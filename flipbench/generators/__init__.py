"""Graph generators, one module per `generator` name in a configuration.

Each module defines ``generate(config: dict, seed: int) -> RawGraph``.
"""
