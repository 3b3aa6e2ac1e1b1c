"""Program: a vertex program as one user-facing object.

The port of `repro.api.program`, over the port's own registries
(`repro_torch.algebra.ALGEBRAS` and `repro_torch.graphs.reference.ORACLES`).
A `Program` bundles the algebra the engine runs with the numpy ground
truth it is checked against, and registers both atomically:

    import flip_torch

    @flip_torch.Program.define("minimax", min_max_semiring,
                               weight_rule="graph")
    def minimax_oracle(g, src):        # the decorated fn IS the oracle
        ...
        return best                    # (n,) numpy result

    flip_torch.compile(g, "minimax").query(0).check()

A new semiring also needs a specialization of the CUDA kernel
(kernels/frontier/csrc/frontier_relax.cu); on the CPU any semiring runs
through the plain version.

`Program.get(name)` wraps an already-registered algorithm, so strings,
`VertexAlgebra`s, and `Program`s are interchangeable everywhere the api
accepts a program.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from repro_torch.algebra import (ALGEBRAS, Semiring, VertexAlgebra,
                                 get_algebra, register_algebra)
from repro_torch.graphs import reference


@dataclasses.dataclass(frozen=True)
class Program:
    """A vertex algebra paired with its numpy ground truth."""

    algebra: VertexAlgebra
    oracle: Callable | None = None   # (graph, src) -> result [, stats]

    @property
    def name(self) -> str:
        return self.algebra.name

    # -------------------------------------------------------------- #
    def reference(self, graph, src: int = 0) -> np.ndarray:
        """The oracle result alone (stats dropped)."""
        if self.oracle is None:
            raise ValueError(
                f"program {self.name!r} has no registered oracle")
        out = self.oracle(graph, src)
        if isinstance(out, tuple):
            out = out[0]
        return np.asarray(out)

    def check(self, graph, src, got) -> bool:
        """Compare an execution result against the oracle at the
        algebra's tolerance (±inf-safe)."""
        return bool(self.algebra.results_match(got,
                                               self.reference(graph, src)))

    # -------------------------------------------------------------- #
    @classmethod
    def get(cls, name: str) -> "Program":
        """Wrap an already-registered algorithm (algebra + oracle)."""
        return cls(get_algebra(name), reference.get_oracle(name))

    @classmethod
    def of(cls, program) -> "Program":
        """Coerce str | VertexAlgebra | Program to a Program. A bare
        VertexAlgebra picks up its registered oracle when one exists."""
        if isinstance(program, Program):
            return program
        if isinstance(program, VertexAlgebra):
            return cls(program, reference.get_oracle(program.name))
        if isinstance(program, str):
            return cls.get(program)
        raise TypeError(
            f"program must be a name, VertexAlgebra, or Program; got "
            f"{type(program).__name__}")

    # -------------------------------------------------------------- #
    @classmethod
    def define(cls, name: str | None = None,
               semiring: Semiring | None = None, *,
               algebra: VertexAlgebra | None = None,
               oracle: Callable | None = None,
               register: bool = True, **algebra_kwargs):
        """Build and register a Program in one call.

        Either pass a prebuilt ``algebra=VertexAlgebra(...)`` or let
        this construct one from ``(name, semiring, **algebra_kwargs)``
        (the `VertexAlgebra` fields: weight_rule, kind, undirected,
        all_start, tol, damping, ...). With ``oracle`` omitted, returns
        a decorator so the oracle function sits directly under the
        definition:

            @Program.define("minimax", MIN_MAX, weight_rule="graph")
            def minimax_oracle(g, src): ...

        Registration is atomic: the algebra lands in `ALGEBRAS` (every
        execution layer) and the oracle in `reference.ORACLES`
        (`reference.run` dispatch, --check paths, tests) together, or --
        with ``register=False`` -- not at all (a local, unregistered
        program still compiles via `flip_torch.compile`).
        """
        if algebra is None:
            if name is None or semiring is None:
                raise TypeError(
                    "Program.define needs either algebra=VertexAlgebra("
                    "...) or (name, semiring, ...) to build one")
            algebra = VertexAlgebra(name, semiring, **algebra_kwargs)
        elif algebra_kwargs or name is not None or semiring is not None:
            raise TypeError(
                "Program.define takes either algebra=... or (name, "
                "semiring, **fields), not both")

        if oracle is None:
            def decorator(fn: Callable) -> "Program":
                return cls.define(algebra=algebra, oracle=fn,
                                  register=register)
            return decorator

        prog = cls(algebra, oracle)
        if register:
            register_algebra(algebra)
            reference.register_oracle(algebra.name, oracle)
        return prog

    def unregister(self) -> None:
        """Remove this program from both registries (test teardown)."""
        ALGEBRAS.pop(self.name, None)
        reference.ORACLES.pop(self.name, None)
