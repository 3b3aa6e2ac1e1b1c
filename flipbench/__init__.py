"""flipbench: the benchmark of the PyTorch/CUDA port (`repro_torch`).

One run is one cell of `BENCHMARK.json` (a configuration under a traffic
mix), started from the checkout's root:

    python3 flipbench/run.py --workload road-ny.sssp8 --seed 7 \
        --seconds 30 --trace 0

See README.md in this folder. Nothing here imports the JAX package.
"""
