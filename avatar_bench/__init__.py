"""The benchmark of the PyTorch / CUDA port (`stableavatar_tpu_torch`).

`python3 -m avatar_bench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell once; `BENCHMARK.json` at the repository's
root lists the cells, configurations and metrics.  Nothing here imports
JAX or the JAX package.
"""
