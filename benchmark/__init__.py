"""The benchmark of cstone_tpu_torch: cells, traffic, metric readers, the
plain reference and the comparison that decides `correct`.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

BENCHMARK.json at the root of the repository names the cells; each cell's
configuration (`configs/`), traffic mix (`traffic/`) and metric readers
(`metrics/`) are files of their own that the harness finds by name.
Nothing here imports jax or the JAX package.
"""
