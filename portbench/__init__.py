"""The benchmark of scs_tpu_torch, the PyTorch and CUDA port.

One command runs one cell once, on the card:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cells, the metrics and the configurations are named in BENCHMARK.json
at the root of the repository; every piece that belongs to one of them
lives in a file of its own, found by that name (`registry.py`). Nothing here
imports the JAX package or JAX.
"""
