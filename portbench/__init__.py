"""The benchmark of `genmap_tpu_torch` (the PyTorch and CUDA port).

`python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
runs one cell of BENCHMARK.json once; README.md describes the layout.
"""
