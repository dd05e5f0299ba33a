"""The benchmark of foldcomp_tpu_torch on NVIDIA GPUs.

`python3 -m portbench.run --workload <name> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of BENCHMARK.json once and prints one JSON
line. README.md says how the pieces fit and how to add to them.
"""
