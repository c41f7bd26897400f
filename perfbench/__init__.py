"""The benchmark of pyscf_isdf_tpu_torch on one NVIDIA H100 (see
BENCHMARK.json at the root and ``python perfbench/run.py --help``)."""
