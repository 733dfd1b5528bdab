"""The benchmark of the PyTorch / CUDA port (`tal_asrd_tpu_torch`); see
BENCHMARK.json at the repository's root and run.py."""
