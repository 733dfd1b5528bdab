"""Tests of the PyTorch port that need an NVIDIA GPU and nvcc. They carry the
marker `gpu` and skip on a machine without a card; whether there is one is
decided inside the test, never while the module is imported.

    python -m pytest tests/test_torch_gpu.py -m gpu
"""
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.gpu
def test_kernels_build_and_match_their_plain_versions_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no interpret mode")
    res = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--phases", "kernels"],
        capture_output=True, text=True, cwd=ROOT, timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "kernel checks passed" in res.stdout
