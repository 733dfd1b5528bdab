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


@pytest.mark.gpu
def test_k4_equals_its_plain_version_and_counts_its_launches():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no interpret mode")
    from tal_asrd_tpu_torch.core.config import SpecAugmentConfig
    from tal_asrd_tpu_torch.ops.specaug import (
        draw_seeds, spec_augment, spec_augment_seeded, specaug_plain)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape, cfg in (((8, 301, 80), SpecAugmentConfig()),
                       ((3, 37, 8), SpecAugmentConfig(freq_mask_param=4))):
        spec = torch.randn(shape, device="cuda", generator=gen, requires_grad=True)
        seeds = draw_seeds(shape[0], gen, "cuda")
        before = (spec_augment.launches, spec_augment.backward_launches)
        out = spec_augment_seeded(seeds, spec, cfg)
        assert spec_augment.launches == before[0] + 1
        assert torch.equal(out, specaug_plain(seeds, spec.detach(), cfg))
        g = torch.randn_like(out)
        out.backward(g)
        assert spec_augment.backward_launches == before[1] + 1
        assert torch.equal(spec.grad, specaug_plain(seeds, g, cfg))
    # the kernel moves rows as float4: other widths raise, nothing falls back
    spec = torch.randn((3, 37, 6), device="cuda", generator=gen)
    with pytest.raises(ValueError):
        spec_augment_seeded(draw_seeds(3, gen, "cuda"), spec, SpecAugmentConfig(freq_mask_param=4))
