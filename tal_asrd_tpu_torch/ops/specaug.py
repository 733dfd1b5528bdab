"""SpecAugment: per example, zero a few frequency and time spans of the
log-mel.

Counterpart of tal_asrd_tpu/ops/specaug.py. Per (example, mask), as the
reference draws them:
    width  ~ U{0, .., param-1}
    start  ~ U{0, .., dim - width - 1}
    end    = start + U{0, .., width-1}     (start when width == 0)
and [start, end) is zeroed; the output is a new tensor and zero masks leave
the input's values as they are.

The draws come from per-example int32 seeds, through a counter-based 32-bit
hash keyed by (seed, mask, draw) and integer arithmetic only, so the CUDA
kernel K4 (ops/cuda_specaug.py, csrc/specaug.cu) and `specaug_plain` give the
same spans and agree bit for bit. The seeds come from an explicit
`torch.Generator` (`spec_augment`) or from the caller (`spec_augment_seeded`,
as the trainer draws them for a whole batch before splitting it). jax.random
gives other numbers: the tests compare distributions with the reference and
masks given the same spans. When dim <= width the start is 0 and the span is
clipped to dim (the reference's mask clips such a span too).

`spec_augment_seeded` launches K4 for a CUDA tensor and takes the plain
version only for a CPU tensor; there is no fallback from a failed build or
launch. The gradient is the same mask applied to the incoming gradient (K4
again on the card). `spec_augment.launches` counts K4 launches, and
`spec_augment.backward_launches` those of them made by a backward pass.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from tal_asrd_tpu_torch.core.config import SpecAugmentConfig
from tal_asrd_tpu_torch.ops.cuda_specaug import launch_specaug

_MASK32 = 0xFFFFFFFF


def mix32(x: torch.Tensor) -> torch.Tensor:
    """The kernel's 32-bit hash on int64 tensors holding uint32 values. Both
    multipliers are below 2^31, so each product fits in int64 exactly."""
    x = x ^ (x >> 16)
    x = (x * 0x21F0AAAD) & _MASK32
    x = x ^ (x >> 15)
    x = (x * 0x735A2D97) & _MASK32
    return x ^ (x >> 15)


def sample_spans(seeds: torch.Tensor, num_masks: int, param: int, dim: int,
                 first_mask: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(start, end) int64 [B, num_masks] of masks first_mask.. of each
    example (the frequency masks come first, then the time masks)."""
    if num_masks > 0 and param < 1:
        raise ValueError(f"a mask parameter must be >= 1, got {param}")
    key = mix32(seeds.to(torch.int64) & _MASK32)[:, None]
    g = torch.arange(first_mask, first_mask + num_masks, device=seeds.device)

    def draw(k):
        return mix32(key ^ (3 * g + k))
    width = draw(0) % max(param, 1)
    room = dim - width
    start = torch.where(room > 0, draw(1) % room.clamp(min=1), 0)
    length = torch.where(width > 0, draw(2) % width.clamp(min=1), 0)
    return start, torch.clamp(start + length, max=dim)


def span_mask(start: torch.Tensor, end: torch.Tensor, dim: int) -> torch.Tensor:
    """[B, num_masks] spans -> [B, dim] bool keep-mask (True = keep)."""
    pos = torch.arange(dim, device=start.device)[None, None, :]
    masked = (pos >= start[..., None]) & (pos < end[..., None])
    return ~masked.any(dim=1)


def specaug_plain(seeds: torch.Tensor, spec: torch.Tensor,
                  cfg: SpecAugmentConfig = SpecAugmentConfig()) -> torch.Tensor:
    """Plain version of K4: spec [B, T, M] with the spans of `seeds` [B]
    zeroed, any dtype and device."""
    _, t, m = spec.shape
    f_s, f_e = sample_spans(seeds, cfg.num_freq_masks, cfg.freq_mask_param, m)
    t_s, t_e = sample_spans(seeds, cfg.num_time_masks, cfg.time_mask_param, t,
                            first_mask=cfg.num_freq_masks)
    keep = span_mask(t_s, t_e, t)[:, :, None] & span_mask(f_s, f_e, m)[:, None, :]
    return torch.where(keep, spec, torch.zeros((), dtype=spec.dtype, device=spec.device))


class _SpecAugmentK4(torch.autograd.Function):
    """K4 forward; backward masks the incoming gradient with the same spans."""

    @staticmethod
    def forward(ctx, spec, seeds, cfg):
        ctx.save_for_backward(seeds)
        ctx.cfg = cfg
        out = launch_specaug(seeds, spec, cfg.freq_mask_param, cfg.num_freq_masks,
                             cfg.time_mask_param, cfg.num_time_masks)
        spec_augment.launches += 1
        return out

    @staticmethod
    def backward(ctx, grad):
        (seeds,) = ctx.saved_tensors
        cfg = ctx.cfg
        out = launch_specaug(seeds, grad.contiguous(), cfg.freq_mask_param,
                             cfg.num_freq_masks, cfg.time_mask_param,
                             cfg.num_time_masks)
        spec_augment.launches += 1
        spec_augment.backward_launches += 1
        return out, None, None


def spec_augment_seeded(seeds: torch.Tensor, spec: torch.Tensor,
                        cfg: SpecAugmentConfig = SpecAugmentConfig()) -> torch.Tensor:
    """SpecAugment of spec [B, T, M] with the spans of seeds [B] (int32, on
    spec's device): K4 for a CUDA tensor, the plain version for a CPU one."""
    if spec.dim() != 3 or seeds.shape != (spec.shape[0],):
        raise ValueError(f"expected spec [B, T, M] and seeds [B], got "
                         f"{tuple(spec.shape)} and {tuple(seeds.shape)}")
    if cfg.num_freq_masks == 0 and cfg.num_time_masks == 0:
        return spec
    if spec.device.type == "cpu":
        return specaug_plain(seeds, spec, cfg)
    return _SpecAugmentK4.apply(spec, seeds, cfg)


def draw_seeds(batch: int, generator: Optional[torch.Generator] = None,
               device=None) -> torch.Tensor:
    """[batch] int32 seeds, uniform over int32, from `generator` (the
    default generator of `device` if None), placed on `device`."""
    gen_device = generator.device if generator is not None else device
    seeds = torch.randint(-2 ** 31, 2 ** 31, (batch,), generator=generator,
                          device=gen_device, dtype=torch.int32)
    return seeds.to(device) if device is not None else seeds


def spec_augment(spec: torch.Tensor,
                 cfg: SpecAugmentConfig = SpecAugmentConfig(),
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """SpecAugment of [B, T, n_mels] features, one seed per example drawn
    from `generator`."""
    return spec_augment_seeded(draw_seeds(spec.shape[0], generator, spec.device),
                               spec, cfg)


spec_augment.launches = 0
spec_augment.backward_launches = 0
