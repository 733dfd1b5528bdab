"""CUDA kernel K4: SpecAugment with the spans drawn on the device.

Replaces the TPU kernel `specaug_pallas` / `_specaug_kernel` of
tal_asrd_tpu/ops/pallas_kernels.py. What it computes, and its plain version,
are in ops/specaug.py (`spec_augment_seeded`, `specaug_plain`); this module
binds the kernel of csrc/specaug.cu and checks what it is given.

What bounds it on an H100: one write of every value and one read of every
value it keeps, so those bytes over the memory rate (4 * (B*T*M + kept) /
3.35 TB/s, reckoned from each run's draw by chip_smoke.py). The design
(csrc/specaug.cu) streams rows with 16-byte loads and stores, skips the
read of a row inside a time span, and draws each example's spans inside the
block from its seed, so no mask tensor crosses memory and there is one
launch.

The span arithmetic is integer-only and shared with the plain version, so
the kernel and `specaug_plain` agree bit for bit. The Pallas kernel's draw
(`start = bits % dim`, then clamped to `dim - width - 1`,
pallas_kernels.py:101-103) piles the starts at one value; the port follows
the distribution of the function training runs instead.
"""
from __future__ import annotations

import ctypes

import torch

from tal_asrd_tpu_torch.ops import _build

MAX_MASKS = 16      # per axis (csrc/specaug.cu)
MAX_MELS = 1024

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load_library().tal_specaug
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def launch_specaug(seeds: torch.Tensor, spec: torch.Tensor, f_param: int,
                   n_f: int, t_param: int, n_t: int) -> torch.Tensor:
    """One launch of K4 on CUDA tensors: spec [B, T, M] f32 with M % 4 == 0
    and 16-byte aligned (the kernel moves rows as float4), seeds [B] int32,
    both on one card. Returns a new [B, T, M] f32 tensor."""
    if spec.device.type != "cuda" or seeds.device != spec.device:
        raise ValueError(
            f"K4 takes spec and seeds on one CUDA device, got {spec.device} "
            f"and {seeds.device}")
    if spec.dim() != 3 or seeds.shape != (spec.shape[0],):
        raise ValueError(f"expected spec [B, T, M] and seeds [B], got "
                         f"{tuple(spec.shape)} and {tuple(seeds.shape)}")
    if spec.dtype != torch.float32 or seeds.dtype != torch.int32:
        raise TypeError("K4 takes a float32 spec and int32 seeds")
    if not (spec.is_contiguous() and seeds.is_contiguous()):
        raise ValueError("K4 takes contiguous tensors")
    b, t, m = spec.shape
    if max(n_f, n_t) > MAX_MASKS or m > MAX_MELS:
        raise ValueError(f"K4 takes at most {MAX_MASKS} masks per axis and "
                         f"{MAX_MELS} mels, got {n_f}, {n_t} and {m}")
    out = torch.empty_like(spec)
    if m % 4 != 0 or spec.data_ptr() % 16 != 0 or out.data_ptr() % 16 != 0:
        raise ValueError(f"K4 takes M % 4 == 0 and 16-byte aligned tensors, got "
                         f"M = {m}, spec at {spec.data_ptr():#x}")
    with torch.cuda.device(spec.device):
        err = _kernel()(
            spec.data_ptr(), out.data_ptr(), seeds.data_ptr(), b, t, m,
            f_param, n_f, t_param, n_t,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"tal_specaug launch failed: CUDA error {err}")
    return out
