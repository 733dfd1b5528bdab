"""CUDA kernel of the frontend hot path: fused mel projection + log (K2).

Replaces the TPU kernel `fused_logmel_project` / `_logmel_kernel` of
tal_asrd_tpu/ops/pallas_kernels.py: `log(power @ filterbank + eps)` with the
mel energies never written to device memory before the log.

What bounds it on an H100: at the frontend's shapes (201 frequency bins, 80
mels) the function moves 281 floats per frame and does 2*201*80 f32
operations per frame, about 29 operations per byte — above the card's f32
(non-tensor-core) ratio of ~20, so the f32 multiply-add rate is the floor,
with the memory floor close behind. The kernel (csrc/logmel_project.cu) is a
persistent f32 GEMM with the log in its epilogue: one block per SM stages
the filterbank once, double-buffers 64-frame tiles of `power` into shared
memory with cp.async, and gives each thread a 4 frames x 4 mels register tile
read with 16-byte shared-memory loads, so the FMA units, not shared memory,
set its pace. The products are exact f32 FMAs on the CUDA cores, as in the
plain version. The 128-padding of 201 and 80 in the TPU kernel is TPU tiling
and is not carried over.

`fused_logmel_project` launches the kernel for a CUDA tensor and takes the
plain version only for a CPU tensor; there is no fallback from a failed build
or launch. `fused_logmel_project.launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from tal_asrd_tpu_torch.ops import _build


def logmel_project_plain(power: torch.Tensor, filterbank: torch.Tensor,
                         eps: float = 1e-6) -> torch.Tensor:
    """Plain PyTorch version: log(power @ filterbank + eps), f32."""
    return torch.log(torch.matmul(power, filterbank) + eps)


_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load_library().tal_logmel_project
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def fused_logmel_project(power: torch.Tensor, filterbank: torch.Tensor,
                         eps: float = 1e-6) -> torch.Tensor:
    """log(power @ filterbank + eps) -> [N, n_mels] f32.

    power [N, n_freqs] f32 (flattened batch*frames), filterbank
    [n_freqs, n_mels] f32, both on one device."""
    if power.dim() != 2 or filterbank.dim() != 2 \
            or power.shape[1] != filterbank.shape[0]:
        raise ValueError(
            f"expected power [N, F] and filterbank [F, M], got "
            f"{tuple(power.shape)} and {tuple(filterbank.shape)}")
    if power.device != filterbank.device:
        raise ValueError("power and filterbank lie on different devices")
    if power.device.type == "cpu":
        return logmel_project_plain(power, filterbank, eps)
    if power.device.type != "cuda":
        raise RuntimeError(f"unsupported device {power.device}")
    if power.dtype != torch.float32 or filterbank.dtype != torch.float32:
        raise TypeError("fused_logmel_project takes float32 tensors")
    if not (power.is_contiguous() and filterbank.is_contiguous()) \
            or filterbank.data_ptr() % 16:
        raise ValueError("fused_logmel_project takes contiguous tensors and a "
                         "16-byte aligned filterbank")
    n, f = power.shape
    m = filterbank.shape[1]
    if m % 16 or m > 128:
        raise ValueError(f"n_mels {m}: the kernel takes a multiple of 16 up to 128")
    out = torch.empty((n, m), dtype=torch.float32, device=power.device)
    with torch.cuda.device(power.device):
        props = torch.cuda.get_device_properties(power.device)
        err = _kernel()(
            power.data_ptr(), filterbank.data_ptr(), out.data_ptr(),
            n, f, m, float(eps), props.multi_processor_count,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"tal_logmel_project launch failed: CUDA error {err}")
    fused_logmel_project.launches += 1
    return out


fused_logmel_project.launches = 0
