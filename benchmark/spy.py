"""Records which elements each dropout call of the program kept, so that the
reference can apply the same masks: PyTorch's dropout draws from the
default generator inside its kernel, and a float32 computation cannot draw
the same bits. A call's keep-mask is where its output is not zero (an input
that is zero gives zero either way, and after a ReLU or a softmax its
gradient is zero too). The masks are packed to bits and kept on the host."""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F


def _weights(device):
    return (2 ** torch.arange(8, device=device)).to(torch.uint8)


def pack(keep: torch.Tensor) -> torch.Tensor:
    flat = keep.reshape(-1).to(torch.uint8)
    flat = F.pad(flat, (0, (-flat.numel()) % 8)).view(-1, 8)
    return (flat * _weights(flat.device)).sum(dim=1, dtype=torch.uint8).cpu()


def unpack(bits: torch.Tensor, shape, device) -> torch.Tensor:
    b = bits.to(device)[:, None] & _weights(device)
    n = 1
    for s in shape:
        n *= s
    return (b != 0).reshape(-1)[:n].reshape(shape)


class DropoutRecorder:
    """Inside the block, every call of torch.nn.functional.dropout (which
    nn.Dropout also calls) is made as before and its keep-mask recorded."""

    def __init__(self):
        self.masks: List[Tuple[torch.Tensor, tuple, float]] = []

    def __enter__(self):
        self._orig = F.dropout

        def dropout(input, p=0.5, training=True, inplace=False):
            out = self._orig(input, p, training, inplace)
            if training and p > 0:
                self.masks.append((pack(out != 0), tuple(out.shape), float(p)))
            return out

        F.dropout = dropout
        return self

    def __exit__(self, *exc):
        F.dropout = self._orig
        return False

    def keep_masks(self, device) -> Optional[List[Tuple[torch.Tensor, float]]]:
        """The recorded masks on `device`, None when no dropout was drawn."""
        return [(unpack(bits, shape, device), p) for bits, shape, p in self.masks] or None
