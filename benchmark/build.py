"""The system under test, built from a configuration file and a seed.

Weights are the benchmark's own: one draw of a standard normal on the
run's device from a `torch.Generator` seeded by the run's seed, scaled leaf
by leaf, in float32: matrices and kernels 1 / sqrt(fan_in) and the
embedding table 1 / sqrt(3 embed_size), the spreads of the reference's
initialiser (lecun normal; uniform in +-1 / sqrt(embed_size)); the
embedding projection 1 / sqrt(embed_size); biases 0.02; the ReZero scalars,
which the reference starts at 0 and training moves, 0.1 + 0.02 z. At 0.3
the encoder's activations grow block by block, and the bf16 and fp8
gradients of the scalars and of the decoder's self-attention part from
float32's by more than a lower precision does elsewhere. The program's model is built on the meta device, so its own
initialiser draws nothing, then given storage and these values. The
reference reads the same values by name.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

SCALARS_AT, SCALARS_SPREAD = 0.1, 0.02
EMBED_SCALE = 3 ** -0.5      # the spread of the reference's uniform(+-1 / sqrt(E)) table


def model_config(config: dict):
    from tal_asrd_tpu_torch.core.config import ModelConfig
    keys = ("model_type", "num_speakers", "n_mels", "vocab_size", "n_head", "max_positions",
            "dropout", "embed_size", "tds_depths", "tds_kernel", "tds_dropout",
            "width_mult", "d_decoder_override")
    kw = {k: config[k] for k in keys if k in config}
    kw["tds_depths"] = tuple(kw["tds_depths"])
    return ModelConfig(**kw)


def draw_weights(shapes: List[Tuple[str, Tuple[int, ...]]], seed: int, device,
                 embed_size: int) -> Dict[str, torch.Tensor]:
    """name -> float32 tensor, views of one seeded draw on `device`."""
    scales, shifts = [], []
    for name, shape in shapes:
        if len(shape) == 0:
            scales.append(SCALARS_SPREAD)
            shifts.append(SCALARS_AT)
        elif len(shape) == 1:
            scales.append(0.02)
            shifts.append(0.0)
        elif name == "embedding.weight":
            scales.append(EMBED_SCALE / math.sqrt(embed_size))
            shifts.append(0.0)
        elif name == "embedding_proj":
            scales.append(1.0 / math.sqrt(embed_size))
            shifts.append(0.0)
        else:
            scales.append(1.0 / math.sqrt(math.prod(shape[1:])))
            shifts.append(0.0)
    sizes = torch.tensor([math.prod(s) for _, s in shapes], device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(int(sizes.sum()), generator=gen, device=device)
    flat.mul_(torch.repeat_interleave(torch.tensor(scales, device=device), sizes))
    flat.add_(torch.repeat_interleave(torch.tensor(shifts, device=device), sizes))
    out, at = {}, 0
    for name, shape in shapes:
        n = math.prod(shape)
        out[name] = flat[at:at + n].view(shape)
        at += n
    return out


def _fill(model, weights: Dict[str, torch.Tensor]) -> None:
    """Storage on the weights' device for a model built on the meta device,
    the weights copied in (cast to the model's dtype), the positional table
    made again."""
    from tal_asrd_tpu_torch.models.decoder import sinusoidal_positions
    device = next(iter(weights.values())).device
    model.to_empty(device=device)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(weights[name])
        pe = model.pos_dec.pe
        pe.copy_(torch.from_numpy(sinusoidal_positions(*pe.shape)).to(pe.dtype))


def shapes_of(config: dict) -> List[Tuple[str, Tuple[int, ...]]]:
    from tal_asrd_tpu_torch.models.asr import ASRModel
    with torch.device("meta"):
        m = ASRModel(model_config(config), device="meta")
    return [(n, tuple(p.shape)) for n, p in m.named_parameters()]


def serving_model(config: dict, weights: Dict[str, torch.Tensor]):
    """The program's ASRModel in the configuration's compute dtype (its
    parameters stored in it, as served), in eval mode."""
    from tal_asrd_tpu_torch.models.asr import ASRModel
    dtype = getattr(torch, config["compute_dtype"])
    with torch.device("meta"):
        model = ASRModel(model_config(config), dtype=dtype, device="meta")
    _fill(model, weights)
    return model.eval()


def training_system(config: dict, train_kw: dict, weights: Dict[str, torch.Tensor]):
    """The program's ASRSystem: float32 parameters, compute in the
    configuration's dtype, its optimizer (LAMB) made for the filled
    parameters."""
    from tal_asrd_tpu_torch.core.config import TrainConfig
    from tal_asrd_tpu_torch.train.system import ASRSystem
    with torch.device("meta"):
        system = ASRSystem(model_config(config), TrainConfig(**train_kw),
                           compute_dtype=getattr(torch, config["compute_dtype"]),
                           device="meta")
    _fill(system.model, weights)
    system.device = next(iter(weights.values())).device
    system.optimizer = system._make_optimizer()
    return system
