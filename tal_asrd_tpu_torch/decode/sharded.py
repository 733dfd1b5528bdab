"""Window-parallel and episode-parallel decode, the batch split over devices.

Counterpart of tal_asrd_tpu/decode/sharded.py. The JAX package shards the
batch over a mesh's data axes with the parameters replicated; here the
batch is split evenly over a list of torch devices, each part runs on a
replica of the model on its device, and only the outputs (token ids,
lengths, scores) are gathered onto the first device: no activation crosses
a device.

The split keeps the whole batch's semantics where the model reads the
batch as a whole:
  * the frontend subtracts one mean over the whole batch's real frames
    (ops/logmel.py): the first device takes it from the whole batch's
    log-mel with the unsplit encode's own operations, so every part
    subtracts the unsplit batch's mean to the bit (the parts' own f32 sums
    added up land a unit in the last place off it now and then, and in
    bf16 a few features then round the other way; long episodes follow);
  * `pad_mask_mode="batch_max"` scales the encoder mask by the batch's
    longest audio: every part is given that length.
What is left is how the device's kernels round at another batch size (on
an H100 the frontend and the encoder give the same bits at batches 2 and 4
in bf16; in f32 the encoder parts from batch 4 by up to 4e-4 at batch 2).
Only the input audio and the mean, a scalar, reach another device.

The frontends run first, from the calling thread (the mean is their one
meeting point); then each distinct device runs its parts' encoder and
decode on a host thread of its own, so that no card waits for another's
host loop. Parts that share a device run in order on its thread; with one
distinct device everything runs on the calling thread.
"""
from __future__ import annotations

import copy
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from tal_asrd_tpu_torch.decode.beam import BeamSearchSpec, beam_search
from tal_asrd_tpu_torch.decode.unaligned import UnalignedSpec, unaligned_decode_batched
from tal_asrd_tpu_torch.ops.logmel import batch_mean


def default_devices() -> List[str]:
    """Every visible CUDA device."""
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("no CUDA device is visible; pass devices=['cpu', ...] "
                           "to split the batch over CPU replicas")
    return [f"cuda:{i}" for i in range(n)]


def replicate(model, devices: Sequence[str]) -> List:
    """One model per entry of `devices`: the model itself where it already
    lives, else one copy per distinct device, shared by that device's
    entries."""
    own = next(model.parameters()).device
    copies: Dict[torch.device, Any] = {own: model}
    out = []
    for name in devices:
        dev = torch.device(name)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if dev not in copies:
            copies[dev] = copy.deepcopy(model).to(dev)
        out.append(copies[dev])
    return out


def sharded_features(models: Sequence, devices: Sequence[str], audio, audio_lens):
    """Split audio [B, T] (and audio_lens [B]) into len(devices) equal parts
    and take each part's features on its device with the whole batch's
    frontend mean: the first device takes the whole batch's log-mel, its
    mean and its own part of it; every other device its part's log-mel.
    Returns the parts' (features in the compute dtype, part of audio_lens
    or None), in order."""
    n = len(devices)
    b = audio.shape[0]
    if b % n:
        raise ValueError(f"a batch of {b} does not split evenly over {n} devices")
    part = b // n
    audio = torch.as_tensor(audio)
    lens = None if audio_lens is None else torch.as_tensor(audio_lens)
    whole = models[0].log_mel(audio.to(devices[0]))
    mels = [whole[:part]] + [model.log_mel(audio[i * part:(i + 1) * part].to(dev))
                             for i, (model, dev) in enumerate(zip(models[1:], devices[1:]), 1)]
    if models[0].frontend.mean_subtract:
        mean = batch_mean(whole, None if lens is None else lens.to(devices[0]),
                          models[0].frontend)
        mels = [mel - mean.to(mel.device) for mel in mels]
    return [(mel.to(model.compute_dtype),
             None if lens is None else lens[i * part:(i + 1) * part].to(dev))
            for i, (mel, model, dev) in enumerate(zip(mels, models, devices))]


def _device_key(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def per_device(devices: Sequence[str], work: Callable[[int], Any]) -> List[Any]:
    """work(i) for every part i under inference mode, the parts of one
    device in order on one host thread per distinct device; the results in
    part order."""
    groups: Dict[torch.device, List[int]] = {}
    for i, name in enumerate(devices):
        groups.setdefault(_device_key(name), []).append(i)
    results: List[Any] = [None] * len(devices)
    errors: List[BaseException] = []

    def run(parts: List[int]) -> None:
        try:
            with torch.inference_mode():
                for i in parts:
                    results[i] = work(i)
        except BaseException as e:  # noqa: BLE001 - raised on the calling thread
            errors.append(e)

    if len(groups) == 1:
        run(list(range(len(devices))))
    else:
        threads = [threading.Thread(target=run, args=(parts,)) for parts in groups.values()]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    if errors:
        raise errors[0]
    return results


def _batch_max(audio_lens) -> Optional[int]:
    return None if audio_lens is None else int(torch.as_tensor(audio_lens).max())


def encode_sharded(models: Sequence, devices: Sequence[str], audio, audio_lens
                   ) -> List[Dict[str, Any]]:
    """`sharded_features`, then each part's encoder on its device with the
    whole batch's longest audio. Returns the parts' encoder outputs, in
    order."""
    batch_max = _batch_max(audio_lens)
    return [model.encode_features(feats, l_i, audio.shape[-1], batch_max_len=batch_max)
            for (feats, l_i), model in zip(sharded_features(models, devices, audio, audio_lens),
                                           models)]


def _gather(parts: List[Dict[str, Any]], device) -> Dict[str, Any]:
    """Concatenate the parts' outputs along the batch on `device` (lists,
    such as the state machine's events, are joined)."""
    out = {}
    for key, first in parts[0].items():
        if isinstance(first, torch.Tensor):
            out[key] = torch.cat([p[key].to(device) for p in parts])
        else:
            out[key] = [x for p in parts for x in p[key]]
    return out


def make_sharded_decode(model, spec: BeamSearchSpec,
                        devices: Optional[Sequence[str]] = None) -> Callable:
    """(audio [B, T], audio_lens [B], prime [B, P]) -> beam_search's outputs
    for the whole batch, on the first device, the batch split evenly over
    `devices` (default: every visible CUDA device). `model` is an ASRModel;
    B must be divisible by len(devices). Inputs may be numpy arrays or
    tensors on any device."""
    devs = list(devices) if devices is not None else default_devices()
    models = replicate(model, devs)

    def run(audio, audio_lens, prime) -> Dict[str, torch.Tensor]:
        with torch.inference_mode():
            prime = torch.as_tensor(prime).to(torch.long)
            part = prime.shape[0] // len(devs)
            feats = sharded_features(models, devs, audio, audio_lens)
        batch_max = _batch_max(audio_lens)

        def decode(i: int) -> Dict[str, torch.Tensor]:
            enc = models[i].encode_features(feats[i][0], feats[i][1], audio.shape[-1],
                                            batch_max_len=batch_max)
            return beam_search(models[i], enc, prime[i * part:(i + 1) * part].to(devs[i]),
                               spec)

        outs = per_device(devs, decode)
        with torch.inference_mode():
            return _gather(outs, devs[0])

    return run


def make_sharded_unaligned(model, spec: UnalignedSpec,
                           devices: Optional[Sequence[str]] = None) -> Callable:
    """(audio [N, T], audio_lens [N]) -> unaligned_decode_batched's outputs
    for N whole episodes, split evenly over `devices` (default: every
    visible CUDA device), each part's lanes through the state machine on its
    device; N must be divisible by len(devices)."""
    devs = list(devices) if devices is not None else default_devices()
    models = replicate(model, devs)

    def run(audio, audio_lens) -> Dict[str, Any]:
        with torch.inference_mode():
            feats = sharded_features(models, devs, audio, audio_lens)
        batch_max = _batch_max(audio_lens)

        def decode(i: int) -> Dict[str, Any]:
            enc = models[i].encode_features(feats[i][0], feats[i][1], audio.shape[-1],
                                            batch_max_len=batch_max)
            mask = enc.get("encoder_padding_mask")
            x = enc["encoder_out"]
            ns = ((~mask).sum(-1) if mask is not None
                  else torch.full((x.shape[0],), x.shape[1]))
            return unaligned_decode_batched(models[i], enc, ns, spec)

        outs = per_device(devs, decode)
        with torch.inference_mode():
            return _gather(outs, devs[0])

    return run
