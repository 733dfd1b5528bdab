"""The contrastive metric head (train/embed_system.py, cli/train_embed.py)
and RandomSegmentDataset (data/audio.py), port against JAX package on the
CPU, float32:

  * ContrastiveDataset gives the JAX package's episodes for a seed;
  * from the JAX EmbedSystem's initial parameters, the loss and accuracy of
    a batch agree within 1e-6, and 20 Adam steps (losses, accuracies, the
    parameters after them) within 1e-5, at a small width here and at the
    CLI's (64 -> 256 -> 256 -> 10) against the JAX CPU reference's 20 steps
    on its exported rows (tests/fixtures/torch_embed_reference.json); at
    that width the losses agree to 1.5e-6, and 99.5 % of the parameters
    within 1e-5, every one within lr (8e-4); the 173 of 85002 elements
    that lie up to 5.1e-4 apart are, all but one, the incoming weights and
    biases of two hidden units whose ReLU gate flipped between the
    packages on one sample (a pre-activation of -2.1e-7 or -8.8e-8 in
    JAX), and the one is within 2e-5;
  * a head that `python -m tal_asrd_tpu_torch.cli.train_embed` wrote loads
    unchanged in the JAX package's `apply_embed_head`, whose outputs equal
    the port's within 1e-5; the flax tree and the module's state_dict
    convert both ways;
  * RandomSegmentDataset draws the JAX package's windows from the same
    `random.Random` state, a corrupt file quarantined and replaced alike."""
import json
import os
import pickle
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tal_asrd_tpu.data.audio import RandomSegmentDataset as JRandomSegmentDataset
from tal_asrd_tpu.eval.wder_search import apply_embed_head
from tal_asrd_tpu.train.embed_system import ContrastiveDataset as JContrastiveDataset
from tal_asrd_tpu.train.embed_system import EmbedSystem as JEmbedSystem
from tal_asrd_tpu.train.embed_system import contrastive_loss as j_contrastive_loss
from tal_asrd_tpu_torch.core.convert import params_to_state_dict, state_dict_to_params
from tal_asrd_tpu_torch.data.audio import RandomSegmentDataset
from tal_asrd_tpu_torch.data.audio_io import write_wav
from tal_asrd_tpu_torch.train.embed_system import (
    ContrastiveCollator,
    ContrastiveDataset,
    EmbedMLP,
    EmbedSystem,
    contrastive_loss,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_embed_reference.json")
ARRAYS = os.path.join(ROOT, "tests", "fixtures", "torch_embed_reference_arrays.npz")

SMALL = dict(in_dim=8, hidden=32, out_dim=8)
B, STEPS = 16, 20


def speaker_rows(n_speakers=5, per=12, dim=8, seed=0):
    rng = np.random.RandomState(seed)
    emb = np.concatenate([rng.randn(per, dim) * 0.3 + np.eye(dim)[i % dim]
                          for i in range(n_speakers)]).astype(np.float32)
    return emb, np.repeat(np.arange(n_speakers), per).astype(np.int32)


def episodes(cls, emb, ids, n, seed=0, n_way=4, b=B):
    ds = cls(emb, ids, n_way=n_way, seed=seed, epoch_len=n * b)
    return np.stack([ContrastiveCollator()([ds[i * b + j] for j in range(b)])
                     for i in range(n)])


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_episodes_match_jax():
    emb, ids = speaker_rows()
    ids[-1] = 9          # a speaker with one row cannot anchor
    got = episodes(ContrastiveDataset, emb, ids, 6, seed=3)
    np.testing.assert_array_equal(got, episodes(JContrastiveDataset, emb, ids, 6, seed=3))
    assert got.shape == (6, B, 4, 8)
    ds = ContrastiveDataset(emb, ids)
    assert 9 not in ds.anchors and len(ds) == 5000


def test_loss_matches_jax():
    emb, ids = speaker_rows()
    batch = episodes(ContrastiveDataset, emb, ids, 1)[0]
    j = JEmbedSystem(batch_size=B, **SMALL)
    model = EmbedMLP(**SMALL)
    model.load_state_dict(params_to_state_dict(numpy_tree(j.params)))
    with torch.no_grad():
        loss, acc = contrastive_loss(model, torch.from_numpy(batch))
    j_loss, j_acc = j_contrastive_loss(j.model, j.params, jnp.asarray(batch))
    assert abs(float(loss) - float(j_loss)) < 1e-6 and float(acc) == float(j_acc)


def test_init_is_flax_dense():
    """lecun-normal kernels (truncated at 2 std, std 1/sqrt(fan_in)), zero
    biases."""
    model = EmbedMLP(generator=torch.Generator().manual_seed(0))
    for layer, fan_in in ((model.Dense_0, 64), (model.Dense_1, 256), (model.Dense_2, 256)):
        w = layer.weight.detach().numpy() * np.sqrt(fan_in)
        assert abs(w.std() - 1.0) < 0.05 and np.abs(w).max() <= 2.28
        assert not layer.bias.detach().any()


def run_both(j_system, port, batches):
    j_losses, j_accs = j_system.fit(iter(batches))
    losses, accs = port.fit(iter(batches))
    return (np.asarray(losses), np.asarray(accs)), (np.asarray(j_losses), np.asarray(j_accs))


def test_adam_steps_match_jax():
    emb, ids = speaker_rows()
    batches = episodes(ContrastiveDataset, emb, ids, STEPS)
    j = JEmbedSystem(batch_size=B, **SMALL)
    port = EmbedSystem(batch_size=B, params=numpy_tree(j.params), device="cpu", **SMALL)
    (losses, accs), (j_losses, j_accs) = run_both(j, port, batches)
    np.testing.assert_allclose(losses, j_losses, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(accs, j_accs)
    assert losses[-1] < losses[0]
    for layer, leaves in numpy_tree(j.params).items():
        for leaf, want in leaves.items():
            np.testing.assert_allclose(port.params[layer][leaf], want, rtol=0, atol=1e-5)


def test_cli_width_steps_match_the_jax_fixture():
    """The fixture's 20 steps at the CLI's width (batch 64, 6-way), from the
    JAX EmbedSystem's initial parameters, on its exported rows. Where a
    parameter lies more than 1e-5 from JAX's, a hidden unit's ReLU gate
    flipped: on some sample and step its pre-activation lies within the
    rounding of the two packages' sums of zero (the fixture records JAX's
    within 1e-4 of zero), one package passes that sample's gradient
    through the unit and the other does not, and Adam turns the
    difference into steps of up to lr on the unit's incoming weights."""
    with open(FIXTURE) as f:
        ref = json.load(f)["embed_system"]
    arrays = np.load(ARRAYS)
    rows, ids = arrays["gen_embed/train8/rows"], arrays["gen_embed/train8/ids"]
    n_train = int(len(rows) * 0.8)
    tree = {}
    for key in arrays.files:
        if key.startswith("embed_system/") and key.count("/") == 3:
            _, tag, layer, leaf = key.split("/")
            tree.setdefault(tag, {}).setdefault(layer, {})[leaf] = arrays[key]
    near = {k: arrays[f"embed_system/near_zero/{k}"] for k in ("step", "layer", "index", "value")}
    batches = episodes(ContrastiveDataset, rows[:n_train], ids[:n_train], ref["steps"],
                       seed=ref["episode_seed"], n_way=ref["n_way"], b=ref["batch_size"])
    port = EmbedSystem(batch_size=ref["batch_size"], params=tree["init"], device="cpu")
    losses, accs, flipped = [], [], set()
    for t, batch in enumerate(batches):
        with torch.no_grad():
            h0 = port.model.Dense_0(port._batch(batch))
            hidden = (h0, port.model.Dense_1(torch.relu(h0)))
        for layer, h in enumerate(hidden):
            sel = (near["step"] == t) & (near["layer"] == layer)
            got = h.reshape(-1)[torch.from_numpy(near["index"][sel]).long()].numpy()
            differ = (got > 0) != (near["value"][sel] > 0)
            flipped |= {(layer, int(i) % h.shape[-1]) for i in near["index"][sel][differ]}
        loss, acc = port.fit(iter(batch[None]))
        losses += loss
        accs += acc
    np.testing.assert_allclose(losses, ref["losses"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(accs, ref["accs"], rtol=0, atol=1e-6)
    lr = port.optimizer.param_groups[0]["lr"]
    gaps, in_flipped = [], []
    for layer, leaves in tree["final"].items():
        units = [u for l_, u in flipped if f"Dense_{l_}" == layer]
        for leaf, want in leaves.items():
            gaps.append(np.abs(port.params[layer][leaf] - want).ravel())
            mask = np.zeros(want.shape, bool)
            mask[..., units] = True          # the unit's incoming weights and bias
            in_flipped.append(mask.ravel())
    gaps, in_flipped = np.concatenate(gaps), np.concatenate(in_flipped)
    assert (gaps <= 1e-5).mean() >= 0.995 and gaps.max() <= lr, (gaps.max(), (gaps > 1e-5).sum())
    assert flipped, "parameters apart with no ReLU gate flipped"
    outliers = gaps > 1e-5
    assert (outliers & in_flipped).sum() >= 0.99 * outliers.sum(), (
        sorted(flipped), outliers.sum(), (outliers & in_flipped).sum())
    assert gaps[~in_flipped].max() <= 2e-5, gaps[~in_flipped].max()


def test_head_written_by_the_cli_loads_in_jax(tmp_path):
    from tal_asrd_tpu_torch.cli import train_embed
    emb, ids = speaker_rows(dim=64)
    for part, sl in (("train", slice(0, 48)), ("valid", slice(0, None, 2))):
        with open(tmp_path / f"spk.{part}.pkl", "wb") as f:
            pickle.dump((emb[sl], ids[sl]), f)
    head = str(tmp_path / "head.msgpack")
    res = train_embed.main(["--train-data", str(tmp_path / "spk.train.pkl"),
                            "--valid-data", str(tmp_path / "spk.valid.pkl"),
                            "--steps", "3", "--batch-size", "8", "--out", head,
                            "--device", "cpu"])
    assert len(res["losses"]) == 3 and 0.0 <= res["valid_acc"] <= 1.0
    x = emb[:5]
    paired = [([], [("hello", (x[i], 3), "host") for i in range(3)] + [("bye", (None, 1))]),
              ([], [("more", (x[i], 0)) for i in range(3, 5)])]
    mapped = apply_embed_head(paired, head)
    got = np.stack([u[1][0] for _, hyp in mapped for u in hyp if u[1][0] is not None])
    np.testing.assert_allclose(got, res["system"].embed(x), rtol=0, atol=1e-5)
    assert mapped[0][1][3] == ("bye", (None, 1)) and mapped[0][1][0][2] == "host"
    tree = res["system"].params
    assert set(tree) == {"Dense_0", "Dense_1", "Dense_2"}
    assert tree["Dense_0"]["kernel"].shape == (64, 256) and tree["Dense_2"]["bias"].shape == (10,)
    sd = res["system"].model.state_dict()
    back = params_to_state_dict(state_dict_to_params(sd))
    assert all(torch.equal(back[k], v) for k, v in sd.items()) and set(back) == set(sd)


def test_random_segments_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    d = tmp_path / "wavs"
    d.mkdir()
    for i, secs in enumerate((2.0, 7.5, 12.0)):
        write_wav(str(d / f"ep{i}.wav"), (rng.standard_normal(int(secs * 16000)) * 0.1)
                  .astype(np.float32))
    (d / "ep3.wav").write_bytes(b"not a wav")
    logs = {}
    draws = {}
    for side, cls in (("port", RandomSegmentDataset), ("jax", JRandomSegmentDataset)):
        logs[side] = str(tmp_path / side / "bad.log")
        ds = cls(str(d), segment_seconds=5.0, quarantine_log=logs[side],
                 rng=random.Random(11))
        draws[side] = [ds[i] for i in (0, 1, 2, 3, 1, 2, 3, 2)]
        draws[side + "_bad"] = sorted(os.path.basename(p) for p in ds.bad)
    assert draws["port_bad"] == draws["jax_bad"] == ["ep3.wav"]
    for a, b in zip(draws["port"], draws["jax"]):
        np.testing.assert_array_equal(a, b)
    assert [len(w) for w in draws["port"]][:3] == [32000, 80000, 80000]
    with open(logs["port"]) as f:
        assert f.read().startswith(str(d / "ep3.wav") + "\t")
