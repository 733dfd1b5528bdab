"""The clustering CLIs and tools of the embedding chain, port against the
JAX package on the CPU:

  * `python -m tal_asrd_tpu_torch.cli.wder` plain, --wer-only, --cluster
    (each engine), --grid-search and --embed-head: the `-wder.pkl` fields
    equal to the JAX CLI's on one seeded pickle (--workers 1);
  * `python -m tal_asrd_tpu_torch.cli.wder_search` plain, --embed-head,
    --mean, --lower-no-punct and --role-based --role-map: the TSV equal line
    for line;
  * both CLIs on the JAX CLI's rows of the synthetic test split against
    tests/fixtures/torch_cluster_reference.json (scripts/
    torch_cluster_reference.py): the TSV through the JAX CLI's head, the
    raw grid's ValueError (ROADMAP C22), the chain's -wder.pkl;
  * `cli.tools wder-format --sd-features --role-map`, `convert_results` at
    word level with SD ids, `_window_embed` (windows clamped at the tail):
    equal within 1e-6;
  * every function of eval/tools.py, `cli.tools merge-outputs`,
    `librispeech-format` on a tiny wav tree and `convert-audio` on a wav:
    the same outputs; a non-wav source without ffmpeg raises naming it.
"""
import importlib.util
import json
import os
import pickle
import shutil
import warnings

import numpy as np
import pytest

import tal_asrd_tpu.eval.convert as jconv
import tal_asrd_tpu.eval.tools as jtools
import tal_asrd_tpu_torch.eval.convert as pconv
import tal_asrd_tpu_torch.eval.tools as ptools
from tal_asrd_tpu.cli import tools as j_tools_cli
from tal_asrd_tpu.cli import wder as j_wder
from tal_asrd_tpu.cli import wder_search as j_search
from tal_asrd_tpu_torch.cli import tools as p_tools_cli
from tal_asrd_tpu_torch.cli import wder as p_wder
from tal_asrd_tpu_torch.cli import wder_search as p_search
from tal_asrd_tpu_torch.core.checkpoint import save_pytree
from tal_asrd_tpu_torch.data.audio_io import write_wav
from tal_asrd_tpu_torch.text.bpe import BpeTokenizer

from tests.test_torch_wder_search import seeded_pairs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BPE = os.path.join(ROOT, "accuracy_release", "bpe.model")


def reference():
    spec = importlib.util.spec_from_file_location(
        "torch_cluster_reference", os.path.join(ROOT, "scripts", "torch_cluster_reference.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def both(tmp_path, name, data):
    """The same pickle in a directory for each package: (jax path, port path)."""
    paths = []
    for side in ("jax", "port"):
        os.makedirs(os.path.join(tmp_path, side), exist_ok=True)
        path = os.path.join(tmp_path, side, name)
        with open(path, "wb") as f:
            pickle.dump(data, f)
        paths.append(path)
    return paths


def head_file(tmp_path, d):
    r = np.random.RandomState(11)
    tree = {f"Dense_{i}": {"kernel": (r.randn(a, b) / np.sqrt(a)).astype(np.float32),
                           "bias": (r.randn(b) * 0.1).astype(np.float32)}
            for i, (a, b) in enumerate(((d, 256), (256, 256), (256, 10)))}
    path = os.path.join(tmp_path, "head.msgpack")
    save_pytree(path, tree)
    return path


def quiet(fn, *a, **k):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(*a, **k)


def fields(path):
    with open(path.replace(".pkl", "-wder.pkl"), "rb") as f:
        return repr({k: [np.asarray(x).tolist() for x in v] if isinstance(v, tuple) else v
                     for k, v in pickle.load(f).items()})


@pytest.fixture(scope="module")
def pairs():
    return seeded_pairs(n_seg=2, n_utt=14, d=12, seed=5)


@pytest.mark.parametrize("flags", [
    [], ["--wer-only"], ["--cluster"], ["--cluster", "--cluster-method", "dbscan",
                                        "--metric", "cos_sim"],
    ["--cluster", "--cluster-method", "gmm", "--metric", "cos_dist"],
    ["--cluster", "--cluster-method", "agglomerative", "--metric", "idp"],
    ["--cluster", "--grid-search", "--n-calls", "3", "--metric", "ndp"],
    ["--cluster", "--cluster-method", "agglomerative", "--metric", "cos_dist", "HEAD"]],
    ids=["plain", "wer_only", "hdbscan", "dbscan", "gmm", "agglomerative", "grid_search",
         "embed_head"])
def test_cli_wder_equal_jax(tmp_path, pairs, flags):
    if "HEAD" in flags:
        flags = flags[:-1] + ["--embed-head", head_file(tmp_path, 12)]
    jp, pp = both(tmp_path, "ready.pkl", pairs)
    quiet(j_wder.main, ["--eval-file", jp, "--workers", "1"] + flags)
    p_wder.main(["--eval-file", pp, "--workers", "1", "--device", "cpu"] + flags)
    assert fields(pp) == fields(jp)


def test_cli_wder_search_tsv_equal(tmp_path, pairs):
    head = head_file(tmp_path, 12)
    tokens = [(r, [(u, (np.stack([e, e * 0.5]) if e is not None else None, s), role)
                   for u, (e, s), role in h]) for r, h in pairs]
    role_map = os.path.join(tmp_path, "roles.json")
    with open(role_map, "w") as f:
        json.dump({"0": "host", "1": "interviewer", "2": "subject"}, f)
    for data, flags in ((pairs, []), (pairs, ["--embed-head", head]),
                        (tokens, ["--mean", "--lower-no-punct"]),
                        (pairs, ["--role-based", "--role-map", role_map])):
        jp, pp = both(tmp_path, "ready.pkl", data)
        jt, pt = jp + ".tsv", pp + ".tsv"
        quiet(j_search.main, ["--eval-file", jp, "--workers", "1", "--out-tsv", jt] + flags)
        p_search.main(["--eval-file", pp, "--workers", "1", "--out-tsv", pt,
                       "--device", "cpu"] + flags)
        with open(jt) as f, open(pt) as g:
            assert g.read() == f.read(), flags


def test_both_clis_against_the_jax_reference_fixture(tmp_path):
    ref = reference()
    with open(ref.FIXTURE) as f:
        fx = json.load(f)
    arrays = np.load(ref.ARRAYS_NPZ)
    head = os.path.join(tmp_path, "head.msgpack")
    save_pytree(head, ref.head_tree(arrays))
    ready = os.path.join(tmp_path, "wder_ready.pkl")
    with open(ready, "wb") as f:
        pickle.dump(ref.paired_results(fx, arrays), f)
    for variant, extra in (("raw", []), ("head", ["--embed-head", head])):
        tsv = os.path.join(tmp_path, f"{variant}.tsv")
        try:
            p_search.main(["--eval-file", ready, "--workers", "1", "--out-tsv", tsv,
                           "--device", "cpu"] + extra)
            with open(tsv) as f:
                got = {"text": f.read(), "raises": None}
        except ValueError as e:
            got = {"text": None, "raises": f"ValueError: {e}"}
        assert got == fx["tsv"][variant]
        out = p_wder.main(["--eval-file", ready, "--cluster", "--cluster-method",
                           fx["chain"][0], "--metric", fx["chain"][1], "--workers", "1",
                           "--device", "cpu"] + extra)
        want = fx["wder_pkl"][variant]
        assert out["overall_wder"] == want["overall_wder"]
        assert [np.asarray(h).tolist() for h in out["hyp_speakers"]] == want["hyp_speakers"]
    assert fx["tsv"]["raw"]["raises"].startswith("ValueError: Fitting the mixture model")


def sd_results(tok):
    """test_result.pkl entries of an unaligned run: attention over 357-frame
    windows, a window past the features' end."""
    r = np.random.RandomState(9)
    results = []
    for seg in range(2):
        refs = [{"utterance": "so the story began", "speaker": "a", "role": "host"},
                {"utterance": "when we left town", "speaker": "b"}]
        hyps = []
        for k, text in enumerate(("so the story began", "when we left town and")):
            ids = tok.encode(text)[1:-1]
            att = r.rand(len(ids), 357).astype(np.float32)
            hyps.append({"utterance": text, "speakerId": k + seg, "utteranceTokens": ids,
                         "attention": att / att.sum(1, keepdims=True),
                         "chunkStart": np.sort(r.randint(0, 700, len(ids)))})
        hyps.append({"utterance": "okay", "speakerId": 3,
                     "speakerEmbed": r.randn(8).astype(np.float32)})
        results.append((refs, hyps))
    return results


def assert_entries_close(want, got):
    assert len(want) == len(got)
    for (jr, jh), (pr, ph) in zip(want, got):
        assert jr == pr
        assert len(jh) == len(ph)
        for j, p in zip(jh, ph):
            assert (j[0], j[1][1], j[2]) == (p[0], p[1][1], p[2])
            np.testing.assert_allclose(p[1][0], j[1][0], rtol=0, atol=1e-6)


def test_wder_format_sd_features_and_word_level_equal(tmp_path):
    tok = BpeTokenizer(model_path=BPE)
    results = sd_results(tok)
    sd = np.random.RandomState(2).randn(900, 8).astype(np.float32)
    np.save(os.path.join(tmp_path, "sd.npy"), sd)
    role_map = os.path.join(tmp_path, "roles.json")
    with open(role_map, "w") as f:
        json.dump({"1": "host"}, f)
    tr = os.path.join(tmp_path, "test_result.pkl")
    with open(tr, "wb") as f:
        pickle.dump(results, f)
    outs = {}
    for side, main, extra in (("jax", j_tools_cli.main, []),
                              ("port", p_tools_cli.main, ["--device", "cpu"])):
        out = os.path.join(tmp_path, f"{side}.pkl")
        main(["wder-format", "--test-result", tr, "--out", out, "--sd-features",
              os.path.join(tmp_path, "sd.npy"), "--role-map", role_map] + extra)
        with open(out, "rb") as f:
            outs[side] = pickle.load(f)
    assert_entries_close(outs["jax"], outs["port"])
    sd_ids = np.random.RandomState(3).randint(0, 4, 900)
    assert_entries_close(
        jconv.convert_results(results, sd_features=sd, sd_ids=sd_ids, word_level=True,
                              tokenizer=tok),
        pconv.convert_results(results, sd_features=sd, sd_ids=sd_ids, word_level=True,
                              tokenizer=tok, device="cpu"))
    att, cs = results[0][1][1]["attention"], np.array([0, 500, 880, 899][:1] * len(
        results[0][1][1]["chunkStart"]))
    np.testing.assert_allclose(pconv._window_embed(att, cs + 880, sd, "cpu"),
                               jconv._window_embed(att, cs + 880, sd), rtol=0, atol=1e-6)


def test_eval_tools_equal(tmp_path):
    texts = ["<S1> Hello, world! <EOT> next", "part <EOS> two. <PAD>", "<EOT> three?"]
    for fn in ("strip_punct", "strip_output"):
        assert [getattr(ptools, fn)(t) for t in texts] == [getattr(jtools, fn)(t)
                                                           for t in texts]
    assert ptools.splice_at_eot(texts) == jtools.splice_at_eot(texts)
    assert ptools.eval_transcripts(texts, texts[::-1]) == \
        jtools.eval_transcripts(texts, texts[::-1])
    utts = [{"u": i} for i in range(5)]
    losses = [0.1, 3.0, 0.5, 2.0, 0.9]
    assert ptools.prune_bad_utterances(utts, losses, 1.0) == \
        jtools.prune_bad_utterances(utts, losses, 1.0)
    paired = [([("a b", 0), ("c", 1, "host")], [("a b", (None, 0)), ("c", 1), ("d", 2, "x")])]
    assert ptools.apply_role_names(paired, {0: "ann"}, {1: "interviewer"}) == \
        jtools.apply_role_names(paired, {0: "ann"}, {1: "interviewer"})
    emb = np.random.RandomState(0).randn(4, 3)
    for roles in (None, ["host", "subject", "host", "x"]):
        j = jtools.export_tsne(emb, [0, 1, 0, 2], roles, os.path.join(tmp_path, "j"))
        p = ptools.export_tsne(emb, [0, 1, 0, 2], roles, os.path.join(tmp_path, "p"))
        for a, b in zip(j, p):
            with open(a) as f, open(b) as g:
                assert g.read() == f.read()


def test_merge_librispeech_and_convert_audio_equal(tmp_path):
    shards = []
    for k in range(2):
        path = os.path.join(tmp_path, f"shard{k}.jsonl")
        with open(path, "w") as f:
            f.write("\n".join(json.dumps({"i": k * 10 + i, "text": f"t{i}"})
                              for i in range(3)) + "\n\n")
        shards.append(path)
    src = os.path.join(tmp_path, "libri")
    r = np.random.RandomState(4)
    for spk in ("19", "26"):
        chap = os.path.join(src, spk, "198")
        os.makedirs(chap)
        with open(os.path.join(chap, f"{spk}-198.trans.txt"), "w") as f:
            for u in range(2):
                f.write(f"{spk}-198-000{u} HELLO THERE NUMBER {u}\n")
                write_wav(os.path.join(chap, f"{spk}-198-000{u}.wav"),
                          0.1 * r.randn(8000 + 800 * u).astype(np.float32))
    got = {}
    for side, main in (("jax", j_tools_cli.main), ("port", p_tools_cli.main)):
        out = os.path.join(tmp_path, side)
        main(["merge-outputs", "--inputs", *shards, "--out", out + ".pkl"])
        main(["librispeech-format", "--src", src, "--out-dir", out])
        main(["convert-audio", "--src", os.path.join(src, "19", "198", "19-198-0001.wav"),
              "--out-dir", out + "_wav"])
        names = sorted(os.listdir(out)) + sorted(os.listdir(out + "_wav"))
        blobs = [open(os.path.join(out, n), "rb").read() for n in sorted(os.listdir(out))]
        blobs += [open(out + ".pkl", "rb").read(),
                  open(os.path.join(out + "_wav", "19-198-0001.wav"), "rb").read()]
        got[side] = (names, blobs)
    assert got["port"] == got["jax"]
    if shutil.which("ffmpeg") is None:
        flac = os.path.join(tmp_path, "x.flac")
        open(flac, "wb").close()
        with pytest.raises(RuntimeError, match="ffmpeg"):
            p_tools_cli.main(["convert-audio", "--src", flac, "--out-dir",
                              os.path.join(tmp_path, "f")])
