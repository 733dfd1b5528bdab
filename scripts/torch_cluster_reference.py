#!/usr/bin/env python3
"""The reference partitions of the embedding chain's clustering half, from the JAX package on the CPU.

    python3 scripts/torch_cluster_reference.py

Writes tests/fixtures/torch_cluster_reference.json and, for the arrays,
tests/fixtures/torch_cluster_reference_arrays.npz. JAX on the CPU
(JAX_PLATFORMS=cpu), where scikit-learn is:

  * The pickle: the test split's 118 rows of `cli.gen_embed` in f32
    (tests/fixtures/torch_embed_reference_arrays.npz, `gen_embed/card`;
    scripts/ensure_corpus.sh's test split, seed 202, 4 x 180 s, 8
    speakers), grouped by episode into a wder-ready pickle: one segment an
    episode (its rows in the eval loader's order), ref utterances (text,
    speaker, role), hyp utterances (the same text, (row, argmax of the
    row's speaker posteriors), "subject"). WER is 0: only the diarization
    is scored. Every episode has at least MIN_UNIQUE unique rows (fewer
    and the grid's PCA-16 leg raises, ROADMAP C20).
  * The head: `python -m tal_asrd_tpu.cli.train_embed` at its defaults on
    the JAX CLI's train-split rows (`gen_embed/train8`), ~30 s; its tree
    goes to the arrays (`head/Dense_i/kernel|bias`), the rows mapped
    through it by `apply_embed_head` to `head_rows`.
  * grid: the labels of every parameter set of `default_param_grid()` on
    each segment, raw and through the head, as `corpus_wder_map` computes
    them at workers 1 after np.random.seed(2020) (the CLI's draws), or the
    ValueError a set raises (ROADMAP C22: the GMM on the raw 64-wide
    rows), with the cosine-distance matrices XLA's CPU product gave
    (`cos/...`) and, of every Bayesian GMM, its input, its k-means labels
    and its lower bound a variational step (`gmm/...`; whether it
    converged in the JSON's `gmm`).
  * wder: the labels of `cli.wder --cluster` for each of its four methods
    and five metrics on each segment, raw and through the head, each run
    from np.random.seed(2020) at --workers 1 (or the ValueError it stops
    at); and the `-wder.pkl` fields of the chain's run (agglomerative,
    cos_dist).
  * tsv: `python -m tal_asrd_tpu.cli.wder_search --workers 1`'s TSV, raw
    and with --embed-head, or the ValueError it stops at.

`paired_results` and `head_tree` rebuild the pickle and the head from the
fixture with numpy alone (chip_smoke.py and the tests call them). The
committed fixture was made on an 8-core x86 CPU; `seconds` holds the run's
time.
"""
from __future__ import annotations

import json
import os
import pickle
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_cluster_reference.json")
ARRAYS_NPZ = os.path.join(ROOT, "tests", "fixtures", "torch_cluster_reference_arrays.npz")
EMBED_ARRAYS = os.path.join(ROOT, "tests", "fixtures", "torch_embed_reference_arrays.npz")
TOKENIZER = "accuracy_release/bpe.model"
SPLIT = dict(n_episodes=4, episode_seconds=180.0, n_speakers=8, seed=202)
MIN_UNIQUE = 16
MAX_SECS = 20.0             # the eval CLI's --max-secs default
WDER_METHODS = ("hdbscan", "dbscan", "agglomerative", "gmm")
WDER_METRICS = ("euclidean", "cos_sim", "cos_dist", "idp", "ndp")
CHAIN = ("agglomerative", "cos_dist")          # scripts/embed_chain.sh step 3


# --- numpy alone: the pickle and the head from the fixture -------------------------

def paired_results(fixture: dict, arrays, head: bool = False):
    """The wder-ready pickle's pairs; `head`: the hyp rows are the JAX
    head's images of them."""
    rows = arrays["head_rows" if head else "rows"]
    return [([(u["text"], u["speaker"], u["role"]) for u in seg],
             [(u["text"], (rows[u["row"]], u["hyp_id"]), "subject") for u in seg])
            for seg in fixture["segments"]]


def head_tree(arrays) -> dict:
    """The JAX CLI's head as its flax tree {Dense_i: {kernel, bias}}."""
    tree = {}
    for key in arrays.files:
        if key.startswith("head/"):
            _, layer, leaf = key.split("/")
            tree.setdefault(layer, {})[leaf] = arrays[key]
    return tree


def pset_key(pset) -> str:
    return str(tuple(pset))


# --- JAX on the CPU --------------------------------------------------------------------

def build_segments(split_dir: str, ids: np.ndarray, probs: np.ndarray):
    """The eval loader's items of the split (AlignedDataset, single
    utterances, in order), grouped by episode."""
    from tal_asrd_tpu_torch.data.aligned import AlignedDataset
    from tal_asrd_tpu_torch.data.synth import build_synth_corpus
    from tal_asrd_tpu_torch.text.bpe import BpeTokenizer

    build_synth_corpus(split_dir, **SPLIT)
    tok = BpeTokenizer(model_path=os.path.join(ROOT, TOKENIZER))
    ds = AlignedDataset(split_dir, tok, num_utterances=1, max_segment_duration=MAX_SECS,
                        speaker_map_loc=os.path.join(split_dir, "speaker_map.json"),
                        tokenizer_speakers=True, return_spk_ids=True)
    if len(ds) != len(ids):
        raise SystemExit(f"{len(ds)} items, {len(ids)} rows")
    with open(os.path.join(split_dir, "speaker_map.json")) as f:
        speaker_map = json.load(f)
    segments = {}
    for i, (stub, (utt,)) in enumerate(ds.index):
        if speaker_map[utt["speaker"]] != ids[i]:
            raise SystemExit(f"row {i}: speaker {utt['speaker']} is not id {ids[i]}")
        segments.setdefault(stub, []).append({
            "row": i, "text": utt["utterance"], "speaker": utt["speaker"],
            "role": utt.get("role", "subject"), "hyp_id": int(probs[i].argmax())})
    return [segments[k] for k in sorted(segments)]


def train_head(tmp: str, embed_arrays) -> str:
    from tal_asrd_tpu_torch.eval.gen_embed import save_split
    stem = os.path.join(tmp, "spk_train8")
    save_split(embed_arrays["gen_embed/train8/rows"], embed_arrays["gen_embed/train8/ids"],
               stem)
    head = os.path.join(tmp, "head.msgpack")
    subprocess.run([sys.executable, "-m", "tal_asrd_tpu.cli.train_embed", "--train-data",
                    stem + ".train.pkl", "--valid-data", stem + ".valid.pkl", "--out", head],
                   check=True, cwd=ROOT, env=dict(os.environ, JAX_PLATFORMS="cpu",
                                                  PYTHONPATH=ROOT))
    return head


def record_grid(paired, variant):
    """What corpus_wder_map computes at workers 1 from np.random.seed(2020):
    every segment's labels under every parameter set, in its order, or the
    ValueError a set raises (the CLI stops at the first; here the later
    sets go on from the same draws); XLA's cosine matrices; and of each
    Bayesian GMM its input, its k-means labels and its lower bounds a
    variational step (scikit-learn's `lower_bounds_`), with whether it
    converged."""
    import sklearn.cluster
    import sklearn.mixture

    import tal_asrd_tpu.eval.clustering as jc
    import tal_asrd_tpu.eval.wder_search as jws

    arrays, gmm, seg = {}, {}, [0, None]
    real_cos = jc.cosine_distance_matrix
    real_fit = sklearn.mixture.BayesianGaussianMixture.fit_predict
    real_km = sklearn.cluster.KMeans.fit

    def cos(x, use_device=True):
        d = real_cos(x, use_device)
        arrays[f"cos/{variant}/seg{seg[0]}/d{x.shape[1]}"] = d.astype(np.float32)
        return d

    def km(self, x, *a, **k):
        out = real_km(self, x, *a, **k)
        arrays[f"gmm/{variant}/seg{seg[0]}/{seg[1]}/km"] = np.asarray(self.labels_)
        return out

    def fit(self, x, *a, **k):
        key = f"gmm/{variant}/seg{seg[0]}/{seg[1]}"
        arrays[key + "/x"] = np.array(x)
        try:
            return real_fit(self, x, *a, **k)
        finally:
            arrays[key + "/lb"] = np.asarray(getattr(self, "lower_bounds_", []), np.float64)
            gmm[f"{seg[0]}/{seg[1]}"] = {"n_iter": int(getattr(self, "n_iter_", 0)),
                                         "converged": bool(getattr(self, "converged_", False))}

    jc.cosine_distance_matrix = cos
    sklearn.mixture.BayesianGaussianMixture.fit_predict = fit
    sklearn.cluster.KMeans.fit = km
    grid = []
    try:
        np.random.seed(2020)
        for seg[0], (_, hyp_us) in enumerate(paired):
            table = jws.get_word_speakers(hyp_us, embeddings=True)[4]
            out = {}
            for seg[1], pset in enumerate(jws.default_param_grid()[1:]):
                try:
                    out[pset_key(pset)] = np.asarray(
                        jws.cluster_param_labels(table, pset)).tolist()
                except ValueError as e:
                    out[pset_key(pset)] = f"ValueError: {e}"
            grid.append(out)
    finally:
        jc.cosine_distance_matrix = real_cos
        sklearn.mixture.BayesianGaussianMixture.fit_predict = real_fit
        sklearn.cluster.KMeans.fit = real_km
    return grid, gmm, arrays


def record_wder(eval_file: str, head: str = None):
    """cli.wder --cluster for every method and metric (labels per segment),
    and the chain's -wder.pkl."""
    import tal_asrd_tpu.cli.wder as jw

    out, chain_fields = {}, None
    real = jw.make_cluster_fn
    for method in WDER_METHODS:
        for metric in WDER_METRICS:
            got = []

            def make(*a, **k):
                fn = real(*a, **k)

                def rec(emb, **extra):
                    lab = fn(emb, **extra)
                    got.append(np.asarray(lab).tolist())
                    return lab
                return rec

            jw.make_cluster_fn = make
            raises = None
            try:
                jw.main(["--eval-file", eval_file, "--cluster", "--cluster-method", method,
                         "--metric", metric, "--workers", "1"]
                        + (["--embed-head", head] if head else []))
            except ValueError as e:
                raises = f"ValueError: {e}"
            finally:
                jw.make_cluster_fn = real
            out[f"{method}/{metric}"] = {"labels": got, "raises": raises}
            if (method, metric) == CHAIN:
                with open(eval_file.replace(".pkl", "-wder.pkl"), "rb") as f:
                    fields = pickle.load(f)
                chain_fields = {"overall_wder": fields["overall_wder"],
                                "overall_wer": fields["overall_wer"],
                                "dist": list(fields["dist"]), "n_words": list(fields["n_words"]),
                                "hyp_speakers": [np.asarray(h).tolist()
                                                 for h in fields["hyp_speakers"]],
                                "ref_speakers": [np.asarray(r).tolist()
                                                 for r in fields["ref_speakers"]]}
    return out, chain_fields


def main() -> None:
    sys.path[:0] = [ROOT]
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    jax.config.update("jax_platforms", "cpu")
    from tal_asrd_tpu.cli import wder_search as jcli_search
    from tal_asrd_tpu.core.checkpoint import load_pytree
    from tal_asrd_tpu.eval.wder_search import apply_embed_head

    t0 = time.perf_counter()
    embed = np.load(EMBED_ARRAYS)
    rows = embed["gen_embed/card/rows"]
    fixture = {"what": "JAX CPU reference of the embedding chain's clustering half "
                       "(scripts/torch_cluster_reference.py)",
               "rows": "tests/fixtures/torch_embed_reference_arrays.npz gen_embed/card",
               "split": SPLIT, "min_unique": MIN_UNIQUE, "chain": list(CHAIN)}
    with tempfile.TemporaryDirectory() as tmp:
        fixture["segments"] = build_segments(os.path.join(tmp, "split"),
                                             embed["gen_embed/card/ids"],
                                             embed["gen_embed/card/probs"])
        for seg in fixture["segments"]:
            unique = len({rows[u["row"]].tobytes() for u in seg})
            if unique < MIN_UNIQUE:
                raise SystemExit(f"a segment has {unique} unique rows (< {MIN_UNIQUE})")
        arrays = {"rows": rows}
        head = train_head(tmp, embed)
        for layer, leaves in load_pytree(head).items():
            for leaf, v in leaves.items():
                arrays[f"head/{layer}/{leaf}"] = np.asarray(v, np.float32)
        raw = paired_results(fixture, arrays)
        mapped = apply_embed_head(raw, head)
        head_rows = np.zeros((len(rows), mapped[0][1][0][1][0].shape[0]), np.float32)
        for seg, (_, hyps) in zip(fixture["segments"], mapped):
            for u, (_, (emb, _), _) in zip(seg, hyps):
                head_rows[u["row"]] = emb
        arrays["head_rows"] = head_rows

        for key in ("grid", "gmm", "wder", "tsv", "wder_pkl"):
            fixture[key] = {}
        for variant, paired in (("raw", raw), ("head", mapped)):
            fixture["grid"][variant], fixture["gmm"][variant], new = record_grid(
                paired, variant)
            arrays.update(new)
        eval_file = os.path.join(tmp, "wder_ready.pkl")
        with open(eval_file, "wb") as f:
            pickle.dump(raw, f)
        head_path = os.path.join(tmp, "head.msgpack")
        for variant, extra in (("raw", None), ("head", head_path)):
            fixture["wder"][variant], fixture["wder_pkl"][variant] = record_wder(
                eval_file, extra)
            tsv = os.path.join(tmp, f"grid_{variant}.tsv")
            try:
                jcli_search.main(["--eval-file", eval_file, "--workers", "1",
                                  "--out-tsv", tsv]
                                 + (["--embed-head", head_path] if extra else []))
                with open(tsv) as f:
                    fixture["tsv"][variant] = {"text": f.read(), "raises": None}
            except ValueError as e:
                fixture["tsv"][variant] = {"text": None, "raises": f"ValueError: {e}"}
    fixture["commands"] = {
        "wder": "JAX_PLATFORMS=cpu python -m tal_asrd_tpu.cli.wder --eval-file PKL "
                "--cluster --cluster-method M --metric X --workers 1 [--embed-head HEAD]",
        "wder_search": "JAX_PLATFORMS=cpu python -m tal_asrd_tpu.cli.wder_search "
                       "--eval-file PKL --workers 1 [--embed-head HEAD]",
        "head": "JAX_PLATFORMS=cpu python -m tal_asrd_tpu.cli.train_embed "
                "--train-data T --valid-data V --out HEAD (gen_embed/train8 rows)"}
    fixture["seconds"] = time.perf_counter() - t0
    np.savez_compressed(ARRAYS_NPZ, **arrays)
    with open(FIXTURE, "w") as f:
        json.dump(fixture, f, indent=None, separators=(",", ":"))
        f.write("\n")
    print(f"wrote {FIXTURE} ({fixture['seconds']:.1f} s)", flush=True)


if __name__ == "__main__":
    main()
