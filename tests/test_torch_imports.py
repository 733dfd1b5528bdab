"""The port stands alone: importing every module of tal_asrd_tpu_torch (and
chip_smoke.py) pulls in neither jax, flax, optax nor the JAX package, builds
no kernel and needs no GPU; and every entry point's `device` defaults to
"cuda"."""
import inspect
import os
import pkgutil
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_modules():
    import tal_asrd_tpu_torch
    return sorted(m.name for m in pkgutil.walk_packages(
        tal_asrd_tpu_torch.__path__, "tal_asrd_tpu_torch."))


def test_importing_every_port_module_leaves_jax_out():
    mods = _port_modules()
    assert len(mods) >= 16, mods
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        f"for m in {mods!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'tal_asrd_tpu', 'msgpack', 'ml_dtypes', 'triton'))\n"
        "print('BAD=' + ','.join(bad))\n"
        "import tal_asrd_tpu_torch.ops._build as b\n"
        "print('BUILT=' + str(b._lib is not None))\n"
    )
    # -S -E: no site customisation, no inherited PYTHON* variables, so only
    # the port's own imports decide what ends up in sys.modules; site-packages
    # is put back by hand for torch and numpy.
    site_dirs = [p for p in sys.path if p.endswith("site-packages")]
    boot = f"import sys; sys.path.extend({site_dirs!r})\n"
    res = subprocess.run([sys.executable, "-S", "-E", "-c", boot + code],
                         capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "BAD=\n" in res.stdout + "\n", res.stdout
    assert "BUILT=False" in res.stdout


def test_no_source_line_imports_jax_or_the_jax_package():
    pat = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|tal_asrd_tpu)(\.|\s|$)")
    hits = []
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _, names in os.walk(os.path.join(ROOT, "tal_asrd_tpu_torch")):
        files += [os.path.join(base, n) for n in names if n.endswith(".py")]
    for path in files:
        with open(path) as f:
            hits += [f"{path}:{i}" for i, line in enumerate(f, 1) if pat.match(line)]
    assert not hits, hits


def test_the_long_form_modules_are_among_the_checked_ones():
    mods = set(_port_modules())
    assert {"tal_asrd_tpu_torch.ops.ngram", "tal_asrd_tpu_torch.decode.unaligned",
            "tal_asrd_tpu_torch.decode.transcribe", "tal_asrd_tpu_torch.vad.core",
            "tal_asrd_tpu_torch.vad.webrtc_gmm", "tal_asrd_tpu_torch.vad.windows",
            "tal_asrd_tpu_torch.vad.eval", "tal_asrd_tpu_torch.vad.pipeline",
            "tal_asrd_tpu_torch.cli.vad", "tal_asrd_tpu_torch.cli.transcribe"} <= mods
    # the neural SAD (ROADMAP A18) is ported too
    assert {"tal_asrd_tpu_torch.vad.sad", "tal_asrd_tpu_torch.vad.pyannet",
            "tal_asrd_tpu_torch.cli.sad"} <= mods


def test_the_training_cli_modules_are_among_the_checked_ones():
    mods = set(_port_modules())
    assert {"tal_asrd_tpu_torch.cli.train", "tal_asrd_tpu_torch.cli.tools",
            "tal_asrd_tpu_torch.core.utils", "tal_asrd_tpu_torch.data.segment"} <= mods


def test_the_lm_modules_are_among_the_checked_ones():
    mods = set(_port_modules())
    assert {"tal_asrd_tpu_torch.models.lm", "tal_asrd_tpu_torch.train.lm_system",
            "tal_asrd_tpu_torch.cli.train_lm"} <= mods


def test_the_reference_decode_and_embedding_modules_are_among_the_checked_ones():
    mods = set(_port_modules())
    assert {"tal_asrd_tpu_torch.decode.reference_mode", "tal_asrd_tpu_torch.decode.sharded",
            "tal_asrd_tpu_torch.eval.gen_embed", "tal_asrd_tpu_torch.cli.gen_embed",
            "tal_asrd_tpu_torch.train.embed_system", "tal_asrd_tpu_torch.cli.train_embed",
            "tal_asrd_tpu_torch.data.audio"} <= mods
    import tal_asrd_tpu_torch.data as data
    import tal_asrd_tpu_torch.decode as decode
    import tal_asrd_tpu_torch.eval as eval_pkg
    import tal_asrd_tpu_torch.train as train
    for pkg, names in ((decode, ("greedy_noncausal", "make_sharded_decode",
                                 "make_sharded_unaligned")),
                       (eval_pkg, ("generate_speaker_embeddings", "save_split")),
                       (train, ("ContrastiveCollator", "ContrastiveDataset", "EmbedSystem")),
                       (data, ("RandomSegmentDataset",))):
        assert set(names) <= set(pkg.__all__) and all(hasattr(pkg, n) for n in pkg.__all__)


def test_the_speaker_baseline_and_sad_modules_are_among_the_checked_ones():
    mods = set(_port_modules())
    assert {"tal_asrd_tpu_torch.models.sd", "tal_asrd_tpu_torch.baseline",
            "tal_asrd_tpu_torch.baseline.sd_system", "tal_asrd_tpu_torch.baseline.reconcile",
            "tal_asrd_tpu_torch.data.baseline_speaker", "tal_asrd_tpu_torch.cli.train_sd",
            "tal_asrd_tpu_torch.vad.pyannet", "tal_asrd_tpu_torch.vad.sad",
            "tal_asrd_tpu_torch.cli.sad"} <= mods
    import tal_asrd_tpu_torch.baseline as baseline
    import tal_asrd_tpu_torch.data as data
    import tal_asrd_tpu_torch.vad as vad
    from tal_asrd_tpu_torch.cli import tools
    for pkg, names in ((baseline, ("SDSystem", "dump_episode_features", "frame_gold_speakers",
                                   "merge_asr_sd", "utterance_frame_span")),
                       (data, ("SDUtteranceDataset", "SDCollater")),
                       (vad, ("PyanNet", "SincConv", "score_episode", "frame_labels",
                              "n_frames", "binarize", "export_corpus", "to_rttm", "to_uem"))):
        assert set(names) <= set(pkg.__all__) and all(hasattr(pkg, n) for n in pkg.__all__)
    assert not hasattr(tools, "UNPORTED")      # every subcommand is ported


def test_the_diarization_and_alignment_modules_are_among_the_checked_ones():
    """First diarization (A17) and alignment (A19) are ported, with the JAX
    package's __all__."""
    mods = set(_port_modules())
    assert {"tal_asrd_tpu_torch.diarization.gru", "tal_asrd_tpu_torch.diarization.uisrnn",
            "tal_asrd_tpu_torch.diarization.wav2vec", "tal_asrd_tpu_torch.diarization.evals",
            "tal_asrd_tpu_torch.diarization.experiment", "tal_asrd_tpu_torch.diarization.dvec",
            "tal_asrd_tpu_torch.cli.uisrnn", "tal_asrd_tpu_torch.align.dtw",
            "tal_asrd_tpu_torch.align.mfcc", "tal_asrd_tpu_torch.align.forced"} <= mods
    import tal_asrd_tpu_torch.align as align
    import tal_asrd_tpu_torch.diarization as diarization
    from tal_asrd_tpu_torch.diarization.dvec import DVEC_SOURCES
    want = {
        diarization: ["UISRNN", "UISRNNConfig", "UISRNNInferenceConfig", "UISRNNTrainConfig",
                      "estimate_transition_bias", "resize_sequence", "diarization_error_rate",
                      "evaluate_result", "GRU", "GRUCell", "ConvAggregator",
                      "ConvFeatureExtractor", "Wav2VecFeatures", "extract_corpus_features",
                      "extract_utterance_features", "init_wav2vec", "kfold_experiment",
                      "streaming_fit"],
        align: ["dtw_cost_matrix", "dtw_path", "monotonic_segmentation", "mfcc", "dct_matrix",
                "align_episode", "align_utterance", "full_force_align", "token_word_groups"]}
    for pkg, names in want.items():
        assert pkg.__all__ == names and all(hasattr(pkg, n) for n in names)
    assert all(s.startswith("tal_asrd_tpu_torch.") and s in mods for s in DVEC_SOURCES)


@pytest.mark.parametrize("script,call", [
    ("torch_sd_reference.py",
     "t = mod.seeded_sd_tree({'encoder': {'w': np.ones(3, np.float32)}}, 0, num_speakers=5,\n"
     "                       embed_size=4, enc_channels=6)\n"
     "assert t['spk_logit_proj']['kernel'].shape == (4, 5)\n"
     "assert t['encoder']['w'].dtype == np.float32\n"),
    ("torch_sad_reference.py",
     "t = mod.seeded_pyannet_tree(0)\n"
     "assert t['OptimizedLSTMCell_3']['ii']['kernel'].shape == (256, 128)\n"
     "assert t['Conv_0']['kernel'].shape == (5, 80, 60)\n"),
    ("torch_optim_reference.py",
     "g = mod.leaf_gradients([np.ones((3, 2), np.float32), np.full((), 2, np.float32)], 0)\n"
     "assert g[0].shape == (3, 2) and g[1].shape == () and g[0].dtype == np.float32\n"
     "assert mod.sample(np.arange(10000.0))[1] == 2\n"
     "assert mod.flat_state({'a': {'b': np.ones(2)}, 'c': 1}) .keys() == {'a/b', 'c'}\n"),
    ("torch_diar_reference.py",
     "sd = mod.seeded_fairseq_state_dict(0)\n"
     "assert sd['feature_aggregator.conv_layers.8.1.weight'].shape == (512, 512, 3)\n"
     "t = mod.unflat_tree(mod.flat_tree({'a': {'b': np.ones(2)}}, 'x'), 'x')\n"
     "assert t['a']['b'].tolist() == [1, 1]\n")])
def test_the_baseline_reference_scripts_build_their_trees_with_numpy_alone(script, call):
    """scripts/torch_sd_reference.py's `seeded_sd_tree`,
    scripts/torch_sad_reference.py's `seeded_pyannet_tree`,
    scripts/torch_optim_reference.py's `leaf_gradients`, `sample` and
    `flat_state` and scripts/torch_diar_reference.py's
    `seeded_fairseq_state_dict` (chip_smoke.py rebuilds them on the card)
    import numpy only."""
    code = (
        "import importlib.util, sys\n"
        "import numpy as np\n"
        f"spec = importlib.util.spec_from_file_location('r', {os.path.join(ROOT, 'scripts', script)!r})\n"
        "mod = importlib.util.module_from_spec(spec); spec.loader.exec_module(mod)\n"
        + call +
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'tal_asrd_tpu', 'tal_asrd_tpu_torch', 'torch'))\n"
        "print('BAD=' + ','.join(bad))\n"
    )
    site_dirs = [p for p in sys.path if p.endswith("site-packages")]
    boot = f"import sys; sys.path.extend({site_dirs!r})\n"
    res = subprocess.run([sys.executable, "-S", "-E", "-c", boot + code],
                         capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "BAD=\n" in res.stdout + "\n", res.stdout


def test_the_speaker_head_reference_script_builds_its_tree_with_numpy_alone():
    """scripts/torch_spk_reference.py's `seeded_spk_tree` (chip_smoke.py
    rebuilds the speaker-head tree with it on the card) imports numpy only:
    neither torch nor JAX nor the JAX package."""
    code = (
        "import importlib.util, sys\n"
        "import numpy as np\n"
        f"spec = importlib.util.spec_from_file_location('r', {os.path.join(ROOT, 'scripts', 'torch_spk_reference.py')!r})\n"
        "mod = importlib.util.module_from_spec(spec); spec.loader.exec_module(mod)\n"
        "tracked = {'encoder': {'w': np.zeros(3)}, 'decoder_proj': {'kernel': np.zeros((4, 2))},\n"
        "           'decoder': {}, 'embedding_proj': np.zeros((2, 2)),\n"
        "           'embedding': {'embedding': np.arange(10 * 2).reshape(10, 2)}}\n"
        "t = mod.seeded_spk_tree(tracked, 6, 0, 0.4, enc_channels=4, d=2, ff=4, layers=1,\n"
        "                        spk_embed=3, speakers=4, speaker_slots=(1, 2, 3, 5))\n"
        "assert t['embedding']['embedding'][[1, 2, 3, 5]].tolist() == tracked['embedding']['embedding'][6:].tolist()\n"
        "assert t['speaker_head_2']['kernel'].shape == (3, 4)\n"
        "assert float(t['spk_decoder']['layers_0']['resweight']) == np.float32(0.4)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'tal_asrd_tpu', 'tal_asrd_tpu_torch', 'torch'))\n"
        "print('BAD=' + ','.join(bad))\n"
    )
    site_dirs = [p for p in sys.path if p.endswith("site-packages")]
    boot = f"import sys; sys.path.extend({site_dirs!r})\n"
    res = subprocess.run([sys.executable, "-S", "-E", "-c", boot + code],
                         capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "BAD=\n" in res.stdout + "\n", res.stdout


# The JAX package's exports that the port leaves out: none since
# parallelism (ROADMAP A13) is ported.
NOT_YET_PORTED = {}


def test_the_optimizer_and_utility_modules_are_among_the_checked_ones():
    """A12.3, A20 and A13: the modules are ported, and every sub-package the
    JAX package re-exports from (and the top level) exports the JAX names,
    less NOT_YET_PORTED."""
    import importlib
    mods = set(_port_modules())
    assert {"tal_asrd_tpu_torch.utils.flops", "tal_asrd_tpu_torch.utils.profiling",
            "tal_asrd_tpu_torch.text.spm_import", "tal_asrd_tpu_torch.text.gpt2"} <= mods
    assert {"tal_asrd_tpu_torch.parallel.mesh", "tal_asrd_tpu_torch.parallel.tensor",
            "tal_asrd_tpu_torch.parallel.launch"} <= mods
    for sub in ("", ".core", ".ops", ".text", ".models", ".utils", ".train", ".parallel"):
        ref = importlib.import_module("tal_asrd_tpu" + sub)
        mine = importlib.import_module("tal_asrd_tpu_torch" + sub)
        want = [n for n in ref.__all__ if n not in NOT_YET_PORTED.get(sub[1:], set())]
        if sub == ".train":       # optax transformations -> torch.optim classes
            renamed = {"lamb": "LAMB", "radam": "RAdam", "adafactor": "Adafactor",
                       "lookahead": "Lookahead"}
            want = [renamed.get(n, n) for n in want if n != "TrainState"]
            assert set(want) <= set(mine.__all__), sorted(set(want) - set(mine.__all__))
        else:
            assert mine.__all__ == want, sub
        assert all(hasattr(mine, n) for n in mine.__all__), sub
    assert hasattr(importlib.import_module("tal_asrd_tpu_torch.core"), "MeshConfig")
    assert hasattr(importlib.import_module("tal_asrd_tpu_torch.parallel"), "init_distributed")


CLUSTERING_MODULES = ["tal_asrd_tpu_torch.eval.engines", "tal_asrd_tpu_torch.eval.clustering",
                      "tal_asrd_tpu_torch.eval.wder_search", "tal_asrd_tpu_torch.eval.tools",
                      "tal_asrd_tpu_torch.eval.convert", "tal_asrd_tpu_torch.eval.wder",
                      "tal_asrd_tpu_torch.cli.wder", "tal_asrd_tpu_torch.cli.wder_search",
                      "tal_asrd_tpu_torch.cli.tools"]


def test_the_clustering_modules_run_with_sklearn_joblib_and_jax_blocked():
    """The embedding chain's clustering half imports and clusters (every
    engine, PCA, a GMM, workers 2) with sklearn, joblib, jax and the JAX
    package set to None in sys.modules: any import of them raises."""
    assert set(CLUSTERING_MODULES) <= set(_port_modules())
    code = (
        "import importlib, sys\n"
        "for name in ('sklearn', 'joblib', 'jax', 'jaxlib', 'flax', 'tal_asrd_tpu'):\n"
        "    sys.modules[name] = None\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        f"for m in {CLUSTERING_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "import numpy as np\n"
        "from tal_asrd_tpu_torch.eval.clustering import cluster_embeddings\n"
        "from tal_asrd_tpu_torch.eval.wder_search import corpus_wder_map, default_param_grid\n"
        "r = np.random.RandomState(0)\n"
        "x = np.concatenate([r.randn(10, 20) + 4 * k for k in range(2)]).astype(np.float32)\n"
        "for method in ('hdbscan', 'dbscan', 'agglomerative', 'gmm', 'id'):\n"
        "    for metric in ('euclidean', 'cos_dist', 'idp'):\n"
        "        cluster_embeddings(x, method, metric, 16, device='cpu',\n"
        "                           rng=np.random.RandomState(1))\n"
        "pairs = [([(f'w{i} x', i % 2, 'host') for i in range(20)],\n"
        "          [(f'w{i} x', (x[i], i % 2), 'subject') for i in range(20)])] * 2\n"
        "grid = [p for p in default_param_grid() if p[0] != 'gmm']\n"
        "assert corpus_wder_map(pairs, grid, workers=2, device='cpu') == \\\n"
        "    corpus_wder_map(pairs, grid, workers=1, device='cpu')\n"
        "print('OK')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "OK" in res.stdout


def test_no_port_file_names_sklearn_or_joblib():
    pat = re.compile(r"\b(sklearn|joblib)\b")
    hits = []
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _, names in os.walk(os.path.join(ROOT, "tal_asrd_tpu_torch")):
        files += [os.path.join(base, n) for n in names if n.endswith(".py")]
    for path in files:
        with open(path) as f:
            hits += [f"{path}:{i}" for i, line in enumerate(f, 1) if pat.search(line)]
    assert not hits, hits


@pytest.mark.parametrize("target", ["ASRModel", "make_generate_fn", "ASRSystem",
                                    "EvalRunner", "cli.test", "Transcriber",
                                    "cli.transcribe", "cli.vad", "cli.train",
                                    "cli.train_lm", "DecoderLMModel", "LMSystem",
                                    "cli.gen_embed", "cli.train_embed", "EmbedSystem",
                                    "cli.wder", "cli.wder_search", "cli.tools wder-format",
                                    "cluster_embeddings", "apply_embed_head",
                                    "convert_results", "cli.train_sd", "cli.sad", "SDModel",
                                    "SDSystem", "PyanNet"])
def test_entry_points_default_to_cuda(target):
    from tal_asrd_tpu_torch.baseline import SDSystem
    from tal_asrd_tpu_torch.cli import sad as cli_sad
    from tal_asrd_tpu_torch.cli import train_embed as cli_train_embed
    from tal_asrd_tpu_torch.cli import train_sd as cli_train_sd
    from tal_asrd_tpu_torch.cli import transcribe as cli_transcribe
    from tal_asrd_tpu_torch.cli import wder as cli_wder
    from tal_asrd_tpu_torch.cli import wder_search as cli_wder_search
    from tal_asrd_tpu_torch.cli import vad as cli_vad
    from tal_asrd_tpu_torch.cli.args import get_argparser, get_lm_argparser
    from tal_asrd_tpu_torch.decode.beam import make_generate_fn
    from tal_asrd_tpu_torch.decode.transcribe import Transcriber
    from tal_asrd_tpu_torch.eval.clustering import cluster_embeddings
    from tal_asrd_tpu_torch.eval.convert import convert_results
    from tal_asrd_tpu_torch.eval.runner import EvalRunner
    from tal_asrd_tpu_torch.eval.wder_search import apply_embed_head
    from tal_asrd_tpu_torch.models.asr import ASRModel
    from tal_asrd_tpu_torch.models.lm import DecoderLMModel
    from tal_asrd_tpu_torch.models.sd import SDModel
    from tal_asrd_tpu_torch.vad.pyannet import PyanNet
    from tal_asrd_tpu_torch.train.embed_system import EmbedSystem
    from tal_asrd_tpu_torch.train.lm_system import LMSystem
    from tal_asrd_tpu_torch.train.system import ASRSystem
    parsers = {  # python -m tal_asrd_tpu_torch.cli.<name>: --device
        "cli.test": (get_argparser, ["--train-data", "d", "--valid-data", "d",
                                     "--tokenizer", "t", "--model-type", "1x"]),
        "cli.transcribe": (cli_transcribe.get_parser, ["--audio", "a", "--load", "c",
                                                       "--tokenizer", "t"]),
        "cli.vad": (cli_vad.get_parser, ["--data-dir", "d", "--out-dir", "o"]),
        "cli.train": (lambda: get_argparser(is_train=True),
                      ["--train-data", "d", "--valid-data", "d", "--tokenizer", "t",
                       "--model-type", "1x", "--name", "n"]),
        "cli.train_lm": (get_lm_argparser, ["--train-data", "d", "--valid-data", "d",
                                            "--tokenizer", "t", "--name", "n"]),
        # cli.gen_embed: the eval CLI's parser plus --out-path
        "cli.gen_embed": (get_argparser, ["--train-data", "d", "--valid-data", "d",
                                          "--tokenizer", "t", "--model-type", "1x"]),
        "cli.train_embed": (cli_train_embed.get_parser, ["--train-data", "t.pkl",
                                                         "--valid-data", "v.pkl"]),
        "cli.wder": (cli_wder.get_parser, ["--eval-file", "r.pkl"]),
        "cli.wder_search": (cli_wder_search.get_parser, ["--eval-file", "r.pkl"]),
        "cli.train_sd": (cli_train_sd.get_parser, ["--train-data", "d", "--valid-data", "d",
                                                   "--name", "n"]),
        "cli.sad": (cli_sad.get_parser, ["--train-data", "d", "--test-data", "d",
                                         "--out-dir", "o"]),
    }
    if target == "cli.tools wder-format":
        import tal_asrd_tpu_torch.cli.tools as cli_tools
        assert 'wf.add_argument("--device", default="cuda"' in inspect.getsource(cli_tools)
        return
    if target in parsers:
        make, argv = parsers[target]
        assert make().parse_args(argv).device == "cuda"
        return
    fn = {"ASRModel": ASRModel.__init__, "make_generate_fn": make_generate_fn,
          "ASRSystem": ASRSystem.__init__, "EvalRunner": EvalRunner.__init__,
          "Transcriber": Transcriber.__init__, "DecoderLMModel": DecoderLMModel.__init__,
          "LMSystem": LMSystem.__init__, "EmbedSystem": EmbedSystem.__init__,
          "cluster_embeddings": cluster_embeddings, "apply_embed_head": apply_embed_head,
          "convert_results": convert_results, "SDModel": SDModel.__init__,
          "SDSystem": SDSystem.__init__, "PyanNet": PyanNet.__init__}[target]
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_chip_smoke_fails_without_a_gpu():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU; the check is for machines without one")
    res = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                         capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    assert "needs an NVIDIA GPU" in res.stderr


def test_cuda_tensor_never_reaches_the_plain_version():
    """The wrappers pick the plain version by `device.type == "cpu"` alone and
    wrap neither the build nor the launch in a try."""
    import tal_asrd_tpu_torch.ops.cuda_decode as cd
    import tal_asrd_tpu_torch.ops.cuda_kernels as ck
    import tal_asrd_tpu_torch.ops.specaug as sa
    for wrapper, plain, counter in (
            (cd.fused_layer_step, "layer_step_plain", cd.fused_layer_step),
            (ck.fused_logmel_project, "logmel_project_plain", ck.fused_logmel_project),
            (sa.spec_augment_seeded, "specaug_plain", sa.spec_augment)):
        src = inspect.getsource(wrapper)
        assert "try:" not in src and "except" not in src
        assert src.count(plain + "(") == 1
        before, after = src.split(plain + "(")
        assert 'device.type == "cpu"' in before.splitlines()[-2] + before.splitlines()[-1]
        assert isinstance(counter.launches, int)
    for fn in (sa._SpecAugmentK4.forward, sa._SpecAugmentK4.backward):
        src = inspect.getsource(fn)
        assert "try:" not in src and "specaug_plain" not in src
    assert "try:" not in inspect.getsource(__import__(
        "tal_asrd_tpu_torch.ops._build", fromlist=["x"]).load_library)
