"""Every stage combination of the composer, {None, TPS} x {VGG, ResNet,
RCNN, SVTR} x {None, BiLSTM} x {CTC, Attn}, in the port against the JAX
package's ``Recognizer``, float32 on the CPU, narrow (32x64 crops,
output_channel 32, hidden 16, SVTR embed 16/32/64 and depth 2/4/2, batch 4):
the random trees against ``jax.eval_shape`` of a JAX init, the draws of the
combinations the port built before kept byte for byte, an RBA learner
(None/ResNet/BiLSTM/Attn) that builds and steps, every eval forward on the
same weights, the score envelope of an SVTR model with an Attn head, the
``DERNet`` over RCNN, the DER extractor count of a BiLSTM best file, and a
TPS/SVTR/BiLSTM/Attn best file against JAX's reader.  The JAX side runs its
CPU routes (the XLA attention, the gathering warp); the port its kernels'
plain versions (the fused inference Block with the degree-15 erf fit)."""

import hashlib
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import mrn_tpu.models.composer as jax_composer
import mrn_tpu.models.svtr as jax_svtr
import mrn_tpu.models.tps as jax_tps
from mrn_tpu.models.der import DERNet as JaxDERNet
from mrn_tpu.ops.grid_sample import grid_sample_gather
from mrn_tpu.train import checkpoint as jax_ckpt
from mrn_tpu_torch.bridge import der_state, from_flax, to_flax
from mrn_tpu_torch.config import default_options, load_config
from mrn_tpu_torch.data.synthetic import SyntheticTaskLoader, alphabet_of_size
from mrn_tpu_torch.evaluate_cli import load_learner
from mrn_tpu_torch.models import tps
from mrn_tpu_torch.models.composer import Recognizer, build_recognizer
from mrn_tpu_torch.models.der import DERNet
from mrn_tpu_torch.models.init import random_der, random_mrn, random_recognizer
from mrn_tpu_torch.models.svtr import configure_blocks
from mrn_tpu_torch.ops.grid_sample import grid_sample_reference
from mrn_tpu_torch.serve import Server
from mrn_tpu_torch.train.learners import build_learner

COMBOS = list(itertools.product(("None", "TPS"), ("VGG", "ResNet", "RCNN", "SVTR"),
                                ("None", "BiLSTM"), ("CTC", "Attn")))
IDS = ["/".join(c) for c in COMBOS]
IMG = (32, 64, 4)
OC, HID, BATCH, BML = 32, 16, 4, 6
SVTR = dict(embed_dim=(16, 32, 64), depth=(2, 4, 2), num_heads=(2, 2, 4))
SOS = 2   # [UNK] [PAD] [SOS] [EOS] ' '
CHARS = list("abcdefghijklmnopqrstuv")
# Eval forward, each combination at the tolerance of the existing parity
# test of its backbone: the conv backbones, BiLSTMs and heads at float32
# summation order (tests/test_torch_crnn.py, TOL); SVTR's Blocks with the
# degree-15 erf fit and the clamp-exp softmax against the exact erf
# (tests/test_torch_models.py, EXTRACTOR_TOL).  A TPS grid comes from two
# float32 products that cancel terms far larger than the result, so each
# framework's grid is ~6e-5 from the float64 product (tests/test_torch_tps.py):
# the port's grid is held to JAX's at GRID_TOL
# (tests/test_torch_trba_train.py), and both warps then sample JAX's grid, so
# that the stages behind it are held at their own tolerance
TOL, SVTR_TOL, GRID_TOL = 1e-5, 1e-4, 2e-4
# DERNet over RCNN in train mode: 79 batch-statistics BatchNorms per GRCNN
# (tests/test_torch_crnn.py, GRCNN_TRAIN_TOL)
GRCNN_TRAIN_TOL = 1e-4
# The trees SVTR, CRNN, GRCNN and TRBA drew before the composer went stage
# by stage: sha256 of a recognizer, a 2-expert MRN and a 2-extractor DER
# drawn in turn from default_rng(7) (output_channel 64, hidden 32, imgW
# 64, SVTR embed 16/32/64 depth 1/2/1), and the generator's next draw
PARENT_DRAWS = {"svtr": ("dfb594d2288a67b833f38edff4486840", 2222721261696962193),
                "crnn": ("0dc09a346adcca584ed44289db54e2cb", 1525789792221806472),
                "grcnn": ("788aa5e48e61793b2c2b07c48792da53", 2246300049035659679),
                "trba": ("54583ca94a0c2a3dcec5fd17c36a3a28", 4458029519736841272)}


@pytest.fixture(autouse=True, scope="module")
def _narrow_jax():
    """The JAX composer's SVTR narrowed as the port's ``svtr=`` narrows it,
    its attention on the XLA route; torch on one thread (beside the other
    test workers, more threads oversubscribe the cores)."""

    class NarrowSVTR(jax_svtr.SVTRExtractor):
        embed_dim: tuple = SVTR["embed_dim"]
        depth: tuple = SVTR["depth"]
        num_heads: tuple = SVTR["num_heads"]

    mp = pytest.MonkeyPatch()
    mp.setattr(jax_composer, "SVTRExtractor", NarrowSVTR)
    jax_svtr.set_attention_impl("xla")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    jax_svtr.set_attention_impl("auto")
    mp.undo()


def _opt(combo, **kw):
    t, f, s, p = combo
    return default_options(Transformation=t, FeatureExtraction=f, SequenceModeling=s,
                           Prediction=p, imgW=IMG[1], output_channel=OC, hidden_size=HID,
                           batch_max_length=BML, svtr=SVTR, **kw)


def _jax_recognizer(combo, n):
    t, f, s, p = combo
    return jax_composer.Recognizer(num_classes=n, prediction=p, transformation=t,
                                   feature_extraction=f, sequence_modeling=s,
                                   output_channel=OC, hidden_size=HID, img_size=IMG[:2],
                                   batch_max_length=BML)


def _shapes(tree, prefix=""):
    out = {}
    for k, x in tree.items():
        out.update(_shapes(x, f"{prefix}{k}/") if isinstance(x, dict)
                   else {prefix + k: tuple(np.shape(x))})
    return out


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def _perturb(tree, rng, scale=0.05):
    """Every leaf moved off its init value (BN variances stay positive), so
    that a leaf bridged to the wrong place shows."""
    if isinstance(tree, dict):
        return {k: (_perturb(v, rng, scale) if k != "var" or isinstance(v, dict)
                    else np.abs(v + scale * rng.standard_normal(v.shape)).astype(np.float32)
                    + np.float32(0.5)) for k, v in tree.items()}
    return (tree + scale * rng.standard_normal(tree.shape)).astype(np.float32)


def _text(combo):
    return jnp.full((BATCH, 1), SOS, jnp.int32) if combo[3] == "Attn" else None


def _tol(combo):
    return SVTR_TOL if combo[1] == "SVTR" else TOL


def _same_grid(monkeypatch):
    """Within the test: JAX's eval warp records its grid, the port's records
    its own and samples JAX's (the last one recorded).  Returns the two
    lists of grids."""
    grids = {"jax": [], "port": []}

    def jax_warp(image, grid, inference=False):
        assert inference
        grids["jax"].append(np.asarray(grid))
        return grid_sample_gather(image, grid)

    def port_warp(image, grid):
        grids["port"].append(grid.numpy().copy())
        return grid_sample_reference(image, torch.tensor(grids["jax"][-1]))

    monkeypatch.setattr(jax_tps, "grid_sample", jax_warp)
    monkeypatch.setattr(tps, "grid_sample", port_warp)
    return grids


# ------------------------------------------------------------ random trees
@pytest.mark.parametrize("combo", COMBOS, ids=IDS)
def test_random_tree_matches_jax_init(combo):
    """``random_recognizer``'s trees, names and shapes, against a JAX
    ``Recognizer.init`` of the same stages; the port's model loads them
    strictly."""
    opt, n = _opt(combo), 13
    jm = _jax_recognizer(combo, n)
    x = jnp.zeros((BATCH, *IMG))
    v = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0),
                                        "droppath": jax.random.PRNGKey(1)}, x,
                                       text=_text(combo), train=False, is_train=False))
    params, stats = random_recognizer(np.random.default_rng(0), opt, n)
    assert _shapes(params) == _shapes(v["params"])
    assert _shapes(stats) == _shapes(v.get("batch_stats", {}))
    assert ("transformation" in params["extractor"]) == (combo[0] == "TPS")
    build_recognizer(opt, n).load_state_dict(from_flax(params, stats), strict=True)


def _digest(*trees):
    h = hashlib.sha256()

    def walk(x):
        if isinstance(x, dict):
            for k in sorted(x):
                h.update(str(k).encode())
                walk(x[k])
        else:
            a = np.ascontiguousarray(np.asarray(x))
            h.update(f"{a.dtype}{a.shape}".encode())
            h.update(a.tobytes())

    for t in trees:
        walk(t)
    return h.hexdigest()[:32]


@pytest.mark.parametrize("arch", sorted(PARENT_DRAWS))
def test_built_combinations_keep_their_draws(arch):
    """SVTR, CRNN, GRCNN and TRBA draw the bytes they drew when each was its
    own unit: the campaign records and the card checks depend on them."""
    opt = load_config(f"configs/{arch}_mrn.py", imgW=IMG[1], output_channel=64,
                      hidden_size=32, svtr=dict(embed_dim=(16, 32, 64), depth=(1, 2, 1),
                                                num_heads=(2, 2, 4)))
    rng = np.random.default_rng(7)
    trees = [*random_recognizer(rng, opt, 12), *random_mrn(rng, opt, (8, 12)),
             *random_der(rng, opt, 2, 12)]
    assert (_digest(*trees), int(rng.integers(1 << 62))) == PARENT_DRAWS[arch]


def _images(seed, n=BATCH):
    """Normalised crops with a noisy alpha channel (float: JAX reads an
    integer batch as bank indices)."""
    loader = SyntheticTaskLoader([alphabet_of_size(10)], 0, n, 8, img_w=IMG[1], max_len=5,
                                 seed=seed)
    idx, words = loader.get_batch()
    images = (loader.bank[idx].astype(np.float32) / 255.0 - 0.5) / 0.5
    images[..., 3] = np.random.default_rng(seed).uniform(-1, 1, images.shape[:3])
    return images.astype(np.float32), words


@pytest.mark.parametrize("il", ["base", "mrn"])
def test_rba_learner_builds_and_steps(tmp_path, il):
    """None/ResNet/BiLSTM/Attn from random weights: the tree has no TPS, so
    the learner's model loads it and trains one step."""
    opt = load_config("configs/trba_mrn.py", il=il, Transformation="None", imgW=IMG[1],
                      output_channel=OC, hidden_size=HID, batch_size=BATCH,
                      batch_max_length=BML, output_dir=str(tmp_path),
                      data_log=str(tmp_path / "data_any.txt"))
    learner = build_learner(opt, device="cpu")
    learner.character = alphabet_of_size(10)
    learner.converter = learner.build_converter()
    learner.build_model()
    assert not hasattr(learner.model.extractor, "transformation")
    learner.build_optimizer()
    before = {k: v.clone() for k, v in learner.model.state_dict().items()}
    metrics = learner.train_step(_images(0))
    assert np.isfinite(float(metrics["loss"]))
    after = learner.model.state_dict()
    assert not torch.equal(before["fc.kernel"], after["fc.kernel"])
    assert not torch.equal(before["extractor.feature.bn0_1.mean"],
                           after["extractor.feature.bn0_1.mean"])


# ------------------------------------------------------------ eval forward
@pytest.mark.parametrize("combo", COMBOS, ids=IDS)
def test_eval_forward_matches_jax(combo, monkeypatch):
    """Features and logits on the same perturbed weights and crops: CTC
    logits everywhere; Attn's greedy logits up to a crop's first flipped
    pick, a flip allowed only at a near-tie and in at most one crop; a
    TPS's grid against JAX's."""
    grids = _same_grid(monkeypatch)
    rng = np.random.default_rng(sum(map(ord, "".join(combo))))
    n = len(CHARS) + 5
    params, stats = random_recognizer(rng, _opt(combo), n)
    params, stats = _perturb(params, rng), _perturb(stats, rng)
    params["fc"]["kernel"] = 3 * rng.standard_normal((HID, n)).astype(np.float32)
    x, _ = _images(1)
    ref = _jax_recognizer(combo, n).apply({"params": params, "batch_stats": stats},
                                          jnp.asarray(x), text=_text(combo), train=False,
                                          is_train=False)
    port = build_recognizer(_opt(combo), n)
    port.load_state_dict(from_flax(params, stats), strict=True)
    configure_blocks(port, gelu_degree=15)
    text = None if combo[3] == "CTC" else torch.full((BATCH, 1), SOS)
    with torch.inference_mode():
        got = port.eval()(torch.from_numpy(x), text)
    tol = _tol(combo)
    assert len(grids["port"]) == len(grids["jax"]) == (combo[0] == "TPS")
    for mine, theirs in zip(grids["port"], grids["jax"]):
        np.testing.assert_allclose(mine, theirs, atol=GRID_TOL, rtol=0)
    np.testing.assert_allclose(got["feature"].numpy(), np.asarray(ref["feature"]), atol=tol,
                               rtol=tol)
    if combo[3] == "CTC":
        np.testing.assert_allclose(got["predict"].numpy(), np.asarray(ref["predict"]),
                                   atol=tol, rtol=tol)
    else:
        _, flipped = chip_smoke.check_greedy("greedy logits vs JAX", got["predict"],
                                             torch.tensor(np.asarray(ref["predict"])),
                                             torch.full((BATCH,), n), tol, tol)
        assert int(flipped.sum()) <= 1


# ------------------------------------------------------------ serving an Attn SVTR
@pytest.mark.parametrize("transformation", ["None", "TPS"])
def test_score_envelope_runs_with_an_attn_head(transformation):
    """The envelope check passes the [SOS] column to an SVTR model with an
    Attn head, a single recognizer's and an ensemble's, and reads the same
    scores as the same model with a CTC head (the head reads no score)."""
    combo = (transformation, "SVTR", "BiLSTM", "Attn")
    opt, n = _opt(combo), len(CHARS) + 5
    params, stats = random_recognizer(np.random.default_rng(3), opt, n)
    x, _ = _images(2)
    server = Server(opt, params, stats, CHARS, device="cpu")
    mx = server.check_score_envelope(x)
    assert mx is not None and np.isfinite(mx) and mx > 0
    ctc = {"extractor": params["extractor"],   # the CTC converter has 4 specials, not 5
           "fc": {k: v[..., :n - 1] for k, v in params["fc"].items()}}
    ctc_server = Server(opt.replace(Prediction="CTC"), ctc, stats, CHARS, device="cpu")
    assert ctc_server.check_score_envelope(x) == mx
    counts = (12, n)
    mparams, mstats = random_mrn(np.random.default_rng(4), opt, counts)
    ensemble = Server(opt, mparams, mstats, CHARS, class_counts=counts, device="cpu")
    assert np.isfinite(ensemble.check_score_envelope(x))
    assert len(ensemble.recognize(x)) == BATCH


# ------------------------------------------------------------ DER over RCNN
@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("prediction", ["CTC", "Attn"])
def test_dernet_over_rcnn_matches_jax(prediction, train):
    """Two GRCNN extractors (None/RCNN/BiLSTM) under both heads: main and
    aux logits and, in train mode, every extractor's running statistics."""
    combo = ("None", "RCNN", "BiLSTM", prediction)
    opt, n = _opt(combo), 13
    rng = np.random.default_rng(5)
    params, stats = random_der(rng, opt, 2, n)
    stats = _perturb(stats, rng)
    jm = JaxDERNet(n_experts=2, num_classes=n, prediction=prediction, transformation="None",
                   feature_extraction="RCNN", sequence_modeling="BiLSTM",
                   output_channel=OC, hidden_size=HID, img_size=IMG[:2],
                   batch_max_length=BML)
    x, _ = _images(3)
    text = None
    if prediction == "Attn":
        text = rng.integers(0, n, (BATCH, BML + 1)).astype(np.int32)
        text[:, 0] = SOS
    (ref, mutated) = jm.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                              text=None if text is None else jnp.asarray(text), train=train,
                              is_train=True, mutable=["batch_stats"])
    net = DERNet(2, n, prediction, "None", "RCNN", "BiLSTM", IMG[2], OC, HID, IMG[:2],
                 batch_max_length=BML)
    net.load_state_dict(der_state(params, stats), strict=True)
    with torch.no_grad():
        got = net(torch.from_numpy(x), None if text is None else torch.from_numpy(text).long(),
                  train=train, is_train=True)
    tol = GRCNN_TRAIN_TOL if train else TOL
    for k in ("logits", "aux_logits"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), atol=tol, rtol=tol,
                                   err_msg=k)
    got_stats = dict(_leaves(to_flax(net)[1]))
    for k, want in _leaves(jax.tree_util.tree_map(np.asarray, mutated["batch_stats"])):
        np.testing.assert_allclose(got_stats[k], want, atol=TOL if train else 0.0,
                                   rtol=TOL if train else 0.0, err_msg=k)


def test_der_best_file_of_a_bilstm_extractor_loads(tmp_path):
    """``evaluate_cli.load_learner`` counts a DER file's extractors from any
    stacked leaf: a BiLSTM extractor has no ``seq_linear``."""
    combo = ("None", "VGG", "BiLSTM", "CTC")
    roots = tmp_path / "data"
    for lan, chars in (("T0", "abc"), ("T1", "def")):
        (roots / lan).mkdir(parents=True)
        (roots / lan / "dict.txt").write_text("\n".join(chars) + "\n")
    opt = _opt(combo, il="der", lan_list=["T0", "T1"], select_data=[str(roots)],
               output_dir=str(tmp_path / "saved"), data_log=str(tmp_path / "d.txt"))
    params, stats = random_der(np.random.default_rng(6), opt, 2, 4 + 6)
    path = str(tmp_path / "saved" / "T1_1_best_score.msgpack")
    jax_ckpt.save_model(path, params, stats)
    learner = load_learner(opt, path, last_task=1, device="cpu")
    assert learner.n_experts == 2 and len(learner.model.extractors) == 2


# ------------------------------------------------------------ a best file
def test_tps_svtr_bilstm_attn_best_file_matches_jax_reader(tmp_path, monkeypatch):
    """An MRN task-0 expert of TPS/SVTR/BiLSTM/Attn after one step: its best
    file reads back in JAX's reader leaf for leaf, JAX writes the same
    bytes from what it read, JAX's Recognizer on the file's trees gives the
    learner's eval logits, and ``Server.from_checkpoint`` serves them."""
    combo = ("TPS", "SVTR", "BiLSTM", "Attn")
    opt = _opt(combo, il="mrn", batch_size=BATCH, output_dir=str(tmp_path),
               exp_name="combo", data_log=str(tmp_path / "d.txt"))
    learner = build_learner(opt, device="cpu")
    learner.character = alphabet_of_size(10)
    learner.converter = learner.build_converter()
    learner.build_model()
    learner.build_optimizer()
    learner.train_step(_images(4))
    learner._save_best(0)
    path = learner._best_path(0)
    with open(path, "rb") as f:
        data = f.read()
    payload = jax_ckpt.load_model(path)
    params, stats = to_flax(learner.model)
    for tree, ref in ((params, payload["params"]), (stats, payload["batch_stats"])):
        got, want = dict(_leaves(tree)), dict(_leaves(ref))
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes(), k
    again = str(tmp_path / "again.msgpack")
    jax_ckpt.save_model(again, payload["params"], payload["batch_stats"],
                        extra={k: v for k, v in payload.items()
                               if k not in ("params", "batch_stats")})
    with open(again, "rb") as f:
        assert f.read() == data
    x, _ = _images(5)
    n = learner.converter.num_classes
    grids = _same_grid(monkeypatch)
    ref = _jax_recognizer(combo, n).apply({"params": payload["params"],
                                           "batch_stats": payload["batch_stats"]},
                                          jnp.asarray(x), text=_text(combo), train=False,
                                          is_train=False)
    server = Server.from_checkpoint(opt, path, learner.character, last_task=0, device="cpu")
    configure_blocks(server.model, gelu_degree=15)
    got = server.forward(x)["logits"]
    np.testing.assert_allclose(grids["port"][0], grids["jax"][0], atol=GRID_TOL, rtol=0)
    _, flipped = chip_smoke.check_greedy("best file vs JAX", got,
                                         torch.tensor(np.asarray(ref["predict"])),
                                         torch.full((BATCH,), n), SVTR_TOL, SVTR_TOL)
    assert int(flipped.sum()) <= 1
    assert isinstance(server.model, Recognizer)
