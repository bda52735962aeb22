"""The port's export entry point (``mrn_tpu_torch.export_cli``) on the CPU:

- ``export_inference`` -> ``torch.export.save`` -> ``torch.export.load``:
  the loaded program's logits equal the eager port's bitwise for a tiny
  SVTR (float32, bfloat16, the tanh-GELU switch, int8), CRNN and TRBA (the
  TPS warp's plain version inside its custom op), each serving kernel one
  custom-op node of the graph;
- ``export_cli.main`` on checkpoints the port's ``train_cli`` wrote: a
  2-expert routed MRN after task 0 and task 0's recognizer with ``--int8``,
  against the eager ``evaluate_cli`` learner bitwise; its refusals and the
  card it asks for;
- the tiny task-0 SVTR and its int8 form against the JAX package's
  ``export_inference`` -> ``deserialize(...).call`` (as
  ``tests/test_export.py`` builds it) on the same weights, and against the
  eager port bitwise;
- the three serving ops through ``torch.library.opcheck``."""

import contextlib
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mrn_tpu.models.composer as jax_composer
import mrn_tpu.models.svtr as jax_svtr
from mrn_tpu.models.composer import build_recognizer as jax_build_recognizer
from mrn_tpu.ops import int8 as jax_int8
from mrn_tpu.train.learners.base import BaseLearner as JaxBaseLearner
from mrn_tpu_torch import evaluate_cli, export_cli, train_cli
from mrn_tpu_torch.codec import build_converter
from mrn_tpu_torch.config import default_options, load_config
from mrn_tpu_torch.data.manager import ValDataset
from mrn_tpu_torch.data.synthetic import alphabet_of_size
from mrn_tpu_torch.models import svtr as port_svtr
from mrn_tpu_torch.models.init import random_block, random_recognizer
from mrn_tpu_torch.ops import grid_sample, svtr_block
from mrn_tpu_torch.serve import Server, quantize_int8
from mrn_tpu_torch.tools import create_lmdb

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import export_cli as jax_export_cli  # noqa: E402
from helpers import tiny_opt  # noqa: E402

NARROW = dict(embed_dim=(16, 32, 64), depth=(1, 2, 1), num_heads=(2, 2, 4), drop_path_rate=0.0)
CHARS = list("abcdefgh")
BATCH = 2
# the loaded program against JAX's exported one, task-0 SVTR of 4 narrow
# Blocks: float32, JAX's composed Blocks (exact erf, max-subtract softmax)
# against the port's fused Block with the degree-15 erf fit, float32 noise
# (tests/test_torch_mrn_slice.py); int8, tests/test_torch_int8.py's bounds
# for the int8 recognizer (an activation at a .5 boundary may round to the
# other int8 value on either side and cascade)
LOGIT_TOL = 1e-4
INT8_LOGIT_ATOL, INT8_LOGIT_MEAN_ATOL = 1.5e-2, 5e-3


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    port_svtr.set_gelu_approximate(False)


def _stub(opt, srv):
    """What ``export_inference`` reads of a learner, around a server's
    model (a single recognizer at task 0)."""
    return types.SimpleNamespace(opt=opt, model=srv.model, _cur_task=0,
                                 converter=srv.converter, device=torch.device("cpu"))


def _round_trip(program, path):
    torch.export.save(program, path)
    return torch.export.load(path).module()


def _custom_ops(program):
    return [str(n.target) for n in program.graph.nodes
            if n.op == "call_function" and str(n.target).startswith("mrn_tpu_torch.")]


def _eager(srv, x):
    with torch.inference_mode():
        out = srv.model(x.to(srv.dtype), srv.sos_column(x))
    return (out["predict"] if "predict" in out else out["logits"]).float()


def _svtr_opt(**kw):
    return load_config("configs/svtr_mrn.py", imgW=64, output_channel=32, hidden_size=16,
                       svtr=NARROW, **kw)


def _server(kind, rng):
    """(options, server, expected custom-op nodes) of a tiny recognizer."""
    if kind in ("svtr", "svtr_bf16", "svtr_tanh", "svtr_int8"):
        opt = _svtr_opt(compute_dtype="bfloat16" if kind == "svtr_bf16" else "float32")
        params, stats = random_recognizer(rng, opt, build_converter("CTC", CHARS).num_classes)
        params["fc"]["kernel"] = 3 * params["fc"]["kernel"]
        srv = Server(opt, params, stats, CHARS, device="cpu")
        if kind != "svtr_int8":
            return opt, srv, {"mrn_tpu_torch.fused_block.default": 4}
        calib = [rng.integers(0, 256, (BATCH, 32, 64, 4), dtype=np.uint8) for _ in range(2)]
        quantize_int8(srv, iter(calib))
        return opt, srv, {"mrn_tpu_torch.fused_block_int8.default": 4}
    config, nodes = {"crnn": ("configs/crnn_mrn.py", {}),
                     "trba": ("configs/trba_mrn.py",
                              {"mrn_tpu_torch.grid_sample.default": 1})}[kind]
    opt = load_config(config, imgW=32, output_channel=32, hidden_size=16, batch_max_length=2)
    params, stats = random_recognizer(rng, opt, build_converter(opt.Prediction,
                                                                CHARS).num_classes)
    return opt, Server(opt, params, stats, CHARS, device="cpu"), nodes


@pytest.mark.parametrize("kind", ["svtr_bf16", "svtr_tanh", "svtr_int8", "crnn", "trba"])
def test_loaded_program_equals_eager(kind, rng, tmp_path):
    """Each serving kernel is one custom-op node, an SVTR Block's folded
    weights (from its cache) and an int8 Block's prepared operands are
    constants of the program (nothing is folded or prepared in the graph),
    the CPU ops count no kernel launch, and the loaded program's logits
    equal the eager model's bitwise."""
    opt, srv, nodes = _server(kind, rng)
    before = (svtr_block.launches, svtr_block.int8_launches, grid_sample.launches)
    port_svtr.set_gelu_approximate(kind == "svtr_tanh")
    dtype = "bf16" if kind == "svtr_bf16" else "f32"
    program, shape = export_cli.export_inference(_stub(opt, srv), opt, BATCH, dtype)
    port_svtr.set_gelu_approximate(False)
    ops = _custom_ops(program)
    assert {op: ops.count(op) for op in set(ops)} == nodes
    constants = set(program.graph_signature.inputs_to_lifted_tensor_constants)
    for node in program.graph.nodes:
        if "fused_block" in str(node.target):
            lists = [a for a in node.args if isinstance(a, (list, tuple)) and a
                     and hasattr(a[0], "name")]
            assert lists and all(w.name in constants for ws in lists for w in ws)
    module = _round_trip(program, str(tmp_path / f"{kind}.pt2"))
    x = torch.from_numpy(rng.standard_normal((BATCH, opt.imgH, opt.imgW, opt.input_channel)
                                             ).astype(np.float32))
    with torch.inference_mode():
        got = module(x)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    port_svtr.set_gelu_approximate(kind == "svtr_tanh")
    ref = _eager(srv, x)
    port_svtr.set_gelu_approximate(False)
    assert torch.equal(got, ref)
    assert (svtr_block.launches, svtr_block.int8_launches, grid_sample.launches) == before
    if kind == "svtr_tanh":   # the form was baked in when the program was traced
        assert not torch.equal(got, _eager(srv, x))
        with torch.inference_mode():
            assert torch.equal(module(x), got)


@pytest.mark.parametrize("frozen", [False, True])
def test_trace_takes_weights_changed_after_eager_call(rng, frozen):
    """A Block's weights changed in place after an eager call: a trace
    takes the new ones, folded inside the graph, or within
    ``frozen_folds`` folded on entry as constants of the program; the
    cache thaws on exit."""
    c = 32
    blk = port_svtr.Block(c, 2, "Global", (4, 8)).eval()
    blk.load_state_dict({k: torch.from_numpy(v) for k, v in random_block(rng, c).items()})
    x = torch.from_numpy(rng.standard_normal((2, 32, c)).astype(np.float32))
    with torch.no_grad():
        stale = blk(x)
        blk.fc1_kernel.mul_(1.5)
        params = {k: getattr(blk, k) for k in svtr_block.PARAM_KEYS}
        fresh = svtr_block.fused_block_reference(x, params, None, 2, blk.scale)
        with port_svtr.frozen_folds(blk, torch.float32) if frozen else contextlib.nullcontext():
            program = torch.export.export(blk, (x,), strict=False)
    assert not blk.fold_cache.frozen
    constants = set(program.graph_signature.inputs_to_lifted_tensor_constants)
    (node,) = [n for n in program.graph.nodes if "fused_block" in str(n.target)]
    assert all((w.name in constants) == frozen for w in node.args[1])
    with torch.no_grad():
        got = program.module()(x)
    assert torch.equal(got, fresh) and not torch.equal(got, stale)


# ------------------------------------------------------------ export_cli.main
LANS = ["T0", "T1"]
ALPHABETS = [alphabet_of_size(6), alphabet_of_size(5, 0x4E00 + 10)]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A 2-task LMDB tree and the port's train_cli checkpoints over it
    (SVTR-MRN, narrow, 2 steps a phase)."""
    root = tmp_path_factory.mktemp("export")
    index = {ch: i for i, ch in enumerate("".join(ALPHABETS))}
    for split, n, seed in (("train", 8, 0), ("test", 4, 50)):
        for t, lan in enumerate(LANS):
            create_lmdb.create_synthetic_dataset(str(root / split / lan), ALPHABETS[t], n,
                                                 seed + t, heights=(20, 40), widths=(40, 120),
                                                 max_len=4, char_to_idx=index)
    common = dict(exp_name="exp", il="mrn", memory="random", memory_num=4, batch_max_length=6,
                  imgH=32, imgW=64, manual_seed=111, output_dir=str(root / "saved"),
                  data_log=str(root / "data.txt"))
    model = dict(Transformation="None", FeatureExtraction="SVTR", SequenceModeling="None",
                 Prediction="CTC", input_channel=4, output_channel=32, hidden_size=16,
                 svtr=NARROW)
    train = dict(lan_list=LANS, select_data=[str(root / "train")],
                 valid_datas=[str(root / "test")], batch_size=4, workers=0, num_iter=2,
                 val_interval=2)
    cfg = root / "cfg.py"
    cfg.write_text(f"common = {common!r}\nmodel = {model!r}\ntrain = {train!r}\n",
                   encoding="utf-8")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        train_cli.main(["--config", str(cfg), "--device", "cpu"])
    finally:
        torch.set_num_threads(threads)
    exp = root / "saved" / "exp"
    return dict(cfg=str(cfg), root=root, task0=str(exp / "T0_0_0_best_score.msgpack"),
                task1=str(exp / "T1_1_1_best_score.msgpack"))


def _test_images(trained, lan):
    loader = ValDataset([str(trained["root"] / "test" / lan)],
                        load_config(trained["cfg"])).create_dataset()
    images = np.asarray(next(iter(loader))[0])
    return torch.from_numpy((images.astype(np.float32) / 255.0 - 0.5) / 0.5)


def test_export_cli_routed_mrn_equals_eager(trained, tmp_path, capsys):
    out = str(tmp_path / "mrn.pt2")
    path, shape = export_cli.main(["--config", trained["cfg"], "--saved_model",
                                   trained["task1"], "--out", out, "--batch_size", "4",
                                   "--dtype", "f32", "--device", "cpu"])
    assert path == out and f"wrote {out}: {os.path.getsize(out)} bytes" in capsys.readouterr().out
    program = torch.export.load(out)
    module = program.module()
    x = _test_images(trained, "T1")
    learner = evaluate_cli.load_learner(load_config(trained["cfg"]), trained["task1"], 1,
                                        device="cpu")
    with torch.inference_mode():
        got = module(x)
        ref = learner._eval_logits(x, "TF").float()
    assert tuple(got.shape) == shape == (4, 16, 4 + sum(map(len, ALPHABETS)))
    assert torch.equal(got, ref)
    ops = _custom_ops(program)
    assert ops.count("mrn_tpu_torch.fused_block.default") == 2 * 4


def test_export_cli_int8_equals_eager(trained, tmp_path):
    out = str(tmp_path / "int8.pt2")
    calib_root = str(trained["root"] / "test")
    export_cli.main(["--config", trained["cfg"], "--saved_model", trained["task0"], "--out", out,
                     "--batch_size", "4", "--dtype", "f32", "--taski", "0", "--int8",
                     "--calib_data", calib_root, "--device", "cpu"])
    module = torch.export.load(out).module()
    opt = load_config(trained["cfg"])
    learner = evaluate_cli.load_learner(opt, trained["task0"], 0, device="cpu")
    evaluate_cli.quantize_learner_int8(
        learner, opt, ValDataset([os.path.join(calib_root, "T0")], opt).create_dataset())
    x = _test_images(trained, "T0")
    with torch.inference_mode():
        assert torch.equal(module(x), learner._eval_logits(x, "FF").float())


def test_export_cli_refusals_and_device(trained, tmp_path, monkeypatch):
    args = ["--config", trained["cfg"], "--saved_model", trained["task1"], "--out",
            str(tmp_path / "x.pt2")]
    with pytest.raises(SystemExit):     # int8 of a routed ensemble, as JAX refuses it
        export_cli.main(args + ["--int8", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        export_cli.main(args)
    assert not (tmp_path / "x.pt2").exists()


# -------------------------------------------------------------- against JAX
@pytest.fixture
def jax_narrow():
    """The JAX package with the narrow SVTR, on its default attention path on
    the CPU (the composed XLA Blocks: exact erf, max-subtract softmax)."""

    class NarrowSVTR(jax_svtr.SVTRExtractor):
        embed_dim: tuple = NARROW["embed_dim"]
        depth: tuple = NARROW["depth"]
        num_heads: tuple = NARROW["num_heads"]
        drop_path_rate: float = NARROW["drop_path_rate"]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_composer, "SVTRExtractor", NarrowSVTR)
        jax_svtr.set_attention_impl("auto")
        yield


def _jax_int8(learner, jopt, calib):
    """What JAX's ``evaluate_cli.quantize_learner_int8`` does to the learner,
    calibrated on one batch under one jit: the calibrated amaxes quantized,
    the int8 model in place."""
    n = learner._total_classes
    variables = {"params": learner.params, "batch_stats": learner.batch_stats}
    quant = jax.jit(lambda v, x: jax_build_recognizer(jopt, n, quant="calib").apply(
        v, x, train=False, mutable=["quant"])[1]["quant"])(variables, jnp.asarray(calib))
    qv = jax.jit(jax_int8.quantize_variables)({**variables, "quant": quant})
    learner.model = jax_build_recognizer(jopt, n, quant="int8")
    learner.params, learner.eval_quant = qv["params"], qv["quant"]


@pytest.mark.parametrize("int8", [False, True])
def test_loaded_program_matches_jax_export(jax_narrow, rng, tmp_path, int8):
    """Task-0 SVTR (4 narrow Blocks, imgW 64) with the port's random trees in
    the JAX layout, fc spread, built as ``tests/test_export.py`` builds it:
    JAX's ``export_inference`` served by ``deserialize(...).call`` against
    the port's loaded ``.pt2`` (its Blocks on the degree-15 erf fit, as
    ``tests/test_torch_cli.py`` holds the port against JAX's composed
    Blocks), float32; with ``int8`` each side calibrates on the same batch
    first (the port with ``serve.quantize_int8``, ``evaluate_cli --int8``'s
    helper).  The loaded program also equals the port's eager model
    bitwise."""
    from jax import export as jexport

    kw = dict(Transformation="None", FeatureExtraction="SVTR", SequenceModeling="None",
              Prediction="CTC", imgW=64, output_channel=32, hidden_size=16)
    jopt = tiny_opt(lan_list=["T0"], **kw)
    learner = JaxBaseLearner(jopt)
    learner.character = CHARS
    learner.converter = learner.build_converter()
    opt = default_options(svtr=NARROW, **kw)
    params, stats = random_recognizer(rng, opt, learner._total_classes)
    params["fc"]["kernel"] = 3 * params["fc"]["kernel"]
    learner.model = jax_build_recognizer(jopt, learner._total_classes)
    learner.params, learner.batch_stats = params, stats
    srv = Server(opt, params, stats, CHARS, device="cpu")
    calib = rng.normal(size=(BATCH, 32, 64, 4)).astype(np.float32)
    x = rng.normal(size=(BATCH, 32, 64, 4)).astype(np.float32)
    if int8:
        _jax_int8(learner, jopt, calib)
        quantize_int8(srv, [calib], n_batches=1)
    port_svtr.configure_blocks(srv.model, gelu_degree=15)
    blob, _ = jax_export_cli.export_inference(learner, jopt, batch_size=BATCH, dtype_name="f32")
    ref = np.asarray(jexport.deserialize(blob).call(jnp.asarray(x)))
    program, _ = export_cli.export_inference(_stub(opt, srv), opt, BATCH, "f32")
    with torch.inference_mode():
        got = _round_trip(program, str(tmp_path / "svtr.pt2"))(torch.from_numpy(x))
    assert torch.equal(got, _eager(srv, torch.from_numpy(x)))
    got = got.numpy()
    assert got.shape == ref.shape
    if not int8:
        np.testing.assert_allclose(got, ref, atol=LOGIT_TOL, rtol=LOGIT_TOL)
        return
    diff = np.abs(got - ref)
    assert diff.max() <= INT8_LOGIT_ATOL and diff.mean() <= INT8_LOGIT_MEAN_ATOL, \
        (diff.max(), diff.mean())


# ------------------------------------------------------------------ the ops
def test_serving_ops_pass_opcheck(rng):
    """Schema, fake implementation and dispatch of the three custom ops."""
    c, n = 32, 32
    params = {k: torch.from_numpy(v) for k, v in random_block(rng, c).items()}
    x = torch.from_numpy(rng.standard_normal((2, n, c)).astype(np.float32))
    weights = list(svtr_block._fold(params, 0.25, torch.float32))
    mask = torch.from_numpy(port_svtr.local_attention_mask_col_major(4, 8))
    torch.library.opcheck(torch.ops.mrn_tpu_torch.fused_block.default,
                          (x, weights, mask, [4, 8, 7, 11], 2, 0))
    quant = {f"act_amax_{k}": torch.tensor(3.0) for k in ("qkv", "proj", "fc1", "fc2")}
    quant.update({f"w_scale_{k}": torch.full((s,), 0.01) for k, s in
                  (("qkv", 3 * c), ("proj", c), ("fc1", 4 * c), ("fc2", c))})
    int8_params = dict(params)
    for k in ("qkv", "proj", "fc1", "fc2"):
        int8_params[f"{k}_kernel"] = torch.from_numpy(
            rng.integers(-127, 128, params[f"{k}_kernel"].shape).astype(np.int8))
    w = svtr_block.prepare_int8(int8_params, quant)
    torch.library.opcheck(torch.ops.mrn_tpu_torch.fused_block_int8.default,
                          (x, list(w.norms), list(w.kernels), list(w.biases), list(w.deqs),
                           w.inv, list(w.kernels_t), mask, [4, 8, 7, 11], 2, 0.25, False, 9))
    image = torch.from_numpy(rng.standard_normal((2, 8, 16, 4)).astype(np.float32))
    grid = torch.from_numpy(rng.uniform(-1.2, 1.2, (2, 8, 16, 2)).astype(np.float32))
    torch.library.opcheck(torch.ops.mrn_tpu_torch.grid_sample.default, (image, grid))
