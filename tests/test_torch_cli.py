"""The port's entry points ``train_cli``, ``evaluate_cli`` and
``recognize_cli`` on a 2-task LMDB tree of PNG and JPEG crops at natural
sizes, on the CPU, against the JAX package's CLIs:

- ``train_cli`` end to end (SVTR-MRN, narrow, a few steps): checkpoint
  names, ``log_train.txt``, the AIA lines, the same run with
  ``--device_bank``, the parallel flags it refuses without a process group
  (or against the world's size) and the card it asks for; in a 1-rank gloo
  world the same run bitwise, and under ``torchrun --nproc_per_node 2`` the
  one-process run's files, scores and losses;
- ``evaluate_cli`` on checkpoints the JAX package wrote (its MRN learner's
  ``_save_best`` over experts with a spread fc and a router): Acc and Ned
  per dataset, ``log_evaluation.txt``, ``log_all_evaluation.txt`` and the
  evaluation log equal to the JAX CLI's (``averaged_infer_time`` aside);
- ``recognize_cli``: words equal to JAX's, confidences within 1e-5;
- ``--model_name RBA`` (None/ResNet/BiLSTM/Attn) against JAX's eval;
- ``--int8`` on task 0's recognizer against JAX's int8 eval (the Pallas
  int8 Block in interpret mode) within ``tests/test_torch_int8.py``'s
  tolerance.

The JAX side evaluates SVTR on its composed XLA Block (exact erf,
max-subtract softmax), the port on its fused inference Block's plain
version with the degree-15 erf fit, as ``tests/test_torch_validation.py``
does: the logits agree to float32 noise.  JAX's ``evaluate_cli`` leaves a
routed MRN checkpoint's learner holding the router alone, which its
``run_validation`` and its score-envelope check cannot serve; the JAX side
here evaluates the same learner with the full routed variables
(``_routed_variables``, what its ``test`` runs), skips that check, and
counts the router's parameters as its CLI does.
"""

import functools
import io
import os
import re
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import PIL.Image
import pytest
import torch

import chip_smoke
import mrn_tpu.models.composer as jax_composer
import mrn_tpu.models.svtr as jax_svtr
from mrn_tpu.config import load_config as jax_load_config
from mrn_tpu.data.manager import ValDataset as JaxValDataset
from mrn_tpu.train.checkpoint import save_model as jax_save_model
from mrn_tpu.train.learners.mrn import MRN as JaxMRN
from mrn_tpu_torch import evaluate_cli, recognize_cli, train_cli
from mrn_tpu_torch.bridge import to_flax
from mrn_tpu_torch.config import load_config
from mrn_tpu_torch.data import image
from mrn_tpu_torch.data.synthetic import alphabet_of_size
from mrn_tpu_torch.models.init import random_recognizer, random_router
from mrn_tpu_torch.models.svtr import Block
from mrn_tpu_torch.parallel import mesh, multihost
from mrn_tpu_torch.serve import Server
from mrn_tpu_torch.tools import create_lmdb

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import evaluate_cli as jax_evaluate_cli  # noqa: E402
import recognize_cli as jax_recognize_cli  # noqa: E402

SVTR = dict(embed_dim=(16, 32, 64), depth=(1, 2, 1), num_heads=(2, 2, 4), drop_path_rate=0.0)
IMG_W = 64
LANS = ["T0", "T1"]
ALPHABETS = [alphabet_of_size(10), alphabet_of_size(6, 0x4E00 + 10)]
N_TRAIN, N_TEST = 12, 10
BLOCK_INIT = Block.__init__   # the Blocks' own GELU, as a launched train_cli builds them
# tests/test_torch_int8.py's tolerance for the int8 recognizer's logits
# against JAX's (the Pallas int8 kernel in interpret mode)
INT8_LOGIT_ATOL, INT8_LOGIT_MEAN_ATOL = 1.5e-2, 5e-3


@pytest.fixture(autouse=True, scope="module")
def narrow():
    """The JAX package with the narrow SVTR; every port Block with the
    degree-15 erf fit; torch on one thread."""

    class NarrowSVTR(jax_svtr.SVTRExtractor):
        embed_dim: tuple = SVTR["embed_dim"]
        depth: tuple = SVTR["depth"]
        num_heads: tuple = SVTR["num_heads"]
        drop_path_rate: float = SVTR["drop_path_rate"]

    block_init = Block.__init__

    def init15(self, *args, **kwargs):
        block_init(self, *args, **kwargs)
        self.gelu_degree = 15

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_composer, "SVTRExtractor", NarrowSVTR)
    mp.setattr(Block, "__init__", init15)
    jax_svtr.set_attention_impl("xla")
    yield
    jax_svtr.set_attention_impl("auto")
    mp.undo()
    torch.set_num_threads(threads)


def _encoder():
    state = {"n": 0}

    def encode(rgba):
        state["n"] += 1
        if state["n"] % 2:
            return image.encode_png(rgba)
        buf = io.BytesIO()
        PIL.Image.fromarray(rgba).convert("RGB").save(buf, "JPEG", quality=90)
        return buf.getvalue()
    return encode


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    index = {ch: i for i, ch in enumerate("".join(ALPHABETS))}
    for split, n, seed in (("train", N_TRAIN, 0), ("test", N_TEST, 50)):
        for t, lan in enumerate(LANS):
            create_lmdb.create_synthetic_dataset(str(root / split / lan), ALPHABETS[t], n,
                                                 seed + t, heights=(20, 40), widths=(40, 160),
                                                 max_len=5, char_to_idx=index, encode=_encoder())
    return root


def _config(root, name, **overrides):
    """A reference-format config file over the tree (the same file serves
    both packages: the JAX one narrows SVTR through the patched class)."""
    common = dict(dict(exp_name=name, il="mrn", memory="random", memory_num=8,
                       batch_max_length=8, imgH=32, imgW=IMG_W, manual_seed=111,
                       output_dir=str(root / "saved"), data_log=str(root / "data_any.txt")),
                  **overrides)
    model = dict(model_name="SVTR", Transformation="None", FeatureExtraction="SVTR",
                 SequenceModeling="None", Prediction="CTC", input_channel=4, output_channel=32,
                 hidden_size=16, svtr=SVTR)
    train = dict(lan_list=LANS, select_data=[str(root / "train")],
                 valid_datas=[str(root / "test")], batch_size=8, NED=True, workers=0,
                 num_iter=4, val_interval=2)
    path = root / f"{name}.py"
    path.write_text(f"common = {common!r}\nmodel = {model!r}\ntrain = {train!r}\n",
                    encoding="utf-8")
    return str(path)


# ------------------------------------------------------------- train_cli
def test_train_cli_end_to_end(tree, capsys):
    cfg = _config(tree, "port_mrn")
    runs = [train_cli.main(["--config", cfg, "--device", "cpu"])]
    out = capsys.readouterr().out
    exp = tree / "saved" / "port_mrn"
    names = sorted(p.name for p in exp.iterdir())
    assert names == ["T0_0_0_best_score.msgpack", "T1_1_0_best_score.msgpack",
                     "T1_1_1_best_score.msgpack", "experts", "log_train.txt"]
    assert len(list((exp / "experts").iterdir())) == 2
    log = (exp / "log_train.txt").read_text(encoding="utf-8")
    for line in ("Task 0 Test AIA:", "Task 1 Test AIA:", "Task 1 accs:", "Best_score:"):
        assert line in log
    assert f"ALL Average Incremental Accuracy: {sum(runs[0].best_scores) / 2:.2f}" in out
    assert "select_data: [" in out     # the CLI's own log echoes
    data_log = (tree / "data_any.txt").read_text(encoding="utf-8")
    assert "----------- port_mrn ------------" in data_log and "ALL Average Acc:" in data_log
    # the device bank's run takes the same stream: the same losses
    runs.append(train_cli.main(["--config", _config(tree, "port_mrn_bank"), "--device", "cpu",
                                "--device_bank"]))
    losses = [[r["loss"] for r in run.learner.history] for run in runs]
    assert len(losses[0]) == 4 + 4 + 2 and losses[0] == losses[1]
    assert runs[0].best_scores == runs[1].best_scores


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture
def one_rank_world(monkeypatch):
    """torchrun's environment for a 1-rank world on a free port; the group
    and the mesh are taken down afterwards."""
    for key, value in dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()), RANK="0",
                           WORLD_SIZE="1", LOCAL_RANK="0").items():
        monkeypatch.setenv(key, value)
    yield
    mesh.clear()
    if multihost.is_initialized():
        torch.distributed.destroy_process_group()


def test_train_cli_refuses_parallel_flags_and_needs_a_card(tree, monkeypatch):
    cfg = _config(tree, "refused")
    for key in multihost.TORCHRUN_ENV:
        monkeypatch.delenv(key, raising=False)
    # more than one shard, or the start-up, without torchrun's process group
    for flag in (["--data_parallel", "2"], ["--expert_parallel", "2"], ["--multihost"]):
        with pytest.raises(RuntimeError, match="torchrun"):
            train_cli.main(["--config", cfg, "--device", "cpu", *flag])
    # a world whose size disagrees with the flags
    for key, value in dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()), RANK="0",
                           WORLD_SIZE="1", LOCAL_RANK="0").items():
        monkeypatch.setenv(key, value)
    try:
        for flag in (["--data_parallel", "2"], ["--expert_parallel", "2"]):
            with pytest.raises(ValueError, match="the world has 1|do not split"):
                train_cli.main(["--config", cfg, "--device", "cpu", *flag])
    finally:
        mesh.clear()
        torch.distributed.destroy_process_group()
    for key in multihost.TORCHRUN_ENV:
        monkeypatch.delenv(key)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main, extra in ((train_cli.main, []),
                        (evaluate_cli.main, ["--saved_model", "x", "--eval_data", "y"]),
                        (recognize_cli.main, ["--saved_model", "x", "--image_folder", "y"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            main(["--config", cfg, *extra])


def _router_and_experts(learner):
    return ([v.clone() for s in learner.expert_states for v in s.values()]
            + [v.clone() for v in learner.router_state.values()])


@pytest.fixture(scope="module")
def one_process(tree):
    """train_cli in this process without a process group, with the Blocks'
    own GELU, as ``python -m mrn_tpu_torch.train_cli`` runs: the reference
    of the 1-rank world and of the torchrun launch."""
    mp = pytest.MonkeyPatch()
    mp.setattr(Block, "__init__", BLOCK_INIT)
    for key in multihost.TORCHRUN_ENV + ("LOCAL_RANK",):
        mp.delenv(key, raising=False)
    try:
        return train_cli.main(["--config", _config(tree, "launch_one"), "--device", "cpu"])
    finally:
        mp.undo()


def test_train_cli_in_a_one_rank_world_is_bitwise_the_run_without(tree, one_process,
                                                                  one_rank_world, monkeypatch):
    """The parallel path (process group, 1-rank mesh, every collective) over
    one gloo rank computes what the run without a group computes."""
    monkeypatch.setattr(Block, "__init__", BLOCK_INIT)
    world = train_cli.main(["--config", _config(tree, "world1"), "--device", "cpu",
                            "--data_parallel", "1"])
    assert mesh.get_mesh().shape == {"data": 1}
    assert (world.best_scores, world.ned_scores) == \
        (one_process.best_scores, one_process.ned_scores)
    for a, b in zip(_router_and_experts(world.learner), _router_and_experts(one_process.learner)):
        assert torch.equal(a, b)
    assert [r["loss"] for r in world.learner.history] == \
        [r["loss"] for r in one_process.learner.history]


def _log_numbers(path, key):
    text = open(path, encoding="utf-8").read()
    return [float(x) for x in re.findall(rf"{key}: ([-0-9.e]+)", text)]


def test_train_cli_under_torchrun_matches_one_process(tree, one_process):
    """``torchrun --nproc_per_node 2 -m mrn_tpu_torch.train_cli --device cpu``
    against the same run in one process: the same best files and scores,
    and the logged losses to 1e-3 (measured 1.1e-4): the two sum in
    another order, and Adam turns the float noise of the gradients whose
    exact value is 0 (the patch embedding's weights on the constant alpha
    channel, its conv biases before BatchNorm) into steps of up to its
    learning rate either way."""
    env = {k: v for k, v in os.environ.items() if k not in multihost.TORCHRUN_ENV}
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=root + os.pathsep + env.get("PYTHONPATH", ""))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2",
           "--master_addr", "127.0.0.1", "--master_port", str(_free_port()),
           "-m", "mrn_tpu_torch.train_cli", "--config", _config(tree, "launch_two"),
           "--device", "cpu"]
    done = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stdout[-3000:] + done.stderr[-3000:]
    one, two = (tree / "saved" / f"launch_{n}" for n in ("one", "two"))
    assert sorted(p.name for p in one.iterdir()) == sorted(p.name for p in two.iterdir())
    for key in ("Current_score", "Ned_score", "Test AIA"):
        assert _log_numbers(one / "log_train.txt", key) == \
            _log_numbers(two / "log_train.txt", key), key
    for key in ("Train_loss", "Valid_loss"):
        np.testing.assert_allclose(_log_numbers(two / "log_train.txt", key),
                                   _log_numbers(one / "log_train.txt", key), rtol=1e-3,
                                   atol=1e-5, err_msg=key)


# --------------------------------------------------- JAX-written checkpoints
def _spread_experts(opt, counts, seed):
    """Experts in the JAX init distributions (``models.init``, numpy flax
    trees) with their fc spread (init weights give near-equal logits)."""
    rng = np.random.default_rng(seed)
    experts = []
    for count in counts:
        params, stats = random_recognizer(rng, opt, count)
        params["fc"]["kernel"] = 3 * rng.standard_normal(
            params["fc"]["kernel"].shape).astype(np.float32)
        experts.append((params, stats))
    return experts


@pytest.fixture(scope="module")
def jax_ckpt(tree):
    """Task 0's and task 1's best files of the JAX MRN learner (expert
    blobs beside them), written by its ``_save_best``."""
    cfg = _config(tree, "jax_mrn")
    jopt = jax_load_config(cfg, prefetch=False)
    counts = (4 + len(ALPHABETS[0]), 4 + len(ALPHABETS[0]) + len(ALPHABETS[1]))
    experts = _spread_experts(load_config(cfg), counts, 21)
    jl = JaxMRN(jopt)
    jl.character = ALPHABETS[0]
    jl.converter = jl.build_converter()
    jl._cur_task, jl._phase = 0, "standalone"
    jl.params, jl.batch_stats = experts[0]
    jl._save_best(0, step=0)
    jl.character = "".join(ALPHABETS)
    jl.converter = jl.build_converter()
    jl.expert_params = [p for p, _ in experts]
    jl.expert_stats = [s for _, s in experts]
    jl.class_counts = list(counts)
    jl._cur_task, jl._phase = 1, "routed"
    jl._build_mrn_module(n_experts=2, counts=counts)
    rng = np.random.default_rng(4)
    router = random_router(rng, load_config(cfg), 2)
    for key in ("channel_route", "route"):   # routing that varies per sample
        router[key]["kernel"] = rng.standard_normal(router[key]["kernel"].shape).astype(np.float32)
    jl.router_params = router
    jl.params, jl.batch_stats = jl._routed_variables(router)
    jl._save_best(1, step=1)
    exp = tree / "saved" / "jax_mrn"
    return dict(cfg=cfg, task0=str(exp / "T0_0_0_best_score.msgpack"),
                task1=str(exp / "T1_1_1_best_score.msgpack"))


def _jax_routed_learner(cfg, path):
    """JAX's ``evaluate_cli.load_learner`` of a routed file; its
    validation served by the full routed variables, its params the
    router's as its CLI counts them."""
    jopt = jax_load_config(cfg, extra_sections=["test"])
    jl = jax_evaluate_cli.load_learner(jopt, path, 1)
    routed = jl._routed_variables(jl.router_params)
    counted = jl.params
    run = jl.run_validation
    jl._envelope_checked = True    # its envelope check reads the router as an expert

    def run_validation(loader, choose="val"):
        jl.params, jl.batch_stats = routed
        try:
            return run(loader, choose)
        finally:
            jl.params = counted
    jl.run_validation = run_validation
    return jopt, jl, routed


def _without_infer_time(text):
    return re.sub(r"averaged_infer_time: [0-9.]+", "averaged_infer_time: -", text)


def test_evaluate_cli_on_jax_checkpoint_matches_jax(tree, jax_ckpt, tmp_path, capsys):
    root = str(tree / "test")
    port_res, jax_res = tmp_path / "port", tmp_path / "jax"
    got = evaluate_cli.main(["--config", jax_ckpt["cfg"], "--saved_model", jax_ckpt["task1"],
                             "--eval_data", root, "--device", "cpu",
                             "--result_dir", str(port_res)])
    jopt, jl, _ = _jax_routed_learner(jax_ckpt["cfg"], jax_ckpt["task1"])
    ref = jax_evaluate_cli.evaluate_tasks(jl, jopt, [root], 1, result_dir=str(jax_res))
    assert got == ref
    assert len(got[0]) == 2 and any(n > 0 for n in got[1])    # the spread fc reads words
    name = "log_evaluation.txt"
    assert (port_res / "jax_mrn" / name).read_text(encoding="utf-8") == \
        (jax_res / "jax_mrn" / name).read_text(encoding="utf-8")

    # benchmark_all_eval over the tree's languages, with its three files
    learner = evaluate_cli.load_learner(load_config(jax_ckpt["cfg"], extra_sections=["test"]),
                                        jax_ckpt["task1"], 1, device="cpu")
    for mod, lrn, opt, res in ((evaluate_cli, learner, learner.opt, port_res),
                               (jax_evaluate_cli, jl, jopt, jax_res)):
        opt.eval_type, opt.eval_data = "IL_STR", root + "/"
        mod.benchmark_all_eval(lrn, opt, 1, result_dir=str(res),
                               evaluation_log_dir=str(res / "evlog"), eval_data_list=LANS)
    name = "log_all_evaluation.txt"
    text = [_without_infer_time((r / "jax_mrn" / name).read_text(encoding="utf-8"))
            for r in (port_res, jax_res)]
    assert text[0] == text[1] and "accuracy: T0:" in text[0]
    logs = [sorted((r / "evlog").iterdir()) for r in (port_res, jax_res)]
    assert [p.name for p in logs[0]] == [p.name for p in logs[1]]
    assert logs[0][0].read_text(encoding="utf-8").replace(str(port_res), "R") == \
        logs[1][0].read_text(encoding="utf-8").replace(str(jax_res), "R")


def test_recognize_cli_matches_jax(tree, jax_ckpt, tmp_path):
    from mrn_tpu_torch.data.lmdb_store import LmdbReader

    folder = tmp_path / "crops"
    folder.mkdir()
    env = LmdbReader(str(tree / "test" / "T1"))
    for i in range(N_TEST):
        raw = env.get(b"image-%09d" % (i + 1))
        ext = ".png" if raw.startswith(image.PNG_MAGIC) else ".jpg"
        (folder / f"{i:03d}{ext}").write_bytes(raw)
    got = recognize_cli.main(["--config", jax_ckpt["cfg"], "--saved_model", jax_ckpt["task1"],
                              "--image_folder", str(folder), "--device", "cpu"])
    jopt, jl, routed = _jax_routed_learner(jax_ckpt["cfg"], jax_ckpt["task1"])
    jl.params, jl.batch_stats = routed
    ref = list(jax_recognize_cli.recognize(jl, jopt, str(folder)))
    assert [(p, w) for p, w, _ in got] == [(p, w) for p, w, _ in ref]
    assert any(w for _, w, _ in got)
    np.testing.assert_allclose([c for _, _, c in got], [c for _, _, c in ref], atol=1e-5,
                               rtol=0)


# -------------------------------------------------------------------- RBA
def test_rba_eval_matches_jax(tree, tmp_path):
    """``--model_name RBA`` on a JAX-saved None/ResNet/BiLSTM/Attn
    recognizer: Acc and Ned per dataset and the words."""
    cfg = _config(tree, "rba", il="base", memory=None)
    jopt = jax_load_config(cfg, extra_sections=["test"])
    jopt.model_name = "RBA"
    jax_evaluate_cli.apply_model_name_presets(jopt)
    chars = "".join(ALPHABETS)
    n = len(chars) + 5
    rng = np.random.default_rng(31)
    model = jax_composer.build_recognizer(jopt, n)
    x = np.zeros((2, 32, IMG_W, 4), np.float32)
    text = jnp.full((2, 1), 2, jnp.int32)
    v = jax.jit(lambda k: model.init({"params": k}, x, text=text, train=False,
                                     is_train=False))(jax.random.PRNGKey(7))
    v = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(np.shape(a)).astype(np.float32),
        jax.tree_util.tree_map(np.asarray, v))
    v["batch_stats"] = jax.tree_util.tree_map(lambda a: np.abs(a) + 0.5, v["batch_stats"])
    v["params"]["fc"]["kernel"] = 3 * rng.standard_normal(
        v["params"]["fc"]["kernel"].shape).astype(np.float32)
    # BatchNorm statistics set on a batch of the tree's crops, so that
    # random weights tell the crops apart (chip_smoke.calibrate_random_trba)
    popt = evaluate_cli.apply_model_name_presets(
        load_config(cfg, extra_sections=["test"], model_name="RBA"))
    srv = Server(popt, v["params"], v["batch_stats"], chars, device="cpu")
    from mrn_tpu_torch.data.dataset import LmdbDataset
    ds = LmdbDataset(str(tree / "test" / "T1"), popt)
    crops = srv.images(np.stack([ds[i][0] for i in range(len(ds))]))
    chip_smoke.calibrate_random_trba(srv.model, crops, torch.full((len(ds), 1), 2))
    params, stats = to_flax(srv.model)
    path = tmp_path / "rba_1_best.msgpack"
    jax_save_model(str(path), params, stats)

    root = str(tree / "test")
    got = evaluate_cli.main(["--config", cfg, "--saved_model", str(path), "--eval_data", root,
                             "--model_name", "RBA", "--device", "cpu",
                             "--result_dir", str(tmp_path / "port")])
    jl = jax_evaluate_cli.load_learner(jopt, str(path), 1)
    ref = jax_evaluate_cli.evaluate_tasks(jl, jopt, [root], 1,
                                          result_dir=str(tmp_path / "jax"))
    assert got == ref and any(n > 0 for n in got[1])
    learner = evaluate_cli.load_learner(popt, str(path), 1, device="cpu")
    loader = lambda mod, o: mod.ValDataset([os.path.join(root, "T1")], o).create_dataset()  # noqa: E731
    from mrn_tpu_torch.data import manager
    from mrn_tpu.data import manager as jax_manager
    words = learner.run_validation(loader(manager, popt), "test").preds
    assert words == jl.run_validation(loader(jax_manager, jopt), "test").preds


# ------------------------------------------------------------------- int8
def test_int8_eval_matches_jax(tree, jax_ckpt, tmp_path):
    """``--int8 --taski 0`` on the JAX file of task 0: the quantized
    recognizer's logits against JAX's int8 eval (the Pallas int8 Block in
    interpret mode), Acc per dataset equal."""
    import mrn_tpu.ops.svtr_block as jax_block_ops

    root = str(tree / "test")
    seen = {}
    real = evaluate_cli.load_learner

    def load_learner(*args, **kwargs):
        seen["learner"] = real(*args, **kwargs)
        return seen["learner"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(evaluate_cli, "load_learner", load_learner)
        got = evaluate_cli.main(["--config", jax_ckpt["cfg"], "--saved_model",
                                 jax_ckpt["task0"], "--taski", "0", "--int8", "--eval_data",
                                 root, "--device", "cpu", "--result_dir", str(tmp_path / "p")])
    learner = seen["learner"]
    assert learner.eval_quant and any(getattr(m, "quant", "") == "int8"
                                      for m in learner.model.modules())

    jopt = jax_load_config(jax_ckpt["cfg"], extra_sections=["test"], il="base")
    jl = jax_evaluate_cli.load_learner(jopt, jax_ckpt["task0"], 0)
    calib = JaxValDataset([os.path.join(root, "T0")], jopt).create_dataset()
    jax_evaluate_cli.quantize_learner_int8(jl, jopt, calib)
    fused = jax_block_ops.fused_block
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_block_ops, "fused_block", functools.partial(fused, interpret=True))
        jax_svtr.set_attention_impl("pallas")
        try:
            ref = jax_evaluate_cli.evaluate_tasks(jl, jopt, [root], 0,
                                                  result_dir=str(tmp_path / "j"))
            images, _, _ = next(iter(calib))
            ref_logits = np.asarray(jl.model.apply(
                {"params": jl.params, "batch_stats": jl.batch_stats, "quant": jl.eval_quant},
                jnp.asarray(images), train=False)["predict"])
        finally:
            jax_svtr.set_attention_impl("xla")
    assert got[0] == ref[0]
    port_batch = next(iter(evaluate_cli.ValDataset([os.path.join(root, "T0")],
                                                   learner.opt).create_dataset()))[0]
    with torch.no_grad():
        logits = learner._eval_logits(learner._device_images(port_batch), "FF").numpy()
    diff = np.abs(logits - ref_logits)
    assert diff.max() <= INT8_LOGIT_ATOL and diff.mean() <= INT8_LOGIT_MEAN_ATOL, \
        (diff.max(), diff.mean())
    top2 = np.sort(ref_logits, axis=-1)[..., -2:]
    decided = top2[..., 1] - top2[..., 0] > 2 * diff.max()
    np.testing.assert_array_equal(logits.argmax(-1)[decided], ref_logits.argmax(-1)[decided])
