"""Data- and expert-parallel training of the port (``mrn_tpu_torch.parallel``)
over a 2-rank gloo world on the CPU, against the single-process port and
the JAX package's meshes.

Each rank runs ``tests/torch_parallel_worker.py`` under torchrun's
environment on a free localhost port (``multihost.initialize(device="cpu")``,
torch on one thread); the same scenarios without a process group are the
reference.  Held here:

- the mesh's layout, ``shard_batch`` / ``shard_experts`` (the non-divisible
  count replicated), ``replicate`` and ``gather_for_host``, and the identity
  functions and refusals without a group;
- one train-mode BatchNorm's outputs, input and parameter gradients and
  running statistics: the global batch's;
- SVTR-MRN (narrow, DropPath on): three step-0 steps of a new expert and
  three router steps over a data mesh, three router steps over a 1 x 2
  ``data x expert`` mesh, pinned and drifting;
- one TRBA (Attn) step whose halves hold 7 and 2 targets a word: the loss
  and gradient of the global token count, not a mean of the ranks' means;
- three CRNN base-learner steps against the JAX ``BaseLearner`` under
  ``set_data_parallel(2)`` on its virtual CPU devices;
- MRN's routed logits and picks on the 1 x 2 mesh against the JAX
  ``MRNNet`` under ``set_expert_parallel(2)`` (``tests/test_parallel.py``'s
  shapes and atol; its experts are VGG + BiLSTM, the CRNN the port builds,
  where that test leaves the sequence model out);
- EWC's Fisher over the world.

Tolerances.  A world sums in another order than one process: gradients are
held to ``GRAD_TOL`` of the tree's largest gradient (measured 3.4e-6 for
SVTR, whose patch-embedding BatchNorms' fast variance cancels; 1.4e-4 for
TRBA's TPS, held at ``TRBA_GRAD_TOL`` as ``tests/test_torch_trba_train.py``
holds it against JAX), parameters and statistics after three steps at
``tests/test_multihost.py``'s rtol 5e-5, atol 1e-6.  A leaf whose exact
gradient is 0 (a conv bias feeding a train-mode BatchNorm, the router's
``route`` bias, which shifts every expert's score alike) gets float noise
in either layout, and Adam's normalisation turns noise into steps of up to
its learning rate either way: those leaves, and the running means of those
BatchNorms, are held within ``ADAM_NOISE`` (two learning rates a step).
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_worker as worker
from mrn_tpu.config import load_config as jax_load_config
from mrn_tpu.models.composer import build_recognizer as jax_build_recognizer
from mrn_tpu.models.mrn import MRNNet as JaxMRNNet
from mrn_tpu.parallel.mesh import set_data_parallel as jax_set_data_parallel
from mrn_tpu.parallel.mesh import set_expert_parallel as jax_set_expert_parallel
from mrn_tpu.parallel.mesh import replicate as jax_replicate
from mrn_tpu.parallel.mesh import shard_batch as jax_shard_batch
from mrn_tpu.parallel.mesh import shard_experts as jax_shard_experts
from mrn_tpu.train.learners.base import BaseLearner as JaxBaseLearner
from mrn_tpu.train.steps import TrainState as JaxTrainState
from mrn_tpu_torch.parallel import mesh, multihost

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAD_TOL = 1e-5
TRBA_GRAD_TOL = 5e-4
PARAM_RTOL, PARAM_ATOL = 5e-5, 1e-6
ADAM_NOISE = 2 * worker.STEPS * 5e-4          # the configs' Adam learning rate
ZERO_GRAD = ("patch_embed/conv1/bias", "patch_embed/conv2/bias", "patch_embed/bn1/mean",
             "patch_embed/bn2/mean", "route/bias")
# the JAX mesh's and the port's CRNN steps: the losses to float32 summation
# order, the first gradient as tests/test_torch_crnn.py holds one step (1e-4
# of the largest plus 1e-3 relative); after three Adam steps every
# parameter within ADAM_NOISE and all but JAX_STRAY of them at the tight
# tolerance: across frameworks a gradient element at noise level steps
# Adam by up to its learning rate either way (ROADMAP.md §3; measured 1 of
# 31,812 elements, an LSTM input weight, 2.8e-5 away)
JAX_LOSS_RTOL = 1e-5
JAX_GRAD_GLOBAL, JAX_GRAD_RTOL = 1e-4, 1e-3
JAX_STRAY = 1e-3
EP_ATOL = 1e-5
WORLD_TIMEOUT = 300


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v, np.float64)


def _largest(tree):
    return max(float(np.abs(v).max(initial=0.0)) for _, v in _leaves(tree))


def _assert_grads(got, ref, tol, what):
    scale = tol * _largest(ref)
    ref = dict(_leaves(ref))
    for k, v in _leaves(got):
        np.testing.assert_allclose(v, ref[k], atol=scale, rtol=0, err_msg=f"{what}: {k}")


def _assert_params(got, ref, what):
    ref = dict(_leaves(ref))
    got = dict(_leaves(got))
    assert got.keys() == ref.keys(), what
    for k, v in got.items():
        if k.endswith(ZERO_GRAD):
            np.testing.assert_allclose(v, ref[k], atol=ADAM_NOISE, rtol=0, err_msg=f"{what}: {k}")
        else:
            np.testing.assert_allclose(v, ref[k], atol=PARAM_ATOL, rtol=PARAM_RTOL,
                                       err_msg=f"{what}: {k}")


@pytest.fixture(scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """Both ranks of the gloo world, started (they run while this process
    computes the references)."""
    tmp = tmp_path_factory.mktemp("parallel_world")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE="2",
               OMP_NUM_THREADS="1",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, os.path.join(ROOT, "tests",
                                                            "torch_parallel_worker.py"),
                               str(tmp)], env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    yield tmp, procs
    for p in procs:
        p.kill()


@pytest.fixture(scope="module")
def single(tmp_path_factory, _one_thread):
    """The same scenarios in this process, without a process group."""
    tmp = tmp_path_factory.mktemp("parallel_single")
    assert not multihost.is_initialized()
    return {fn.__name__: fn(str(tmp)) for fn in worker.SCENARIOS if fn.__name__ != "layout"}


@pytest.fixture(scope="module")
def jax_crnn(single, tmp_path_factory):
    """JAX's BaseLearner steps under ``set_data_parallel(2)`` from the port's
    initial CRNN, on the same batches: per-step losses, the first step's
    gradient, the final params."""
    tmp = tmp_path_factory.mktemp("parallel_jax")
    path, kw = worker.crnn_options(str(tmp), side="jax")
    jl = JaxBaseLearner(jax_load_config(path, **kw))
    jl._cur_task, jl.character = 0, list(worker.ALPHABETS[0])
    jl.converter = jl.build_converter()
    jl.model = jax_build_recognizer(jl.opt, jl._total_classes)
    params, stats = single["crnn_base"]["initial"]
    jl.params = jax.tree_util.tree_map(jnp.asarray, params)
    jl.batch_stats = jax.tree_util.tree_map(jnp.asarray, stats)
    jl.build_optimizer()
    try:
        jax_set_data_parallel(2)
        state = JaxTrainState(jax_replicate(jl.params), jax_replicate(jl.batch_stats),
                              jax_replicate(jl.opt_state), jnp.asarray(0, jnp.int32))
        step = jl.get_train_step()
        losses, first = [], None
        for images, words in worker.crnn_batches():
            batch = jl._encode_batch(images, words)
            rng = jax.random.PRNGKey(0)
            if first is None:
                first = jax.grad(lambda p: jl.loss_fn(p, state.batch_stats, batch, rng,
                                                      None)[0])(state.params)
            state, metrics = step(state, batch, rng, None)
            losses.append(float(metrics["loss"]))
        host = jax.tree_util.tree_map(np.asarray, (first, state.params, state.batch_stats))
    finally:
        jax_set_data_parallel(1)
    return dict(loss=losses, grads=host[0], params=host[1], stats=host[2])


@pytest.fixture(scope="module")
def world(launched, single, jax_crnn):
    """Every scenario on both ranks of the gloo world: ``[rank0, rank1]``."""
    tmp, procs = launched
    outs = [p.communicate(timeout=WORLD_TIMEOUT)[0] for p in procs]
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(2)]


# ----------------------------------------------------------------- the mesh
def test_mesh_layout_shards_and_collectives(world):
    for rank, res in enumerate(world):
        data, expert = res["layout"]["data"], res["layout"]["expert"]
        assert data["shape"] == {"data": 2} and data["data_index"] == rank
        assert data["rows"] == [4 * rank + i for i in range(4)] and data["odd"] == "raised"
        assert data["experts4"] == [0, 1, 2, 3]           # no expert axis: all of them
        assert expert["shape"] == {"data": 1, "expert": 2}
        assert (expert["data_index"], expert["expert_index"]) == (0, rank)
        assert expert["rows"] == list(range(8)) and expert["odd"] == "split"
        assert expert["experts4"] == [2 * rank, 2 * rank + 1]
        assert expert["experts3"] == [0, 1, 2]            # 3 on 2: replicated, as in JAX
        for res_axis in (data, expert):
            assert res_axis["replicated"] == [1.0] * 3     # rank 0's values
            assert res_axis["gathered"] == [10.0 * i for i in range(8)]
            assert res_axis["summed"] == 28.0


def test_without_a_group_the_mesh_is_the_identity_and_refuses_shards(monkeypatch):
    assert mesh.set_data_parallel(1) is None and mesh.get_mesh() is None
    x = np.arange(6)
    assert mesh.shard_batch(x) is x and list(mesh.shard_experts(3)) == [0, 1, 2]
    t = torch.ones(3)
    assert mesh.data_mean(t) is t and mesh.all_reduce_grads([t])[0] is t
    assert mesh.gather_for_host({"t": t})["t"] is t and mesh.is_main()
    for install in (lambda: mesh.set_data_parallel(2), lambda: mesh.set_expert_parallel(2)):
        with pytest.raises(RuntimeError, match="torchrun"):
            install()
    for key in multihost.TORCHRUN_ENV:
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        multihost.initialize(device="cpu")


def test_global_batchnorm_moments_and_gradient(world, single):
    ref = single["batchnorm"]
    for res in world:
        got = res["batchnorm"]
        for key in ("y", "gx", "gscale", "gbias", "mean", "var"):
            scale = float(np.abs(ref[key]).max())
            np.testing.assert_allclose(got[key], ref[key], atol=1e-6 * scale, rtol=0,
                                       err_msg=key)


def test_ranks_hold_the_same_replicas(world):
    for name in ("svtr_mrn", "crnn_base", "trba"):
        a, b = world[0][name], world[1][name]
        if "step0" in a:
            a, b = a["step0"], b["step0"]
        for (k, x), (_, y) in zip(_leaves(a["params"]), _leaves(b["params"])):
            assert np.array_equal(x, y), f"{name}: {k}"
        for (k, x), (_, y) in zip(_leaves(a["stats"]), _leaves(b["stats"])):
            assert np.array_equal(x, y), f"{name}: {k}"


# ------------------------------------------------------------------ SVTR-MRN
def test_svtr_mrn_expert_step_matches_one_process(world, single):
    ref = single["svtr_mrn"]["step0"]
    for res in world:
        got = res["svtr_mrn"]["step0"]
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-6)
        for g, r in zip(got["grads"], ref["grads"]):
            _assert_grads(g, r, GRAD_TOL, "step-0 grads")
        _assert_params(got["params"], ref["params"], "step-0 params")
        _assert_params(got["stats"], ref["stats"], "step-0 statistics")


@pytest.mark.parametrize("scenario", ["svtr_mrn", "svtr_mrn_expert", "svtr_mrn_drifting"])
def test_svtr_mrn_router_step_matches_one_process(world, single, scenario):
    ref = single[scenario]["step1"]
    blocks = []
    for res in world:
        got = res[scenario]["step1"]
        blocks.append(got["block"])
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-6)
        np.testing.assert_allclose(got["clf"], ref["clf"], rtol=1e-6)
        for g, r in zip(got["grads"], ref["grads"]):
            _assert_grads(g, r, GRAD_TOL, "router grads")
        _assert_params(got["params"], ref["params"], "router params")
        # the whole stack's statistics (gathered under the expert mesh)
        _assert_params(got["stats"], ref["stats"], "expert statistics")
    assert blocks == ([[0, 1], [0, 1]] if scenario == "svtr_mrn" else [[0], [1]])
    if scenario == "svtr_mrn_drifting":   # the drifting statistics did move
        pinned = dict(_leaves(single["svtr_mrn_expert"]["step1"]["stats"]))
        assert any(not np.array_equal(v, pinned[k]) for k, v in _leaves(ref["stats"]))


# ---------------------------------------------------------------------- TRBA
def test_trba_attn_step_uses_the_global_token_count(world, single):
    ref = single["trba"]
    for res in world:
        got = res["trba"]
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-6)
        _assert_grads(got["grads"][0], ref["grads"][0], TRBA_GRAD_TOL, "TRBA grads")
        # a mean of the ranks' token means is another loss
        assert abs(got["local_mean"] - ref["loss"][0]) > 1e3 * 1e-6 * ref["loss"][0]


# ------------------------------------------------------- CRNN against JAX
def test_crnn_base_learner_matches_one_process(world, single):
    ref = single["crnn_base"]
    for res in world:
        got = res["crnn_base"]
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-6)
        for g, r in zip(got["grads"], ref["grads"]):
            _assert_grads(g, r, GRAD_TOL, "CRNN grads")
        _assert_params(got["params"], ref["params"], "CRNN params")
        _assert_params(got["stats"], ref["stats"], "CRNN statistics")


def test_crnn_base_learner_matches_jax_data_parallel(world, jax_crnn):
    got = world[0]["crnn_base"]
    np.testing.assert_allclose(got["loss"], jax_crnn["loss"], rtol=JAX_LOSS_RTOL)
    scale = JAX_GRAD_GLOBAL * _largest(jax_crnn["grads"])
    ref = dict(_leaves(jax_crnn["grads"]))
    for k, v in _leaves(got["grads"][0]):
        np.testing.assert_allclose(v, ref[k], atol=scale, rtol=JAX_GRAD_RTOL, err_msg=k)
    ref = dict(_leaves(jax_crnn["params"]))
    ref.update((f"stats/{k}", v) for k, v in _leaves(jax_crnn["stats"]))
    mine = dict(_leaves(got["params"]))
    mine.update((f"stats/{k}", v) for k, v in _leaves(got["stats"]))
    assert mine.keys() == ref.keys()
    stray = total = 0
    for k, v in mine.items():
        np.testing.assert_allclose(v, ref[k], atol=ADAM_NOISE, rtol=0, err_msg=k)
        stray += int((np.abs(v - ref[k]) > PARAM_ATOL + PARAM_RTOL * np.abs(ref[k])).sum())
        total += v.size
    assert stray <= JAX_STRAY * total, (stray, total)


# ----------------------------------------------- MRN's experts against JAX
def test_mrn_expert_parallel_forward_matches_jax(world):
    params, stats, image = worker.ep_inputs()
    net = JaxMRNNet(n_experts=len(worker.EP_COUNTS), num_classes=worker.EP_CLASSES,
                    class_counts=worker.EP_COUNTS, prediction="CTC",
                    feature_extraction="VGG", sequence_modeling="BiLSTM", output_channel=32,
                    hidden_size=16, img_size=(32, 64))
    variables = {"params": params, "batch_stats": stats}

    @jax.jit
    def fwd(variables, image):
        out = net.apply(variables, image, cross=True, train=False, is_train=False)
        return out["logits"], out["index"]

    try:
        jax_set_expert_parallel(2)
        sharded = dict(jax_replicate(variables))
        sharded["params"] = dict(sharded["params"])
        sharded["params"]["experts"] = jax_shard_experts(variables["params"]["experts"], 2)
        if "batch_stats" in variables:
            sharded["batch_stats"] = {"experts": jax_shard_experts(
                variables["batch_stats"]["experts"], 2)}
        logits, index = jax.tree_util.tree_map(np.asarray, fwd(sharded, jax_shard_batch(image)))
    finally:
        jax_set_data_parallel(1)
    for rank, res in enumerate(world):
        got = res["mrn_forward"]
        assert got["block"] == [rank]
        np.testing.assert_allclose(got["logits"], logits, atol=EP_ATOL)
        np.testing.assert_array_equal(got["index"], index)


# ----------------------------------------------------------------------- EWC
def test_ewc_fisher_is_the_global_batch(world, single):
    ref = single["ewc_fisher"]
    rms = {k: np.sqrt(v) for k, v in _leaves(ref["fisher"])}
    for res in world:
        got = {k: np.sqrt(v) for k, v in _leaves(res["ewc_fisher"]["fisher"])}
        _assert_grads(got, rms, GRAD_TOL, "Fisher's root")
        _assert_params(res["ewc_fisher"]["stats"], ref["stats"], "Fisher-pass statistics")
