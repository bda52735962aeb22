"""The scenarios of ``tests/test_torch_parallel.py``, run on each rank of a
gloo world on the CPU and, without a process group, as the single-process
reference.  Each scenario takes the shared inputs directory and returns a
dict of numpy arrays and numbers; ``main`` runs them all on one rank and
saves ``{out}/rank{r}.pt``.

    python tests/torch_parallel_worker.py OUT_DIR  # under torchrun's environment

Every scenario draws its weights and batches from fixed seeds, so every rank
and the reference start alike; the ranks keep their rows of each global
batch (``mesh.shard_batch``), as ``train_cli`` does under torchrun."""

import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from mrn_tpu_torch.bridge import flax_tree, mrn_state, to_flax  # noqa: E402
from mrn_tpu_torch.config import load_config  # noqa: E402
from mrn_tpu_torch.data.synthetic import SyntheticTaskLoader, alphabet_of_size  # noqa: E402
from mrn_tpu_torch.models.common import BatchNorm  # noqa: E402
from mrn_tpu_torch.models.init import random_mrn, random_recognizer, random_router  # noqa: E402
from mrn_tpu_torch.models.mrn import MRNNet  # noqa: E402
from mrn_tpu_torch.ops.losses import cross_entropy_ignore  # noqa: E402
from mrn_tpu_torch.parallel import mesh, multihost  # noqa: E402
from mrn_tpu_torch.train.learners.base import BaseLearner  # noqa: E402
from mrn_tpu_torch.train.learners import ewc  # noqa: E402
from mrn_tpu_torch.train.learners.mrn import MRN  # noqa: E402

# the narrow SVTR of the port's other CPU tests, DropPath on: its masks are
# drawn for the global batch on every rank
SVTR = dict(embed_dim=(16, 32, 64), depth=(1, 2, 1), num_heads=(2, 2, 4))
ALPHABETS = [alphabet_of_size(10), alphabet_of_size(6, 0x4E00 + 10)]
CHARS = ALPHABETS[0] + ALPHABETS[1]
BATCH = 4            # global batch of the SVTR, TRBA and EWC scenarios
CRNN_BATCH = 8       # global batch of the CRNN base learner
STEPS = 3
# the JAX package's expert-parallel test's shapes (tests/test_parallel.py),
# its experts a CRNN (VGG + BiLSTM) where that test has no sequence model
EP_COUNTS, EP_CLASSES, EP_BATCH = (8, 12), 12, 8


def _host(tree):
    return {k: _host(v) if isinstance(v, dict) else np.asarray(v) for k, v in tree.items()}


def _capture_grads(learner):
    """The gradients ``grad_transform`` sees (global under a mesh), one dict
    per step."""
    seen = []

    def transform(grads):
        seen.append({k: v.detach().clone() for k, v in grads.items()})
        return grads

    learner.grad_transform = lambda: transform
    return seen


def _float_images(loader, idx, seed):
    """The crops, normalised, the constant alpha channel replaced by seeded
    noise (the JAX learner reads an integer batch as bank indices)."""
    images = (loader.bank[idx].astype(np.float32) / 255.0 - 0.5) / 0.5
    images[..., 3] = np.random.default_rng(seed).uniform(-1, 1, images.shape[:3])
    return images


class FloatBatches:
    """A ``SyntheticTaskLoader``'s batches as float images with a noise
    alpha channel (``_float_images``): a constant channel would make its
    patch-embedding weights a second bias, whose gradient is float noise."""

    def __init__(self, loader):
        self.loader, self.calls = loader, 0

    def _images(self, idx):
        self.calls += 1
        return _float_images(self.loader, idx, 1000 + self.calls)

    def get_batch(self):
        idx, words = self.loader.get_batch()
        return self._images(idx), words

    def get_batch2(self):
        idx, words, task_ids = self.loader.get_batch2()
        return self._images(idx), words, task_ids


def _svtr_options(tmp, **kw):
    return load_config(os.path.join(ROOT, "configs", "svtr_mrn.py"), svtr=SVTR, imgW=128,
                       output_channel=32, hidden_size=16, batch_size=BATCH, num_iter=4,
                       manual_seed=3, output_dir=os.path.join(tmp, "saved"),
                       data_log=os.path.join(tmp, "data_any.txt"), **kw)


def _record(model, grads, metrics):
    params, stats = to_flax(model)
    return {"params": _host(params), "stats": _host(stats),
            "grads": [_host(flax_tree(g.items())) for g in grads],
            "loss": [float(m["loss"]) for m in metrics]}


# ------------------------------------------------------------------ scenarios
def layout(tmp):
    """The mesh's layout and the identity functions' counterparts."""
    out = {}
    for name, install in (("data", lambda: mesh.set_data_parallel()),
                          ("expert", lambda: mesh.set_expert_parallel(2))):
        m = install()
        rank = torch.distributed.get_rank()
        x = torch.arange(8.0)
        got = torch.full((3,), float(rank + 1))
        mesh.replicate([got])
        gathered = mesh.gather_for_host({"rows": mesh.shard_batch(x) * 10,
                                         "sum": mesh.shard_batch(x).sum()})
        try:
            mesh.shard_batch(np.arange(7))
            odd = "split"
        except ValueError:
            odd = "raised"
        out[name] = dict(shape=m.shape, data_index=m.data_index, expert_index=m.expert_index,
                         rows=mesh.shard_batch(np.arange(8)).tolist(),
                         experts4=list(mesh.shard_experts(4)),
                         experts3=list(mesh.shard_experts(3)),
                         replicated=got.tolist(), gathered=gathered["rows"].tolist(),
                         summed=float(gathered["sum"]), odd=odd)
    mesh.clear()
    return out


def batchnorm(tmp):
    """One train-mode BatchNorm over the global batch's rows: outputs, the
    input gradient (each rank's is ``D`` times its rows' share of the global
    loss's), the parameter gradients averaged over the world, the running
    statistics."""
    mesh.set_data_parallel() if torch.distributed.is_initialized() else None
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.normal(1.0, 2.0, (8, 6, 3, 5)).astype(np.float32))
    w = torch.as_tensor(rng.normal(size=(8, 6, 3, 5)).astype(np.float32))
    bn = BatchNorm(6)
    with torch.no_grad():
        bn.scale.copy_(torch.as_tensor(rng.uniform(0.5, 1.5, 6).astype(np.float32)))
        bn.bias.copy_(torch.as_tensor(rng.normal(size=6).astype(np.float32)))
    xs = mesh.shard_batch(x).clone().requires_grad_(True)
    y = bn(xs, train=True)
    loss = (y * mesh.shard_batch(w)).pow(2).mean()
    gx, gs, gb = torch.autograd.grad(loss, [xs, bn.scale, bn.bias])
    gs, gb = mesh.all_reduce_grads([gs, gb])
    out = dict(y=mesh.gather_for_host({"y": y.detach()})["y"].numpy(),
               gx=mesh.gather_for_host({"g": gx / mesh.data_size()})["g"].numpy(),
               gscale=gs.numpy(), gbias=gb.numpy(), mean=bn.mean.numpy().copy(),
               var=bn.var.numpy().copy())
    mesh.clear()
    return out


def svtr_mrn(tmp, expert_parallel=False, pinned=True):
    """SVTR-MRN: three step-0 steps of a new expert (DropPath on), then
    three router steps over two frozen experts and that one's class count;
    under ``expert_parallel`` the router phase runs on a 1 x 2 mesh, in the
    drifting mode when not ``pinned``."""
    opt = _svtr_options(os.path.join(tmp, f"svtr_{expert_parallel}_{pinned}"),
                        mrn_pin_expert_stats=pinned)
    loader = FloatBatches(SyntheticTaskLoader(ALPHABETS, 1, BATCH, 8, img_w=128, seed=1))
    learner = MRN(opt, device="cpu")
    learner._cur_task, learner.character = 1, list(CHARS)
    learner.converter = learner.build_converter()
    out = {}
    if torch.distributed.is_initialized():
        mesh.set_data_parallel()
    if not expert_parallel:
        learner.change_model()
        learner.build_optimizer()
        grads = _capture_grads(learner)
        metrics = [learner.train_step(loader.get_batch()) for _ in range(STEPS)]
        out["step0"] = _record(learner.model, grads, metrics)
    rng = np.random.default_rng(21)
    counts = (1 + len(ALPHABETS[0]), 1 + len(CHARS))
    for count in counts:
        params, stats = random_recognizer(rng, opt, count)
        params["fc"]["kernel"] = 3 * rng.standard_normal(
            params["fc"]["kernel"].shape).astype(np.float32)
        learner.add_expert(params, stats, count)
    if expert_parallel and torch.distributed.is_initialized():
        mesh.set_expert_parallel(2)
    learner.start_router_phase(random_router(rng, opt, len(counts)))
    grads = _capture_grads(learner)
    metrics = [learner.train_step(loader.get_batch2()) for _ in range(STEPS)]
    router = {k: v for k, v in to_flax(learner.mrn_model)[0].items() if k != "experts"}
    out["step1"] = dict(_record(learner.mrn_model, grads, metrics), params=_host(router),
                        stats=_host(learner._expert_stats_tree()),
                        clf=[float(m["clf"]) for m in metrics],
                        block=list(learner.mrn_model.expert_block))
    mesh.clear()
    return out


def svtr_mrn_expert(tmp):
    return svtr_mrn(tmp, expert_parallel=True)


def svtr_mrn_drifting(tmp):
    return svtr_mrn(tmp, expert_parallel=True, pinned=False)


def _trba_options(tmp):
    return load_config(os.path.join(ROOT, "configs", "trba_mrn.py"), il="base", imgW=64,
                       output_channel=32, hidden_size=16, batch_size=BATCH,
                       batch_max_length=6, num_iter=4, manual_seed=3,
                       output_dir=os.path.join(tmp, "saved"),
                       data_log=os.path.join(tmp, "data_any.txt"))


TRBA_WORDS = ["abcdef", "bcdefa", "a", "b"]   # rank 0's rows long, rank 1's short


def trba(tmp):
    """One TRBA (TPS, ResNet, BiLSTM, Attn) base-learner step whose two
    halves of the batch hold 7 and 2 targets a word: the loss and gradient
    need the global token count.  ``local_mean`` is what a mean of the
    ranks' token means would report."""
    opt = _trba_options(os.path.join(tmp, "trba"))
    if torch.distributed.is_initialized():
        mesh.set_data_parallel()
    learner = BaseLearner(opt, device="cpu")
    learner._cur_task, learner.character = 0, list(ALPHABETS[0])
    learner.converter = learner.build_converter()
    learner.build_model()
    learner.build_optimizer()
    grads = _capture_grads(learner)
    images = np.random.default_rng(8).uniform(-1, 1, (BATCH, 32, 64, 4)).astype(np.float32)
    words = [w.translate(str.maketrans("abcdef", ALPHABETS[0][:6])) for w in TRBA_WORDS]
    batch = learner._encode_batch(images, words)
    stats = {k: b.clone() for k, b in learner.model.named_buffers()}
    with torch.no_grad():   # the ranks' token means, averaged
        preds = learner._apply_train(learner.state.params, batch)
        local = mesh.all_reduce_grads([cross_entropy_ignore(
            preds, batch["label"][:, 1:], learner.converter.pad_id)])[0]
        for k, b in learner.model.named_buffers():
            b.copy_(stats[k])
    metrics = [learner.train_step((images, words))]
    out = dict(_record(learner.model, grads, metrics), local_mean=float(local))
    mesh.clear()
    return out


def crnn_batches():
    """The CRNN scenario's three global batches: float images, words."""
    loader = SyntheticTaskLoader(ALPHABETS, 0, CRNN_BATCH, 16, img_w=64, max_len=5, seed=4)
    batches = []
    for i in range(STEPS):
        idx, words = loader.get_batch()
        batches.append((_float_images(loader, idx, 100 + i), list(words)))
    return batches


def crnn_options(tmp, side="port"):
    kw = dict(il="base", imgW=64, output_channel=32, hidden_size=16, batch_size=CRNN_BATCH,
              batch_max_length=6, num_iter=STEPS, manual_seed=3,
              output_dir=os.path.join(tmp, f"crnn_{side}"),
              data_log=os.path.join(tmp, f"crnn_{side}.txt"))
    return os.path.join(ROOT, "configs", "crnn_mrn.py"), kw


def crnn_base(tmp):
    """Three steps of the CRNN base learner (VGG's train-mode BatchNorms,
    BiLSTM, CTC) from its task-0 network; ``initial`` are its params and
    statistics before the first step (the JAX run's start)."""
    path, kw = crnn_options(tmp)
    opt = load_config(path, **kw)
    if torch.distributed.is_initialized():
        mesh.set_data_parallel()
    learner = BaseLearner(opt, device="cpu")
    learner._cur_task, learner.character = 0, list(ALPHABETS[0])
    learner.converter = learner.build_converter()
    learner.build_model()
    learner.build_optimizer()
    initial = [_host(t) for t in to_flax(learner.model)]
    grads = _capture_grads(learner)
    metrics = [learner.train_step(b) for b in crnn_batches()]
    out = dict(_record(learner.model, grads, metrics), initial=initial)
    mesh.clear()
    return out


def ewc_fisher(tmp):
    """EWC's Fisher diagonal over two batches of the narrow SVTR (DropPath
    on): squares of the global batch's gradient, unclamped (most of this
    random network's entries sit at the 1e-4 clamp)."""
    ewc.FISHERMAX = float("inf")
    opt = _svtr_options(os.path.join(tmp, "ewc"), il="ewc", fisher_num_iter=2)
    loader = FloatBatches(SyntheticTaskLoader(ALPHABETS, 0, BATCH, 8, img_w=128, seed=6))
    if torch.distributed.is_initialized():
        mesh.set_data_parallel()
    learner = ewc.EWC(opt, device="cpu")
    learner._cur_task, learner.character = 0, list(ALPHABETS[0])
    learner.converter = learner.build_converter()
    learner.build_model()
    fisher = learner.get_fisher_diagonal(loader)
    out = {"fisher": _host(flax_tree(fisher.items())),
           "stats": _host(to_flax(learner.model)[1])}
    mesh.clear()
    return out


def ep_inputs():
    """The expert-parallel forward's MRNNet trees (``random_mrn`` of a narrow
    CRNN, the fc spread so that no pick is a near-tie) and image."""
    rng = np.random.default_rng(7)
    path, kw = crnn_options("unused")
    params, stats = random_mrn(rng, load_config(path, **kw), EP_COUNTS)
    params["experts"]["fc"]["kernel"] *= 20.0
    image = rng.standard_normal((EP_BATCH, 32, 64, 4)).astype(np.float32)
    return params, stats, image


def mrn_forward(tmp):
    """The routed logits and picks of the JAX package's expert-parallel
    test's MRNNet on a 1 x 2 data x expert mesh."""
    params, stats, image = ep_inputs()
    if torch.distributed.is_initialized():
        mesh.set_expert_parallel(2)
    block = mesh.shard_experts(len(EP_COUNTS))
    net = MRNNet(len(EP_COUNTS), EP_CLASSES, EP_COUNTS, prediction="CTC",
                 feature_extraction="VGG", sequence_modeling="BiLSTM", output_channel=32,
                 hidden_size=16, img_size=(32, 64), num_fiducial=8, expert_block=block)
    state = mrn_state(params, stats)
    local = {}
    for k, v in state.items():
        if k.startswith("experts."):
            i, rest = k.split(".", 2)[1:]
            if int(i) in block:
                local[f"experts.{block.index(int(i))}.{rest}"] = v
        else:
            local[k] = v
    net.load_state_dict(local, strict=True)
    with torch.no_grad():
        out = net.eval()(torch.as_tensor(image), is_train=False)
    mesh.clear()
    return {"logits": out["logits"].numpy(), "index": out["index"].numpy(),
            "block": list(block)}


SCENARIOS = (layout, batchnorm, svtr_mrn, svtr_mrn_expert, svtr_mrn_drifting, trba, crnn_base,
             ewc_fisher, mrn_forward)


def main(out_dir):
    torch.set_num_threads(1)
    rank, world = multihost.initialize(device="cpu")
    results = {}
    for scenario in SCENARIOS:
        results[scenario.__name__] = scenario(out_dir)
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
