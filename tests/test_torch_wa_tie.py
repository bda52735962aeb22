"""WA's best-file choice under a tie, the port against the JAX package's
learner, float32 on the CPU at smoke size.

Both learners run task 1's loop (``_update_representation``: 4 iterations,
validated at 1, 2 and 4), ``test`` and ``after_task`` through their own
code, with two things replaced alike on both sides: each step moves the fc
by the same fixed amount (the iterates are then bitwise equal across the
frameworks), and the validation returns scripted scores, the last two tied
(3.0, 5.64, 5.64, the TRBA campaign's Latin floor).  Under the strict
``>`` both keep iteration 2's file; ``test`` reloads it, and ``after_task``
keeps the aligned reloaded network as the old one (the port's
``_old_model``, JAX's ``_old_params``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrn_tpu.config import load_config as jax_load_config
from mrn_tpu.train.learners.wa import WA as JaxWA
from mrn_tpu.train.steps import TrainState as JaxTrainState
from mrn_tpu_torch.bridge import to_flax
from mrn_tpu_torch.config import load_config
from mrn_tpu_torch.train.evaluate import ValidationResult
from mrn_tpu_torch.train.learners.wa import WA

SVTR = dict(embed_dim=(16, 32, 64), depth=(1, 2, 1), num_heads=(2, 2, 4),
            drop_path_rate=0.0)
CHARS = ["abcdefghij", "abcdefghijklmnop"]
SCORES = (3.0, 5.64, 5.64)          # at iterations 1, 2 and 4
STEP = 0.01                          # each iteration adds STEP * DELTA to the fc kernel


class Loader:
    def get_batch(self):
        return np.zeros((4, 32, 128, 4), np.float32), ["ab", "cd", "ef", "kl"]


def _scripted(scores):
    left = list(scores)

    def run_validation(loader, val_choose="val"):
        score = left.pop(0) if left else 0.0
        return ValidationResult(0.0, score, 0.0, [], [], [], 0.0, 1)
    return run_validation


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("wa_tie")
    common = dict(il="wa", imgW=128, output_channel=32, hidden_size=16, batch_size=4,
                  num_iter=4, val_interval=2, manual_seed=3, prefetch=False)
    topt = load_config("configs/svtr_mrn.py", svtr=SVTR, output_dir=str(tmp / "port"),
                       data_log=str(tmp / "port.txt"), **common)
    jopt = jax_load_config("configs/svtr_mrn.py", output_dir=str(tmp / "jax"),
                           data_log=str(tmp / "jax.txt"), **common)
    # the port's learner at task 1: task 0's network kept as the old one, grown
    tl = WA(topt, device="cpu")
    tl._cur_task, tl.character = 0, list(CHARS[0])
    tl.converter = tl.build_converter()
    tl.build_model()
    tl.after_task()
    tl._cur_task, tl.character = 1, list(CHARS[1])
    tl.converter = tl.build_converter()
    tl.change_model()
    tl.build_optimizer()
    start = to_flax(tl.model)
    delta = np.random.default_rng(0).standard_normal(
        start[0]["fc"]["kernel"].shape).astype(np.float32)
    jl = JaxWA(jopt)
    jl._cur_task, jl.character = 1, list(CHARS[1])
    jl.converter = jl.build_converter()
    jl._known_classes = tl._known_classes
    jl.params, jl.batch_stats = start
    jl._old_params, jl._old_batch_stats = to_flax(tl._old_model)
    jl.build_optimizer()

    def port_step(fetched):
        with torch.no_grad():
            tl.model.fc.kernel.add_(STEP * torch.from_numpy(delta))
        return {"loss": torch.zeros(())}

    def jax_step(state, batch, rng, aux):
        params = dict(state.params, fc=dict(state.params["fc"], kernel=state.params["fc"][
            "kernel"] + STEP * jnp.asarray(delta)))
        return JaxTrainState(params, state.batch_stats, state.opt_state, state.step + 1), \
            {"loss": jnp.zeros(())}

    tl.train_step = port_step
    tl.run_validation = _scripted(SCORES)
    jl.get_train_step = lambda: jax_step
    jl.run_validation = _scripted(SCORES)
    iterates = {}
    kernel = np.asarray(start[0]["fc"]["kernel"], np.float32)
    for i in range(1, 5):
        kernel = kernel + np.float32(STEP) * delta
        iterates[i] = kernel
    tl._update_representation(1, Loader(), None)
    jl._update_representation(0, 1, Loader(), None)
    live = (tl.model.fc.kernel.detach().numpy().copy(), np.asarray(jl.params["fc"]["kernel"]))
    tl.test(["set"], [], [], 1, val_dataset_builder=lambda name: None)
    jl.test(["set"], [], [], 1, val_dataset_builder=lambda name: None)
    reloaded = (tl.model.fc.kernel.detach().numpy().copy(), np.asarray(jl.params["fc"]["kernel"]))
    tl.after_task()
    jl.after_task()
    kept = (tl._old_model.fc.kernel.detach().float().numpy(),
            np.asarray(jl._old_params["fc"]["kernel"]))
    return dict(iterates=iterates, live=live, reloaded=reloaded, kept=kept,
                best=(tl.best_score, jl.best_score))


def test_both_keep_the_first_of_the_tied_files(runs):
    assert runs["best"] == (5.64, 5.64)
    port, jax = runs["reloaded"]
    np.testing.assert_array_equal(port, runs["iterates"][2])
    np.testing.assert_array_equal(jax, runs["iterates"][2])
    # the loop's last iterate was aligned in place, then overwritten by the reload
    assert not np.array_equal(port, runs["live"][0])


def test_after_task_keeps_the_same_aligned_network(runs):
    port, jax = runs["kept"]
    np.testing.assert_allclose(port, jax, rtol=1e-6, atol=1e-7)
    assert not np.allclose(port, runs["reloaded"][0])   # the align moved the new columns
