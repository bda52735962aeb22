"""The port of ``mrn_tpu/train/learners/base.py``: the base strategy
(sequential fine-tuning) and the lifecycle every learner shares: the
converter, the mixed-precision policy, the train-mode forward, batch
encoding with the device image bank, the optimizer, the loop with its
validation points, best checkpoints, ``test``, the rehearsal-memory draw
and full-state snapshots.

The base strategy, task by task (``incremental_train``): task 0 draws a
Recognizer from ``weight_rng`` in the JAX init distributions and gives it
the reference init pass (``build_model``, the same draws as MRN's task-0
expert); a later task draws a fresh Recognizer, carries the extractor
(params and BatchNorm statistics) over whole and grows the fc
(``change_model``, ``models.surgery.grow_fc``); the optimizer starts
afresh.  Task 0 trains on its stream (``_init_train``); a later task first
draws the rehearsal memory when ``opt.memory`` is set (two half-batch
loaders, ``data.manager``) and trains (``_update_representation``).
``after_task`` keeps the reloaded best network as the old network (eval
mode, frozen, its parameters cast once under the bf16 policy) and sets
``_known_classes``.  ``train_aux()`` gives the loss its task-level
constants (LwF's old network, EWC's Fisher), read at the start of every
loop.  ``opt.start_task`` replays a task below it: its stream is built as
training would build it (so the generators advance alike), its best
checkpoint is loaded and ``_after_resume`` rebuilds what the skipped
training would have left (EWC's Fisher).

The loop (``_run_loop``) validates at iteration 1, every ``val_interval``
and at the last iteration, writing a best checkpoint whenever the score
improves (``best_score`` starts over in every loop).  Step losses stay on
the device, at most 64 in flight; at a validation point they are read
back in one copy into the ``Averager`` and into ``history`` (one record a
step: its metrics, and ``seconds``, the mean step time of its ``StepMeter``
window: the host clock from the window's first batch to the end of its
last step on the device, validation left out).  Batches come through a
``data.prefetch.Prefetcher`` (``opt.prefetch``, on by default) that draws
exactly the loop's batches on a thread; encoding and the copy to the
device stay on the main thread.

Generators: ``np_rng`` (seeded ``manual_seed``) draws only the rehearsal
memory, as the JAX learner's does; ``weight_rng`` (a stream of its own from
the same seed) draws new experts and routers; ``generator`` (torch, on the
learner's device) draws every DropPath keep mask.

Full-state snapshots (``opt.full_ckpt``): at every validation point before
the last, ``{lan}_{taski}[_{step}]_train_state.msgpack`` holds the live
params and statistics (flax layout), the Adam state in optax's layout
(``train.optim.adam_state_to_optax``), the iteration, the DropPath
generator's state (where JAX keeps its PRNG key) and the host state (the
numpy generators, the memory indices, the best score and the manager's
generator as it was when the stream was built).  With ``opt.resume_full``
a loop that finds its snapshot restores it, rebuilds the stream from the
manager's generator at build and skips the consumed batches; a completed
stage removes its snapshot.

Evaluation runs float32 weights (the masters, as the JAX eval step does)
in eval mode: ``eval_batch`` gives the greedy ``preds_index``, the
``max_probs`` of the float32 softmax and the CTC ``loss_sum`` /
``loss_count`` (per sample over ``max(length, 1)``, non-finite values
zeroed, padded rows of length 0 left out).

Mixed precision (``opt.train_dtype == "bf16"``, the JAX ``--bf16`` policy):
every float parameter and the image are cast to bfloat16 for the forward
and backward (``torch.func.functional_call`` over cast copies, so
LayerNorm and the rest run in bfloat16 exactly as in JAX, which
``torch.autocast`` would not); master parameters, Adam moments, BatchNorm
running statistics and the losses stay float32.

Runs on the CUDA card unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

import functools
import os
import time
from typing import Callable, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from mrn_tpu_torch import resolve_device
from mrn_tpu_torch.bridge import from_flax, to_flax
from mrn_tpu_torch.codec import CTCLabelConverter
from mrn_tpu_torch.data.prefetch import Prefetcher
from mrn_tpu_torch.models.composer import build_recognizer
from mrn_tpu_torch.models.init import random_recognizer
from mrn_tpu_torch.models.surgery import apply_reference_init, grow_fc
from mrn_tpu_torch.models.svtr import set_droppath_generator
from mrn_tpu_torch.ops.ctc import ctc_loss_per_sample
from mrn_tpu_torch.train.checkpoint import (best_model_path, load_model, load_train_state,
                                            save_model, save_train_state, train_state_path)
from mrn_tpu_torch.train.evaluate import ValidationResult, validation
from mrn_tpu_torch.train.optim import (build_optimizer, build_schedule, opt_state_from_optax,
                                       opt_state_to_optax)
from mrn_tpu_torch.train.steps import TrainState, make_train_step, recognition_loss
from mrn_tpu_torch.utils import Averager, ExperimentLog, StepMeter

__all__ = ["BaseLearner"]

MAX_IN_FLIGHT = 64  # step losses left on the device before the oldest is read


class BaseLearner:
    def __init__(self, opt, device: Optional[Union[str, torch.device]] = None):
        if opt.Prediction != "CTC":
            raise NotImplementedError(f"Prediction {opt.Prediction!r}: the port trains CTC "
                                      "heads only so far; the Attn branches (teacher "
                                      "forcing, LwF's start index 1) are ROADMAP.md §1 "
                                      "item 7")
        self.opt = opt
        self.device = resolve_device(device)
        self.np_rng = np.random.default_rng(opt.manual_seed)
        self.weight_rng = np.random.default_rng(
            np.random.SeedSequence(opt.manual_seed, spawn_key=(1,)))
        # draws every DropPath keep mask of the models this learner builds
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(opt.manual_seed)
        self._cur_task = -1
        self._known_classes = 0
        self._total_classes = 0
        self.character = None
        self.converter = None
        self.model: Optional[nn.Module] = None
        self._old_model: Optional[nn.Module] = None   # LwF's and WA's old network
        self.state: Optional[TrainState] = None
        self._train_step = None
        self._bank = None       # (host bank, its copy on the device)
        self.memory_index: List[np.ndarray] = []
        self.history: List[Dict] = []
        self.best_score = -1.0
        self.log = ExperimentLog(opt.exp_name, opt.get("output_dir", "./saved_models"),
                                 opt.get("data_log", "./data_any.txt"))

    # ------------------------------------------------------------ setup
    def build_converter(self) -> CTCLabelConverter:
        converter = CTCLabelConverter(self.character)
        self._total_classes = converter.num_classes
        return converter

    def _build_net(self) -> nn.Module:
        """The strategy's network at the current class count (unloaded)."""
        return build_recognizer(self.opt, self._total_classes)

    def _set_model(self, params: Mapping, stats: Mapping) -> None:
        """The network of ``params`` / ``stats`` (flax trees) as the live
        model, its DropPath drawn from ``generator``."""
        model = self._build_net()
        model.load_state_dict(from_flax(params, stats), strict=True)
        self.model = model.to(self.device)
        set_droppath_generator(self.model, self.generator)

    def build_model(self) -> None:
        """Task 0: drawn in the JAX init distributions from ``weight_rng``,
        then the reference init pass."""
        params, stats = random_recognizer(self.weight_rng, self.opt, self._total_classes)
        self._set_model(apply_reference_init(params, self.weight_rng), stats)

    def change_model(self) -> None:
        """Task > 0: a fresh Recognizer carrying the old extractor (params
        and statistics) whole, its fc grown over the old one."""
        old_params, old_stats = to_flax(self.model)
        params, _ = random_recognizer(self.weight_rng, self.opt, self._total_classes)
        params["extractor"] = old_params["extractor"]
        self._set_model(grow_fc(params, old_params), old_stats)

    def trainable_params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    def build_optimizer(self, scale: float = 1.0, the: int = 1) -> None:
        params = self.trainable_params()
        schedule = build_schedule(self.opt, scale=scale, the=the)
        self.state = TrainState(params, build_optimizer(self.opt, schedule,
                                                        list(params.values())))
        self._train_step = None

    # ------------------------------------------------------- loss/steps
    def _mp_dtype(self) -> Optional[torch.dtype]:
        return torch.bfloat16 if self.opt.get("train_dtype") == "bf16" else None

    def _mp_cast(self, tree: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """bf16 copies of the float tensors (differentiable casts), or the
        tensors themselves without the policy."""
        dt = self._mp_dtype()
        if dt is None:
            return dict(tree)
        return {k: v.to(dt) if v.is_floating_point() else v for k, v in tree.items()}

    def _apply(self, module: nn.Module, params, image, **kwargs):
        """``module(image, **kwargs)`` with ``params`` (cast under the bf16
        policy) in place of the module's own; buffers are the module's."""
        image = image.to(self._mp_dtype() or image.dtype)
        return functional_call(module, self._mp_cast(params), (image,), kwargs)

    def _apply_train(self, params, batch) -> torch.Tensor:
        """Train-mode predictions, float32."""
        return self._apply(self.model, params, batch["image"], train=True)["predict"].float()

    def _frozen_copy(self, module: nn.Module) -> nn.Module:
        """``module`` in eval mode without gradients, its parameters cast
        to bfloat16 under the bf16 policy (its statistics stay float32):
        the JAX step casts a frozen network's params every step to the same
        values."""
        module = module.eval().requires_grad_(False)
        dt = self._mp_dtype()
        if dt is not None:
            for p in module.parameters():
                p.data = p.data.to(dt)
        return module

    def _eval_forward(self, module: nn.Module, image: torch.Tensor):
        """A frozen network's eval-mode forward on the (cast) image."""
        with torch.no_grad():
            return module(image.to(self._mp_dtype() or image.dtype), train=False)

    def train_aux(self):
        """Task-level constants of the loss (None for the base strategy)."""
        return None

    def loss_fn(self, params, batch, aux=None):
        return recognition_loss(self._apply_train(params, batch), batch), {}

    def grad_transform(self) -> Optional[Callable]:
        return None

    def get_train_step(self):
        if self._train_step is None:
            aux = self.train_aux()
            self._train_step = make_train_step(
                lambda params, batch: self.loss_fn(params, batch, aux), self.grad_transform())
        return self._train_step

    # ------------------------------------------------------------ batches
    def _bank_on_device(self) -> torch.Tensor:
        """``opt.image_bank`` [N, H, W, C] uint8 on the device: a tensor
        there already, a ``DeviceImageBank``'s device copy (dropped by its
        ``add``), or a numpy array copied once (again if its length
        changes)."""
        bank = self.opt.get("image_bank")
        if bank is None:
            raise ValueError("bank-index batch but opt.image_bank is unset")
        if isinstance(bank, torch.Tensor):
            return bank.to(self.device)
        if hasattr(bank, "as_device_array"):
            return bank.as_device_array(self.device)
        if self._bank is None or self._bank[0] is not bank or len(self._bank[1]) != len(bank):
            self._bank = (bank, torch.as_tensor(np.asarray(bank, np.uint8),
                                                device=self.device))
        return self._bank[1]

    def _device_images(self, images) -> torch.Tensor:
        """Float images move to the device as they are; uint8 crops move and
        are normalised ``(x / 255 - 0.5) / 0.5`` there; other integer
        batches are indices into the uint8 image bank ``opt.image_bank``,
        gathered and normalised on the device."""
        images = np.asarray(images)
        if images.dtype == np.uint8:
            x = torch.as_tensor(images, device=self.device)
            return (x.float() / 255.0 - 0.5) / 0.5
        if not np.issubdtype(images.dtype, np.integer):
            return torch.as_tensor(images, dtype=torch.float32, device=self.device)
        index = torch.as_tensor(images.astype(np.int64), device=self.device)
        img = self._bank_on_device().index_select(0, index)
        return (img.float() / 255.0 - 0.5) / 0.5

    def _encode_batch(self, images, labels) -> Dict[str, torch.Tensor]:
        index, lengths = self.converter.encode(
            labels, batch_max_length=self.opt.batch_max_length)
        return {"image": self._device_images(images),
                "label": torch.as_tensor(index, device=self.device),
                "length": torch.as_tensor(lengths, device=self.device)}

    def train_step(self, fetched) -> Dict[str, torch.Tensor]:
        """One step on a loader batch ``(images, labels[, dataset_idx])``."""
        batch = self._encode_batch(fetched[0], fetched[1])
        if len(fetched) > 2:
            batch["dataset_idx"] = torch.as_tensor(np.asarray(fetched[2]),
                                                   device=self.device)
        return self.get_train_step()(self.state, batch)

    # --------------------------------------------------------------- loop
    def _flush(self, records: List[Dict], train_loss_avg: Averager) -> None:
        """Reads the device values of ``records`` back in one copy, writes
        them into the records and adds each step's logged loss
        (``log_loss``, else ``loss``) to ``train_loss_avg``."""
        slots = [(r, k) for r in records for k, v in r.items() if isinstance(v, torch.Tensor)]
        if slots:
            values = torch.stack([r[k].detach().float().reshape(()) for r, k in slots])
            for (r, k), v in zip(slots, values.cpu().tolist()):
                r[k] = v
        for r in records:
            train_loss_avg.add(r.get("log_loss", r["loss"]))

    def _run_loop(self, taski: int, train_loader, valid_loader, num_iter: Optional[int] = None,
                  get_batch: Optional[Callable] = None, step: Optional[int] = None,
                  val_interval: Optional[int] = None,
                  val_hook: Optional[Callable] = None) -> None:
        """``num_iter`` iterations on ``get_batch`` (default
        ``train_loader.get_batch``), validated on ``valid_loader`` at
        iteration 1, every ``val_interval`` and the last iteration (by
        ``val_hook(valid_loader, iteration, train_loss_avg, start_time)``
        when given); under ``opt.resume_full`` a snapshot of this phase
        restarts the loop after its iteration."""
        num_iter = int(num_iter or self.opt.num_iter)
        val_interval = int(val_interval or self.opt.val_interval)
        get_batch = get_batch or train_loader.get_batch
        train_loss_avg = Averager()
        start_time = time.time()
        self.best_score = -1.0
        start_iter = self._maybe_resume_full(taski, step, train_loader)
        self._train_step = None   # train_aux is read afresh for every loop
        prefetcher = None
        if self.opt.get("prefetch", True):
            prefetcher = get_batch = Prefetcher(get_batch, num_iter - start_iter, depth=2)
        meter = StepMeter()
        pending: List[Dict] = []   # records whose losses are still on the device
        window: List[Dict] = []    # records of the meter's window
        try:
            for iteration in range(start_iter + 1, num_iter + 1):
                fetched = get_batch()
                record = dict(self.train_step(fetched), task=taski, step=step,
                              iteration=iteration)
                self.history.append(record)
                pending.append(record)
                window.append(record)
                if len(pending) > MAX_IN_FLIGHT:
                    self._flush([pending.pop(0)], train_loss_avg)
                meter.tick(len(fetched[1]))

                if iteration % val_interval == 0 or iteration == 1 or iteration == num_iter:
                    self._flush(pending, train_loss_avg)
                    pending = []
                    if self.device.type == "cuda":   # the window ends on the device
                        torch.cuda.synchronize(self.device)
                    seconds = meter.seconds()
                    for r in window:
                        r["seconds"] = seconds / len(window)
                    self.log.write(f"[{iteration}/{num_iter}] {meter.report(seconds)}\n")
                    if val_hook is not None:
                        val_hook(valid_loader, iteration, train_loss_avg, start_time)
                    else:
                        self.val(valid_loader, self.opt, self.best_score, start_time,
                                 iteration, train_loss_avg, taski, step=step)
                    train_loss_avg.reset()
                    window = []
                    if self.opt.get("full_ckpt") and iteration < num_iter:
                        self._save_full_state(taski, step, iteration, train_loader)
                    meter.reset()
        finally:
            if prefetcher is not None:
                prefetcher.close()
        if self.opt.get("full_ckpt"):
            # a completed stage drops its rolling snapshot, so a later resume
            # cannot rewind into it
            path = self._train_state_path(taski, step)
            if os.path.exists(path):
                os.remove(path)

    # ------------------------------------------------ full-state snapshots
    def _train_state_path(self, taski: int, step: Optional[int]) -> str:
        return train_state_path(self.opt.get("output_dir", "./saved_models"),
                                self.opt.exp_name, self.opt.lan_list[taski], taski, step)

    def _snapshot_trees(self) -> Tuple[Dict, Dict]:
        """The live (params, batch_stats) a snapshot keeps: the model's."""
        return to_flax(self.model)

    def _restore_trees(self, params: Mapping, batch_stats: Mapping) -> None:
        """Loads a snapshot's trees in place (the optimizer holds the
        parameter tensors)."""
        self.model.load_state_dict(from_flax(params, batch_stats), strict=True)

    def _frozen_moments(self) -> Dict[str, torch.Tensor]:
        """Parameters outside the optimizer whose (zero) moments a snapshot
        writes all the same, as optax keeps them (DER's frozen
        extractors)."""
        return {}

    def _host_state(self, train_loader=None) -> Dict:
        host = {"np_rng": self.np_rng.bit_generator.state,
                "weight_rng": self.weight_rng.bit_generator.state,
                "memory_index": [np.asarray(ix) for ix in self.memory_index],
                "best_score": self.best_score}
        if train_loader is not None and hasattr(train_loader, "rng_state_at_build"):
            host["manager_rng_at_build"] = train_loader.rng_state_at_build
        return host

    def _restore_host_state(self, host: Mapping) -> None:
        self.np_rng.bit_generator.state = host["np_rng"]
        if "weight_rng" in host:
            self.weight_rng.bit_generator.state = host["weight_rng"]
        self.memory_index = [np.asarray(ix) for ix in host["memory_index"]]
        self.best_score = float(host["best_score"])

    def _rebuild_stream(self, train_loader, taski: int, step: Optional[int]) -> None:
        """Re-runs the stream build that preceded the interrupted loop."""
        if taski == 0 or self.opt.memory is None:
            train_loader.get_dataset(taski, memory=None if taski == 0 else self.opt.memory)
        else:
            train_loader.get_dataset(taski, memory=self.opt.memory,
                                     index_list=self.memory_index)

    def _restore_stream(self, train_loader, host: Mapping, taski: int,
                        step: Optional[int], iteration: int) -> None:
        """Rewinds the manager's generator to its state at build, rebuilds
        the loaders (their construction shuffles replay) and skips the
        ``iteration`` consumed batches."""
        if train_loader is None or not hasattr(train_loader, "skip_batches"):
            return
        if "manager_rng_at_build" in host and hasattr(train_loader, "rng"):
            train_loader.rng.bit_generator.state = host["manager_rng_at_build"]
            self._rebuild_stream(train_loader, taski, step)
        train_loader.skip_batches(iteration)

    def _save_full_state(self, taski: int, step: Optional[int], iteration: int,
                         train_loader=None) -> None:
        params, stats = self._snapshot_trees()
        save_train_state(self._train_state_path(taski, step), params=params,
                         batch_stats=stats,
                         opt_state=opt_state_to_optax(self.state.opt, list(self.state.params),
                                                      self._frozen_moments()),
                         iteration=iteration,
                         rng_key=self.generator.get_state().numpy(),
                         host_state=self._host_state(train_loader))

    def _maybe_resume_full(self, taski: int, step: Optional[int], train_loader) -> int:
        """Restores this (task, step)'s snapshot under ``opt.resume_full``
        and fast-forwards the stream; returns the iteration to go on from
        (0 without a snapshot)."""
        if not self.opt.get("resume_full"):
            return 0
        path = self._train_state_path(taski, step)
        if not os.path.exists(path):
            return 0
        payload = load_train_state(path)
        self._restore_trees(payload["params"], payload["batch_stats"])
        opt_state_from_optax(self.state.opt, list(self.state.params), payload["opt_state"],
                             frozen=list(self._frozen_moments()))
        self.generator.set_state(torch.as_tensor(np.asarray(payload["rng_key"], np.uint8)))
        self._restore_host_state(payload["host_state"])
        iteration = payload["iteration"]
        self.state.step = iteration
        self._restore_stream(train_loader, payload["host_state"], taski, step, iteration)
        self.log.write(f"Task {taski} resume from {path} @ iter {iteration}.\n")
        return iteration

    # ------------------------------------------------------------ train
    def incremental_train(self, taski: int, character, train_loader, valid_loader) -> None:
        """Task ``taski`` whose cumulative character list is ``character``,
        validated on ``valid_loader``'s current set; below
        ``opt.start_task`` the task is replayed from its best checkpoint."""
        self._cur_task = taski
        self.character = list(character)
        self.converter = self.build_converter()
        valid = valid_loader.create_dataset()
        if taski > 0:
            self.change_model()
        else:
            self.build_model()
        self.count_param()
        self.build_optimizer()
        if float(self.opt.get("start_task", 0)) > taski:
            if taski > 0:
                self._build_stream(train_loader, taski)
            self._load_best(taski)
            self._after_resume(taski, train_loader)
        else:
            self.log.write(f"Task {taski} start training ------{self.opt.exp_name}------\n")
            self._train(taski, train_loader, valid)

    def _train(self, taski: int, train_loader, valid_loader) -> None:
        if taski == 0:
            self._init_train(taski, train_loader, valid_loader)
        else:
            self._build_stream(train_loader, taski)
            self._update_representation(taski, train_loader, valid_loader)

    def _init_train(self, taski: int, train_loader, valid_loader) -> None:
        self._run_loop(taski, train_loader, valid_loader)

    def _update_representation(self, taski: int, train_loader, valid_loader) -> None:
        self._init_train(taski, train_loader, valid_loader)

    def _after_resume(self, taski: int, train_loader) -> None:
        """After a ``start_task`` replay: the state the skipped training
        would have left (none for the base strategy)."""

    def after_task(self) -> None:
        """The reloaded best network becomes the old network."""
        old = self._build_net()
        old.load_state_dict(self.model.state_dict(), strict=True)
        self._old_model = self._frozen_copy(old.to(self.device))
        self._known_classes = self._total_classes

    # ------------------------------------------------------ rehearsal
    def build_rehearsal_memory(self, train_loader, taski: int) -> None:
        memory_num = self.opt.memory_num
        num_i = int(memory_num / taski)
        self.build_random_current_memory(num_i, taski, train_loader)
        if self.memory_index and len(self.memory_index) * len(self.memory_index[0]) > memory_num:
            self.reduce_samplers(taski, taski_num=num_i)
        train_loader.get_dataset(taski, memory=self.opt.memory, index_list=self.memory_index)

    def build_random_current_memory(self, taski_num: int, taski: int, train_loader) -> None:
        """Draws ``taski_num`` samples of task ``taski - 1`` from ``np_rng``."""
        _, len_data = train_loader.rehearsal_prev_model(taski)
        self.memory_index.append(self.np_rng.choice(range(len_data), taski_num,
                                                    replace=False))

    def reduce_samplers(self, taski: int, taski_num: int) -> None:
        for i in range(taski):
            self.memory_index[i] = self.memory_index[i][:taski_num]

    def _build_stream(self, train_loader, taski: int) -> None:
        """The stream of a task's rehearsal step: the memory when the
        learner keeps one and the loader has rehearsal, else the current
        task alone."""
        if self.opt.memory is not None and getattr(train_loader, "rehearsal", True):
            self.build_rehearsal_memory(train_loader, taski)
        else:
            train_loader.get_dataset(taski, memory=self.opt.memory)

    # --------------------------------------------------------------- eval
    def _eval_logits(self, images: torch.Tensor, val_choose: str) -> torch.Tensor:
        """The eval-mode model's logits [B, T, C]: its ``predict`` (a
        Recognizer) or ``logits`` (DERNet)."""
        out = self.model(images, train=False)
        return out["predict"] if "predict" in out else out["logits"]

    @torch.no_grad()
    def eval_batch(self, images, labels_index, lengths,
                   val_choose: str = "val") -> Dict[str, np.ndarray]:
        """``make_eval_batch``'s outputs for one padded batch, on the host:
        ``preds_index`` [B, T] int32, ``max_probs`` [B, T], ``loss_sum``
        and ``loss_count``."""
        logits = self._eval_logits(self._device_images(images), val_choose).float()
        lengths = torch.as_tensor(np.asarray(lengths), device=self.device)
        per = ctc_loss_per_sample(logits, torch.as_tensor(np.asarray(labels_index),
                                                          device=self.device), lengths)
        per = per / lengths.clamp(min=1)
        valid = lengths > 0
        out = {"preds_index": logits.argmax(dim=2).to(torch.int32),
               "max_probs": torch.softmax(logits, dim=2).amax(dim=2),
               "loss_sum": torch.where(valid & torch.isfinite(per), per,
                                       torch.zeros_like(per)).sum(),
               "loss_count": valid.sum()}
        return {k: v.cpu().numpy() for k, v in out.items()}

    def run_validation(self, valid_loader, val_choose: str = "val") -> ValidationResult:
        return validation(functools.partial(self.eval_batch, val_choose=val_choose),
                          valid_loader, self.converter, self.opt,
                          is_attn=self.opt.Prediction == "Attn")

    def val(self, valid_loader, opt, best_score, start_time, iteration,
            train_loss_avg, taski, step=None, val_choose="val") -> ValidationResult:
        """Validates, saves a best checkpoint on a better score and logs the
        JAX package's lines."""
        res = self.run_validation(valid_loader, val_choose)
        if res.score > self.best_score:
            self.best_score = res.score
            self._save_best(taski, step=step)
        elapsed = time.time() - start_time
        line = (f"\n[{iteration}/{opt.num_iter}] Train_loss: {train_loss_avg.val():0.5f}, "
                f"Valid_loss: {res.loss:0.5f}\n"
                f"Current_score: {res.score:0.2f}, Ned_score: {res.ned or 0:0.2f}\n"
                f"Best_score: {self.best_score:0.2f}\n"
                f"Infer_time: {res.infer_time:0.2f}, Elapsed_time: {elapsed:0.2f}\n")
        for gt, pred, conf in zip(res.labels[:5], res.preds[:5], res.confidences[:5]):
            line += f"{gt:25s} | {pred:25s} | {conf:0.4f}\t{pred == gt}\n"
        self.log.write(line)
        return res

    # ------------------------------------------------------ checkpoints
    def _best_path(self, taski: int, step: Optional[int] = None) -> str:
        return best_model_path(self.opt.get("output_dir", "./saved_models"),
                               self.opt.exp_name, self.opt.lan_list[taski], taski, step)

    def _ckpt_step_tag(self) -> Optional[int]:
        return None

    def _save_best(self, taski: int, step: Optional[int] = None) -> None:
        save_model(self._best_path(taski, step), *to_flax(self.model))

    def _load_best(self, taski: int, step: Optional[int] = None) -> None:
        path = self._best_path(taski, step)
        params, stats = to_flax(self.model)
        payload = load_model(path, {"params": params, "batch_stats": stats})
        self.model.load_state_dict(from_flax(payload["params"], payload["batch_stats"]),
                                   strict=True)
        self.log.write(f"Task {taski} load checkpoint from {path}.\n")

    # ------------------------------------------------------------- test
    def test(self, valid_datas, best_scores, ned_scores, taski,
             val_dataset_builder=None, val_choose="test"):
        """Reloads the best checkpoint and scores every seen task; MLT17/19
        interleaved split averaging (``mrn_tpu/train/learners/base.py``)."""
        self._load_best(taski, step=self._ckpt_step_tag())
        task_accs, ned_accs = [], []
        for val_data in valid_datas:
            res = self.run_validation(val_dataset_builder(val_data), val_choose)
            task_accs.append(round(res.score, 2))
            ned_accs.append(round(res.ned if res.ned is not None else 0.0, 2))

        self.log.write_data_log(f"----------- {self.opt.exp_name} Task {taski}------------\n")
        if (taski + 1) * 2 == len(task_accs):
            score17, score19 = self.double_write(taski, task_accs)
            best_scores.append(score17)
            ned_scores.append(score19)
            self.log.write(f"Task {taski} Avg Incremental Acc: 17: {score17} 19: {score19}\n")
        else:
            best_scores.append(round(sum(task_accs) / len(task_accs), 2))
            ned_scores.append(round(sum(ned_accs) / len(ned_accs), 2))
            self.log.write(f"Task {taski} Test AIA: {best_scores[-1]}\n"
                           f"Task {taski} accs: {task_accs}\nned: {ned_accs}\n")
            self.log.write_data_log(
                f"{taski} Avg Acc: {best_scores[-1]:0.2f} \n  acc: {task_accs}\n")
        return best_scores, ned_scores

    def double_write(self, taski, accs):
        """Interleaved MLT17/MLT19 averaging."""
        list17 = [accs[i * 2] for i in range(taski + 1)]
        list19 = [accs[i * 2 + 1] for i in range(taski + 1)]
        score17 = round(sum(list17) / len(list17), 2)
        score19 = round(sum(list19) / len(list19), 2)
        self.log.write_data_log(
            f"Task{taski} : 2017: {score17:0.2f} 2019: {score19:0.2f}\n"
            f"17 acc: {list17}\n19 acc: {list19}\n")
        return score17, score19

    def count_param(self) -> int:
        n = sum(p.numel() for p in self.model.parameters())
        self.log.write(f"Total parameters: {n / 1e6:0.2f} M\n")
        return n
