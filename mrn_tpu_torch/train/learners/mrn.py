"""MRN learner, the two training phases of a task with their validation
and best checkpoints (mirrors ``mrn_tpu/train/learners/mrn.py``):

- step 0: the NEW expert trains alone (train mode: DropPath, BatchNorm on
  batch statistics; CTC, or for TRBA the train-mode TPS warp and the
  teacher-forced decoder's cross entropy) on the current task's stream
  (``train_loader.get_dataset(taski, memory=None)``), validated "FF" (the
  standalone expert) on the current task's set; then (task > 0) it is
  frozen into the expert list.  Task 0's expert gets the reference init
  pass (``models.surgery.apply_reference_init``); later experts keep their
  construction init;
- step 1 (task > 0): the rehearsal memory is drawn
  (``build_rehearsal_memory``: ``memory_num / taski`` samples of the last
  task, earlier tasks' memories cut to the same size, or full-size
  memories when ``memory_num >= 5000``), then a fresh router stack trains
  over all experts stacked and frozen, for ``num_iter // 2`` updates on the
  rehearsal stream whose batches carry each sample's ``dataset_idx`` (memory
  0 / current 1, or the task id under ``router_labels="task"``), with loss
  ``15 * CLF + CE(index, dataset_idx)`` (CLF the recognition loss: CTC,
  or Attn's cross entropy with every expert decoding teacher-forced on
  ``label[:, :-1]``) and OneCycle over ``2 * num_iter``,
  validated "TF" (the hard expert pick) on every seen task's set every
  ``max(1, val_interval // 5)`` iterations.  The experts run without
  gradients and, by default, in eval mode, so their BatchNorm statistics
  stay pinned (``mrn_pin_expert_stats=True``).  With
  ``mrn_pin_expert_stats=False`` (the reference's drifting mode, as JAX
  runs it) the router step runs the experts with ``train=True``: BatchNorm
  on batch statistics, its running statistics drifting toward the
  rehearsal stream (the TF validation reads them), SVTR DropPath from
  ``generator``; after the router phase the drifted statistics are written
  back into the frozen experts and their blob hashes invalidated, so the
  next best save writes new blobs.  A router-phase snapshot then carries
  the drifted statistics and a resume restores them.  The best files of
  the router phase keep the statistics the phase started from (the JAX
  learner's ``expert_stats``), and a payload's stats supersede its blobs'
  on load.

``opt.start_task`` replays what a crashed run finished: a phase below it
(task ``i`` step 0 below ``i``, step 1 below ``i + 0.5``) builds its
stream as training would (so the generators advance alike) and loads its
best checkpoint instead of training.  A router-phase snapshot keeps the
router, its Adam state and the host state (and, drifting, the experts'
statistics), not the frozen experts, which the replay rebuilds.

Validation runs float32 experts: under the bf16 policy the training
ensemble holds bfloat16 expert copies, so "TF" runs a float32 ensemble
built once per router phase whose router modules are the training ones.

Checkpoints are the JAX package's files: a frozen expert is written once
as a content-addressed blob ``experts/{sha1[:16]}.msgpack`` (its hash taken
over its flax-layout trees, so the name equals the JAX learner's for the
same expert); a best checkpoint holds the live params (the standalone
expert at step 0, the router only at step 1), ``expert_refs``, every
expert's ``expert_stats`` and the ``router``.  ``test`` reloads the best
checkpoint (FF at task 0, TF later) and ``after_task`` freezes the
reloaded task-0 expert.

``train_loader`` is a ``data.manager.DatasetManager`` (or an object with
its ``get_dataset``, ``rehearsal_prev_model``, ``get_batch`` and
``get_batch2``); images may be indices into ``opt.image_bank``.
``valid_loader`` is a ``data.manager.ValDataset``.

Under an expert mesh (``parallel.mesh.set_expert_parallel``) the routed
ensembles hold only this rank's block of experts (``mesh.shard_experts``,
all of them when the count does not divide), as JAX's
``_routed_variables`` shards the stacked experts; the learner keeps every
frozen expert's state all the same, for its files.  The router's gradient
is averaged over the whole world: each data shard appears on ``E`` ranks
alike.  The drifting statistics of the whole stack are gathered over the
``expert`` group when they are written back or snapshotted.
"""

from __future__ import annotations

import hashlib
import os
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch

from mrn_tpu_torch.bridge import (flax_tree, recognizer_state, routed_state, state_to_flax,
                                  to_flax, unstack)
from mrn_tpu_torch.models.common import BatchNorm
from mrn_tpu_torch.models.composer import build_recognizer
from mrn_tpu_torch.models.init import random_recognizer, random_router
from mrn_tpu_torch.models.mrn import MRNNet
from mrn_tpu_torch.models.svtr import set_droppath_generator
from mrn_tpu_torch.ops.losses import cross_entropy_dense
from mrn_tpu_torch.parallel import mesh
from mrn_tpu_torch.train.checkpoint import composite_experts, load_model, save_model
from mrn_tpu_torch.train.learners.base import BaseLearner

__all__ = ["MRN", "PI", "tree_hash"]

PI = 15.0  # recognition-loss weight in the router phase
ROUTER_KEYS = ("dm_router", "channel_route", "route")


def tree_hash(*trees: Mapping) -> str:
    """The JAX learner's ``_tree_hash``: sha1 over each flax-layout tree's
    sorted keys and, per leaf, its dtype, shape and C-order bytes; the
    first 16 hex digits."""
    h = hashlib.sha1()

    def walk(x):
        if isinstance(x, Mapping):
            for k in sorted(x):
                h.update(str(k).encode())
                walk(x[k])
        else:
            arr = np.asarray(x)
            h.update(str(arr.dtype).encode())
            h.update(str(arr.shape).encode())
            h.update(arr.tobytes())

    for t in trees:
        walk(t)
    return h.hexdigest()[:16]


class MRN(BaseLearner):

    def __init__(self, opt, device=None):
        super().__init__(opt, device)
        self.pinned = bool(opt.get("mrn_pin_expert_stats", True))
        self.expert_states: List[Dict[str, torch.Tensor]] = []  # frozen, unpadded
        self.class_counts: List[int] = []
        self._expert_hashes: List[Optional[str]] = []  # blob names, None until written
        self.router_state: Optional[Dict[str, torch.Tensor]] = None
        self.mrn_model: Optional[MRNNet] = None   # the training ensemble (step 1)
        self._eval_mrn: Optional[MRNNet] = None   # the float32 "TF" ensemble
        self._phase = "standalone"  # "standalone" | "routed"

    # ------------------------------------------------------------ models
    def _set_model(self, params, stats) -> None:
        """The expert of ``params`` / ``stats`` (flax trees) as the current
        standalone model (task 0's: ``BaseLearner.build_model``)."""
        super()._set_model(params, stats)
        self._phase = "standalone"

    def change_model(self) -> None:
        """Task > 0: a fresh expert in its construction init."""
        self._set_model(*random_recognizer(self.weight_rng, self.opt, self._total_classes))

    def _set_experts(self, states: List[Dict[str, torch.Tensor]], counts: List[int],
                     hashes: List[Optional[str]]) -> None:
        self.expert_states, self.class_counts, self._expert_hashes = states, counts, hashes
        self._eval_mrn = None

    def add_expert(self, params: Mapping, batch_stats: Optional[Mapping],
                   class_count: int) -> None:
        """Append a frozen expert given as one Recognizer's flax trees."""
        state = recognizer_state(params, batch_stats)
        self._set_experts(self.expert_states + [{k: v.to(self.device) for k, v in state.items()}],
                          self.class_counts + [int(class_count)], self._expert_hashes + [None])

    def _freeze_newest(self) -> None:
        """The standalone expert joins the frozen expert list and is written
        as a blob."""
        state = {k: v.detach().clone() for k, v in self.model.state_dict().items()}
        self._set_experts(self.expert_states + [state],
                          self.class_counts + [self._total_classes], self._expert_hashes + [None])
        self._ensure_expert_blobs()

    def _routed_model(self, router: Mapping, expert_dtype: Optional[torch.dtype] = None
                      ) -> MRNNet:
        """MRNNet over every frozen expert (fc padded to the current class
        count; under an expert mesh this rank's block of them) plus the
        ``router`` stack (flax tree), its experts frozen and cast to
        ``expert_dtype`` (their BatchNorm statistics stay float32)."""
        opt = self.opt
        block = mesh.shard_experts(len(self.expert_states))
        model = MRNNet(len(self.expert_states), self._total_classes, self.class_counts,
                       prediction=opt.Prediction, transformation=opt.Transformation,
                       feature_extraction=opt.FeatureExtraction,
                       sequence_modeling=opt.SequenceModeling,
                       input_channel=opt.input_channel,
                       output_channel=opt.output_channel, hidden_size=opt.hidden_size,
                       img_size=(opt.imgH, opt.imgW), svtr=opt.get("svtr"),
                       num_fiducial=opt.num_fiducial, batch_max_length=opt.batch_max_length,
                       expert_block=block)
        model.load_state_dict(routed_state([self.expert_states[i] for i in block], router,
                                           self._total_classes), strict=True)
        model.to(self.device)
        for p in model.experts.parameters():
            p.requires_grad_(False)
            if expert_dtype is not None:
                p.data = p.data.to(expert_dtype)
        return model.eval()

    def _router_tree(self) -> Dict:
        """The live router (the training ensemble's in step 1, else the last
        one kept) as a flax tree; ``{}`` before the first router phase."""
        if self._phase == "routed" and self.mrn_model is not None:
            return flax_tree((k, p) for k, p in self.mrn_model.named_parameters()
                             if not k.startswith("experts."))
        return flax_tree(self.router_state.items()) if self.router_state else {}

    def _eval_ensemble(self) -> MRNNet:
        """The "TF" ensemble: float32 experts and the live router.  In step
        1 without the bf16 policy it is the training ensemble; under it, a
        float32 copy of the experts built once per router phase around the
        training ensemble's router modules."""
        if self._eval_mrn is None:
            if self.mrn_model is None:
                self._eval_mrn = self._routed_model(self._router_tree())
            elif self._mp_dtype() is None:
                self._eval_mrn = self.mrn_model
            else:
                model = self._routed_model(self._router_tree())
                for key in ROUTER_KEYS:
                    setattr(model, key, getattr(self.mrn_model, key))
                if not self.pinned:   # the drifting statistics, shared
                    for mine, live in zip(model.experts.modules(),
                                          self.mrn_model.experts.modules()):
                        if isinstance(mine, BatchNorm):
                            mine.mean, mine.var = live.mean, live.var
                self._eval_mrn = model
        return self._eval_mrn

    def trainable_params(self) -> Dict[str, torch.Tensor]:
        if self._phase == "routed":
            return {k: p for k, p in self.mrn_model.named_parameters()
                    if not k.startswith("experts.")}
        return super().trainable_params()

    # ------------------------------------------------------------- loss
    def loss_fn(self, params, batch, aux=None):
        if self._phase != "routed":
            return super().loss_fn(params, batch, aux)
        out = self._apply(self.mrn_model, params, batch["image"], is_train=True,
                          train=not self.pinned, **self._teacher_text(batch))
        loss_clf = self._recognition_loss(out["logits"].float(), batch)
        # CE on the softmaxed routing weights, as the reference does
        loss_router = cross_entropy_dense(out["index"].float(), batch["dataset_idx"])
        # the log's train loss is the recognition part, as the reference's Train_loss_clf
        return PI * loss_clf + loss_router, {"clf": loss_clf.detach(),
                                             "router": loss_router.detach(),
                                             "log_loss": loss_clf.detach()}

    # ------------------------------------------------------------ train
    def start_router_phase(self, router: Optional[Mapping] = None) -> None:
        """Step 1's set-up: the routed ensemble over every frozen expert
        with ``router`` (flax tree) or a fresh router stack from
        ``weight_rng``, cast once under the bf16 policy (the JAX step casts
        them every step to the same values), and its optimizer (OneCycle
        over ``2 * num_iter``)."""
        self._phase = "routed"
        if router is None:
            router = random_router(self.weight_rng, self.opt, len(self.expert_states))
        self.mrn_model = self._routed_model(router, self._mp_dtype())
        set_droppath_generator(self.mrn_model, self.generator)
        self._eval_mrn = None
        self.build_optimizer(scale=1.0, the=2)

    def incremental_train(self, taski: int, character, train_loader, valid_loader) -> None:
        """Step 0, then (task > 0) step 1, of task ``taski`` whose cumulative
        character list is ``character``, validated on ``valid_loader``'s
        sets."""
        self._cur_task = taski
        self.character = list(character)
        self.converter = self.build_converter()
        if taski > 0:
            self.change_model()
        else:
            self.build_model()
        self.count_param()
        self.build_optimizer()
        self._train_mrn(taski, train_loader, valid_loader, step=0)
        if taski > 0:
            self._train_mrn(taski, train_loader, valid_loader, step=1)

    def _train_mrn(self, taski: int, train_loader, valid_loader, step: int) -> None:
        """One phase of task ``taski``, or its replay below ``start_task``."""
        if float(self.opt.get("start_task", 0)) > taski + step * 0.5:
            if taski > 0 and step == 0:
                train_loader.get_dataset(taski, memory=None)
            elif taski > 0:
                self._build_stream(train_loader, taski)
            self._load_best(taski, step=step)
            if step == 0 and taski > 0:
                self._freeze_newest()
            return
        if step == 0:
            self.log.write(f"Task {taski} start training ------{self.opt.exp_name}------\n")
            if taski > 0:
                train_loader.get_dataset(taski, memory=None)
            self._run_loop(taski, train_loader, valid_loader.create_dataset(), step=0)
            if taski > 0:
                self._freeze_newest()
            return   # the first expert is frozen by after_task
        self._build_stream(train_loader, taski)
        self.start_router_phase()
        self._run_loop(taski, train_loader, valid_loader.create_list_dataset(),
                       num_iter=int(self.opt.num_iter // 2),
                       get_batch=train_loader.get_batch2, step=1,
                       val_interval=max(1, int(self.opt.val_interval) // 5))
        self.router_state = {k: v.detach().clone()
                             for k, v in self.mrn_model.state_dict().items()
                             if not k.startswith("experts.")}
        if not self.pinned:
            self._write_back_stats()

    def _expert_buffers(self) -> List[Dict[str, torch.Tensor]]:
        """Every expert's live buffers in the training ensemble, by expert;
        under an expert mesh the other ranks' blocks are gathered."""
        experts = self.mrn_model.experts
        local = [dict(e.named_buffers()) for e in experts]
        if len(experts) == len(self.expert_states):
            return local
        gathered = {k: mesh.gather_experts(torch.stack([b[k] for b in local]))
                    for k in local[0]}
        return [{k: v[i] for k, v in gathered.items()} for i in range(len(self.expert_states))]

    def _expert_stats_tree(self) -> Dict:
        """The training ensemble's expert statistics, stacked under
        ``experts`` (the JAX router state's ``batch_stats``)."""
        return flax_tree((f"experts.{i}.{k}", b) for i, bufs in enumerate(self._expert_buffers())
                         for k, b in bufs.items())

    def _write_back_stats(self) -> None:
        """The drifted statistics into the frozen experts; their blobs are
        written anew at the next best save."""
        states = []
        for state, live in zip(self.expert_states, self._expert_buffers()):
            states.append({k: (live[k].detach().clone() if k in live else v)
                           for k, v in state.items()})
        self._set_experts(states, self.class_counts, [None] * len(states))

    def build_rehearsal_memory(self, train_loader, taski: int) -> None:
        """MRN's memory: ``memory_num >= 5000`` keeps full-size memories."""
        memory_num = self.opt.memory_num
        num_i = memory_num if memory_num >= 5000 else int(memory_num / taski)
        self.build_random_current_memory(num_i, taski, train_loader)
        if memory_num < 5000 and self.memory_index \
                and len(self.memory_index) * len(self.memory_index[0]) > memory_num:
            self.reduce_samplers(taski, taski_num=num_i)
        train_loader.get_dataset(taski, memory=self.opt.memory, index_list=self.memory_index)

    # ------------------------------------------------ full-state snapshots
    def _rebuild_stream(self, train_loader, taski: int, step: Optional[int]) -> None:
        if step == 0 or taski == 0:
            train_loader.get_dataset(taski, memory=None)
        else:
            train_loader.get_dataset(taski, memory=self.opt.memory,
                                     index_list=self.memory_index)

    def _snapshot_trees(self):
        """Step 1 keeps the router, and the experts' statistics when they
        drift: the frozen experts are rebuilt by the replay."""
        if self._phase != "routed":
            return super()._snapshot_trees()
        return self._router_tree(), ({} if self.pinned else self._expert_stats_tree())

    def _restore_trees(self, params, batch_stats) -> None:
        if self._phase != "routed":
            return super()._restore_trees(params, batch_stats)
        live = dict(self.mrn_model.named_parameters())
        live.update(self.mrn_model.named_buffers())
        state = recognizer_state({k: params[k] for k in ROUTER_KEYS})
        if batch_stats:   # drifting mode: the statistics of this rank's experts
            stats = unstack(batch_stats, "experts")
            for j, i in enumerate(self.mrn_model.expert_block):
                head = f"experts.{i}."
                state.update({f"experts.{j}.{k[len(head):]}": v for k, v in stats.items()
                              if k.startswith(head)})
        with torch.no_grad():
            for name, value in state.items():
                live[name].copy_(value)

    def after_task(self) -> None:
        """At task 0 the first expert (reloaded from its best checkpoint by
        ``test``) enters the frozen expert list."""
        if self._cur_task == 0 and not self.expert_states:
            self._freeze_newest()

    # ------------------------------------------------------------- eval
    def _eval_logits(self, images: torch.Tensor, val_choose: str) -> torch.Tensor:
        """FF: the standalone expert; otherwise (TF) the hard expert pick."""
        if val_choose in ("FF", "val") and self._phase == "standalone":
            return super()._eval_logits(images, val_choose)
        return self._eval_ensemble()(images, self._sos_column(images), is_train=False)["logits"]

    def val(self, valid_loader, opt, best_score, start_time, iteration,
            train_loss_avg, taski, step=None, val_choose=None):
        if val_choose is None:
            val_choose = "FF" if self._phase == "standalone" else "TF"
        if step is None:
            step = 0 if self._phase == "standalone" else 1
        return super().val(valid_loader, opt, best_score, start_time, iteration,
                           train_loss_avg, taski, step=step, val_choose=val_choose)

    def test(self, valid_datas, best_scores, ned_scores, taski,
             val_dataset_builder=None, val_choose=None):
        """Task 0: FF on the step-0 best; later tasks: TF on the step-1 best."""
        self._phase = "standalone" if taski == 0 else "routed"
        return super().test(valid_datas, best_scores, ned_scores, taski,
                            val_dataset_builder=val_dataset_builder,
                            val_choose="FF" if taski == 0 else "TF")

    # ------------------------------------------------------ checkpoints
    def _ckpt_step_tag(self) -> int:
        return 0 if self._cur_task == 0 else 1

    def _expert_dir(self) -> str:
        return os.path.join(self.opt.get("output_dir", "./saved_models"),
                            self.opt.exp_name, "experts")

    def _ensure_expert_blobs(self) -> List[str]:
        """Writes a blob for every expert lacking one; returns the refs."""
        for i, state in enumerate(self.expert_states):
            if self._expert_hashes[i]:
                continue
            params, stats = state_to_flax(state)
            ref = tree_hash(params, stats)
            path = os.path.join(self._expert_dir(), f"{ref}.msgpack")
            if not os.path.exists(path):
                save_model(path, params, stats, extra={"class_count": self.class_counts[i]})
            self._expert_hashes[i] = ref
        return list(self._expert_hashes)

    def _save_best(self, taski: int, step: Optional[int] = None) -> None:
        """Step 0: the standalone expert; step 1: the router only (the
        experts are the blobs); both with ``expert_refs``, ``expert_stats``
        and ``router``."""
        router = self._router_tree()
        if self._phase == "routed":
            params, stats = router, {}
        else:
            params, stats = to_flax(self.model)
        refs = self._ensure_expert_blobs()
        save_model(self._best_path(taski, step), params, stats,
                   extra={"expert_refs": refs,
                          "expert_stats": [state_to_flax(s)[1] for s in self.expert_states],
                          "router": router})

    def restore_composite(self, payload: Mapping, expert_dir: Optional[str] = None) -> None:
        """The composite state of a best payload: the frozen experts (blob
        refs resolved under ``expert_dir``, default this learner's, or the
        legacy inline list), the router, and a standalone expert's params
        into the standalone model."""
        params, stats, refs = composite_experts(payload, expert_dir or self._expert_dir())
        stats = stats or [{}] * len(params)
        states = [{k: v.to(self.device) for k, v in recognizer_state(p, s).items()}
                  for p, s in zip(params, stats)]
        mesh.replicate(v for state in states for v in state.values())
        counts = [int(np.shape(p["fc"]["kernel"])[-1]) for p in params]
        self._set_experts(states, counts, refs or [None] * len(states))
        router = payload.get("router")
        self.router_state = ({k: v.to(self.device) for k, v in recognizer_state(router).items()}
                             if router else None)
        if self.router_state:
            mesh.replicate(self.router_state.values())
        self.mrn_model = None
        if not any(k in payload["params"] for k in ROUTER_KEYS):
            if self.model is None:
                self.model = build_recognizer(self.opt, self._total_classes).to(self.device)
            self.model.load_state_dict(recognizer_state(payload["params"],
                                                        payload["batch_stats"]), strict=True)
            mesh.replicate(self.model)

    def _load_best(self, taski: int, step: Optional[int] = None) -> None:
        mesh.barrier()   # rank 0's writes are done
        path = self._best_path(taski, step)
        self.restore_composite(load_model(path))
        self.log.write(f"Task {taski} load checkpoint from {path}.\n")
