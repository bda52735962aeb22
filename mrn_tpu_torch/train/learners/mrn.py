"""MRN learner, the two training phases of a task (mirrors
``mrn_tpu/train/learners/mrn.py`` without LMDB, validation or checkpoints):

- step 0: the NEW expert trains alone (train mode: DropPath, BatchNorm on
  batch statistics, CTC), then it is frozen into the expert list;
- step 1 (task > 0): a fresh router stack trains over all experts stacked
  and frozen, for ``num_iter // 2`` updates on the rehearsal stream whose
  batches carry each sample's task id, with loss
  ``15 * CTC + CE(index, task id)`` and OneCycle over ``2 * num_iter``.
  The experts run in eval mode, so their BatchNorm statistics stay pinned
  (``mrn_pin_expert_stats=True``), and without gradients.

``train_loader`` is any object with the ``DatasetManager`` batch methods:
``get_batch() -> (images, labels)`` for step 0 and ``get_batch2() ->
(images, labels, task_ids)`` for step 1; images may be indices into
``opt.image_bank``.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional

import torch

from mrn_tpu_torch.bridge import from_flax, recognizer_state, routed_state
from mrn_tpu_torch.models.composer import build_recognizer
from mrn_tpu_torch.models.init import random_recognizer, random_router
from mrn_tpu_torch.models.mrn import MRNNet
from mrn_tpu_torch.models.svtr import set_droppath_generator
from mrn_tpu_torch.ops.losses import cross_entropy_dense
from mrn_tpu_torch.train.learners.base import BaseLearner
from mrn_tpu_torch.train.steps import recognition_loss

__all__ = ["MRN", "PI"]

PI = 15.0  # recognition-loss weight in the router phase


class MRN(BaseLearner):

    def __init__(self, opt, device=None):
        super().__init__(opt, device)
        self.expert_states: List[Dict[str, torch.Tensor]] = []  # frozen, unpadded
        self.class_counts: List[int] = []
        self.router_state: Optional[Dict[str, torch.Tensor]] = None
        self.mrn_model: Optional[MRNNet] = None
        self._phase = "standalone"  # "standalone" | "routed"

    # ------------------------------------------------------------ models
    def _new_expert(self) -> None:
        """A fresh expert in the JAX init distributions, as the current
        standalone model.  It serves as both ``build_model`` (task 0) and
        ``change_model`` (task > 0): the task-0 ``apply_reference_init``
        pass of the JAX learner is not ported."""
        params, stats = random_recognizer(self.np_rng, self.opt, self._total_classes)
        model = build_recognizer(self.opt, self._total_classes)
        model.load_state_dict(from_flax(params, stats), strict=True)
        self.model = model.to(self.device)
        set_droppath_generator(self.model, self.generator)
        self._phase = "standalone"

    build_model = change_model = _new_expert

    def add_expert(self, params: Mapping, batch_stats: Optional[Mapping],
                   class_count: int) -> None:
        """Append a frozen expert given as one Recognizer's flax trees."""
        state = recognizer_state(params, batch_stats)
        self.expert_states.append({k: v.to(self.device) for k, v in state.items()})
        self.class_counts.append(int(class_count))

    def _freeze_newest(self) -> None:
        """The standalone expert joins the frozen expert list."""
        self.expert_states.append({k: v.detach().clone()
                                   for k, v in self.model.state_dict().items()})
        self.class_counts.append(self._total_classes)

    def _routed_model(self, router: Optional[Mapping] = None) -> MRNNet:
        """MRNNet over every frozen expert (fc padded to the current class
        count) plus a router stack: ``router`` (flax tree) or a fresh one.
        Under the bf16 policy the frozen experts are cast once here (the
        JAX step casts them every step to the same values); their BatchNorm
        statistics stay float32."""
        opt = self.opt
        n = len(self.expert_states)
        model = MRNNet(n, self._total_classes, self.class_counts,
                       prediction=opt.Prediction, transformation=opt.Transformation,
                       feature_extraction=opt.FeatureExtraction,
                       sequence_modeling=opt.SequenceModeling,
                       input_channel=opt.input_channel,
                       output_channel=opt.output_channel, hidden_size=opt.hidden_size,
                       img_size=(opt.imgH, opt.imgW), svtr=opt.get("svtr"))
        if router is None:
            router = random_router(self.np_rng, opt, n)
        model.load_state_dict(routed_state(self.expert_states, router,
                                           self._total_classes), strict=True)
        model.to(self.device)
        dt = self._mp_dtype()
        for p in model.experts.parameters():
            p.requires_grad_(False)
            if dt is not None:
                p.data = p.data.to(dt)
        return model.eval()

    def trainable_params(self) -> Dict[str, torch.Tensor]:
        if self._phase == "routed":
            return {k: p for k, p in self.mrn_model.named_parameters()
                    if not k.startswith("experts.")}
        return super().trainable_params()

    # ------------------------------------------------------------- loss
    def loss_fn(self, params, batch):
        if self._phase != "routed":
            return super().loss_fn(params, batch)
        out = self._apply(self.mrn_model, params, batch["image"], is_train=True)
        loss_clf = recognition_loss(out["logits"].float(), batch)
        # CE on the softmaxed routing weights, as the reference does
        loss_router = cross_entropy_dense(out["index"].float(), batch["dataset_idx"])
        return PI * loss_clf + loss_router, {"clf": loss_clf.detach(),
                                             "router": loss_router.detach()}

    # ------------------------------------------------------------ train
    def start_router_phase(self, router: Optional[Mapping] = None) -> None:
        """Step 1's set-up: the routed ensemble and its optimizer (OneCycle
        over ``2 * num_iter``)."""
        self._phase = "routed"
        self.mrn_model = self._routed_model(router)
        self.build_optimizer(scale=1.0, the=2)

    def incremental_train(self, taski: int, character, train_loader) -> None:
        """Step 0, then (task > 0) step 1, of task ``taski`` whose cumulative
        character list is ``character``."""
        self._cur_task = taski
        self.character = list(character)
        self.converter = self.build_converter()
        if taski > 0:
            self.change_model()
        else:
            self.build_model()
        self.build_optimizer()
        self._run_loop(train_loader.get_batch, int(self.opt.num_iter), step=0)
        if taski == 0:
            return  # the first expert is frozen by after_task
        self._freeze_newest()
        self.start_router_phase()
        self._run_loop(train_loader.get_batch2, int(self.opt.num_iter // 2), step=1)
        self.router_state = {k: v.detach().clone()
                             for k, v in self.mrn_model.state_dict().items()
                             if not k.startswith("experts.")}

    def after_task(self) -> None:
        """At task 0 the first expert enters the frozen expert list."""
        if self._cur_task == 0 and not self.expert_states:
            self._freeze_newest()
