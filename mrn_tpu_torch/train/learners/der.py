"""DER, Dynamically Expandable Representation (mirrors
``mrn_tpu/train/learners/der.py``) on the port's ``models.der.DERNet``.

- ``build_model``: one extractor, drawn from ``weight_rng``
  (``models.init.random_der``), then the reference init pass with the
  stacked fan-in rule (``stacked=("extractors",)``);
- ``change_model``: the new extractor is a copy of the last one (params
  and statistics), the fc grows over the old one with its input
  (``grow_fc_der``), ``aux_fc`` is fresh;
- training: the old extractors are frozen.  JAX zeroes their slices'
  gradients; here they are left out of the optimizer, which gives the same
  update (a fresh optimizer each task, zero gradients add nothing to the
  global norm, and Adam's and Adadelta's update of a zero gradient from a
  zero state is zero).  They run in eval mode without gradients (the fused
  inference Block on the card), their parameters cast once per loop under
  the bf16 policy; only the newest runs in train mode and updates its
  statistics.  The loss is CLF alone: the aux head's CTC is logged and left
  out (``aux_fc`` gets a zero gradient);
- the fc is aligned (``wa.align_fc``) at the end of
  ``_update_representation``, before ``test`` reloads the best checkpoint;
  ``after_task`` only sets ``_known_classes``.

A full-state snapshot writes the optimizer state in optax's stacked
layout, the frozen extractors' moments zero.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from mrn_tpu_torch.bridge import to_flax
from mrn_tpu_torch.models.composer import Extractor
from mrn_tpu_torch.models.der import DERNet
from mrn_tpu_torch.models.init import random_der
from mrn_tpu_torch.models.surgery import apply_reference_init, grow_fc_der
from mrn_tpu_torch.models.svtr import Block
from mrn_tpu_torch.train.learners.base import BaseLearner
from mrn_tpu_torch.train.learners.wa import align_fc
from mrn_tpu_torch.train.steps import recognition_loss

__all__ = ["DER"]


class DER(BaseLearner):

    def __init__(self, opt, device=None):
        super().__init__(opt, device)
        self.n_experts = 0

    # ------------------------------------------------------------ models
    def _build_net(self) -> DERNet:
        opt = self.opt
        return DERNet(self.n_experts, self._total_classes, prediction=opt.Prediction,
                      transformation=opt.Transformation,
                      feature_extraction=opt.FeatureExtraction,
                      sequence_modeling=opt.SequenceModeling,
                      input_channel=opt.input_channel, output_channel=opt.output_channel,
                      hidden_size=opt.hidden_size, img_size=(opt.imgH, opt.imgW),
                      svtr=opt.get("svtr"), num_fiducial=opt.num_fiducial)

    def build_model(self) -> None:
        self.n_experts = 1
        params, stats = random_der(self.weight_rng, self.opt, 1, self._total_classes)
        self._set_model(apply_reference_init(params, self.weight_rng, stacked=("extractors",)),
                        stats)

    def change_model(self) -> None:
        old_params, old_stats = to_flax(self.model)
        self.n_experts += 1
        params, stats = random_der(self.weight_rng, self.opt, self.n_experts,
                                   self._total_classes)

        def grow(old):
            if isinstance(old, dict):
                return {k: grow(v) for k, v in old.items()}
            return np.concatenate([old, old[-1:]], axis=0)

        params["extractors"] = grow(old_params["extractors"])
        stats["extractors"] = grow(old_stats["extractors"])
        self._set_model(grow_fc_der(params, old_params, out_dim=self.opt.hidden_size), stats)

    def _frozen_names(self):
        return [k for k, _ in self.model.named_parameters()
                if k.startswith("extractors.") and int(k.split(".")[1]) < self.n_experts - 1]

    def trainable_params(self) -> Dict[str, torch.Tensor]:
        frozen = set(self._frozen_names())
        return {k: p for k, p in self.model.named_parameters() if k not in frozen}

    def _frozen_moments(self) -> Dict[str, torch.Tensor]:
        params = dict(self.model.named_parameters())
        return {k: params[k] for k in self._frozen_names()}

    # ------------------------------------------------------------- train
    def train_aux(self):
        """The frozen extractors for the loop: bfloat16 copies under the
        bf16 policy, else the model's own."""
        if self.n_experts <= 1:
            return None
        frozen = list(self.model.extractors[:-1])
        if self._mp_dtype() is None:
            return frozen
        return [self._frozen_copy(self._copy_extractor(e)) for e in frozen]

    def _copy_extractor(self, extractor: Extractor) -> Extractor:
        opt = self.opt
        copy = Extractor(opt.Transformation, opt.FeatureExtraction, opt.SequenceModeling,
                         opt.input_channel, opt.output_channel, opt.hidden_size,
                         (opt.imgH, opt.imgW), opt.get("svtr"), num_fiducial=opt.num_fiducial)
        copy.load_state_dict(extractor.state_dict(), strict=True)
        # the Blocks' settings (plain versions, the erf fit) follow the model's
        for src, dst in zip(extractor.modules(), copy.modules()):
            if isinstance(src, Block):
                dst.plain, dst.gelu_degree = src.plain, src.gelu_degree
        return copy.to(self.device)

    def _apply_train(self, params, batch, aux=None) -> Dict[str, torch.Tensor]:
        if aux is None:
            out = self._apply(self.model, params, batch["image"], train=True)
        else:
            frozen = torch.stack([self._eval_forward(e, batch["image"]) for e in aux])
            out = self._apply(self.model, params, batch["image"], train=True, frozen=frozen)
        return {k: out[k].float() for k in ("logits", "aux_logits")}

    def loss_fn(self, params, batch, aux=None):
        out = self._apply_train(params, batch, aux)
        loss_clf = recognition_loss(out["logits"], batch)
        with torch.no_grad():
            loss_aux = recognition_loss(out["aux_logits"], batch)
        return loss_clf, {"clf": loss_clf.detach(), "aux": loss_aux}

    def _update_representation(self, taski, train_loader, valid_loader):
        super()._update_representation(taski, train_loader, valid_loader)
        align_fc(self, self.model.fc)

    def after_task(self):
        self._known_classes = self._total_classes
