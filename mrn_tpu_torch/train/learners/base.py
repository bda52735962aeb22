"""The part of ``mrn_tpu/train/learners/base.py`` a training step needs:
the converter, the mixed-precision policy, the train-mode forward, batch
encoding with the device image bank, the optimizer and the loop.

Mixed precision (``opt.train_dtype == "bf16"``, the JAX ``--bf16`` policy):
every float parameter and the image are cast to bfloat16 for the forward
and backward (``torch.func.functional_call`` over cast copies, so
LayerNorm and the rest run in bfloat16 exactly as in JAX, which
``torch.autocast`` would not); master parameters, Adam moments, BatchNorm
running statistics and the losses stay float32.

Runs on the CUDA card unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Mapping, Optional, Union

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from mrn_tpu_torch import resolve_device
from mrn_tpu_torch.codec import CTCLabelConverter
from mrn_tpu_torch.train.optim import build_optimizer, build_schedule
from mrn_tpu_torch.train.steps import TrainState, make_train_step, recognition_loss

__all__ = ["BaseLearner"]


class BaseLearner:
    def __init__(self, opt, device: Optional[Union[str, torch.device]] = None):
        if opt.Prediction != "CTC":
            raise NotImplementedError(f"Prediction {opt.Prediction!r}: the port "
                                      "trains CTC heads only so far")
        self.opt = opt
        self.device = resolve_device(device)
        self.np_rng = np.random.default_rng(opt.manual_seed)
        # draws every DropPath keep mask of the models this learner builds
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(opt.manual_seed)
        self._cur_task = -1
        self._total_classes = 0
        self.character = None
        self.converter = None
        self.model: Optional[nn.Module] = None
        self.state: Optional[TrainState] = None
        self._train_step = None
        self._bank = None       # (host bank, its copy on the device)
        self.history: List[Dict] = []

    # ------------------------------------------------------------ setup
    def build_converter(self) -> CTCLabelConverter:
        converter = CTCLabelConverter(self.character)
        self._total_classes = converter.num_classes
        return converter

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

    def loss_fn(self, params, batch):
        return recognition_loss(self._apply_train(params, batch), batch), {}

    def grad_transform(self) -> Optional[Callable]:
        return None

    def get_train_step(self):
        if self._train_step is None:
            self._train_step = make_train_step(self.loss_fn, self.grad_transform())
        return self._train_step

    # ------------------------------------------------------------ batches
    def _device_images(self, images) -> torch.Tensor:
        """Float images move to the device as they are; integer batches are
        indices into the uint8 image bank ``opt.image_bank`` [N, H, W, C],
        copied to the device once, gathered and normalised
        ``(x / 255 - 0.5) / 0.5`` there."""
        images = np.asarray(images)
        if not np.issubdtype(images.dtype, np.integer):
            return torch.as_tensor(images, dtype=torch.float32, device=self.device)
        bank = self.opt.get("image_bank")
        if bank is None:
            raise ValueError("bank-index batch but opt.image_bank is unset")
        if self._bank is None or self._bank[0] is not bank:
            self._bank = (bank, torch.as_tensor(np.asarray(bank, np.uint8),
                                                device=self.device))
        index = torch.as_tensor(images.astype(np.int64), device=self.device)
        img = self._bank[1].index_select(0, index)
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
    def _run_loop(self, get_batch: Callable, num_iter: int, step: int) -> None:
        """``num_iter`` steps.  Each one is timed on the host clock from
        fetching its batch to reading its loss back (which waits for the
        device) and appended to ``history``."""
        for iteration in range(1, num_iter + 1):
            t0 = time.perf_counter()
            metrics = self.train_step(get_batch())
            record = {k: float(v) for k, v in metrics.items()}
            record.update(task=self._cur_task, step=step, iteration=iteration,
                          seconds=time.perf_counter() - t0)
            self.history.append(record)
