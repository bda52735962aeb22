"""Serving entry point: recognise word crops with an SVTR recognizer or an
SVTR-MRN routed ensemble.

    server = Server(opt, params, batch_stats, character, class_counts=counts)
    for word, conf in server.recognize(images): ...

``params``/``batch_stats`` are the JAX package's variable trees as numpy
arrays (bridged with ``mrn_tpu_torch.bridge.from_flax``).  Images are NHWC
at ``(imgH, imgW)``: float already normalised as ``(x/255 - 0.5)/0.5`` or
uint8, which is normalised on the device.  The outputs follow the JAX eval
path (``make_eval_batch`` + ``recognize_cli.recognize``): greedy CTC
indices, ``max softmax`` per step, the decoded word and the confidence
``prod(max softmax)`` over all steps.

Runs on the CUDA card unless ``device="cpu"`` is passed, in
``opt.compute_dtype`` (float32 or bfloat16; bfloat16 casts every weight and
the images, as the JAX serving path does).
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from mrn_tpu_torch import resolve_device
from mrn_tpu_torch.bridge import from_flax
from mrn_tpu_torch.codec import CTCLabelConverter
from mrn_tpu_torch.models.composer import build_recognizer
from mrn_tpu_torch.models.mrn import MRNNet

__all__ = ["Server"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class Server:
    def __init__(self, opt, params: Mapping, batch_stats: Optional[Mapping],
                 character: Sequence[str],
                 class_counts: Optional[Sequence[int]] = None,
                 device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        if opt.compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype {opt.compute_dtype!r} not in {list(_DTYPES)}")
        self.dtype = _DTYPES[opt.compute_dtype]
        self.opt = opt
        self.converter = CTCLabelConverter(character)
        num_classes = self.converter.num_classes
        if "experts" in params:
            n = len(np.asarray(params["experts"]["fc"]["kernel"]))
            if class_counts is None:
                raise ValueError("an MRN ensemble needs the per-expert class_counts")
            self.model = MRNNet(
                n, num_classes, class_counts, prediction=opt.Prediction,
                transformation=opt.Transformation,
                feature_extraction=opt.FeatureExtraction,
                sequence_modeling=opt.SequenceModeling,
                input_channel=opt.input_channel,
                output_channel=opt.output_channel, hidden_size=opt.hidden_size,
                img_size=(opt.imgH, opt.imgW))
        else:
            self.model = build_recognizer(opt, num_classes)
        self.model.load_state_dict(from_flax(params, batch_stats), strict=True)
        self.model.to(device=self.device, dtype=self.dtype).eval()

    def _images(self, images) -> torch.Tensor:
        x = torch.as_tensor(images).to(self.device)
        if x.dtype == torch.uint8:
            x = (x.float() / 255.0 - 0.5) / 0.5
        expect = (self.opt.imgH, self.opt.imgW, self.opt.input_channel)
        if x.ndim != 4 or tuple(x.shape[1:]) != expect:
            raise ValueError(f"images must be NHWC [B, {expect[0]}, {expect[1]}, "
                             f"{expect[2]}], got {tuple(x.shape)}")
        return x.to(self.dtype)

    @torch.inference_mode()
    def forward(self, images) -> Dict[str, torch.Tensor]:
        """{"logits" [B, T, C], "index" [B] (MRN expert pick, else None)} on
        the device."""
        out = self.model(self._images(images))
        if "logits" in out:
            return {"logits": out["logits"], "index": out["index"]}
        return {"logits": out["predict"], "index": None}

    @torch.inference_mode()
    def eval_batch(self, images) -> Dict[str, np.ndarray]:
        """``preds_index`` [B, T] int32, ``max_probs`` [B, T] float32 and, for
        MRN, the expert ``index`` [B], on the host."""
        out = self.forward(images)
        logits = out["logits"]
        probs = torch.softmax(logits.float(), dim=2)
        res = {"preds_index": logits.argmax(dim=2).to(torch.int32).cpu().numpy(),
               "max_probs": probs.amax(dim=2).cpu().numpy()}
        if out["index"] is not None:
            res["index"] = out["index"].cpu().numpy()
        return res

    def recognize(self, images) -> List[Tuple[str, float]]:
        """(word, confidence) per image."""
        res = self.eval_batch(images)
        preds, max_probs = res["preds_index"], res["max_probs"]
        words = self.converter.decode(preds, np.full((preds.shape[0],),
                                                     preds.shape[1]))
        return [(w, float(np.prod(p)) if len(p) else 0.0)
                for w, p in zip(words, max_probs)]
