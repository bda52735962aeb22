"""Serving entry point: recognise word crops with a recognizer or an MRN
routed ensemble of SVTR (None/SVTR/None/CTC) or TRBA (TPS/ResNet/BiLSTM/Attn)
experts.

    server = Server(opt, params, batch_stats, character, class_counts=counts)
    for word, conf in server.recognize(images): ...

``params``/``batch_stats`` are the JAX package's variable trees as numpy
arrays (bridged with ``mrn_tpu_torch.bridge.from_flax``).  Images are NHWC
at ``(imgH, imgW)``: float already normalised as ``(x/255 - 0.5)/0.5`` or
uint8, which is normalised on the device.  The outputs follow the JAX eval
path (``make_eval_batch`` + ``recognize_cli.recognize``): the argmax indices
and ``max softmax`` per step, the decoded word and the confidence
``prod(max softmax)``.  CTC takes every step.  Attn decodes greedily from
an [SOS] column, and each word and its ``max softmax`` are cut at the first
"[EOS]" of the decoded string before the product.

Runs on the CUDA card unless ``device="cpu"`` is passed, in
``opt.compute_dtype`` (float32 or bfloat16; bfloat16 casts every weight and
the images, as the JAX serving path does).

w8a8 serving (``evaluate_cli.py --int8``) of a single SVTR recognizer::

    quantize_int8(server, calibration_batches)   # calibrate, quantize, rebuild
    server.recognize(images)                     # 12 int8 Blocks per request

``server.check_score_envelope(images)`` is the float path's check of the
fused Block's score clamp (``evaluate_cli.check_svtr_envelope``).

Serving a best checkpoint file the JAX package or the port wrote
(``evaluate_cli.load_learner``)::

    server = Server.from_checkpoint(opt, "saved_models/exp/Latin_1_1_best_score.msgpack",
                                    character, last_task=1)

task 0's file is one recognizer; a later task's file is the router, its
experts the blobs ``experts/{ref}.msgpack`` beside it (or inline in an
older file).
"""

from __future__ import annotations

import itertools
import os
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from mrn_tpu_torch import resolve_device
from mrn_tpu_torch.bridge import from_flax, quant_tree, recognizer_state, routed_state
from mrn_tpu_torch.codec import build_converter
from mrn_tpu_torch.models.composer import build_recognizer
from mrn_tpu_torch.models.mrn import MRNNet
from mrn_tpu_torch.models.svtr import Block, score_envelope
from mrn_tpu_torch.ops.int8 import quantize_variables
from mrn_tpu_torch.ops.svtr_block import SCORE_CLAMP
from mrn_tpu_torch.train.checkpoint import composite_experts, load_model

__all__ = ["Server", "quantize_int8"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class Server:
    def __init__(self, opt, params: Mapping, batch_stats: Optional[Mapping],
                 character: Sequence[str],
                 class_counts: Optional[Sequence[int]] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 state: Optional[Mapping[str, torch.Tensor]] = None):
        """``state``: an MRN ensemble's port state dict, loaded in place of
        ``from_flax(params, batch_stats)`` (``from_checkpoint``'s router over
        experts kept apart from its params)."""
        self.device = resolve_device(device)
        if opt.compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype {opt.compute_dtype!r} not in {list(_DTYPES)}")
        self.dtype = _DTYPES[opt.compute_dtype]
        self.opt = opt
        self.converter = build_converter(opt.Prediction, character)
        self.attn = opt.Prediction == "Attn"
        # the float32 trees as given: int8 quantization starts from them
        self.params, self.batch_stats = params, batch_stats
        num_classes = self.converter.num_classes
        if state is not None or "experts" in params:
            if class_counts is None:
                raise ValueError("an MRN ensemble needs the per-expert class_counts")
            self.model = MRNNet(
                len(class_counts), num_classes, class_counts, prediction=opt.Prediction,
                transformation=opt.Transformation,
                feature_extraction=opt.FeatureExtraction,
                sequence_modeling=opt.SequenceModeling,
                input_channel=opt.input_channel,
                output_channel=opt.output_channel, hidden_size=opt.hidden_size,
                img_size=(opt.imgH, opt.imgW), svtr=opt.get("svtr"),
                num_fiducial=opt.num_fiducial, batch_max_length=opt.batch_max_length)
            self.model.load_state_dict(from_flax(params, batch_stats) if state is None
                                       else state, strict=True)
            self.model.to(device=self.device, dtype=self.dtype).eval()
        else:
            self.model = self.build(params, batch_stats)

    @classmethod
    def from_checkpoint(cls, opt, path: str, character: Sequence[str], last_task: int,
                        device: Optional[Union[str, torch.device]] = None) -> "Server":
        """Serves the best checkpoint ``path`` of task ``last_task``
        (``character``: the cumulative character list of tasks 0..last_task):
        at task 0 the recognizer it holds; later, its router over the
        frozen experts (``expert_refs`` resolved under ``experts/`` beside
        the file, or the inline list), each expert's class count read from
        its ``fc.kernel``."""
        payload = load_model(path)
        if last_task == 0:
            return cls(opt, payload["params"], payload["batch_stats"], character,
                       device=device)
        params, stats, _ = composite_experts(
            payload, os.path.join(os.path.dirname(os.path.abspath(path)), "experts"))
        stats = stats or [{}] * len(params)
        counts = [int(np.shape(p["fc"]["kernel"])[-1]) for p in params]
        states = [recognizer_state(p, s) for p, s in zip(params, stats)]
        num_classes = build_converter(opt.Prediction, character).num_classes
        return cls(opt, payload["params"], payload["batch_stats"], character,
                   class_counts=counts, device=device,
                   state=routed_state(states, payload["params"], num_classes))

    def build(self, params: Mapping, batch_stats: Optional[Mapping],
              quant: Optional[Mapping] = None, mode: str = "none",
              dtype: Optional[torch.dtype] = None) -> torch.nn.Module:
        """A single recognizer with these trees, its Blocks in ``mode``
        ("none", "calib", "int8" with ``quant``), on the server's device in
        ``dtype`` (the server's by default), in eval mode."""
        model = build_recognizer(self.opt, self.converter.num_classes, quant=mode)
        model.load_state_dict(from_flax(params, batch_stats, quant), strict=True)
        return model.to(device=self.device, dtype=dtype or self.dtype).eval()

    @property
    def quantized(self) -> bool:
        """Whether the model serves w8a8 int8 Blocks."""
        return any(isinstance(m, Block) and m.quant == "int8" for m in self.model.modules())

    def images(self, images, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """NHWC images (float already normalised, or uint8) on the device in
        ``dtype`` (the server's by default)."""
        x = torch.as_tensor(images).to(self.device)
        if x.dtype == torch.uint8:
            x = (x.float() / 255.0 - 0.5) / 0.5
        expect = (self.opt.imgH, self.opt.imgW, self.opt.input_channel)
        if x.ndim != 4 or tuple(x.shape[1:]) != expect:
            raise ValueError(f"images must be NHWC [B, {expect[0]}, {expect[1]}, "
                             f"{expect[2]}], got {tuple(x.shape)}")
        return x.to(dtype or self.dtype)

    def check_score_envelope(self, images) -> Optional[float]:
        """``evaluate_cli.check_svtr_envelope``: the largest |attention
        score| of this batch on the composed path (``models.svtr.
        score_envelope``, loud on stderr at or above the fused Block's
        ``SCORE_CLAMP``), printed; None on the int8 path, whose softmax
        subtracts the max, and for a model without SVTR Blocks."""
        if self.quantized or self.opt.FeatureExtraction != "SVTR":
            return None
        mx = score_envelope(self.model, self.images(images))
        print(f"# svtr score envelope: max |score| {mx:.1f} (fused-kernel clamp {SCORE_CLAMP:g})")
        return mx

    @torch.inference_mode()
    def forward(self, images) -> Dict[str, torch.Tensor]:
        """{"logits" [B, T, C], "index" [B] (MRN expert pick, else None)} on
        the device."""
        x = self.images(images)
        text = None
        if self.attn:  # make_eval_batch's [SOS] column
            text = torch.full((x.shape[0], 1), self.converter.sos_id, dtype=torch.int64,
                              device=self.device)
        out = self.model(x, text)
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
        out = []
        for w, p in zip(words, max_probs):
            eos = w.find("[EOS]") if self.attn else -1
            if eos >= 0:
                # cut at the string index, as train/evaluate.py does: a
                # multi-character special token before [EOS] shifts the cut
                # of max_probs, a quirk kept for parity
                w, p = w[:eos], p[:eos]
            out.append((w, float(np.prod(p)) if len(p) else 0.0))
        return out


def quantize_int8(server: Server, batches: Iterable, n_batches: int = 4) -> Server:
    """w8a8 post-training quantization of a single-recognizer server
    (``evaluate_cli.quantize_learner_int8``): the float32 recognizer runs in
    eval mode with ``quant="calib"`` on up to ``n_batches`` image batches of
    ``batches`` (NHWC, uint8 or normalised float) and records each Block
    projection's input range; its float32 weights are quantized
    (``ops.int8.quantize_variables``) and the server's model is rebuilt with
    ``quant="int8"`` in its own dtype.  An MRN ensemble is refused, as the
    JAX CLI refuses it.  Returns the server."""
    if isinstance(server.model, MRNNet):
        raise ValueError("int8 serving supports single-recognizer models (the "
                         "composite MRN/DER eval paths stay float)")
    calib = server.build(server.params, server.batch_stats, mode="calib", dtype=torch.float32)
    seen = 0
    with torch.inference_mode():
        for images in itertools.islice(batches, n_batches):
            calib(server.images(images, torch.float32))
            seen += 1
    if seen == 0:
        raise ValueError("int8 calibration saw no batches -- the calibration "
                         "loader is empty; quantizing without activation "
                         "ranges would produce garbage")
    qv = quantize_variables({"params": server.params, "quant": quant_tree(calib)})
    server.model = server.build(qv["params"], server.batch_stats, qv["quant"], mode="int8")
    return server
