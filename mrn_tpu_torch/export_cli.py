"""Export CLI of the port (the port's copy of the JAX package's
``export_cli.py``): traces a checkpoint's eval forward, image -> logits at a
fixed batch, with ``torch.export`` and saves it as a ``.pt2`` program that
serves without the model code.

    python3 -m mrn_tpu_torch.export_cli --config configs/svtr_mrn.py \\
        --saved_model saved_models/.../Bangla_5_1_best_score.msgpack \\
        --out svtr.pt2 --batch_size 512 [--dtype bf16] [--taski 5] \\
        [--int8 [--calib_data ROOT]] [--device cpu]

    # serve it back: the program calls the port's kernels as custom ops
    import torch, mrn_tpu_torch.ops        # registers the ops: import it first
    program = torch.export.load("svtr.pt2")
    logits = program.module()(images)     # float32 [B, T, C]: greedy-decode on top

The input is float32 NHWC ``[B, imgH, imgW, input_channel]``, already
normalised as ``(x/255 - 0.5)/0.5``; the output float32 logits ``[B, T,
classes]``.  Decoding (CTC collapse, Attn EOS cut) stays on the host
(``mrn_tpu_torch.codec``).  The module exported is the one ``evaluate_cli``
evaluates: a recognizer, a DER network, or after task 0 an MRN checkpoint's
routed ensemble (which JAX's CLI cannot evaluate, ``ROADMAP.md`` §3).  An
Attn head decodes greedily from the [SOS] column the program builds.  The
SVTR Blocks, the int8 Blocks and the TPS warp are one custom-op node each
(``torch.ops.mrn_tpu_torch.fused_block``, ``fused_block_int8``,
``grid_sample``): the kernels on the card, their plain versions on the CPU;
the program runs on the device it was exported on.  The GELU form of the
Blocks (``models.svtr.set_gelu_approximate``) is the one set when it is
exported.  Runs on the CUDA card unless ``--device`` names another.
"""

from __future__ import annotations

import argparse
import copy
import os
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from mrn_tpu_torch.config import load_config
from mrn_tpu_torch.data.manager import ValDataset
from mrn_tpu_torch.evaluate_cli import _eval_model, load_learner, quantize_learner_int8
from mrn_tpu_torch.models.svtr import frozen_folds

__all__ = ["InferenceModule", "export_inference", "main"]

_DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


class InferenceModule(nn.Module):
    """float32 NHWC images -> float32 logits [B, T, classes] of ``model`` in
    ``dtype`` (the images cast to it); ``sos_id``: the Attn head's [SOS]
    id, whose column [B, 1] the forward builds (None for CTC)."""

    def __init__(self, model: nn.Module, dtype: torch.dtype, sos_id: Optional[int] = None):
        super().__init__()
        self.model, self.dtype, self.sos_id = model, dtype, sos_id

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        x = image.to(self.dtype)
        text = None if self.sos_id is None else torch.full(
            (x.shape[0], 1), self.sos_id, dtype=torch.int64, device=x.device)
        out = self.model(x, text)
        logits = out["predict"] if "predict" in out else out["logits"]
        return logits.float()


def export_inference(learner, opt, batch_size: int, dtype_name: str = "bf16"):
    """Returns (the ``torch.export.ExportedProgram``, its output shape) of
    the learner's eval forward (``evaluate_cli``'s module at the learner's
    task, a copy cast to ``dtype_name``'s type) at ``batch_size``, on the
    learner's device.

    The trace takes each SVTR Block's folded weights as constants of the
    program (``models.svtr.frozen_folds``, as it takes the int8 Blocks'
    prepared operands) instead of folding in every call."""
    dtype = _DTYPES[dtype_name]
    model = copy.deepcopy(_eval_model(learner, learner._cur_task)).to(dtype=dtype).eval()
    sos_id = learner.converter.sos_id if opt.Prediction == "Attn" else None
    module = InferenceModule(model, dtype, sos_id)
    spec = torch.zeros((batch_size, opt.imgH, opt.imgW, opt.input_channel),
                       dtype=torch.float32, device=learner.device)
    with torch.no_grad():
        out = module(spec)
        with frozen_folds(model, dtype):
            program = torch.export.export(module, (spec,), strict=False)
    return program, tuple(out.shape)


def main(argv: Optional[Sequence[str]] = None):
    """Writes the program; returns (the ``.pt2`` path, its output shape)."""
    parser = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        epilog="Loading the .pt2 needs `import mrn_tpu_torch.ops` first: it registers the "
               "custom ops the program calls.")
    parser.add_argument("--config", required=True)
    parser.add_argument("--saved_model", required=True)
    parser.add_argument("--out", required=True, help="the .pt2 file to write")
    parser.add_argument("--batch_size", type=int, default=512)
    parser.add_argument("--dtype", choices=sorted(_DTYPES), default="bf16")
    parser.add_argument("--taski", type=int, default=None)
    parser.add_argument("--int8", action="store_true",
                        help="export the w8a8 model (serve.quantize_int8): calibrate on "
                             "--calib_data (default: the config's first valid_datas), "
                             "quantize, and export the int8 graph")
    parser.add_argument("--calib_data", default=None,
                        help="LMDB root whose <lan_list[0]> subdir feeds int8 calibration")
    parser.add_argument("--device", default=None, help="default: the CUDA card")
    args = parser.parse_args(argv)

    opt = load_config(args.config)
    np.random.seed(opt.manual_seed)
    last_task = args.taski if args.taski is not None else len(opt.lan_list) - 1
    if args.int8 and opt.il in ("mrn", "der") and last_task > 0:
        parser.error("--int8 supports single-recognizer models (the composite MRN/DER "
                     "eval paths stay float)")
    if args.int8 and not args.calib_data and not opt.get("valid_datas"):
        parser.error("--int8 needs calibration data: pass --calib_data (the config has "
                     "no valid_datas)")
    learner = load_learner(opt, args.saved_model, last_task, device=args.device)
    if args.int8:
        calib_root = args.calib_data or opt.valid_datas[0]
        calib_loader = ValDataset([os.path.join(calib_root, opt.lan_list[0])],
                                  opt).create_dataset()
        quantize_learner_int8(learner, opt, calib_loader)
        print("# int8: calibrated + quantized (w8a8) before export")

    program, shape = export_inference(learner, opt, args.batch_size, args.dtype)
    torch.export.save(program, args.out)
    print(f"wrote {args.out}: {os.path.getsize(args.out)} bytes, output float32 {list(shape)}")
    return args.out, shape


if __name__ == "__main__":
    main()
