"""Holds the port's augmentations to the committed fixtures of
``scripts/make_torch_augment_fixtures.py`` (``tests/fixtures/torch_augment/``:
word-crop PNGs and ``expected.npz`` with Pillow's, OpenCV's and the JAX
package's outputs), without either library: ``check(folder)`` runs every
op and chain on the crops and compares.

Every array must match bit for bit, except (ROADMAP.md §3):

- the CUBIC warps and resizes: at most 1 in 255 on at most 0.1% of values;
- the ABINet chain, which runs them and carries their differences through
  its jitter and final resize: at most 8 in 255 on at most 0.5%;
- a ``minAreaRect`` box, whose corners may land one pixel off where two
  sides bound rectangles of equal area.

A shape that differs is a failure.  ``chip_smoke.py`` runs this on the
machine with the card (its own g++ build of ``csrc/augment.cpp``);
``tests/test_torch_augment_fixtures.py`` on the CPU.
"""

from __future__ import annotations

import os
import random
from typing import Dict, List, Tuple

import numpy as np

from mrn_tpu_torch.config import default_options
from mrn_tpu_torch.data import augment as ops
from mrn_tpu_torch.data import image as image_codec
from mrn_tpu_torch.data.transform import MoCoAugment, build_transform

__all__ = ["BOUNDS", "CHAINS", "SEEDS", "check", "chain_outputs", "load", "run_op"]

IMG_H, IMG_W = 32, 128
SEEDS = {"text": 5, "abinet": 6, "moco": 7}
CHAINS = {"text": "Blur5-Crop90-Rot15", "abinet": "ABINet", "moco": None}
# (levels of 255, share of values) a bounded array may differ by
BOUNDS = {"cubic": (1, 1e-3), "chain": (8, 5e-3), "box": (1, 1.0)}
_CUBIC = ("affine2", "perspective2", "resize_up2", "resize_down2")


def _motion_kernel(degree: int, angle: float) -> np.ndarray:
    m = ops.get_rotation_matrix_2d((degree // 2, degree // 2), angle, 1)
    kernel = np.zeros((degree, degree))
    kernel[degree // 2, :] = 1
    return ops.warp_kernel(kernel, m, (degree, degree))


def run_op(op: str, args: np.ndarray, img: np.ndarray) -> np.ndarray:
    """The port's output for fixture op ``op`` with ``args`` on ``img``."""
    if op == "blur":
        return ops.gaussian_blur(img, args[0])
    if op == "rotate":
        return ops.rotate(img, args[0])
    if op in ("brightness", "contrast", "color"):
        return getattr(ops, op)(img, args[0])
    if op == "hue":
        return ops.shift_hue(img, args[0])
    if op.startswith("affine"):
        return ops.warp_affine(img, args[:6].reshape(2, 3), (int(args[6]), int(args[7])),
                               int(op[-1]))
    if op.startswith("perspective"):
        return ops.warp_perspective(img, args[:9].reshape(3, 3), (int(args[9]), int(args[10])),
                                    int(op[-1]))
    if op.startswith("boxpoints"):
        return ops.box_points(ops.min_area_rect(args.reshape(4, 2))).astype(np.int64)
    if op.startswith("resize_up"):
        return ops.resize(img, (int(args[0]), int(args[1])), int(op[-1]))
    if op.startswith("resize_down"):
        up = ops.resize(img, (int(args[0]), int(args[1])), int(op[-1]))
        return ops.resize(ops.pyr_down(ops.pyr_down(up)), (int(args[2]), int(args[3])),
                          int(op[-1]))
    if op == "pyrdown":
        return ops.pyr_down(img)
    if op == "kernel":
        return _motion_kernel(int(args[0]), float(args[1]))
    if op == "filter2d":
        degree = int(args[0])
        return ops.filter2d(img, _motion_kernel(degree, float(args[1])) / degree)
    raise ValueError(f"unknown fixture op {op!r}")


def load(folder: str) -> Tuple[List[str], Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """(crop names in order, {name: decoded RGBA}, expected arrays)."""
    names = sorted(n for n in os.listdir(folder) if n.endswith(".png"))
    crops = {}
    for name in names:
        with open(os.path.join(folder, name), "rb") as f:
            crops[name] = image_codec.decode(f.read())
    with np.load(os.path.join(folder, "expected.npz")) as z:
        expected = {k: z[k] for k in z.files}
    return names, crops, expected


def chain_outputs(names: List[str], crops: Dict[str, np.ndarray]) -> Dict[str, List]:
    """The port's three chains over the crops in order, each from its own
    generators seeded ``SEEDS[chain]``."""
    out = {}
    for chain, aug in CHAINS.items():
        rng, np_rng = random.Random(SEEDS[chain]), np.random.RandomState(SEEDS[chain])
        opt = default_options(Aug=aug or "None", imgH=IMG_H, imgW=IMG_W)
        if aug is None:
            moco = MoCoAugment(opt, rng)
            out[chain] = [np.stack(moco(crops[n])) for n in names]
        else:
            transform = build_transform(opt, "train", rng=rng, np_rng=np_rng)
            out[chain] = [transform(crops[n]) for n in names]
    return out


def _compare(key: str, got: np.ndarray, want: np.ndarray, bound: str) -> Tuple[bool, str]:
    if got.shape != want.shape:
        return False, f"{key}: shape {got.shape} against {want.shape}"
    if got.dtype != want.dtype:
        return False, f"{key}: dtype {got.dtype} against {want.dtype}"
    diff = np.abs(got.astype(np.float64) - want.astype(np.float64))
    n_diff = int((diff > 0).sum())
    if n_diff == 0:
        return True, ""
    note = f"{key}: {n_diff} of {diff.size} values differ, by up to {diff.max():g}"
    if bound:
        levels, share = BOUNDS[bound]
        if diff.max() <= levels and n_diff <= share * diff.size:
            return True, note + f" (within the {bound} bound)"
    return False, note


def check(folder: str) -> Dict[str, object]:
    """Every fixture op and chain against ``expected.npz``; returns
    ``{"arrays": n, "bitwise": n, "bounded": [notes], "failures": [notes]}``."""
    names, crops, expected = load(folder)
    result = {"arrays": 0, "bitwise": 0, "bounded": [], "failures": []}

    def record(key, got, want, bounded):
        ok, note = _compare(key, got, want, bounded)
        result["arrays"] += 1
        if ok and not note:
            result["bitwise"] += 1
        elif ok:
            result["bounded"].append(note)
        else:
            result["failures"].append(note)

    for key in sorted(k for k in expected if k.count(":") == 2):
        name, op, _ = key.split(":")
        got = run_op(op, expected[key + ":args"], crops[name])
        record(key, got, expected[key],
               "cubic" if op in _CUBIC else "box" if op.startswith("boxpoints") else "")
    for chain, outs in chain_outputs(names, crops).items():
        for name, got in zip(names, outs):
            record(f"{name}:{chain}", got, expected[f"{name}:{chain}"],
                   "chain" if chain == "abinet" else "")
    return result
