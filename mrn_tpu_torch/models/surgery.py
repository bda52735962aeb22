"""Parameter surgery on flax-layout numpy params trees (the port's copy of
``mrn_tpu/models/surgery.py``).

``apply_reference_init`` is the reference's task-0 init pass:
kaiming-normal (fan in, ``std = sqrt(2 / fan_in)``) for every weight-like
leaf, zeros for biases, ones for norm scales; ``localization_fc2`` (the TPS
fiducial regressor) and other leaves such as ``pos_embed`` are left as
they are.

Fan-in follows each leaf's layout: a flax Dense ``kernel`` [in, out] reads
``shape[0]``, a conv ``kernel`` [kh, kw, in, out] ``kh * kw * in``; the
torch-layout ``w_ih``, ``w_hh`` and ``char_embeddings`` read ``shape[1]``.
Leaves under a subtree named in ``stacked`` carry a leading stack axis, and
their fan-in is read per slice.

The task-boundary rules of the other learners (flax Dense kernels are
``[in, out]``, so output units are columns):

- ``grow_fc``: the old fc's output columns and bias entries first in a
  fresh larger fc;
- ``grow_fc_der``: DER's form, the input rows grew as well (old weights in
  the leading rows and columns);
- ``weight_align``: WA's rescale of the newest ``increment`` columns by
  ``gamma`` = the old columns' mean norm over the new columns' (norms per
  output unit over the input axis); the bias is left alone;
- ``reset_fc``: a fresh fc in torch's Linear defaults (and, with
  ``prediction_path``, a fresh Attn decoder); no learner calls it;
- ``count_params``.

The draws come from a numpy generator (the learner's ``weight_rng``), so
the random bits differ from JAX's; the rule applied to each leaf is the
same.
"""

from __future__ import annotations

import math
from typing import Mapping, Optional, Sequence, Tuple

import numpy as np

__all__ = ["apply_reference_init", "count_params", "grow_fc", "grow_fc_der",
           "kaiming_std", "reset_fc", "weight_align"]

# leaf names in torch's [out, in] layout (fan_in = shape[1])
_TORCH_LAYOUT_WEIGHTS = ("w_ih", "w_hh", "char_embeddings")


def kaiming_std(path: Sequence[str], shape: Tuple[int, ...]) -> Optional[float]:
    """The kaiming std of the leaf at ``path`` (key names, root first) with
    per-slice ``shape``, or ``None`` when the pass leaves it to the other
    rules."""
    name = path[-1]
    if name.endswith("kernel"):
        if len(shape) == 2:
            fan_in = shape[0]
        else:
            fan_in = shape[-2] * int(np.prod(shape[:-2]))
    elif name in _TORCH_LAYOUT_WEIGHTS:
        fan_in = shape[1]
    else:
        return None
    return math.sqrt(2.0 / max(1, fan_in))


def apply_reference_init(params: Mapping, rng: np.random.Generator,
                         stacked: Tuple[str, ...] = ()) -> dict:
    """A new tree with the pass applied; draws leaf by leaf in sorted key
    order from ``rng``."""

    def walk(node, path):
        if isinstance(node, Mapping):
            return {k: walk(node[k], path + (str(k),)) for k in sorted(node)}
        leaf = np.asarray(node)
        if any("localization_fc2" in p for p in path):
            return leaf
        name = path[-1]
        shape = leaf.shape[1:] if any(p in stacked for p in path) else leaf.shape
        std = kaiming_std(path, shape)
        if std is not None:
            return (std * rng.standard_normal(leaf.shape)).astype(leaf.dtype)
        if name.endswith("bias") or name in ("b_ih", "b_hh"):
            return np.zeros_like(leaf)
        if name.endswith("scale"):
            return np.ones_like(leaf)
        return leaf

    return walk(params, ())


def _get_path(tree: Mapping, path: Tuple[str, ...]):
    for key in path:
        tree = tree[key]
    return tree


def _set_path(tree: Mapping, path: Tuple[str, ...], value) -> dict:
    if not path:
        return value
    out = dict(tree)
    out[path[0]] = _set_path(tree[path[0]], path[1:], value)
    return out


def grow_fc(new_params: Mapping, old_params: Mapping, path: Tuple[str, ...] = ("fc",)) -> dict:
    """``new_params`` with the old fc's columns and bias entries copied
    into the leading output units of its (larger) fc."""
    new_fc = {k: np.array(v) for k, v in _get_path(new_params, path).items()}
    old_fc = _get_path(old_params, path)
    old_out = np.shape(old_fc["kernel"])[1]
    new_fc["kernel"][:, :old_out] = old_fc["kernel"]
    new_fc["bias"][:old_out] = old_fc["bias"]
    return _set_path(new_params, path, new_fc)


def grow_fc_der(new_params: Mapping, old_params: Mapping, out_dim: int,
                path: Tuple[str, ...] = ("fc",)) -> dict:
    """DER's growth: the fc input grew by ``out_dim`` too; the old kernel
    fills the leading input rows and output columns."""
    del out_dim  # the old kernel's own shape says where it goes
    new_fc = {k: np.array(v) for k, v in _get_path(new_params, path).items()}
    old_fc = _get_path(old_params, path)
    old_in, old_out = np.shape(old_fc["kernel"])
    new_fc["kernel"][:old_in, :old_out] = old_fc["kernel"]
    new_fc["bias"][:old_out] = old_fc["bias"]
    return _set_path(new_params, path, new_fc)


def weight_align(params: Mapping, increment: int, path: Tuple[str, ...] = ("fc",)
                 ) -> Tuple[dict, float]:
    """WA's align; returns ``(params, gamma)``."""
    fc = {k: np.array(v) for k, v in _get_path(params, path).items()}
    kernel = fc["kernel"]   # [in, out]
    new_norm = np.linalg.norm(kernel[:, -increment:], axis=0)
    old_norm = np.linalg.norm(kernel[:, :-increment], axis=0)
    gamma = np.float32(old_norm.mean() / new_norm.mean())
    kernel[:, -increment:] *= gamma
    return _set_path(params, path, fc), float(gamma)


def _torch_uniform(rng: np.random.Generator, shape, fan_in: int) -> np.ndarray:
    bound = 1.0 / math.sqrt(max(1, fan_in))
    return rng.uniform(-bound, bound, shape).astype(np.float32)


def reset_fc(params: Mapping, rng: np.random.Generator, path: Tuple[str, ...] = ("fc",),
             prediction_path: Optional[Tuple[str, ...]] = None) -> dict:
    """A fresh fc of the same shape in torch's Linear defaults (kernel and
    bias ``U(+-1/sqrt(fan_in))``); with ``prediction_path`` (e.g.
    ``("prediction",)``) that subtree too, leaf by leaf in sorted order:
    Dense kernels and biases the same way, ``char_embeddings`` ``N(0, 1)``,
    the LSTM-cell gates (``w_*``, ``b_*``, [4H, ...]) ``U(+-1/sqrt(H))``."""
    fc = dict(_get_path(params, path))
    fan_in = np.shape(fc["kernel"])[0]
    fc["kernel"] = _torch_uniform(rng, np.shape(fc["kernel"]), fan_in)
    if "bias" in fc:
        fc["bias"] = _torch_uniform(rng, np.shape(fc["bias"]), fan_in)
    params = _set_path(params, path, fc)
    if prediction_path is None:
        return params

    def reinit(tree: Mapping) -> dict:
        out = {}
        for name in sorted(tree):
            leaf = tree[name]
            if isinstance(leaf, Mapping) and "kernel" in leaf:
                dense = dict(leaf)
                fan = np.shape(leaf["kernel"])[0]
                dense["kernel"] = _torch_uniform(rng, np.shape(leaf["kernel"]), fan)
                if "bias" in leaf:
                    dense["bias"] = _torch_uniform(rng, np.shape(leaf["bias"]), fan)
                out[name] = dense
            elif isinstance(leaf, Mapping):
                out[name] = reinit(leaf)
            elif name == "char_embeddings":
                out[name] = rng.standard_normal(np.shape(leaf)).astype(np.float32)
            elif name.startswith(("w_", "b_")):
                out[name] = _torch_uniform(rng, np.shape(leaf), np.shape(leaf)[0] // 4)
            else:
                out[name] = leaf
        return out

    return _set_path(params, prediction_path, reinit(_get_path(params, prediction_path)))


def count_params(params: Mapping) -> int:
    """The number of scalars in a params tree."""
    if isinstance(params, Mapping):
        return sum(count_params(v) for v in params.values())
    return int(np.prod(np.shape(params)))
