"""The reference's task-0 init pass over a flax-layout numpy params tree (the
port of ``apply_reference_init`` in ``mrn_tpu/models/surgery.py``):
kaiming-normal (fan in, ``std = sqrt(2 / fan_in)``) for every weight-like
leaf, zeros for biases, ones for norm scales; ``localization_fc2`` (the TPS
fiducial regressor) and other leaves such as ``pos_embed`` are left as
they are.

Fan-in follows each leaf's layout: a flax Dense ``kernel`` [in, out] reads
``shape[0]``, a conv ``kernel`` [kh, kw, in, out] ``kh * kw * in``; the
torch-layout ``w_ih``, ``w_hh`` and ``char_embeddings`` read ``shape[1]``.
Leaves under a subtree named in ``stacked`` carry a leading stack axis, and
their fan-in is read per slice.

The draws come from a numpy generator, so the random bits differ from
JAX's; the rule applied to each leaf is the same.
"""

from __future__ import annotations

import math
from typing import Mapping, Optional, Sequence, Tuple

import numpy as np

__all__ = ["apply_reference_init", "kaiming_std"]

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
