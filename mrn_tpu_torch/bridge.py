"""Weight bridge: the JAX package's flax variable trees (as numpy arrays, or
anything ``np.asarray`` takes) -> the port's ``state_dict``.

The port's modules carry the flax names, so the bridge only flattens the
tree to dotted paths and applies three rules:

- ``blocks<s>_<i>`` -> ``blocks<s>.<i>`` (SVTR stages are ``ModuleList``s);
- a 4-D conv ``kernel`` (flax HWIO) -> ``weight`` in OIHW;
- ``batch_stats`` leaves (BN ``mean``/``var``) land beside the BN's
  ``scale``/``bias`` params.

Dense kernels stay ``[in, out]`` and LayerNorm/Block leaves keep their
names.  An MRN tree (``params["experts"]`` stacked on a leading expert axis,
plus the router subtrees ``dm_router``, ``channel_route`` and ``route``) is
unstacked into ``experts.<i>.``.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

__all__ = ["from_flax", "mrn_state", "recognizer_state"]

_BLOCK_RE = re.compile(r"\bblocks(\d)_(\d+)\b")


def _flatten(tree: Mapping, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            yield from _flatten(value, path + ".")
        else:
            yield path, value


def _leaf(path: str, value) -> Tuple[str, torch.Tensor]:
    arr = np.asarray(value)
    if arr.dtype.kind == "V" or str(arr.dtype) == "bfloat16":
        arr = arr.astype(np.float32)
    path = _BLOCK_RE.sub(r"blocks\1.\2", path)
    if path.endswith(".kernel") and arr.ndim == 4:
        path = path[:-len("kernel")] + "weight"
        arr = arr.transpose(3, 2, 0, 1)
    return path, torch.tensor(arr)


def recognizer_state(params: Mapping, batch_stats: Optional[Mapping] = None,
                     prefix: str = "") -> Dict[str, torch.Tensor]:
    """State dict of a port ``Recognizer`` from one Recognizer's trees."""
    state = {}
    for tree in (params, batch_stats or {}):
        for path, value in _flatten(tree, prefix):
            name, tensor = _leaf(path, value)
            state[name] = tensor
    return state


def mrn_state(params: Mapping, batch_stats: Optional[Mapping] = None
              ) -> Dict[str, torch.Tensor]:
    """State dict of a port ``MRNNet`` from the JAX ``MRNNet`` trees."""
    experts = params["experts"]
    expert_stats = (batch_stats or {}).get("experts", {})
    n = len(np.asarray(experts["fc"]["kernel"]))

    def take(tree, i):
        return {k: take(v, i) if isinstance(v, Mapping) else np.asarray(v)[i]
                for k, v in tree.items()}

    state = {}
    for i in range(n):
        state.update(recognizer_state(take(experts, i), take(expert_stats, i),
                                      prefix=f"experts.{i}."))
    for key in ("dm_router", "channel_route", "route"):
        state.update(recognizer_state({key: params[key]}))
    return state


def from_flax(params: Mapping, batch_stats: Optional[Mapping] = None
              ) -> Dict[str, torch.Tensor]:
    """``mrn_state`` for an MRN tree (has ``experts``), else
    ``recognizer_state``."""
    if "experts" in params:
        return mrn_state(params, batch_stats)
    return recognizer_state(params, batch_stats)
