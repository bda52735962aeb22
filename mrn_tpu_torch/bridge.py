"""Weight bridge between the JAX package's flax variable trees (as numpy
arrays, or anything ``np.asarray`` takes) and the port's ``state_dict``s,
both ways.

The port's modules carry the flax names, so the bridge only flattens the
tree to dotted paths and applies three rules:

- ``blocks<s>_<i>`` -> ``blocks<s>.<i>`` (SVTR stages are ``ModuleList``s);
- a 4-D conv ``kernel`` (flax HWIO) -> ``weight`` in OIHW;
- ``batch_stats`` leaves (BN ``mean``/``var``) land beside the BN's
  ``scale``/``bias`` params.

Dense kernels stay ``[in, out]`` and LayerNorm/Block leaves keep their
names.  A TRBA tree needs no further rule: its convs are the JAX package's
``TorchConv``, whose flax child ``Conv_0`` the port names alike
(``conv0.Conv_0.kernel`` -> ``conv0.Conv_0.weight``); the LSTM leaves
(``rnn.fwd``/``rnn.bwd`` and the attention cell's ``w_ih``, ``w_hh``,
``b_ih``, ``b_hh``) are in torch's layout already; ``localization_fc2``
(a flax ``nn.Dense``), the cell's ``i2h``/``h2h``/``score`` and
``prediction.char_embeddings`` keep their layouts.

An MRN tree (``params["experts"]`` stacked on a leading expert axis, plus
the router subtrees ``dm_router``, ``channel_route`` and ``route``) is
unstacked into ``experts.<i>.``; ``routed_state`` assembles the same layout
from an expert list (each fc, and an Attn expert's char_embeddings,
zero-padded to the current class count) plus a router tree, as the JAX
learner's ``_routed_variables`` does.

A DER tree (``params["extractors"]`` and ``batch_stats["extractors"]``
stacked on a leading axis, the JAX ``extractor_stack``, plus ``fc`` over
the concatenated features and ``aux_fc``) is unstacked into
``extractors.<i>.`` (``der_state``), the port ``DERNet``'s ``ModuleList``.

``to_flax`` goes back: a port module's parameters and buffers as numpy
``(params, batch_stats)`` trees in the JAX layout (MRN experts and DER
extractors stacked), so
tests can hold updated weights and statistics against the JAX package's
leaf by leaf.

A w8a8 recognizer (``quant="int8"``) also has the JAX ``quant`` collection:
per Block ``act_amax_*`` and ``w_scale_*`` (float32), with its projection
kernels int8 in ``params``.  ``from_flax(params, batch_stats, quant)`` loads
it; ``to_flax`` puts the int8 kernels back into ``params`` and
``quant_tree`` gives the collection (a ``quant="calib"`` model's recorded
amaxes too).
"""

from __future__ import annotations

import re
from typing import (Any, Dict, Iterable, Iterator, Mapping, Optional,
                    Sequence, Tuple)

import numpy as np
import torch
from torch import nn

from mrn_tpu_torch.models.svtr import is_quant_scale

__all__ = ["der_state", "flax_tree", "from_flax", "mrn_state", "pad_expert_state",
           "quant_tree", "recognizer_state", "routed_state", "state_to_flax", "to_flax"]

# subtrees stacked on a leading axis in the JAX layout, a ModuleList here
STACKED = ("experts", "extractors")

_BLOCK_RE = re.compile(r"\bblocks(\d)_(\d+)\b")
_PORT_BLOCK_RE = re.compile(r"\bblocks(\d)\.(\d+)\b")


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


def _unstacked(params: Mapping, batch_stats: Optional[Mapping], key: str
               ) -> Dict[str, torch.Tensor]:
    """The ``<key>.<i>.`` entries of the subtree stacked under ``key``."""
    stack = params[key]
    stack_stats = (batch_stats or {}).get(key, {})
    n = len(np.asarray(next(v for _, v in _flatten(stack))))

    def take(tree, i):
        return {k: take(v, i) if isinstance(v, Mapping) else np.asarray(v)[i]
                for k, v in tree.items()}

    state = {}
    for i in range(n):
        state.update(recognizer_state(take(stack, i), take(stack_stats, i),
                                      prefix=f"{key}.{i}."))
    return state


def mrn_state(params: Mapping, batch_stats: Optional[Mapping] = None
              ) -> Dict[str, torch.Tensor]:
    """State dict of a port ``MRNNet`` from the JAX ``MRNNet`` trees."""
    state = _unstacked(params, batch_stats, "experts")
    for key in ("dm_router", "channel_route", "route"):
        state.update(recognizer_state({key: params[key]}))
    return state


def der_state(params: Mapping, batch_stats: Optional[Mapping] = None
              ) -> Dict[str, torch.Tensor]:
    """State dict of a port ``DERNet`` (or of DER optimizer moments) from
    JAX ``DERNet`` trees: ``extractors`` unstacked, the rest as it is."""
    state = _unstacked(params, batch_stats, "extractors")
    state.update(recognizer_state({k: v for k, v in params.items() if k != "extractors"},
                                  {k: v for k, v in (batch_stats or {}).items()
                                   if k != "extractors"}))
    return state


def from_flax(params: Mapping, batch_stats: Optional[Mapping] = None,
              quant: Optional[Mapping] = None) -> Dict[str, torch.Tensor]:
    """``mrn_state`` for an MRN tree (has ``experts``), ``der_state`` for a
    DER tree (has ``extractors``), else ``recognizer_state``; ``quant`` (a
    w8a8 recognizer's ``quant`` collection) lands beside the params."""
    if "extractors" in params:
        return der_state(params, batch_stats)
    if "experts" in params:
        if quant:
            raise ValueError("a quant collection belongs to a single recognizer; "
                             "the MRN ensemble serves float only")
        return mrn_state(params, batch_stats)
    state = recognizer_state(params, batch_stats)
    state.update(recognizer_state(quant or {}))
    return state


def pad_expert_state(state: Mapping[str, torch.Tensor], num_classes: int
                     ) -> Dict[str, torch.Tensor]:
    """One expert's state with its ``fc`` and, for an Attn expert, its
    ``prediction.char_embeddings`` rows zero-padded to ``num_classes`` (the
    JAX package's ``pad_expert_tree``; padded logit columns are later
    overwritten by MRNNet's ones-padding, and the decoder never embeds an
    id at or past its class count)."""
    out = dict(state)
    kernel, bias = state["fc.kernel"], state["fc.bias"]
    pad = num_classes - kernel.shape[1]
    if pad > 0:
        out["fc.kernel"] = torch.nn.functional.pad(kernel, (0, pad))
        out["fc.bias"] = torch.nn.functional.pad(bias, (0, pad))
    emb = state.get("prediction.char_embeddings")
    if emb is not None and num_classes > emb.shape[0]:
        out["prediction.char_embeddings"] = torch.nn.functional.pad(
            emb, (0, 0, 0, num_classes - emb.shape[0]))
    return out


def routed_state(expert_states: Sequence[Mapping[str, torch.Tensor]],
                 router: Mapping, num_classes: int) -> Dict[str, torch.Tensor]:
    """State dict of a port ``MRNNet`` from per-expert Recognizer states
    (unpadded) and a flax router tree (``dm_router``, ``channel_route``,
    ``route``)."""
    state = {}
    for i, expert in enumerate(expert_states):
        for key, value in pad_expert_state(expert, num_classes).items():
            state[f"experts.{i}.{key}"] = value
    for key in ("dm_router", "channel_route", "route"):
        state.update(recognizer_state({key: router[key]}))
    return state


def _nest(tree: Dict, path: str, value: np.ndarray) -> None:
    *heads, last = path.split(".")
    for key in heads:
        tree = tree.setdefault(key, {})
    tree[last] = value


def _flax_leaf(name: str, tensor: torch.Tensor) -> Tuple[str, np.ndarray]:
    t = tensor.detach()
    if t.is_floating_point():
        t = t.float()
    arr = t.cpu().numpy().copy()  # never a view of the tensor
    name = _PORT_BLOCK_RE.sub(r"blocks\1_\2", name)
    if name.endswith(".weight") and arr.ndim == 4:
        name = name[:-len("weight")] + "kernel"
        arr = arr.transpose(2, 3, 1, 0)
    return name, arr


def flax_tree(named: Iterable[Tuple[str, torch.Tensor]]) -> Dict:
    """Port-named tensors (``named_parameters()``, ``named_buffers()``, or a
    dict's items, e.g. gradients) -> one numpy tree (floats as float32,
    int8 kernels as int8) in the JAX layout; ``experts.<i>.`` and
    ``extractors.<i>.`` entries are stacked on axis 0 under ``experts`` and
    ``extractors``."""
    tree: Dict = {}
    stacked: Dict[str, Dict[int, np.ndarray]] = {}
    for name, tensor in named:
        path, arr = _flax_leaf(name, tensor)
        head = path.split(".", 1)[0]
        if head in STACKED:
            _, index, rest = path.split(".", 2)
            stacked.setdefault(f"{head}.{rest}", {})[int(index)] = arr
        else:
            _nest(tree, path, arr)
    for path, per_index in stacked.items():
        _nest(tree, path, np.stack([per_index[i] for i in sorted(per_index)]))
    return tree


def to_flax(module: nn.Module) -> Tuple[Dict, Dict]:
    """``(params, batch_stats)`` numpy trees of a port Recognizer, MRNNet or
    DERNet in the JAX layout (a w8a8 model's int8 kernels in ``params``; its quant
    scales are ``quant_tree``'s)."""
    buffers = [(k, t) for k, t in module.named_buffers() if not is_quant_scale(k)]
    params = list(module.named_parameters()) + [(k, t) for k, t in buffers
                                                if t.dtype == torch.int8]
    stats = [(k, t) for k, t in buffers if t.dtype != torch.int8]
    return flax_tree(params), flax_tree(stats)


def state_to_flax(state: Mapping[str, torch.Tensor]) -> Tuple[Dict, Dict]:
    """``to_flax`` of a float Recognizer given as its state dict (a frozen
    expert): the BatchNorm ``mean``/``var`` leaves are its batch_stats."""
    stats = {k for k in state if k.rsplit(".", 1)[-1] in ("mean", "var")}
    return (flax_tree((k, v) for k, v in state.items() if k not in stats),
            flax_tree((k, state[k]) for k in stats))


def quant_tree(module: nn.Module) -> Dict:
    """The JAX ``quant`` collection of a ``quant="calib"`` or ``"int8"``
    model (numpy float32; empty for a float model)."""
    return flax_tree((k, t) for k, t in module.named_buffers() if is_quant_scale(k))
