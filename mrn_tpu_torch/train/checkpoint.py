"""Checkpoint files in the JAX package's format (the port's copy of
``mrn_tpu/train/checkpoint.py``, on ``train.msgpack_codec`` in place of
flax and msgpack).

Best-score snapshots per (language, task[, step]) live at
``{output_dir}/{exp_name}/{lan}_{taski}[_{step}]_best_score.msgpack``;
rolling full-state snapshots beside them as ``..._train_state.msgpack``.
A payload is a tree of numpy arrays (torch tensors are moved to numpy on
the way out), bytes equal to what the JAX package writes for the same
trees, so each side reads the other's files.

An MRN best checkpoint references its frozen experts by content hash:
``expert_refs`` names blobs ``experts/{ref}.msgpack`` beside it, each one
expert's ``params`` / ``batch_stats`` plus its ``class_count``; older files
hold the experts inline (``experts``).  ``composite_experts`` reads both.

In a process group only rank 0 writes (``parallel.mesh.is_main``); the
learners wait at a barrier before they read a file back.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, List, Mapping, Optional, Tuple

import numpy as np
import torch

from mrn_tpu_torch.parallel import mesh
from mrn_tpu_torch.train.msgpack_codec import msgpack_restore, msgpack_serialize

__all__ = ["best_model_path", "composite_experts", "deep_merge", "load_model",
           "load_train_state", "prune_named_subtrees", "save_model",
           "save_train_state", "train_state_path"]


def best_model_path(output_dir: str, exp_name: str, lan: str, taski: int,
                    step: Optional[int] = None) -> str:
    suffix = f"_{step}" if step is not None else ""
    return os.path.join(output_dir, exp_name,
                        f"{lan}_{taski}{suffix}_best_score.msgpack")


def save_model(path: str, params: Any, batch_stats: Any,
               extra: Optional[dict] = None) -> int:
    """Writes ``{"params", "batch_stats", **extra}``; returns the bytes
    written (0 on a rank other than 0, which writes nothing)."""
    if not mesh.is_main():
        return 0
    os.makedirs(os.path.dirname(path), exist_ok=True)
    payload = {"params": params, "batch_stats": batch_stats}
    if extra:
        payload.update(extra)
    data = msgpack_serialize(payload)
    with open(path, "wb") as f:
        f.write(data)
    return len(data)


def _check_like(template, tree, path: str = "") -> None:
    """``tree`` has ``template``'s keys and, leaf for leaf, its shapes and
    dtypes (flax's ``from_state_dict`` over dicts of arrays)."""
    if isinstance(template, Mapping):
        if not isinstance(tree, Mapping) or set(template) != set(tree):
            have = sorted(tree) if isinstance(tree, Mapping) else type(tree).__name__
            raise ValueError(f"checkpoint at {path or '/'}: keys {have}, "
                             f"expected {sorted(template)}")
        for k in template:
            _check_like(template[k], tree[k], f"{path}/{k}")
        return
    if isinstance(template, (np.ndarray, torch.Tensor)):
        want = (tuple(template.shape), str(template.dtype).replace("torch.", ""))
        have = (tuple(getattr(tree, "shape", ())),
                str(getattr(tree, "dtype", type(tree).__name__)).replace("torch.", ""))
        if want != have:
            raise ValueError(f"checkpoint leaf {path}: shape/dtype {have}, expected {want}")


def load_model(path: str, template: Optional[dict] = None) -> dict:
    """The payload of ``path``; with ``template``, the template's entries of
    it, their keys, shapes and dtypes checked against the template's."""
    with open(path, "rb") as f:
        payload = msgpack_restore(f.read())
    if template is not None:
        payload = {k: payload.get(k) for k in template}
        _check_like(template, payload)
    return payload


def composite_experts(payload: Mapping, expert_dir: str
                      ) -> Tuple[List[dict], List[dict], Optional[List[str]]]:
    """An MRN best payload's frozen experts ``(params list, batch_stats
    list, refs)``: the blob layout (``expert_refs`` resolved under
    ``expert_dir``; stats the payload carries supersede the blobs') or the
    legacy inline ``experts`` list (refs ``None``)."""
    if payload.get("expert_refs"):
        refs = [r.decode() if isinstance(r, bytes) else str(r)
                for r in payload["expert_refs"]]
        blobs = [load_model(os.path.join(expert_dir, f"{ref}.msgpack")) for ref in refs]
        params = [b["params"] for b in blobs]
        stats = [b["batch_stats"] for b in blobs]
        if payload.get("expert_stats"):
            stats = list(payload["expert_stats"])
        return params, stats, refs
    return list(payload.get("experts", [])), list(payload.get("expert_stats", [])), None


# ---------------------------------------------------------------- full state
def train_state_path(output_dir: str, exp_name: str, lan: str, taski: int,
                     step: Optional[int] = None) -> str:
    suffix = f"_{step}" if step is not None else ""
    return os.path.join(output_dir, exp_name,
                        f"{lan}_{taski}{suffix}_train_state.msgpack")


def save_train_state(path: str, *, params: Any, batch_stats: Any,
                     opt_state: Any, iteration: int, rng_key: Any,
                     host_state: dict, extra: Optional[dict] = None) -> None:
    """Atomic (write, then rename) rolling snapshot of the full training
    state.  ``opt_state`` is a state-dict tree; ``host_state`` any picklable
    dict (numpy Generator state, memory indices, ...), stored pickled.
    Rank 0 alone writes."""
    if not mesh.is_main():
        return
    os.makedirs(os.path.dirname(path), exist_ok=True)
    payload = {"params": params, "batch_stats": batch_stats, "opt_state": opt_state,
               "iteration": iteration, "rng_key": rng_key}
    if extra:
        payload.update(extra)
    payload["host_state"] = pickle.dumps(host_state)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(msgpack_serialize(payload))
    os.replace(tmp, path)


def prune_named_subtrees(state_dict: dict, name: str) -> dict:
    """A copy of a nested state dict without any subtree keyed ``name``."""
    return {k: prune_named_subtrees(v, name) if isinstance(v, dict) else v
            for k, v in state_dict.items() if k != name}


def deep_merge(base: dict, overlay: dict) -> dict:
    """Overlay a partial nested state dict onto a template, in place."""
    for k, v in overlay.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            deep_merge(base[k], v)
        else:
            base[k] = v
    return base


def load_train_state(path: str) -> dict:
    """The payload of a ``save_train_state`` file, ``host_state`` unpickled
    (only files this program or the JAX package wrote: unpickling runs
    code) and ``iteration`` an int."""
    with open(path, "rb") as f:
        payload = msgpack_restore(f.read())
    payload["host_state"] = pickle.loads(payload["host_state"])
    payload["iteration"] = int(payload["iteration"])
    return payload
