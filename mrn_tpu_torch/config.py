"""Config system: loads reference-style Python config files (dicts named
``common`` / ``model`` / ``optimizer`` / ``train`` [+ ``test``]) and flattens
them into one options namespace, so ``configs/*.py`` work unchanged.

The port's own copy of ``mrn_tpu/config.py`` (the port imports nothing from
the JAX package).  Config files are plain Python modules executed in an
isolated namespace.
"""

from __future__ import annotations

import copy
import runpy
import types
from typing import Any, Dict, List, Optional

__all__ = ["Options", "load_config", "default_options"]

_SECTION_ORDER = ("common", "model", "train", "optimizer")


class Options(types.SimpleNamespace):
    """Flat options namespace (the reference's ``opt``)."""

    def replace(self, **kw) -> "Options":
        new = copy.deepcopy(vars(self))
        new.update(kw)
        return Options(**new)

    def get(self, key: str, default: Any = None) -> Any:
        return vars(self).get(key, default)


# Defaults covering the full public config surface (same values as the JAX
# package's mrn_tpu/config.py).
_DEFAULTS: Dict[str, Any] = dict(
    # common
    exp_name="exp",
    il="base",
    memory=None,
    memory_num=2000,
    batch_max_length=25,
    imgH=32,
    imgW=256,
    manual_seed=111,
    start_task=0,
    # model
    model_name="CRNN",
    Transformation="None",
    FeatureExtraction="VGG",
    SequenceModeling="BiLSTM",
    Prediction="CTC",
    num_fiducial=20,
    input_channel=4,
    output_channel=512,
    hidden_size=256,
    # optimizer
    schedule="super",
    optimizer="adam",
    lr=0.0005,
    sgd_momentum=0.9,
    sgd_weight_decay=0.000001,
    milestones=[2000, 4000],
    lrate_decay=0.1,
    rho=0.95,
    eps=1e-8,
    lr_drop_rate=0.1,
    # train
    saved_model="",
    Aug="None",
    workers=0,
    lan_list=["Chinese", "Latin", "Japanese", "Korean", "Arabic", "Bangla"],
    valid_datas=[],
    select_data=[],
    batch_ratio="0.5-0.5",
    total_data_usage_ratio="1.0",
    NED=True,
    batch_size=256,
    num_iter=10000,
    val_interval=5000,
    log_multiple_test=None,
    grad_clip=5,
    # framework extensions (absent from the reference configs)
    compute_dtype="float32",     # "bfloat16" for serving throughput
    data_parallel=1,
    expert_parallel=1,
    router_labels="reference",
    mrn_pin_expert_stats=True,
    full_ckpt=False,
    resume_full=False,
    output_dir="./saved_models",
    data_log="./data_any.txt",
)


def default_options(**overrides) -> Options:
    merged = copy.deepcopy(_DEFAULTS)
    merged.update(overrides)
    return Options(**merged)


def load_config(path: str, extra_sections: Optional[List[str]] = None,
                **overrides) -> Options:
    """Execute a reference-style config file and flatten its section dicts.

    ``extra_sections`` may add e.g. ``["test"]``; ``overrides`` are applied
    last (CLI flags / tests).
    """
    ns = runpy.run_path(path)
    merged = copy.deepcopy(_DEFAULTS)
    explicit = set()
    sections = list(_SECTION_ORDER) + list(extra_sections or [])
    for section in sections:
        if section in ns and isinstance(ns[section], dict):
            merged.update(copy.deepcopy(ns[section]))
            explicit.update(ns[section].keys())
    merged.update(overrides)
    explicit.update(overrides)
    opt = Options(**merged)
    # keys the config file (or caller) actually set, vs. _DEFAULTS fallbacks
    opt.explicit_keys = frozenset(explicit)
    return opt
