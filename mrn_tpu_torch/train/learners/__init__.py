"""Incremental-learning strategies of the PyTorch port."""

from __future__ import annotations

from mrn_tpu_torch.train.learners.base import BaseLearner

__all__ = ["BaseLearner", "build_learner"]


def build_learner(opt, device=None):
    """The learner of ``opt.il`` (``lwf``, ``wa``, ``ewc``, ``der``, ``mrn``,
    ``joint_mix`` / ``joint_loader``), ``BaseLearner`` for any other."""
    il = opt.il
    if il == "lwf":
        from mrn_tpu_torch.train.learners.lwf import LwF
        return LwF(opt, device=device)
    if il == "wa":
        from mrn_tpu_torch.train.learners.wa import WA
        return WA(opt, device=device)
    if il == "ewc":
        from mrn_tpu_torch.train.learners.ewc import EWC
        return EWC(opt, device=device)
    if il == "der":
        from mrn_tpu_torch.train.learners.der import DER
        return DER(opt, device=device)
    if il == "mrn":
        from mrn_tpu_torch.train.learners.mrn import MRN
        return MRN(opt, device=device)
    if il in ("joint_mix", "joint_loader"):
        from mrn_tpu_torch.train.learners.joint import JointLearner
        return JointLearner(opt, device=device)
    return BaseLearner(opt, device=device)
