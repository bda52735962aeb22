"""Incremental-learning strategies of the PyTorch port (MRN so far)."""

from __future__ import annotations

from mrn_tpu_torch.train.learners.mrn import MRN

__all__ = ["build_learner"]


def build_learner(opt, device=None):
    """The learner of ``opt.il``: the port's ``MRN`` for ``"mrn"``; the
    other strategies are not ported yet."""
    if opt.il == "mrn":
        return MRN(opt, device=device)
    raise NotImplementedError(f"il={opt.il!r}: the port has the MRN learner only "
                              "(ROADMAP.md §1 item 5)")
