"""The joint learner, the non-incremental upper bound (mirrors
``mrn_tpu/train/learners/joint.py``): one training run on every task's
characters over the stream ``DatasetManager.joint_start`` built
(``joint_mix``: one loader over all tasks; ``joint_loader``: one loader
of ``batch_size // tasks`` per task), validated at every interval on the
all-task set and, after iteration 1, scored on every task by ``test``,
whose scores ``incremental_train`` returns.  ``test`` reloads the best
checkpoint; the loop goes on from the live parameters and statistics, as
the JAX loop keeps its own train state.
"""

from __future__ import annotations

import torch

from mrn_tpu_torch.train.learners.base import BaseLearner

__all__ = ["JointLearner"]


class JointLearner(BaseLearner):

    def incremental_train(self, taski, character, train_loader, valid_loader,
                          valid_datas=None, val_dataset_builder=None):
        self._cur_task = taski
        self.character = list(character)
        self.converter = self.build_converter()
        valid = valid_loader.create_list_dataset(valid_datas=valid_datas)
        if taski > 0:
            self.change_model()
        else:
            self.build_model()
        self.count_param()
        self.build_optimizer()
        self._joint_valid_datas = valid_datas
        self._joint_val_builder = val_dataset_builder
        self._joint_scores = ([], [])
        self._init_train(taski, train_loader, valid)
        return self._joint_scores

    def _init_train(self, taski, train_loader, valid_loader):
        best_scores, ned_scores = self._joint_scores

        def val_hook(valid, iteration, train_loss_avg, start_time):
            self.val(valid, self.opt, self.best_score, start_time, iteration,
                     train_loss_avg, taski)
            if iteration != 1 and self._joint_val_builder is not None:
                live = {k: v.clone() for k, v in self.model.state_dict().items()}
                self.test(self._joint_valid_datas, best_scores, ned_scores, taski,
                          val_dataset_builder=self._joint_val_builder)
                with torch.no_grad():
                    self.model.load_state_dict(live, strict=True)

        self._run_loop(taski, train_loader, valid_loader, val_hook=val_hook)
