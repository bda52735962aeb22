"""Plain-text experiment logs, the same text as the JAX package's
(``mrn_tpu/utils/logging.py``): the per-experiment ``log_train.txt`` and
the append-only data log shared by experiments.  Lines go to the files
only, as the JAX learners write them (``echo_logs`` unset)."""

from __future__ import annotations

import os

__all__ = ["ExperimentLog"]


class ExperimentLog:
    def __init__(self, exp_name: str, output_dir: str = "./saved_models",
                 data_log: str = "./data_any.txt"):
        self.exp_name = exp_name
        self.exp_dir = os.path.join(output_dir, exp_name)
        os.makedirs(self.exp_dir, exist_ok=True)
        self.train_log_path = os.path.join(self.exp_dir, "log_train.txt")
        self.data_log_path = data_log

    def write(self, line: str) -> None:
        with open(self.train_log_path, "a", encoding="utf-8") as f:
            f.write(line)

    def write_data_log(self, line: str) -> None:
        with open(self.data_log_path, "a+", encoding="utf-8") as f:
            f.write(line)
