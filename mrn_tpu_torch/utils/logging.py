"""Plain-text experiment logs, the same text as the JAX package's
(``mrn_tpu/utils/logging.py``): the per-experiment ``log_train.txt`` and
the append-only data log shared by experiments.  Lines go to the files
only, as the JAX learners write them (``echo_logs`` unset), and also to
stdout with ``echo`` (the training CLI's log, as JAX's ``train.py``).  In a
process group only rank 0 writes and echoes (``parallel.mesh.is_main``)."""

from __future__ import annotations

import os
import sys

from mrn_tpu_torch.parallel import mesh

__all__ = ["ExperimentLog"]


class ExperimentLog:
    def __init__(self, exp_name: str, output_dir: str = "./saved_models",
                 data_log: str = "./data_any.txt", echo: bool = False):
        self.exp_name = exp_name
        self.echo = echo
        self.exp_dir = os.path.join(output_dir, exp_name)
        os.makedirs(self.exp_dir, exist_ok=True)
        self.train_log_path = os.path.join(self.exp_dir, "log_train.txt")
        self.data_log_path = data_log

    def write(self, line: str) -> None:
        if not mesh.is_main():
            return
        with open(self.train_log_path, "a", encoding="utf-8") as f:
            f.write(line)
        if self.echo:
            sys.stdout.write(line)
            sys.stdout.flush()

    def write_data_log(self, line: str) -> None:
        if not mesh.is_main():
            return
        with open(self.data_log_path, "a+", encoding="utf-8") as f:
            f.write(line)
