"""The port's campaign entry point (``python3 -m mrn_tpu_torch.campaign``) at
``--smoke`` size on the CPU: 2 tasks of the synthetic suite, the narrow
SVTR, ``num_iter`` 4, batch 8.  The record has every field of the JAX
campaign's ``ACCURACY_RUNS/t6/svtr_mrn.json`` plus the device; a second
process with ``--start_task 1 --eval_from 1`` replays task 0 from its best
checkpoint and draws the same rehearsal memory.  Every strategy builds;
an Attn head and another backbone raise."""

import json
import os
import subprocess
import sys

import pytest
import torch

from mrn_tpu_torch import campaign
from mrn_tpu_torch.config import default_options
from mrn_tpu_torch.train.learners import build_learner

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--smoke", "--tasks", "2", "--num_iter", "4", "--batch_size", "8", "--device", "cpu"]

# a second process: the campaign, then the rehearsal memory its learner drew
REPLAY = """
import json, sys
from mrn_tpu_torch import campaign
made = []
build = campaign.build_learner
campaign.build_learner = lambda opt, device=None: made.append(build(opt, device)) or made[-1]
campaign.main(sys.argv[1:])
print("MEMORY " + json.dumps([ix.tolist() for ix in made[0].memory_index]))
"""


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch's CPU ops on one thread here: beside the other test workers,
    more threads oversubscribe the cores (these runs took 15x longer with
    8 threads in each of two processes)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_smoke_campaign_record_and_replay(tmp_path, monkeypatch):
    out = str(tmp_path / "t2")
    made = []
    build = campaign.build_learner
    monkeypatch.setattr(campaign, "build_learner",
                        lambda opt, device=None: made.append(build(opt, device)) or made[-1])
    record = campaign.main(ARGS + ["--out", out])
    with open(os.path.join(out, "svtr_mrn.json"), encoding="utf-8") as f:
        assert json.load(f) == record
    with open(os.path.join(ROOT, "ACCURACY_RUNS", "t6", "svtr_mrn.json"), encoding="utf-8") as f:
        t6 = json.load(f)
    assert set(t6) | {"device"} == set(record)
    assert record["device"] == "cpu" and record["il"] == "mrn" and record["arch"] == "svtr"
    matrix = record["acc_matrix"]
    assert [len(row) for row in matrix] == [1, 2] and record["final_row"] == matrix[-1]
    assert len(record["aia_per_stage"]) == len(record["stage_seconds"]) == 2
    assert record["avg_forgetting"] == round(matrix[0][0] - matrix[1][0], 2)
    assert record["n_train"] == [max(8, n // 80) for n in campaign.N_TRAIN]
    memory = [ix.tolist() for ix in made[0].memory_index]
    assert len(memory) == 1 and len(memory[0]) == campaign.SMOKE_MEMORY_NUM

    proc = subprocess.run([sys.executable, "-c", REPLAY] + ARGS +
                          ["--out", out, "--start_task", "1", "--eval_from", "1"],
                          cwd=ROOT, capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "task 0 (Chinese): resumed, eval skipped" in proc.stdout
    assert json.loads(proc.stdout.split("MEMORY ")[-1]) == memory
    with open(os.path.join(out, "svtr_mrn.json"), encoding="utf-8") as f:
        replayed = json.load(f)
    assert len(replayed["acc_matrix"]) == 1 and replayed["avg_forgetting"] is None
    log = open(os.path.join(out, "saved", "acc_svtr_mrn", "log_train.txt"),
               encoding="utf-8").read()
    assert "Task 0 load checkpoint from" in log and "Chinese_0_0_best_score" in log


@pytest.mark.parametrize("il", ["wa", "base", "der"])
def test_other_strategies_raise(il, tmp_path):
    """The other strategies are ported for the CTC head; what they still
    refuse is an Attn head (ROADMAP.md §1 item 7) and another backbone."""
    learner = build_learner(default_options(il=il, output_dir=str(tmp_path)), device="cpu")
    assert type(learner).__name__ == {"wa": "WA", "base": "BaseLearner", "der": "DER"}[il]
    with pytest.raises(NotImplementedError, match="item 7"):
        build_learner(default_options(il=il, Prediction="Attn"), device="cpu")
    with pytest.raises(NotImplementedError):
        campaign.main(["--il", il, "--arch", "trba", "--device", "cpu"])
