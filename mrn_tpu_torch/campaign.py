"""The 6-task synthetic incremental campaign of SVTR (the port's copy of
``scripts/accuracy_campaign.py``), for every incremental-learning strategy
of the port.

The suite echoes MLT17's shape: 6 tasks in the reference order with its
class counts (1895/325/1620/1124/73/112, disjoint CJK spans) and instance
counts, 32x256 RGBA crops rendered with the bit-pattern encoder over one
character index, characters Zipf(1.0) and lengths ``p(L) ~ 1/L``.  Per
task: train, reload the best checkpoint and score every seen task; the
record holds the accuracy matrix, the AIA per stage, the average
forgetting and the seconds per stage.  The joint strategies train once on
all tasks (``run_joint``) and record one row.

    python3 -m mrn_tpu_torch.campaign --il wa --tasks 6 --num_iter 1000 \
        --bf16 --out ACCURACY_RUNS_TORCH/t6

writes ``<out>/svtr_<il>.json`` (best checkpoints under ``<out>/saved/``);
``--il`` is ``base``, ``lwf``, ``wa``, ``ewc``, ``der``, ``mrn``,
``joint_mix`` or ``joint_loader``; ``mrn``, ``der``, ``wa`` and
``joint_mix`` keep a rehearsal memory (``MEMORY_ILS``), EWC's Fisher takes
``num_iter // 4`` batches.  The rendered suite is cached as
``build/campaign/suite_<tag>.npz`` under the repository root; on the card
the CUDA kernels are built before stage 0's clock starts.  ``--smoke``
runs a narrow SVTR (embed 16/32/64, depth 1/2/1) on 1/80 of the data.  A
crashed campaign goes on with ``--start_task K --eval_from K`` (tasks
below K replay their best checkpoints; for MRN K + 0.5 also replays task
K's step 0); ``--stop_after K`` ends after stage K, writing
``<out>/svtr_<il>.stage<K>.json``.  Runs on the CUDA card unless
``--device cpu``.  Only the SVTR recognizer is ported.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import time
from typing import Callable, List, Optional, Sequence

from mrn_tpu_torch import resolve_device
from mrn_tpu_torch.config import default_options
from mrn_tpu_torch.data.manager import DatasetManager, ValDataset
from mrn_tpu_torch.data.synthetic import SyntheticSource, alphabet_of_size
from mrn_tpu_torch.train.learners import build_learner

__all__ = ["CLASSES", "GEN_PARAMS", "ILS", "LANS", "MEMORY_ILS", "N_TEST", "N_TRAIN",
           "build_source", "campaign_options", "campaign_record", "device_name", "forgetting",
           "main",
           "run_incremental", "run_joint"]

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE_DIR = os.path.join(ROOT, "build", "campaign")

LANS = ["Chinese", "Latin", "Japanese", "Korean", "Arabic", "Bangla"]
CLASSES = [1895, 325, 1620, 1124, 73, 112]
N_TRAIN = [2687, 47411, 4609, 5631, 3711, 3237]
N_TEST = [529, 11073, 1350, 1230, 983, 713]
GEN_PARAMS = dict(min_len=1, max_len=10, renderer="bits", zipf=1.0,
                  classes=CLASSES, n_test=N_TEST)
MEMORY_NUM = 2000
SMOKE_SVTR = dict(embed_dim=(16, 32, 64), depth=(1, 2, 1), num_heads=(2, 2, 4))
SMOKE_MEMORY_NUM = 16   # below the smallest smoke task
ILS = ("base", "lwf", "wa", "ewc", "der", "mrn", "joint_mix", "joint_loader")
# the strategies that keep a rehearsal memory, as the shipped configs do
MEMORY_ILS = {"mrn", "der", "wa", "joint_mix"}


def task_alphabets() -> List[str]:
    """Each task's span of ``alphabet_of_size``, back to back."""
    spans, start = [], 0x4E00
    for n in CLASSES:
        spans.append(alphabet_of_size(n, start))
        start += n
    return spans


def suite_tag(seed: int, n_train: Sequence[int], img_h: int, img_w: int) -> str:
    """The JAX script's cache tag: seed, train size, crop size and a hash
    of the generation parameters."""
    h = hashlib.sha1(json.dumps(GEN_PARAMS, sort_keys=True).encode()).hexdigest()[:8]
    return f"s{seed}_n{sum(n_train)}_{img_h}x{img_w}_{h}"


def build_source(opt, seed: int = 111, cache_dir: Optional[str] = None,
                 n_train: Sequence[int] = N_TRAIN, n_test: Sequence[int] = N_TEST
                 ) -> SyntheticSource:
    """The bank-mode suite of all six tasks (whatever ``--tasks`` says, as
    in the JAX script, so a task's bank indices never depend on it), loaded
    from ``cache_dir`` when it holds it, else rendered (and saved there)."""
    spans, lans = task_alphabets(), LANS
    cache = None
    if cache_dir:
        cache = os.path.join(cache_dir, f"suite_{suite_tag(seed, n_train, opt.imgH, opt.imgW)}")
        if os.path.exists(cache + ".npz"):
            t0 = time.time()
            source = SyntheticSource.load(cache + ".npz", lans, spans)
            print(f"suite loaded from cache in {time.time() - t0:.0f}s", flush=True)
            return source
    gen = {k: v for k, v in GEN_PARAMS.items() if k not in ("classes", "n_test")}
    source = SyntheticSource(spans, lans, n_train=list(n_train), n_test=list(n_test),
                             img_h=opt.imgH, img_w=opt.imgW, seed=seed, device_bank=True,
                             **gen)
    if cache:
        os.makedirs(cache_dir, exist_ok=True)
        source.save(cache + ".npz")
    return source


def campaign_options(tasks: int = 6, num_iter: int = 1000, batch_size: int = 256,
                     seed: int = 111, bf16: bool = False, out: str = "ACCURACY_RUNS_TORCH",
                     smoke: bool = False, il: str = "mrn", **overrides):
    """The JAX script's options for SVTR under strategy ``il``
    (``run_strategy``)."""
    dims = dict(output_channel=512, hidden_size=256)
    if smoke:
        dims = dict(output_channel=64, hidden_size=32, svtr=SMOKE_SVTR)
    opt = dict(exp_name=f"acc_svtr_{il}", il=il,
               memory="random" if il in MEMORY_ILS else None,
               fisher_num_iter=max(1, num_iter // 4),
               memory_num=SMOKE_MEMORY_NUM if smoke else MEMORY_NUM,
               batch_size=batch_size, num_iter=num_iter,
               val_interval=max(1, num_iter // 2), batch_max_length=25, imgH=32, imgW=256,
               lan_list=LANS[:tasks], select_data=["synth_train"],
               Transformation="None", FeatureExtraction="SVTR", SequenceModeling="None",
               Prediction="CTC", valid_datas=["synth_test"], workers=0, NED=True,
               manual_seed=seed, train_dtype="bf16" if bf16 else None,
               output_dir=os.path.join(out, "saved"),
               data_log=os.path.join(out, f"data_svtr_{il}.txt"), **dims)
    opt.update(overrides)
    return default_options(**opt)


def _val_builder(opt, source) -> Callable:
    def build(val_data):
        return ValDataset([val_data], opt, dataset_factory=source.val_factory).create_dataset()
    return build


def _matrix_row(learner, opt, source, taski: int) -> List[float]:
    """Accuracy on tasks 0..taski with the best checkpoint ``test`` has
    just reloaded."""
    if opt.il == "mrn":
        choose = "FF" if taski == 0 else "TF"
    else:
        choose = "test"
    row = []
    for j in range(taski + 1):
        res = learner.run_validation(_val_builder(opt, source)(f"synth_test/{opt.lan_list[j]}"),
                                     choose)
        row.append(round(res.score, 2))
    return row


def run_incremental(opt, source, learner=None, device=None, manager=None):
    """The campaign's task loop; returns ``(learner, aia per stage, matrix,
    stage seconds)``.  ``opt.image_bank`` must hold the suite's bank; a
    ``learner`` or a ``DatasetManager`` passed in is used as it is."""
    learner = learner or build_learner(opt, device=device)
    manager = manager or DatasetManager(opt, dataset_factory=source.train_factory)
    best_scores, ned_scores, valid_datas = [], [], []
    matrix, stage_times = [], []
    stop_after = int(opt.get("stop_after", -1))
    for taski in range(len(opt.lan_list)):
        t0 = time.time()
        valid_datas.append(f"synth_test/{opt.lan_list[taski]}")
        val_ds = ValDataset(valid_datas, opt, dataset_factory=source.val_factory)
        if taski == 0:
            manager.init_start(opt, opt.select_data, None, taski)
        learner.incremental_train(taski, source.cumulative_character(taski), manager, val_ds)
        if taski < int(opt.get("eval_from", 0)):
            # a replayed stage whose row is already recorded
            learner.after_task()
            stage_times.append(round(time.time() - t0, 1))
            print(f"[{opt.il}] task {taski} ({opt.lan_list[taski]}): resumed, eval skipped "
                  f"({stage_times[-1]}s)", flush=True)
            continue
        best_scores, ned_scores = learner.test(valid_datas, best_scores, ned_scores, taski,
                                               val_dataset_builder=_val_builder(opt, source))
        matrix.append(_matrix_row(learner, opt, source, taski))
        learner.after_task()
        stage_times.append(round(time.time() - t0, 1))
        print(f"[{opt.il}] task {taski} ({opt.lan_list[taski]}): row={matrix[-1]} "
              f"AIA={best_scores[-1]} ({stage_times[-1]}s)", flush=True)
        if 0 <= stop_after <= taski:
            print(f"[{opt.il}] stop_after={stop_after}: stage complete", flush=True)
            break
    return learner, best_scores, matrix, stage_times


def run_joint(opt, source, learner=None, device=None, manager=None):
    """The joint upper bound: every task's stream through
    ``joint_start``, one training run on all characters, then ``test`` and
    the row over every task; returns ``(learner, [row mean], [row],
    [seconds])``."""
    learner = learner or build_learner(opt, device=device)
    manager = manager or DatasetManager(opt, dataset_factory=source.train_factory)
    n_tasks = len(opt.lan_list)
    valid_datas = [f"synth_test/{lan}" for lan in opt.lan_list]
    t0 = time.time()
    for taski in range(n_tasks):
        manager.joint_start(opt, opt.select_data, None, taski, n_tasks)
    val_ds = ValDataset(valid_datas, opt, dataset_factory=source.val_factory)
    best_scores, ned_scores = learner.incremental_train(
        0, source.cumulative_character(n_tasks - 1), manager, val_ds,
        valid_datas=valid_datas, val_dataset_builder=_val_builder(opt, source))
    learner.test(valid_datas, best_scores, ned_scores, 0,
                 val_dataset_builder=_val_builder(opt, source))
    row = _matrix_row(learner, opt, source, n_tasks - 1)
    seconds = round(time.time() - t0, 1)
    print(f"[{opt.il}] joint row={row} ({seconds}s)", flush=True)
    return learner, [round(sum(row) / len(row), 2)], [row], [seconds]


def forgetting(matrix: Sequence[Sequence[float]]) -> Optional[float]:
    """Average forgetting: each old task's diagonal minus its final score;
    ``None`` for a partial matrix."""
    final_row = matrix[-1]
    if len(matrix) != len(final_row):
        return None
    if len(matrix) == 1:
        return 0.0
    n = len(final_row) - 1
    return round(sum(matrix[j][j] - final_row[j] for j in range(n)) / n, 2)


def device_name(device) -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them, or
    ``"cpu"``."""
    if device.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(["nvidia-smi", f"--id={device.index or 0}",
                              "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30, check=True)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        import torch
        return f"{torch.cuda.get_device_name(device)}, power limit not read"


def campaign_record(il: str, num_iter: int, bf16: bool, batch_size: int, seed: int,
                    n_train: Sequence[int], n_test: Sequence[int], aia: List[float],
                    matrix: List[List[float]], times: List[float], total: float,
                    card: str) -> dict:
    """The fields of the JAX campaign's ``ACCURACY_RUNS/t6/svtr_<il>.json``
    plus the card's ``device``."""
    return {
        "il": il, "num_iter": num_iter, "train_dtype": "bf16" if bf16 else "f32",
        "batch_size": batch_size, "seed": seed,
        "classes": CLASSES, "n_train": list(n_train), "n_test": list(n_test),
        "shared_glyphs": 0,
        "aia_per_stage": aia, "final_aia": aia[-1] if aia else None,
        "acc_matrix": matrix, "final_row": matrix[-1] if matrix else None,
        "avg_forgetting": forgetting(matrix) if matrix else None,
        "stage_seconds": times, "total_seconds": total,
        "arch": "svtr", "recycled": False, "device": card,
    }


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--il", default="mrn", choices=ILS)
    ap.add_argument("--arch", default="svtr")
    ap.add_argument("--tasks", type=int, default=6)
    ap.add_argument("--num_iter", type=int, default=2500)
    ap.add_argument("--batch_size", type=int, default=256)
    ap.add_argument("--seed", type=int, default=111)
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--out", default="ACCURACY_RUNS_TORCH")
    ap.add_argument("--smoke", action="store_true",
                    help="narrow SVTR and 1/80 of the data (a wiring check)")
    ap.add_argument("--start_task", type=float, default=0,
                    help="replay phases below this from their best checkpoints "
                         "under <out>/saved/ (K.5 also replays task K's step 0)")
    ap.add_argument("--eval_from", type=int, default=0,
                    help="skip the evaluation of stages below this")
    ap.add_argument("--stop_after", type=int, default=-1,
                    help="end after this stage, writing <out>/svtr_<il>.stage<K>.json")
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)
    if args.arch != "svtr":
        raise NotImplementedError(f"arch={args.arch!r}: the port's campaign runs SVTR only "
                                  "(ROADMAP.md §1 items 7-9)")
    device = resolve_device(args.device)
    if device.type == "cuda":
        # the kernels' nvcc builds stay out of stage 0's seconds
        from mrn_tpu_torch.ops import _build
        t_kernels = time.time()
        _build.build_all()
        print(f"kernels built in {time.time() - t_kernels:.1f}s", flush=True)
    n_train, n_test = N_TRAIN, N_TEST
    if args.smoke:
        n_train = [max(8, n // 80) for n in N_TRAIN]
        n_test = [max(8, n // 80) for n in N_TEST]
    opt = campaign_options(args.tasks, args.num_iter, args.batch_size, args.seed, args.bf16,
                           args.out, args.smoke, il=args.il, start_task=args.start_task,
                           eval_from=args.eval_from, stop_after=args.stop_after)
    os.makedirs(args.out, exist_ok=True)
    t_build = time.time()
    source = build_source(opt, args.seed, None if args.smoke else CACHE_DIR, n_train, n_test)
    opt.image_bank = source.device_bank(device)
    print(f"suite ready in {time.time() - t_build:.0f}s (train={sum(n_train)} "
          f"test={sum(n_test)} crops, bank={source.bank.nbytes >> 20}MB on {device})",
          flush=True)

    t0 = time.time()
    run = run_joint if args.il in ("joint_mix", "joint_loader") else run_incremental
    _, aia, matrix, times = run(opt, source, device=device)
    card = device_name(device)
    total = round(time.time() - t0, 1)
    if args.stop_after >= 0:
        record = {"stage": args.stop_after, "eval_from": args.eval_from, "rows": matrix,
                  "aia": aia, "stage_seconds": times, "total_seconds": total, "device": card}
        path = os.path.join(args.out, f"svtr_{args.il}.stage{args.stop_after}.json")
    else:
        record = campaign_record(args.il, args.num_iter, args.bf16, args.batch_size, args.seed,
                                 n_train, n_test, aia, matrix, times, total, card)
        path = os.path.join(args.out, f"svtr_{args.il}.json")
    with open(path, "w", encoding="utf-8") as f:
        json.dump(record, f, indent=1)
    print(json.dumps({k: record[k] for k in ("final_aia", "avg_forgetting", "final_row",
                                             "total_seconds", "device") if k in record}),
          flush=True)
    print(f"wrote {path}", flush=True)
    return record


if __name__ == "__main__":
    main()
