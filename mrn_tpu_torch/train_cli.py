"""Training CLI of the port (the port's copy of the JAX package's
``train.py``): loads a reference-format config, seeds, then runs the
incremental task loop: per task it builds the data stream from the LMDB
trees under ``select_data`` (``{root}/{language}/`` with ``data.mdb`` and
``dict.txt``), grows the cumulative character dict, trains the learner,
scores every seen task on the ``valid_datas`` roots and reports the
Average Incremental Accuracy.

    python3 -m mrn_tpu_torch.train_cli --config configs/svtr_mrn.py [--bf16] \\
        [--device_bank] [--profile DIR] [--device cpu]
    torchrun --nproc_per_node N -m mrn_tpu_torch.train_cli --config ... \\
        [--data_parallel D] [--expert_parallel E] [--multihost]

Runs on the CUDA card unless ``--device`` names another (the tests pass
``cpu``); without a card and without ``--device`` it raises.  On the card
the kernels are built before the first task.  ``--device_bank`` resizes
each task's crops once into a uint8 bank on the device and streams bank
indices.  ``--profile DIR`` writes a ``torch.profiler`` trace of the whole
run.

Under torchrun (one process per card; ``parallel.multihost``) the process
group is joined and a ``data x expert`` mesh installed over the world
(``parallel.mesh``): ``--expert_parallel E`` shards MRN's experts over E
ranks, ``--data_parallel D`` (default ``WORLD_SIZE // E``) the batch over
D, and ``D x E`` must equal the world size.  ``--multihost`` asks for the
same start-up (in PyTorch one host and many take the same call) and fails
outside torchrun.  The backend is NCCL on the card and gloo with
``--device cpu``.  Local rank 0 builds the CUDA kernels while the others
wait.  More than one shard without a process group raises: nothing falls
back to a single process.
"""

from __future__ import annotations

import argparse
import os
import random
import time
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from mrn_tpu_torch import resolve_device
from mrn_tpu_torch.codec import load_dict
from mrn_tpu_torch.config import load_config
from mrn_tpu_torch.data.dataset import DeviceImageBank
from mrn_tpu_torch.data.manager import DatasetManager, ValDataset
from mrn_tpu_torch.parallel import mesh, multihost
from mrn_tpu_torch.train.learners import build_learner
from mrn_tpu_torch.utils.logging import ExperimentLog

__all__ = ["TrainRun", "main", "train"]


class TrainRun(NamedTuple):
    best_scores: List[float]
    ned_scores: List[float]
    learner: object


def train(opt, log: ExperimentLog, device=None, learner=None
          ) -> Tuple[List[float], List[float]]:
    """The task loop of ``opt`` (JAX's ``train.train``) on ``learner``
    (default: ``build_learner(opt, device)``); returns the per-stage (best,
    ned) score lists."""
    learner = learner or build_learner(opt, device=device)
    data_manager = DatasetManager(opt)
    best_scores, ned_scores = [], []
    valid_datas = []
    char = {}

    def val_builder(val_data):
        return ValDataset([val_data], opt).create_dataset()

    train_datasets = list(opt.lan_list)
    if opt.il in ("joint_loader", "joint_mix"):
        for taski in range(len(train_datasets)):
            for val_root in opt.valid_datas:
                valid_datas.append(os.path.join(val_root, opt.lan_list[taski]))
            data_manager.joint_start(opt, opt.select_data, log, taski, len(train_datasets))
            for data_path in opt.select_data:
                opt.character, char = load_dict(os.path.join(data_path, opt.lan_list[taski]),
                                                char)
        valid_loader = ValDataset(valid_datas, opt)
        best_scores, ned_scores = learner.incremental_train(
            0, opt.character, data_manager, valid_loader, valid_datas=valid_datas,
            val_dataset_builder=val_builder)
        best_scores, ned_scores = learner.test(valid_datas, best_scores, ned_scores, 0,
                                               val_dataset_builder=val_builder)
    else:
        for taski in range(len(train_datasets)):
            for val_root in opt.valid_datas:
                valid_datas.append(os.path.join(val_root, opt.lan_list[taski]))
            valid_loader = ValDataset(valid_datas, opt)
            if taski == 0:
                data_manager.init_start(opt, opt.select_data, log, taski)
            for data_path in opt.select_data:
                opt.character, char = load_dict(os.path.join(data_path, opt.lan_list[taski]),
                                                char)
            learner.incremental_train(taski, opt.character, data_manager, valid_loader)
            best_scores, ned_scores = learner.test(valid_datas, best_scores, ned_scores, taski,
                                                   val_dataset_builder=val_builder)
            learner.after_task()

    log.write_data_log(f"----------- {opt.exp_name} ------------\n")
    if len(opt.valid_datas) == 1:
        aia = sum(best_scores) / len(best_scores)
        print(f"ALL Average Incremental Accuracy: {aia:.2f}")
        log.write_data_log(f"ALL Average Acc: {aia:.2f} \n")
    elif len(opt.valid_datas) == 2:
        a17 = sum(best_scores) / len(best_scores)
        a19 = sum(ned_scores) / len(ned_scores)
        print(f"ALL Average 17 Acc: {a17:.2f}")
        print(f"ALL Average 19 Acc: {a19:.2f}")
        log.write_data_log(f"ALL 17 Acc: {a17:.2f} \n")
        log.write_data_log(f"ALL 19 Acc: {a19:.2f} \n")
    return best_scores, ned_scores


def main(argv: Optional[Sequence[str]] = None) -> TrainRun:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--config", required=True, help="reference-format python config file")
    parser.add_argument("--data_parallel", type=int, default=None,
                        help="shard the batch over this many ranks (under torchrun; default "
                             "WORLD_SIZE // expert_parallel)")
    parser.add_argument("--expert_parallel", type=int, default=None,
                        help="shard MRN's experts over this many ranks (2-D data x expert mesh)")
    parser.add_argument("--multihost", action="store_true",
                        help="join torchrun's process group (also implied under torchrun; "
                             "one host or many)")
    parser.add_argument("--profile", default=None,
                        help="write a torch.profiler trace of the run to this directory")
    parser.add_argument("--bf16", action="store_true",
                        help="mixed precision: forward and backward in bf16, float32 master "
                             "params, optimizer state and BatchNorm statistics")
    parser.add_argument("--device_bank", action="store_true",
                        help="resize each task's crops once into a uint8 bank on the device "
                             "and stream only indices (incompatible with Aug)")
    parser.add_argument("--device", default=None, help="default: the CUDA card")
    args = parser.parse_args(argv)

    opt = load_config(args.config)
    expert_par = args.expert_parallel or opt.get("expert_parallel", 1) or 1
    data_par = args.data_parallel or (opt.get("data_parallel", 1) or 1)
    if args.multihost or opt.get("multihost", False) or multihost.launched_by_torchrun():
        rank, world = multihost.initialize(args.device)
        # unset (the config's default 1), the data size is the world over the experts
        mesh.set_expert_parallel(expert_par, args.data_parallel or
                                 (data_par if data_par > 1 else None))
        print(f"process group: rank {rank} of {world}, mesh {mesh.get_mesh().shape}", flush=True)
    elif data_par > 1 or expert_par > 1:
        raise RuntimeError(f"--data_parallel {data_par} / --expert_parallel {expert_par} need "
                           "one process per rank: launch with torchrun --nproc_per_node N -m "
                           "mrn_tpu_torch.train_cli ...")
    device = resolve_device(args.device)
    random.seed(opt.manual_seed)
    np.random.seed(opt.manual_seed)
    if args.bf16:
        opt.train_dtype = "bf16"
    if args.device_bank or opt.get("device_bank", False):
        opt.image_bank = DeviceImageBank()
    if device.type == "cuda":
        from mrn_tpu_torch.ops import _build
        t0 = time.time()
        if int(os.environ.get("LOCAL_RANK", 0)) == 0:
            _build.build_all()
        mesh.barrier()   # the other ranks load local rank 0's builds
        _build.build_all()
        print(f"kernels built in {time.time() - t0:.1f}s", flush=True)

    log = ExperimentLog(opt.exp_name, opt.get("output_dir", "./saved_models"),
                        opt.get("data_log", "./data_any.txt"), echo=True)
    log.write_data_log(f"----------- {opt.exp_name} ------------\n")
    learner = build_learner(opt, device=device)
    if args.profile:
        from mrn_tpu_torch.utils.profiling import trace
        with trace(args.profile):
            run = TrainRun(*train(opt, log, learner=learner), learner)
    else:
        run = TrainRun(*train(opt, log, learner=learner), learner)
    mesh.barrier()   # rank 0's files are written
    return run


if __name__ == "__main__":
    main()
