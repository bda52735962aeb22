"""Evaluation CLI of the port (the port's copy of the JAX package's
``evaluate_cli.py``, the reference's ``test.py``): rebuilds the learner of
a best checkpoint, written by either package, at its class count and
reports word accuracy and NED.

    # per-task evaluation, cumulative dict over tasks 0..taski
    python3 -m mrn_tpu_torch.evaluate_cli --config configs/svtr_mrn.py \\
        --saved_model saved_models/SVTR_MRN/Bangla_5_1_best_score.msgpack \\
        --eval_data ../dataset/MLT17_IL/test_2017 --taski 5

    # the reference's preset dataset lists
    python3 -m mrn_tpu_torch.evaluate_cli --config ... --saved_model ... \\
        --eval_type IL_STR [--calculate_infer_time]

``evaluate_tasks`` writes ``{result_dir}/{exp}/log_evaluation.txt`` and
``benchmark_all_eval`` ``{result_dir}/{exp}/log_all_evaluation.txt`` and
``evaluation_log/log_{all_model_evaluation,multiple_test}_<date>.txt``,
line for line as the JAX CLI writes them.  ``--calculate_infer_time``
evaluates at batch 1.  ``--int8`` serves a single SVTR, CRNN, GRCNN, TRBA
or RBA recognizer w8a8 (``serve.quantize_int8``, calibrated on the first
batches of the first eval root's first language: the SVTR Block
projections, or every conv of VGG, RCNN and ResNet); an MRN or DER ensemble
after task 0 is refused, as the JAX CLI refuses it.  ``--model_name CRNN``
(None/VGG/BiLSTM/CTC), ``RBA`` (None/ResNet/BiLSTM/Attn) and ``TRBA`` set
the stages.

An MRN checkpoint evaluates "TF" (the routed ensemble) after task 0 and
"FF" (the standalone expert) at task 0; JAX's CLI asks for "test" there,
which its MRN learner serves with the ensemble of a run that has none.
Runs on the CUDA card unless ``--device`` names another.
"""

from __future__ import annotations

import argparse
import os
from datetime import date
from typing import Dict, List, Optional, Sequence

import numpy as np

from mrn_tpu_torch.bridge import to_flax
from mrn_tpu_torch.codec import load_dict
from mrn_tpu_torch.config import load_config
from mrn_tpu_torch.data.dataset import DeviceImageBank, bank_dataset, hierarchical_dataset
from mrn_tpu_torch.data.manager import EpochLoader, ValDataset
from mrn_tpu_torch.data.transform import build_transform
from mrn_tpu_torch.models.surgery import count_params
from mrn_tpu_torch.serve import Server, quantize_int8
from mrn_tpu_torch.train.checkpoint import load_model
from mrn_tpu_torch.train.learners import build_learner

__all__ = ["EVAL_TYPE_PRESETS", "apply_model_name_presets", "benchmark_all_eval",
           "check_svtr_envelope", "evaluate_tasks", "load_learner", "main",
           "quantize_learner_int8", "val_choose"]

# preset evaluation dataset lists (reference test.py:26-54)
EVAL_TYPE_PRESETS = {
    "benchmark": (["IIIT5k_3000", "SVT", "IC13_1015", "IC15_2077", "SVTP", "CUTE80"],
                  "data_CVPR2021/evaluation/benchmark/"),
    "addition": (["5.COCO", "6.RCTW17", "7.Uber", "8.ArT", "9.LSVT", "10.MLT19", "11.ReCTS"],
                 "data_CVPR2021/evaluation/addition/"),
    "IL_STR": (["Latin", "Chinese", "Arabic", "Japanese", "Korean", "Bangla", "Hindi",
                "Symbols"], "../dataset/MLT2019/test_2019/"),
}


def apply_model_name_presets(opt):
    """model_name -> the four stages (reference test.py:476-492)."""
    name = opt.get("model_name")
    if name == "CRNN":
        opt.Transformation, opt.FeatureExtraction = "None", "VGG"
        opt.SequenceModeling, opt.Prediction = "BiLSTM", "CTC"
    elif name == "TRBA":
        opt.Transformation, opt.FeatureExtraction = "TPS", "ResNet"
        opt.SequenceModeling, opt.Prediction = "BiLSTM", "Attn"
    elif name == "RBA":
        opt.Transformation, opt.FeatureExtraction = "None", "ResNet"
        opt.SequenceModeling, opt.Prediction = "BiLSTM", "Attn"
    return opt


def load_learner(opt, saved_model: str, last_task: int, device=None):
    """The learner of ``opt.il`` holding the checkpoint ``saved_model`` of
    task ``last_task``: the cumulative character dict over tasks
    0..last_task (``dict.txt`` under every ``select_data`` root), the
    converter, and the checkpoint's network (an MRN file's experts from
    ``experts/`` beside it, its router when ``last_task > 0``)."""
    char: Dict[str, int] = {}
    for taski in range(last_task + 1):
        for data_path in opt.select_data:
            opt.character, char = load_dict(os.path.join(data_path, opt.lan_list[taski]),
                                            char)
    learner = build_learner(opt, device=device)
    learner._cur_task = last_task
    learner.character = list(opt.character)
    learner.converter = learner.build_converter()
    payload = load_model(saved_model)
    if opt.il == "mrn":
        learner.restore_composite(
            payload, expert_dir=os.path.join(os.path.dirname(os.path.abspath(saved_model)),
                                             "experts"))
        learner._phase = "standalone" if last_task == 0 else "routed"
    else:
        if opt.il == "der":   # any leaf of the stack: the extractor count leads
            leaf = payload["params"]["extractors"]
            while isinstance(leaf, dict):
                leaf = next(iter(leaf.values()))
            learner.n_experts = int(np.shape(leaf)[0])
        learner._set_model(payload["params"], payload["batch_stats"])
    return learner


def val_choose(opt, last_task: int) -> str:
    if opt.il == "mrn":
        return "TF" if last_task > 0 else "FF"
    return "test"


def _eval_model(learner, last_task: int):
    """The module the learner evaluates (the routed ensemble, or its
    model)."""
    if learner.opt.il == "mrn" and last_task > 0:
        return learner._eval_ensemble()
    return learner.model


def _params_tree(learner, last_task: int):
    """The params tree the JAX CLI counts: an MRN checkpoint's router after
    task 0, else the network's."""
    if learner.opt.il == "mrn" and last_task > 0:
        return learner._router_tree()
    if getattr(learner, "eval_quant", None):
        return learner.float_params
    return to_flax(learner.model)[0]


def _calibration_batches(calib_loader):
    """The eval loader's batches as the JAX CLI calibrates on them: a uint8
    batch normalised on the host, its padded rows the zeros of JAX's
    float32 padding (the port pads uint8 batches with black crops, which
    would move the calibrated ranges); bank indices as they are."""
    for images, _, n_valid in calib_loader:
        images = np.asarray(images)
        if images.dtype == np.uint8:
            images = (images.astype(np.float32) / 255.0 - 0.5) / 0.5
            images[n_valid:] = 0.0
        yield images


def quantize_learner_int8(learner, opt, calib_loader, n_batches: int = 4):
    """``--int8``: the learner's single recognizer served w8a8
    (``serve.quantize_int8``: calibrated in float32 on up to ``n_batches``
    batches of ``calib_loader``, quantized, rebuilt with int8 Blocks or
    int8 convs), in place of its model."""
    params, stats = to_flax(learner.model)
    server = Server(opt, params, stats, learner.character, device=learner.device)
    quantize_int8(server, _calibration_batches(calib_loader), n_batches)
    learner.float_params, learner.float_stats = params, stats
    learner.model = server.model
    learner.eval_quant = True
    return learner


def check_svtr_envelope(learner, opt, loader, last_task: int) -> Optional[float]:
    """Once per learner: the largest |attention score| of the loader's first
    batch on the composed path against the fused Block's clamp
    (``Server.check_score_envelope``, loud on stderr past it)."""
    if (opt.FeatureExtraction != "SVTR" or getattr(learner, "eval_quant", None)
            or getattr(learner, "_envelope_checked", False)):
        return None
    learner._envelope_checked = True
    try:
        images = next(iter(loader))[0]
    except StopIteration:
        return None
    server = Server(opt, {}, None, learner.character, device=learner.device,
                    model=_eval_model(learner, last_task))
    return server.check_score_envelope(images)


def benchmark_all_eval(learner, opt, last_task: int, calculate_infer_time: bool = False,
                       log_multiple_test: bool = False, result_dir: str = "./result",
                       evaluation_log_dir: str = "./evaluation_log",
                       eval_data_list: Optional[Sequence[str]] = None):
    """Evaluates the preset list of ``opt.eval_type`` (or ``eval_data_list``
    under its root) and writes the reference's log files field for field
    (reference test.py:24-136); returns (total accuracy, names, accuracy
    strings)."""
    preset_list, default_root = EVAL_TYPE_PRESETS[opt.eval_type]
    eval_data_list = list(eval_data_list or preset_list)
    eval_root = opt.get("eval_data") or default_root
    eval_batch_size = 1 if calculate_infer_time else opt.batch_size
    exp_dir = os.path.join(result_dir, opt.exp_name)
    os.makedirs(exp_dir, exist_ok=True)
    os.makedirs(evaluation_log_dir, exist_ok=True)
    transform = build_transform(opt, mode="test")
    choose = val_choose(opt, last_task)

    accuracy_list: List[str] = []
    total_forward_time = 0.0
    total_eval_data_number = 0
    total_correct_number = 0.0
    dashed_line = "-" * 80
    with open(os.path.join(exp_dir, "log_all_evaluation.txt"), "a", encoding="utf-8") as log:
        print(dashed_line)
        log.write(dashed_line + "\n")
        for eval_data in eval_data_list:
            eval_data_path = eval_root + eval_data
            ds, eval_data_log = hierarchical_dataset(root=eval_data_path, opt=opt, mode="test")
            bank = opt.get("image_bank")
            if isinstance(bank, DeviceImageBank):
                ds = bank.datasets.get(eval_data_path) or bank.datasets.setdefault(
                    eval_data_path, bank_dataset(ds, opt, bank))
            loader = EpochLoader(ds, eval_batch_size, transform, shuffle=False,
                                 pad_to_batch=True, rng=np.random.default_rng(opt.manual_seed))
            check_svtr_envelope(learner, opt, loader, last_task)
            res = learner.run_validation(loader, choose)
            accuracy_list.append(f"{res.score:0.2f}")
            total_forward_time += res.infer_time
            total_eval_data_number += len(ds)
            total_correct_number += res.score * res.length_of_data
            log.write(eval_data_log)
            print(f"Acc {res.score:0.2f}")
            log.write(f"Acc {res.score:0.2f}\n")
            print(f"Ned {res.ned or 0:0.2f}")
            log.write(f"Ned {res.ned or 0:0.2f}\n")
            print(dashed_line)
            log.write(dashed_line + "\n")

        averaged_forward_time = total_forward_time / total_eval_data_number * 1000
        total_accuracy = total_correct_number / total_eval_data_number
        params_num = count_params(_params_tree(learner, last_task))
        eval_log = "accuracy: "
        for name, accuracy in zip(eval_data_list, accuracy_list):
            eval_log += f"{name}: {accuracy}\t"
        eval_log += f"total_accuracy: {total_accuracy:0.2f}\t"
        eval_log += (f"averaged_infer_time: {averaged_forward_time:0.3f}\t"
                     f"# parameters: {params_num / 1e6:0.2f}")
        print(eval_log)
        log.write(eval_log + "\n")
        print("\t".join(accuracy_list))
        print(f"Total_accuracy:{total_accuracy:0.2f}")
        log.write("\t".join(accuracy_list) + "\n")
        log.write(f"Total_accuracy:{total_accuracy:0.2f}" + "\n")

    today = date.today()
    if log_multiple_test:
        with open(os.path.join(evaluation_log_dir, f"log_multiple_test_{today}.txt"), "a",
                  encoding="utf-8") as log_all_model:
            log_all_model.write("\t".join(accuracy_list) + "\n")
    else:
        with open(os.path.join(evaluation_log_dir, f"log_all_model_evaluation_{today}.txt"),
                  "a", encoding="utf-8") as log_all_model:
            log_all_model.write(f"{result_dir}/{opt.exp_name}\t"
                                f"Total_accuracy:{total_accuracy:0.2f}\n")
            log_all_model.write("\t".join(accuracy_list) + "\n")
    return total_accuracy, eval_data_list, accuracy_list


def evaluate_tasks(learner, opt, eval_roots: Sequence[str], last_task: int,
                   result_dir: str = "./result"):
    """Tasks 0..last_task of every root (``{root}/{language}``), with the
    reference's single-dataset log (test.py:356-378); returns (scores,
    neds)."""
    exp_dir = os.path.join(result_dir, opt.exp_name)
    os.makedirs(exp_dir, exist_ok=True)
    choose = val_choose(opt, last_task)
    scores, neds = [], []
    with open(os.path.join(exp_dir, "log_evaluation.txt"), "a", encoding="utf-8") as log:
        for root in eval_roots:
            for taski in range(last_task + 1):
                val_data = os.path.join(root, opt.lan_list[taski])
                loader = ValDataset([val_data], opt).create_dataset()
                eval_data_log = (f"dataset_root:  {val_data}\t dataset: /\n"
                                 f"sub-directory:\t/.\t num samples: {len(loader.dataset)}\n")
                check_svtr_envelope(learner, opt, loader, last_task)
                res = learner.run_validation(loader, choose)
                scores.append(res.score)
                neds.append(res.ned or 0.0)
                log.write(eval_data_log)
                log.write(f"best acc score{res.score:0.2f}\n")
                log.write(f"best ned score{res.ned or 0:0.2f}\n")
                print(f"{val_data}: acc={res.score:.2f} ned={res.ned or 0:.2f} "
                      f"infer_time={res.infer_time:.2f}s n={res.length_of_data}")
        print(f"total_accuracy: {sum(scores) / len(scores):.2f}")
        print(f"total_ned: {sum(neds) / len(neds):.2f}")
    return scores, neds


def main(argv: Optional[Sequence[str]] = None):
    """Returns ``evaluate_tasks``' or ``benchmark_all_eval``'s result."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--config", required=True)
    parser.add_argument("--saved_model", required=True)
    parser.add_argument("--eval_data", nargs="+", default=None,
                        help="test roots (per-language subdirs inside); with --eval_type the "
                             "first entry overrides the preset root")
    parser.add_argument("--taski", type=int, default=None,
                        help="evaluate tasks 0..taski (default: all)")
    parser.add_argument("--eval_type", choices=sorted(EVAL_TYPE_PRESETS), default=None,
                        help="preset dataset list (reference test.py:26-54)")
    parser.add_argument("--calculate_infer_time", action="store_true",
                        help="batch_size=1 to measure per-image infer time")
    parser.add_argument("--log_multiple_test", action="store_true")
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--model_name", choices=["CRNN", "TRBA", "RBA"], default=None,
                        help="architecture preset override")
    parser.add_argument("--result_dir", default="./result")
    parser.add_argument("--evaluation_log_dir", default="./evaluation_log")
    parser.add_argument("--device_bank", action="store_true",
                        help="resize the eval sets once into a uint8 bank on the device")
    parser.add_argument("--int8", action="store_true",
                        help="w8a8 serving of a single recognizer (SVTR Blocks or the "
                             "VGG/ResNet/RCNN convs), calibrated on the first eval batches")
    parser.add_argument("--device", default=None, help="default: the CUDA card")
    args = parser.parse_args(argv)

    opt = load_config(args.config, extra_sections=["test"])
    if args.model_name:
        opt.model_name = args.model_name
        apply_model_name_presets(opt)
    elif "model_name" in opt.get("explicit_keys", ()):
        # the built-in default ("CRNN") must not override a config's stages
        apply_model_name_presets(opt)
    if args.batch_size:
        opt.batch_size = args.batch_size
    if args.device_bank or opt.get("device_bank", False):
        opt.image_bank = DeviceImageBank()
    np.random.seed(opt.manual_seed)
    last_task = args.taski if args.taski is not None else len(opt.lan_list) - 1

    learner = load_learner(opt, args.saved_model, last_task, device=args.device)
    if args.int8:
        if opt.il in ("mrn", "der") and last_task > 0:
            parser.error("--int8 supports single-recognizer models (the composite MRN/DER "
                         "eval paths stay float)")
        if args.eval_data:
            calib_root = args.eval_data[0]
        elif args.eval_type in EVAL_TYPE_PRESETS:
            calib_root = EVAL_TYPE_PRESETS[args.eval_type][1]
        else:
            parser.error("--int8 needs calibration data: pass --eval_data or a known "
                         "--eval_type")
        calib_loader = ValDataset([os.path.join(calib_root, opt.lan_list[0])],
                                  opt).create_dataset()
        quantize_learner_int8(learner, opt, calib_loader)
        print("# int8: quantized w8a8 (per-channel weights; conv extractors + SVTR block "
              "projections)")

    print(f"# parameters: {count_params(_params_tree(learner, last_task)) / 1e6:.2f} M")
    if args.eval_type:
        opt.eval_type = args.eval_type
        if args.eval_data:
            opt.eval_data = args.eval_data[0]
        return benchmark_all_eval(learner, opt, last_task,
                                  calculate_infer_time=args.calculate_infer_time,
                                  log_multiple_test=args.log_multiple_test,
                                  result_dir=args.result_dir,
                                  evaluation_log_dir=args.evaluation_log_dir)
    if not args.eval_data:
        parser.error("--eval_data is required without --eval_type")
    return evaluate_tasks(learner, opt, args.eval_data, last_task, result_dir=args.result_dir)


if __name__ == "__main__":
    main()
