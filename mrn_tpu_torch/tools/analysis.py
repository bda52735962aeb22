"""Offline per-character accuracy analysis of the port (the port's copy of
``mrn_tpu/tools/analysis.py``, reference: tools/utils.py:233-278
``read_txt`` / ``dict_total``).

Given two label dumps — the correctly-predicted words and all ground-truth
words — computes per-character frequencies, per-character recall, and the
reference's average-recall-per-frequency-bucket report (characters grouped by
how often they appear in the ground truth).  The reference version hardcodes
its experiment paths; this one takes explicit paths and returns the data.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

__all__ = ["char_frequency", "char_accuracy", "char_accuracy_report"]


def char_frequency(path: str) -> Dict[str, int]:
    """Character -> occurrence count over a one-word-per-line txt file
    (read_txt, utils.py:233-249)."""
    char_dict: Dict[str, int] = {}
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            for char in line.strip("\n"):
                char_dict[char] = char_dict.get(char, 0) + 1
    return char_dict


def char_accuracy(true_path: str, total_path: str) -> List[Tuple[str, int, float]]:
    """[(char, gt_count, recall)] sorted by ascending gt frequency
    (dict_total core, utils.py:250-262).  recall = correct_count / gt_count."""
    true_char = char_frequency(true_path)
    total_char = char_frequency(total_path)
    char_list = [(key, value, true_char.get(key, 0) / value)
                 for key, value in total_char.items()]
    return sorted(char_list, key=lambda item: item[1])


def char_accuracy_report(true_path: str, total_path: str,
                         out_path: Optional[str] = None) -> List[str]:
    """Average recall per frequency bucket + the full per-char table, in the
    reference's log format (dict_total, utils.py:263-278).  Returns the log
    lines; appends them to ``out_path`` when given."""
    pred_list = char_accuracy(true_path, total_path)
    lines: List[str] = []
    start_i, acc = 0, 0.0
    for i, (char, count, recall) in enumerate(pred_list):
        if i != 0 and count != pred_list[i - 1][1]:
            avg = acc / (i - start_i)
            lines.append("avg {} char is {:.2f} total {}\n".format(
                pred_list[i - 1][1], avg, i - start_i))
            start_i, acc = i, 0.0
        acc += recall
    if pred_list:  # flush the final bucket (the reference drops it implicitly)
        avg = acc / (len(pred_list) - start_i)
        lines.append("avg {} char is {:.2f} total {}\n".format(
            pred_list[-1][1], avg, len(pred_list) - start_i))
    for item in pred_list:
        lines.append(str(list(item)) + "\n")
    if out_path:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        with open(out_path, "a", encoding="utf-8") as log:
            log.writelines(lines)
    return lines
