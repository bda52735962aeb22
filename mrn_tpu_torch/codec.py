"""CTC label codec and cumulative character-dictionary loading (the port's
own copy of the CTC half of ``mrn_tpu/codec.py``).

Token layout (load-bearing for checkpoint and parity comparisons):
index 0 = [CTCblank]; then [PAD], [UNK], ' ' and the characters.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

__all__ = ["CTCLabelConverter", "load_dict"]


def load_dict(path: str, char: Dict[str, int]) -> Tuple[List[str], Dict[str, int]]:
    """Accumulate characters from ``path``/dict.txt into the running ``char``
    map (insertion-ordered), returning the cumulative character list.  One
    character per line, newline stripped (other whitespace kept)."""
    with open(os.path.join(path, "dict.txt"), encoding="utf-8") as f:
        for line in f:
            ch = line.rstrip("\n")
            if ch not in char:
                char[ch] = 1
    character = list(char.keys())
    return character, char


class CTCLabelConverter:
    """Text <-> index codec for CTC heads: vocabulary
    ``[CTCblank] [PAD] [UNK] ' ' <chars...>`` with the blank at index 0."""

    def __init__(self, character: Sequence[str]):
        list_special = ["[PAD]", "[UNK]", " "]
        dict_character = list_special + list(character)
        self.dict: Dict[str, int] = {c: i + 1 for i, c in enumerate(dict_character)}
        self.character: List[str] = ["[CTCblank]"] + dict_character
        self.blank_id = 0
        self.pad_id = self.dict["[PAD]"]
        self.unk_id = self.dict["[UNK]"]

    @property
    def num_classes(self) -> int:
        return len(self.character)

    def encode(self, words: Sequence[str], batch_max_length: int = 25):
        """Returns ``(indices [B, batch_max_length] int32, lengths [B] int32)``,
        padded with [PAD]."""
        b = len(words)
        out = np.full((b, batch_max_length), self.pad_id, dtype=np.int32)
        lengths = np.zeros((b,), dtype=np.int32)
        for i, word in enumerate(words):
            lengths[i] = len(word)
            idx = [self.dict.get(ch, self.unk_id) for ch in word]
            out[i, : len(idx)] = idx
        return out, lengths

    def decode(self, indices: np.ndarray, lengths: np.ndarray) -> List[str]:
        """Greedy CTC decode: collapse repeats then drop blanks."""
        indices = np.asarray(indices)
        words = []
        for row, length in zip(indices, np.asarray(lengths)):
            chars = []
            prev = -1
            for i in range(int(length)):
                t = int(row[i])
                if t != 0 and t != prev:
                    chars.append(self.character[t])
                prev = t
            words.append("".join(chars))
        return words
