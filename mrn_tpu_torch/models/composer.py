"""Model composition (mirrors ``mrn_tpu/models/composer.py``):
FeatureExtraction -> mean over height -> SequenceModeling -> CTC head, in
eval or train mode (``forward(image, train=...)``).

The port covers None/SVTR/None/CTC so far; every other stage combination
raises ``NotImplementedError``.  ``svtr`` (keyword arguments of
``SVTRExtractor``: ``embed_dim``, ``depth``, ``num_heads``,
``drop_path_rate``) narrows the backbone for tests; the configs leave it
unset, which is the reference SVTR.  ``quant`` ("none", "calib", "int8") is
the SVTR Blocks' w8a8 mode (``models.svtr.Block``).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from mrn_tpu_torch.models.common import Dense
from mrn_tpu_torch.models.svtr import SVTRExtractor

__all__ = ["Extractor", "Recognizer", "build_recognizer", "sequence_length"]


def sequence_length(feature_extraction: str, img_w: int) -> int:
    """Visual sequence length T for a backbone at width img_w."""
    if feature_extraction == "VGG":
        return img_w // 4 - 1
    if feature_extraction == "SVTR":
        return img_w // 4
    if feature_extraction in ("ResNet", "RCNN"):
        return img_w // 4 + 1
    raise ValueError(feature_extraction)


def _check_supported(transformation, feature_extraction, sequence_modeling,
                     prediction="CTC"):
    stages = (transformation, feature_extraction, sequence_modeling, prediction)
    if stages != ("None", "SVTR", "None", "CTC"):
        raise NotImplementedError(
            f"{'+'.join(stages)}: the PyTorch port serves None+SVTR+None+CTC "
            "so far; TPS/VGG/ResNet/RCNN/BiLSTM/Attn come in later slices "
            "(see ROADMAP.md)")


class Extractor(nn.Module):
    """SVTR -> mean over H -> ``seq_linear`` (the "None" sequence stage
    still projects to ``hidden_size``).  Returns [B, T, hidden]."""

    def __init__(self, transformation: str = "None",
                 feature_extraction: str = "SVTR",
                 sequence_modeling: str = "None", input_channel: int = 4,
                 output_channel: int = 512, hidden_size: int = 256,
                 img_size: Tuple[int, int] = (32, 256),
                 svtr: Optional[Mapping] = None, quant: str = "none"):
        super().__init__()
        _check_supported(transformation, feature_extraction, sequence_modeling)
        self.feature = SVTRExtractor(input_channel, output_channel, img_size,
                                     **dict(svtr or {}), quant=quant)
        self.seq_linear = Dense(output_channel, hidden_size)

    def forward(self, image: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.seq_linear(self.feature(image, train).mean(dim=1))


class Recognizer(nn.Module):
    """Extractor + CTC classifier ``fc``; returns {"predict", "feature"}."""

    def __init__(self, num_classes: int, prediction: str = "CTC",
                 transformation: str = "None", feature_extraction: str = "SVTR",
                 sequence_modeling: str = "None", input_channel: int = 4,
                 output_channel: int = 512, hidden_size: int = 256,
                 img_size: Tuple[int, int] = (32, 256),
                 svtr: Optional[Mapping] = None, quant: str = "none"):
        super().__init__()
        _check_supported(transformation, feature_extraction, sequence_modeling,
                         prediction)
        self.extractor = Extractor(transformation, feature_extraction,
                                   sequence_modeling, input_channel,
                                   output_channel, hidden_size, img_size, svtr, quant)
        self.fc = Dense(hidden_size, num_classes)

    def forward(self, image: torch.Tensor,
                train: bool = False) -> Dict[str, torch.Tensor]:
        feature = self.extractor(image, train)
        return {"predict": self.fc(feature), "feature": feature}


def build_recognizer(opt, num_classes: int, quant: str = "none") -> Recognizer:
    """Recognizer from a flat options namespace (``configs/*.py``), its SVTR
    Blocks in w8a8 mode ``quant``."""
    return Recognizer(
        num_classes=num_classes, prediction=opt.Prediction,
        transformation=opt.Transformation,
        feature_extraction=opt.FeatureExtraction,
        sequence_modeling=opt.SequenceModeling,
        input_channel=opt.input_channel, output_channel=opt.output_channel,
        hidden_size=opt.hidden_size, img_size=(opt.imgH, opt.imgW),
        svtr=opt.get("svtr"), quant=quant)
