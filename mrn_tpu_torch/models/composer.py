"""Model composition (mirrors ``mrn_tpu/models/composer.py``):
Transformation -> FeatureExtraction -> mean over height -> SequenceModeling
-> prediction head.

The port covers three stage combinations, in eval and train mode:

- None/SVTR/None/CTC (``forward(image, train=...)``); ``svtr`` (keyword
  arguments of ``SVTRExtractor``: ``embed_dim``, ``depth``, ``num_heads``,
  ``drop_path_rate``) narrows the backbone for tests, the configs leave it
  unset; ``quant`` ("none", "calib", "int8") is the SVTR Blocks' w8a8 mode
  (``models.svtr.Block``);
- TPS/ResNet/BiLSTM/Attn (TRBA) and None/ResNet/BiLSTM/Attn (RBA, TRBA
  without the TPS: ``evaluate_cli --model_name RBA``): ``fc`` is the
  decoder's generator.  ``train`` drives BatchNorm (and the TPS warp: the
  kernel in eval mode, the differentiable warp in train mode);
  ``is_train`` drives the decoder, teacher-forced on ``text`` ([SOS] and
  the characters) or greedy from its [SOS] column, and defaults to
  ``train``, JAX's split; ``class_count`` restricts the decoder to an
  expert's true vocabulary.

Every other combination raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from mrn_tpu_torch.models.attention import AttentionDecoder
from mrn_tpu_torch.models.common import Dense
from mrn_tpu_torch.models.lstm import BidirectionalLSTM
from mrn_tpu_torch.models.resnet import ResNetExtractor
from mrn_tpu_torch.models.svtr import SVTRExtractor
from mrn_tpu_torch.models.tps import TPSTransformer

__all__ = ["Extractor", "Recognizer", "build_recognizer", "sequence_length"]

_SVTR = ("None", "SVTR", "None", "CTC")
_TRBA = ("TPS", "ResNet", "BiLSTM", "Attn")
_RBA = ("None", "ResNet", "BiLSTM", "Attn")


def sequence_length(feature_extraction: str, img_w: int) -> int:
    """Visual sequence length T for a backbone at width img_w."""
    if feature_extraction == "VGG":
        return img_w // 4 - 1
    if feature_extraction == "SVTR":
        return img_w // 4
    if feature_extraction in ("ResNet", "RCNN"):
        return img_w // 4 + 1
    raise ValueError(feature_extraction)


def _check_supported(stages: Tuple[str, ...], quant: str = "none") -> None:
    """``stages``: an extractor's three, or a recognizer's four."""
    n = len(stages)
    if stages not in (_SVTR[:n], _TRBA[:n], _RBA[:n]):
        raise NotImplementedError(
            f"{'+'.join(stages)}: the PyTorch port serves None+SVTR+None+CTC, "
            "TPS+ResNet+BiLSTM+Attn and None+ResNet+BiLSTM+Attn so far; VGG and RCNN "
            "come in later slices (see ROADMAP.md)")
    if stages[1] == "ResNet" and quant != "none":
        raise NotImplementedError("w8a8 serving of TRBA (the int8 conv path) is not ported")


class Extractor(nn.Module):
    """Returns [B, T, hidden].  SVTR: SVTR -> mean over H -> ``seq_linear``
    (the "None" sequence stage still projects to ``hidden_size``).  TRBA:
    TPS -> ResNet -> mean over H -> two BiLSTMs (``seq0``, ``seq1``); RBA
    the same without the TPS."""

    def __init__(self, transformation: str = "None",
                 feature_extraction: str = "SVTR",
                 sequence_modeling: str = "None", input_channel: int = 4,
                 output_channel: int = 512, hidden_size: int = 256,
                 img_size: Tuple[int, int] = (32, 256),
                 svtr: Optional[Mapping] = None, quant: str = "none",
                 num_fiducial: int = 20):
        super().__init__()
        _check_supported((transformation, feature_extraction, sequence_modeling), quant)
        if feature_extraction == "SVTR":
            self.feature = SVTRExtractor(input_channel, output_channel, img_size,
                                         **dict(svtr or {}), quant=quant)
            self.seq_linear = Dense(output_channel, hidden_size)
        else:
            if transformation == "TPS":
                self.transformation = TPSTransformer(num_fiducial, img_size, input_channel)
            self.feature = ResNetExtractor(input_channel, output_channel)
            self.seq0 = BidirectionalLSTM(output_channel, hidden_size, hidden_size)
            self.seq1 = BidirectionalLSTM(hidden_size, hidden_size, hidden_size)

    def forward(self, image: torch.Tensor, train: bool = False) -> torch.Tensor:
        if isinstance(self.feature, SVTRExtractor):
            return self.seq_linear(self.feature(image, train).mean(dim=1))
        if hasattr(self, "transformation"):
            image = self.transformation(image, train)
        seq = self.feature(image, train).mean(dim=1)
        return self.seq1(self.seq0(seq))


class Recognizer(nn.Module):
    """Extractor + growable classifier ``fc`` (CTC head, or the Attn
    decoder's generator); returns {"predict", "feature"}."""

    def __init__(self, num_classes: int, prediction: str = "CTC",
                 transformation: str = "None", feature_extraction: str = "SVTR",
                 sequence_modeling: str = "None", input_channel: int = 4,
                 output_channel: int = 512, hidden_size: int = 256,
                 img_size: Tuple[int, int] = (32, 256),
                 svtr: Optional[Mapping] = None, quant: str = "none",
                 num_fiducial: int = 20, batch_max_length: int = 25):
        super().__init__()
        _check_supported((transformation, feature_extraction, sequence_modeling, prediction))
        self.extractor = Extractor(transformation, feature_extraction,
                                   sequence_modeling, input_channel,
                                   output_channel, hidden_size, img_size, svtr, quant,
                                   num_fiducial)
        self.fc = Dense(hidden_size, num_classes)
        self.prediction = (AttentionDecoder(hidden_size, hidden_size, num_classes,
                                            batch_max_length)
                           if prediction == "Attn" else None)

    def forward(self, image: torch.Tensor, text: Optional[torch.Tensor] = None,
                train: bool = False, is_train: Optional[bool] = None,
                class_count: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """``text`` (Attn): [B, 1] whose first entry is the [SOS] id
        (greedy), or [B, batch_max_length + 1] ids (teacher-forced,
        ``is_train``, which defaults to ``train``); ``class_count`` (Attn):
        the decoder's true vocabulary size."""
        feature = self.extractor(image, train)
        if self.prediction is None:
            return {"predict": self.fc(feature), "feature": feature}
        if text is None:
            raise ValueError("the Attn decoder needs text: [SOS] and, teacher-forced, the "
                             "characters")
        return {"predict": self.prediction(feature, text, self.fc, class_count,
                                           train if is_train is None else is_train),
                "feature": feature}


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
        svtr=opt.get("svtr"), quant=quant, num_fiducial=opt.num_fiducial,
        batch_max_length=opt.batch_max_length)
