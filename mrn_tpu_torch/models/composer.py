"""Model composition (mirrors ``mrn_tpu/models/composer.py``):
Transformation -> FeatureExtraction -> mean over height -> SequenceModeling
-> prediction head, composed stage by stage as in JAX.  Every combination
of the four stages builds, in eval and train mode:

- Transformation: "None", or "TPS" (``transformation``, the RARE TPS warp
  to ``img_size``: the kernel in eval mode, the differentiable warp in
  train mode);
- FeatureExtraction (``feature``): "VGG" (CRNN), "ResNet" (TRBA), "RCNN"
  (GRCNN) or "SVTR"; ``svtr`` (keyword arguments of ``SVTRExtractor``:
  ``embed_dim``, ``depth``, ``num_heads``, ``drop_path_rate``) narrows
  SVTR for tests, the configs leave it unset;
- SequenceModeling: "BiLSTM" (two BiLSTMs, ``seq0`` and ``seq1``) or
  "None" (``seq_linear``, a Dense to ``hidden_size``, as the reference
  projects);
- Prediction: "CTC" (the head ``fc``) or "Attn" (the decoder
  ``prediction``, whose generator is ``fc``).

``train`` drives BatchNorm, DropPath and the TPS warp; ``is_train``
drives the Attn decoder, teacher-forced on ``text`` ([SOS] and the
characters) or greedy from its [SOS] column, and defaults to ``train``,
JAX's split; ``class_count`` restricts the decoder to an expert's true
vocabulary.  An unknown stage name raises ``ValueError``.

``quant`` ("none", "calib", "int8") is the w8a8 mode of the SVTR Blocks
(``models.svtr.Block``) or of every conv of VGG, ResNet and RCNN
(``models.common.TorchConv``); the TPS localization net, the BiLSTMs and
the heads stay float, as in JAX.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from mrn_tpu_torch.models.attention import AttentionDecoder
from mrn_tpu_torch.models.common import Dense
from mrn_tpu_torch.models.lstm import BidirectionalLSTM
from mrn_tpu_torch.models.rcnn import RCNNExtractor
from mrn_tpu_torch.models.resnet import ResNetExtractor
from mrn_tpu_torch.models.svtr import SVTRExtractor
from mrn_tpu_torch.models.tps import TPSTransformer
from mrn_tpu_torch.models.vgg import VGGExtractor

__all__ = ["Extractor", "Recognizer", "build_recognizer", "sequence_length"]

_CONV_EXTRACTORS = {"VGG": VGGExtractor, "ResNet": ResNetExtractor, "RCNN": RCNNExtractor}
_TRANSFORMATIONS = ("None", "TPS")
_FEATURES = ("VGG", "ResNet", "RCNN", "SVTR")
_SEQUENCES = ("None", "BiLSTM")
_PREDICTIONS = ("CTC", "Attn")


def sequence_length(feature_extraction: str, img_w: int) -> int:
    """Visual sequence length T for a backbone at width img_w."""
    if feature_extraction == "VGG":
        return img_w // 4 - 1
    if feature_extraction == "SVTR":
        return img_w // 4
    if feature_extraction in ("ResNet", "RCNN"):
        return img_w // 4 + 1
    raise ValueError(feature_extraction)


def _check_stage(stage: str, name: str, known: Tuple[str, ...]) -> None:
    if name not in known:
        raise ValueError(f"{stage}={name!r}: not one of {', '.join(known)}")


class Extractor(nn.Module):
    """NHWC image -> [B, T, hidden]: (``transformation`` ->) ``feature`` ->
    mean over H -> ``seq0`` / ``seq1`` (BiLSTM) or ``seq_linear`` (None)."""

    def __init__(self, transformation: str = "None",
                 feature_extraction: str = "SVTR",
                 sequence_modeling: str = "None", input_channel: int = 4,
                 output_channel: int = 512, hidden_size: int = 256,
                 img_size: Tuple[int, int] = (32, 256),
                 svtr: Optional[Mapping] = None, quant: str = "none",
                 num_fiducial: int = 20):
        super().__init__()
        for stage, name, known in (("Transformation", transformation, _TRANSFORMATIONS),
                                   ("FeatureExtraction", feature_extraction, _FEATURES),
                                   ("SequenceModeling", sequence_modeling, _SEQUENCES)):
            _check_stage(stage, name, known)
        if transformation == "TPS":
            self.transformation = TPSTransformer(num_fiducial, img_size, input_channel)
        if feature_extraction == "SVTR":
            self.feature = SVTRExtractor(input_channel, output_channel, img_size,
                                         **dict(svtr or {}), quant=quant)
        else:
            self.feature = _CONV_EXTRACTORS[feature_extraction](input_channel, output_channel,
                                                                quant=quant)
        if sequence_modeling == "BiLSTM":
            self.seq0 = BidirectionalLSTM(output_channel, hidden_size, hidden_size)
            self.seq1 = BidirectionalLSTM(hidden_size, hidden_size, hidden_size)
        else:
            self.seq_linear = Dense(output_channel, hidden_size)

    def forward(self, image: torch.Tensor, train: bool = False) -> torch.Tensor:
        if hasattr(self, "transformation"):
            image = self.transformation(image, train)
        seq = self.feature(image, train).mean(dim=1)
        if hasattr(self, "seq_linear"):
            return self.seq_linear(seq)
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
        _check_stage("Prediction", prediction, _PREDICTIONS)
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
    Blocks or convs in w8a8 mode ``quant``."""
    return Recognizer(
        num_classes=num_classes, prediction=opt.Prediction,
        transformation=opt.Transformation,
        feature_extraction=opt.FeatureExtraction,
        sequence_modeling=opt.SequenceModeling,
        input_channel=opt.input_channel, output_channel=opt.output_channel,
        hidden_size=opt.hidden_size, img_size=(opt.imgH, opt.imgW),
        svtr=opt.get("svtr"), quant=quant, num_fiducial=opt.num_fiducial,
        batch_max_length=opt.batch_max_length)
