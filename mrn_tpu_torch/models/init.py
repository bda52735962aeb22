"""Random weights in the JAX package's init distributions, as numpy trees in
the flax layout (bridged into the port with ``bridge.from_flax``).

An extractor is drawn stage by stage, transformation -> feature ->
sequence, then the recognizer's head, each stage in its own distribution:

- SVTR ``feature``: Block kernels ``truncated_normal(0.02)`` with zero
  biases, convs kaiming-normal (fan in) with zero biases, LayerNorm scale
  1 and bias 1 (the reference SVTR quirk), BatchNorm scale 1 / bias 0 /
  mean 0 / var 1;
- VGG (CRNN), RCNN (GRCNN) and ResNet (TRBA) ``feature`` and the TPS
  localization net: every conv kernel, conv bias (VGG's
  ``conv0``-``conv3`` and ``conv6``, GRCNN's ``conv0``; the other convs
  are bias-free) and Dense layer ``U(-1/sqrt(fan_in), 1/sqrt(fan_in))``,
  BatchNorm 1 / 0 / 0 / 1, and ``localization_fc2`` a zero kernel with the
  RARE fiducial bias (so every crop starts from the same near-identity
  grid);
- the BiLSTMs' and the attention cell's LSTM weights and biases
  ``U(-1/sqrt(H), 1/sqrt(H))``, ``char_embeddings`` ``N(0, 1)``;
- ``seq_linear``, ``fc`` and the router's Dense layers the torch default
  ``U(-1/sqrt(fan_in), 1/sqrt(fan_in))``, the router's LayerNorms 1 / 0.

A new expert is drawn this way (the JAX learner's ``change_model``); task
0's expert then gets ``models.surgery.apply_reference_init``.  A DERNet
(``random_der``) stacks extractors drawn one after another,
then its heads: CTC ``fc`` (over the concatenated features) and
``aux_fc``; Attn ``fc`` and ``aux_fc`` (both ``[hidden, C]``, the
generators), ``prediction`` (a decoder over the concatenation) and
``aux_prediction`` (over one extractor's features).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from mrn_tpu_torch.models.composer import sequence_length
from mrn_tpu_torch.models.tps import _fc2_bias

__all__ = ["random_block", "random_der", "random_extractor", "random_mrn",
           "random_recognizer", "random_router"]

_SVTR = dict(embed_dim=(64, 128, 256), depth=(3, 6, 3))


def _trunc02(rng, shape):
    """truncated_normal(stddev=.02, lower=-2, upper=2)."""
    z = rng.standard_normal(shape)
    bad = np.abs(z) > 2.0
    while bad.any():
        z[bad] = rng.standard_normal(int(bad.sum()))
        bad = np.abs(z) > 2.0
    return (0.02 * z).astype(np.float32)


def _torch_dense(rng, fan_in, fan_out):
    bound = 1.0 / np.sqrt(fan_in)
    return {"kernel": rng.uniform(-bound, bound, (fan_in, fan_out)).astype(np.float32),
            "bias": rng.uniform(-bound, bound, (fan_out,)).astype(np.float32)}


def _conv(rng, cin, cout):
    std = np.sqrt(2.0 / (cin * 9))  # kaiming normal, fan_in
    return {"kernel": (std * rng.standard_normal((3, 3, cin, cout))).astype(np.float32),
            "bias": np.zeros((cout,), np.float32)}


def _affine(c, bias):
    """LayerNorm/BatchNorm scale 1 and a constant bias."""
    return {"scale": np.ones((c,), np.float32),
            "bias": np.full((c,), bias, np.float32)}


def random_block(rng, c, hidden=None):
    hidden = hidden or 4 * c
    ones, zeros = np.ones((c,), np.float32), np.zeros
    return dict(norm1_scale=ones.copy(), norm1_bias=ones.copy(),
                qkv_kernel=_trunc02(rng, (c, 3 * c)), qkv_bias=zeros((3 * c,), np.float32),
                proj_kernel=_trunc02(rng, (c, c)), proj_bias=zeros((c,), np.float32),
                norm2_scale=ones.copy(), norm2_bias=ones.copy(),
                fc1_kernel=_trunc02(rng, (c, hidden)), fc1_bias=zeros((hidden,), np.float32),
                fc2_kernel=_trunc02(rng, (hidden, c)), fc2_bias=zeros((c,), np.float32))


def random_recognizer(rng, opt, num_classes):
    """One Recognizer's (params, batch_stats) trees, any stage combination
    (``opt.svtr`` may narrow an SVTR backbone: ``embed_dim``, ``depth``)."""
    extractor, stats = random_extractor(rng, opt)
    params = {"extractor": extractor, "fc": _torch_dense(rng, opt.hidden_size, num_classes)}
    if opt.Prediction == "Attn":
        params["prediction"] = _random_decoder(rng, opt.hidden_size, opt.hidden_size,
                                               num_classes)
    return params, {"extractor": stats}


def random_der(rng, opt, n_extractors, num_classes):
    """A DERNet's trees: ``n_extractors`` extractors stacked under
    ``extractors`` (drawn one after another), then the heads (CTC: ``fc``
    over the concatenated features and ``aux_fc`` over one extractor's;
    Attn: the generators ``fc`` and ``aux_fc``, the decoders
    ``prediction`` over the concatenation and ``aux_prediction``)."""
    trees = [random_extractor(rng, opt) for _ in range(n_extractors)]

    def stack(*xs):
        if isinstance(xs[0], dict):
            return {k: stack(*(x[k] for x in xs)) for k in xs[0]}
        return np.stack(xs)

    h = opt.hidden_size
    params = {"extractors": stack(*(p for p, _ in trees))}
    if opt.Prediction == "Attn":
        params.update(fc=_torch_dense(rng, h, num_classes),
                      aux_fc=_torch_dense(rng, h, num_classes),
                      prediction=_random_decoder(rng, n_extractors * h, h, num_classes),
                      aux_prediction=_random_decoder(rng, h, h, num_classes))
    else:
        params.update(fc=_torch_dense(rng, n_extractors * h, num_classes),
                      aux_fc=_torch_dense(rng, h, num_classes))
    return params, {"extractors": stack(*(s for _, s in trees))}


def random_extractor(rng, opt):
    """One Extractor's (params, batch_stats) trees, drawn stage by stage:
    the TPS ``transformation`` (``opt.Transformation="TPS"``), the
    ``feature`` stage (``opt.FeatureExtraction``), then the sequence stage
    (``seq0`` / ``seq1``, or ``seq_linear``)."""
    t = _Trees(rng)
    if opt.Transformation == "TPS":
        _random_tps(t, opt)
    _FEATURE_DRAWS[opt.FeatureExtraction](t, opt)
    if opt.SequenceModeling == "BiLSTM":
        t.bilstms(opt.output_channel, opt.hidden_size)
    else:
        t.params["seq_linear"] = _torch_dense(rng, opt.output_channel, opt.hidden_size)
    return t.params, t.stats


def _random_svtr(t, opt):
    """SVTR's ``feature`` (``opt.svtr`` may narrow it)."""
    rng = t.rng
    arch = dict(_SVTR, **(opt.get("svtr") or {}))
    e0, e1, e2 = arch["embed_dim"]
    h0, w0 = opt.imgH // 4, opt.imgW // 4
    ln = lambda c: _affine(c, 1.0)  # noqa: E731  (SVTR quirk: LN bias 1)
    bn = lambda c: _affine(c, 0.0)  # noqa: E731
    feature = {
        "patch_embed": {"conv1": _conv(rng, opt.input_channel, e0 // 2), "bn1": bn(e0 // 2),
                        "conv2": _conv(rng, e0 // 2, e0), "bn2": bn(e0)},
        "pos_embed": _trunc02(rng, (1, h0 * w0, e0)),
        "sub_sample1": {"conv": _conv(rng, e0, e1), "norm": ln(e1)},
        "sub_sample2": {"conv": _conv(rng, e1, e2), "norm": ln(e2)},
        "sub_sample3": {"conv": _conv(rng, e2, opt.output_channel),
                        "norm": ln(opt.output_channel)},
    }
    for stage, (dim, n) in enumerate(zip((e0, e1, e2), arch["depth"]), start=1):
        for i in range(n):
            feature[f"blocks{stage}_{i}"] = random_block(rng, dim)
    t.params["feature"] = feature
    t.stats["feature"] = {"patch_embed": {
        "bn1": {"mean": np.zeros((e0 // 2,), np.float32),
                "var": np.ones((e0 // 2,), np.float32)},
        "bn2": {"mean": np.zeros((e0,), np.float32),
                "var": np.ones((e0,), np.float32)}}}


def _uniform(rng, shape, fan_in):
    bound = 1.0 / np.sqrt(fan_in)
    return rng.uniform(-bound, bound, shape).astype(np.float32)


class _Trees:
    """Builds a params tree and its batch_stats tree side by side."""

    def __init__(self, rng):
        self.rng, self.params, self.stats = rng, {}, {}

    @staticmethod
    def _at(tree, path):
        for key in path:
            tree = tree.setdefault(key, {})
        return tree

    def conv(self, path, name, k, cin, cout, bias=False):
        """A ``TorchConv`` (k x k) under ``path``, bias-free unless ``bias``."""
        fan_in = k * k * cin
        leaf = {"kernel": _uniform(self.rng, (k, k, cin, cout), fan_in)}
        if bias:
            leaf["bias"] = _uniform(self.rng, (cout,), fan_in)
        self._at(self.params, path)[name] = {"Conv_0": leaf}

    def bn(self, path, name, c):
        """A BatchNorm: scale 1, bias 0, mean 0, var 1."""
        self._at(self.params, path)[name] = {"scale": np.ones(c, np.float32),
                                             "bias": np.zeros(c, np.float32)}
        self._at(self.stats, path)[name] = {"mean": np.zeros(c, np.float32),
                                            "var": np.ones(c, np.float32)}

    def conv_bn(self, path, conv, bn, k, cin, cout):
        """A bias-free ``TorchConv`` (k x k) and its BatchNorm under ``path``."""
        self.conv(path, conv, k, cin, cout)
        self.bn(path, bn, cout)

    def bilstms(self, oc, h):
        """The sequence stage: ``seq0`` (``oc`` -> ``h``) and ``seq1``."""
        for name, in_size in (("seq0", oc), ("seq1", h)):
            self.params[name] = {"rnn": {"fwd": _lstm(self.rng, in_size, h),
                                         "bwd": _lstm(self.rng, in_size, h)},
                                 "linear": _torch_dense(self.rng, 2 * h, h)}


def _lstm(rng, in_size, hidden):
    """One LSTM direction (or cell) in torch's layout, U(+-1/sqrt(H))."""
    g = 4 * hidden
    return {name: _uniform(rng, shape, hidden) for name, shape in
            (("w_ih", (g, in_size)), ("w_hh", (g, hidden)), ("b_ih", (g,)),
             ("b_hh", (g,)))}


def _random_decoder(rng, input_size, h, num_classes):
    """An Attn decoder over features of ``input_size``: the attention cell
    (its LSTM on the context and a 256-wide embedding) and
    ``char_embeddings``."""
    cell = dict(_lstm(rng, input_size + 256, h),
                i2h={"kernel": _uniform(rng, (input_size, h), input_size)},
                h2h=_torch_dense(rng, h, h),
                score={"kernel": _uniform(rng, (h, 1), h)})
    return {"attention_cell": cell,
            "char_embeddings": rng.standard_normal((num_classes, 256)).astype(np.float32)}


def _random_tps(t, opt):
    """The TPS ``transformation``: the localization net at its fixed widths
    and ``localization_fc2``, a zero kernel with the RARE fiducial bias."""
    f = opt.num_fiducial
    loc = ("transformation", "localization")
    chans = (opt.input_channel, 64, 128, 256, 512)
    for i in range(4):
        t.conv_bn(loc, f"conv{i}", f"bn{i}", 3, chans[i], chans[i + 1])
    t._at(t.params, loc).update(
        localization_fc1=_torch_dense(t.rng, 512, 256),
        localization_fc2={"kernel": np.zeros((256, 2 * f), np.float32),
                          "bias": _fc2_bias(f)})


def _random_resnet(t, opt):
    """TRBA's ResNet ``feature``."""
    oc = opt.output_channel
    feat = ("feature",)
    widths = (oc // 4, oc // 2, oc, oc)
    t.conv_bn(feat, "conv0_1", "bn0_1", 3, opt.input_channel, oc // 16)
    t.conv_bn(feat, "conv0_2", "bn0_2", 3, oc // 16, oc // 8)
    inplanes = oc // 8
    for i, (planes, blocks) in enumerate(zip(widths, (1, 2, 5, 3)), start=1):
        for j in range(blocks):
            block = feat + (f"layer{i}", f"block{j}")
            cin = inplanes if j == 0 else planes
            t.conv_bn(block, "conv1", "bn1", 3, cin, planes)
            t.conv_bn(block, "conv2", "bn2", 3, planes, planes)
            if cin != planes:
                t.conv_bn(block, "down_conv", "down_bn", 1, cin, planes)
        if i < 4:
            t.conv_bn(feat, f"conv{i}", f"bn{i}", 3, planes, planes)
        inplanes = planes
    t.conv_bn(feat, "conv4_1", "bn4_1", 2, oc, oc)
    t.conv_bn(feat, "conv4_2", "bn4_2", 2, oc, oc)


def _random_vgg(t, opt):
    """CRNN's VGG ``feature``."""
    oc = opt.output_channel
    o = (oc // 8, oc // 4, oc // 2, oc)
    feat = ("feature",)
    for name, cin, cout in (("conv0", opt.input_channel, o[0]), ("conv1", o[0], o[1]),
                            ("conv2", o[1], o[2]), ("conv3", o[2], o[2])):
        t.conv(feat, name, 3, cin, cout, bias=True)
    t.conv_bn(feat, "conv4", "bn4", 3, o[2], o[3])
    t.conv_bn(feat, "conv5", "bn5", 3, o[3], o[3])
    t.conv(feat, "conv6", 2, o[3], o[3], bias=True)


def _random_rcnn(t, opt):
    """GRCNN's RCNN ``feature``: ``conv0``, three GRCLs of 5 steps and
    ``conv1`` / ``bn1``."""
    oc = opt.output_channel
    o = (oc // 8, oc // 4, oc // 2, oc)
    feat = ("feature",)
    t.conv(feat, "conv0", 3, opt.input_channel, o[0], bias=True)
    for g, (cin, cout) in enumerate(((o[0], o[0]), (o[0], o[1]), (o[1], o[2]))):
        grcl = feat + (f"grcl{g}",)
        t.conv(grcl, "wgf_u", 1, cin, cout)
        t.conv(grcl, "wf_u", 3, cin, cout)
        t.conv(grcl, "wgr_x", 1, cout, cout)
        t.conv(grcl, "wr_x", 3, cout, cout)
        t.bn(grcl, "bn_x_init", cout)
        for i in range(5):
            for name in ("gfu", "grx", "rx", "fu", "gx"):
                t.bn(grcl, f"u{i}_bn_{name}", cout)
    t.conv_bn(feat, "conv1", "bn1", 2, o[2], o[3])


_FEATURE_DRAWS = {"SVTR": _random_svtr, "ResNet": _random_resnet, "VGG": _random_vgg,
                  "RCNN": _random_rcnn}


def random_router(rng, opt, n_experts):
    """A fresh router stack (``dm_router``, ``channel_route``, ``route``)."""
    h, i = opt.hidden_size, n_experts
    t = sequence_length(opt.FeatureExtraction, opt.imgW)
    ln = lambda c: _affine(c, 0.0)  # noqa: E731
    return {
        "dm_router": {"norm": ln(h), "proj_1": _torch_dense(rng, h, 2 * h),
                      "spatial_norm": ln(h), "spatial_proj": _torch_dense(rng, i * t, i * t),
                      "proj_2": _torch_dense(rng, h, h), "channel_norm": ln(t),
                      "channel_proj": _torch_dense(rng, i * h, i * h),
                      "proj_3": _torch_dense(rng, h, h)},
        "channel_route": _torch_dense(rng, i * h, i),
        "route": _torch_dense(rng, t, 1),
    }


def random_mrn(rng, opt, class_counts: Sequence[int]):
    """MRNNet trees: experts stacked on axis 0 (each fc, and an Attn
    expert's char_embeddings rows, zero-padded from its own class count to
    the total, as the JAX learner stacks them) plus a fresh router stack."""
    num_classes = max(class_counts)
    trees = []
    for count in class_counts:
        p, s = random_recognizer(rng, opt, count)
        grow = num_classes - count
        p["fc"]["kernel"] = np.pad(p["fc"]["kernel"], ((0, 0), (0, grow)))
        p["fc"]["bias"] = np.pad(p["fc"]["bias"], (0, grow))
        if "prediction" in p:
            emb = p["prediction"]["char_embeddings"]
            p["prediction"]["char_embeddings"] = np.pad(emb, ((0, grow), (0, 0)))
        trees.append((p, s))

    def stack(*xs):
        if isinstance(xs[0], dict):
            return {k: stack(*(x[k] for x in xs)) for k in xs[0]}
        return np.stack(xs)

    params = dict(random_router(rng, opt, len(class_counts)),
                  experts=stack(*(p for p, _ in trees)))
    return params, {"experts": stack(*(s for _, s in trees))}
