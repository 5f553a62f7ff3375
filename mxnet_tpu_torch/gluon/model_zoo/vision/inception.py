"""Inception v3 (counterpart of
``mxnet_tpu/gluon/model_zoo/vision/inception.py``); it takes 299²
inputs."""
from __future__ import annotations

from ... import nn
from ...block import HybridBlock
from ._common import concat, no_pretrained

__all__ = ["Inception3", "inception_v3"]


def _make_basic_conv(**kwargs):
    out = nn.HybridSequential(prefix="")
    out.add(nn.Conv2D(use_bias=False, **kwargs))
    out.add(nn.BatchNorm(epsilon=0.001))
    out.add(nn.Activation("relu"))
    return out


class _Branches(HybridBlock):
    """Child branches on the same input, concatenated on channels."""

    def __init__(self, branches, **kwargs):
        super().__init__(**kwargs)
        for i, b in enumerate(branches):
            self.register_child(b, f"branch{i}")

    def forward(self, x):
        return concat([b(x) for b in self._children.values()])

    def hybrid_forward(self, F, x):
        # reference inception.py:27-28
        return F.concat(*[b(x) for b in self._children.values()], dim=1)


def _make_branch(use_pool, *conv_settings):
    out = nn.HybridSequential(prefix="")
    if use_pool == "avg":
        out.add(nn.AvgPool2D(pool_size=3, strides=1, padding=1))
    elif use_pool == "max":
        out.add(nn.MaxPool2D(pool_size=3, strides=2))
    setting_names = ["channels", "kernel_size", "strides", "padding"]
    for setting in conv_settings:
        kwargs = {setting_names[i]: value
                  for i, value in enumerate(setting) if value is not None}
        out.add(_make_basic_conv(**kwargs))
    return out


def _make_A(pool_features, prefix):
    return _Branches([
        _make_branch(None, (64, 1, None, None)),
        _make_branch(None, (48, 1, None, None), (64, 5, None, 2)),
        _make_branch(None, (64, 1, None, None), (96, 3, None, 1),
                     (96, 3, None, 1)),
        _make_branch("avg", (pool_features, 1, None, None)),
    ], prefix=prefix)


def _make_B(prefix):
    return _Branches([
        _make_branch(None, (384, 3, 2, None)),
        _make_branch(None, (64, 1, None, None), (96, 3, None, 1),
                     (96, 3, 2, None)),
        _make_branch("max"),
    ], prefix=prefix)


def _make_C(channels_7x7, prefix):
    return _Branches([
        _make_branch(None, (192, 1, None, None)),
        _make_branch(None, (channels_7x7, 1, None, None),
                     (channels_7x7, (1, 7), None, (0, 3)),
                     (192, (7, 1), None, (3, 0))),
        _make_branch(None, (channels_7x7, 1, None, None),
                     (channels_7x7, (7, 1), None, (3, 0)),
                     (channels_7x7, (1, 7), None, (0, 3)),
                     (channels_7x7, (7, 1), None, (3, 0)),
                     (192, (1, 7), None, (0, 3))),
        _make_branch("avg", (192, 1, None, None)),
    ], prefix=prefix)


def _make_D(prefix):
    return _Branches([
        _make_branch(None, (192, 1, None, None), (320, 3, 2, None)),
        _make_branch(None, (192, 1, None, None),
                     (192, (1, 7), None, (0, 3)),
                     (192, (7, 1), None, (3, 0)),
                     (192, 3, 2, None)),
        _make_branch("max"),
    ], prefix=prefix)


class _SplitConcat(HybridBlock):
    """A branch whose tail splits into parallel convs (inception E)."""

    def __init__(self, head, tails, **kwargs):
        super().__init__(**kwargs)
        self.head = head
        for i, t in enumerate(tails):
            self.register_child(t, f"tail{i}")
        self._tails = tails

    def forward(self, x):
        y = self.head(x) if self.head is not None else x
        return concat([t(y) for t in self._tails])

    def hybrid_forward(self, F, x):
        # reference inception.py:102-104
        y = self.head(x) if self.head is not None else x
        return F.concat(*[t(y) for t in self._tails], dim=1)


def _make_E(prefix):
    return _Branches([
        _make_branch(None, (320, 1, None, None)),
        _SplitConcat(
            _make_basic_conv(channels=384, kernel_size=1),
            [_make_basic_conv(channels=384, kernel_size=(1, 3),
                              padding=(0, 1)),
             _make_basic_conv(channels=384, kernel_size=(3, 1),
                              padding=(1, 0))]),
        _SplitConcat(
            _make_branch(None, (448, 1, None, None), (384, 3, None, 1)),
            [_make_basic_conv(channels=384, kernel_size=(1, 3),
                              padding=(0, 1)),
             _make_basic_conv(channels=384, kernel_size=(3, 1),
                              padding=(1, 0))]),
        _make_branch("avg", (192, 1, None, None)),
    ], prefix=prefix)


class Inception3(HybridBlock):
    def __init__(self, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            self.features.add(_make_basic_conv(
                channels=32, kernel_size=3, strides=2))
            self.features.add(_make_basic_conv(channels=32, kernel_size=3))
            self.features.add(_make_basic_conv(
                channels=64, kernel_size=3, padding=1))
            self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
            self.features.add(_make_basic_conv(channels=80, kernel_size=1))
            self.features.add(_make_basic_conv(channels=192,
                                               kernel_size=3))
            self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
            self.features.add(_make_A(32, "A1_"))
            self.features.add(_make_A(64, "A2_"))
            self.features.add(_make_A(64, "A3_"))
            self.features.add(_make_B("B_"))
            self.features.add(_make_C(128, "C1_"))
            self.features.add(_make_C(160, "C2_"))
            self.features.add(_make_C(160, "C3_"))
            self.features.add(_make_C(192, "C4_"))
            self.features.add(_make_D("D_"))
            self.features.add(_make_E("E1_"))
            self.features.add(_make_E("E2_"))
            self.features.add(nn.AvgPool2D(pool_size=8))
            self.features.add(nn.Dropout(0.5))
            self.output = nn.Dense(classes)

    def forward(self, x):
        return self.output(self.features(x))


def inception_v3(pretrained=False, ctx=None, root=None, **kwargs):
    no_pretrained(pretrained)
    return Inception3(**kwargs)
