"""ResNet v1 and v2 (counterpart of
``mxnet_tpu/gluon/model_zoo/vision/resnet.py``).

The same structure and parameter names as the reference
(BasicBlockV1 / BottleneckV1 / BasicBlockV2 / BottleneckV2, the
18/34/50/101/152 layer configs), so its weights carry across by name.
Every layer past the stem takes its input width at construction, so a
net's shapes are known before a forward (``parallel.make_train_step``
builds its step from them); the stem's image channels are
``in_channels`` (default 3; 0 defers them to the first forward, as the
reference's stem does, with the same names and shapes after it).  The
default layout is the reference's,
channel-first (NCHW inputs, OIHW weights); ``layout="NHWC"`` builds the
net channel-last.  A channel-last BottleneckV1 built with
``no_bias=True`` runs its bn2 → relu → conv3 tail through the fused op
(``ops/pallas_conv.py``) when that is enabled and the block trains; in
any other layout or with the zoo's biases the tail runs layer by layer,
as in the reference.  On NDArrays the block trains exactly when
``autograd.is_training()`` (``gluon.block``), so in ``autograd.record()``
the fused tail runs and bn2's running statistics move, as in the
reference's eager Gluon.
"""
from __future__ import annotations

from ....base import MXNetError
from ... import nn
from ...block import HybridBlock

__all__ = ["ResNetV1", "ResNetV2", "BasicBlockV1", "BasicBlockV2",
           "BottleneckV1", "BottleneckV2", "get_resnet",
           "resnet18_v1", "resnet34_v1", "resnet50_v1", "resnet101_v1",
           "resnet152_v1", "resnet18_v2", "resnet34_v2", "resnet50_v2",
           "resnet101_v2", "resnet152_v2"]


def _conv3x3(channels, stride, in_channels):
    return nn.Conv2D(channels, kernel_size=3, strides=stride, padding=1,
                     use_bias=False, in_channels=in_channels)


class BasicBlockV1(HybridBlock):
    # no_bias is accepted for API uniformity with BottleneckV1: every
    # conv here is already bias-free
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 no_bias=False, **kwargs):
        super().__init__(**kwargs)
        self.body = nn.HybridSequential(prefix="")
        self.body.add(_conv3x3(channels, stride, in_channels))
        self.body.add(nn.BatchNorm(in_channels=channels))
        self.body.add(nn.Activation("relu"))
        self.body.add(_conv3x3(channels, 1, channels))
        self.body.add(nn.BatchNorm(in_channels=channels))
        if downsample:
            self.downsample = nn.HybridSequential(prefix="")
            self.downsample.add(nn.Conv2D(
                channels, kernel_size=1, strides=stride, use_bias=False,
                in_channels=in_channels))
            self.downsample.add(nn.BatchNorm(in_channels=channels))
        else:
            self.downsample = None

    def forward(self, x):
        residual = x
        x = self.body(x)
        if self.downsample is not None:
            residual = self.downsample(residual)
        return (residual + x).relu()

    def hybrid_forward(self, F, x):
        # reference resnet.py:59-64
        residual = x
        x = self.body(x)
        if self.downsample is not None:
            residual = self.downsample(residual)
        return F.Activation(residual + x, act_type="relu")


class BottleneckV1(HybridBlock):
    # The reference zoo leaves biases on the two 1x1 body convs;
    # ``no_bias=True`` drops them (the reference benchmark symbol's
    # choice), which also makes the bn2 -> relu -> conv3 tail fusable.
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 no_bias=False, **kwargs):
        super().__init__(**kwargs)
        use_bias = not no_bias
        mid = channels // 4
        self.body = nn.HybridSequential(prefix="")
        self.body.add(nn.Conv2D(mid, kernel_size=1, strides=stride,
                                use_bias=use_bias, in_channels=in_channels))
        self.body.add(nn.BatchNorm(in_channels=mid))
        self.body.add(nn.Activation("relu"))
        self.body.add(_conv3x3(mid, 1, mid))
        self.body.add(nn.BatchNorm(in_channels=mid))
        self.body.add(nn.Activation("relu"))
        self.body.add(nn.Conv2D(channels, kernel_size=1, strides=1,
                                use_bias=use_bias, in_channels=mid))
        self.body.add(nn.BatchNorm(in_channels=channels))
        if downsample:
            self.downsample = nn.HybridSequential(prefix="")
            self.downsample.add(nn.Conv2D(
                channels, kernel_size=1, strides=stride, use_bias=False,
                in_channels=in_channels))
            self.downsample.add(nn.BatchNorm(in_channels=channels))
        else:
            self.downsample = None
        # the fused tail is eligible when the net is channel-last and
        # conv3 is bias-free; the body structure is verified so a
        # reshuffle disables the fusion instead of fusing wrong layers
        self._fusable_tail = (not use_bias
                              and nn.layout.is_channel_last()
                              and self._tail_structure_ok())

    def _tail_structure_ok(self):
        body = list(self.body._children.values())
        if len(body) != 8:
            return False
        bn2, act2, conv3 = body[4], body[5], body[6]
        return (isinstance(bn2, nn.BatchNorm)
                and isinstance(conv3, nn.Conv2D)
                and isinstance(body[7], nn.BatchNorm)
                and getattr(act2, "_act_type", None) == "relu"
                and conv3._kwargs["kernel"] == (1, 1)
                and conv3._kwargs["stride"] == (1, 1))

    def _fused_tail(self, t):
        """bn2 -> relu -> conv3 through the fused op, folding the batch
        statistics into bn2's running averages like the layer; None
        when the fused path does not apply to this call."""
        from ....ops import pallas_conv

        body = list(self.body._children.values())
        bn2, conv3 = body[4], body[6]
        if not (pallas_conv.enabled() and self.training
                and not bn2._kwargs["use_global_stats"]):
            return None
        y, bmean, bvar = pallas_conv.fused_bn_relu_conv1x1(
            t, bn2.gamma, bn2.beta, conv3.weight, eps=bn2._kwargs["eps"],
            fix_gamma=bn2._kwargs["fix_gamma"])
        bn2.update_running(bmean, bvar)
        return y

    def forward(self, x):
        residual = x
        if self._fusable_tail:
            body = list(self.body._children.values())
            t = x
            for layer in body[:4]:   # conv1, bn1, relu, conv2 (3x3)
                t = layer(t)
            y = self._fused_tail(t)
            if y is not None:
                x = body[7](y)       # bn3
            else:                    # ineligible call: plain tail
                x = t
                for layer in body[4:]:
                    x = layer(x)
        else:
            x = self.body(x)
        if self.downsample is not None:
            residual = self.downsample(residual)
        return (x + residual).relu()

    def hybrid_forward(self, F, x):
        # reference resnet.py:148-166: the graph is the layer graph, the
        # fused tail being taken only off the symbolic path (:151)
        residual = x
        x = self.body(x)
        if self.downsample is not None:
            residual = self.downsample(residual)
        return F.Activation(x + residual, act_type="relu")


class BasicBlockV2(HybridBlock):
    # pre-activation: bn -> relu -> conv, twice; the projection shortcut
    # takes the first activation.  no_bias is accepted for API
    # uniformity: every conv here is already bias-free
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 no_bias=False, **kwargs):
        super().__init__(**kwargs)
        self.bn1 = nn.BatchNorm(in_channels=in_channels)
        self.conv1 = _conv3x3(channels, stride, in_channels)
        self.bn2 = nn.BatchNorm(in_channels=channels)
        self.conv2 = _conv3x3(channels, 1, channels)
        if downsample:
            self.downsample = nn.Conv2D(channels, 1, stride, use_bias=False,
                                        in_channels=in_channels)
        else:
            self.downsample = None

    def forward(self, x):
        residual = x
        x = self.bn1(x).relu()
        if self.downsample is not None:
            residual = self.downsample(x)
        x = self.conv1(x)
        x = self.bn2(x).relu()
        x = self.conv2(x)
        return x + residual

    def hybrid_forward(self, F, x):
        # reference resnet.py:186-196
        residual = x
        x = self.bn1(x)
        x = F.Activation(x, act_type="relu")
        if self.downsample is not None:
            residual = self.downsample(x)
        x = self.conv1(x)
        x = self.bn2(x)
        x = F.Activation(x, act_type="relu")
        x = self.conv2(x)
        return x + residual


class BottleneckV2(HybridBlock):
    # pre-activation bottleneck; the stride is on the 3x3 conv.  no_bias
    # is accepted for API uniformity: every conv here is bias-free
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 no_bias=False, **kwargs):
        super().__init__(**kwargs)
        mid = channels // 4
        self.bn1 = nn.BatchNorm(in_channels=in_channels)
        self.conv1 = nn.Conv2D(mid, kernel_size=1, strides=1,
                               use_bias=False, in_channels=in_channels)
        self.bn2 = nn.BatchNorm(in_channels=mid)
        self.conv2 = _conv3x3(mid, stride, mid)
        self.bn3 = nn.BatchNorm(in_channels=mid)
        self.conv3 = nn.Conv2D(channels, kernel_size=1, strides=1,
                               use_bias=False, in_channels=mid)
        if downsample:
            self.downsample = nn.Conv2D(channels, 1, stride, use_bias=False,
                                        in_channels=in_channels)
        else:
            self.downsample = None

    def forward(self, x):
        residual = x
        x = self.bn1(x).relu()
        if self.downsample is not None:
            residual = self.downsample(x)
        x = self.conv1(x)
        x = self.bn2(x).relu()
        x = self.conv2(x)
        x = self.bn3(x).relu()
        x = self.conv3(x)
        return x + residual

    def hybrid_forward(self, F, x):
        # reference resnet.py:219-232
        residual = x
        x = self.bn1(x)
        x = F.Activation(x, act_type="relu")
        if self.downsample is not None:
            residual = self.downsample(x)
        x = self.conv1(x)
        x = self.bn2(x)
        x = F.Activation(x, act_type="relu")
        x = self.conv2(x)
        x = self.bn3(x)
        x = F.Activation(x, act_type="relu")
        x = self.conv3(x)
        return x + residual


class ResNetV1(HybridBlock):
    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, no_bias=False, in_channels=3, **kwargs):
        super().__init__(**kwargs)
        if len(layers) != len(channels) - 1:
            raise MXNetError("ResNetV1 needs one more channel count than "
                             "stages")
        self._no_bias = no_bias
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            if thumbnail:
                self.features.add(_conv3x3(channels[0], 1, in_channels))
            else:
                self.features.add(nn.Conv2D(channels[0], 7, 2, 3,
                                            use_bias=False,
                                            in_channels=in_channels))
                self.features.add(nn.BatchNorm(in_channels=channels[0]))
                self.features.add(nn.Activation("relu"))
                self.features.add(nn.MaxPool2D(3, 2, 1))
            for i, num_layer in enumerate(layers):
                stride = 1 if i == 0 else 2
                self.features.add(self._make_layer(
                    block, num_layer, channels[i + 1], stride, i + 1,
                    in_channels=channels[i]))
            self.features.add(nn.GlobalAvgPool2D())
            self.output = nn.Dense(classes, in_units=channels[-1])

    def _make_layer(self, block, layers, channels, stride, stage_index,
                    in_channels=0):
        extra = {"no_bias": True} if self._no_bias else {}
        layer = nn.HybridSequential(prefix=f"stage{stage_index}_")
        with layer.name_scope():
            layer.add(block(channels, stride, channels != in_channels,
                            in_channels=in_channels, prefix="", **extra))
            for _ in range(layers - 1):
                layer.add(block(channels, 1, False, in_channels=channels,
                                prefix="", **extra))
        return layer

    def forward(self, x):
        return self.output(self.features(x))


class ResNetV2(HybridBlock):
    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, no_bias=False, in_channels=3, **kwargs):
        super().__init__(**kwargs)
        if len(layers) != len(channels) - 1:
            raise MXNetError("ResNetV2 needs one more channel count than "
                             "stages")
        self._no_bias = no_bias
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            # normalizes the input image: no affine, statistics only
            self.features.add(nn.BatchNorm(scale=False, center=False,
                                           in_channels=in_channels))
            if thumbnail:
                self.features.add(_conv3x3(channels[0], 1, in_channels))
            else:
                self.features.add(nn.Conv2D(channels[0], 7, 2, 3,
                                            use_bias=False,
                                            in_channels=in_channels))
                self.features.add(nn.BatchNorm(in_channels=channels[0]))
                self.features.add(nn.Activation("relu"))
                self.features.add(nn.MaxPool2D(3, 2, 1))
            in_channels = channels[0]
            for i, num_layer in enumerate(layers):
                stride = 1 if i == 0 else 2
                self.features.add(self._make_layer(
                    block, num_layer, channels[i + 1], stride, i + 1,
                    in_channels=in_channels))
                in_channels = channels[i + 1]
            self.features.add(nn.BatchNorm(in_channels=in_channels))
            self.features.add(nn.Activation("relu"))
            self.features.add(nn.GlobalAvgPool2D())
            self.features.add(nn.Flatten())
            self.output = nn.Dense(classes, in_units=in_channels)

    _make_layer = ResNetV1._make_layer

    def forward(self, x):
        return self.output(self.features(x))


resnet_spec = {
    18: ("basic_block", [2, 2, 2, 2], [64, 64, 128, 256, 512]),
    34: ("basic_block", [3, 4, 6, 3], [64, 64, 128, 256, 512]),
    50: ("bottle_neck", [3, 4, 6, 3], [64, 256, 512, 1024, 2048]),
    101: ("bottle_neck", [3, 4, 23, 3], [64, 256, 512, 1024, 2048]),
    152: ("bottle_neck", [3, 8, 36, 3], [64, 256, 512, 1024, 2048]),
}

resnet_net_versions = [ResNetV1, ResNetV2]
resnet_block_versions = [
    {"basic_block": BasicBlockV1, "bottle_neck": BottleneckV1},
    {"basic_block": BasicBlockV2, "bottle_neck": BottleneckV2},
]


def get_resnet(version, num_layers, pretrained=False, layout=None,
               **kwargs):
    """ResNet ``version`` 1 or 2 with ``num_layers`` layers.
    ``layout="NHWC"`` builds the net channel-last (inputs NHWC); the
    default follows the ``nn.default_layout`` scope (NCHW)."""
    if num_layers not in resnet_spec:
        raise MXNetError(
            f"Invalid number of layers: {num_layers}. "
            f"Options are {sorted(resnet_spec.keys())}")
    if version not in (1, 2):
        raise MXNetError(f"Invalid resnet version: {version} (1 or 2)")
    if pretrained:
        raise MXNetError("pretrained weights are not downloadable; load "
                         "them with Block.load_parameters or "
                         "parallel.load_jax_params")
    block_type, layers, channels = resnet_spec[num_layers]
    with nn.default_layout(layout):
        return resnet_net_versions[version - 1](
            resnet_block_versions[version - 1][block_type], layers,
            channels, **kwargs)


def resnet18_v1(**kwargs):
    return get_resnet(1, 18, **kwargs)


def resnet34_v1(**kwargs):
    return get_resnet(1, 34, **kwargs)


def resnet50_v1(**kwargs):
    return get_resnet(1, 50, **kwargs)


def resnet101_v1(**kwargs):
    return get_resnet(1, 101, **kwargs)


def resnet152_v1(**kwargs):
    return get_resnet(1, 152, **kwargs)


def resnet18_v2(**kwargs):
    return get_resnet(2, 18, **kwargs)


def resnet34_v2(**kwargs):
    return get_resnet(2, 34, **kwargs)


def resnet50_v2(**kwargs):
    return get_resnet(2, 50, **kwargs)


def resnet101_v2(**kwargs):
    return get_resnet(2, 101, **kwargs)


def resnet152_v2(**kwargs):
    return get_resnet(2, 152, **kwargs)
