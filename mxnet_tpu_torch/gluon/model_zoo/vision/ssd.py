"""SSD object detectors (counterpart of
``mxnet_tpu/gluon/model_zoo/vision/ssd.py``; upstream's example/ssd,
the VGG16-reduced SSD over the multibox contrib ops).

One HybridBlock gives (cls_preds, loc_preds, anchors) with static
shapes; the training targets come from ``MultiBoxTarget``, detections
from ``MultiBoxDetection``, so the reference's training recipe carries
over unchanged.  The parameter names are the reference's, so
``.params`` files cross both ways.
"""
from __future__ import annotations

import torch

from .... import ndarray as nd
from ....ops.detection_ops import multibox_prior
from ...block import HybridBlock
from ...nn import Conv2D, HybridSequential, MaxPool2D

__all__ = ["SSD", "get_ssd", "ssd_300_vgg16_reduced", "ssd_512_vgg16",
           "ssd_300_resnet18"]


def _vgg_reduced_features():
    """VGG16-reduced backbone stages (upstream example/ssd
    symbol/vgg16_reduced.py): stage 1 ends at conv4_3, the first anchor
    scale; stage 2 ends at fc7 (atrous fc6, 1x1 fc7)."""
    stage1 = HybridSequential()
    for channels, n in [(64, 2), (128, 2), (256, 3)]:
        for _ in range(n):
            stage1.add(Conv2D(channels, 3, padding=1, activation="relu"))
        stage1.add(MaxPool2D(2, 2))
    for _ in range(3):
        stage1.add(Conv2D(512, 3, padding=1, activation="relu"))
    stage2 = HybridSequential()
    stage2.add(MaxPool2D(2, 2))
    for _ in range(3):
        stage2.add(Conv2D(512, 3, padding=1, activation="relu"))
    stage2.add(MaxPool2D(3, 1, padding=1))
    stage2.add(Conv2D(1024, 3, padding=6, dilation=6,
                      activation="relu"))  # fc6 atrous
    stage2.add(Conv2D(1024, 1, activation="relu"))  # fc7
    return [stage1, stage2]


def _resnet18_features():
    """ResNet-18 v1 through stage 3 (stride 16), then stage 4."""
    from .resnet import get_resnet

    # the stem defers its input width, so that the initializer draws in
    # the reference's order
    net = get_resnet(1, 18, classes=10, in_channels=0)
    children = list(net.features._children.values())
    # features = [Conv, BN, ReLU, MaxPool, stage1..4, GlobalAvgPool]
    stage1 = HybridSequential()
    for c in children[:-2]:
        stage1.add(c)
    stage2 = HybridSequential()
    stage2.add(children[-2])
    return [stage1, stage2]


class SSD(HybridBlock):
    """Single-shot detector heads over a multi-stage backbone.

    forward(x) -> (cls_preds (B, N, classes+1), loc_preds (B, N*4),
    anchors (1, N, 4)).
    """

    def __init__(self, backbone_stages, num_classes, sizes, ratios,
                 extra_channels=(512, 256, 256, 256), prefix=None,
                 params=None, **kwargs):
        super().__init__(prefix=prefix, params=params, **kwargs)
        self.num_classes = num_classes  # foreground classes
        self._sizes = sizes
        self._ratios = ratios
        with self.name_scope():
            self.stages = HybridSequential()
            for s in backbone_stages:
                self.stages.add(s)
            # extra downsampling blocks: 1x1 squeeze, 3x3 stride 2
            self.extras = HybridSequential()
            for i in range(len(sizes) - len(backbone_stages)):
                blk = HybridSequential()
                ch = extra_channels[min(i, len(extra_channels) - 1)]
                blk.add(Conv2D(ch // 2, 1, activation="relu"))
                blk.add(Conv2D(ch, 3, strides=2, padding=1,
                               activation="relu"))
                self.extras.add(blk)
            self.class_preds = HybridSequential()
            self.loc_preds = HybridSequential()
            for i in range(len(sizes)):
                a = len(sizes[i]) + len(ratios[i]) - 1
                self.class_preds.add(
                    Conv2D(a * (num_classes + 1), 3, padding=1))
                self.loc_preds.add(Conv2D(a * 4, 3, padding=1))

    def forward(self, x):
        feats = []
        for stage in self.stages._children.values():
            x = stage(x)
            feats.append(x)
        for blk in self.extras._children.values():
            x = blk(x)
            feats.append(x)
        cls_out, loc_out, anchor_out = [], [], []
        cps = list(self.class_preds._children.values())
        lps = list(self.loc_preds._children.values())
        b = x.shape[0]
        for i, feat in enumerate(feats):
            cp = cps[i](feat)  # (B, A*(C+1), h, w)
            lp = lps[i](feat)  # (B, A*4, h, w)
            anchor_out.append(multibox_prior(
                feat, sizes=tuple(self._sizes[i]),
                ratios=tuple(self._ratios[i]), clip=False))
            cls_out.append(cp.permute(0, 2, 3, 1).reshape(
                b, -1, self.num_classes + 1))
            loc_out.append(lp.permute(0, 2, 3, 1).reshape(b, -1))
        return (torch.cat(cls_out, dim=1), torch.cat(loc_out, dim=1),
                torch.cat(anchor_out, dim=1))

    # ------------------------------------------------- train / inference
    def training_targets(self, anchors, class_preds, labels,
                         overlap_threshold=0.5,
                         negative_mining_ratio=3.0):
        """``MultiBoxTarget`` on the forward's NDArrays (upstream's
        training_targets in example/ssd/symbol/symbol_builder.py):
        (loc_target, loc_mask, cls_target), constants to autograd."""
        cls_pred_t = class_preds.transpose(axes=(0, 2, 1))
        return nd.invoke(
            "_contrib_MultiBoxTarget", [anchors, labels, cls_pred_t],
            overlap_threshold=overlap_threshold,
            negative_mining_ratio=negative_mining_ratio,
            negative_mining_thresh=0.5)

    def detect(self, cls_preds, loc_preds, anchors, nms_threshold=0.45,
               threshold=0.01, nms_topk=400):
        """``MultiBoxDetection`` of the forward's NDArrays: (B, N, 6)."""
        cls_prob = nd.softmax(cls_preds, axis=-1).transpose(
            axes=(0, 2, 1))
        return nd.invoke(
            "_contrib_MultiBoxDetection", [cls_prob, loc_preds, anchors],
            nms_threshold=nms_threshold, threshold=threshold,
            nms_topk=nms_topk)


def get_ssd(backbone="vgg16_reduced", num_classes=20, sizes=None,
            ratios=None, **kwargs):
    if sizes is None:
        sizes = [[0.1, 0.141], [0.2, 0.272], [0.37, 0.447],
                 [0.54, 0.619], [0.71, 0.79], [0.88, 0.961]]
    if ratios is None:
        ratios = [[1, 2, 0.5]] * 2 + [[1, 2, 0.5, 3, 1.0 / 3]] * 3 + \
            [[1, 2, 0.5]]
        ratios = ratios[: len(sizes)]
    if backbone == "vgg16_reduced":
        stages = _vgg_reduced_features()
    elif backbone == "resnet18":
        stages = _resnet18_features()
    else:
        raise ValueError(f"unknown ssd backbone {backbone}")
    return SSD(stages, num_classes, sizes, ratios, **kwargs)


def ssd_300_vgg16_reduced(num_classes=20, **kwargs):
    """SSD-300 with the VGG16-reduced backbone (upstream
    example/ssd/train.py's defaults)."""
    return get_ssd("vgg16_reduced", num_classes, **kwargs)


def ssd_512_vgg16(num_classes=20, **kwargs):
    """SSD-512: seven anchor scales (upstream example/ssd
    symbol_factory's 512 configuration)."""
    sizes = [[0.07, 0.1025], [0.15, 0.2121], [0.3, 0.3674],
             [0.45, 0.4950], [0.6, 0.6315], [0.75, 0.7721],
             [0.9, 0.9557]]
    ratios = [[1, 2, 0.5]] * 2 + [[1, 2, 0.5, 3, 1.0 / 3]] * 3 + \
        [[1, 2, 0.5]] * 2
    return get_ssd("vgg16_reduced", num_classes, sizes=sizes,
                   ratios=ratios, **kwargs)


def ssd_300_resnet18(num_classes=20, **kwargs):
    sizes = [[0.1, 0.141], [0.2, 0.272], [0.37, 0.447], [0.54, 0.619]]
    ratios = [[1, 2, 0.5]] * 4
    return get_ssd("resnet18", num_classes, sizes=sizes, ratios=ratios,
                   **kwargs)
