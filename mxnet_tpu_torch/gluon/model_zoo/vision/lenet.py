"""LeNet-5 (counterpart of ``mxnet_tpu/gluon/model_zoo/vision/lenet.py``),
the reference's ``train_mnist.py`` model as a HybridBlock."""
from __future__ import annotations

from ... import nn
from ...block import HybridBlock

__all__ = ["LeNet", "lenet"]


class LeNet(HybridBlock):
    def __init__(self, classes=10, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            self.features.add(nn.Conv2D(20, kernel_size=5,
                                        activation="tanh"))
            self.features.add(nn.MaxPool2D(pool_size=2, strides=2))
            self.features.add(nn.Conv2D(50, kernel_size=5,
                                        activation="tanh"))
            self.features.add(nn.MaxPool2D(pool_size=2, strides=2))
            self.features.add(nn.Flatten())
            self.features.add(nn.Dense(500, activation="tanh"))
            self.output = nn.Dense(classes)

    def forward(self, x):
        return self.output(self.features(x))


def lenet(**kwargs):
    kwargs.pop("pretrained", None)
    return LeNet(**kwargs)
