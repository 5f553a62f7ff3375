"""Activation block (counterpart of
``mxnet_tpu/gluon/nn/activations.py``)."""
from __future__ import annotations

from ...ops.nn import activation
from ..block import HybridBlock

__all__ = ["Activation"]


class Activation(HybridBlock):
    def __init__(self, activation, **kwargs):
        self._act_type = activation
        super().__init__(**kwargs)

    def _alias(self):
        return self._act_type

    def forward(self, x):
        return activation(x, act_type=self._act_type)

    def hybrid_forward(self, F, x):
        # reference activations.py:19-20
        return F.Activation(x, act_type=self._act_type)

    def extra_repr(self):
        return self._act_type
