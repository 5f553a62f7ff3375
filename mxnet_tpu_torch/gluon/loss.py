"""Losses (counterpart of ``mxnet_tpu/gluon/loss.py``): the softmax
cross-entropy the ResNet train step uses."""
from __future__ import annotations

from ..base import MXNetError
from ..ops.nn import log_softmax, pick
from .block import HybridBlock

__all__ = ["Loss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss"]


class Loss(HybridBlock):
    def __init__(self, weight, batch_axis, **kwargs):
        super().__init__(**kwargs)
        self._weight = weight
        self._batch_axis = batch_axis

    def _weighted_mean(self, loss, sample_weight):
        if sample_weight is not None:
            loss = loss * sample_weight
        if self._weight is not None:
            if not isinstance(self._weight, (int, float)):
                raise MXNetError("weight must be a number")
            loss = loss * self._weight
        dims = [d for d in range(loss.dim()) if d != self._batch_axis]
        return loss.mean(dim=dims) if dims else loss


class SoftmaxCrossEntropyLoss(Loss):
    """``-log_softmax(pred)[label]`` per sample (sparse labels), or
    ``-sum(log_softmax(pred) * label)`` (dense), averaged over all but
    the batch axis (reference ``SoftmaxCrossEntropyLoss``,
    ``mxnet_tpu/gluon/loss.py:131``)."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def forward(self, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = log_softmax(pred, axis=self._axis)
        if self._sparse_label:
            loss = -pick(pred, label, axis=self._axis, keepdims=True)
        else:
            loss = -(pred * label.reshape(pred.shape)).sum(
                dim=self._axis, keepdim=True)
        return self._weighted_mean(loss, sample_weight)


SoftmaxCELoss = SoftmaxCrossEntropyLoss
