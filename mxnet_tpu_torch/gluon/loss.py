"""Losses (counterpart of ``mxnet_tpu/gluon/loss.py``).

Each loss computes per-sample values averaged over every axis but the
batch axis (``PoissonNLLLoss`` over all, ``TripletLoss`` summed), scaled
by ``sample_weight`` (broadcast) and the constructor's ``weight``, as
the reference's ``_apply_weighting`` does.  ``CTCLoss`` waits for its
op (ROADMAP §A 4).
"""
from __future__ import annotations

import math
import numbers

import torch

from ..base import MXNetError
from ..ops.nn import activation, log_softmax, pick
from ..ops.reduce import norm
from .block import HybridBlock

__all__ = ["Loss", "L2Loss", "L1Loss", "SigmoidBinaryCrossEntropyLoss",
           "SigmoidBCELoss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss",
           "KLDivLoss", "HuberLoss", "HingeLoss", "SquaredHingeLoss",
           "LogisticLoss", "TripletLoss", "PoissonNLLLoss",
           "CosineEmbeddingLoss"]


def _apply_weighting(loss, weight=None, sample_weight=None):
    if sample_weight is not None:
        loss = loss * sample_weight
    if weight is not None:
        if not isinstance(weight, numbers.Number):
            raise MXNetError("weight must be a number")
        loss = loss * weight
    return loss


def _other_dims(x, batch_axis):
    """Every axis of ``x`` but ``batch_axis``."""
    return [d for d in range(x.dim()) if d != batch_axis % max(x.dim(), 1)]


def _softrelu(x):
    return activation(x, act_type="softrelu")


class Loss(HybridBlock):
    def __init__(self, weight, batch_axis, **kwargs):
        super().__init__(**kwargs)
        self._weight = weight
        self._batch_axis = batch_axis

    def __repr__(self):
        return (f"{self.__class__.__name__}(batch_axis={self._batch_axis}, "
                f"w={self._weight})")

    def _batch_mean(self, loss):
        """The mean over every axis but the batch axis."""
        dims = _other_dims(loss, self._batch_axis)
        return loss.mean(dim=dims) if dims else loss

    def _weighted_mean(self, loss, sample_weight, weight=None):
        return self._batch_mean(_apply_weighting(
            loss, self._weight if weight is None else weight,
            sample_weight))


class L2Loss(Loss):
    """``weight / 2 * (label - pred)^2``."""

    def __init__(self, weight=1.0, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def forward(self, pred, label, sample_weight=None):
        loss = torch.square(label.reshape(pred.shape) - pred)
        return self._weighted_mean(loss, sample_weight, self._weight / 2)


class L1Loss(Loss):
    """``|label - pred|``."""

    def __init__(self, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def forward(self, pred, label, sample_weight=None):
        loss = torch.abs(label.reshape(pred.shape) - pred)
        return self._weighted_mean(loss, sample_weight)


class SigmoidBinaryCrossEntropyLoss(Loss):
    """Binary cross-entropy of ``sigmoid(pred)`` (of ``pred`` with
    ``from_sigmoid``), in the stable form; ``pos_weight`` scales the
    positive term."""

    def __init__(self, from_sigmoid=False, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_sigmoid = from_sigmoid

    def forward(self, pred, label, sample_weight=None, pos_weight=None):
        label = label.reshape(pred.shape)
        if not self._from_sigmoid:
            if pos_weight is None:
                loss = torch.relu(pred) - pred * label + \
                    _softrelu(-torch.abs(pred))
            else:
                log_weight = 1 + (pos_weight - 1) * label
                loss = torch.relu(pred) - pred * label + \
                    (_softrelu(-torch.abs(pred)) + torch.relu(-pred)) * \
                    log_weight
        else:
            eps = 1e-12
            if pos_weight is None:
                loss = -(torch.log(pred + eps) * label
                         + torch.log(1.0 - pred + eps) * (1.0 - label))
            else:
                loss = -(torch.log(pred + eps) * label * pos_weight
                         + torch.log(1.0 - pred + eps) * (1.0 - label))
        return self._weighted_mean(loss, sample_weight)


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


class SoftmaxCrossEntropyLoss(Loss):
    """``-log_softmax(pred)[label]`` per sample (sparse labels), or
    ``-sum(log_softmax(pred) * label)`` (dense)."""

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


class KLDivLoss(Loss):
    """``label * (log(label) - pred)``, ``pred`` log-probabilities (or
    logits, ``from_logits=False``)."""

    def __init__(self, from_logits=True, axis=-1, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._axis = axis

    def forward(self, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = log_softmax(pred, axis=self._axis)
        loss = label * (torch.log(label + 1e-12) - pred)
        return self._weighted_mean(loss, sample_weight)


class HuberLoss(Loss):
    """``|d| - rho / 2`` above ``rho``, ``d^2 / (2 rho)`` below."""

    def __init__(self, rho=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._rho = rho

    def forward(self, pred, label, sample_weight=None):
        loss = torch.abs(label.reshape(pred.shape) - pred)
        loss = torch.where(loss > self._rho, loss - 0.5 * self._rho,
                           (0.5 / self._rho) * torch.square(loss))
        return self._weighted_mean(loss, sample_weight)


class HingeLoss(Loss):
    """``max(0, margin - pred * label)``, labels -1 or 1."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def forward(self, pred, label, sample_weight=None):
        loss = torch.relu(self._margin - pred * label.reshape(pred.shape))
        return self._weighted_mean(loss, sample_weight)


class SquaredHingeLoss(Loss):
    """``max(0, margin - pred * label)^2``."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def forward(self, pred, label, sample_weight=None):
        loss = torch.square(torch.relu(
            self._margin - pred * label.reshape(pred.shape)))
        return self._weighted_mean(loss, sample_weight)


class LogisticLoss(Loss):
    """``log(1 + exp(-pred * label))`` for labels in {-1, 1}
    (``"signed"``) or {0, 1} (``"binary"``)."""

    def __init__(self, weight=None, batch_axis=0, label_format="signed",
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._label_format = label_format
        if label_format not in ("signed", "binary"):
            raise MXNetError(f"label_format can only be signed or binary, "
                             f"got {label_format}")

    def forward(self, pred, label, sample_weight=None):
        label = label.reshape(pred.shape)
        if self._label_format == "signed":
            label = (label + 1.0) / 2.0
        loss = torch.relu(pred) - pred * label + \
            _softrelu(-torch.abs(pred))
        return self._weighted_mean(loss, sample_weight)


class TripletLoss(Loss):
    """``max(0, |positive - pred|^2 - |negative - pred|^2 + margin)`` per
    sample (summed over the non-batch axes)."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def forward(self, pred, positive, negative, sample_weight=None):
        positive = positive.reshape(pred.shape)
        negative = negative.reshape(pred.shape)
        d = torch.square(positive - pred) - torch.square(negative - pred)
        dims = _other_dims(d, self._batch_axis)
        loss = torch.relu((d.sum(dim=dims) if dims else d) + self._margin)
        return _apply_weighting(loss, self._weight, sample_weight)


class PoissonNLLLoss(Loss):
    """The Poisson negative log-likelihood, averaged over everything;
    ``compute_full`` adds Stirling's term for targets above 1."""

    def __init__(self, weight=None, from_logits=True, batch_axis=0,
                 compute_full=False, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._compute_full = compute_full

    def forward(self, pred, target, sample_weight=None, epsilon=1e-08):
        target = target.reshape(pred.shape)
        if self._from_logits:
            loss = torch.exp(pred) - target * pred
        else:
            loss = pred - target * torch.log(pred + epsilon)
        if self._compute_full:
            stirling = target * torch.log(target + 1e-12) - target + \
                0.5 * torch.log(2 * target * math.pi + 1e-12)
            loss = loss + torch.where(target > 1, stirling,
                                      torch.zeros_like(stirling))
        return _apply_weighting(loss, self._weight, sample_weight).mean()


class CosineEmbeddingLoss(Loss):
    """``1 - cos(input1, input2)`` for label 1, else ``max(0, cos -
    margin)``."""

    def __init__(self, weight=None, batch_axis=0, margin=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def forward(self, input1, input2, label, sample_weight=None):
        input1 = input1.reshape(input2.shape)
        cos_sim = self._cosine_similarity(input1, input2)
        label = label.reshape(-1, 1)
        loss = torch.where(label == 1, 1.0 - cos_sim,
                           torch.relu(cos_sim - self._margin))
        return self._weighted_mean(loss, sample_weight)

    @staticmethod
    def _cosine_similarity(x, y, axis=-1):
        x_norm = norm(x, axis=axis).reshape(-1, 1)
        y_norm = norm(y, axis=axis).reshape(-1, 1)
        x_dot_y = (x * y).sum(dim=axis).reshape(-1, 1)
        return x_dot_y / torch.clamp(x_norm * y_norm, min=1e-12)
