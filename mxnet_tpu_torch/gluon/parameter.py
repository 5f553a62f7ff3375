"""Parameters (counterpart of ``mxnet_tpu/gluon/parameter.py``).

A :class:`Parameter` is the record of one named weight: its full
reference-style name (``resnetv10_stage1_conv0_weight``), shape, dtype,
initializer and ``grad_req``.  The tensor itself is registered on the
owning :class:`~mxnet_tpu_torch.gluon.block.Block` the PyTorch way: an
``nn.Parameter`` when it is trained, a buffer when ``grad_req`` is
``null`` (BatchNorm running statistics), so ``.to()``,
``state_dict`` and ``torch.func.functional_call`` see it.

Shapes are fixed at construction.  The reference's deferred shape
inference (a 0 in a shape, resolved at the first forward) is not
ported: the port's layers take ``in_channels``/``in_units`` and raise
when they are missing.
"""
from __future__ import annotations

from ..base import MXNetError

__all__ = ["Parameter", "ParameterDict"]


class Parameter:
    """Metadata of one named weight; :meth:`data` is its tensor."""

    def __init__(self, name, grad_req="write", shape=None, dtype="float32",
                 init=None, differentiable=True):
        if grad_req not in ("write", "add", "null"):
            raise MXNetError(f"grad_req must be write/add/null, got "
                             f"{grad_req}")
        self.name = name
        self.shape = tuple(int(s) for s in shape) if shape is not None \
            else None
        self.dtype = dtype
        self.init = init
        self.grad_req = grad_req if differentiable else "null"
        self._block = None
        self._attr = None

    def _bind(self, block, attr):
        if self.shape is None or any(s <= 0 for s in self.shape):
            raise MXNetError(
                f"Parameter {self.name} has shape {self.shape}: deferred "
                "shape inference is not ported; pass in_channels / "
                "in_units to the layer")
        self._block = block
        self._attr = attr

    def data(self):
        """The tensor registered on the owning block."""
        if self._block is None:
            raise MXNetError(f"Parameter {self.name} is not bound to a "
                             "block")
        return getattr(self._block, self._attr)

    def __repr__(self):
        return f"Parameter {self.name} (shape={self.shape}, " \
               f"dtype={self.dtype})"


class ParameterDict:
    """Prefix-scoped factory of :class:`Parameter` records (the part of
    the reference's ``ParameterDict`` the port's layers use)."""

    def __init__(self, prefix=""):
        self.prefix = prefix

    def get(self, name, **kwargs):
        return Parameter(self.prefix + name, **kwargs)
