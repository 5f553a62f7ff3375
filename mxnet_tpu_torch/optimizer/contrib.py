"""Contrib optimizers (counterpart of ``mxnet_tpu/optimizer/contrib.py``).

``GroupAdaGrad`` lives in the main registry, so ``create('groupadagrad')``
finds it; this module is the reference's import surface for it."""
from .optimizer import GroupAdaGrad

__all__ = ["GroupAdaGrad"]
