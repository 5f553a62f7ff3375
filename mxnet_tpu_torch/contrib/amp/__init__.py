"""Automatic Mixed Precision (counterpart of
``mxnet_tpu/contrib/amp``).

The policy lists (:mod:`.lists`) drive the ops themselves: a registered
op named in a list casts its floating inputs while AMP is on (the
target dtype for the matmul/convolution family, float32 for the
numerically sensitive ops, the widest input dtype for the multi-input
ops).  The hook sits in the op (``ops/registry.py``), not only in
``nd.invoke``, because the port's Gluon layers call the op functions
directly; ``invoke``, the layers and the graph executor all reach it.
A symbolic trace made while AMP is on writes the same casts into the
graph as ``amp_cast`` / ``amp_multicast`` nodes (upstream's
low-precision pass), so an exported artifact carries them and serves
without AMP on.

Loss scaling: :func:`init_trainer` + :func:`scale_loss` give the Gluon
Trainer dynamic loss scaling with overflow skipping (the
``multi_all_finite`` op).  ``init`` is process-wide; :func:`_off`
turns it off again.
"""
from __future__ import annotations

import contextlib
import functools

from ...base import MXNetError
from . import lists
from .loss_scaler import LossScaler

__all__ = ["init", "is_active", "cast_inputs", "init_trainer",
           "scale_loss", "unscale", "convert_model",
           "convert_hybrid_block", "lists", "LossScaler"]

_active = False
_target_dtype = None
_target_set = frozenset(lists.TARGET_DTYPE_OPS)
_fp32_set = frozenset(lists.FP32_OPS)
_widest_set = frozenset(lists.WIDEST_TYPE_CASTS)
#: every op name a policy list holds (the registry wraps these)
POLICY_OPS = _target_set | _fp32_set | _widest_set


def _dtype(target_dtype):
    import torch

    if isinstance(target_dtype, str):
        if target_dtype in ("bfloat16", "bf16"):
            return torch.bfloat16
        if target_dtype in ("float16", "fp16"):
            return torch.float16
    elif target_dtype in (torch.bfloat16, torch.float16):
        return target_dtype
    raise MXNetError(f"AMP target_dtype must be bfloat16 or float16, got "
                     f"{target_dtype!r}")


def init(target_dtype="bfloat16"):
    """Turn AMP on for every op call of the process (reference
    ``amp.init``); a second call with another dtype raises."""
    global _active, _target_dtype
    dt = _dtype(target_dtype)
    if _active and dt != _target_dtype:
        raise MXNetError("AMP already initialized with a different dtype")
    _target_dtype = dt
    _active = True


def is_active():
    return _active


def _off():
    """Turn AMP off (tests and scripts that scope it)."""
    global _active
    _active = False


def _is_float(a):
    import torch

    return isinstance(a, torch.Tensor) and a.is_floating_point()


def cast_inputs(op_name, arrays):
    """The policy lists applied to one op call's inputs (tensors; other
    values pass through)."""
    import torch

    if op_name in _target_set:
        return [a.to(_target_dtype) if _is_float(a) else a for a in arrays]
    if op_name in _fp32_set:
        return [a.to(torch.float32) if _is_float(a) else a for a in arrays]
    if op_name in _widest_set:
        floats = {a.dtype for a in arrays if _is_float(a)}
        if len(floats) > 1:
            widest = functools.reduce(torch.promote_types, floats)
            return [a.to(widest) if _is_float(a) else a for a in arrays]
    return list(arrays)


def cast_symbols(op_name, inputs, keep=()):
    """The same policy as graph nodes: the inputs of an op of the lists
    through ``amp_cast`` (or one ``amp_multicast``), but the slots in
    ``keep`` (auxiliary states)."""
    from ... import symbol as sym
    from ...dtype import dtype_name

    if op_name in _target_set or op_name in _fp32_set:
        dt = dtype_name(_target_dtype) if op_name in _target_set \
            else "float32"
        return [s if i in keep else sym.amp_cast(s, dtype=dt)
                for i, s in enumerate(inputs)]
    if op_name in _widest_set and len(inputs) > 1:
        return list(sym.amp_multicast(*inputs, num_outputs=len(inputs)))
    return list(inputs)


def init_trainer(trainer):
    """Attach a dynamic :class:`LossScaler` to a Gluon Trainer."""
    if getattr(trainer, "_amp_loss_scaler", None) is None:
        trainer._amp_loss_scaler = LossScaler()
        trainer._amp_original_scale = trainer._scale
    return trainer


@contextlib.contextmanager
def scale_loss(loss, trainer):
    """Scale the loss; ``trainer.step`` divides the gradients by the
    same scale (and skips the step on overflow)."""
    scaler = getattr(trainer, "_amp_loss_scaler", None)
    if scaler is None:
        raise MXNetError("call amp.init_trainer(trainer) first")
    trainer._scale = trainer._amp_original_scale / scaler.loss_scale
    if isinstance(loss, (list, tuple)):
        yield [l * scaler.loss_scale for l in loss]
    else:
        yield loss * scaler.loss_scale


def unscale(trainer):
    """Divide the current gradients by the loss scale (for clipping
    between backward and step)."""
    scaler = getattr(trainer, "_amp_loss_scaler", None)
    if scaler is None:
        raise MXNetError("call amp.init_trainer(trainer) first")
    inv = 1.0 / scaler.loss_scale
    for p in trainer._params:
        if p.grad_req == "null" or not p._initialized:
            continue
        g = p._wrap()._grad
        if g is not None:
            g._data.mul_(inv)
    trainer._scale = trainer._amp_original_scale


def convert_model(sym, arg_params, aux_params, target_dtype="bfloat16"):
    """A symbolic model for low-precision inference: its arguments cast
    to ``target_dtype`` (norm parameters and the auxiliary states stay
    fp32); the graph is returned as it is."""
    from ...ndarray.ndarray import NDArray
    from ...parallel import amp_cast_params

    dt = _dtype(str(target_dtype))
    casted = amp_cast_params({k: v._data for k, v in arg_params.items()},
                             dt)
    return sym, {k: NDArray(v) for k, v in casted.items()}, \
        dict(aux_params)


def convert_hybrid_block(block, target_dtype="bfloat16"):
    """Cast a HybridBlock's floating parameters to ``target_dtype``, but
    the norm parameters and statistics."""
    from ...dtype import dtype_name
    from ...parallel import _is_norm_stat

    dt = dtype_name(_dtype(str(target_dtype)))
    for name, p in block.collect_params().items():
        if not _is_norm_stat(name) and p._initialized and \
                p.data()._data.is_floating_point():
            p.cast(dt)
    block._clear_cached_ops()
    return block
