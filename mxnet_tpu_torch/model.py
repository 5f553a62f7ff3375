"""Checkpoint helpers + legacy FeedForward shim (counterpart of
``mxnet_tpu/model.py``).

Reference parity: python/mxnet/model.py (``save_checkpoint`` :394,
``load_checkpoint`` :442 — the `-symbol.json` + `-NNNN.params` format).
The files are the reference's bytes for the same symbol and arrays.
"""
from __future__ import annotations

import logging

from . import ndarray as nd
from . import symbol as sym_mod
from .base import MXNetError

__all__ = ["save_checkpoint", "load_checkpoint", "load_params",
           "BatchEndParam", "FeedForward"]


class BatchEndParam:
    def __init__(self, epoch, nbatch, eval_metric, locals=None):
        self.epoch = epoch
        self.nbatch = nbatch
        self.eval_metric = eval_metric
        self.locals = locals


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params,
                    remove_amp_cast=True, keep_n=None):
    """Save `prefix-symbol.json` + `prefix-NNNN.params` (reference
    model.py:394), routed through the atomic versioned writer
    (resilience.checkpoint): write-to-temp + fsync + rename, a CRC32
    manifest, and a `latest` pointer — a crash mid-write can no longer
    leave a torn ``.params`` that ``load_checkpoint`` loads blindly.
    The legacy file layout is unchanged; ``keep_n`` optionally prunes
    old versions (None keeps all, the historical behavior)."""
    from .resilience.checkpoint import CheckpointManager

    CheckpointManager(prefix, keep_n=keep_n).save(
        epoch, symbol=symbol, arg_params=arg_params,
        aux_params=aux_params)
    logging.info("Saved checkpoint to \"%s-%04d.params\"", prefix,
                 epoch)


def load_params(prefix, epoch):
    """(arg_params, aux_params) from a .params file.

    When the checkpoint carries a manifest (every save since the
    atomic writer landed), the payload is CRC-verified in the SAME
    read that decodes it: a truncated/corrupt file raises instead of
    silently loading garbage weights;
    ``CheckpointManager(prefix).load()`` falls back to the previous
    good version instead."""
    from .resilience.checkpoint import CheckpointManager

    save_dict = CheckpointManager(prefix).load_params_dict(epoch)
    arg_params, aux_params = {}, {}
    for k, v in save_dict.items():
        tp, name = k.split(":", 1)
        if tp == "arg":
            arg_params[name] = v
        elif tp == "aux":
            aux_params[name] = v
    return arg_params, aux_params


def load_checkpoint(prefix, epoch):
    """(symbol, arg_params, aux_params) (reference model.py:442)."""
    symbol = sym_mod.load(f"{prefix}-symbol.json")
    arg_params, aux_params = load_params(prefix, epoch)
    return symbol, arg_params, aux_params


class FeedForward:
    """Legacy pre-Module API: thin shim over Module (reference
    model.py FeedForward, deprecated even in the reference)."""

    def __init__(self, symbol, ctx=None, num_epoch=None,
                 optimizer="sgd", initializer=None, arg_params=None,
                 aux_params=None, **kwargs):
        self.symbol = symbol
        self.ctx = ctx
        self.num_epoch = num_epoch
        self.optimizer = optimizer
        self.initializer = initializer
        self.arg_params = arg_params
        self.aux_params = aux_params
        self._kwargs = kwargs
        self._module = None

    def fit(self, X, y=None, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", logger=None, work_load_list=None,
            monitor=None, eval_end_callback=None,
            eval_batch_end_callback=None):
        from . import module as mod_module

        module = mod_module.Module(
            self.symbol, context=self.ctx,
            label_names=[n for n in self.symbol.list_arguments()
                         if n.endswith("label")] or None)
        # hyper-params given to the ctor (learning_rate, momentum, wd,
        # ...) flow to the optimizer, reference FeedForward contract
        hyper = tuple(
            (k, v) for k, v in self._kwargs.items()
            if k in ("learning_rate", "momentum", "wd", "rescale_grad",
                     "clip_gradient", "beta1", "beta2", "epsilon"))
        module.fit(
            X, eval_data=eval_data, eval_metric=eval_metric,
            epoch_end_callback=epoch_end_callback,
            batch_end_callback=batch_end_callback, kvstore=kvstore,
            optimizer=self.optimizer,
            optimizer_params=hyper or (("learning_rate", 0.01),),
            initializer=self.initializer,
            arg_params=self.arg_params, aux_params=self.aux_params,
            num_epoch=self.num_epoch)
        self._module = module
        self.arg_params, self.aux_params = module.get_params()
        return self

    def predict(self, X, num_batch=None, return_data=False, reset=True):
        if self._module is None:
            raise MXNetError("call fit before predict")
        out = self._module.predict(X, num_batch=num_batch, reset=reset)
        return out.asnumpy() if hasattr(out, "asnumpy") else out

    def score(self, X, eval_metric="acc", num_batch=None, **kwargs):
        """Evaluate on a data iterator (reference model.py
        FeedForward.score)."""
        if self._module is None:
            raise MXNetError("call fit before score")
        from . import metric as metric_mod

        if not hasattr(eval_metric, "update"):
            eval_metric = metric_mod.create(eval_metric)
        res = self._module.score(X, eval_metric, num_batch=num_batch)
        return res[0][1] if res else None

    @staticmethod
    def load(prefix, epoch, ctx=None, **kwargs):
        symbol, arg_params, aux_params = load_checkpoint(prefix, epoch)
        return FeedForward(symbol, ctx=ctx, arg_params=arg_params,
                           aux_params=aux_params, begin_epoch=epoch,
                           **kwargs)

    def save(self, prefix, epoch=None):
        if epoch is None:
            epoch = self.num_epoch
        save_checkpoint(prefix, epoch, self.symbol, self.arg_params or {},
                        self.aux_params or {})
