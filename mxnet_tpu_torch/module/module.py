"""Module: executor-backed trainable module (counterpart of
``mxnet_tpu/module/module.py``).

Reference parity: python/mxnet/module/module.py (``Module`` :40 over
``DataParallelExecutorGroup``).  One executor on one device, updated per
parameter through ``optimizer.get_updater``, as the reference updates a
Module on one context.  ``context=None`` takes ``mx.current_context()``,
``gpu(0)`` unless a ``with mx.cpu():`` scope says otherwise (the
reference's default is ``cpu()``).  A context list of more than one
device, a KVStore object and ``group2ctxs`` raise: the port assumes one
card (ROADMAP §A 11).
"""
from __future__ import annotations

import logging

import numpy as onp
import torch

from .. import initializer as init_mod
from .. import ndarray as nd
from .. import optimizer as opt
from ..base import MXNetError
from ..context import current_context
from .base_module import BaseModule

__all__ = ["Module"]


def _one_context(context):
    if context is None:
        return current_context()
    if isinstance(context, (list, tuple)):
        if len(context) != 1:
            raise MXNetError(
                f"Module(context={list(context)}): data parallelism over "
                "several devices is not ported; the port runs a Module on "
                "one card (ROADMAP §A 11)")
        return context[0]
    return context


def _check_sharding_env():
    """``MXNET_OPTIMIZER_SHARDING`` takes the reference's values; on one
    context each of them leaves the per-parameter updater in place, as
    in the reference (there is nothing to shard over)."""
    from ..config import get_env

    raw = str(get_env("MXNET_OPTIMIZER_SHARDING")).strip().lower()
    if raw and raw not in ("ps", "1", "on", "true", "yes", "0", "off",
                           "false", "no"):
        raise MXNetError(
            f"MXNET_OPTIMIZER_SHARDING={raw!r} is not a recognized "
            "value (use 'ps' to force sharding on, '0' to force it "
            "off, or unset)")


class Module(BaseModule):
    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None, group2ctxs=None,
                 compression_params=None):
        super().__init__(logger=logger)
        self._symbol = symbol
        self._data_names = list(data_names) if data_names else []
        self._label_names = list(label_names) if label_names else []
        self._context = _one_context(context)
        self._device = self._context.torch_device()
        if isinstance(group2ctxs, (list, tuple)):
            group2ctxs = group2ctxs[0] if len(group2ctxs) == 1 else \
                group2ctxs
        if group2ctxs:
            raise MXNetError(
                "group2ctxs (a graph placed over several devices) is not "
                "ported: the port runs a Module on one card "
                "(ROADMAP §A 11)")
        self._fixed_param_names = set(fixed_param_names or [])
        arg_names = symbol.list_arguments()
        self._param_names = [
            n for n in arg_names
            if n not in self._data_names and n not in self._label_names
        ]
        self._aux_names = symbol.list_auxiliary_states()
        self._exec = None
        self._data_shapes = None
        self._label_shapes = None
        self._optimizer = None
        self._updater = None
        self._arg_params = None  # preloaded checkpoint weights (load())
        self._aux_params = None
        self._grad_req = None
        self._monitor = None

    # ------------------------------------------------------- descriptors
    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def output_names(self):
        return self._symbol.list_outputs()

    @property
    def data_shapes(self):
        return self._data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_shapes(self):
        self._check_binded()
        shape_kwargs = {n: tuple(s) for n, s in self._data_shapes}
        if self._label_shapes:
            shape_kwargs.update(
                {n: tuple(s) for n, s in self._label_shapes})
        _, out_shapes, _ = self._symbol.infer_shape_partial(
            **shape_kwargs)
        return list(zip(self._symbol.list_outputs(), out_shapes))

    # ------------------------------------------------------------- bind
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False,
             shared_module=None, grad_req="write"):
        """Allocate the executor on the module's device from the data
        (and label) shapes.  ``grad_req`` is a string or a per-name
        dict; data take ``write`` only with ``inputs_need_grad``, labels
        and ``fixed_param_names`` ``null``.  With ``shared_module`` the
        parameter and auxiliary arrays are that module's own objects, so
        an update through either is seen by both."""
        if self.binded and not force_rebind:
            return
        self.for_training = for_training
        self._data_shapes = [(d[0], tuple(d[1])) for d in data_shapes]
        self._label_shapes = ([(d[0], tuple(d[1]))
                               for d in label_shapes]
                              if label_shapes else None)
        shape_kwargs = {d[0]: tuple(d[1]) for d in data_shapes}
        if label_shapes:
            shape_kwargs.update({d[0]: tuple(d[1]) for d in label_shapes})
        req = {}
        for n in self._symbol.list_arguments():
            if n in self._data_names:
                req[n] = "write" if inputs_need_grad else "null"
            elif n in self._label_names or n in self._fixed_param_names:
                req[n] = "null"
            elif not for_training:
                req[n] = "null"
            else:
                req[n] = grad_req.get(n, "write") \
                    if isinstance(grad_req, dict) else grad_req
        self._grad_req = req
        self._exec = self._symbol.simple_bind(
            self._context, grad_req=req, **shape_kwargs)
        self.binded = True
        if self._monitor is not None:
            self._monitor.install(self._exec)
        if shared_module is not None and shared_module._exec is not None:
            # share the actual parameter NDArray objects (reference:
            # shared_exec memory pool, bucketing_module.py)
            ex, shared = self._exec, shared_module._exec
            for n in self._param_names:
                if n in shared.arg_dict:
                    ex.arg_dict[n] = shared.arg_dict[n]
            for n in self._aux_names:
                if n in shared.aux_dict:
                    ex.aux_dict[n] = shared.aux_dict[n]
            ex.arg_arrays = [ex.arg_dict[n]
                             for n in self._symbol.list_arguments()]
            ex.aux_arrays = [ex.aux_dict[n] for n in self._aux_names]
            if shared_module.params_initialized:
                self.params_initialized = True
        if self._arg_params is not None:
            # weights preloaded by Module.load
            self.init_params(arg_params=self._arg_params,
                             aux_params=self._aux_params,
                             force_init=True, allow_missing=True)

    # ----------------------------------------------------------- params
    def init_params(self, initializer=None, arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        """Each parameter from ``arg_params``/``aux_params`` when given
        there, else from ``initializer`` (default ``Uniform(0.01)``),
        drawn on the host and moved to the module's device."""
        self._check_binded()
        if self.params_initialized and not force_init:
            return
        if initializer is None and (arg_params is None
                                    or aux_params is None):
            initializer = init_mod.Uniform(0.01)
        for names, store, given in (
                (self._param_names, self._exec.arg_dict, arg_params),
                (self._aux_names, self._exec.aux_dict, aux_params)):
            for name in names:
                arr = store[name]
                if given is not None and name in given:
                    src = self._tensor(given[name])
                elif initializer is not None:
                    src = initializer(init_mod.InitDesc(name), arr.shape,
                                      str(arr.dtype))
                elif names is self._param_names and not allow_missing:
                    raise MXNetError(f"missing parameter {name}")
                else:
                    continue
                arr._adopt(src.to(self._device, arr._data.dtype))
        self.params_initialized = True

    @staticmethod
    def _tensor(v):
        if isinstance(v, nd.NDArray):
            return v._data.detach()
        return torch.from_numpy(onp.ascontiguousarray(onp.asarray(v)))

    def get_params(self):
        """Copies of the parameters and auxiliary states, on the
        module's device."""
        self._check_binded()
        arg = {n: self._exec.arg_dict[n].copy()
               for n in self._param_names}
        aux = {n: self._exec.aux_dict[n].copy() for n in self._aux_names}
        return arg, aux

    # -------------------------------------------------------- optimizer
    def _update_param_names(self):
        """Parameters the optimizer updates: grad_req not 'null' and a
        gradient buffer exists."""
        return [n for n in self._param_names
                if self._grad_req.get(n, "null") != "null"
                and self._exec.grad_dict.get(n) is not None]

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        """The optimizer (a name, made with ``rescale_grad`` 1/batch
        unless given, or an instance) and its per-parameter updater.
        On one context a ``dist_*`` kvstore or
        ``MXNET_OPTIMIZER_SHARDING=ps`` takes this same updater, as in
        the reference (there is nothing to shard over)."""
        self._check_binded()
        if self.optimizer_initialized and not force_init:
            return
        if kvstore is not None and not isinstance(kvstore, str):
            raise MXNetError("a KVStore object is not ported: pass its "
                             "name (ROADMAP §A 11)")
        _check_sharding_env()
        if isinstance(optimizer, str):
            # state keyed by parameter NAME, so buckets whose graphs
            # order their parameters differently share one updater
            idx2name = {n: n for n in self._param_names}
            opt_params = dict(optimizer_params)
            if "rescale_grad" not in opt_params:
                # reference module.py: default grad rescale is 1/batch
                batch_size = self._exec.arg_dict[
                    self._data_names[0]].shape[0]
                opt_params["rescale_grad"] = 1.0 / batch_size
            optimizer = opt.create(
                optimizer, param_idx2name=idx2name, **opt_params)
        self._optimizer = optimizer
        self._updater = opt.get_updater(optimizer)
        self.optimizer_initialized = True
        states = getattr(self, "_preload_opt_states", None)
        if states is not None:
            self.load_optimizer_states(states)

    # ------------------------------------------------------------- exec
    def forward(self, data_batch, is_train=None):
        """Feed a batch (host or device NDArrays; moved to the module's
        device) and run the executor; a batch of another shape rebinds
        it first (reference module.py:365-371)."""
        self._check_binded()
        if is_train is None:
            is_train = self.for_training
        feeds = dict(zip(self._data_names, data_batch.data))
        if data_batch.label is not None and self._label_names:
            feeds.update(zip(self._label_names, data_batch.label))
        for k, v in feeds.items():
            if tuple(self._exec.arg_dict[k].shape) != tuple(v.shape):
                self._exec = self._exec.reshape(
                    **{k2: tuple(v2.shape) for k2, v2 in feeds.items()})
                if self._monitor is not None:
                    self._monitor.install(self._exec)
                break
        self._exec.forward(is_train=is_train, **feeds)

    def backward(self, out_grads=None):
        self._check_binded()
        self._exec.backward(out_grads=out_grads)

    def update(self):
        """One optimizer step of every trained parameter, by name."""
        self._check_binded()
        assert self.optimizer_initialized
        for name in self._update_param_names():
            self._updater(name, self._exec.grad_dict[name],
                          self._exec.arg_dict[name])

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        eval_metric.update(labels, self.get_outputs())

    def get_outputs(self, merge_multi_context=True):
        self._check_binded()
        return self._exec.outputs

    def get_input_grads(self, merge_multi_context=True):
        self._check_binded()
        return [self._exec.grad_dict.get(n) for n in self._data_names]

    # --------------------------------------------------------------- io
    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False,
                        keep_n=None):
        """One atomic checkpoint version (resilience.checkpoint): params,
        optionally the optimizer states, the symbol, the manifest and
        the `latest` pointer, in the reference's file layout."""
        from ..resilience.checkpoint import CheckpointManager

        arg_params, aux_params = self.get_params()
        states = None
        if save_optimizer_states:
            states = self._get_optimizer_states()
        CheckpointManager(prefix, keep_n=keep_n).save(
            epoch, symbol=self._symbol, arg_params=arg_params,
            aux_params=aux_params, optimizer_states=states)

    def _step_finite(self):
        """Outputs AND gradients: finite predictions can still carry a
        non-finite gradient, and such a step must not update."""
        if not self._outputs_finite():
            return False
        return all(bool(torch.isfinite(self._exec.grad_dict[n]._data).all())
                   for n in self._update_param_names())

    def _get_optimizer_states(self):
        if self._updater is None:
            raise MXNetError("optimizer not initialized")
        return self._updater.get_states(dump_optimizer=True)

    def _set_optimizer_states(self, states):
        if self._updater is None:
            raise MXNetError("optimizer not initialized")
        self._updater.set_states(states)
        # set_states of a dump_optimizer pickle installs the unpickled
        # optimizer; point the module at the one that runs
        live = getattr(self._updater, "optimizer", None)
        if live is not None:
            self._optimizer = live

    def load_optimizer_states(self, fname):
        """Optimizer states from a ``.states`` file."""
        with open(fname, "rb") as f:
            self._set_optimizer_states(f.read())

    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """A Module over a checkpoint's symbol whose ``bind`` installs
        its parameters; ``load_optimizer_states`` keeps the
        ``.states`` file for ``init_optimizer``."""
        from .. import model

        sym, arg_params, aux_params = model.load_checkpoint(prefix, epoch)
        mod = Module(symbol=sym, **kwargs)
        mod._arg_params, mod._aux_params = arg_params, aux_params
        if load_optimizer_states:
            mod._preload_opt_states = f"{prefix}-{int(epoch):04d}.states"
        return mod

    def install_monitor(self, mon):
        """Attach a ``mx.monitor.Monitor`` to this module's executor:
        every forward records output stats under the monitor's tic/toc
        protocol.  Installs now if bound, else at bind."""
        self._monitor = mon
        if self._exec is not None:
            mon.install(self._exec)
