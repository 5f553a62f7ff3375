"""Trainer (counterpart of ``mxnet_tpu/gluon/trainer.py``): applies an
optimizer to a set of :class:`~mxnet_tpu_torch.gluon.Parameter`.

``step(batch_size)`` sets the optimizer's ``rescale_grad`` to
``rescale_grad / batch_size`` and updates each parameter in turn
through an :class:`~mxnet_tpu_torch.optimizer.Updater`, in place on the
parameter's device, as the reference does: a parameter whose gradient
``backward`` has not written since the last step is an error unless
``ignore_stale_grad``.  With ``multi_precision`` an fp16/bf16 parameter
is updated through an fp32 master copy.

The kvstore ``"device"``, ``"local"`` or None updates in this process
with no store.  A ``dist*`` name or a ``KVStore`` object spans workers
(reference ``_init_kvstore``, trainer.py:169): with
``update_on_kvstore`` (the default for a ``dist*`` name) each gradient
is pushed and the store's updater (this Trainer's, shared) updates the
stored weight, which is pulled back; without it ``allreduce_grads``
sums every gradient over the workers through the store and each worker
updates its own replica.  ``compression_params`` go to the store.  With
AMP's loss scaler (``contrib.amp.init_trainer``) a step whose gradients
are not all finite, on any worker, is skipped and the scale halves.
"""
from __future__ import annotations

import torch

from .. import kvstore as kvs
from .. import ndarray as nd
from .. import optimizer as opt
from ..base import MXNetError
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer"]


class Trainer:
    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None):
        if isinstance(params, (dict, ParameterDict)):
            params = list(params.values())
        if not isinstance(params, (list, tuple)):
            raise MXNetError(
                "First argument must be a list or dict of Parameters, "
                f"got {type(params)}.")
        self._params = []
        self._param2idx = {}
        for i, param in enumerate(params):
            if not isinstance(param, Parameter):
                raise MXNetError(
                    "First argument must be a list or dict of Parameters, "
                    f"got list of {type(param)}.")
            self._param2idx[param.name] = i
            self._params.append(param)
        self._compression_params = compression_params
        optimizer_params = optimizer_params if optimizer_params else {}
        self._scale = float(optimizer_params.get("rescale_grad", 1.0))
        self._init_optimizer(optimizer, optimizer_params)
        self._kvstore_params = {"kvstore": kvstore,
                                "update_on_kvstore": update_on_kvstore}
        self._kv_initialized = False
        self._kvstore = None
        self._update_on_kvstore = None

    def _init_optimizer(self, optimizer, optimizer_params):
        param_dict = dict(enumerate(self._params))
        if isinstance(optimizer, opt.Optimizer):
            if optimizer_params:
                raise MXNetError(
                    "optimizer_params must be None if optimizer is an "
                    "instance of Optimizer instead of str")
            self._optimizer = optimizer
            self._optimizer.param_dict = param_dict
        else:
            self._optimizer = opt.create(
                optimizer, param_dict=param_dict, **optimizer_params)
        self._updaters = [opt.get_updater(self._optimizer)]

    def _init_kvstore(self):
        kvstore = self._kvstore_params["kvstore"]
        update_on_kvstore = self._kvstore_params["update_on_kvstore"]
        if isinstance(kvstore, str) and kvstore.startswith("dist"):
            self._kvstore = kvs.create(kvstore)
            if update_on_kvstore is None:
                update_on_kvstore = True
        elif isinstance(kvstore, kvs.KVStore):
            self._kvstore = kvstore
        else:
            # one process: no store
            self._kvstore = None
            update_on_kvstore = False
        if self._kvstore is not None and update_on_kvstore:
            # the store shares this Trainer's updater: the optimizer's
            # state lives in one place (save_states/load_states)
            self._kvstore._set_updater(self._updaters[0])
        if self._kvstore is not None and self._compression_params:
            self._kvstore.set_gradient_compression(
                self._compression_params)
        self._update_on_kvstore = bool(update_on_kvstore)
        self._kv_initialized = True

    def _kv_lazy_init(self, i, value):
        if i not in self._kvstore._store:
            self._kvstore.init(i, value)

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    @property
    def optimizer(self):
        return self._optimizer

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def allreduce_grads(self):
        """Sum every gradient over the workers through the store, in
        place (``update_on_kvstore`` False); the identity without a
        store or when the store updates.  Every allocated gradient is
        pushed, a stale one as zeros, so every worker issues the same
        sequence."""
        if not self._kv_initialized:
            self._init_kvstore()
        if self._kvstore is None or self._update_on_kvstore:
            return
        for i, param in enumerate(self._params):
            if param.grad_req == "null" or not param._initialized:
                continue
            arr = param._wrap()
            g = arr._grad
            if g is None:
                continue
            zeros = nd.NDArray(g._data.new_zeros(g._data.shape))
            self._kv_lazy_init(i, zeros)
            self._kvstore.push(i, g if arr._fresh_grad else zeros)
            self._kvstore.pull(i, out=g)

    def step(self, batch_size, ignore_stale_grad=False):
        """Rescale the gradients by ``1 / batch_size``, sum them over
        the workers and update every parameter."""
        if not self._kv_initialized:
            self._init_kvstore()
        self._optimizer.rescale_grad = self._scale / batch_size
        self.allreduce_grads()
        self._update(ignore_stale_grad)

    def update(self, batch_size, ignore_stale_grad=False):
        """:meth:`step` without the all-reduce."""
        if not self._kv_initialized:
            self._init_kvstore()
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update(ignore_stale_grad)

    def _update(self, ignore_stale_grad=False):
        scaler = getattr(self, "_amp_loss_scaler", None)
        if scaler is not None:
            # AMP's dynamic loss scaling: a step whose gradients overflow
            # is skipped whole, and the scale backs off
            overflow = scaler.has_overflow(self._params)
            if self._kvstore is not None and self._kvstore.num_workers > 1:
                # one verdict for all workers, or their pushes below
                # would no longer match
                flag = self._kvstore._allreduce(torch.tensor(
                    [1.0 if overflow else 0.0]))
                overflow = float(flag[0]) > 0
            scaler.update_scale(overflow)
            if overflow:
                for param in self._params:
                    if param._initialized:
                        param._wrap()._fresh_grad = False
                return
        updater = self._updaters[0]
        for i, param in enumerate(self._params):
            if param.grad_req == "null":
                continue
            if not param._initialized:
                if param._deferred_init is not None and ignore_stale_grad:
                    continue
                raise MXNetError(
                    f"Parameter {param.name} has not been initialized")
            arr = param._wrap()
            stale = arr._grad is None or not arr._fresh_grad
            if stale and not ignore_stale_grad:
                raise MXNetError(
                    f"Gradient of Parameter `{param.name}` on context "
                    "has not been updated by backward since last `step`. "
                    "This could mean a bug in your model that made it only "
                    "use a subset of the Parameters for the last forward "
                    "pass. Set ignore_stale_grad=True to suppress this "
                    "warning.")
            if self._update_on_kvstore and self._kvstore is not None:
                # the store updates: push the gradient (zeros if stale,
                # so every worker pushes the same keys), pull the weight
                self._kv_lazy_init(i, arr)
                self._kvstore.push(i, arr._grad if not stale else nd.NDArray(
                    arr._data.new_zeros(arr._data.shape)))
                self._kvstore.pull(i, out=arr)
            elif stale:
                continue
            else:
                updater(i, arr._grad, arr)
            arr._fresh_grad = False

    def save_states(self, fname):
        """Pickle the optimizer and its states to ``fname`` (the one
        updater, which a store that updates shares)."""
        if not self._kv_initialized:
            self._init_kvstore()
        with open(fname, "wb") as fout:
            fout.write(self._updaters[0].get_states(dump_optimizer=True))

    def load_states(self, fname):
        """Restore what :meth:`save_states` wrote; each state goes to
        its parameter's device at the next update."""
        if not self._kv_initialized:
            self._init_kvstore()
        with open(fname, "rb") as f:
            states = f.read()
        for updater in self._updaters:
            updater.set_states(states)
            updater.optimizer = self._updaters[0].optimizer
        self._optimizer = self._updaters[0].optimizer
        if self._update_on_kvstore and self._kvstore is not None:
            # the store keeps sharing the one updater
            self._kvstore._set_updater(self._updaters[0])
