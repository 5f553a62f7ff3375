"""Trainer (counterpart of ``mxnet_tpu/gluon/trainer.py``): applies an
optimizer to a set of :class:`~mxnet_tpu_torch.gluon.Parameter`.

``step(batch_size)`` sets the optimizer's ``rescale_grad`` to
``rescale_grad / batch_size`` and updates each parameter in turn
through an :class:`~mxnet_tpu_torch.optimizer.Updater`, in place on the
parameter's device, as the reference does: a parameter whose gradient
``backward`` has not written since the last step is an error unless
``ignore_stale_grad``.  With ``multi_precision`` an fp16/bf16 parameter
is updated through an fp32 master copy.

One process, one device: the kvstore ``"device"``, ``"local"`` or None.
A ``dist*`` kvstore, a KVStore object and gradient compression raise
(the distributed Trainer, ROADMAP §A item 11).  With AMP's loss scaler
(``contrib.amp.init_trainer``) a step whose gradients are not all
finite is skipped and the scale halves.
"""
from __future__ import annotations

from .. import optimizer as opt
from ..base import MXNetError
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer"]

_LOCAL_KVSTORES = (None, "device", "local")


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
        if not (kvstore is None or isinstance(kvstore, str)) or \
                kvstore not in _LOCAL_KVSTORES:
            raise MXNetError(
                f"kvstore {kvstore!r}: the distributed Trainer is not "
                "ported yet (ROADMAP §A item 11); use 'device', 'local' "
                "or None")
        if compression_params:
            raise MXNetError("gradient compression is not ported yet "
                             "(ROADMAP §A item 11)")
        self._params = []
        self._param2idx = {}
        for i, param in enumerate(params):
            if not isinstance(param, Parameter):
                raise MXNetError(
                    "First argument must be a list or dict of Parameters, "
                    f"got list of {type(param)}.")
            self._param2idx[param.name] = i
            self._params.append(param)
        optimizer_params = optimizer_params if optimizer_params else {}
        self._scale = float(optimizer_params.get("rescale_grad", 1.0))
        self._init_optimizer(optimizer, optimizer_params)

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

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    @property
    def optimizer(self):
        return self._optimizer

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def allreduce_grads(self):
        """Sum gradients across workers: the identity in one process."""

    def step(self, batch_size, ignore_stale_grad=False):
        """Rescale the gradients by ``1 / batch_size`` and update every
        parameter."""
        self._optimizer.rescale_grad = self._scale / batch_size
        self.allreduce_grads()
        self._update(ignore_stale_grad)

    def update(self, batch_size, ignore_stale_grad=False):
        """:meth:`step` without the all-reduce."""
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update(ignore_stale_grad)

    def _update(self, ignore_stale_grad=False):
        scaler = getattr(self, "_amp_loss_scaler", None)
        if scaler is not None:
            # AMP's dynamic loss scaling: a step whose gradients overflow
            # is skipped whole, and the scale backs off
            overflow = scaler.has_overflow(self._params)
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
            if arr._grad is None or not arr._fresh_grad:
                if ignore_stale_grad:
                    continue
                raise MXNetError(
                    f"Gradient of Parameter `{param.name}` on context "
                    "has not been updated by backward since last `step`. "
                    "This could mean a bug in your model that made it only "
                    "use a subset of the Parameters for the last forward "
                    "pass. Set ignore_stale_grad=True to suppress this "
                    "warning.")
            updater(i, arr._grad, arr)
            arr._fresh_grad = False

    def save_states(self, fname):
        """Pickle the optimizer and its states to ``fname``."""
        with open(fname, "wb") as fout:
            fout.write(self._updaters[0].get_states(dump_optimizer=True))

    def load_states(self, fname):
        """Restore what :meth:`save_states` wrote; each state goes to
        its parameter's device at the next update."""
        with open(fname, "rb") as f:
            states = f.read()
        for updater in self._updaters:
            updater.set_states(states)
            updater.optimizer = self._updaters[0].optimizer
        self._optimizer = self._updaters[0].optimizer
