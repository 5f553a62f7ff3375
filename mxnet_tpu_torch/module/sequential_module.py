"""SequentialModule + PythonModule (counterpart of
``mxnet_tpu/module/sequential_module.py``; reference:
python/mxnet/module/sequential_module.py, python_module.py)."""
from __future__ import annotations

from ..base import MXNetError
from .base_module import BaseModule

__all__ = ["SequentialModule", "PythonModule", "PythonLossModule"]


class SequentialModule(BaseModule):
    """Chain modules: each module's outputs feed the next (reference
    sequential_module.py:35)."""

    META_TAKE_LABELS = "take_labels"
    META_AUTO_WIRING = "auto_wiring"

    def __init__(self, logger=None):
        super().__init__()
        self._modules = []
        self._metas = []
        self.binded = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self._label_shapes = None

    def add(self, module, **kwargs):
        self._modules.append(module)
        self._metas.append(kwargs)
        return self

    @property
    def data_names(self):
        return self._modules[0].data_names if self._modules else []

    @property
    def output_names(self):
        return self._modules[-1].output_names if self._modules else []

    @property
    def data_shapes(self):
        return self._modules[0].data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_shapes(self):
        return self._modules[-1].output_shapes

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False,
             shared_module=None, grad_req="write"):
        if self.binded and not force_rebind:
            return
        if shared_module is not None:
            raise MXNetError("shared_module not supported in "
                             "SequentialModule")
        self._label_shapes = label_shapes
        cur_shapes = data_shapes
        for i, (mod, meta) in enumerate(zip(self._modules, self._metas)):
            take_labels = meta.get(self.META_TAKE_LABELS, False)
            mod.bind(cur_shapes,
                     label_shapes if take_labels else None,
                     for_training=for_training,
                     inputs_need_grad=(inputs_need_grad or i > 0),
                     force_rebind=force_rebind, grad_req=grad_req)
            if i + 1 == len(self._modules):
                break
            # wire this module's outputs into the next module's data
            # slots positionally (reference META_AUTO_WIRING)
            nxt = self._modules[i + 1]
            outs = mod.output_shapes
            if len(nxt.data_names) > len(outs):
                raise MXNetError(
                    f"SequentialModule wiring mismatch: module {i} "
                    f"produces {len(outs)} output(s) but module "
                    f"{i + 1} expects {len(nxt.data_names)} input(s)")
            cur_shapes = [
                (dn, s) for dn, (_, s) in zip(nxt.data_names, outs)]
        self.binded = True

    def init_params(self, initializer=None, arg_params=None,
                    aux_params=None, allow_missing=False,
                    force_init=False, allow_extra=False):
        for mod in self._modules:
            mod.init_params(initializer=initializer,
                            arg_params=arg_params, aux_params=aux_params,
                            allow_missing=True, force_init=force_init,
                            allow_extra=True)
        self.params_initialized = True

    def get_params(self):
        args, auxs = {}, {}
        for mod in self._modules:
            a, x = mod.get_params()
            args.update(a)
            auxs.update(x)
        return args, auxs

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        for mod in self._modules:
            mod.set_params(arg_params, aux_params, allow_missing=True,
                           force_init=force_init, allow_extra=True)

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        for mod in self._modules:
            mod.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                               optimizer_params=optimizer_params,
                               force_init=force_init)
        self.optimizer_initialized = True

    def forward(self, data_batch, is_train=None):
        from ..io.io import DataBatch

        batch = data_batch
        for i, (mod, meta) in enumerate(zip(self._modules, self._metas)):
            mod.forward(batch, is_train=is_train)
            if i == len(self._modules) - 1:
                break
            out = mod.get_outputs()
            label = getattr(data_batch, "label", None)
            batch = DataBatch(data=out, label=label)

    def backward(self, out_grads=None):
        grads = out_grads
        for i, mod in reversed(list(enumerate(self._modules))):
            mod.backward(out_grads=grads)
            if i == 0:
                break
            grads = mod.get_input_grads()

    def update(self):
        for mod in self._modules:
            mod.update()

    def update_metric(self, eval_metric, labels):
        self._modules[-1].update_metric(eval_metric, labels)

    def get_outputs(self):
        return self._modules[-1].get_outputs()

    def get_input_grads(self):
        return self._modules[0].get_input_grads()


class PythonModule(BaseModule):
    """A module whose computation is arbitrary Python (reference
    python_module.py:30) — base for metrics-only / loss-only modules."""

    def __init__(self, data_names, label_names, output_names,
                 logger=None):
        super().__init__()
        self._data_names = list(data_names)
        self._label_names = list(label_names or [])
        self._output_names = list(output_names)
        self.binded = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self._data_shapes = None
        self._label_shapes = None
        self._output_shapes = None

    @property
    def data_names(self):
        return self._data_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        return self._data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_shapes(self):
        return self._output_shapes

    def get_params(self):
        return {}, {}

    def init_params(self, *a, **k):
        self.params_initialized = True

    def init_optimizer(self, *a, **k):
        self.optimizer_initialized = True

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False,
             shared_module=None, grad_req="write"):
        self._data_shapes = data_shapes
        self._label_shapes = label_shapes
        self._output_shapes = self._compute_output_shapes()
        self.binded = True

    def _compute_output_shapes(self):
        raise NotImplementedError

    def update(self):
        pass

    def update_metric(self, eval_metric, labels):
        pass


class PythonLossModule(PythonModule):
    """Pass-through loss head computing gradients in Python (reference
    python_module.py:191)."""

    def __init__(self, name="pyloss", data_names=("data",),
                 label_names=("softmax_label",), logger=None,
                 grad_func=None):
        super().__init__(data_names, label_names,
                         [name + "_output"], logger=logger)
        self._name = name
        self._scores = None
        self._labels = None
        self._scores_grad = None
        self._grad_func = grad_func

    def _compute_output_shapes(self):
        return [(self._name + "_output", self._data_shapes[0][1])]

    def forward(self, data_batch, is_train=None):
        self._scores = data_batch.data[0]
        if data_batch.label:
            self._labels = data_batch.label[0]

    def get_outputs(self):
        return [self._scores]

    def backward(self, out_grads=None):
        if self._grad_func is not None:
            self._scores_grad = self._grad_func(self._labels,
                                                self._scores)
        else:
            raise MXNetError("PythonLossModule requires grad_func")

    def get_input_grads(self):
        return [self._scores_grad]
