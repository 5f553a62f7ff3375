"""BucketingModule: per-bucket modules sharing parameters (counterpart of
``mxnet_tpu/module/bucketing_module.py``).

Reference parity: python/mxnet/module/bucketing_module.py — one module
per bucket key, every one bound over the default bucket's parameter and
auxiliary arrays (the same NDArray objects), so an update through any
bucket is seen by all.  SURVEY.md §5.7: bucketing is the reference's
variable-length strategy.  A context list reaches every bucket's Module,
so under a process mesh (``Module``) each bucket trains data-parallel
over the same shared arrays.
"""
from __future__ import annotations

import logging

from .base_module import BaseModule
from .module import Module, _mesh_contexts

__all__ = ["BucketingModule"]


class BucketingModule(BaseModule):
    def __init__(self, sym_gen, default_bucket_key=None, logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None, group2ctxs=None,
                 compression_params=None):
        super().__init__(logger=logger)
        assert default_bucket_key is not None
        self._sym_gen = sym_gen
        self._default_bucket_key = default_bucket_key
        # the buckets' Modules take the context (list) as given; this
        # process's context feeds fit's device feed
        self._contexts = context
        self._context = _mesh_contexts(context)[0]
        self._fixed_param_names = fixed_param_names
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None
        self._params_dirty = False

    @property
    def symbol(self):
        return self._curr_module.symbol

    def _gen_module(self, bucket_key):
        sym, data_names, label_names = self._sym_gen(bucket_key)
        return Module(
            sym, data_names, label_names, logger=self.logger,
            context=self._contexts,
            fixed_param_names=self._fixed_param_names)

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False,
             shared_module=None, grad_req="write"):
        if self.binded and not force_rebind:
            return
        self.for_training = for_training
        module = self._gen_module(self._default_bucket_key)
        module.bind(data_shapes, label_shapes, for_training,
                    inputs_need_grad, force_rebind=False,
                    shared_module=None, grad_req=grad_req)
        self._curr_module = module
        self._curr_bucket_key = self._default_bucket_key
        self._buckets[self._default_bucket_key] = module
        self.binded = True

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        assert self.binded, "call bind before switching bucket"
        if bucket_key not in self._buckets:
            module = self._gen_module(bucket_key)
            module.bind(data_shapes, label_shapes, self.for_training,
                        force_rebind=False,
                        shared_module=self._buckets[
                            self._default_bucket_key],
                        grad_req="write")
            if self._curr_module is not None and \
                    self._curr_module.optimizer_initialized:
                module._optimizer = self._curr_module._optimizer
                module._updater = self._curr_module._updater
                module.optimizer_initialized = True
            self._buckets[bucket_key] = module
        else:
            module = self._buckets[bucket_key]
        self._curr_module = module
        self._curr_bucket_key = bucket_key

    def init_params(self, initializer=None, arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        if self.params_initialized and not force_init:
            return
        self._check_binded()
        self._curr_module.init_params(
            initializer=initializer, arg_params=arg_params,
            aux_params=aux_params, allow_missing=allow_missing,
            force_init=force_init, allow_extra=allow_extra)
        self._params_dirty = False
        self.params_initialized = True

    def get_params(self):
        self._check_binded()
        arg, aux = self._curr_module.get_params()
        self._params_dirty = False
        return arg, aux

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        self._check_binded()
        if self.optimizer_initialized and not force_init:
            return
        self._curr_module.init_optimizer(
            kvstore, optimizer, optimizer_params, force_init=force_init)
        for mod in self._buckets.values():
            if mod is not self._curr_module:
                mod._optimizer = self._curr_module._optimizer
                mod._updater = self._curr_module._updater
                mod.optimizer_initialized = True
        self.optimizer_initialized = True

    def forward(self, data_batch, is_train=None):
        self._check_binded()
        bucket_key = getattr(data_batch, "bucket_key", None)
        if bucket_key is None:
            bucket_key = self._default_bucket_key
        data_shapes = [(getattr(d, "name", f"data{i}")
                        if not isinstance(d, tuple) else d[0],
                        tuple(a.shape))
                       for i, (d, a) in enumerate(
                           zip(data_batch.provide_data or
                               [("data", None)] * len(data_batch.data),
                               data_batch.data))]
        label_shapes = None
        if data_batch.label:
            provide = (data_batch.provide_label
                       or [("softmax_label", None)] * len(data_batch.label))
            label_shapes = [
                (getattr(d, "name", None) if not isinstance(d, tuple)
                 else d[0], tuple(a.shape))
                for d, a in zip(provide, data_batch.label)]
        self.switch_bucket(bucket_key, data_shapes, label_shapes)
        # params shared by reference: sync from previous module
        self._curr_module.forward(data_batch, is_train=is_train)

    def backward(self, out_grads=None):
        self._check_binded()
        self._curr_module.backward(out_grads=out_grads)
        self._params_dirty = True

    def update(self):
        self._check_binded()
        assert self.optimizer_initialized
        self._params_dirty = True
        # parameter NDArrays are shared across buckets (Module.bind
        # shared_module) — one update is visible everywhere
        self._curr_module.update()

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        self._check_binded()
        self._curr_module.update_metric(eval_metric, labels)

    def get_outputs(self, merge_multi_context=True):
        self._check_binded()
        return self._curr_module.get_outputs(merge_multi_context)

    def install_monitor(self, mon):
        for mod in self._buckets.values():
            mod.install_monitor(mon)
