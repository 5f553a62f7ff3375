"""Module: executor-backed trainable module (counterpart of
``mxnet_tpu/module/module.py``).

Reference parity: python/mxnet/module/module.py (``Module`` :40 over
``DataParallelExecutorGroup``).  ``context=None`` takes
``mx.current_context()``, ``gpu(0)`` unless a ``with mx.cpu():`` scope
says otherwise (the reference's default is ``cpu()``).  One context: one
executor on that device, updated per parameter through
``optimizer.get_updater``.

``context=[c_0..c_{N-1}]`` is data parallelism over a ``data`` mesh.  The
reference runs it as one program over N devices in one process; the
port's mesh spans the N worker processes of a launched job, one device
each (``parallel.get_mesh``, ``process_device``; ROADMAP §C), and a list
of several contexts outside such a job raises.  Every process runs the
same Module over the same global batch: ``bind`` takes the global batch
B, each process's executor holds its contiguous rows ``[rank*B/N,
(rank+1)*B/N)`` (the reference's ``P("data")`` rows), the parameters
start from rank 0's values, training BatchNorm takes the global batch's
statistics (``ops.nn.bn_group_scope``) and the output ops that divide by
the batch divide by the global one (``ops.nn.global_batch_scope``).
After ``backward`` the trained parameters' gradients are summed over the
mesh, one all-reduce a flat bucket (``parallel.zero.plan_buckets``),
counted in ``exchange``: ``grad_dict`` holds the global gradient, as the
reference's.  ``get_outputs``/``get_input_grads`` all-gather the global
batch's rows when they are called.  ``kvstore="dist_*"`` (or
``MXNET_OPTIMIZER_SHARDING=ps``) takes ``zero.ShardedBucketUpdater``,
whose optimizer state is sharded over the mesh; ``kvstore="local"`` the
per-parameter updater on the summed gradients.  ``group2ctxs`` places
the graph's ``ctx_group``s on devices (``symbol.executor``).
"""
from __future__ import annotations

import logging

import numpy as onp
import torch

from .. import initializer as init_mod
from .. import ndarray as nd
from .. import optimizer as opt
from ..base import MXNetError
from ..context import current_context, from_torch_device
from ..parallel.zero import (ShardedBucketUpdater, flatten_bucket,
                             plan_buckets, resolve_sharding_env,
                             sharding_rule_reasons, unflatten_bucket)
from .base_module import BaseModule

__all__ = ["Module"]


def _mesh_contexts(context):
    """``(bind context, mesh or None)`` of ``Module(context=...)``: a list
    of several contexts is the mesh of this launched job's processes,
    this process on its own device; one context is the Module on it."""
    if context is None:
        return current_context(), None
    if not isinstance(context, (list, tuple)):
        return context, None
    ctxs = list(context)
    if len(ctxs) == 1:
        return ctxs[0], None
    from ..kvstore import init_distributed
    from ..parallel import _world, get_mesh, process_device

    init_distributed()  # a job the launcher started: join its group
    world, rank = _world()
    if world == 1:
        raise MXNetError(
            f"Module(context={ctxs}) outside a launched job: the port "
            "spans devices with worker processes, one device each, not "
            f"one process over {len(ctxs)} devices (ROADMAP §C, the "
            f"distributed Module); launch {len(ctxs)} processes "
            f"(python -m mxnet_tpu_torch.tools.launch -n {len(ctxs)} "
            "...), each building this Module")
    if len(ctxs) != world:
        raise MXNetError(
            f"Module(context=...) of {len(ctxs)} contexts in a job of "
            f"{world} worker processes: the mesh is the job's processes, "
            "one context each")
    kind = "cuda" if ctxs[0].device_type == "gpu" else "cpu"
    mesh = get_mesh(devices=[process_device(rank, kind)])
    return from_torch_device(mesh.devices[0]), mesh


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
        self._context, self._mesh = _mesh_contexts(context)
        self._device = self._context.torch_device()
        self._exchange = None
        if self._mesh is not None:
            from ..ops.collective_ops import Exchange

            self._exchange = Exchange(self._mesh)
        # one group->context dict (the reference's list holds one per
        # data-parallel context; the Module runs one executor a process)
        if isinstance(group2ctxs, (list, tuple)):
            if len(group2ctxs) > 1:
                raise MXNetError(
                    "group2ctxs: pass one group->Context dict (data "
                    "parallelism comes from context=[...], not per-ctx "
                    "groups)")
            group2ctxs = group2ctxs[0] if group2ctxs else None
        if group2ctxs and self._mesh is not None:
            raise MXNetError("group2ctxs cannot combine with a "
                             "multi-context data mesh")
        self._group2ctx = group2ctxs or None
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
        self._grad_plan = None
        self._gathered = None

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

    @property
    def exchange(self):
        """The mesh's counted collectives (``ops.collective_ops.
        Exchange``: ``counts()``, ``reset()``); None on one context."""
        return self._exchange

    # -------------------------------------------------------- the mesh
    def _rows(self, shape):
        """This process's share of a batch-major shape (the whole shape
        when the mesh's width does not divide its batch: ``forward``
        raises on such a batch)."""
        if self._mesh is None or not shape or shape[0] % self._mesh.size:
            return tuple(shape)
        return (shape[0] // self._mesh.size,) + tuple(shape[1:])

    def _slice_rows(self, name, arr):
        """This process's contiguous rows of a global batch array."""
        n = self._mesh.size
        b = arr.shape[0]
        if b % n:
            raise MXNetError(
                f"batch axis of '{name}' ({b}) must divide the "
                f"{n}-process data mesh")
        k = b // n
        return arr[self._mesh.rank * k:(self._mesh.rank + 1) * k]

    def _collective(self, fn, what):
        """Run one of the Module's collectives; a failure names this
        rank (a peer whose iterator ended early never joins, and gloo's
        timeout, ``MXNET_PS_DEADLINE_SEC``, ends the wait)."""
        try:
            return fn()
        except RuntimeError as e:  # gloo's errors (DistBackendError)
            raise MXNetError(
                f"rank {self._mesh.rank} of {self._mesh.size}: the "
                f"Module's {what} failed ({e}); every process must run "
                "the same forward/backward/update/get_outputs calls in "
                "the same order") from e

    def _gather_rows(self, arrs, what):
        """The global batch's rows of each batch-major array (this
        process holds its share), in rank order; others as they are."""
        local = self._exec.arg_dict[self._data_names[0]].shape[0] \
            if self._data_names else None
        out = []
        for a in arrs:
            if a is None or a._data.dim() == 0 or a.shape[0] != local:
                out.append(a)
                continue
            t = a._data.contiguous()
            whole = self._collective(
                lambda t=t: self._exchange.all_gather(t.reshape(-1),
                                                      role="rows"), what)
            out.append(nd.NDArray(whole.reshape(
                (self._mesh.size * t.shape[0],) + tuple(t.shape[1:]))))
        return out

    def _reduce_grads(self, grads):
        """Sum this backward's parameter gradients over the mesh, one
        all-reduce a flat bucket, in place of ``grads``' entries."""
        names = [n for n in self._param_names if n in grads]
        if not names:
            return
        if self._grad_plan is None or [n for b in self._grad_plan
                                       for n in b.names] != names:
            self._grad_plan = plan_buckets({n: grads[n] for n in names}, 1)
        for b in self._grad_plan:
            flat = flatten_bucket(b, grads)
            self._collective(lambda f=flat: self._exchange.all_reduce(f),
                             "gradient all-reduce")
            grads.update(unflatten_bucket(b, flat))

    def _broadcast_params(self):
        """Every parameter and auxiliary state from rank 0."""
        for store, names in ((self._exec.arg_dict, self._param_names),
                             (self._exec.aux_dict, self._aux_names)):
            for n in names:
                t = store[n]._data
                self._collective(
                    lambda t=t: self._exchange.broadcast(t, role="control"),
                    "parameter broadcast")

    # ------------------------------------------------------------- bind
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False,
             shared_module=None, grad_req="write"):
        """Allocate the executor on the module's device from the data
        (and label) shapes — under a mesh the global batch, of which the
        executor holds this process's rows.  ``grad_req`` is a string or
        a per-name dict; data take ``write`` only with
        ``inputs_need_grad``, labels and ``fixed_param_names`` ``null``.
        With ``shared_module`` the parameter and auxiliary arrays are
        that module's own objects, so an update through either is seen
        by both."""
        if self.binded and not force_rebind:
            return
        self.for_training = for_training
        self._data_shapes = [(d[0], tuple(d[1])) for d in data_shapes]
        self._label_shapes = ([(d[0], tuple(d[1]))
                               for d in label_shapes]
                              if label_shapes else None)
        shape_kwargs = {d[0]: self._rows(d[1]) for d in data_shapes}
        if label_shapes:
            shape_kwargs.update({d[0]: self._rows(d[1])
                                 for d in label_shapes})
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
            self._context, grad_req=req, group2ctx=self._group2ctx,
            **shape_kwargs)
        self._gathered = None
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
        drawn on the host and moved to its device; under a mesh, rank
        0's values on every process."""
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
                # a copy: the sharded updater writes parameters in place
                arr._adopt(src.to(arr._data.device, arr._data.dtype,
                                  copy=True))
        if self._mesh is not None:
            self._broadcast_params()
        self.params_initialized = True

    @staticmethod
    def _tensor(v):
        if isinstance(v, nd.NDArray):
            return v._data.detach()
        return torch.from_numpy(onp.ascontiguousarray(onp.asarray(v)))

    def get_params(self):
        """Copies of the parameters and auxiliary states, on their
        devices."""
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

    def _named_grads(self):
        """The live gradient buffers by parameter name — the numerics
        monitor's observation point in ``fit``."""
        return {n: self._exec.grad_dict[n]
                for n in self._update_param_names()}

    def _resolve_optimizer_sharding(self, kvstore, optimizer):
        """``"ps"`` when this Module takes the sharded updater: under a
        mesh, ``kvstore="dist_*"`` (whose reference semantics are the
        server-side optimizer on key shards) or
        ``MXNET_OPTIMIZER_SHARDING=ps``, unless the env forces it off or
        the optimizer has semantics the flat buckets cannot reproduce
        (logged, the per-parameter updater kept).  Else None."""
        env = resolve_sharding_env()
        if env is False:
            return None
        kv_name = kvstore if isinstance(kvstore, str) else \
            getattr(kvstore, "type", "")
        if env != "ps" and not str(kv_name).startswith("dist"):
            return None
        if self._mesh is None:
            return None  # one device: nothing to shard over
        reasons = sharding_rule_reasons(optimizer)
        if reasons:
            self.logger.warning(
                "optimizer sharding requested (kvstore=%r) but falling "
                "back to the per-parameter updater: %s", kv_name,
                "; ".join(reasons))
            return None
        return "ps"

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        """The optimizer (a name, made with ``rescale_grad`` 1/global
        batch unless given, or an instance) and its updater: the
        sharded one where :meth:`_resolve_optimizer_sharding` says so,
        else the per-parameter one.  ``kvstore`` is a name or a KVStore
        (taken by its ``type``)."""
        self._check_binded()
        if self.optimizer_initialized and not force_init:
            return
        if isinstance(optimizer, str):
            # state keyed by parameter NAME, so buckets whose graphs
            # order their parameters differently share one updater
            idx2name = {n: n for n in self._param_names}
            opt_params = dict(optimizer_params)
            if "rescale_grad" not in opt_params:
                # reference module.py: default grad rescale is 1/batch,
                # the global batch under a mesh
                batch_size = self._data_shapes[0][1][0] \
                    if self._mesh is not None else \
                    self._exec.arg_dict[self._data_names[0]].shape[0]
                opt_params["rescale_grad"] = 1.0 / batch_size
            optimizer = opt.create(
                optimizer, param_idx2name=idx2name, **opt_params)
        self._optimizer = optimizer
        if self._resolve_optimizer_sharding(kvstore, optimizer) == "ps":
            self._updater = ShardedBucketUpdater(
                optimizer, self._mesh,
                {n: self._exec.arg_dict[n]._data
                 for n in self._update_param_names()},
                exchange=self._exchange)
        else:
            self._updater = opt.get_updater(optimizer)
        from .. import telemetry

        rl = telemetry.current()
        if rl is not None:
            # sticky context: every later step record carries the
            # optimizer-sharding mode in effect
            rl.set_context(sharding="ps" if isinstance(
                self._updater, ShardedBucketUpdater) else "none")
        self.optimizer_initialized = True
        states = getattr(self, "_preload_opt_states", None)
        if states is not None:
            self.load_optimizer_states(states)

    # ------------------------------------------------------------- exec
    def forward(self, data_batch, is_train=None):
        """Feed a batch (host or device NDArrays; moved to the module's
        device) and run the executor; a batch of another shape rebinds
        it first (reference module.py:365-371).  Under a mesh the batch
        is global and this process feeds its rows (a batch the device
        feed already cut to them, ``rows_of``, as it is)."""
        self._check_binded()
        if is_train is None:
            is_train = self.for_training
        feeds = dict(zip(self._data_names, data_batch.data))
        if data_batch.label is not None and self._label_names:
            feeds.update(zip(self._label_names, data_batch.label))
        mesh = self._mesh
        if mesh is not None and getattr(data_batch, "rows_of", None) != (
                mesh.rank, mesh.size):
            feeds = {k: nd.NDArray(self._slice_rows(
                k, v._data if isinstance(v, nd.NDArray)
                else torch.as_tensor(onp.asarray(v))))
                for k, v in feeds.items()}
        for k, v in feeds.items():
            if tuple(self._exec.arg_dict[k].shape) != tuple(v.shape):
                self._exec = self._exec.reshape(
                    **{k2: tuple(v2.shape) for k2, v2 in feeds.items()})
                if self._monitor is not None:
                    self._monitor.install(self._exec)
                break
        self._gathered = None
        if mesh is None or not is_train:
            self._exec.forward(is_train=is_train, **feeds)
            return
        from ..ops.nn import bn_group_scope, global_batch_scope

        with bn_group_scope(self._exchange), global_batch_scope(mesh.size):
            self._exec.forward(is_train=is_train, **feeds)

    def backward(self, out_grads=None):
        """The executor's backward; under a mesh ``out_grads`` are the
        global batch's (this process takes its rows) and the
        parameters' gradients are then summed over the mesh."""
        self._check_binded()
        if self._mesh is None:
            self._exec.backward(out_grads=out_grads)
            return
        from ..ops.nn import bn_group_scope

        if out_grads is not None:
            out_grads = [out_grads] if isinstance(out_grads, nd.NDArray) \
                else list(out_grads)
            local = self._exec.arg_dict[self._data_names[0]].shape[0]
            out_grads = [
                nd.NDArray(self._slice_rows("out_grads", g._data))
                if isinstance(g, nd.NDArray) and g._data.dim()
                and g.shape[0] == local * self._mesh.size else g
                for g in out_grads]
        with bn_group_scope(self._exchange):
            self._exec.backward(out_grads=out_grads,
                                reduce_grads=self._reduce_grads)

    def update(self):
        """One optimizer step of every trained parameter: one
        ``update_all`` of the sharded updater, or each by name."""
        self._check_binded()
        assert self.optimizer_initialized
        names = self._update_param_names()
        if isinstance(self._updater, ShardedBucketUpdater):
            self._collective(lambda: self._updater.update_all(
                [(n, self._exec.grad_dict[n], self._exec.arg_dict[n])
                 for n in names]), "sharded update")
            return
        for name in names:
            self._updater(name, self._exec.grad_dict[name],
                          self._exec.arg_dict[name])

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        """The metric on the global batch: under a mesh the outputs are
        gathered, and labels the device feed cut to this process's rows
        are too."""
        if self._mesh is not None and labels is not None:
            labels = self._gather_rows(list(labels), "label gather")
        eval_metric.update(labels, self.get_outputs())

    def get_outputs(self, merge_multi_context=True):
        """The outputs of the last forward; under a mesh the global
        batch's rows, all-gathered on the first call after it."""
        self._check_binded()
        if self._mesh is None:
            return self._exec.outputs
        if self._gathered is None:
            self._gathered = self._gather_rows(self._exec.outputs,
                                               "output gather")
        return self._gathered

    def get_input_grads(self, merge_multi_context=True):
        self._check_binded()
        grads = [self._exec.grad_dict.get(n) for n in self._data_names]
        if self._mesh is None:
            return grads
        return self._gather_rows(grads, "input-gradient gather")

    # --------------------------------------------------------------- io
    def _writes_checkpoints(self):
        """Under a mesh only rank 0 writes; every process gathers."""
        return self._mesh is None or self._mesh.rank == 0

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False,
                        keep_n=None):
        """One atomic checkpoint version (resilience.checkpoint): params,
        optionally the optimizer states, the symbol, the manifest and
        the `latest` pointer, in the reference's file layout.  Under a
        mesh every process calls it (the sharded states gather) and rank
        0 writes."""
        from ..resilience.checkpoint import CheckpointManager

        arg_params, aux_params = self.get_params()
        states = None
        if save_optimizer_states:
            states = self._get_optimizer_states()
        if not self._writes_checkpoints():
            return
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

    def _topology_block(self):
        """The world this module trains in, for the checkpoint
        manifest's ``topology`` stamp.  Under a mesh: its width, the
        sharded updater's plan fingerprint and bucket count
        (``sharding="ps"``) or ``"none"``, and the bound global batch.
        On one context: the elastic context's process count as the
        world, each process a replica of its own batch, whose global
        batch is the local batch times it.  The global batch is the unit
        the resume cursor is kept in, so it re-slices across any
        world."""
        from ..resilience import elastic

        if self._mesh is not None:
            upd = self._updater if isinstance(
                self._updater, ShardedBucketUpdater) else None
            return elastic.topology_block(
                world_size=self._mesh.size, num_processes=self._mesh.size,
                mesh=self._mesh,
                sharding="ps" if upd is not None else "none",
                plan=upd.plan if upd is not None else None,
                global_batch=self._data_shapes[0][1][0])
        ctx = elastic.context()
        world = ctx.num_processes if ctx is not None else 1
        global_batch = None
        try:
            global_batch = int(
                self._exec.arg_dict[self._data_names[0]].shape[0]) * world
        except Exception:
            pass
        return elastic.topology_block(world_size=world,
                                      num_processes=world,
                                      sharding="none",
                                      global_batch=global_batch)

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
