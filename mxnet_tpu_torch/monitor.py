"""Monitor — output statistics during training (counterpart of
``mxnet_tpu/monitor.py``; reference python/mxnet/monitor.py:33-160).

As in the reference, the Monitor observes at the API boundaries:

  * ``install(executor)`` — wraps ``Executor.forward`` and records every
    symbol output (and, with ``monitor_all``, the argument arrays).
  * ``install(block)`` — registers Gluon forward hooks on every child
    block, recording each block's outputs by name.

The tic/toc/toc_print protocol is unchanged.
"""
from __future__ import annotations

import re

import numpy as onp

from .base import MXNetError

__all__ = ["Monitor"]


def _host(x):
    """An NDArray or tensor as a numpy array on the host."""
    if hasattr(x, "asnumpy"):
        return x.asnumpy()
    if hasattr(x, "detach"):
        return x.detach().float().cpu().numpy()
    return onp.asarray(x)


class Monitor:
    """Collect activation statistics every `interval` batches.

    Parameters match reference monitor.py:52: ``interval`` (batches
    between samples), ``stat_func`` (NDArray -> NDArray/scalar, default
    mean(|x|)), ``pattern`` (regex filtering entry names), ``sort``
    (sort stats by name at toc), ``monitor_all`` (also record inputs/
    arguments, not only outputs).
    """

    def __init__(self, interval, stat_func=None, pattern=".*", sort=False,
                 monitor_all=False):
        if stat_func is None:
            def asum_stat(x):
                """returns |x|/size(x), async execution."""
                return onp.abs(_host(x)).mean()

            stat_func = asum_stat
        elif stat_func == "numerics":
            # the numerics monitor's six numbers (l2/min/max/nan/inf/
            # zero_frac) through the classic tic/toc protocol, as the
            # run log's tensor_stats rows carry them
            from .telemetry import numerics as _nm

            def numerics_stat(x):
                row = _nm.stats_row(_nm.summary(getattr(x, "_data", x)))
                return [f"{k}={row[k]:.6g}" for k in _nm.STAT_FIELDS]

            stat_func = numerics_stat
        self.stat_func = stat_func
        self.interval = int(interval)
        self.activated = False
        self.queue = []
        self.step = 0
        self.exes = []
        self.re_prog = re.compile(pattern)
        self.sort = sort
        self.monitor_all = monitor_all
        self._handles = []

    # ----------------------------------------------------------- hooks
    def _stat_helper(self, name, array):
        if not self.activated or not self.re_prog.match(name):
            return
        self.queue.append((self.step, name, self.stat_func(array)))

    def install(self, exe):
        """Attach to an Executor, a Gluon Block, or a Module.

        A Module delegates to its ``install_monitor``: the monitor
        wraps the bound executor (group) immediately when bound, or at
        ``bind`` time otherwise — the legacy ``fit(monitor=...)``
        path from the reference, driveable from either end."""
        from .gluon.block import Block
        from .module.base_module import BaseModule
        from .symbol.executor import Executor

        if any(e is exe for e in self.exes):
            return  # idempotent: don't stack hooks/wrappers
        if isinstance(exe, BaseModule):
            self.exes.append(exe)
            exe.install_monitor(self)  # wraps exe's executor via this
            #                            install (Executor branch)
            return
        if isinstance(exe, Block):
            self._install_block(exe)
        elif isinstance(exe, Executor):
            self._install_executor(exe)
        else:
            raise MXNetError(
                f"Monitor.install expects an Executor, Block or "
                f"Module, got {type(exe)}")
        self.exes.append(exe)

    def _install_block(self, block):
        def make_hook(blk):
            def hook(b, inputs, outputs):
                outs = outputs if isinstance(outputs, (list, tuple)) \
                    else [outputs]
                for i, o in enumerate(outs):
                    self._stat_helper(f"{blk.name}_output{i}", o)
                if self.monitor_all:
                    ins = inputs if isinstance(inputs, (list, tuple)) \
                        else [inputs]
                    for i, a in enumerate(ins):
                        self._stat_helper(f"{blk.name}_input{i}", a)
            return hook

        def walk(b):
            yield b
            for c in b._children.values():
                yield from walk(c)

        for child in walk(block):
            self._handles.append(
                child.register_forward_hook(make_hook(child)))

    def _install_executor(self, exe):
        monitor = self
        orig_forward = exe.forward

        def forward(is_train=False, **kwargs):
            out = orig_forward(is_train=is_train, **kwargs)
            for name, arr in exe.output_dict.items():
                monitor._stat_helper(name, arr)
            if monitor.monitor_all:
                for name, arr in zip(exe._symbol.list_arguments(),
                                     exe.arg_arrays):
                    monitor._stat_helper(name, arr)
            return out

        exe.forward = forward

    # -------------------------------------------------------- protocol
    def tic(self):
        """Start collecting for this batch if step % interval == 0
        (reference monitor.py:88)."""
        if self.step % self.interval == 0:
            self.queue = []
            self.activated = True
        self.step += 1

    def toc(self):
        """End collection; return list of (step, name, stat_str)
        (reference monitor.py:102)."""
        if not self.activated:
            return []
        self.activated = False
        res = []
        queue = self.queue
        if self.sort:
            queue = sorted(queue, key=lambda x: x[1])
        for n, k, v_list in queue:
            if not isinstance(v_list, (list, tuple)):
                v_list = [v_list]
            s = " ".join(str(v) for v in v_list)
            res.append((n, k, s))
        self.queue = []
        return res

    def toc_print(self):
        """End collection and print results (reference
        monitor.py:142)."""
        res = self.toc()
        for n, k, v in res:
            print(f"Batch: {n:7d} {k:30s} {v}")
        return res
