"""BaseModule: the high-level train/predict interface (counterpart of
``mxnet_tpu/module/base_module.py``).

Reference parity: python/mxnet/module/base_module.py (``fit`` :409-538 —
bind → init_params → init_optimizer → epoch loop forward_backward /
update / metric / checkpoint; ``score``, ``predict``).

``fit`` wraps ``train_data`` in the device feed (``io.DeviceFeedIter``,
``MXNET_DEVICE_FEED``, on by default, as the reference's): batches reach
the module's device on a side stream while the step before runs, so
``forward``'s own move is a no-op.  fit closes the feed it made on the
way out and hands the caller's iterator back reset.
``resume_from=`` and ``MXNET_SNAPSHOT_EVERY`` raise: they wait for
ROADMAP §A 7, with §A 11's asynchronous checkpoint.  ``fit`` runs a
telemetry session (``telemetry.fit_session``: step records, sampled
loss syncs, the numerics monitor's ``tensor_stats`` on sampled and bad
steps, the hang watchdog of ``MXNET_WATCHDOG_SEC``, the flight dump on
every in-fit death) and a preemption drain: SIGTERM/SIGINT finishes
the step in flight, saves a checkpoint when fit has one, dumps the
flight recorder and re-raises the signal.  Peer healing is not armed,
and takes no action, as the reference's does when unset.
"""
from __future__ import annotations

import logging
import time

import numpy as onp

from .. import metric as metric_mod
from .. import ndarray as nd
from ..base import MXNetError

__all__ = ["BaseModule"]


def _refuse_unported(resume_from):
    from ..config import get_env

    if resume_from is not None:
        raise MXNetError("fit(resume_from=...) restores the RNG, the batch "
                         "cursor and the topology stamp, which are not "
                         "ported yet (ROADMAP §A 7, with §A 11's "
                         "asynchronous checkpoint)")
    if int(get_env("MXNET_SNAPSHOT_EVERY")) > 0:
        raise MXNetError("MXNET_SNAPSHOT_EVERY needs the asynchronous "
                         "snapshot writer, which is not ported yet "
                         "(ROADMAP §A 7, with §A 11's asynchronous "
                         "checkpoint)")


class BaseModule:
    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self._symbol = None

    # ------------------------------------------------------ infra props
    @property
    def symbol(self):
        return self._symbol

    def _check_binded(self):
        if not self.binded:
            raise MXNetError("Module not binded")

    # ------------------------------------------------------ train loop
    def forward_backward(self, data_batch):
        self.forward(data_batch, is_train=True)
        self.backward()

    def score(self, eval_data, eval_metric, num_batch=None,
              batch_end_callback=None, score_end_callback=None, reset=True,
              epoch=0, sparse_row_id_fn=None):
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)
        eval_metric.reset()
        actual_num_batch = 0
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            self.update_metric(eval_metric, eval_batch.label)
            if batch_end_callback is not None:
                for cb in _as_list(batch_end_callback):
                    cb(_BatchEndParam(epoch, nbatch, eval_metric))
            actual_num_batch += 1
        if score_end_callback:
            for cb in _as_list(score_end_callback):
                cb(_BatchEndParam(epoch, actual_num_batch, eval_metric))
        return eval_metric.get_name_value()

    def iter_predict(self, eval_data, num_batch=None, reset=True,
                     sparse_row_id_fn=None):
        """Yield ``(outputs, nbatch, batch)`` per batch, the padding cut
        off (upstream MXNet's ``BaseModule.iter_predict``)."""
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            pad = eval_batch.pad or 0
            outputs = [out[0:out.shape[0] - pad]
                       for out in self.get_outputs()]
            yield outputs, nbatch, eval_batch

    def predict(self, eval_data, num_batch=None, merge_batches=True,
                reset=True, always_output_list=False,
                sparse_row_id_fn=None):
        output_list = [outs for outs, _, _ in self.iter_predict(
            eval_data, num_batch=num_batch, reset=reset)]
        if len(output_list) == 0:
            return output_list
        if merge_batches:
            num_outputs = len(output_list[0])
            for out in output_list:
                if len(out) != num_outputs:
                    raise MXNetError(
                        "Cannot merge batches: different number of outputs")
            output_list2 = [
                nd.concat(*[out[i] for out in output_list], dim=0)
                for i in range(num_outputs)
            ]
            if num_outputs == 1 and not always_output_list:
                return output_list2[0]
            return output_list2
        return output_list

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", optimizer="sgd",
            optimizer_params=(("learning_rate", 0.01),),
            eval_end_callback=None, eval_batch_end_callback=None,
            initializer=None, arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None,
            monitor=None, sparse_row_id_fn=None, resume_from=None,
            checkpoint=None, checkpoint_period=1):
        """Full training loop (reference base_module.py:409-538).

        ``checkpoint`` — a prefix (or CheckpointManager) fit checkpoints
        to, atomically, at every ``checkpoint_period`` epoch boundary;
        retention follows ``MXNET_CKPT_KEEP`` for a prefix.
        ``MXNET_BAD_STEP_LIMIT`` > 0 arms the step-level NaN/Inf guard:
        a non-finite step is skipped (update withheld); after that many
        consecutive bad steps fit restores the last good checkpoint and
        raises."""
        assert num_epoch is not None, "please specify number of epochs"
        _refuse_unported(resume_from)
        from .. import initializer as init_mod
        from ..config import get_env
        from ..resilience.checkpoint import CheckpointManager

        if initializer is None:
            initializer = init_mod.Uniform(0.01)
        ckpt_mgr = None
        if checkpoint is not None:
            ckpt_mgr = checkpoint if isinstance(checkpoint,
                                                CheckpointManager) \
                else CheckpointManager(str(checkpoint),
                                       keep_n=get_env("MXNET_CKPT_KEEP"))

        self.bind(
            data_shapes=train_data.provide_data,
            label_shapes=train_data.provide_label,
            for_training=True, force_rebind=force_rebind)
        if monitor is not None:
            self.install_monitor(monitor)
        self.init_params(
            initializer=initializer, arg_params=arg_params,
            aux_params=aux_params, allow_missing=allow_missing,
            force_init=force_init)
        self.init_optimizer(
            kvstore=kvstore, optimizer=optimizer,
            optimizer_params=optimizer_params)

        if validation_metric is None:
            validation_metric = eval_metric
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)
        # the telemetry session (a no-op shell when MXNET_RUNLOG is
        # unset): step records, sampled loss syncs and the flight dumps
        # of the in-fit death paths hang off it
        from .. import telemetry as _tm
        from ..resilience.preempt import PreemptionDrain

        # the device feed: fit owns the wrapper it makes and closes it
        # on the way out, or its producer would go on reading the
        # caller's iterator
        from ..io.device_feed import DeviceFeedIter, device_feed_enabled

        owned_feed = None
        if device_feed_enabled() and \
                not isinstance(train_data, DeviceFeedIter):
            train_data = owned_feed = DeviceFeedIter(
                train_data, device=getattr(self, "_context", None))
        batch_size = 0
        try:
            batch_size = int(train_data.provide_data[0][1][0])
        except Exception:
            pass
        # feed-wait and H2D deltas come from whichever feed drives the
        # loop: fit's own or one the caller made
        feed = owned_feed if owned_feed is not None else (
            train_data if isinstance(train_data, DeviceFeedIter)
            else None)
        session = _tm.fit_session(batch_size=batch_size, feed=feed)
        drain = PreemptionDrain()
        try:
            with drain:
                self._fit_epochs(
                    train_data, eval_data, eval_metric, validation_metric,
                    begin_epoch, num_epoch, monitor, batch_end_callback,
                    epoch_end_callback, eval_end_callback,
                    eval_batch_end_callback, ckpt_mgr=ckpt_mgr,
                    checkpoint_period=checkpoint_period, drain=drain,
                    session=session)
            session.finish("preempted" if drain.requested is not None
                           else "ok")
        except BaseException as exc:  # noqa: BLE001 — flight-record
            # every in-fit death (a NaN abort dumped at its raise site;
            # the first dump's reason wins)
            session.flight(f"exception:{type(exc).__name__}")
            session.finish("error")
            raise
        finally:
            if owned_feed is not None:
                owned_feed.close()
                # the caller's iterator comes back reset, not part-read
                # by the producer's last read-ahead
                if hasattr(owned_feed.base, "reset"):
                    owned_feed.base.reset()
        # drained: the checkpoint and the flight dump are on disk — hand
        # the signal back to its original disposition
        drain.reraise()

    def _save_fit_checkpoint(self, ckpt_mgr, epoch, batch_cursor):
        """Flush one atomic checkpoint version (epoch boundaries): a
        fresh monotonic version id, the epoch and cursor in the
        manifest."""
        arg_p, aux_p = self.get_params()
        states = None
        get_states = getattr(self, "_get_optimizer_states", None)
        if get_states is not None:
            try:
                states = get_states()
            except MXNetError:
                states = None  # optimizer not initialized yet
        version = ckpt_mgr.allocate_version(min_version=max(1, int(epoch)))
        return ckpt_mgr.save(
            version, symbol=self._symbol, arg_params=arg_p,
            aux_params=aux_p, optimizer_states=states,
            batch_cursor=batch_cursor, epoch=epoch)

    def _outputs_finite(self):
        """NaN/Inf probe over the step's outputs (a device sync — only
        ever called with the bad-step guard armed)."""
        for out in self.get_outputs():
            a = out.asnumpy() if hasattr(out, "asnumpy") \
                else onp.asarray(out)
            if not onp.isfinite(a).all():
                return False
        return True

    def _step_finite(self):
        """Whether the step just run is safe to apply; Module also probes
        the gradients."""
        return self._outputs_finite()

    def _emit_tensor_stats(self, step, epoch):
        """The numerics monitor's ``tensor_stats`` record of the named
        gradient buffers; called only on sampled or bad steps, and a
        telemetry failure never kills training."""
        from .. import telemetry as _tm
        from ..telemetry import numerics as _nm

        rl = _tm.current()
        grads_of = getattr(self, "_named_grads", None)
        if rl is None or grads_of is None:
            return
        try:
            grads = grads_of()
            if grads:
                _nm.emit(rl, step, _nm.summarize_named(grads),
                         where="grad", epoch=epoch)
        except Exception:
            self.logger.debug("numerics monitor emission failed",
                              exc_info=True)

    def _fit_epochs(self, train_data, eval_data, eval_metric,
                    validation_metric, begin_epoch, num_epoch, monitor,
                    batch_end_callback, epoch_end_callback,
                    eval_end_callback, eval_batch_end_callback,
                    ckpt_mgr=None, checkpoint_period=1, drain=None,
                    session=None):
        from ..config import get_env
        from ..resilience import faultsim
        from ..telemetry import numerics as _nm

        if session is None:
            # direct callers get the shell, run-log-less and watchdog-
            # less: nothing on this path would close an armed watchdog
            from ..telemetry.session import FitSession

            session = FitSession(None, watchdog=False)
        bad_limit = int(get_env("MXNET_BAD_STEP_LIMIT"))
        bad_run = 0
        # the numerics monitor: the gradients are host-visible buffers
        # here, so the summaries run only on sampled steps and on every
        # bad step
        numerics_on = _nm.armed()
        nm_period = _nm.sample_period() if numerics_on else 0
        nm_step = 0
        checkpoint_period = int(max(1, checkpoint_period))
        for epoch in range(begin_epoch, num_epoch):
            tic = time.time()
            eval_metric.reset()
            nbatch = 0
            data_iter = iter(train_data)
            end_of_batch = False
            # an empty iterator fails loudly, as in the reference
            next_data_batch = next(data_iter)
            while not end_of_batch:
                data_batch = next_data_batch
                if monitor is not None:
                    monitor.tic()
                session.step_begin()
                self.forward_backward(data_batch)
                bad_step = False
                if bad_limit > 0:
                    bad_step = (faultsim.inject("step.loss_nan")
                                == "nan") or not self._step_finite()
                if numerics_on and (bad_step
                                    or nm_step % nm_period == 0):
                    self._emit_tensor_stats(nm_step, epoch)
                nm_step += 1
                if bad_step:
                    # skip-and-count: the update is withheld so one NaN
                    # batch cannot poison the params
                    bad_run += 1
                    self.logger.warning(
                        "Epoch[%d] Batch[%d] non-finite step — update "
                        "skipped (%d/%d consecutive)", epoch, nbatch,
                        bad_run, bad_limit)
                    if bad_run >= bad_limit:
                        restored = None
                        if ckpt_mgr is not None:
                            restored = ckpt_mgr.latest_epoch()
                            if restored is not None:
                                state = ckpt_mgr.load(restored)
                                self.set_params(state["arg_params"],
                                                state["aux_params"])
                                set_states = getattr(
                                    self, "_set_optimizer_states", None)
                                if set_states is not None and \
                                        state.get("optimizer_states"):
                                    set_states(state["optimizer_states"])
                        session.flight("nan_abort")
                        raise MXNetError(
                            f"aborting fit: {bad_run} consecutive "
                            f"non-finite steps (MXNET_BAD_STEP_LIMIT="
                            f"{bad_limit}) at epoch {epoch} batch "
                            f"{nbatch}; parameters "
                            + (f"restored to checkpoint epoch "
                               f"{restored}" if restored is not None
                               else "left as of the last finite step "
                               "(no checkpoint to restore)"))
                else:
                    bad_run = 0
                    self.update()
                try:
                    next_data_batch = next(data_iter)
                except StopIteration:
                    end_of_batch = True
                self.update_metric(eval_metric, data_batch.label)
                if session:
                    # sampled device sync only: unsampled steps keep
                    # wall timing but read no metric value
                    synced = session.should_sync()
                    loss_val = None
                    if synced:
                        try:
                            nv = eval_metric.get_name_value()
                            if nv and nv[0][1] == nv[0][1]:  # not NaN
                                loss_val = float(nv[0][1])
                        except Exception:
                            pass
                    session.step_end(epoch, nbatch, loss=loss_val,
                                     synced=synced, bad_step=bad_step)
                if monitor is not None:
                    monitor.toc_print()
                if batch_end_callback is not None:
                    for cb in _as_list(batch_end_callback):
                        cb(_BatchEndParam(epoch, nbatch, eval_metric))
                nbatch += 1
                if drain is not None and drain.requested is not None:
                    # preemption drain: the step in flight is done —
                    # flush a checkpoint with the batch cursor, dump the
                    # flight recorder, then unwind (fit re-raises)
                    if ckpt_mgr is not None:
                        self._save_fit_checkpoint(ckpt_mgr, epoch, nbatch)
                    self.logger.info(
                        "Preemption drain (signal %s) at epoch %d batch "
                        "%d", drain.requested, epoch, nbatch)
                    session.flight("preempt_drain")
                    return
            for name, val in eval_metric.get_name_value():
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            toc = time.time()
            self.logger.info("Epoch[%d] Time cost=%.3f", epoch, toc - tic)

            arg_p, aux_p = self.get_params()
            self.set_params(arg_p, aux_p)
            if epoch_end_callback is not None:
                for callback in _as_list(epoch_end_callback):
                    callback(epoch, self.symbol, arg_p, aux_p)
            if ckpt_mgr is not None \
                    and (epoch + 1) % checkpoint_period == 0:
                # epoch boundary: cursor 0, epoch field = next epoch
                self._save_fit_checkpoint(ckpt_mgr, epoch + 1, 0)

            if eval_data is not None:
                res = self.score(
                    eval_data, validation_metric,
                    score_end_callback=eval_end_callback,
                    batch_end_callback=eval_batch_end_callback,
                    epoch=epoch)
                for name, val in res:
                    self.logger.info(
                        "Epoch[%d] Validation-%s=%f", epoch, name, val)
            train_data.reset()

    # subclass responsibilities ----------------------------------------
    def bind(self, *a, **k):
        raise NotImplementedError

    def init_params(self, *a, **k):
        raise NotImplementedError

    def init_optimizer(self, *a, **k):
        raise NotImplementedError

    def forward(self, *a, **k):
        raise NotImplementedError

    def backward(self, *a, **k):
        raise NotImplementedError

    def update(self):
        raise NotImplementedError

    def update_metric(self, *a, **k):
        raise NotImplementedError

    def get_outputs(self):
        raise NotImplementedError

    def get_params(self):
        raise NotImplementedError

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        self.init_params(
            initializer=None, arg_params=arg_params, aux_params=aux_params,
            allow_missing=allow_missing, force_init=force_init,
            allow_extra=allow_extra)

    def install_monitor(self, mon):
        raise NotImplementedError


class _BatchEndParam:
    def __init__(self, epoch, nbatch, eval_metric):
        self.epoch = epoch
        self.nbatch = nbatch
        self.eval_metric = eval_metric
        self.locals = None


def _as_list(x):
    return x if isinstance(x, (list, tuple)) else [x]
