"""BaseModule: the high-level train/predict interface (counterpart of
``mxnet_tpu/module/base_module.py``).

Reference parity: python/mxnet/module/base_module.py (``fit`` :409-538 —
bind → init_params → init_optimizer → epoch loop forward_backward /
update / metric / checkpoint; ``score``, ``predict``).

``fit`` wraps ``train_data`` in the device feed (``io.DeviceFeedIter``,
``MXNET_DEVICE_FEED``, on by default, as the reference's): batches reach
the module's device on a side stream while the step before runs, so
``forward``'s own move is a no-op.  fit closes the feed it made on the
way out and hands the caller's iterator back reset.  ``fit`` runs a
telemetry session (``telemetry.fit_session``: step records, sampled
loss syncs, the numerics monitor's ``tensor_stats`` on sampled and bad
steps, the hang watchdog of ``MXNET_WATCHDOG_SEC``, the flight dump on
every in-fit death) and a preemption drain: SIGTERM/SIGINT finishes
the step in flight, saves a checkpoint when fit has one, dumps the
flight recorder and re-raises the signal.  ``resume_from=`` restores
parameters, optimizer states, the RNG and the epoch/batch cursor;
``MXNET_SNAPSHOT_EVERY`` takes asynchronous snapshots; peer healing
(``MXNET_HEARTBEAT_DIR``) polls a failure detector at every step
boundary, as the reference's.
"""
from __future__ import annotations

import logging
import time

import numpy as onp

from .. import metric as metric_mod
from .. import ndarray as nd
from ..base import MXNetError

__all__ = ["BaseModule"]


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

        * ``checkpoint`` — a prefix (or CheckpointManager) fit
          checkpoints to: atomically at every ``checkpoint_period``
          epoch boundary, and mid-epoch on a SIGTERM/SIGINT drain.
          Retention follows ``MXNET_CKPT_KEEP`` for a prefix.
        * ``resume_from`` — a prefix (or CheckpointManager) to restore
          from: parameters, optimizer states, host and device RNG and
          the epoch/batch cursor come back, and the data iterator is
          skipped ahead, so a killed-and-relaunched fit continues
          bit-exactly (given the same seed and a deterministic
          iterator).  A topology stamp in the manifest goes through
          ``elastic.reshard_verdict``/``reslice_cursor``.  Overrides
          ``arg_params``/``begin_epoch``.
        * ``MXNET_BAD_STEP_LIMIT`` > 0 arms the step-level NaN/Inf
          guard: a non-finite step is skipped (update withheld); after
          that many consecutive bad steps fit restores the last good
          checkpoint and raises.
        * ``MXNET_SNAPSHOT_EVERY`` > 0 (with ``checkpoint=``) takes an
          asynchronous snapshot every that many batches: the
          device-to-host copy at the step boundary, the atomic write on
          a background thread (``MXNET_CKPT_ASYNC=0`` makes it
          synchronous).
        * with peer healing armed (``MXNET_HEARTBEAT_DIR`` and a
          multi-process elastic world, or an explicit ``healing.arm``),
          each step runs under ``healing.guard_collective`` and every
          step boundary renews this rank's beat and polls the failure
          detector: a declared peer death fires the emergency
          checkpoint (the freshest snapshot) and raises
          ``PeerDeadError`` out of fit; the healing supervisor
          relaunches, and the resume counts ``auto_reshards``.
        """
        assert num_epoch is not None, "please specify number of epochs"
        from .. import initializer as init_mod
        from ..config import get_env
        from ..context import cpu
        from ..resilience.checkpoint import CheckpointManager, restore_rng

        if initializer is None:
            initializer = init_mod.Uniform(0.01)
        resume_state = None
        if resume_from is not None:
            rmgr = resume_from if isinstance(resume_from,
                                             CheckpointManager) \
                else CheckpointManager(str(resume_from))
            # host arrays: init_params moves them to the module's device
            resume_state = rmgr.load(ctx=cpu())
            arg_params = resume_state["arg_params"]
            aux_params = resume_state["aux_params"]
            begin_epoch = int(resume_state["epoch"])
            force_init = True
            allow_missing = False
            self.logger.info(
                "Resuming fit from checkpoint epoch %d (batch cursor "
                "%d)", begin_epoch, resume_state["batch_cursor"])
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

        resume_cursor = 0
        if resume_state is not None:
            resume_cursor = self._resume_from_state(resume_state)
            restore_rng(resume_state.get("rng"))

        if validation_metric is None:
            validation_metric = eval_metric
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)
        if resume_cursor > 0:
            # mid-epoch resume: skip the batches the interrupted run
            # already trained on, before the device feed exists, so the
            # skipped batches are never moved to the card
            skip_iter = iter(train_data)
            for _ in range(resume_cursor):
                try:
                    next(skip_iter)
                except StopIteration:
                    break
        # the telemetry session (a no-op shell when MXNET_RUNLOG is
        # unset): step records, sampled loss syncs and the flight dumps
        # of the in-fit death paths hang off it
        from .. import telemetry as _tm
        from ..resilience import healing as _healing
        from ..resilience.preempt import PreemptionDrain

        # the device feed: fit owns the wrapper it makes and closes it
        # on the way out, or its producer would go on reading the
        # caller's iterator
        from ..io.device_feed import DeviceFeedIter, device_feed_enabled

        owned_feed = None
        if device_feed_enabled() and \
                not isinstance(train_data, DeviceFeedIter):
            # under a mesh the feed moves only this process's rows
            train_data = owned_feed = DeviceFeedIter(
                train_data, device=getattr(self, "_context", None),
                mesh=getattr(self, "_mesh", None))
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
        # peer healing: the heartbeat and the failure detector, armed
        # when the env configures them; unarmed this is one env read
        _healing.arm_from_env()
        drain = PreemptionDrain()
        try:
            with drain:
                self._fit_epochs(
                    train_data, eval_data, eval_metric, validation_metric,
                    begin_epoch, num_epoch, monitor, batch_end_callback,
                    epoch_end_callback, eval_end_callback,
                    eval_batch_end_callback, ckpt_mgr=ckpt_mgr,
                    checkpoint_period=checkpoint_period, drain=drain,
                    resume_cursor=resume_cursor, session=session)
            session.finish("preempted" if drain.requested is not None
                           else "ok")
        except BaseException as exc:  # noqa: BLE001 — flight-record
            # every in-fit death (a NaN abort dumped at its raise site;
            # the first dump's reason wins)
            session.flight(f"exception:{type(exc).__name__}")
            session.finish("error")
            raise
        finally:
            if ckpt_mgr is not None:
                # every captured snapshot lands (or errors) and the
                # writer stops; a later save_async re-arms it
                try:
                    ckpt_mgr.close_async()
                except Exception:
                    pass
            if owned_feed is not None:
                owned_feed.close()
                # the caller's iterator comes back reset, not part-read
                # by the producer's last read-ahead
                if hasattr(owned_feed.base, "reset"):
                    owned_feed.base.reset()
        # drained: the checkpoint and the flight dump are on disk — hand
        # the signal back to its original disposition
        drain.reraise()

    def _resume_from_state(self, resume_state):
        """Restore the optimizer states of a loaded checkpoint and
        return its batch cursor, re-sliced for the live world.  A
        manifest with a topology stamp is compared with the live world
        first: a changed world is logged and counted (``reshards``; on
        a supervisor relaunch also ``auto_reshards`` and a ``heal``
        "resume" record), never a death; a changed global batch under a
        mid-epoch cursor raises."""
        resume_cursor = int(resume_state.get("batch_cursor", 0))
        old_topo = resume_state.get("topology")
        if old_topo:
            from ..resilience import elastic as _elastic

            resume_cursor, _ = _elastic._apply_resume_topology(
                old_topo, self._topology_block(), resume_cursor,
                logger=self.logger)
        states = resume_state.get("optimizer_states")
        set_states = getattr(self, "_set_optimizer_states", None)
        if states and set_states is not None:
            set_states(states)
        return resume_cursor

    def _fit_checkpoint_state(self, ckpt_mgr, epoch, batch_cursor):
        """(version, save kwargs) of the live module state — shared by
        the synchronous drain/boundary saves and the asynchronous
        snapshot cadence, so the two never differ in what they
        capture.  Version ids are strictly monotonic
        (``allocate_version`` counts queued snapshots too): an
        existing version is never rewritten in place.  The manifest's
        epoch and batch cursor carry the resume truth."""
        arg_p, aux_p = self.get_params()
        states = None
        get_states = getattr(self, "_get_optimizer_states", None)
        if get_states is not None:
            try:
                states = get_states()
            except MXNetError:
                states = None  # optimizer not initialized yet
        version = ckpt_mgr.allocate_version(min_version=max(1, int(epoch)))
        # the (constant) symbol is serialized once per module, not once
        # per cadence snapshot
        cache = getattr(self, "_symbol_json_cache", None)
        if cache is None or cache[0] is not self._symbol:
            cache = (self._symbol, self._symbol.tojson()
                     if self._symbol is not None else None)
            self._symbol_json_cache = cache
        return version, dict(
            symbol_json=cache[1], arg_params=arg_p, aux_params=aux_p,
            optimizer_states=states, batch_cursor=batch_cursor,
            epoch=epoch, topology=self._topology_block())

    def _save_fit_checkpoint(self, ckpt_mgr, epoch, batch_cursor,
                             lock_timeout=None):
        """Flush one atomic checkpoint version synchronously (epoch
        boundaries, preemption drains).  ``lock_timeout`` bounds the
        writer-lock wait on the peer-death path: when the async writer
        is wedged holding the lock, the heal exit proceeds without this
        version, and says so."""
        version, kw = self._fit_checkpoint_state(ckpt_mgr, epoch,
                                                 batch_cursor)
        if not self._writes_checkpoints():
            return None
        man = ckpt_mgr.save(version, lock_timeout=lock_timeout, **kw)
        if man is None and lock_timeout is not None:
            self.logger.warning(
                "checkpoint version %d SKIPPED: writer lock still "
                "held after %.0fs (wedged async write?)", version,
                lock_timeout)
        return man

    def _snapshot_fit_checkpoint(self, ckpt_mgr, epoch, batch_cursor):
        """One MXNET_SNAPSHOT_EVERY cadence snapshot: capture at this
        step boundary, write off the critical path
        (``CheckpointManager.save_async``; ``MXNET_CKPT_ASYNC=0`` makes
        the write synchronous).  The freshest capture doubles as the
        emergency checkpoint a peer death or a watchdog abort
        flushes."""
        from ..config import get_env

        version, kw = self._fit_checkpoint_state(ckpt_mgr, epoch,
                                                 batch_cursor)
        if not self._writes_checkpoints():
            return
        if get_env("MXNET_CKPT_ASYNC"):
            ckpt_mgr.save_async(version, **kw)
        else:
            ckpt_mgr.save(version, **kw)

    def _writes_checkpoints(self):
        """Whether this process writes fit's checkpoints (every process
        computes their state; under a Module's mesh only rank 0
        writes)."""
        return True

    def _topology_block(self):
        """The world stamp of this module's checkpoints
        (``resilience.elastic.topology_block``); Module overrides it.
        None keeps the manifest as a pre-elastic one."""
        return None

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
                    resume_cursor=0, session=None):
        from ..config import get_env
        from ..resilience import faultsim
        from ..resilience import healing as _healing
        from ..telemetry import numerics as _nm

        if session is None:
            # direct callers get the shell, run-log-less and watchdog-
            # less: nothing on this path would close an armed watchdog
            from ..telemetry.session import FitSession

            session = FitSession(None, watchdog=False)
        bad_limit = int(get_env("MXNET_BAD_STEP_LIMIT"))
        bad_run = 0

        # peer healing: with a detector armed, the collective-bearing
        # calls run under guard_collective, so a peer dying inside a
        # collective surfaces as PeerDeadError instead of wedging the
        # survivor; unarmed this is a plain call
        def _guarded(fn, label):
            det = _healing.detector()
            if det is None:
                return fn()
            return _healing.guard_collective(fn, det, label=label)

        def _heal_out(epoch, nbatch):
            # the emergency checkpoint flushes the freshest snapshot (no
            # collective: the group is already broken); with no
            # snapshot captured yet, a direct save (the Module's state
            # is process-local), with a bounded wait for the writer lock
            paths = _healing.fire_emergency("peer_death")
            if not paths and ckpt_mgr is not None:
                try:
                    self._save_fit_checkpoint(ckpt_mgr, epoch, nbatch,
                                              lock_timeout=10.0)
                except Exception:
                    self.logger.exception(
                        "peer-death fallback checkpoint failed")

        # the async snapshot cadence: every N batches, capture params,
        # optimizer states, RNG and cursor at the step boundary and
        # write off the critical path
        snap_every = int(get_env("MXNET_SNAPSHOT_EVERY")) \
            if ckpt_mgr is not None else 0
        snap_step = 0
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
            if epoch == begin_epoch and resume_cursor > 0:
                # fit() already skipped the source ahead; only the batch
                # numbering resumes here
                nbatch = resume_cursor
            end_of_batch = False
            boundary_resume = False
            next_data_batch = None
            try:
                next_data_batch = next(data_iter)
            except StopIteration:
                if epoch == begin_epoch and resume_cursor > 0:
                    # the resume landed on the epoch boundary: nothing
                    # left to train, but the epoch-end contract below
                    # still runs, so the checkpoint cadence matches an
                    # uninterrupted run
                    boundary_resume = True
                else:
                    # an empty iterator fails loudly, as in the
                    # reference
                    raise
            drained = False
            while not end_of_batch and not boundary_resume:
                data_batch = next_data_batch
                if monitor is not None:
                    monitor.tic()
                session.step_begin()
                try:
                    _guarded(lambda: self.forward_backward(data_batch),
                             "fit_forward_backward")
                except _healing.PeerDeadError:
                    _heal_out(epoch, nbatch)
                    raise
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
                                # a full rollback, the RNG included
                                from ..resilience.checkpoint import \
                                    restore_rng

                                state = ckpt_mgr.load(restored)
                                self.set_params(state["arg_params"],
                                                state["aux_params"])
                                set_states = getattr(
                                    self, "_set_optimizer_states", None)
                                if set_states is not None and \
                                        state.get("optimizer_states"):
                                    set_states(state["optimizer_states"])
                                restore_rng(state.get("rng"))
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
                    try:
                        _guarded(self.update, "fit_update")
                    except _healing.PeerDeadError:
                        _heal_out(epoch, nbatch)
                        raise
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
                snap_step += 1
                # the healing poll (one dict lookup unarmed): renew this
                # rank's beat and raise PeerDeadError on a declared
                # death, before the cadence snapshot starts
                try:
                    _healing.poll(step=snap_step)
                except _healing.PeerDeadError:
                    _heal_out(epoch, nbatch)
                    raise
                if snap_every > 0 and snap_step % snap_every == 0:
                    try:
                        _guarded(lambda: self._snapshot_fit_checkpoint(
                            ckpt_mgr, epoch, nbatch), "fit_snapshot")
                    except _healing.PeerDeadError:
                        _heal_out(epoch, nbatch)
                        raise
                if drain is not None and drain.requested is not None:
                    # preemption drain: the step in flight is done —
                    # queued snapshots land first, then a checkpoint
                    # with the batch cursor (the newest version), the
                    # flight dump, and fit unwinds and re-raises
                    drained_ckpt = None
                    if ckpt_mgr is not None:
                        ckpt_mgr.wait_async(timeout=30.0)
                        drained_ckpt = self._save_fit_checkpoint(
                            ckpt_mgr, epoch, nbatch, lock_timeout=15.0)
                    self.logger.info(
                        "Preemption drain (signal %s): %s at epoch %d "
                        "batch %d", drain.requested,
                        "checkpoint" if drained_ckpt is not None
                        else "no checkpoint written here", epoch, nbatch)
                    session.flight("preempt_drain")
                    drained = True
                    break
            if drained:
                return
            if not boundary_resume:
                for name, val in eval_metric.get_name_value():
                    self.logger.info("Epoch[%d] Train-%s=%f", epoch, name,
                                     val)
                toc = time.time()
                self.logger.info("Epoch[%d] Time cost=%.3f", epoch,
                                 toc - tic)

            arg_p, aux_p = self.get_params()
            self.set_params(arg_p, aux_p)
            if epoch_end_callback is not None:
                for callback in _as_list(epoch_end_callback):
                    callback(epoch, self.symbol, arg_p, aux_p)
            if ckpt_mgr is not None \
                    and (epoch + 1) % checkpoint_period == 0:
                # epoch boundary: cursor 0, epoch field = next epoch.
                # The schedule is absolute (epoch number), so a resume
                # keeps the uninterrupted run's cadence
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
