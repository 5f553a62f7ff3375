"""Training callbacks (counterpart of ``mxnet_tpu/callback.py``;
reference: python/mxnet/callback.py)."""
from __future__ import annotations

import logging
import math
import time

__all__ = ["module_checkpoint", "do_checkpoint", "log_train_metric",
           "Speedometer", "ProgressBar", "LogValidationMetricsCallback"]


def module_checkpoint(mod, prefix, period=1, save_optimizer_states=False,
                      keep_n=None):
    """Checkpoint the Module at the end of every `period` epochs.

    Writes route through the atomic versioned writer
    (resilience.checkpoint): rename-atomic payloads, CRC manifest,
    `latest` pointer.  ``keep_n`` prunes older versions (None keeps
    all, the historical behavior)."""
    period = int(max(1, period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            mod.save_checkpoint(prefix, iter_no + 1,
                                save_optimizer_states, keep_n=keep_n)

    return _callback


def do_checkpoint(prefix, period=1, keep_n=None):
    """Checkpoint params (+symbol) every `period` epochs (reference
    callback.py:55), atomically (see ``module_checkpoint``)."""
    from . import model

    period = int(max(1, period))

    def _callback(iter_no, sym, arg, aux):
        if (iter_no + 1) % period == 0:
            model.save_checkpoint(prefix, iter_no + 1, sym, arg, aux,
                                  keep_n=keep_n)

    return _callback


def log_train_metric(period, auto_reset=False):
    def _callback(param):
        if param.nbatch % period == 0 and param.eval_metric is not None:
            name_value = param.eval_metric.get_name_value()
            for name, value in name_value:
                logging.info(
                    "Iter[%d] Batch[%d] Train-%s=%f",
                    param.epoch, param.nbatch, name, value)
            if auto_reset:
                param.eval_metric.reset()

    return _callback


class Speedometer:
    """Log training speed + metrics every `frequent` batches (reference
    callback.py:120).

    Timing uses ``time.perf_counter()`` — a monotonic clock — so an
    NTP step or wall-clock jump during training cannot produce
    negative or absurd samples/sec.  When run telemetry is active
    (``MXNET_RUNLOG``), the reported rate is the RunLog's recent-step
    throughput — the same number the run log and metrics textfile
    carry — instead of a second independent measurement."""

    def __init__(self, batch_size, frequent=50, auto_reset=True):
        self.batch_size = batch_size
        self.frequent = frequent
        self.init = False
        self.tic = 0
        self.last_count = 0
        self.auto_reset = auto_reset

    def _speed(self):
        try:
            from . import telemetry

            rl = telemetry.current()
            if rl is not None:
                # only over the steps of this reporting interval (since
                # tic): an eval loop records no steps, so this returns
                # None and the own clock answers
                authoritative = rl.recent_throughput(since=self.tic)
                if authoritative is not None:
                    return authoritative
        except Exception:
            pass  # broken telemetry must not silence the log line
        try:
            return (self.frequent * self.batch_size
                    / (time.perf_counter() - self.tic))
        except ZeroDivisionError:
            return float("inf")

    def __call__(self, param):
        count = param.nbatch
        if self.last_count > count:
            self.init = False
        self.last_count = count

        if self.init:
            if count % self.frequent == 0:
                speed = self._speed()
                if param.eval_metric is not None:
                    name_value = param.eval_metric.get_name_value()
                    if self.auto_reset:
                        param.eval_metric.reset()
                    msg = "Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec"
                    msg += "\t%s=%f" * len(name_value)
                    logging.info(
                        msg, param.epoch, count, speed,
                        *sum(name_value, ()))
                else:
                    logging.info(
                        "Iter[%d] Batch [%d]\tSpeed: %.2f samples/sec",
                        param.epoch, count, speed)
                self.tic = time.perf_counter()
        else:
            self.init = True
            self.tic = time.perf_counter()


class ProgressBar:
    """ASCII progress bar (reference ProgressBar)."""

    def __init__(self, total, length=80):
        self.bar_len = length
        self.total = total

    def __call__(self, param):
        count = param.nbatch
        filled_len = int(round(self.bar_len * count / float(self.total)))
        percents = math.ceil(100.0 * count / float(self.total))
        prog_bar = "=" * filled_len + "-" * (self.bar_len - filled_len)
        logging.info("[%s] %s%s\r", prog_bar, percents, "%")


class LogValidationMetricsCallback:
    def __call__(self, param):
        if not param.eval_metric:
            return
        name_value = param.eval_metric.get_name_value()
        for name, value in name_value:
            logging.info(
                "Epoch[%d] Validation-%s=%f", param.epoch, name, value)
