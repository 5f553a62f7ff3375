"""Elastic multi-process runtime: reshard-on-resize resume (counterpart
of ``mxnet_tpu/resilience/elastic.py``).

MXNet's distributed layer (ps-lite) let a job survive a changing worker
set.  This module is the port's counterpart, built so that losing k
processes is a resume at the new world size, not a restart:

* :func:`elastic_init` — multi-process bring-up over
  ``torch.distributed``: the coordinator address and process id/count
  resolve from explicit arguments, the ``MXNET_*`` knobs, then the
  ``DMLC_*`` launcher contract; the job's rendezvous is
  ``kvstore.init_distributed``'s ``TCPStore`` (process 0 serves it) and
  gloo group, so a process has one rendezvous whether the store or
  this module opens it.  A bounded-retry loop (:mod:`.retry`) makes a
  flaky coordinator or a slow peer a backoff, and a barrier all-reduce
  proves the group before any state is built.
* :func:`topology_block` — the checkpoint manifest's ``topology``
  stamp: world size, process count, mesh shape, optimizer-sharding
  mode, bucket-plan fingerprint and the global batch.
* :func:`reshard_verdict` / :func:`reslice_cursor` — the resize
  decision and the batch cursor across it (cursors count GLOBAL
  batches, so a resize at a fixed global batch keeps them).
* :class:`ElasticHostIter` — this process's deterministic row slice of
  a global batch stream, so any world size consumes the same samples.
* :func:`host_gather` — one host copy of an array: a copy of a
  replicated tensor, an all-gather of a bucket shard (a ZeRO stage-3
  parameter, a sharded optimizer state).

The port has one device per process: :func:`elastic_mesh` is the mesh
of the world's processes (``parallel.Mesh``).

Fault points (``resilience.faultsim``): ``dist.init`` fires inside
every bring-up attempt (an armed ``raise`` exercises the retry path),
``dist.collective`` before the barrier's all-reduce.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as onp

from ..base import MXNetError
from . import faultsim
from .retry import retry_call

__all__ = ["ElasticContext", "elastic_enabled", "elastic_init",
           "initialized", "context", "elastic_mesh", "host_gather",
           "topology_block", "reshard_verdict", "reslice_cursor",
           "ElasticHostIter"]

faultsim.register_point("dist.init", "inside every process-group "
                        "bring-up attempt of elastic_init")
faultsim.register_point("dist.collective", "before the elastic "
                        "barrier's all-reduce")


@dataclasses.dataclass(frozen=True)
class ElasticContext:
    """One process's view of the elastic job after bring-up."""

    coordinator: str | None   # host:port, None for single-process
    num_processes: int
    process_id: int
    world_devices: int        # devices across every process
    local_devices: int
    backend: str

    @property
    def is_coordinator(self):
        return self.process_id == 0

    @property
    def distributed(self):
        return self.coordinator is not None


_STATE = {"ctx": None}


def _env_or(name, dmlc, cast, sentinel):
    """Resolve one bring-up knob: MXNET_* first, the DMLC_* launcher
    contract second (``tools/launch.py`` exports those)."""
    from ..config import get_env

    v = get_env(name)
    if v != sentinel:
        return cast(v)
    raw = os.environ.get(dmlc)
    if raw is not None:
        return cast(raw)
    return None


def elastic_enabled():
    """Whether multi-process bring-up is requested: ``MXNET_ELASTIC``
    set, or an explicit coordinator in the env (``MXNET_COORDINATOR``
    / a ``DMLC_NUM_WORKER > 1`` launcher contract)."""
    from ..config import get_env

    if get_env("MXNET_ELASTIC"):
        return True
    if get_env("MXNET_COORDINATOR"):
        return True
    try:
        return int(os.environ.get("MXNET_NUM_PROCESSES",
                                  os.environ.get("DMLC_NUM_WORKER", 1))
                   ) > 1
    except ValueError:
        return False


def initialized():
    return _STATE["ctx"] is not None


def context():
    """The live :class:`ElasticContext`, or None before bring-up."""
    return _STATE["ctx"]


def _resolve_bringup(coordinator, num_processes, process_id):
    from ..config import get_env

    if coordinator is None:
        coordinator = get_env("MXNET_COORDINATOR") or None
    if coordinator is None:
        uri = os.environ.get("DMLC_PS_ROOT_URI")
        port = os.environ.get("DMLC_PS_ROOT_PORT")
        # the DMLC contract only implies a coordinator when a launcher
        # actually exported a >1 worker job
        if uri and port and int(os.environ.get("DMLC_NUM_WORKER",
                                               "1")) > 1:
            coordinator = f"{uri}:{port}"
    if num_processes is None:
        num_processes = _env_or("MXNET_NUM_PROCESSES",
                                "DMLC_NUM_WORKER", int, 0)
    if process_id is None:
        process_id = _env_or("MXNET_PROCESS_ID", "DMLC_WORKER_ID",
                             int, -1)
    return coordinator, num_processes, process_id


def _local_backend():
    """The device type the process's default context names: ``cuda``
    for ``gpu(0)`` (the port's default), else ``cpu``."""
    from ..context import current_context

    return "cuda" if current_context().device_type == "gpu" else "cpu"


def elastic_init(coordinator=None, num_processes=None, process_id=None,
                 attempts=None, timeout_sec=None, barrier=True):
    """Multi-process bring-up (idempotent; returns the live context).

    * knob resolution — explicit args > ``MXNET_COORDINATOR`` /
      ``MXNET_NUM_PROCESSES`` / ``MXNET_PROCESS_ID`` > the ``DMLC_*``
      launcher contract;
    * the rendezvous is ``kvstore.init_distributed``'s ``TCPStore`` at
      the coordinator (process 0 serves it) and its gloo group; a group
      the store already opened is reused when its world matches;
    * a bounded-retry loop (``MXNET_DIST_INIT_ATTEMPTS`` attempts
      within ``MXNET_DIST_INIT_TIMEOUT_SEC`` total) around the
      bring-up — the ``dist.init`` fault point fires inside every
      attempt, so an armed flake is retried like a real coordinator
      hiccup;
    * an optional barrier all-reduce proving the group before any
      training state is built (the ``dist.collective`` point fires
      there).

    Single-process jobs (no coordinator resolvable, process count
    <= 1) skip ``torch.distributed`` and return a local context.
    """
    if _STATE["ctx"] is not None:
        return _STATE["ctx"]
    from ..config import get_env

    coordinator, num_processes, process_id = _resolve_bringup(
        coordinator, num_processes, process_id)
    if coordinator is None and (num_processes or 1) > 1:
        # the silent version of this misconfiguration is N world-size-1
        # jobs each believing it is rank 0, training the full dataset
        # independently and overwriting each other's checkpoints
        raise MXNetError(
            f"elastic_init: num_processes={num_processes} but no "
            "coordinator resolved (set MXNET_COORDINATOR=host:port or "
            "the DMLC_PS_ROOT_URI/DMLC_PS_ROOT_PORT launcher "
            "contract)")
    if coordinator is None or (num_processes or 1) <= 1:
        ctx = ElasticContext(coordinator=None, num_processes=1,
                             process_id=0, world_devices=1,
                             local_devices=1, backend=_local_backend())
        _STATE["ctx"] = ctx
        return ctx
    if num_processes is None or process_id is None or process_id < 0:
        raise MXNetError(
            "elastic_init: a coordinator was resolved "
            f"({coordinator!r}) but num_processes/process_id were not "
            "(set MXNET_NUM_PROCESSES/MXNET_PROCESS_ID or the DMLC_* "
            "launcher contract)")
    import torch.distributed as dist

    from .. import kvstore

    attempts = int(attempts if attempts is not None
                   else get_env("MXNET_DIST_INIT_ATTEMPTS"))
    timeout_sec = float(timeout_sec if timeout_sec is not None
                        else get_env("MXNET_DIST_INIT_TIMEOUT_SEC"))

    def once():
        faultsim.inject("dist.init")
        kvstore.init_distributed(coordinator=str(coordinator),
                                 num_workers=int(num_processes),
                                 rank=int(process_id))

    def on_retry(attempt, exc):
        try:
            from .. import telemetry

            telemetry.count("dist_init_retries")
            telemetry.event("dist_init_retry", attempt=attempt,
                            error=type(exc).__name__,
                            coordinator=coordinator)
        except Exception:
            pass
        try:  # a half-initialized group must not poison the redial
            if dist.is_initialized():
                dist.destroy_process_group()
        except Exception:
            pass
        kvstore._rendezvous = None

    retry_call(once,
               retry_on=(RuntimeError, ConnectionError, OSError,
                         faultsim.FaultInjected),
               attempts=attempts, base_delay=0.2, max_delay=5.0,
               deadline_sec=timeout_sec, on_retry=on_retry)
    if dist.get_world_size() != int(num_processes) \
            or dist.get_rank() != int(process_id):
        raise MXNetError(
            f"elastic_init: the live process group is rank "
            f"{dist.get_rank()} of {dist.get_world_size()}, not "
            f"{process_id} of {num_processes}")
    ctx = ElasticContext(
        coordinator=str(coordinator), num_processes=int(num_processes),
        process_id=int(process_id), world_devices=int(num_processes),
        local_devices=1, backend=str(dist.get_backend()))
    _STATE["ctx"] = ctx
    if barrier:
        elastic_barrier()
    try:
        from .. import telemetry

        telemetry.event("elastic_init", coordinator=ctx.coordinator,
                        num_processes=ctx.num_processes,
                        process_id=ctx.process_id,
                        world_devices=ctx.world_devices)
    except Exception:
        pass
    return ctx


def elastic_barrier():
    """A real collective across every process: the all-reduce of a one
    must equal the process count.  Proves the group is live before any
    training state is built (a dead peer surfaces here, not
    mid-epoch)."""
    import torch
    import torch.distributed as dist

    faultsim.inject("dist.collective")
    if not dist.is_initialized() or dist.get_world_size() <= 1:
        return 1
    n = dist.get_world_size()
    ones = torch.ones(1, dtype=torch.float32)
    dist.all_reduce(ones)
    total = int(ones.item())
    if total != n:
        raise MXNetError(
            f"elastic barrier all-reduce returned {total}, want {n} — "
            "the cross-process group is not healthy")
    return total


def elastic_mesh(dp=None, tp=1, devices=None):
    """The ``('data',)`` mesh of this process's world (the reference's
    ``elastic_mesh``): one device a process, so a world of N processes
    is the N-process mesh of ``parallel.Mesh``, this process its rank,
    on ``devices[0]`` (default: ``parallel.process_device``).  ``tp`` >
    1 (tensor parallelism) waits for ROADMAP §A 8."""
    from ..parallel import Mesh, get_mesh, process_device

    ctx = _STATE["ctx"]
    world = ctx.world_devices if ctx is not None else 1
    tp = max(1, int(tp))
    dp = world // tp if dp is None else int(dp)
    if dp * tp != world:
        raise MXNetError(
            f"elastic_mesh: dp({dp}) x tp({tp}) != {world} devices")
    if tp != 1:
        raise MXNetError(
            f"elastic_mesh: a dp({dp}) x tp({tp}) mesh is tensor "
            "parallelism, which is not ported yet (ROADMAP §A 8)")
    if world == 1:
        return get_mesh(devices=devices)
    if devices is not None and len(devices) > 1:
        return get_mesh(devices=devices)  # raises: one device a process
    rank = ctx.process_id
    dev = process_device(rank) if not devices else \
        get_mesh(devices=devices).devices[0]
    return Mesh((dev,), ("data",), world, rank)


def host_gather(x):
    """One host numpy copy of an array (an NDArray, a tensor or
    anything numpy takes).  A replicated tensor is a device-to-host
    copy; this process's shard of a bucket split over a mesh's
    processes (``parallel.zero.mark_shard``: a stage-3 parameter, a
    sharded optimizer state) all-gathers to the whole bucket first,
    a collective every process of the mesh must join.  bf16 comes back
    as float32, which numpy can hold."""
    import torch

    data = getattr(x, "_data", x)
    if isinstance(data, torch.Tensor):
        from ..ops.collective_ops import Exchange
        from ..parallel.zero import shard_mesh

        mesh = shard_mesh(data)
        data = data.detach()
        if mesh is not None:
            data = Exchange(mesh).all_gather(data)
        if data.dtype == torch.bfloat16:
            data = data.float()
        return data.to("cpu").numpy()
    return onp.asarray(data)


# ------------------------------------------------------------- topology
def _mesh_world(mesh):
    width = int(mesh.shape.get("data", len(mesh.devices)))
    return width, (width,), tuple(str(a) for a in mesh.axis_names)


def topology_block(world_size=None, num_processes=None, mesh=None,
                   sharding="none", plan=None, global_batch=None,
                   zero_stage=None):
    """The checkpoint manifest's ``topology`` stamp, in the reference's
    keys.

    ``world_size`` is the data-mesh width; ``plan`` (a ``parallel.zero``
    bucket list) contributes its fingerprint so a resume can tell "same
    shard count, same packing" from "must re-plan" without loading any
    state; ``zero_stage`` rides both the stamp and the fingerprint."""
    if mesh is not None:
        width, mesh_shape, mesh_axes = _mesh_world(mesh)
        if world_size is None:
            world_size = width
    else:
        mesh_shape = (int(world_size),) if world_size else (1,)
        mesh_axes = ("data",)
    if world_size is None:
        world_size = 1
    if num_processes is None:
        ctx = _STATE["ctx"]
        num_processes = ctx.num_processes if ctx is not None else 1
    block = {
        "world_size": int(world_size),
        "num_processes": int(num_processes),
        "mesh_shape": list(mesh_shape),
        "mesh_axes": list(mesh_axes),
        "sharding": str(sharding),
    }
    if zero_stage is not None:
        block["zero_stage"] = int(zero_stage)
    if plan is not None:
        from ..parallel.zero import plan_fingerprint

        block["plan_fingerprint"] = plan_fingerprint(plan, world_size,
                                                     zero_stage)
        block["n_buckets"] = len(plan)
    if global_batch is not None:
        block["global_batch"] = int(global_batch)
    return block


def reshard_verdict(old, new):
    """The resize decision for a resume: given the checkpoint's
    ``topology`` block and the live one, say whether optimizer state
    must re-shard and whether the batch cursor transfers.

    * equal world size AND equal plan fingerprint → ``reshard: False``
      (a same-N resume is a no-op);
    * anything that changes the shard layout (world size, mesh shape,
      sharding mode, bucket plan) → ``reshard: True`` with the reasons
      listed;
    * ``cursor_compatible`` is False only when both sides stamped a
      global batch and they differ.
    """
    old = dict(old or {})
    new = dict(new or {})
    reasons = []
    for key, label in (("world_size", "world size"),
                       ("mesh_shape", "mesh shape"),
                       ("sharding", "sharding mode"),
                       ("plan_fingerprint", "bucket plan")):
        a, b = old.get(key), new.get(key)
        if a is not None and b is not None and a != b:
            reasons.append(f"{label} {a!r} -> {b!r}")
    gb_old, gb_new = old.get("global_batch"), new.get("global_batch")
    cursor_ok = not (gb_old is not None and gb_new is not None
                     and int(gb_old) != int(gb_new))
    return {
        "reshard": bool(reasons),
        "reasons": reasons,
        "old_world": old.get("world_size"),
        "new_world": new.get("world_size"),
        "cursor_compatible": cursor_ok,
    }


def reslice_cursor(batch_cursor, old, new):
    """Re-slice the batch cursor across a new data-mesh width.

    Cursors count GLOBAL batches of a fixed global batch size, so the
    number of consumed batches is invariant under a resize — each
    process of the new world skips exactly ``batch_cursor`` batches of
    its own re-sliced stream (:class:`ElasticHostIter`).  A cursor
    cannot cross a global batch-size change: the sample boundary would
    land mid-batch, so that raises."""
    batch_cursor = int(batch_cursor)
    if batch_cursor == 0:
        return 0
    v = reshard_verdict(old, new)
    if not v["cursor_compatible"]:
        raise MXNetError(
            "cannot re-slice a mid-epoch batch cursor across a global "
            f"batch change ({dict(old or {}).get('global_batch')} -> "
            f"{dict(new or {}).get('global_batch')}): the sample "
            "boundary would land mid-batch.  Resume from an "
            "epoch-boundary checkpoint, or keep the global batch "
            "fixed across the resize.")
    return batch_cursor


def _apply_resume_topology(old, new, batch_cursor, logger=None):
    """The topology step of a resume (``Module.fit(resume_from=)``, and
    a hand-written loop resuming the same way): the verdict of ``old``
    against ``new`` and the re-sliced cursor.  A changed world is
    logged and counted (``reshards`` and a ``resize`` event; on a
    supervisor relaunch also ``auto_reshards`` and a ``heal`` "resume"
    record), never a death.  Returns ``(cursor, verdict)``."""
    from .. import telemetry
    from . import healing

    verdict = reshard_verdict(old, new)
    cursor = reslice_cursor(batch_cursor, old, new)
    if not verdict["reshard"]:
        if logger is not None:
            logger.info("Elastic resume: topology unchanged (world %s)",
                        verdict["new_world"])
        return cursor, verdict
    if logger is not None:
        logger.info("Elastic resume: topology changed (%s)",
                    "; ".join(verdict["reasons"]))
    telemetry.count("reshards")
    telemetry.event("resize", old_world=verdict["old_world"],
                    new_world=verdict["new_world"],
                    reasons=verdict["reasons"], batch_cursor=cursor)
    attempt = healing.relaunch_attempt()
    if attempt > 0:
        # a supervisor relaunch healing a peer death: this reshard
        # happened with no operator action
        telemetry.count("auto_reshards")
        telemetry.heal("resume", old_world=verdict["old_world"],
                       new_world=verdict["new_world"],
                       batch_cursor=cursor, attempt=attempt)
    return cursor, verdict


class ElasticHostIter:
    """Deterministic per-process re-slicing of a global batch stream.

    Wraps an iterator yielding GLOBAL batches (an ``NDArrayIter`` at the
    fixed global batch size, same seed on every process) and yields
    this process's contiguous row slice of each:
    ``rows[rank * b_local : (rank + 1) * b_local]``.  The slicing is a
    pure function of (global batch index, rank, num_hosts), so a resume
    at another process count re-partitions the SAME global stream — no
    sample dropped or double-fed, and a cursor of k global batches
    means "skip k batches of your own stream" at any world size.
    """

    def __init__(self, base, rank, num_hosts):
        self.base = base
        self.rank = int(rank)
        self.num_hosts = max(1, int(num_hosts))
        if not 0 <= self.rank < self.num_hosts:
            raise MXNetError(
                f"ElasticHostIter: rank {rank} outside "
                f"[0, {num_hosts})")

    def _slice_desc(self, descs):
        out = []
        for d in descs:
            name, shape = d[0], tuple(d[1])
            if shape[0] % self.num_hosts:
                raise MXNetError(
                    f"global batch {shape[0]} of {name!r} must divide "
                    f"the {self.num_hosts}-host world")
            out.append((name, (shape[0] // self.num_hosts,)
                        + shape[1:]))
        return out

    @property
    def provide_data(self):
        return self._slice_desc(self.base.provide_data)

    @property
    def provide_label(self):
        return self._slice_desc(self.base.provide_label)

    def reset(self):
        self.base.reset()

    def _slice(self, arr):
        n = arr.shape[0]
        if n % self.num_hosts:
            raise MXNetError(
                f"global batch {n} must divide the "
                f"{self.num_hosts}-host world")
        b = n // self.num_hosts
        return arr[self.rank * b:(self.rank + 1) * b]

    def _slice_any(self, a):
        if hasattr(a, "_data"):  # NDArray: slice the backing tensor
            from .. import ndarray as nd

            return nd.NDArray(self._slice(a._data))
        return self._slice(onp.asarray(a))

    def _local_pad(self, global_pad, global_n):
        """This process's share of the global batch's pad count.
        Padding rows live at the TAIL of the global batch, so only the
        processes whose row range overlaps ``[global_n - pad,
        global_n)`` carry any."""
        global_pad = int(global_pad or 0)
        if not global_pad:
            return 0
        b = global_n // self.num_hosts
        end = (self.rank + 1) * b
        return max(0, min(b, end - (global_n - global_pad)))

    def __iter__(self):
        for batch in self.base:
            if hasattr(batch, "data"):  # DataBatch
                from ..io import DataBatch

                yield DataBatch(
                    data=[self._slice_any(a) for a in batch.data],
                    label=[self._slice_any(a)
                           for a in (batch.label or [])] or None,
                    pad=self._local_pad(
                        getattr(batch, "pad", 0),
                        int(batch.data[0].shape[0])))
            else:  # raw (x, y) tuples
                yield tuple(self._slice(onp.asarray(a))
                            for a in batch)

    def next(self):
        if not hasattr(self, "_it"):
            self._it = iter(self)
        try:
            return next(self._it)
        except StopIteration:
            del self._it
            raise
