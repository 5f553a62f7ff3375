"""Atomic, versioned, verifiable checkpoints (counterpart of
``mxnet_tpu/resilience/checkpoint.py``).

* **Atomic writes** — every payload goes write-to-temp + fsync +
  ``os.replace``; the final path is either its previous content or the
  complete new content, never a torn mix.
* **Versioned manifests** — each checkpoint carries a JSON manifest
  (epoch, step, batch cursor, per-payload size + CRC32, the autotune
  winners-file hash) and a ``prefix-latest.json`` pointer written LAST.
* **Verification + fallback** — :meth:`CheckpointManager.verify`
  detects truncated/corrupt payloads by size+CRC; ``load()`` /
  ``latest_epoch()`` fall back to the newest version that verifies.
* **Retention** — ``keep_n`` prunes old versions after each save.
* **Asynchronous snapshots** — :meth:`CheckpointManager.save_async`
  copies every array to the host at the caller's step boundary (the
  copy is complete when it returns, so an in-place optimizer update of
  the next step cannot reach the snapshot) and writes it on a
  background thread through a bounded queue; the freshest capture is
  the emergency checkpoint :mod:`.healing` flushes on a peer death or
  a watchdog abort.

``prefix-symbol.json`` and ``prefix-NNNN.params`` are the reference's
bytes for the same symbol and arrays; the manifest has the reference's
keys.  Its ``rng`` is :func:`capture_rng`'s: numpy's global state as
the reference writes it, and the port's generators.  Every save writes a
``checkpoint`` run-log record, and a load that falls back past corrupt
versions a ``checkpoint`` record with ``reason="fallback"``.
:func:`stage3_save_params` / :func:`stage3_load_params` carry ZeRO
stage 3's bucket shards to and from the named ``.params`` layout.
"""
from __future__ import annotations

import hashlib
import json
import os
import queue
import threading
import time
import zlib

import numpy as onp

from ..base import MXNetError
from ..context import cpu
from . import faultsim

__all__ = ["CheckpointManager", "atomic_write_bytes", "capture_rng",
           "restore_rng", "stage3_save_params", "stage3_load_params"]

faultsim.register_point("ckpt.write", "mid-payload in checkpoint "
                        "atomic_write")
faultsim.register_point("ckpt.async", "async snapshot writer thread, "
                        "mid-payload in every atomic write of a "
                        "save_async version")

def stage3_save_params(plan, params):
    """ZeRO stage 3's ``{"_bucket<i>": shard}`` -> the named
    ``{name: numpy array}`` for :meth:`CheckpointManager.save` (reference
    ``stage3_save_params``).  Each bucket gathers to one host copy
    through ``elastic.host_gather`` (a collective under a process mesh:
    every process calls it), so the ``.params`` on disk are
    interchangeable with replicated and stage-1/2 runs."""
    from ..parallel.zero import gather_stage3_params, stage3_param_keys
    from .elastic import host_gather

    keys = set(stage3_param_keys(plan))
    named = gather_stage3_params(plan, {k: host_gather(v)
                                        for k, v in params.items()
                                        if k in keys})
    return {n: v.numpy() for n, v in named.items()}


def stage3_load_params(plan, arg_params, mesh=None):
    """The inverse of :func:`stage3_save_params`: a loaded named
    ``arg_params`` in the stage-3 layout, this process's shards under a
    ``mesh``.  Check the manifest's topology first
    (``elastic.reshard_verdict``): another plan would misread the
    buckets."""
    import torch

    from ..parallel.zero import shard_stage3_params

    named = {k: torch.as_tensor(onp.asarray(
        v.asnumpy() if hasattr(v, "asnumpy") else v))
        for k, v in arg_params.items()}
    return shard_stage3_params(plan, named, mesh=mesh)


def capture_rng():
    """The host and device RNG state as JSON-serializable data, so a
    resumed run continues the interrupted one's random streams.

    ``"numpy"`` is numpy's global Mersenne state exactly as the
    reference writes it (the 624 words as base64 of their bytes).
    ``"device"`` is the port's own: the seed new generators take and the
    state of every per-device ``torch.Generator`` made so far (base64),
    or None before any exists.  It does not cross packages: the
    reference's ``"device"`` is a JAX key, which the port cannot read,
    and the reference cannot read the port's."""
    import base64

    from .. import _rng

    st = onp.random.get_state()
    key = onp.asarray(st[1], onp.uint32)
    state = {"numpy": [st[0],
                       {"b64": base64.b64encode(
                           key.tobytes()).decode("ascii")},
                       int(st[2]), int(st[3]), float(st[4])],
             "device": None}
    gens = _rng.generator_states()
    if gens:
        state["device"] = {
            "seed": _rng._S.seed,
            "generators": {d: base64.b64encode(raw).decode("ascii")
                           for d, raw in gens.items()}}
    return state


def restore_rng(state):
    """Restore a :func:`capture_rng` snapshot (missing parts no-op).
    ``"numpy"`` takes the base64 form and the legacy integer list, as
    the reference's; a ``"device"`` that is not the port's (a JAX key
    list) is skipped."""
    import base64

    from .. import _rng

    if not state:
        return
    np_st = state.get("numpy")
    if np_st:
        key = np_st[1]
        if isinstance(key, dict):
            key = onp.frombuffer(base64.b64decode(key["b64"]), onp.uint32)
        onp.random.set_state((np_st[0], onp.asarray(key, onp.uint32),
                              int(np_st[2]), int(np_st[3]),
                              float(np_st[4])))
    dev = state.get("device")
    if isinstance(dev, dict):
        _rng.set_generator_states(
            {d: base64.b64decode(b) for d, b in dev["generators"].items()},
            dev.get("seed"))


def atomic_write_bytes(path, data, inject_point="ckpt.write"):
    """Write ``data`` to ``path`` atomically: temp file in the same
    directory, fsync, then rename over the target (plus a directory
    fsync so the rename itself is durable).

    The fault-injection point fires MID-payload, so an armed
    ``ckpt.write:crash`` leaves a truncated *temp* file and the final
    path untouched — exactly the torn-write scenario the old direct
    ``nd.save`` could not survive.
    """
    path = os.fspath(path)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    # pid AND thread id: two writers racing toward the same target keep
    # distinct temp files, so both writes stay atomic (the loser's rename
    # is a benign overwrite of identical content)
    tmp = os.path.join(
        d, f".{os.path.basename(path)}.tmp.{os.getpid()}"
           f".{threading.get_ident()}")
    try:
        with open(tmp, "wb") as f:
            half = len(data) // 2
            f.write(data[:half])
            if inject_point:
                faultsim.inject(inject_point)
            f.write(data[half:])
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    try:
        dfd = os.open(d, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:
        pass  # platforms/filesystems without directory fsync


_AT_HASH_CACHE = {"key": None, "hash": None}


def _autotune_hash():
    """SHA-256 of the persisted autotune winners file, recorded so a
    resume can tell whether it is replaying under the same variant
    choices the checkpointed run trained with (the reference's
    ``_autotune_hash``).  Memoized by (path, mtime, size)."""
    try:
        from .. import autotune

        p = autotune.cache_path()
        st = os.stat(p)
        key = (p, st.st_mtime_ns, st.st_size)
        if _AT_HASH_CACHE["key"] != key:
            with open(p, "rb") as f:
                _AT_HASH_CACHE["hash"] = \
                    hashlib.sha256(f.read()).hexdigest()
            _AT_HASH_CACHE["key"] = key
        return _AT_HASH_CACHE["hash"]
    except Exception:
        return None


def _crc(blob):
    return zlib.crc32(blob) & 0xFFFFFFFF

def _host_copies(named):
    """``{key: host NDArray}`` of ``named`` (NDArrays, or anything numpy
    takes), every copy complete when this returns and sharing no
    storage with its source, so a step that updates a source in place
    later cannot reach a captured snapshot (the reference's arrays are
    immutable; the port's are not).  Card tensors go to pinned host
    buffers (PyTorch's caching host allocator reuses them once a
    snapshot is written), every copy queued before one wait on each
    stream that carries them."""
    import torch

    from .. import ndarray as nd

    out, streams = {}, {}
    for k, v in named.items():
        if not isinstance(v, nd.NDArray):
            out[k] = nd.array(onp.asarray(v), ctx=cpu())
            continue
        t = v._data.detach()
        if t.is_cuda:
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            buf.copy_(t, non_blocking=True)
            stream = torch.cuda.current_stream(t.device)
            streams[id(stream)] = stream
        else:
            buf = t.clone()
        out[k] = nd.NDArray(buf)
    for stream in streams.values():
        stream.synchronize()
    return out


def _split_params(save_dict):
    """Split a loaded ``arg:``/``aux:``-keyed dict (the reference
    .params convention) into (arg_params, aux_params)."""
    arg_params, aux_params = {}, {}
    for k, v in save_dict.items():
        tp, _, name = k.partition(":")
        if tp == "arg":
            arg_params[name] = v
        elif tp == "aux":
            aux_params[name] = v
    return arg_params, aux_params

class CheckpointManager:
    """Owner of one checkpoint series under ``prefix``.

    Files per version ``NNNN`` (all written atomically, manifest after
    payloads, ``latest`` pointer last):

    * ``prefix-NNNN.params``        — ``arg:``/``aux:`` blobs, the
      reference binary format (``load_checkpoint`` compatible)
    * ``prefix-NNNN.states``        — pickled optimizer state (optional)
    * ``prefix-NNNN.manifest.json`` — epoch/step/cursor, per-payload
      size+CRC32, RNG snapshot, autotune winners hash
    * ``prefix-symbol.json``        — the network (shared across versions)
    * ``prefix-latest.json``        — pointer to the newest version
    """

    MANIFEST_FORMAT = 1

    def __init__(self, prefix, keep_n=None):
        self.prefix = os.fspath(prefix)
        self.keep_n = keep_n
        self._vlock = threading.Lock()
        self._reserved = 0        # highest version handed out in-process
        self._write_lock = threading.Lock()  # serializes version writes
        self._written = set()     # versions already durably written
        self._good_cache = set()  # versions that verified (this process)
        self._async = None        # lazy _AsyncWriter
        self._freshest = None     # newest captured snapshot (host-side)

    # ------------------------------------------------------------ paths
    def params_path(self, epoch):
        return f"{self.prefix}-{int(epoch):04d}.params"

    def states_path(self, epoch):
        return f"{self.prefix}-{int(epoch):04d}.states"

    def manifest_path(self, epoch):
        return f"{self.prefix}-{int(epoch):04d}.manifest.json"

    def symbol_path(self):
        return f"{self.prefix}-symbol.json"

    def latest_path(self):
        return f"{self.prefix}-latest.json"

    def _dir(self):
        return os.path.dirname(os.path.abspath(self.prefix)) or "."

    # ------------------------------------------------------------- save
    def save(self, version, symbol=None, symbol_json=None,
             arg_params=None, aux_params=None, optimizer_states=None,
             step=None, batch_cursor=0, extra=None, epoch=None,
             topology=None, lock_timeout=None):
        """Write one atomic checkpoint version; returns its manifest.

        ``version`` names the files (``prefix-NNNN.*``); ``epoch`` is
        the training epoch recorded in the manifest and defaults to
        the version — they coincide for clean epoch-boundary saves,
        and diverge when fit's mid-epoch drain allocates a fresh
        version id to avoid rewriting an existing one in place.
        ``batch_cursor`` records how many batches of that epoch were
        already consumed (0 = a clean epoch boundary) — the resume
        cursor for mid-epoch preemption drains.

        ``topology`` (``resilience.elastic.topology_block``) stamps
        the world the checkpoint was written FROM — world size, mesh
        shape, optimizer-sharding mode, bucket-plan fingerprint,
        global batch — so a resume at a different world size can
        detect the mismatch and re-plan/re-shard instead of dying,
        while a same-topology resume provably skips the reshard.
        """
        cap = self._capture(version, symbol=symbol,
                            symbol_json=symbol_json,
                            arg_params=arg_params,
                            aux_params=aux_params,
                            optimizer_states=optimizer_states,
                            step=step, batch_cursor=batch_cursor,
                            extra=extra, epoch=epoch,
                            topology=topology)
        return self._write_version(cap, lock_timeout=lock_timeout)

    # -------------------------------------------------- capture / write
    def _capture(self, version, symbol=None, symbol_json=None,
                 arg_params=None, aux_params=None,
                 optimizer_states=None, step=None, batch_cursor=0,
                 extra=None, epoch=None, topology=None):
        """Snapshot everything a checkpoint version needs onto the
        HOST, now: every array copied off its device (``_host_copies``), the
        symbol's JSON, the RNG state and the autotune hash.  The
        returned dict is self-contained: writing it later (the async
        writer thread, an emergency flush) touches no device."""
        version = int(version)
        with self._vlock:
            self._reserved = max(self._reserved, version)
        named = {f"arg:{k}": v for k, v in (arg_params or {}).items()}
        named.update({f"aux:{k}": v for k, v in (aux_params or {}).items()})
        save_dict = _host_copies(named)
        if symbol_json is None and symbol is not None:
            symbol_json = symbol.tojson()
        return {
            "version": version,
            "epoch": version if epoch is None else int(epoch),
            "save_dict": save_dict,
            "optimizer_states": optimizer_states,
            "symbol_json": symbol_json,
            "step": step,
            "batch_cursor": int(batch_cursor),
            "rng": capture_rng(),
            "autotune_sha256": _autotune_hash(),
            "topology": topology,
            "extra": extra or {},
        }

    def _write_version(self, cap, inject_point="ckpt.write",
                       telemetry_extra=None, skip_if_written=False,
                       lock_timeout=None):
        """Serialize + atomically write one captured version: every
        payload write-to-temp+fsync+rename, manifest after payloads,
        ``latest`` pointer LAST — a crash anywhere leaves the previous
        complete version as ``latest``.  Serialized against concurrent
        writers (async thread vs emergency flush vs sync save).
        ``skip_if_written`` (the async/emergency paths, which race
        toward the same allocated version) returns None instead of
        rewriting a version this process already made durable; the sync
        ``save()`` keeps its rewrite-in-place semantics.
        ``lock_timeout`` bounds the wait for the writer lock (the
        emergency/abort paths: when the wedge IS a hung write holding
        the lock, blocking here would stop the abort from ever reaching
        its ``os._exit``) — on timeout, None."""
        from .. import ndarray as nd

        t_save0 = time.perf_counter()
        version = cap["version"]
        if lock_timeout is None:
            self._write_lock.acquire()
        elif not self._write_lock.acquire(timeout=float(lock_timeout)):
            return None  # the lock holder is wedged: do not join it
        try:
            if skip_if_written and version in self._written:
                return None  # already durably written (emergency won)
            files = {}
            payload = nd.save_buffer(cap["save_dict"])
            ppath = self.params_path(version)
            atomic_write_bytes(ppath, payload,
                               inject_point=inject_point)
            files[os.path.basename(ppath)] = {
                "bytes": len(payload), "crc32": _crc(payload)}
            states = cap.get("optimizer_states")
            if states is not None:
                spath = self.states_path(version)
                atomic_write_bytes(spath, states,
                                   inject_point=inject_point)
                files[os.path.basename(spath)] = {
                    "bytes": len(states), "crc32": _crc(states)}
            sj = cap.get("symbol_json")
            if sj is not None:
                # the symbol file is SHARED across versions: skip the
                # rewrite when this manager already wrote identical
                # content (the cadence-snapshot path would otherwise
                # re-write an unchanged multi-MB graph per snapshot)
                sj_crc = _crc(sj.encode())
                if getattr(self, "_symbol_crc", None) != sj_crc:
                    atomic_write_bytes(self.symbol_path(),
                                       sj.encode(),
                                       inject_point=inject_point)
                    self._symbol_crc = sj_crc
            manifest = {
                "format": self.MANIFEST_FORMAT,
                "version": version,
                "epoch": cap["epoch"],
                "step": cap.get("step"),
                "batch_cursor": int(cap.get("batch_cursor", 0)),
                "files": files,
                "rng": cap.get("rng"),
                "autotune_sha256": cap.get("autotune_sha256"),
                "topology": cap.get("topology"),
                "time": time.time(),
                "extra": cap.get("extra") or {},
            }
            atomic_write_bytes(self.manifest_path(version),
                               json.dumps(manifest, indent=1).encode(),
                               inject_point=inject_point)
            # the pointer goes LAST: a crash anywhere above leaves
            # `latest` naming the previous complete version.  On the
            # ASYNC/emergency paths it only ever moves FORWARD (a
            # queued snapshot landing after a newer drain save must
            # not point resumes back at the older version); a sync
            # save() keeps the legacy rule — the pointer follows the
            # last explicit save, lower version number or not
            cur = -1
            if skip_if_written:
                try:
                    with open(self.latest_path(), "rb") as f:
                        cur = int(json.loads(f.read())["epoch"])
                except (OSError, ValueError, KeyError, TypeError):
                    pass  # unreadable/corrupt pointer: overwrite it
            if version >= cur:
                atomic_write_bytes(
                    self.latest_path(),
                    json.dumps({"epoch": version,
                                "manifest": os.path.basename(
                                    self.manifest_path(version))}
                               ).encode(),
                    inject_point=inject_point)
            self._written.add(version)
            # just written from in-memory blobs whose CRCs the manifest
            # records: good by construction for this process's
            # retention decisions
            self._good_cache.add(version)
            self._apply_retention()
        finally:
            self._write_lock.release()
        from .. import telemetry

        telemetry.checkpoint_event(
            self.prefix, version, time.perf_counter() - t_save0,
            sum(f["bytes"] for f in files.values()),
            **(telemetry_extra or {}))
        return manifest

    def allocate_version(self, min_version=1):
        """A fresh monotonic version id: past everything on disk AND
        everything handed out in this process (the async queue
        included), so sync saves, async snapshots and emergency flushes
        never collide.  ``min_version`` lets fit keep the legacy
        version==epoch naming for the first clean save."""
        with self._vlock:
            eps = self.epochs()
            v = max((eps[-1] + 1) if eps else 1, self._reserved + 1,
                    int(min_version))
            self._reserved = v
            return v

    # -------------------------------------------------- async snapshots
    def save_async(self, version=None, symbol=None, symbol_json=None,
                   arg_params=None, aux_params=None,
                   optimizer_states=None, step=None, batch_cursor=0,
                   extra=None, epoch=None, topology=None,
                   queue_depth=2):
        """Asynchronous snapshot checkpoint: capture NOW (device→host
        at the caller's step boundary), write LATER (serialization +
        atomic writes on a background thread), so the training step
        never waits on the disk.

        * the bounded queue (``queue_depth``) back-pressures: when the
          disk cannot keep up, the CALLER blocks on the next
          ``save_async`` instead of snapshots accumulating in host
          memory;
        * the freshest capture is retained in memory and registered as
          the EMERGENCY checkpoint source (:mod:`.healing`): a peer
          death or watchdog abort flushes it synchronously — no
          collective and no device needed;
        * the ``ckpt.async`` fault point fires mid-payload inside the
          writer thread: an armed ``crash`` proves a mid-write death
          leaves ``latest`` == previous-good with no torn final file;
        * each completed write bumps the ``ckpt_async_writes`` counter
          and emits the standard ``checkpoint`` record with
          ``async=True``.

        Returns the allocated version id immediately.
        """
        if version is None:
            version = self.allocate_version()
        cap = self._capture(version, symbol=symbol,
                            symbol_json=symbol_json,
                            arg_params=arg_params,
                            aux_params=aux_params,
                            optimizer_states=optimizer_states,
                            step=step, batch_cursor=batch_cursor,
                            extra=extra, epoch=epoch,
                            topology=topology)
        self._freshest = cap
        if self._async is None:
            self._async = _AsyncWriter(self, depth=int(queue_depth))
            from . import healing

            healing.register_emergency(self._emergency_hook)
        self._async.submit(cap)
        return int(version)

    def wait_async(self, timeout=None):
        """Block until every queued snapshot is durably written (the
        drain/exit path: a final sync save must not overtake a queued
        async one in the version order a resume trusts)."""
        if self._async is not None:
            return self._async.drain(timeout=timeout)
        return True

    def close_async(self, timeout=None):
        """Drain and stop the writer thread; unregisters the emergency
        hook.  Idempotent."""
        wr, self._async = self._async, None
        if wr is None:
            return True
        from . import healing

        healing.unregister_emergency(self._emergency_hook)
        return wr.close(timeout=timeout)

    def flush_emergency(self, reason="emergency", lock_timeout=10.0):
        """Synchronously write the freshest captured snapshot if it is
        not yet on disk — the failure detector's death path and the
        watchdog's abort escalation call this (directly or through
        ``healing.fire_emergency``).  Fault injection is disabled for
        this write, and the writer lock is taken with a timeout: when
        the wedge being escaped is itself a hung checkpoint write
        holding the lock, the emergency gives up and lets the abort
        reach its ``os._exit``.  Returns the manifest path written, or
        None when the freshest snapshot is already durable (or
        unreachable)."""
        cap = self._freshest
        if cap is None or cap["version"] in self._written:
            return None
        cap = dict(cap)
        cap["extra"] = dict(cap.get("extra") or {}, emergency=reason)
        man = self._write_version(cap, inject_point=None,
                                  telemetry_extra={"emergency": reason},
                                  skip_if_written=True,
                                  lock_timeout=lock_timeout)
        if man is None:
            return None
        return self.manifest_path(cap["version"])

    def _emergency_hook(self, reason):
        return self.flush_emergency(reason)

    # --------------------------------------------------------- retention
    def _verified_good(self, e):
        """verify() with a positive memo: a version this process wrote
        or already verified is trusted without re-reading its payloads
        on every retention sweep (rot after a positive verdict is the
        accepted trade — retention is belt-and-braces, fsck re-reads
        everything)."""
        if e in self._good_cache:
            return True
        if self.verify(e):
            self._good_cache.add(e)
            return True
        return False

    def _apply_retention(self):
        """keep_n retention that can never garbage-collect the
        recovery chain: the newest ``keep_n`` VERIFIED-GOOD versions
        are kept (torn versions do not count against the window), and
        only versions strictly older than the oldest kept good one are
        pruned.  With every version healthy this is exactly the old
        count-based prune; with the newest versions torn (foreign
        truncation, bit rot, a lying fsync) the last good generations
        survive — the count-based prune deleted the newest good
        version while keeping its torn juniors."""
        if not self.keep_n or int(self.keep_n) <= 0:
            return
        keep_n = int(self.keep_n)
        eps = self.epochs()
        if len(eps) <= keep_n:
            return
        # NEWEST-first with early stop: verification walks down only
        # until keep_n good versions are found.  A save through this
        # manager just seeded its own version into the good-cache, so
        # the steady state re-reads at most keep_n-1 older payloads —
        # and only on the first sweep of a freshly constructed
        # manager (later sweeps hit the cache for everything kept).
        good_found = 0
        floor = None
        for e in reversed(eps):
            if self._verified_good(e):
                good_found += 1
                if good_found >= keep_n:
                    floor = e
                    break
        if good_found == 0:
            return  # nothing verifies: delete NOTHING — any file may
            #         be the operator's last forensic straw
        if floor is None:
            return  # fewer than keep_n good versions exist: keep all
        for e in eps:
            if e >= floor:
                continue
            for p in (self.params_path(e), self.states_path(e),
                      self.manifest_path(e)):
                try:
                    os.unlink(p)
                except OSError:
                    pass
            self._good_cache.discard(e)

    # ----------------------------------------------------------- lookup
    def epochs(self):
        """All versions on disk (ascending), from their manifests."""
        base = os.path.basename(self.prefix)
        out = []
        try:
            names = os.listdir(self._dir())
        except OSError:
            return out
        suffix = ".manifest.json"
        for n in names:
            if n.startswith(base + "-") and n.endswith(suffix):
                num = n[len(base) + 1:-len(suffix)]
                if num.isdigit():
                    out.append(int(num))
        return sorted(out)

    def _read_manifest(self, epoch):
        with open(self.manifest_path(epoch), "rb") as f:
            return json.loads(f.read().decode())

    def has_manifest(self, epoch):
        return os.path.exists(self.manifest_path(epoch))

    def _read_verified(self, epoch):
        """Manifest + every payload in ONE read each, CRC-checked as
        read.  The recovery path (load) decodes from these buffers
        directly, so verification never doubles the disk I/O of a
        multi-GB resume."""
        man = self._read_manifest(epoch)
        blobs = {}
        for fname, meta in man["files"].items():
            fp = os.path.join(self._dir(), fname)
            with open(fp, "rb") as f:
                blob = f.read()
            if len(blob) != meta.get("bytes") \
                    or _crc(blob) != meta.get("crc32"):
                raise MXNetError(
                    f"checkpoint payload {fp!r} failed verification "
                    "(truncated or corrupt)")
            blobs[fname] = blob
        return man, blobs

    def verify(self, epoch):
        """True iff the manifest parses and every payload matches its
        recorded size and CRC32 — catches truncation, bit rot, and
        torn non-atomic writes from foreign tools."""
        return self.verify_detail(epoch) is None

    def verify_detail(self, epoch):
        """None when the version verifies, else a one-line problem
        NAMING the offending file — what ``tools/ckpt_fsck.py`` prints
        so an operator knows which artifact is torn, not just which
        version."""
        try:
            self._read_verified(epoch)
            return None
        except MXNetError as e:
            return str(e)
        except OSError as e:
            return (f"checkpoint manifest/payload unreadable: "
                    f"{getattr(e, 'filename', None) or e}")
        except (ValueError, KeyError) as e:
            return (f"checkpoint manifest {self.manifest_path(epoch)!r}"
                    f" malformed ({type(e).__name__}: {e})")

    def _latest_candidates(self):
        """Version numbers to try, newest-first: the ``latest``
        pointer's target, then every other on-disk version."""
        candidates = []
        try:
            with open(self.latest_path(), "rb") as f:
                candidates.append(int(json.loads(f.read())["epoch"]))
        except (OSError, ValueError, KeyError, TypeError):
            pass  # unreadable/corrupt pointer (non-numeric epoch
            #       included): fall back through on-disk versions
        for e in reversed(self.epochs()):
            if e not in candidates:
                candidates.append(e)
        return candidates

    def latest_epoch(self):
        """Newest version that VERIFIES, or None.

        The ``latest`` pointer is consulted first; a corrupt or
        missing candidate falls back through older versions (newest
        first) — the previous-good-version guarantee.
        """
        for e in self._latest_candidates():
            if self.verify(e):
                return e
        return None

    # ------------------------------------------------------------- load
    def load(self, epoch=None, ctx=None):
        """Load a verified checkpoint.

        ``epoch=None`` loads the newest version that verifies (falling
        back past corrupt ones); an explicit version number raises
        :class:`MXNetError` when that version fails verification —
        detection, not silent substitution, for a pinned request.

        Returns a dict with ``version`` (the file id), ``epoch`` (the
        training epoch from the manifest — diverges from the version
        after mid-epoch drains), ``step``, ``batch_cursor``,
        ``arg_params``, ``aux_params`` (NDArray dicts),
        ``optimizer_states`` (bytes or None), ``rng``, ``topology``
        (the world stamp, or None for pre-elastic files) and
        ``extra``.
        """
        from .. import ndarray as nd

        man, blobs = {}, {}
        t_load0 = time.perf_counter()
        if epoch is None:
            # newest-good fallback, ONE read per candidate: the blobs
            # that verified are the blobs that get decoded
            skipped = []
            for cand in self._latest_candidates():
                try:
                    man, blobs = self._read_verified(cand)
                    epoch = cand
                    break
                except (OSError, ValueError, KeyError, MXNetError):
                    skipped.append(int(cand))
                    continue
            if epoch is None:
                raise MXNetError(
                    f"no verifiable checkpoint under {self.prefix!r}")
            if skipped:
                # a recovery past rotten versions is not silent: a
                # checkpoint record names the skipped versions and the
                # ckpt_fallbacks counter reaches the textfile
                from .. import telemetry

                telemetry.count("ckpt_fallbacks")
                telemetry.checkpoint_event(
                    self.prefix, epoch, time.perf_counter() - t_load0,
                    sum(len(b) for b in blobs.values()),
                    reason="fallback", skipped_versions=skipped)
        else:
            epoch = int(epoch)
            if self.has_manifest(epoch):
                try:
                    man, blobs = self._read_verified(epoch)
                except MXNetError as e:
                    raise MXNetError(
                        f"checkpoint {self.params_path(epoch)!r} "
                        "failed verification (truncated or corrupt "
                        "payload); load(epoch=None) falls back to the "
                        "last good version") from e
            # manifest-less versions (pre-atomic-writer files) load
            # blind, the legacy behavior

        pname = os.path.basename(self.params_path(epoch))
        if pname in blobs:
            save_dict = nd.load_buffer(blobs[pname], ctx=ctx)
        else:
            save_dict = nd.load(self.params_path(epoch), ctx=ctx)
        arg_params, aux_params = _split_params(save_dict)
        sname = os.path.basename(self.states_path(epoch))
        states = blobs.get(sname)
        if states is None and os.path.exists(self.states_path(epoch)):
            with open(self.states_path(epoch), "rb") as f:
                states = f.read()
        return {
            "version": int(epoch),
            "epoch": int(man.get("epoch", epoch)),
            "step": man.get("step"),
            "batch_cursor": int(man.get("batch_cursor", 0)),
            "arg_params": arg_params,
            "aux_params": aux_params,
            "optimizer_states": states,
            "rng": man.get("rng"),
            "autotune_sha256": man.get("autotune_sha256"),
            "topology": man.get("topology"),
            "extra": man.get("extra", {}),
        }

    def load_params_dict(self, version, ctx=None):
        """One version's ``.params`` dict in a SINGLE read: with a
        manifest the payload is CRC-verified and decoded from the same
        buffer (raises on mismatch — detection for a pinned version);
        manifest-less files load blind, the legacy behavior."""
        from .. import ndarray as nd

        version = int(version)
        if self.has_manifest(version):
            try:
                _, blobs = self._read_verified(version)
            except (OSError, ValueError, KeyError, MXNetError) as e:
                raise MXNetError(
                    f"checkpoint {self.params_path(version)!r} failed "
                    "verification (truncated or corrupt payload); "
                    "CheckpointManager.load() falls back to the last "
                    "good version") from e
            pname = os.path.basename(self.params_path(version))
            if pname in blobs:
                return nd.load_buffer(blobs[pname], ctx=ctx)
        return nd.load(self.params_path(version), ctx=ctx)


class _AsyncWriter:
    """The snapshot-checkpoint background writer: one daemon thread
    draining a BOUNDED queue of captured snapshots.

    The bound is the back-pressure contract: a disk slower than the
    snapshot cadence blocks the producer (the training loop's
    ``save_async``) on ``queue.put`` instead of accumulating host
    copies without limit.  The ``ckpt.async`` fault point fires
    mid-payload inside every write this thread performs — an armed
    ``crash`` is the power-loss-during-async-write drill.  The thread
    writes host bytes only: every capture it receives was copied off
    the device before ``save_async`` returned.
    """

    def __init__(self, mgr, depth=2):
        self.mgr = mgr
        self._q = queue.Queue(maxsize=max(1, int(depth)))
        self._cv = threading.Condition()
        self._submitted = 0
        self._completed = 0
        self._stop = False
        self._errors = []
        self._thread = threading.Thread(
            target=self._run, name="mxnet_tpu_torch-ckpt-async",
            daemon=True)
        self._thread.start()

    def submit(self, cap):
        with self._cv:
            self._submitted += 1
        self._q.put(cap)  # blocks when the disk is behind: backpressure

    def _run(self):
        while True:
            cap = self._q.get()
            if cap is None:
                return
            try:
                faultsim.inject("ckpt.async")
                man = self.mgr._write_version(
                    cap, inject_point="ckpt.async",
                    telemetry_extra={"async": True},
                    skip_if_written=True)
                if man is not None:
                    from .. import telemetry

                    telemetry.count("ckpt_async_writes")
            except Exception as e:  # a broken disk must not kill the
                # writer thread, nor be silent: every failed snapshot is
                # logged, counted and recorded
                self._errors.append(e)
                import logging

                logging.getLogger("mxnet_tpu_torch").warning(
                    "async snapshot write failed (version %s): %r",
                    cap.get("version"), e)
                try:
                    from .. import telemetry

                    telemetry.count("ckpt_async_errors")
                    telemetry.event("ckpt_async_error",
                                    version=cap.get("version"),
                                    error=repr(e))
                except Exception:
                    pass
            finally:
                with self._cv:
                    self._completed += 1
                    self._cv.notify_all()

    def drain(self, timeout=None):
        """True once every snapshot submitted so far is written (or
        failed into ``errors``)."""
        with self._cv:
            return self._cv.wait_for(
                lambda: self._completed >= self._submitted,
                timeout=timeout)

    def close(self, timeout=None):
        timeout = 10.0 if timeout is None else float(timeout)
        if not self._stop:
            self._stop = True
            try:
                # the sentinel must not block forever: with the writer
                # wedged on a bad disk the bounded queue stays full, and
                # close() abandons the daemon thread instead of joining
                # the hang
                self._q.put(None, timeout=timeout)
            except queue.Full:
                pass
        self._thread.join(timeout=timeout)
        return not self._thread.is_alive()

    @property
    def errors(self):
        return list(self._errors)
