"""Sharded TCP parameter server of the distributed store (counterpart of
``mxnet_tpu/_ps.py``).

Every worker process runs one server shard, which owns the keys with
``crc32(key) % size == rank`` (ps-lite's key-to-server sharding), so a
worker's wire traffic is O(N) a push or pull.  Two modes, as the
reference server:

* sync: a round merges all W workers' pushes, then updates once; a
  pull waits until every round its worker pushed is merged;
* async: each push applies on arrival; no worker waits for a peer.

Every worker heartbeats every shard; ``dead_nodes(timeout)`` lists the
workers whose last beat is older (``get_num_dead_node``).

The shard is native C++ (``src/ps_server_native.cc``, built with g++ on
first use into ``_build/``, speaking a little-endian binary protocol)
unless the build fails or ``MXNET_PS_NATIVE=0``; then a Python shard
speaking length-prefixed pickle serves.  Each shard advertises its
protocol in its address (``n:host:port`` / ``p:host:port``), so a
client picks the codec per server.  Addresses are exchanged through the
job's rendezvous store (``kvstore.rendezvous_store``: a
``torch.distributed.TCPStore`` at ``DMLC_PS_ROOT_URI:DMLC_PS_ROOT_PORT``),
under an epoch a restarted worker increments.  Values are CPU tensors
in their pushed dtype; an optimizer set on the store runs on the
worker's device through the updater callback.  Client requests retry
with bounded backoff (``resilience.retry``), then wait for a restarted
shard's next address epoch.  Row-sparse pushes and pulls wait for the
sparse storage (ROADMAP §A 3).
"""
from __future__ import annotations

import ctypes
import datetime
import json
import pickle
import socket
import struct
import threading
import time
import zlib

import numpy as onp
import torch

from .base import MXNetError
from .config import get_env
from .resilience import faultsim
from .resilience.retry import retry_call

__all__ = ["PSBackend", "native_lib_path"]

_LEN = struct.Struct("!Q")

faultsim.register_point("ps.push", "PS client, inside every push attempt")
faultsim.register_point("ps.pull", "PS client, inside every pull attempt")


def _deadline_sec():
    return float(get_env("MXNET_PS_DEADLINE_SEC"))


def _send_msg(sock, obj):
    data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(_LEN.pack(len(data)) + data)


def _recv_exact(sock, n):
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf += chunk
    return bytes(buf)


def _recv_msg(sock):
    (n,) = _LEN.unpack(_recv_exact(sock, _LEN.size))
    return pickle.loads(_recv_exact(sock, n))


def _decompress_2bit(payload, shape, threshold):
    """Unpack the 2-bit wire payload on the server: code 1 -> +t,
    2 -> -t, 0 -> 0 (float32)."""
    p = onp.frombuffer(bytes(payload), dtype=onp.uint8)
    codes = onp.stack([p & 3, (p >> 2) & 3, (p >> 4) & 3, (p >> 6) & 3],
                      axis=-1).reshape(-1)
    n = 1
    for d in shape:
        n *= d
    codes = codes[:n].reshape(shape)
    out = onp.zeros(shape, onp.float32)
    out[codes == 1] = threshold
    out[codes == 2] = -threshold
    return torch.from_numpy(out)


_HALF = (torch.float16, torch.bfloat16)


class _ServerShard(threading.Thread):
    """One process's Python server: owns keys with owner(key) == rank."""

    def __init__(self, rank, size):
        super().__init__(daemon=True, name=f"ps-server-{rank}")
        self.rank = rank
        self.size = size
        self.values = {}           # key -> CPU tensor, its pushed dtype
        self.pending = {}          # key -> merge accumulator (sync)
        self.pending_count = {}
        # a pull by worker s waits until every round s pushed is merged
        self.completed_rounds = {}   # key -> merged rounds
        self.pushed_rounds = {}      # (key, sender) -> pushes by sender
        # keys are namespaced per store ("s0/weight"); each namespace
        # may carry its own optimizer rule
        self.updaters = {}         # namespace -> updater callable
        self.last_hb = {}          # worker rank -> monotonic time
        self.profiling = False
        self.stats = {"push": 0, "pull": 0, "bytes_in": 0, "bytes_out": 0}
        self.commands = []
        self._live_conns = set()
        self._cv = threading.Condition()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(("0.0.0.0", 0))
        self._sock.listen(64)
        self.port = self._sock.getsockname()[1]
        self._stop = False

    def run(self):
        while not self._stop:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            with self._cv:
                self._live_conns.add(conn)
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _serve(self, conn):
        try:
            while True:
                msg = _recv_msg(conn)
                try:
                    resp = self._handle(msg)
                except Exception as exc:  # the client sees the error
                    resp = ("err", repr(exc))
                _send_msg(conn, resp)
        except (ConnectionError, EOFError, OSError):
            conn.close()
        finally:
            with self._cv:
                self._live_conns.discard(conn)

    def _prof(self, op, bytes_in=0, bytes_out=0):
        """Profiling counters; the caller holds the lock."""
        if self.profiling:
            self.stats[op] += 1
            self.stats["bytes_in"] += int(bytes_in)
            self.stats["bytes_out"] += int(bytes_out)

    def _updater_for(self, key):
        ns = key.split("/", 1)[0] if "/" in key else ""
        return self.updaters.get(ns)

    def _apply(self, key, grad):
        """The stored value after one update with ``grad``."""
        bare = key.split("/", 1)[1] if "/" in key else key
        return self._updater_for(key)(bare, grad, self.values[key])

    def _merge_round(self, key, stored_dt):
        merged = self.pending.pop(key)
        if merged.dtype != stored_dt:
            # one rounding of the fp32-accumulated round sum
            merged = merged.to(stored_dt)
        self.pending_count[key] = 0
        self.completed_rounds[key] = self.completed_rounds.get(key, 0) + 1
        if self._updater_for(key) is None:
            self.values[key] = merged
        else:
            self.values[key] = self._apply(key, merged)

    def _push(self, key, grad, mode, sender):
        with self._cv:
            if key not in self.values:
                raise MXNetError(f"push to uninitialized key {key}")
            stored_dt = self.values[key].dtype
            if mode != "async" and stored_dt in _HALF:
                # a sync round merges half-precision keys in fp32
                grad = grad.to(torch.float32)
            elif grad.dtype != stored_dt:
                grad = grad.to(stored_dt)
            self._prof("push", bytes_in=grad.numel() * grad.element_size())
            if mode == "async":
                if self._updater_for(key) is None:
                    self.values[key] = self.values[key] + grad
                else:
                    self.values[key] = self._apply(key, grad)
            else:
                # a worker a full round ahead waits for the merge, so two
                # of its pushes never fold into one round
                prev = self.pushed_rounds.get((key, sender), 0)
                skew_deadline = time.monotonic() + _deadline_sec()
                while prev > self.completed_rounds.get(key, 0):
                    left = skew_deadline - time.monotonic()
                    if left <= 0:
                        raise MXNetError(
                            f"sync push round skew on {key}: worker "
                            f"{sender} is a full round ahead and the "
                            "merge never completed")
                    self._cv.wait(timeout=min(left, 1.0))
                self.pushed_rounds[(key, sender)] = prev + 1
                acc = self.pending.get(key)
                self.pending[key] = grad if acc is None else acc + grad
                cnt = self.pending_count.get(key, 0) + 1
                if cnt == self.size:
                    self._merge_round(key, stored_dt)
                else:
                    self.pending_count[key] = cnt
            self._cv.notify_all()

    def _handle(self, msg):
        op = msg[0]
        if op == "init":
            _, key, value, sender, *rest = msg
            refill = bool(rest[0]) if rest else False
            with self._cv:
                # rank 0's init wins; a refill (shard-restart recovery)
                # only fills an absent key
                if (sender == 0 and not refill) or key not in self.values:
                    self.values[key] = value
                self._cv.notify_all()
            return ("ok",)
        if op == "push":
            _, key, payload, mode, meta = msg
            grad = _decompress_2bit(payload, meta["shape"],
                                    meta["threshold"]) \
                if meta.get("compressed") else payload
            self._push(key, grad, mode, meta.get("sender", -1))
            return ("ok",)
        if op == "pull":
            _, key, sender = msg
            deadline = time.monotonic() + _deadline_sec()
            with self._cv:
                def ready():
                    if key not in self.values:
                        return False
                    need = self.pushed_rounds.get((key, sender), 0)
                    return self.completed_rounds.get(key, 0) >= need
                while not ready():
                    left = deadline - time.monotonic()
                    if left <= 0:
                        raise MXNetError(f"pull timeout on key {key}")
                    self._cv.wait(timeout=min(left, 1.0))
                v = self.values[key]
                self._prof("pull", bytes_out=v.numel() * v.element_size())
                return ("val", v)
        if op == "hb":
            _, sender = msg
            with self._cv:
                self.last_hb[sender] = time.monotonic()
            return ("ok",)
        if op == "cmd":
            # SendCommandToServers; head 0 is the server profiler
            _, head, body = msg
            with self._cv:
                self.commands.append((int(head), str(body)))
                if int(head) == 0:
                    parts = str(body).split(":", 2)
                    if parts[0] == "profile":
                        if parts[1] == "start":
                            self.profiling = True
                            for k in self.stats:
                                self.stats[k] = 0
                        elif parts[1] == "stop":
                            self.profiling = False
                        elif parts[1] == "dump" and len(parts) == 3:
                            with open(f"{parts[2]}.r{self.rank}", "w") as f:
                                json.dump({"rank": self.rank,
                                           "profiling": self.profiling,
                                           **self.stats}, f)
            return ("ok",)
        if op == "dead":
            _, timeout_s = msg
            now = time.monotonic()
            with self._cv:
                dead = [r for r in range(self.size)
                        if now - self.last_hb.get(r, -1e18) > timeout_s]
            return ("dead", dead)
        raise MXNetError(f"unknown ps op {op!r}")

    def stop(self):
        """Close the listener and every live connection: a stopped shard
        goes silent, so peers fail over to its restarted incarnation."""
        self._stop = True
        # shutdown before close: it wakes the thread blocked in accept()
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()
        with self._cv:
            conns = list(self._live_conns)
            self._live_conns.clear()
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass


# ------------------------------------------------- native shard loader
_native_lock = threading.Lock()
_native_lib = None
_native_tried = False

#: ctypes signature of the optimizer callback the native server calls
_UPDATER_CB = ctypes.CFUNCTYPE(
    ctypes.c_int, ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
    ctypes.POINTER(ctypes.c_float), ctypes.c_uint64)


def native_lib_path():
    """Build ``src/ps_server_native.cc`` with g++ (if not built) and
    return the library's path; raises where the build fails."""
    import os

    from ._native import build_native

    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src", "ps_server_native.cc")
    return build_native(src, "libps_server_native.so",
                        ldflags=("-lpthread",), opt="-O2")


def _get_native_lib():
    """The loaded native shard; None where the build fails or
    ``MXNET_PS_NATIVE=0``."""
    global _native_lib, _native_tried
    if int(get_env("MXNET_PS_NATIVE")) == 0:
        return None
    with _native_lock:
        if _native_tried:
            return _native_lib
        _native_tried = True
        try:
            lib = ctypes.CDLL(native_lib_path())
            lib.ps_native_start.restype = ctypes.c_int
            lib.ps_native_start.argtypes = [ctypes.c_int, ctypes.c_int]
            lib.ps_native_set_updater.restype = None
            lib.ps_native_set_updater.argtypes = [_UPDATER_CB]
            _native_lib = lib
        except Exception:  # noqa: BLE001 - the Python shard serves
            _native_lib = None
        return _native_lib


# --------------------------------------------- native binary encoding
#: wire dtype codes (ps_server_native.cc)
_DT_CODES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2,
             torch.float16: 3, torch.int32: 4, torch.int64: 5,
             torch.int8: 6, torch.uint8: 7}
_CODE_DT = {c: d for d, c in _DT_CODES.items()}


def _wire_tensor(a):
    """A contiguous flat CPU tensor in a wire dtype (others widen to
    float32)."""
    a = a.detach().to("cpu").reshape(-1).contiguous()
    if a.dtype not in _DT_CODES:
        a = a.to(torch.float32)
    return a


def _tensor_bytes(a):
    return a.view(torch.uint8).numpy().tobytes() if a.numel() else b""


def _n_encode(msg):
    op_map = {"init": 0, "push": 1, "pull": 2, "hb": 3, "dead": 4,
              "cmd": 7}
    op = msg[0]
    key = msg[1] if op in ("init", "push", "pull") else ""
    kb = key.encode()
    head = struct.pack("<BI", op_map[op], len(kb)) + kb
    if op == "init":
        _, _, value, sender, *rest = msg
        refill = bool(rest[0]) if rest else False
        v = _wire_tensor(value)
        body = struct.pack("<iBBQ", sender, 1 if refill else 0,
                           _DT_CODES[v.dtype], v.numel()) + _tensor_bytes(v)
    elif op == "push":
        _, _, payload, mode, meta = msg
        if meta.get("compressed"):
            n = 1
            for d in meta["shape"]:
                n *= d
            body = struct.pack(
                "<iBBBfQ", meta["sender"], 0 if mode == "sync" else 1,
                1, 0, float(meta["threshold"]), n) + bytes(payload)
        else:
            v = _wire_tensor(payload)
            body = struct.pack(
                "<iBBBfQ", meta["sender"], 0 if mode == "sync" else 1,
                0, _DT_CODES[v.dtype], 0.0, v.numel()) + _tensor_bytes(v)
    elif op in ("pull", "hb"):
        body = struct.pack("<i", msg[2] if op == "pull" else msg[1])
    elif op == "cmd":
        _, cmd_head, cbody = msg
        cb = str(cbody).encode()
        body = struct.pack("<iI", int(cmd_head), len(cb)) + cb
    else:  # dead
        body = struct.pack("<d", float(msg[1]))
    frame = head + body
    return struct.pack("<Q", len(frame)) + frame


def _n_roundtrip(sock, msg):
    sock.sendall(_n_encode(msg))
    (ln,) = struct.unpack("<Q", _recv_exact(sock, 8))
    data = _recv_exact(sock, ln)
    status = data[0]
    if status == 0:
        return None
    if status == 1:
        raise MXNetError(f"ps server error: {data[1:].decode()}")
    if status == 2:
        dt = _CODE_DT[data[1]]
        (n,) = struct.unpack_from("<Q", data, 2)
        nbytes = n * torch.empty((), dtype=dt).element_size()
        return torch.frombuffer(bytearray(data[10:10 + nbytes]),
                                dtype=dt) if n else torch.empty(0, dtype=dt)
    if status == 3:
        (m,) = struct.unpack_from("<I", data, 1)
        return list(struct.unpack_from(f"<{m}i", data, 5))
    raise MXNetError(f"ps: bad response status {status}")


class PSBackend:
    """Worker-side client and in-process server shard (one a process).

    The shard is native when it builds (protocol ``n``), else the Python
    one (``p``); :attr:`shard` says which serves here."""

    _singleton = None

    @classmethod
    def get(cls, rank, size, store=None):
        if cls._singleton is None:
            cls._singleton = cls(rank, size, store)
        return cls._singleton

    def __init__(self, rank, size, store=None):
        self.rank = rank
        self.size = size
        self._store = store
        self._updaters = {}
        self._shapes = {}  # key -> value shape (native shards store flat)
        self._native_cb = None  # keeps the ctypes callback alive
        lib = _get_native_lib()
        port = lib.ps_native_start(rank, size) if lib is not None else -1
        if port > 0:
            self._lib = lib
            self.server = None
            self._proto = "n"
            self._port = port
        else:
            self._lib = None
            self.server = _ServerShard(rank, size)
            self.server.start()
            self.server.updaters = self._updaters
            self._proto = "p"
            self._port = self.server.port
        self._addrs = self._exchange_addrs()
        self._conns = {}
        self._conn_locks = {}
        self._conn_create = threading.Lock()
        self._hb_stop = threading.Event()
        self._hb = threading.Thread(target=self._heartbeat_loop,
                                    daemon=True, name="ps-heartbeat")
        self._hb.start()

    @property
    def shard(self):
        """Which shard serves in this process: ``native`` or
        ``python``."""
        return "native" if self._proto == "n" else "python"

    # ----------------------------------------------------- bootstrap
    def _rendezvous(self):
        if self._store is None:
            raise MXNetError(
                "the parameter server needs the job's rendezvous store "
                "for its address exchange (launch with "
                "mxnet_tpu_torch/tools/launch.py)")
        return self._store

    def _my_addr(self):
        try:
            my_ip = socket.gethostbyname(socket.gethostname())
        except OSError:
            my_ip = "127.0.0.1"
        return f"{self._proto}:{my_ip}:{self._port}"

    def _exchange_addrs(self):
        """Epoch-keyed exchange: a restarted worker (``launch.py
        --max-restarts``) registers under the next epoch, and peers
        re-resolve on a connection failure (:meth:`_refresh_addr`)."""
        mine = self._my_addr()
        self._addr_epoch = {r: 0 for r in range(self.size)}
        if self.size == 1:
            return {0: mine}
        store = self._rendezvous()
        epoch = store.add(f"mxps/epoch/{self.rank}", 1) - 1
        store.set(f"mxps/addr/{self.rank}/e{epoch}", mine)
        self._addr_epoch[self.rank] = epoch
        addrs = {}
        for r in range(self.size):
            addrs[r] = self._wait_key(f"mxps/addr/{r}/e0", 60)
        addrs[self.rank] = mine
        return addrs

    def _wait_key(self, key, seconds):
        store = self._rendezvous()
        store.wait([key], datetime.timedelta(seconds=seconds))
        return store.get(key).decode()

    def _refresh_addr(self, r):
        """A peer's shard stopped answering: wait (up to 120 s, the
        launcher's relaunch window) for its restarted incarnation's
        address under the next epoch."""
        if self.size == 1:
            return
        e = self._addr_epoch.get(r, 0) + 1
        self._addrs[r] = self._wait_key(f"mxps/addr/{r}/e{e}", 120)
        self._addr_epoch[r] = e

    def _addr_of(self, r):
        proto, host, port = self._addrs[r].split(":", 2)
        return proto, host, int(port)

    @staticmethod
    def _dial(host, port, timeout):
        """``create_connection`` that refuses a TCP self-connect (a
        closed localhost port can connect a socket to itself)."""
        s = socket.create_connection((host, port), timeout=timeout)
        try:
            if s.getsockname() == s.getpeername():
                raise ConnectionError(
                    f"self-connect to {host}:{port} (no listener)")
        except OSError:
            s.close()
            raise
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return s

    def _conn(self, r):
        # the heartbeat and worker threads race to open a connection
        with self._conn_create:
            if r not in self._conns:
                _, host, port = self._addr_of(r)
                self._conns[r] = self._dial(host, port, timeout=600)
                self._conn_locks[r] = threading.Lock()
        return self._conns[r], self._conn_locks[r]

    def _do_request(self, r, msg):
        proto = self._addr_of(r)[0]
        sock, lock = self._conn(r)
        with lock:
            if proto == "n":
                return _n_roundtrip(sock, msg)
            _send_msg(sock, msg)
            resp = _recv_msg(sock)
        if resp[0] in ("val", "dead"):
            return resp[1]
        if resp[0] == "err":
            raise MXNetError(f"ps server error: {resp[1]}")
        if resp[0] != "ok":
            # a garbage frame: a dead transport, so retries engage
            raise ConnectionError(f"ps: malformed response {resp[:1]}")
        return None

    _FAULT_POINTS = {"push": "ps.push", "pull": "ps.pull"}

    def _request(self, r, msg):
        point = self._FAULT_POINTS.get(msg[0])

        def once():
            if point is not None:
                faultsim.inject(point)
            return self._do_request(r, msg)

        def on_retry(attempt, exc):
            from . import telemetry

            telemetry.count("ps_retries")
            telemetry.event("ps_retry", op=msg[0], rank=r, attempt=attempt,
                            error=type(exc).__name__)
            if not isinstance(exc, faultsim.FaultInjected):
                self._drop_conn(r)

        try:
            # at-least-once delivery: an applied but unacknowledged push
            # may repeat, as ps-lite's resend may
            return retry_call(
                once, retry_on=(ConnectionError, EOFError, OSError,
                                faultsim.FaultInjected),
                attempts=3, base_delay=0.05, max_delay=1.0,
                deadline_sec=_deadline_sec(), on_retry=on_retry)
        except faultsim.FaultInjected:
            raise
        except (ConnectionError, EOFError, OSError):
            # still dead: wait for a restarted incarnation's address
            self._drop_conn(r)
            self._refresh_addr(r)
            return self._do_request(r, msg)

    def owner(self, key):
        # stable across processes (not Python's hash)
        return zlib.crc32(str(key).encode()) % self.size

    # ----------------------------------------------------- operations
    def init(self, key, value, refill=False):
        v = value.detach().to("cpu").contiguous()
        self._shapes[key] = tuple(v.shape)
        self._request(self.owner(key), ("init", key, v, self.rank, refill))

    def push(self, key, grad, mode, compressed_payload=None, meta=None):
        if compressed_payload is not None:
            payload = bytes(compressed_payload)
            meta = dict(meta or {})
            meta["compressed"] = True
        else:
            payload = grad.detach().to("cpu").contiguous()
            meta = {"compressed": False}
        meta["sender"] = self.rank
        self._request(self.owner(key), ("push", key, payload, mode, meta))

    def pull(self, key):
        """The stored value: a CPU tensor (flat from the native
        shard)."""
        return self._request(self.owner(key), ("pull", key, self.rank))

    def set_updater(self, namespace, updater):
        """Install ``updater(bare_key, grad, value) -> new value`` (CPU
        tensors) for ``namespace`` on this process's shard; every worker
        runs the same program, so every shard gets the same rule."""
        self._updaters[namespace] = updater
        if self._lib is not None and self._native_cb is None:
            self._native_cb = _UPDATER_CB(self._native_updater)
            self._lib.ps_native_set_updater(self._native_cb)

    def _native_updater(self, key_c, grad_p, value_p, n):
        """The native shard's callback: 0 applied, 1 no rule for the
        key's namespace (the server merges by default), -1 the rule
        raised (the pushing client sees the error)."""
        try:
            key = key_c.decode()
            ns, _, bare = key.partition("/")
            updater = self._updaters.get(ns)
            if updater is None:
                return 1
            shape = self._shapes.get(key, (n,))
            grad = torch.from_numpy(onp.ctypeslib.as_array(
                grad_p, shape=(n,)).copy()).reshape(shape)
            value = onp.ctypeslib.as_array(value_p, shape=(n,))
            new = updater(bare or key, grad, torch.from_numpy(
                value.copy()).reshape(shape))
            value[:] = new.to(torch.float32).reshape(-1).numpy()
            return 0
        except Exception:  # noqa: BLE001 - reported to the client
            import traceback

            traceback.print_exc()
            return -1

    def command(self, head, body):
        """Send ``(head, body)`` to every shard (SendCommandToServers);
        head 0 drives the server profiler: ``profile:start``,
        ``profile:stop``, ``profile:dump:<path>``."""
        for r in range(self.size):
            self._request(r, ("cmd", int(head), str(body)))

    def num_dead_node(self, timeout_s=60.0):
        return len(self.dead_nodes(timeout_s))

    def dead_nodes(self, timeout_s=60.0):
        """Workers whose heartbeat is older than ``timeout_s``, asked of
        the shards in rank order (the first that answers: heartbeats go
        to every shard, so the probe survives a dead shard)."""
        last_err = None
        for r in range(self.size):
            try:
                return self._do_request(r, ("dead", float(timeout_s)))
            except Exception as e:  # noqa: BLE001 - ask the next shard
                last_err = e
                self._drop_conn(r)
        raise MXNetError(f"liveness probe failed on every shard: "
                         f"{last_err!r}")

    def _drop_conn(self, r):
        with self._conn_create:
            conn = self._conns.pop(r, None)
            self._conn_locks.pop(r, None)
        if conn is not None:
            try:
                conn.close()
            except OSError:
                pass

    def _heartbeat_loop(self):
        # connections of its own (a blocking sync pull holds the shared
        # one), to every shard
        interval = float(get_env("MXNET_PS_HEARTBEAT_SEC"))
        conns = {}
        while not self._hb_stop.is_set():
            for r in range(self.size):
                try:
                    if r not in conns:
                        proto, host, port = self._addr_of(r)
                        conns[r] = (proto, self._dial(host, port,
                                                      timeout=2))
                    proto, c = conns[r]
                    if proto == "n":
                        _n_roundtrip(c, ("hb", self.rank))
                    else:
                        _send_msg(c, ("hb", self.rank))
                        _recv_msg(c)
                except Exception:  # noqa: BLE001 - redial next beat
                    pc = conns.pop(r, None)
                    if pc is not None:
                        try:
                            pc[1].close()
                        except OSError:
                            pass
            self._hb_stop.wait(interval)

    def stop_heartbeat(self):
        """Stop beating: the liveness probe reports this worker dead
        once its timeout passes."""
        self._hb_stop.set()
