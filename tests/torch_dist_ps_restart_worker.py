"""The parameter server's recovery drill, as
``tests/dist_ps_restart_worker.py``; a worker script, run under the
port's launcher with 3 workers and ``MXNET_PS_NATIVE=0`` (the Python
shard can be stopped and started again in the process, as the launcher
would relaunch a worker whose shard comes back empty on a new port):

- rank 1 stops its shard, starts a fresh one and registers it under
  address epoch 1;
- the peers' next request to shard 1 fails, re-resolves the epoch-1
  address, meets 'uninitialized key', refills from the last value
  pulled and retries: the stored value goes on from there;
- rank 0 then stops its shard and its heartbeat for good: the liveness
  probe, asked of the shards in order, fails over to shard 1.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import mxnet_tpu_torch as mx  # noqa: E402
from mxnet_tpu_torch import _ps  # noqa: E402


def restart_shard(ps):
    """A fresh Python shard on a new port under the next address
    epoch (what a relaunched worker's shard does)."""
    ps.server.stop()
    new = _ps._ServerShard(ps.rank, ps.size)
    new.start()
    new.updaters = ps._updaters
    ps.server = new
    ps._port = new.port
    store = ps._rendezvous()
    epoch = store.add(f"mxps/epoch/{ps.rank}", 1) - 1
    mine = ps._my_addr()
    store.set(f"mxps/addr/{ps.rank}/e{epoch}", mine)
    ps._addr_epoch[ps.rank] = epoch
    ps._addrs[ps.rank] = mine
    # this process's own connection to the old shard is stale
    ps._drop_conn(ps.rank)


def main():
    assert os.environ.get("MXNET_PS_NATIVE") == "0", \
        "the drill stops and starts the Python shard"
    kv = mx.kv.create("dist_async")
    n, r = kv.num_workers, kv.rank
    assert n >= 3
    ps = kv._ps_backend()
    key = next(f"w{i}" for i in range(64)
               if ps.owner(kv._ps_key(f"w{i}")) == 1)
    kv.init(key, mx.nd.zeros((16,)))
    kv.barrier()
    kv.push(key, mx.nd.ones((16,)))
    kv.barrier()
    out = mx.nd.zeros((16,))
    kv.pull(key, out=out)
    assert out.asnumpy()[0] == float(n), out.asnumpy()[0]
    kv.barrier()

    if r == 1:
        restart_shard(ps)
    kv.barrier()  # the peers go on once the new shard listens
    # a real worker's death resets its sockets; here the peers drop
    # their cached connection so that the next request re-dials
    ps._drop_conn(1)
    kv.push(key, mx.nd.ones((16,)))
    kv.barrier()
    out2 = mx.nd.zeros((16,))
    kv.pull(key, out=out2)
    got = float(out2.asnumpy()[0])
    # the refill restores n, then n more pushes land (a retried push may
    # apply twice: at-least-once delivery)
    assert 2 * n <= got <= 2 * n + 2, got
    assert ps._addr_epoch[1] == 1, ps._addr_epoch
    kv.barrier()

    if r == 0:
        ps.server.stop()
        ps.stop_heartbeat()
    kv.barrier()
    time.sleep(2.5)
    if r != 0:
        assert kv.num_dead_node(timeout_sec=2.0) >= 1
    kv.barrier()
    print(f"[worker {r}] ps_restart drill OK ({n} workers)", flush=True)


if __name__ == "__main__":
    main()
