"""dist_async for the port's store, as ``tests/dist_async_worker.py``;
a worker script, run under the port's launcher with 3 workers:

    python -m mxnet_tpu_torch.tools.launch -n 3 --cpu \\
        python tests/torch_dist_async_worker.py

Pushes apply on arrival: worker 2 is made slow, and workers 0 and 1
finish their rounds in a fraction of its delay; the final value is the
closed form ``n * ROUNDS``; the slow worker, which stopped its
heartbeat, shows in ``num_dead_node``.  ``SLOW_SLEEP`` (seconds) may be
set in the environment.
"""
import os
import sys
import time

import numpy as onp

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import mxnet_tpu_torch as mx  # noqa: E402

SLOW_RANK = 2
SLOW_SLEEP = float(os.environ.get("SLOW_SLEEP", "6.0"))
ROUNDS = 5
SHAPE = (32, 16)


def main():
    kv = mx.kv.create("dist_async")
    n, r = kv.num_workers, kv.rank
    assert n == int(os.environ.get("DMLC_NUM_WORKER", "3")), n
    assert kv.type == "dist_async"
    kv.init("w", mx.nd.zeros(SHAPE))
    slow = r == SLOW_RANK % n and n > 2
    if slow:
        # stop beating first, so the probe sees a stale beat
        kv._ps_backend().stop_heartbeat()
        time.sleep(SLOW_SLEEP)
    t0 = time.time()
    for _ in range(ROUNDS):
        kv.push("w", mx.nd.ones(SHAPE))
        out = mx.nd.zeros(SHAPE)
        kv.pull("w", out=out)
    elapsed = time.time() - t0
    # this worker's own pushes are in what it pulled last
    assert float(out.asnumpy()[0, 0]) >= ROUNDS - 1e-6
    if n > 2 and not slow:
        assert elapsed < SLOW_SLEEP / 2, (
            f"fast worker {r} took {elapsed:.1f}s: async must not wait "
            f"for the {SLOW_SLEEP}s-slow worker")
        time.sleep(SLOW_SLEEP / 2)
        dead = kv.num_dead_node(timeout_sec=SLOW_SLEEP / 3)
        assert dead >= 1, dead
    kv.barrier()
    out = mx.nd.zeros(SHAPE)
    kv.pull("w", out=out)
    onp.testing.assert_allclose(out.asnumpy(),
                                onp.full(SHAPE, float(n * ROUNDS)),
                                err_msg="async accumulate total")
    assert kv.num_dead_node(timeout_sec=30.0) <= 1
    print(f"[worker {r}] dist_async OK ({elapsed:.1f}s, {n} workers, "
          f"shard {kv.shard})", flush=True)


if __name__ == "__main__":
    main()
