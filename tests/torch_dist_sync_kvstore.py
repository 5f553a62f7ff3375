"""The closed-form dist_sync invariants of ``tests/dist_sync_kvstore.py``
for the port's store; a worker script, run under the port's launcher:

    python -m mxnet_tpu_torch.tools.launch -n 3 --cpu \\
        python tests/torch_dist_sync_kvstore.py

Every worker pushes a known per-rank value and must pull exactly the
sum over workers (several shapes and dtypes, repeated rounds, with and
without an updater); the parameter server keeps the pushed dtype; the
2-bit wire is 16x smaller than fp32 with an error-feedback residual;
the server profiler counts every worker's push.  It runs on the default
context: the card, unless the launcher was given ``--cpu``.
"""
import json
import os
import sys
import tempfile

import numpy as onp
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import mxnet_tpu_torch as mx  # noqa: E402
from mxnet_tpu_torch import kvstore as kvs  # noqa: E402


def main():
    kv = mx.kv.create("dist_sync")
    n, r = kv.num_workers, kv.rank
    assert n == int(os.environ.get("DMLC_NUM_WORKER", "1")), n
    assert 0 <= r < n and kv.backend == "gloo"
    dev = mx.current_context()

    shapes = {"3": (3, 3), "big": (128, 96), "vec": (7,)}
    # init: rank 0's value everywhere
    for k, shape in shapes.items():
        kv.init(k, mx.nd.full(shape, float(r + 1)))
    kv.barrier()
    out = mx.nd.zeros(shapes["3"])
    kv.pull("3", out=out)
    onp.testing.assert_allclose(out.asnumpy(), onp.ones(shapes["3"]))
    assert out.context == dev

    total = n * (n + 1) / 2
    for rnd in range(3):
        for k, shape in shapes.items():
            kv.push(k, mx.nd.full(shape, float(r + 1)))
        kv.barrier()
        for k, shape in shapes.items():
            out = mx.nd.zeros(shape)
            kv.pull(k, out=out)
            onp.testing.assert_allclose(out.asnumpy(),
                                        onp.full(shape, total),
                                        err_msg=f"round {rnd} key {k}")
        kv.barrier()

    kv.init("pp", mx.nd.zeros((4, 4)))
    out = mx.nd.zeros((4, 4))
    kv.pushpull("pp", mx.nd.full((4, 4), float(r + 1)), out=out)
    onp.testing.assert_allclose(out.asnumpy(), onp.full((4, 4), total))

    # the parameter server keeps the pushed dtype: f64's tail, exact
    # int32, bf16 at 2 bytes an element
    kva = kvs.create("dist_async")
    ps = kva._ps_backend()
    kva.barrier()
    f64v = torch.full((6,), 1.0 + 1e-12, dtype=torch.float64)
    ps.init("dt/f64", torch.zeros(6, dtype=torch.float64))
    kva.barrier()
    ps.push("dt/f64", f64v, "async")
    kva.barrier()
    got64 = ps.pull("dt/f64")
    assert got64.dtype == torch.float64, got64.dtype
    onp.testing.assert_allclose(got64.numpy(), n * f64v.numpy(), rtol=0,
                                atol=1e-12)
    assert abs(float(got64[0]) - n) > 1e-13, "f64 tail lost on the wire"
    iv = torch.tensor([2 ** 20, 1, -7, 0, 3], dtype=torch.int32)
    ps.init("dt/i32", torch.zeros(5, dtype=torch.int32))
    kva.barrier()
    ps.push("dt/i32", iv, "async")
    kva.barrier()
    gi = ps.pull("dt/i32")
    assert gi.dtype == torch.int32 and torch.equal(gi, n * iv), gi
    ps.init("dt/b16", torch.zeros(8, dtype=torch.bfloat16))
    kva.barrier()
    ps.push("dt/b16", torch.ones(8, dtype=torch.bfloat16), "async")
    kva.barrier()
    gb = ps.pull("dt/b16")
    assert gb.dtype == torch.bfloat16, gb.dtype
    onp.testing.assert_allclose(gb.float().numpy(), onp.full(8, float(n)),
                                rtol=1e-2)

    # fp16 keys
    kv.init("h", mx.nd.zeros((64, 65)).astype("float16"))
    kv.push("h", mx.nd.full((64, 65), float(r + 1)).astype("float16"))
    kv.barrier()
    out = mx.nd.zeros((64, 65)).astype("float16")
    kv.pull("h", out=out)
    onp.testing.assert_allclose(out.asnumpy().astype("float32"),
                                onp.full((64, 65), total), rtol=1e-3)

    # a list of gradients sums locally first
    kv.init("md", mx.nd.zeros((5,)))
    kv.push("md", [mx.nd.ones((5,)), mx.nd.ones((5,))])
    kv.barrier()
    out = mx.nd.zeros((5,))
    kv.pull("md", out=out)
    onp.testing.assert_allclose(out.asnumpy(), onp.full((5,), 2.0 * n))

    # the updater runs identically on every worker
    def upd(key, grad, stored):
        stored._adopt(stored._data + 0.5 * grad._data)

    kv._set_updater(upd)
    kv.init("u", mx.nd.zeros((2, 2)))
    kv.push("u", mx.nd.ones((2, 2)))
    kv.barrier()
    out = mx.nd.zeros((2, 2))
    kv.pull("u", out=out)
    onp.testing.assert_allclose(out.asnumpy(), onp.full((2, 2), 0.5 * n))

    # 2-bit compression: the wire carries 2 bits a value; the sum over
    # workers of each one's quantised {-t, 0, t}
    kvc = kvs.create("dist_sync")
    kvc.set_gradient_compression({"type": "2bit", "threshold": 0.5})
    nelem = 1024
    kvc.init("c", mx.nd.zeros((nelem,)))
    kvc.push("c", mx.nd.full((nelem,), 10.0))
    kvc.barrier()
    out = mx.nd.zeros((nelem,))
    kvc.pull("c", out=out)
    onp.testing.assert_allclose(out.asnumpy(), onp.full((nelem,), 0.5 * n))
    assert kvc.last_wire_bytes == nelem // 4, kvc.last_wire_bytes
    assert kvc.last_uncompressed_bytes == 4 * nelem
    # the residual: a sub-threshold push crosses the threshold next round
    kvc._set_updater(lambda k, g, s: s._adopt(g._data))
    kvc.init("cr", mx.nd.zeros((nelem,)))
    kvc.push("cr", mx.nd.full((nelem,), 0.3))
    kvc.barrier()
    kvc.pull("cr", out=out)
    onp.testing.assert_allclose(out.asnumpy(), onp.zeros((nelem,)))
    kvc.push("cr", mx.nd.full((nelem,), 0.3))
    kvc.barrier()
    kvc.pull("cr", out=out)
    onp.testing.assert_allclose(out.asnumpy(), onp.full((nelem,), 0.5 * n))

    # an optimizer on a compressed store runs on the server shards
    kvo = kvs.create("dist_sync")
    kvo.set_gradient_compression({"type": "2bit", "threshold": 0.5})
    kvo.set_optimizer(mx.optimizer.create("sgd", learning_rate=0.1))
    kvo.init("o", mx.nd.ones((16,)))
    kvo.push("o", mx.nd.full((16,), 2.0))
    kvo.barrier()
    out = mx.nd.zeros((16,))
    kvo.pull("o", out=out)
    onp.testing.assert_allclose(out.asnumpy(),
                                onp.full((16,), 1.0 - 0.1 * 0.5 * n),
                                rtol=1e-6)

    # the server profiler counts each worker's push on its owner shard
    prof_base = os.path.join(tempfile.gettempdir(),
                             f"mxps_torch_prof_{os.getppid()}")
    kvc._send_command_to_servers(0, "profile:start")
    kvc.barrier()
    kvc.push("c", mx.nd.full((nelem,), 1.0))
    kvc.barrier()
    if r == 0:
        kvc._send_command_to_servers(0, f"profile:dump:{prof_base}")
    kvc.barrier()
    pushes = 0
    for w in range(n):
        with open(f"{prof_base}.r{w}") as f:
            stats = json.load(f)
        assert stats["rank"] == w
        pushes += stats["push"]
    assert pushes == n, pushes

    # sparse pulls wait for the sparse storage
    try:
        kv.row_sparse_pull("3", out=mx.nd.zeros((3, 3)),
                           row_ids=mx.nd.array([1]))
        raise AssertionError("row_sparse_pull must raise")
    except mx.MXNetError as e:
        assert "ROADMAP §A 3" in str(e)
    kv.barrier()
    print(f"[worker {r}] dist_sync_kvstore OK ({n} workers, shard "
          f"{kva.shard})", flush=True)


if __name__ == "__main__":
    main()
