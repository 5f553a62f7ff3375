"""The port's ``CSVIter``, ``LibSVMIter`` and ``MNISTIter`` held against
the JAX package on the CPU, over files written here from a seed:
batches, labels, pads and ``provide_*`` exactly equal, over two epochs,
shuffled and not, with and without ``round_batch``."""
import gzip
import struct

import numpy as onp
import pytest

import jax

jax.config.update("jax_platforms", "cpu")

import mxnet_tpu as jmx  # noqa: E402

import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu_torch.base import MXNetError  # noqa: E402


@pytest.fixture(autouse=True)
def _host():
    with tmx.cpu():
        yield


def _epochs(it, n=2):
    out = []
    for e in range(n):
        if e:
            it.reset()
        for b in it:
            out.append(([a.asnumpy() for a in b.data + b.label], b.pad))
    return out


def _same(j, t):
    assert len(j) == len(t) > 0
    for (ja, jp), (ta, tp) in zip(j, t):
        assert jp == tp
        for a, b in zip(ja, ta):
            assert a.dtype == b.dtype and a.shape == b.shape
            onp.testing.assert_array_equal(a, b)


def _csv(tmp_path, rows=23, cols=6, seed=0):
    rng = onp.random.RandomState(seed)
    x = rng.randn(rows, cols).round(4)
    y = rng.randint(0, 3, (rows, 1)).astype(float)
    px, py = tmp_path / "x.csv", tmp_path / "y.csv"
    onp.savetxt(px, x, delimiter=",")
    onp.savetxt(py, y, delimiter=",")
    return str(px), str(py)


@pytest.mark.parametrize("shuffle,round_batch,labels", [
    (False, True, True), (True, True, True), (False, False, False)])
def test_csv_iter_matches_reference(tmp_path, shuffle, round_batch,
                                    labels):
    px, py = _csv(tmp_path)
    res = []
    for pkg in (jmx, tmx):
        it = pkg.io.CSVIter(data_csv=px, data_shape=(2, 3), batch_size=5,
                            label_csv=py if labels else None,
                            shuffle=shuffle, round_batch=round_batch,
                            seed=3)
        descs = [(d.name, d.shape) for d in it.provide_data
                 + it.provide_label]
        res.append((descs, _epochs(it)))
    assert res[0][0] == res[1][0]
    _same(res[0][1], res[1][1])
    for pkg in (jmx, tmx):
        with pytest.raises(Exception):
            pkg.io.CSVIter(data_csv=px, data_shape=(4,), batch_size=5)


def test_libsvm_iter_matches_reference(tmp_path):
    rng = onp.random.RandomState(1)
    lines = ["# a comment", ""]
    for _ in range(17):
        idx = sorted(rng.choice(10, rng.randint(1, 5), replace=False))
        lines.append(f"{rng.randint(0, 4)} " + " ".join(
            f"{k}:{rng.randn():.3f}" for k in idx))
    p = tmp_path / "d.libsvm"
    p.write_text("\n".join(lines) + "\n")
    res = [_epochs(pkg.io.LibSVMIter(data_libsvm=str(p), data_shape=(10,),
                                     batch_size=4, shuffle=True, seed=2))
           for pkg in (jmx, tmx)]
    _same(*res)
    bad = tmp_path / "bad.libsvm"
    bad.write_text("1 12:0.5\n")
    with pytest.raises(MXNetError, match="index 12"):
        tmx.io.LibSVMIter(data_libsvm=str(bad), data_shape=(10,),
                          batch_size=2)


def _idx(path, arr, gz):
    head = struct.pack(">i", 0x0800 | arr.ndim) + struct.pack(
        ">" + "i" * arr.ndim, *arr.shape)
    op = gzip.open if gz else open
    with op(path, "wb") as f:
        f.write(head + arr.astype(onp.uint8).tobytes())


@pytest.mark.parametrize("gz,flat", [(False, False), (True, True)])
def test_mnist_iter_matches_reference(tmp_path, gz, flat):
    rng = onp.random.RandomState(4)
    imgs = rng.randint(0, 256, (21, 28, 28))
    labs = rng.randint(0, 10, 21)
    suf = ".gz" if gz else ""
    pi, pl = str(tmp_path / f"i.idx{suf}"), str(tmp_path / f"l.idx{suf}")
    _idx(pi, imgs, gz)
    _idx(pl, labs, gz)
    res = [_epochs(pkg.io.MNISTIter(image=pi, label=pl, batch_size=8,
                                    shuffle=True, flat=flat, seed=6))
           for pkg in (jmx, tmx)]
    _same(*res)
    assert res[1][0][0][0].shape == ((8, 784) if flat else (8, 1, 28, 28))
    assert res[1][-1][1] == 3  # 21 = 8 + 8 + 5, padded by 3


def test_iterator_batches_are_host_arrays(tmp_path):
    px, _ = _csv(tmp_path)
    with tmx.gpu(0):
        it = tmx.io.CSVIter(data_csv=px, data_shape=(6,), batch_size=4)
        b = next(iter(it))
    assert b.data[0].context == tmx.cpu()
