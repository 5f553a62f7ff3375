"""The port's RecordIO (``mx.recordio``) and ``RecordFileDataset`` held
against the JAX package on the CPU.

Files written by one package are read by the other and their bytes are
compared exactly; the resync reader skips the three damage shapes of
``mxnet_tpu.test_utils.corrupt_rec`` (a torn frame, a bad header, a
smeared JPEG) exactly as the reference's does.  Exact equality
throughout: the format is bytes.
"""
import pickle

import numpy as onp
import pytest

import jax

jax.config.update("jax_platforms", "cpu")

import mxnet_tpu as jmx  # noqa: E402
from mxnet_tpu import test_utils as jtu  # noqa: E402

import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu_torch.base import MXNetError  # noqa: E402

MAGIC = b"\x0a\x23\xd7\xce"


def _payloads(seed=0, n=12):
    """Records of random sizes, some holding the magic bytes (which the
    writer splits into continuation parts)."""
    rng = onp.random.RandomState(seed)
    out = []
    for i in range(n):
        b = rng.bytes(int(rng.randint(0, 300)))
        if i % 3 == 1:
            b = b[:7] + MAGIC + b[7:] + MAGIC
        out.append(b)
    return out


@pytest.mark.parametrize("writer,reader", [("j", "t"), ("t", "j")])
def test_record_files_cross_both_ways(tmp_path, writer, reader):
    pkgs = {"j": jmx, "t": tmx}
    recs = _payloads()
    paths = {}
    for name, pkg in pkgs.items():
        p = str(tmp_path / f"{name}.rec")
        w = pkg.recordio.MXRecordIO(p, "w")
        for r in recs:
            w.write(r)
        w.close()
        paths[name] = p
    with open(paths["j"], "rb") as a, open(paths["t"], "rb") as b:
        assert a.read() == b.read()
    r = pkgs[reader].recordio.MXRecordIO(paths[writer], "r")
    got = []
    while True:
        s = r.read()
        if s is None:
            break
        got.append(s)
    r.close()
    assert got == recs


def test_indexed_records_and_headers_match_reference(tmp_path):
    recs = _payloads(seed=1, n=6)
    files = {}
    for name, pkg in (("j", jmx), ("t", tmx)):
        idx, rec = str(tmp_path / f"{name}.idx"), str(tmp_path / f"{name}.rec")
        w = pkg.recordio.MXIndexedRecordIO(idx, rec, "w")
        for i, r in enumerate(recs):
            lab = float(i) if i % 2 else [float(i), 2.5, -1.0]
            w.write_idx(i * 10, pkg.recordio.pack(
                pkg.recordio.IRHeader(0, lab, i, 7), r))
        w.close()
        files[name] = (open(idx).read(), open(rec, "rb").read())
    assert files["j"] == files["t"]
    # the port reads the reference's file by key, in any order
    r = tmx.recordio.MXIndexedRecordIO(str(tmp_path / "j.idx"),
                                       str(tmp_path / "j.rec"), "r")
    for i in (5, 0, 3):
        h, s = tmx.recordio.unpack(r.read_idx(i * 10))
        jh, js = jmx.recordio.unpack(jmx.recordio.pack(
            jmx.recordio.IRHeader(0, float(i) if i % 2 else
                                  [float(i), 2.5, -1.0], i, 7), recs[i]))
        assert s == js == recs[i]
        assert (h.flag, h.id, h.id2) == (jh.flag, jh.id, jh.id2)
        onp.testing.assert_array_equal(h.label, jh.label)
    assert r.keys == [i * 10 for i in range(6)]
    r.close()


def test_pickled_reader_reopens_at_start(tmp_path):
    p = str(tmp_path / "a.rec")
    w = tmx.recordio.MXRecordIO(p, "w")
    for r in _payloads(n=3):
        w.write(r)
    w.close()
    r = tmx.recordio.MXRecordIO(p, "r", resync=True, on_skip=print)
    first = r.read()
    r2 = pickle.loads(pickle.dumps(r))
    assert r2.on_skip is None and r2._resync and r2.read() == first
    r.close()
    r2.close()


DAMAGE = {"torn": dict(torn=(3,)), "unpack": dict(unpack=(5,)),
          "decode": dict(decode=(7,)),
          "all": dict(torn=(2, 9), unpack=(4,), decode=(6, 11))}


@pytest.mark.parametrize("shape", list(DAMAGE))
def test_resync_skips_as_the_reference_does(tmp_path, shape):
    path = str(tmp_path / "c.rec")
    offsets = jtu.write_rec_corpus(path, n=14, size=12, seed=5)
    jtu.corrupt_rec(path, offsets, **DAMAGE[shape])
    res = {}
    for name, pkg in (("j", jmx), ("t", tmx)):
        skips = []
        r = pkg.recordio.MXRecordIO(
            path, "r", resync=True,
            on_skip=lambda o, n, why, s=skips: s.append((o, n, why)))
        recs = []
        while True:
            s = r.read()
            if s is None:
                break
            recs.append(s)
        r.close()
        res[name] = (recs, skips)
    assert res["t"] == res["j"]
    # strict mode raises where the frame is torn, as the reference's
    if "torn" in DAMAGE[shape]:
        for pkg in (jmx, tmx):
            r = pkg.recordio.MXRecordIO(path, "r")
            with pytest.raises(Exception, match="magic"):
                while r.read() is not None:
                    pass
            r.close()


def test_images_pack_and_unpack_through_pil(tmp_path):
    yy, xx = onp.mgrid[0:20, 0:24]
    img = onp.stack([yy * 12, xx * 10, 255 - yy * 6], -1).astype("uint8")
    s = tmx.recordio.pack_img(tmx.recordio.IRHeader(0, 4.0, 1, 0), img,
                              quality=95)
    h, back = tmx.recordio.unpack_img(s)
    assert h.label == 4.0 and back.shape == img.shape
    # a lossy round trip of a BGR image stays BGR
    assert onp.abs(back.astype(int) - img.astype(int)).mean() < 4
    # the reference unpacks the port's record to the same pixels
    jh, jback = jmx.recordio.unpack_img(s)
    onp.testing.assert_array_equal(jback, back)
    with pytest.raises(MXNetError):
        tmx.recordio.pack_img(tmx.recordio.IRHeader(0, 0, 0, 0), img,
                              img_fmt=".bmp")


def test_record_file_dataset_matches_reference(tmp_path):
    recs = _payloads(seed=4, n=5)
    idx, rec = str(tmp_path / "d.idx"), str(tmp_path / "d.rec")
    w = jmx.recordio.MXIndexedRecordIO(idx, rec, "w")
    for i, r in enumerate(recs):
        w.write_idx(i, r)
    w.close()
    jd = jmx.gluon.data.RecordFileDataset(rec)
    td = tmx.gluon.data.RecordFileDataset(rec)
    assert len(td) == len(jd) == 5
    assert [td[i] for i in range(5)] == [jd[i] for i in range(5)] == recs
