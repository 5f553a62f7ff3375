"""The port's ``ImageRecordIter`` on the host held against the JAX
package's on the CPU, with the native library (libjpeg) decoding on
both sides: batches, labels and pads equal bit for bit, shuffled,
augmented, sharded, with and without ``round_batch``, at 0 and several
workers; quarantine manifests equal as JSON; the skip ceiling, a
crashed worker's respawn and a straggler's re-dispatch as the
reference's; every ``data`` run-log record valid under
``mxnet_tpu.telemetry.schema``.  ``image_augment_plain`` (the card
kernel's plain version) equals the native ``decode_augment_batch`` bit
for bit on the same decoded pixels, and the committed nvJPEG fixture's
pixels equal libjpeg's decode of its bytes.  Every test that waits on a
thread has its own time limit."""
import ctypes
import io
import json
import os
import threading

import numpy as onp
import pytest
import torch

import jax

jax.config.update("jax_platforms", "cpu")

import mxnet_tpu as jmx  # noqa: E402
from mxnet_tpu import test_utils as jtu  # noqa: E402
from mxnet_tpu.telemetry import schema as j_schema  # noqa: E402

import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu_torch import _native  # noqa: E402
from mxnet_tpu_torch.base import MXNetError  # noqa: E402
from mxnet_tpu_torch.ops.image_augment import image_augment_plain  # noqa: E402,E501
from mxnet_tpu_torch.resilience import faultsim as t_fs  # noqa: E402

from test_torch_device_feed import limited  # noqa: E402

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                       "nvjpeg_fixture.npz")


@pytest.fixture(autouse=True)
def _host():
    if _native.get_lib() is None:
        pytest.skip("needs g++ and libjpeg for the native library")
    with tmx.cpu():
        yield
    t_fs.reset("")


def _corpus(tmp_path, n=30, size=40, seed=3, **damage):
    path = str(tmp_path / "c.rec")
    offs = jtu.write_rec_corpus(path, n=n, size=size, seed=seed)
    if damage:
        jtu.corrupt_rec(path, offs, **damage)
    return path


BASE = dict(data_shape=(3, 24, 24), batch_size=8, shuffle=True,
            rand_crop=True, rand_mirror=True, resize=32, mean_r=123.68,
            mean_g=116.28, mean_b=103.53, std_r=58.395, std_g=57.12,
            std_b=57.375, seed=7, max_skip_frac=0.5)


def _run(pkg, path, manifest, epochs=2, **kw):
    args = dict(BASE, **kw)
    if pkg is jmx:
        args = {k: v for k, v in args.items() if k != "io_workers"}
        args["device_feed"] = False
    it = pkg.io.ImageRecordIter(path_imgrec=path,
                                quarantine_manifest=manifest, **args)
    out = []
    try:
        for e in range(epochs):
            if e:
                it.reset()
            for b in it:
                out.append((b.data[0].asnumpy(), b.label[0].asnumpy(),
                            b.pad))
        stats = it.data_plane_stats()
    finally:
        it.close()
    return out, stats


def _same(j, t):
    assert len(j) == len(t) > 0
    for (jd, jl, jp), (td, tl, tp) in zip(j, t):
        assert jp == tp
        assert td.dtype == jd.dtype == onp.float32
        onp.testing.assert_array_equal(td, jd)
        onp.testing.assert_array_equal(tl, jl)


CASES = {
    "workers0": dict(io_workers=0),
    "workers3": dict(io_workers=3),
    "no_round": dict(io_workers=2, round_batch=False),
    "shard1of3": dict(io_workers=2, part_index=1, num_parts=3),
    "no_resize_gray_crop": dict(io_workers=0, resize=-1,
                                data_shape=(3, 48, 20)),
    "jitter": dict(io_workers=2, random_h=10, random_s=20, random_l=15,
                   pca_noise=0.1, max_random_contrast=0.2,
                   max_random_illumination=10),
}


@limited(120)
@pytest.mark.parametrize("case", list(CASES))
def test_batches_equal_reference_bit_for_bit(tmp_path, case):
    # a record that fails to decode sends its batch down the per-image
    # PIL path (other arithmetic than libjpeg's batch) in both packages;
    # whether a wrap-around batch still holds it depends on the order in
    # which a pool assembles batches, so decode damage is held with one
    # producer, and unpack and framing damage at any worker count
    damage = dict(torn=(5,), unpack=(9,))
    if not CASES[case].get("io_workers"):
        damage["decode"] = (17,)
    path = _corpus(tmp_path, **damage)
    j, js = _run(jmx, path, str(tmp_path / "j.json"), **CASES[case])
    t, ts = _run(tmx, path, str(tmp_path / "t.json"), **CASES[case])
    if case == "jitter":
        # the HSL round trip runs in float64 numpy on both sides; the
        # rest is the same code
        assert len(j) == len(t)
        for (jd, jl, jp), (td, tl, tp) in zip(j, t):
            assert jp == tp
            onp.testing.assert_array_equal(tl, jl)
            onp.testing.assert_allclose(td, jd, rtol=0, atol=1e-5)
    else:
        _same(j, t)
    with open(tmp_path / "j.json") as f, open(tmp_path / "t.json") as g:
        jm, tm = json.load(f), json.load(g)
    assert tm == jm
    assert {k: ts[k] for k in ("records", "skipped", "parse_skips",
                               "quarantined")} == \
        {k: js[k] for k in ("records", "skipped", "parse_skips",
                            "quarantined")}


@limited(120)
def test_stream_identical_at_any_worker_count(tmp_path):
    path = _corpus(tmp_path, n=26, unpack=(4, 19))
    runs = [_run(tmx, path, str(tmp_path / f"{w}.json"), io_workers=w)[0]
            for w in (0, 1, 4)]
    _same(runs[0], runs[1])
    _same(runs[0], runs[2])


@limited(120)
def test_skip_ceiling_fails_loudly_as_the_reference(tmp_path):
    path = _corpus(tmp_path, n=12, decode=(1, 2, 3, 4))
    for pkg in (jmx, tmx):
        kw = dict(BASE, max_skip_frac=0.1, io_workers=2) if pkg is tmx \
            else dict(BASE, max_skip_frac=0.1)
        it = pkg.io.ImageRecordIter(path_imgrec=path, **kw)
        with pytest.raises(pkg.base.MXNetError, match="quarantine ceiling"):
            list(it)
        it.close()
    # a parse-stage ceiling raises at construction and leaks no handle
    path2 = _corpus(tmp_path, n=10, torn=(1, 3, 5, 7))
    for pkg in (jmx, tmx):
        with pytest.raises(pkg.base.MXNetError, match="quarantine ceiling"):
            pkg.io.ImageRecordIter(path_imgrec=path2, data_shape=(3, 8, 8),
                                   batch_size=2, max_skip_frac=0.05)


def _clean_batches(path, **kw):
    it = tmx.io.ImageRecordIter(path_imgrec=path, data_shape=(3, 16, 16),
                                batch_size=4, std_r=255.0, std_g=255.0,
                                std_b=255.0, max_skip_frac=0.5, **kw)
    try:
        return ([(b.data[0].asnumpy(), b.pad) for b in it],
                it.data_plane_stats())
    finally:
        it.close()


@limited(120)
@pytest.mark.parametrize("spec,deadline,respawns", [
    ("io.worker:crash@2", 1.0, "some"),
    ("io.worker:delay=1.5@1", 0.3, "some"),
    ("io.worker:raise@2", 2.0, "none"),
])
def test_worker_faults_keep_the_stream(tmp_path, spec, deadline, respawns):
    """A crashed worker is respawned and its batch re-dispatched, a
    straggler's batch re-dispatched, a raise absorbed: the stream is
    the fault-free one, as in the reference's drills."""
    path = str(tmp_path / "w.rec")
    jtu.write_rec_corpus(path, n=12, size=16, seed=1)
    ref, _ = _clean_batches(path)
    t_fs.reset(spec)
    got, stats = _clean_batches(path, io_workers=2,
                                worker_deadline_sec=deadline)
    t_fs.reset("")
    assert (stats["respawns"] >= 1) == (respawns == "some")
    assert len(got) == len(ref) == 3
    for (a, pa), (b, pb) in zip(ref, got):
        assert pa == pb
        onp.testing.assert_array_equal(a, b)


@limited(120)
def test_respawn_budget_and_abandoned_iterator(tmp_path):
    path = str(tmp_path / "w.rec")
    jtu.write_rec_corpus(path, n=12, size=16, seed=1)
    t_fs.reset("io.worker:crash@1+")
    it = tmx.io.ImageRecordIter(path_imgrec=path, data_shape=(3, 16, 16),
                                batch_size=4, io_workers=2,
                                worker_respawn=2, worker_deadline_sec=0.5)
    with pytest.raises(MXNetError, match="respawn budget exhausted"):
        list(it)
    it.close()
    t_fs.reset("")
    for workers in (0, 2):
        it = tmx.io.ImageRecordIter(path_imgrec=path,
                                    data_shape=(3, 16, 16), batch_size=4,
                                    prefetch_buffer=1, io_workers=workers)
        next(it)  # the producer blocks on the full queue
        it.close()
        leaked = [t.name for t in threading.enumerate()
                  if t.name.startswith("ImageRecordIter") and t.is_alive()]
        assert not leaked, leaked


@limited(120)
def test_data_records_are_schema_valid(tmp_path):
    from mxnet_tpu_torch import telemetry as t_tm

    path = _corpus(tmp_path, n=16, torn=(3,), unpack=(6,), decode=(11,))
    runlog = str(tmp_path / "run.jsonl")
    t_tm.reset(runlog)
    try:
        t_fs.reset("io.worker:crash@2")
        it = tmx.io.ImageRecordIter(path_imgrec=path, data_shape=(3, 16, 16),
                                    batch_size=4, max_skip_frac=0.5,
                                    io_workers=2, worker_deadline_sec=1.0)
        list(it)
        it.close()
    finally:
        t_fs.reset("")
        t_tm.close()
    with open(runlog) as f:
        records, problems = j_schema.validate_lines(f)
    assert not problems, problems
    data = [r for r in records if r["type"] == "data"]
    assert [r["action"] for r in data].count("quarantine") == 3
    assert "respawn" in [r["action"] for r in data]
    ends = [r for r in records if r["type"] == "run_end"]
    assert ends[-1]["counters"]["data_records_skipped"] == 3


def _decode(lib, j):
    a = onp.frombuffer(j, onp.uint8)
    p = a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    h, w = ctypes.c_int(), ctypes.c_int()
    assert lib.rec_jpeg_size(p, len(a), ctypes.byref(h), ctypes.byref(w)) \
        == 0
    out = onp.empty((h.value, w.value, 3), onp.uint8)
    assert lib.rec_jpeg_decode(p, len(a), out.ctypes.data_as(
        ctypes.POINTER(ctypes.c_uint8)), h.value, w.value) == 0
    return out


@pytest.mark.parametrize("resize", [-1, 100, 256])
def test_plain_augment_equals_native_bit_for_bit(resize):
    from PIL import Image

    rng = onp.random.RandomState(resize & 0xFF)
    shapes = [(375, 500), (500, 375), (100, 90), (257, 301), (224, 224),
              (33, 401), (1, 1), (17, 229)]
    jpegs = []
    for h, w in shapes:
        b = io.BytesIO()
        Image.fromarray((rng.rand(h, w, 3) * 255).astype("uint8")).save(
            b, format="JPEG", quality=90)
        jpegs.append(b.getvalue())
    lib = _native.get_lib()
    imgs = [_decode(lib, j) for j in jpegs]
    flat = torch.from_numpy(onp.concatenate([i.reshape(-1) for i in imgs]))
    offs = onp.cumsum([0] + [i.size for i in imgs[:-1]])
    n = len(imgs)
    mean = onp.array([123.68, 116.28, 103.53], "float32")
    std = onp.array([58.395, 57.12, 57.375], "float32")
    for oh, ow in ((224, 224), (64, 48)):
        cx = rng.rand(n).astype("float32")
        cy = rng.rand(n).astype("float32")
        mir = (rng.rand(n) < 0.5).astype("uint8")
        for m, s in ((mean, std), (None, None)):
            want, fails = _native.decode_augment_batch(
                jpegs, oh, ow, mean=m, std=s, crop_x=cx, crop_y=cy,
                mirror=mir, resize_short=resize)
            assert fails == 0
            got = image_augment_plain(
                flat, offs, [i.shape[0] for i in imgs],
                [i.shape[1] for i in imgs], oh, ow, cx, cy, mir, m, s,
                resize)
            assert got.dtype == torch.float32
            onp.testing.assert_array_equal(got.numpy(), want)


def test_committed_fixture_is_libjpegs_decode():
    """The nvJPEG-against-libjpeg fixture that chip_smoke.py reads: each
    committed JPEG (4:2:0, 4:4:4, grayscale, odd sizes) with the pixels
    libjpeg decodes from it."""
    fx = onp.load(FIXTURE)
    names = sorted(k[5:] for k in fx.files if k.startswith("jpeg_"))
    assert len(names) == 4
    lib = _native.get_lib()
    for name in names:
        onp.testing.assert_array_equal(
            _decode(lib, fx[f"jpeg_{name}"].tobytes()), fx[f"pix_{name}"])


def test_card_target_without_a_card_raises(tmp_path):
    path = _corpus(tmp_path, n=4)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(MXNetError, match="no CUDA card"):
        tmx.io.ImageRecordIter(path_imgrec=path, data_shape=(3, 8, 8),
                               batch_size=2, ctx=tmx.gpu(0))
    with tmx.gpu(0), pytest.raises(MXNetError, match="no CUDA card"):
        tmx.io.ImageRecordIter(path_imgrec=path, data_shape=(3, 8, 8),
                               batch_size=2)
    # the host target: device feed off, or an explicit host context
    it = tmx.io.ImageRecordIter(path_imgrec=path, data_shape=(3, 8, 8),
                                batch_size=2, device_feed=False)
    assert it.ctx == tmx.cpu() and next(it).data[0].context == tmx.cpu()
    assert it.stats()["h2d_bytes"] == 0 and it.stats()["batches"] == 1
    it.close()


def make_fixture(path=FIXTURE, seed=11):
    """Write the fixture: four small JPEGs from a seed (PIL's encoder)
    and libjpeg's pixels of each.  ``python
    tests/test_torch_image_record_iter.py`` rewrites it."""
    from PIL import Image

    rng = onp.random.RandomState(seed)
    lib = _native.get_lib()
    out = {}
    for name, (h, w), mode, sub in (("420", (37, 53), "RGB", 2),
                                    ("444", (41, 29), "RGB", 0),
                                    ("gray", (31, 45), "L", None),
                                    ("420_odd", (19, 67), "RGB", 2)):
        yy, xx = onp.mgrid[0:h, 0:w] / max(h, w)
        base = onp.stack([onp.sin(6 * yy + c) * onp.cos(5 * xx - c)
                          for c in range(3)], -1) * 90 + 128
        img = onp.clip(base + rng.randn(h, w, 3) * 12, 0, 255) \
            .astype("uint8")
        if mode == "L":
            img = img[..., 0]
        b = io.BytesIO()
        kw = {"quality": 90} if sub is None else {"quality": 90,
                                                  "subsampling": sub}
        Image.fromarray(img, mode).save(b, format="JPEG", **kw)
        out[f"jpeg_{name}"] = onp.frombuffer(b.getvalue(), onp.uint8)
        out[f"pix_{name}"] = _decode(lib, b.getvalue())
    os.makedirs(os.path.dirname(path), exist_ok=True)
    onp.savez_compressed(path, **out)


if __name__ == "__main__":
    make_fixture()
