"""The port's ``ImageDetRecordIter`` held against the JAX package's on
the CPU, bit for bit: both decode with PIL and resize with PIL's
``imresize`` on the host, so every batch's pixels, its ``(batch,
max_objects, object_width)`` labels padded with -1 and its pad agree
exactly, with mirror on and off (the mirror's ``[xmin, xmax]`` remap),
shuffled, sharded, with ``label_pad_width`` and an extra header, and
with damaged records quarantined into equal manifests.  ``rand_crop``
raises the reference's message; ``provide_label`` is the reference's.
"""
import io
import json

import numpy as onp
import pytest

import jax

jax.config.update("jax_platforms", "cpu")

import mxnet_tpu as jmx  # noqa: E402
from mxnet_tpu import test_utils as jtu  # noqa: E402

import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu_torch.base import MXNetError  # noqa: E402

from test_torch_device_feed import limited  # noqa: E402


@pytest.fixture(autouse=True)
def _host():
    with tmx.cpu():
        yield


def write_det_corpus(path, n=24, seed=5, header_width=2, max_boxes=6,
                     classes=20):
    """``n`` JPEGs of varied sizes, each with 1..``max_boxes`` boxes of
    ``classes`` classes:
    labels ``[header_width, 5, <extra header>, (id, x0, y0, x1, y1)...]``.
    Returns the records' byte offsets (for ``corrupt_rec``)."""
    from PIL import Image

    rng = onp.random.RandomState(seed)
    w = tmx.recordio.MXRecordIO(path, "w")
    offsets = []
    try:
        for i in range(n):
            hh, ww = rng.randint(20, 60, 2)
            img = (rng.rand(hh, ww, 3) * 255).astype("uint8")
            bio = io.BytesIO()
            Image.fromarray(img).save(bio, format="JPEG", quality=90)
            k = rng.randint(1, max_boxes + 1)
            x0, y0 = rng.rand(k) * 0.5, rng.rand(k) * 0.5
            boxes = onp.stack([rng.randint(0, classes, k), x0, y0,
                               x0 + 0.1 + rng.rand(k) * 0.4,
                               y0 + 0.1 + rng.rand(k) * 0.4], 1)
            extra = [float(ww), float(hh)][:header_width - 2]
            lab = onp.concatenate([[header_width, 5], extra,
                                   boxes.reshape(-1)]).astype("float32")
            offsets.append(w.tell())
            w.write(tmx.recordio.pack(tmx.recordio.IRHeader(0, lab, i, 0),
                                      bio.getvalue()))
    finally:
        w.close()
    return offsets


def _run(pkg, path, manifest=None, epochs=1, **kw):
    args = dict(data_shape=(3, 32, 40), batch_size=5, mean_r=123.68,
                mean_g=116.28, mean_b=103.53, std_r=58.395, std_g=57.12,
                std_b=57.375, seed=7, **kw)
    if pkg is jmx:
        args.pop("io_workers", None)
        args["device_feed"] = False
    if manifest:
        args["quarantine_manifest"] = manifest
    it = pkg.io.ImageDetRecordIter(path_imgrec=path, **args)
    out = []
    try:
        for e in range(epochs):
            if e:
                it.reset()
            for b in it:
                out.append((b.data[0].asnumpy(), b.label[0].asnumpy(),
                            b.pad))
        desc = it.provide_label[0]
    finally:
        it.close()
    return out, (desc.name, tuple(desc.shape))


CASES = {
    "plain": dict(),
    "mirror": dict(rand_mirror=True),
    "mirror_shuffle_workers": dict(rand_mirror=True, shuffle=True,
                                   io_workers=3),
    "label_pad_width": dict(label_pad_width=2 + 5 * 9, rand_mirror=True),
    "shard_no_round": dict(part_index=1, num_parts=2, round_batch=False),
}


@limited(120)
@pytest.mark.parametrize("case", list(CASES))
def test_batches_equal_reference_bit_for_bit(tmp_path, case):
    path = str(tmp_path / "det.rec")
    write_det_corpus(path, header_width=4 if case == "plain" else 2)
    want, jdesc = _run(jmx, path, epochs=2, **CASES[case])
    got, tdesc = _run(tmx, path, epochs=2, **CASES[case])
    assert tdesc == jdesc
    assert len(got) == len(want) > 0
    for (jd, jl, jp), (td, tl, tp) in zip(want, got):
        assert tp == jp
        assert td.dtype == onp.float32 and tl.dtype == onp.float32
        onp.testing.assert_array_equal(td, jd)
        onp.testing.assert_array_equal(tl, jl)
    lab = got[0][1]
    assert lab.shape[1:] == tdesc[1][1:]
    if case != "shard_no_round":  # a shard scans its own records
        assert lab.shape[1:] == (9 if case == "label_pad_width" else 6, 5)
    assert (lab[lab[..., 0] < 0] == -1).all()  # the padding


def test_mirror_remaps_boxes(tmp_path):
    """A mirrored image's boxes are ``[1 - xmax, 1 - xmin]`` of the
    plain run's, and its pixels the plain ones flipped left-right."""
    path = str(tmp_path / "det.rec")
    write_det_corpus(path, n=10)
    plain, _ = _run(tmx, path)
    mirr, _ = _run(tmx, path, rand_mirror=True)
    flipped = 0
    for (pd, pl, _), (md, ml, _) in zip(plain, mirr):
        for k in range(len(pd)):
            if onp.array_equal(md[k], pd[k]):
                onp.testing.assert_array_equal(ml[k], pl[k])
                continue
            flipped += 1
            onp.testing.assert_array_equal(md[k], pd[k][:, :, ::-1])
            valid = pl[k][:, 0] >= 0
            onp.testing.assert_allclose(ml[k][valid, 1],
                                        1.0 - pl[k][valid, 3], rtol=1e-6)
            onp.testing.assert_allclose(ml[k][valid, 3],
                                        1.0 - pl[k][valid, 1], rtol=1e-6)
            onp.testing.assert_array_equal(ml[k][~valid], pl[k][~valid])
    assert flipped > 0


@limited(120)
def test_quarantine_equals_reference(tmp_path):
    path = str(tmp_path / "det.rec")
    offs = write_det_corpus(path, n=20)
    jtu.corrupt_rec(path, offs, unpack=(3,), decode=(7, 12))
    manifests = [str(tmp_path / f"{p}.json") for p in ("j", "t")]
    want, _ = _run(jmx, path, manifests[0], max_skip_frac=0.5)
    got, _ = _run(tmx, path, manifests[1], max_skip_frac=0.5,
                  io_workers=2)
    assert len(got) == len(want)
    for (jd, jl, jp), (td, tl, tp) in zip(want, got):
        assert tp == jp
        onp.testing.assert_array_equal(td, jd)
        onp.testing.assert_array_equal(tl, jl)
    with open(manifests[0]) as f:
        jm = json.load(f)
    with open(manifests[1]) as f:
        tm = json.load(f)
    key = lambda e: (e["record"], e["offset"], e["stage"])  # noqa: E731
    assert sorted(map(key, tm["entries"])) == sorted(map(key, jm["entries"]))
    # PIL decodes through one of the two smeared payloads
    assert {e["stage"] for e in tm["entries"]} == {"decode", "unpack"}


def test_rand_crop_refused_as_the_reference(tmp_path):
    path = str(tmp_path / "det.rec")
    write_det_corpus(path, n=4)
    for pkg in (jmx, tmx):
        with pytest.raises(Exception, match="rand_crop is not bbox-aware"):
            pkg.io.ImageDetRecordIter(path_imgrec=path,
                                      data_shape=(3, 16, 16),
                                      batch_size=2, rand_crop=True)
    with pytest.raises(MXNetError, match="3-channel"):
        it = tmx.io.ImageDetRecordIter(path_imgrec=path,
                                       data_shape=(1, 16, 16), batch_size=2)
        try:
            next(it)
        finally:
            it.close()
