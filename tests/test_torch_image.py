"""The port's ``mx.image`` held against the JAX package on the CPU:
decode, resize and crops equal exactly; each augmenter and the
``CreateAugmenter`` chain under one ``random.seed``/``np.random.seed``
equal exactly where the arithmetic is elementwise, and to 1e-5 of the
largest value where a sum is taken (contrast, saturation, hue, gray:
the two packages sum in other orders); ``ImageIter`` over a ``.rec``
equal batch for batch."""
import io
import random

import numpy as onp
import pytest

import jax

jax.config.update("jax_platforms", "cpu")

import mxnet_tpu as jmx  # noqa: E402
from mxnet_tpu import test_utils as jtu  # noqa: E402

import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu_torch.base import MXNetError  # noqa: E402

PIL = pytest.importorskip("PIL.Image")


@pytest.fixture(autouse=True)
def _host():
    with tmx.cpu():
        yield


def _jpeg(h=30, w=41, seed=0):
    rng = onp.random.RandomState(seed)
    img = (rng.rand(h, w, 3) * 255).astype("uint8")
    b = io.BytesIO()
    PIL.fromarray(img).save(b, format="JPEG", quality=90)
    return b.getvalue()


def _both(fn):
    return [onp.asarray(fn(pkg).asnumpy()) for pkg in (jmx, tmx)]


def test_decode_resize_and_crops_match_reference():
    buf = _jpeg()
    for flag, to_rgb in ((1, True), (0, True), (1, False)):
        j, t = _both(lambda p: p.image.imdecode(buf, flag=flag,
                                                to_rgb=to_rgb))
        assert t.dtype == j.dtype and t.shape == j.shape
        onp.testing.assert_array_equal(t, j)
    for interp in (0, 1, 2):
        j, t = _both(lambda p: p.image.imresize(
            p.image.imdecode(buf), 17, 23, interp))
        onp.testing.assert_array_equal(t, j)
    j, t = _both(lambda p: p.image.resize_short(p.image.imdecode(buf), 20))
    onp.testing.assert_array_equal(t, j)
    j, t = _both(lambda p: p.image.fixed_crop(p.image.imdecode(buf), 3, 5,
                                              10, 12, size=(8, 9)))
    onp.testing.assert_array_equal(t, j)
    j, t = _both(lambda p: p.image.center_crop(p.image.imdecode(buf),
                                               (16, 14))[0])
    onp.testing.assert_array_equal(t, j)
    j, t = _both(lambda p: p.image.color_normalize(
        p.image.imdecode(buf), onp.array([1.0, 2.0, 3.0], "float32"),
        onp.array([2.0, 3.0, 4.0], "float32")))
    onp.testing.assert_array_equal(t, j)
    j, t = _both(lambda p: p.image.copyMakeBorder(p.image.imdecode(buf),
                                                  1, 2, 3, 4, value=7))
    onp.testing.assert_array_equal(t, j)
    assert tmx.image.imdecode(buf).context == tmx.cpu()


def test_imread_and_native_decode(tmp_path):
    p = tmp_path / "a.jpg"
    p.write_bytes(_jpeg(seed=2))
    j = jmx.image.imread(str(p)).asnumpy()
    t = tmx.image.imread(str(p)).asnumpy()
    onp.testing.assert_array_equal(t, j)
    # libjpeg through the native library: the same size, pixels near PIL's
    from mxnet_tpu_torch import _native
    from mxnet_tpu_torch.image import _decode_native

    if _native.get_lib() is not None:
        nat = _decode_native(p.read_bytes(), 1)
        assert nat.shape == j.shape
        assert onp.abs(nat.astype(int) - j.astype(int)).max() <= 2
        with pytest.raises(MXNetError):
            _decode_native(b"not a jpeg", 1)


AUGS = {
    "flip": (lambda p: p.image.HorizontalFlipAug(0.7), 0),
    "random_crop": (lambda p: p.image.RandomCropAug((20, 16)), 0),
    "random_sized_crop": (lambda p: p.image.RandomSizedCropAug(
        (18, 14), (0.3, 1.0), (0.75, 1.33)), 0),
    "brightness": (lambda p: p.image.BrightnessJitterAug(0.4), 0),
    "contrast": (lambda p: p.image.ContrastJitterAug(0.4), 1e-5),
    "saturation": (lambda p: p.image.SaturationJitterAug(0.4), 1e-5),
    "hue": (lambda p: p.image.HueJitterAug(0.3), 1e-5),
    "lighting": (lambda p: p.image.LightingAug(
        0.1, [55.46, 4.794, 1.148], [[-0.5675, 0.7192, 0.4009],
                                     [-0.5808, -0.0045, -0.8140],
                                     [-0.5836, -0.6948, 0.4203]]), 1e-5),
    "gray": (lambda p: p.image.RandomGrayAug(0.9), 1e-5),
    "color_jitter": (lambda p: p.image.ColorJitterAug(0.3, 0.3, 0.3), 1e-5),
}


@pytest.mark.parametrize("name", list(AUGS))
def test_augmenters_match_reference_under_a_seed(name):
    make, tol = AUGS[name]
    buf = _jpeg(seed=3)
    outs = []
    for pkg in (jmx, tmx):
        aug = make(pkg)
        img = pkg.image.imdecode(buf)
        res = []
        for trial in range(4):
            random.seed(100 + trial)
            onp.random.seed(100 + trial)
            res.append(onp.asarray(aug(img).asnumpy(), "float32"))
        outs.append((aug.dumps(), res))
    (jd, j), (td, t) = outs
    assert td == jd
    for a, b in zip(j, t):
        assert a.shape == b.shape
        scale = max(1.0, float(onp.abs(a).max()))
        onp.testing.assert_allclose(b, a, rtol=0, atol=tol * scale)


def test_create_augmenter_chain_matches_reference():
    buf = _jpeg(h=40, w=52, seed=4)
    kw = dict(resize=36, rand_crop=True, rand_mirror=True, mean=True,
              std=True, brightness=0.2, pca_noise=0.1)
    outs = []
    for pkg in (jmx, tmx):
        chain = pkg.image.CreateAugmenter((3, 24, 24), **kw)
        random.seed(7)
        onp.random.seed(7)
        img = pkg.image.imdecode(buf)
        for aug in chain:
            img = aug(img)
        outs.append(([a.dumps() for a in chain], img.asnumpy()))
    assert outs[0][0] == outs[1][0]
    onp.testing.assert_allclose(outs[1][1], outs[0][1], rtol=0, atol=1e-4)


def test_image_iter_matches_reference(tmp_path):
    path = str(tmp_path / "c.rec")
    jtu.write_rec_corpus(path, n=11, size=20, seed=6)
    outs = []
    for pkg in (jmx, tmx):
        random.seed(3)
        it = pkg.image.ImageIter(batch_size=4, data_shape=(3, 16, 16),
                                 path_imgrec=path, shuffle=True,
                                 rand_crop=True, rand_mirror=True)
        got = []
        for epoch in range(2):
            if epoch:
                it.reset()
            for b in it:
                got.append((b.data[0].asnumpy(), b.label[0].asnumpy(),
                            b.pad))
        it.close()
        outs.append(got)
    assert len(outs[0]) == len(outs[1]) == 6
    for (jd, jl, jp), (td, tl, tp) in zip(*outs):
        assert jp == tp
        onp.testing.assert_array_equal(td, jd)
        onp.testing.assert_array_equal(tl, jl)
    assert outs[1][-1][0].shape == (4, 3, 16, 16)
