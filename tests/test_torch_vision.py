"""``gluon.data.vision`` of the port held against the JAX package's on
the CPU.

- Datasets over files the test writes (IDX plain and gzipped, CIFAR-10
  and CIFAR-100 binary batches, a ``.rec`` with its ``.idx``, an image
  folder): every item's image and label equal the reference's bit for
  bit, with a transform too; a missing file raises the reference's
  error (nothing is downloaded).
- The deterministic transforms (``Cast``, ``ToTensor``, ``Normalize``,
  ``CenterCrop``, ``Compose``) equal the reference's bit for bit;
  ``Resize`` (``jax.image.resize``'s antialiased bilinear weights,
  computed the same way in float32, contracted in another order) to
  2e-5 of the largest value on float images and within one unit on
  uint8 ones, and nearest exactly.
- The random transforms draw from ``mx.random``'s generator (the
  reference from numpy's): their outputs' statistics over 400 draws
  agree with the reference's (flip and gray shares within 0.1, crop
  sides' and jitter outputs' means within 4 standard errors, spreads
  within 20 %), and a seed repeats the port's draws exactly.
"""
import gzip
import os
import struct

import numpy as onp
import pytest

import jax

jax.config.update("jax_platforms", "cpu")

import mxnet_tpu as jmx  # noqa: E402
from mxnet_tpu.gluon.data.vision import transforms as JT  # noqa: E402

import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu_torch.base import MXNetError  # noqa: E402
from mxnet_tpu_torch.gluon.data.vision import transforms as TT  # noqa: E402


@pytest.fixture(autouse=True)
def _host():
    with tmx.cpu():
        yield


def write_idx(path, arr):
    """An IDX file of the uint8 array ``arr`` (gzipped for ``.gz``)."""
    head = struct.pack(">I", 0x0800 | arr.ndim) + struct.pack(
        ">" + "I" * arr.ndim, *arr.shape)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(head + arr.astype(onp.uint8).tobytes())


def write_mnist(root, n=20, seed=0, gz=False, prefix=("train", "t10k")):
    rng = onp.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    sfx = ".gz" if gz else ""
    for split in prefix:
        write_idx(os.path.join(root, f"{split}-images-idx3-ubyte{sfx}"),
                  rng.randint(0, 256, (n, 28, 28)))
        write_idx(os.path.join(root, f"{split}-labels-idx1-ubyte{sfx}"),
                  rng.randint(0, 10, n))


def _items(ds):
    out = []
    for i in range(len(ds)):
        img, lab = ds[i]
        out.append((img.asnumpy() if hasattr(img, "asnumpy") else img,
                    onp.asarray(lab)))
    return out


def _same_items(a, b):
    assert len(a) == len(b) > 0
    for (ia, la), (ib, lb) in zip(a, b):
        assert ia.dtype == ib.dtype and ia.shape == ib.shape
        onp.testing.assert_array_equal(ia, ib)
        onp.testing.assert_array_equal(la, lb)


@pytest.mark.parametrize("name,gz", [("MNIST", False), ("MNIST", True),
                                     ("FashionMNIST", False)])
def test_mnist_datasets_match_reference(tmp_path, name, gz):
    root = str(tmp_path / "m")
    write_mnist(root, gz=gz)
    for train in (True, False):
        got = getattr(tmx.gluon.data.vision, name)(root=root, train=train)
        want = getattr(jmx.gluon.data.vision, name)(root=root, train=train)
        _same_items(_items(got), _items(want))
    ds = tmx.gluon.data.vision.MNIST(root=root, transform=lambda x, y: (
        x.astype("float32") / 255, y + 1))
    img, lab = ds[3]
    raw = tmx.gluon.data.vision.MNIST(root=root)[3]
    onp.testing.assert_array_equal(img.asnumpy(),
                                   raw[0].asnumpy().astype("float32") / 255)
    assert lab == raw[1] + 1 and raw[0].context == tmx.cpu()


def test_missing_files_raise_the_reference_error(tmp_path):
    empty = str(tmp_path / "none")
    os.makedirs(empty)
    for cls in ("MNIST", "CIFAR10", "CIFAR100"):
        with pytest.raises(MXNetError, match="not found"):
            getattr(tmx.gluon.data.vision, cls)(root=empty)
        with pytest.raises(Exception, match="not found"):
            getattr(jmx.gluon.data.vision, cls)(root=empty)


def test_cifar_datasets_match_reference(tmp_path):
    rng = onp.random.RandomState(1)
    c10 = tmp_path / "c10" / "cifar-10-batches-bin"
    os.makedirs(c10)
    for name in [f"data_batch_{i}.bin" for i in range(1, 6)] + \
            ["test_batch.bin"]:
        rows = onp.concatenate([rng.randint(0, 10, (4, 1)),
                                rng.randint(0, 256, (4, 3072))], 1)
        (c10 / name).write_bytes(rows.astype(onp.uint8).tobytes())
    c100 = tmp_path / "c100"
    os.makedirs(c100)
    for name in ("train.bin", "test.bin"):
        rows = onp.concatenate([rng.randint(0, 20, (5, 1)),
                                rng.randint(0, 100, (5, 1)),
                                rng.randint(0, 256, (5, 3072))], 1)
        (c100 / name).write_bytes(rows.astype(onp.uint8).tobytes())
    for train in (True, False):
        _same_items(
            _items(tmx.gluon.data.vision.CIFAR10(root=str(tmp_path / "c10"),
                                                 train=train)),
            _items(jmx.gluon.data.vision.CIFAR10(root=str(tmp_path / "c10"),
                                                 train=train)))
        for fine in (False, True):
            kw = dict(root=str(c100), train=train, fine_label=fine)
            _same_items(_items(tmx.gluon.data.vision.CIFAR100(**kw)),
                        _items(jmx.gluon.data.vision.CIFAR100(**kw)))


def _jpeg(rng, h, w):
    import io

    from PIL import Image

    bio = io.BytesIO()
    Image.fromarray((rng.rand(h, w, 3) * 255).astype("uint8")).save(
        bio, format="JPEG", quality=90)
    return bio.getvalue()


def test_image_record_and_folder_datasets_match_reference(tmp_path):
    rng = onp.random.RandomState(2)
    rec, idx = str(tmp_path / "d.rec"), str(tmp_path / "d.idx")
    w = tmx.recordio.MXIndexedRecordIO(idx, rec, "w")
    for i in range(6):
        w.write_idx(i, tmx.recordio.pack(
            tmx.recordio.IRHeader(0, float(i % 3), i, 0),
            _jpeg(rng, 20 + i, 30)))
    w.close()
    _same_items(_items(tmx.gluon.data.vision.ImageRecordDataset(rec)),
                _items(jmx.gluon.data.vision.ImageRecordDataset(rec)))
    root = tmp_path / "folder"
    for c in ("cat", "dog"):
        os.makedirs(root / c)
        for i in range(3):
            (root / c / f"{i}.jpg").write_bytes(_jpeg(rng, 16, 12 + i))
        (root / c / "notes.txt").write_text("skipped")
    got = tmx.gluon.data.vision.ImageFolderDataset(str(root))
    want = jmx.gluon.data.vision.ImageFolderDataset(str(root))
    assert got.synsets == want.synsets == ["cat", "dog"]
    assert [lab for _, lab in got.items] == [lab for _, lab in want.items]
    _same_items(_items(got), _items(want))


def _image(seed, h=21, w=17, dtype="uint8"):
    rng = onp.random.RandomState(seed)
    return (rng.rand(h, w, 3) * 255).astype(dtype)


def _apply(pkg, t, x):
    return t(pkg.nd.array(x, dtype=str(x.dtype))).asnumpy()


DETERMINISTIC = {
    "cast": lambda T: T.Cast("float16"),
    "to_tensor": lambda T: T.ToTensor(),
    "normalize": lambda T: T.Normalize((0.4, 0.5, 0.6), (0.2, 0.25, 0.3)),
    "center_crop": lambda T: T.CenterCrop((10, 8)),
    "compose": lambda T: T.Compose([T.CenterCrop(9), T.ToTensor(),
                                    T.Normalize(0.5, 0.25)]),
}


@pytest.mark.parametrize("name", list(DETERMINISTIC))
def test_deterministic_transforms_bit_for_bit(name):
    x = _image(3)
    if name == "normalize":
        x = onp.transpose(x, (2, 0, 1)).astype("float32") / 255
    want = _apply(jmx, DETERMINISTIC[name](JT), x)
    got = _apply(tmx, DETERMINISTIC[name](TT), x)
    assert got.dtype == want.dtype and got.shape == want.shape
    onp.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("size,interp", [((9, 7), 1), ((40, 33), 1),
                                         (12, 1), ((9, 30), 0),
                                         ((25, 8), 0)])
def test_resize_matches_reference(size, interp):
    xf = _image(4, dtype="float32")
    want = _apply(jmx, JT.Resize(size, interpolation=interp), xf)
    got = _apply(tmx, TT.Resize(size, interpolation=interp), xf)
    assert got.shape == want.shape
    if interp == 0:
        onp.testing.assert_array_equal(got, want)
    else:
        assert onp.abs(got - want).max() <= 2e-5 * onp.abs(want).max()
    xu = _image(5)
    want = _apply(jmx, JT.Resize(size, interpolation=interp), xu)
    got = _apply(tmx, TT.Resize(size, interpolation=interp), xu)
    assert got.dtype == onp.uint8
    assert onp.abs(got.astype(int) - want.astype(int)).max() <= (
        0 if interp == 0 else 1)
    # keep_ratio and a crop of an image smaller than the crop
    for T, pkg in ((JT, jmx), (TT, tmx)):
        assert _apply(pkg, T.Resize(10, keep_ratio=True), xu).shape == \
            (12, 10, 3)
        assert _apply(pkg, T.CenterCrop(30), xu).shape == (30, 30, 3)


def _draws(pkg, T, make, x, n=400):
    if pkg is jmx:
        onp.random.seed(0)
    else:
        tmx.random.seed(0)
    t = make(T)
    return [_apply(pkg, t, x) for _ in range(n)]


RANDOM = {
    "flip_lr": lambda T: T.RandomFlipLeftRight(),
    "flip_tb": lambda T: T.RandomFlipTopBottom(),
    "gray": lambda T: T.RandomGray(0.3),
    "brightness": lambda T: T.RandomBrightness(0.4),
    "contrast": lambda T: T.RandomContrast(0.4),
    "saturation": lambda T: T.RandomSaturation(0.4),
    "hue": lambda T: T.RandomHue(0.2),
    "color_jitter": lambda T: T.RandomColorJitter(0.2, 0.2, 0.2, 0.1),
    "lighting": lambda T: T.RandomLighting(0.1),
    "resized_crop": lambda T: T.RandomResizedCrop((8, 6)),
}


@pytest.mark.parametrize("name", list(RANDOM))
def test_random_transforms_match_reference_statistics(name):
    x = _image(6, h=12, w=10)
    j = onp.stack(_draws(jmx, JT, RANDOM[name], x)).astype("float64")
    t = onp.stack(_draws(tmx, TT, RANDOM[name], x)).astype("float64")
    assert j.shape == t.shape and _draws(tmx, TT, RANDOM[name], x, 1)[0] \
        .dtype == _draws(jmx, JT, RANDOM[name], x, 1)[0].dtype
    if name in ("flip_lr", "flip_tb", "gray"):
        changed = lambda d: (onp.abs(d - x).reshape(len(d), -1)  # noqa
                             .max(axis=1) > 0).mean()
        assert abs(changed(t) - changed(j)) < 0.1
    else:
        # each draw's mean over its pixels: the two samples' means within
        # 4 standard errors, their spreads within 20 %; and the per-pixel
        # spread over the draws within 20 %
        mj = j.reshape(len(j), -1).mean(axis=1)
        mt = t.reshape(len(t), -1).mean(axis=1)
        se = onp.sqrt((mj.var() + mt.var()) / len(mj))
        assert abs(mt.mean() - mj.mean()) <= 4 * se + 1e-6
        assert abs(mt.std() - mj.std()) <= 0.2 * mj.std() + 1e-6
        spread = j.std(axis=0).mean()
        assert abs(t.std(axis=0).mean() - spread) <= 0.2 * spread + 1e-6
    again = onp.stack(_draws(tmx, TT, RANDOM[name], x))
    onp.testing.assert_array_equal(again, t)  # mx.random.seed repeats


def test_dataloader_with_vision_transform(tmp_path):
    root = str(tmp_path / "m")
    write_mnist(root, n=12)
    ds = tmx.gluon.data.vision.MNIST(root=root).transform_first(
        TT.Compose([TT.ToTensor(), TT.Normalize(0.13, 0.31)]))
    batches = list(tmx.gluon.data.DataLoader(ds, batch_size=5))
    assert [b[0].shape for b in batches] == [(5, 1, 28, 28)] * 2 + \
        [(2, 1, 28, 28)]
    jds = jmx.gluon.data.vision.MNIST(root=root).transform_first(
        JT.Compose([JT.ToTensor(), JT.Normalize(0.13, 0.31)]))
    jb = list(jmx.gluon.data.DataLoader(jds, batch_size=5))
    for a, b in zip(batches, jb):
        onp.testing.assert_array_equal(a[0].asnumpy(), b[0].asnumpy())
        onp.testing.assert_array_equal(a[1].asnumpy(), b[1].asnumpy())


def write_synth_mnist(root, n_train=512, n_test=128):
    """IDX files of the reference's synthetic digits (``train_mnist.
    synth``) as uint8 images."""
    from mxnet_tpu_torch.example import train_mnist

    os.makedirs(root, exist_ok=True)
    for split, n, seed in (("train", n_train, 1), ("t10k", n_test, 2)):
        ds = train_mnist.synth(n, seed)
        x = onp.stack([ds[i][0] for i in range(n)])[..., 0]
        y = onp.array([ds[i][1] for i in range(n)])
        write_idx(os.path.join(root, f"{split}-images-idx3-ubyte"),
                  onp.round(onp.clip(x, 0, 1) * 255))
        write_idx(os.path.join(root, f"{split}-labels-idx1-ubyte"), y)


def test_train_mnist_example_with_data_dir(tmp_path):
    """``train_mnist.py --data-dir`` reads the IDX files through
    ``gluon.data.vision.MNIST`` and learns the digits there."""
    from mxnet_tpu_torch.example import train_mnist

    root = str(tmp_path / "mnist")
    write_synth_mnist(root, n_train=1024)
    res = train_mnist.main(["--data-dir", root, "--ctx", "cpu",
                            "--epochs", "2", "--network", "mlp"])
    assert res["steps"] == 32
    assert res["epochs"][1]["loss"] < res["epochs"][0]["loss"]
    assert res["val_acc"] >= 0.9
