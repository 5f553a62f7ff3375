"""The port's detection ops (``ops/detection_ops.py``), contrib ops
(``ops/contrib_ops.py``) and ``mx.nd.contrib`` held against the JAX
package on the CPU.

Inputs are numpy from a seed: the fixtures of ``tests/test_detection.py``
and random inputs at SSD-300's 7,478 anchors (feature maps 37, 18, 9,
5, 3 and 2).  Tolerances (fp32):

- anchors, IOUs, ids, kept sets, positives, ``loc_mask`` and the
  positive class targets exactly; ``loc_target`` within 2 ulps (the
  packages' ``log`` differ by one: 2.4e-7 seen), boxes and scores to
  1e-5 (``exp``: 1.2e-7 seen);
- ``MultiBoxTarget``'s negatives (hard-negative mining ranks anchors by
  a softmax, which the packages sum in other orders): equal, except
  anchors whose background probability lies within a relative 1e-6 of
  the ``num_neg``-th; the count of such anchors is asserted (0 seen);
- RoI ops' outputs and data gradients to 1e-5 of each tensor's largest
  magnitude, with tied maxima (a constant image) and empty bins;
- ``Proposal``: rows 0 … post - 2 and their scores to 1e-5; its last
  row is a divergence, pinned (the reference writes every unselected
  box there; the port keeps the post-th kept box, upstream's intent);
- contrib ops to 1e-5 (FFT: 1e-5 of the largest magnitude), their
  gradients likewise.
"""
import inspect

import numpy as onp
import pytest
import torch

import jax

jax.config.update("jax_platforms", "cpu")

import mxnet_tpu as jmx  # noqa: E402
from mxnet_tpu.ops import registry as j_reg  # noqa: E402

import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu_torch.base import MXNetError  # noqa: E402
from mxnet_tpu_torch.ops import registry as t_reg  # noqa: E402

TOL = 1e-5
#: the feature-map sides of SSD-300 (VGG16-reduced, the reference's
#: floor pooling) and the zoo's default sizes and ratios
SSD300_MAPS = (37, 18, 9, 5, 3, 2)
SSD_SIZES = [[0.1, 0.141], [0.2, 0.272], [0.37, 0.447], [0.54, 0.619],
             [0.71, 0.79], [0.88, 0.961]]
SSD_RATIOS = [[1, 2, 0.5]] * 2 + [[1, 2, 0.5, 3, 1.0 / 3]] * 3 + \
    [[1, 2, 0.5]]
SSD300_ANCHORS = 7478


@pytest.fixture(autouse=True)
def _host():
    with tmx.cpu():
        yield


def _rel(got, want):
    got, want = onp.asarray(got, "float64"), onp.asarray(want, "float64")
    return float(onp.abs(got - want).max() / max(onp.abs(want).max(),
                                                 1e-30))


def _run(pkg, name, arrays, grad_of=(), head_seed=9, **params):
    """Outputs (and the gradients of ``arrays[grad_of]`` under a seeded
    head on the first output) of op ``name`` in package ``pkg``."""
    xs = [pkg.nd.array(a, dtype=a.dtype) for a in arrays]
    for i in grad_of:
        xs[i].attach_grad()
    with pkg.autograd.record():
        out = pkg.nd.invoke(name, xs, **params)
    outs = out if isinstance(out, (list, tuple)) else [out]
    grads = []
    if grad_of:
        head = onp.random.RandomState(head_seed).randn(
            *outs[0].shape).astype("float32")
        outs[0].backward(pkg.nd.array(head))
        grads = [xs[i].grad.asnumpy() for i in grad_of]
    return [o.asnumpy() for o in outs], grads


def _both(name, arrays, grad_of=(), **params):
    return (_run(jmx, name, arrays, grad_of, **params),
            _run(tmx, name, arrays, grad_of, **params))


# ------------------------------------------------------ SSD-300 inputs
def _ssd300_anchors():
    return onp.concatenate([
        _run(tmx, "_contrib_MultiBoxPrior",
             [onp.zeros((1, 1, s, s), "float32")],
             sizes=tuple(SSD_SIZES[i]), ratios=tuple(SSD_RATIOS[i]))[0][0]
        for i, s in enumerate(SSD300_MAPS)], axis=1)


def _labels(batch, m, classes, seed):
    """The example's synthetic boxes: 1 or 2 gts an image (m - 1 or m - 2
    rows of -1 padding), plus ``m`` gts in the last image."""
    rs = onp.random.RandomState(seed)
    lab = onp.full((batch, m, 5), -1.0, "float32")
    for i in range(batch):
        n = m if i == batch - 1 else rs.randint(1, 3)
        for b in range(n):
            x1, y1 = rs.uniform(0.0, 0.6, 2)
            w, h = rs.uniform(0.2, 0.4, 2)
            lab[i, b] = [rs.randint(0, classes), x1, y1, min(x1 + w, 1.0),
                         min(y1 + h, 1.0)]
    return lab


def _bg_prob(cls_pred):
    z = cls_pred.astype("float64")
    e = onp.exp(z - z.max(axis=1, keepdims=True))
    return e[:, 0] / e.sum(axis=1)


def _hold_targets(t, j, cls_pred):
    """Positives, masks and targets as the module docstring states; the
    negatives equal but at the ``num_neg`` boundary.  Returns the count
    of anchors whose negative label differs there."""
    (t_loc, t_mask, t_cls), (j_loc, j_mask, j_cls) = t, j
    onp.testing.assert_array_equal(t_mask, j_mask)
    onp.testing.assert_array_equal(t_cls > 0, j_cls > 0)
    onp.testing.assert_array_equal(t_cls[j_cls > 0], j_cls[j_cls > 0])
    # exact but for the packages' log, which differ by an ulp
    onp.testing.assert_array_max_ulp(t_loc, j_loc, maxulp=2)
    bg = _bg_prob(cls_pred)
    boundary = 0
    for b in range(t_cls.shape[0]):
        t_neg, j_neg = t_cls[b] == 0, j_cls[b] == 0
        assert t_neg.sum() == j_neg.sum()
        differ = onp.flatnonzero(t_neg != j_neg)
        if len(differ):
            edge = bg[b][j_neg].max()  # the num_neg-th score
            assert onp.all(onp.abs(bg[b][differ] - edge)
                           <= 1e-6 * abs(edge)), (b, differ)
            boundary += len(differ)
    return boundary


def test_ssd300_anchor_count_and_values():
    anchors = _ssd300_anchors()
    assert anchors.shape == (1, SSD300_ANCHORS, 4)
    for i, s in enumerate(SSD300_MAPS):
        j, t = _both("_contrib_MultiBoxPrior",
                     [onp.zeros((2, 3, s, s + 1), "float32")],
                     sizes=tuple(SSD_SIZES[i]), ratios=tuple(SSD_RATIOS[i]),
                     clip=bool(i % 2))
        onp.testing.assert_array_equal(t[0][0], j[0][0])


@pytest.mark.parametrize("mining", [3.0, -1.0])
@pytest.mark.parametrize("m,seed", [(3, 0), (8, 1)])
def test_multibox_target_at_ssd300(mining, m, seed):
    anchors = _ssd300_anchors()
    labels = _labels(4, m, 20, seed)
    cls_pred = onp.random.RandomState(seed + 10).randn(
        4, 21, SSD300_ANCHORS).astype("float32")
    (j, _), (t, _) = _both("_contrib_MultiBoxTarget",
                           [anchors, labels, cls_pred],
                           overlap_threshold=0.5,
                           negative_mining_ratio=mining,
                           negative_mining_thresh=0.5)
    assert t[2].shape == (4, SSD300_ANCHORS)
    assert _hold_targets(t, j, cls_pred) == 0
    assert (t[2] > 0).sum(axis=1).min() >= 1


def test_multibox_target_ties_in_mining():
    """Equal background probabilities everywhere (constant logits): the
    stable order takes the lowest-index candidates, as the reference."""
    anchors = _ssd300_anchors()
    labels = _labels(2, 3, 20, 4)
    cls_pred = onp.zeros((2, 21, SSD300_ANCHORS), "float32")
    (j, _), (t, _) = _both("_contrib_MultiBoxTarget",
                           [anchors, labels, cls_pred],
                           negative_mining_ratio=3.0,
                           minimum_negative_samples=5)
    for a, b in zip(t, j):
        onp.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)
    onp.testing.assert_array_equal(t[2], j[2])


def _detection_inputs(batch, seed):
    rs = onp.random.RandomState(seed)
    logits = rs.randn(batch, 21, SSD300_ANCHORS).astype("float32") * 3
    e = onp.exp(logits - logits.max(axis=1, keepdims=True))
    prob = (e / e.sum(axis=1, keepdims=True)).astype("float32")
    loc = (rs.randn(batch, SSD300_ANCHORS * 4) * 0.5).astype("float32")
    return prob, loc


def _hold_detections(t, j):
    onp.testing.assert_array_equal(t[..., 0], j[..., 0])  # ids, kept set
    onp.testing.assert_allclose(t[..., 1:], j[..., 1:], rtol=TOL,
                                atol=TOL)


@pytest.mark.parametrize("params", [
    dict(nms_topk=400, threshold=0.01, nms_threshold=0.45),
    dict(nms_topk=400, force_suppress=True, clip=False),
    dict(nms_topk=-1, threshold=0.2, nms_threshold=0.5, background_id=3)])
def test_multibox_detection_at_ssd300(params):
    anchors = _ssd300_anchors()
    prob, loc = _detection_inputs(2, 3)
    (j, _), (t, _) = _both("_contrib_MultiBoxDetection",
                           [prob, loc, anchors], **params)
    assert t[0].shape == (2, SSD300_ANCHORS, 6)
    _hold_detections(t[0], j[0])
    assert (t[0][..., 0] >= 0).sum() > 10


def _nms_rows(batch, n, seed, classes=5):
    rs = onp.random.RandomState(seed)
    xy = rs.rand(batch, n, 2).astype("float32")
    wh = (rs.rand(batch, n, 2) * 0.3 + 0.02).astype("float32")
    score = rs.rand(batch, n, 1).astype("float32")
    half = n // 2
    score[:, 1::2] = score[:, 0:2 * half:2]  # ties, pair by pair
    ids = rs.randint(-1, classes, (batch, n, 1)).astype("float32")
    return onp.concatenate([ids, score, xy, xy + wh], axis=-1)


@pytest.mark.parametrize("params", [
    dict(topk=400, overlap_thresh=0.45, valid_thresh=0.01, id_index=0),
    dict(topk=400, overlap_thresh=0.45, id_index=0, background_id=0),
    dict(topk=-1, overlap_thresh=0.3, force_suppress=True, id_index=0),
    dict(topk=-1, overlap_thresh=0.5, id_index=-1),
])
def test_box_nms_at_ssd300(params):
    n = SSD300_ANCHORS if params["topk"] > 0 else 600
    rows = _nms_rows(2, n, 5)
    (j, _), (t, _) = _both("_contrib_box_nms", [rows], **params)
    onp.testing.assert_array_equal(t[0], j[0])


@pytest.mark.parametrize("fmt", [("corner", "center"), ("center", "corner"),
                                 ("center", "center")])
def test_box_nms_formats_and_batch_shape(fmt):
    rows = _nms_rows(6, 50, 6).reshape(2, 3, 50, 6)
    (j, _), (t, _) = _both("box_nms", [rows], in_format=fmt[0],
                           out_format=fmt[1], coord_start=2,
                           score_index=1, id_index=0)
    onp.testing.assert_allclose(t[0], j[0], rtol=TOL, atol=TOL)
    onp.testing.assert_array_equal(t[0] == -1, j[0] == -1)


def test_box_iou_at_ssd300():
    anchors = _ssd300_anchors()
    gts = _labels(4, 3, 20, 2)[..., 1:]
    (j, _), (t, _) = _both("_contrib_box_iou", [anchors[0], gts])
    assert t[0].shape == (SSD300_ANCHORS, 4, 3)
    onp.testing.assert_allclose(t[0], j[0], rtol=TOL, atol=TOL)


def test_box_iou_shapes_and_formats():
    rs = onp.random.RandomState(2)
    a = onp.concatenate([rs.rand(3, 4, 2), rs.rand(3, 4, 2) + 1], -1)
    b = onp.concatenate([rs.rand(5, 2), rs.rand(5, 2) + 1], -1)
    for fmt in ("corner", "center"):
        (j, _), (t, _) = _both("_contrib_box_iou", [a.astype("float32"),
                                                    b.astype("float32")],
                               format=fmt)
        assert t[0].shape == (3, 4, 5)
        onp.testing.assert_allclose(t[0], j[0], rtol=TOL, atol=TOL)


# ------------------------------------------ the reference's fixtures
def _fixture_cases():
    f32 = lambda a: onp.array(a, "float32")  # noqa: E731
    n = 8
    mining_anchors = onp.zeros((1, n, 4), "float32")
    mining_anchors[0, :, 0] = onp.linspace(0, 0.7, n)
    mining_anchors[0, :, 2] = mining_anchors[0, :, 0] + 0.1
    mining_anchors[0, :, 3] = 0.1
    img = onp.arange(16, dtype="float32").reshape(1, 1, 4, 4)
    rows = f32([[0, 0.9, 0.0, 0.0, 1.0, 1.0], [0, 0.8, 0.05, 0.05, 1.0, 1.0],
                [0, 0.7, 2.0, 2.0, 3.0, 3.0]])[None]
    rs = onp.random.RandomState(5)
    return {
        "prior": ("_contrib_MultiBoxPrior", [onp.zeros((1, 3, 2, 2), "f4")],
                  dict(sizes=(0.5,), ratios=(1.0,))),
        "prior_many": ("_contrib_MultiBoxPrior",
                       [onp.zeros((1, 3, 2, 2), "f4")],
                       dict(sizes=(0.5, 0.25), ratios=(1.0, 2.0, 0.5))),
        "prior_clip": ("_contrib_MultiBoxPrior",
                       [onp.zeros((1, 3, 1, 2), "f4")],
                       dict(sizes=(1.0,), ratios=(1.0,), clip=True)),
        "prior_steps": ("_contrib_MultiBoxPrior",
                        [onp.zeros((1, 3, 3, 5), "f4")],
                        dict(sizes=(0.3,), ratios=(1.0, 2.0),
                             steps=(0.25, 0.2), offsets=(0.4, 0.6))),
        "iou": ("_contrib_box_iou", [f32([[0, 0, 2, 2]]),
                                     f32([[1, 1, 3, 3], [0, 0, 2, 2],
                                          [4, 4, 5, 5]])], {}),
        "nms": ("_contrib_box_nms", [rows],
                dict(overlap_thresh=0.5, valid_thresh=0.0, id_index=0,
                     score_index=1, coord_start=2)),
        "nms_force": ("_contrib_box_nms",
                      [f32([[0, 0.9, 0, 0, 1, 1], [1, 0.8, 0.05, 0.05, 1, 1]])
                       [None]],
                      dict(overlap_thresh=0.5, id_index=0, score_index=1,
                           coord_start=2, force_suppress=True)),
        "target": ("_contrib_MultiBoxTarget",
                   [f32([[[0.1, 0.1, 0.4, 0.4], [0.6, 0.6, 0.9, 0.9]]]),
                    f32([[[1, 0.1, 0.1, 0.4, 0.4]]]),
                    onp.zeros((1, 3, 2), "f4")],
                   dict(overlap_threshold=0.5, negative_mining_ratio=-1.0)),
        "target_encoding": ("_contrib_MultiBoxTarget",
                            [f32([[[0.0, 0.0, 0.5, 0.5]]]),
                             f32([[[0, 0.1, 0.1, 0.5, 0.5]]]),
                             onp.zeros((1, 2, 1), "f4")],
                            dict(overlap_threshold=0.5,
                                 negative_mining_ratio=-1.0)),
        "target_mining": ("_contrib_MultiBoxTarget",
                          [mining_anchors, f32([[[0, 0.0, 0.0, 0.1, 0.1]]]),
                           rs.randn(1, 3, n).astype("f4")],
                          dict(overlap_threshold=0.5,
                               negative_mining_ratio=3.0,
                               negative_mining_thresh=0.5)),
        "detection": ("_contrib_MultiBoxDetection",
                      [f32([[[0.1, 0.8], [0.2, 0.1], [0.7, 0.1]]]),
                       onp.zeros((1, 8), "f4"),
                       f32([[[0.2, 0.2, 0.4, 0.4], [0.6, 0.6, 0.8, 0.8]]])],
                      dict(threshold=0.05, nms_threshold=0.5)),
        "roi_pooling": ("ROIPooling", [img, f32([[0, 0, 0, 3, 3]])],
                        dict(pooled_size=(2, 2), spatial_scale=1.0)),
        "roi_align": ("_contrib_ROIAlign", [img, f32([[0, 0, 0, 2, 2]])],
                      dict(pooled_size=(1, 1), spatial_scale=1.0,
                           sample_ratio=1)),
    }


FIXTURES = _fixture_cases()


@pytest.mark.parametrize("case", sorted(FIXTURES))
def test_reference_fixtures_match(case):
    name, arrays, params = FIXTURES[case]
    (j, _), (t, _) = _both(name, arrays, **params)
    assert len(t) == len(j)
    for a, b in zip(t, j):
        assert a.shape == b.shape
        onp.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)


def test_reference_fixture_values_hold_in_the_port():
    """The hand-computed values of ``tests/test_detection.py``."""
    (a,), _ = _run(tmx, *FIXTURES["prior"][:2], **FIXTURES["prior"][2])
    onp.testing.assert_allclose(a[0, 1], [0.5, 0.0, 1.0, 0.5], atol=1e-6)
    (out,), _ = _run(tmx, *FIXTURES["nms"][:2], **FIXTURES["nms"][2])
    assert out[0, 1, 1] == pytest.approx(0.7) and (out[0, 2] == -1).all()
    (loc, mask, cls), _ = _run(tmx, *FIXTURES["target"][:2],
                               **FIXTURES["target"][2])
    assert cls[0].tolist() == [2.0, 0.0]
    onp.testing.assert_array_equal(mask[0], [1, 1, 1, 1, 0, 0, 0, 0])
    (_, _, cls), _ = _run(tmx, *FIXTURES["target_mining"][:2],
                          **FIXTURES["target_mining"][2])
    assert [(cls == v).sum() for v in (1, 0, -1)] == [1, 3, 4]
    (r,), _ = _run(tmx, *FIXTURES["roi_pooling"][:2],
                   **FIXTURES["roi_pooling"][2])
    onp.testing.assert_array_equal(r[0, 0], [[5, 7], [13, 15]])
    rs = onp.random.RandomState(5)
    (r,), _ = _run(tmx, "_contrib_Proposal", [
        rs.rand(1, 18, 4, 4).astype("f4"),
        (rs.randn(1, 36, 4, 4) * 0.1).astype("f4"),
        onp.array([[64, 64, 1.0]], "f4")], scales=(2, 4, 8),
        ratios=(0.5, 1, 2), rpn_post_nms_top_n=10, rpn_min_size=1)
    assert r.shape == (10, 5) and (r[:, 0] == 0).all()
    assert (r[:, 1:] >= 0).all() and (r[:, [1, 3]] <= 63).all()


# ------------------------------------------------------------ RoI ops
def _roi_inputs(kind, seed=7):
    rs = onp.random.RandomState(seed)
    data = rs.randn(2, 8, 12, 14).astype("float32")
    if kind == "constant":  # every bin's maximum tied
        data = onp.full_like(data, 0.5)
    if kind == "ties":  # pairs of equal pixels
        data = onp.round(data * 2) / 2
    rois = onp.array([
        [0, 1.0, 1.5, 9.0, 8.0], [1, 0.0, 0.0, 13.0, 11.0],
        [1, 4.2, 3.3, 6.1, 5.9], [0, 10.0, 9.0, 22.0, 20.0],  # bins past
        [0, -5.0, -4.0, 3.0, 2.0], [1, 7.7, 2.2, 7.9, 2.4]],  # the edge
        "float32")
    return data, rois


@pytest.mark.parametrize("kind", ["random", "ties", "constant"])
@pytest.mark.parametrize("scale,pooled", [(1.0, (2, 2)), (0.5, (3, 4)),
                                          (1.0, (7, 7))])
def test_roi_pooling_forward_and_gradient(kind, scale, pooled):
    data, rois = _roi_inputs(kind)
    (j, jg), (t, tg) = _both("ROIPooling", [data, rois], grad_of=(0,),
                             pooled_size=pooled, spatial_scale=scale)
    assert _rel(t[0], j[0]) <= TOL
    assert _rel(tg[0], jg[0]) <= TOL
    if kind == "constant":  # a tied maximum shares its gradient evenly
        assert onp.unique(onp.round(tg[0][tg[0] != 0], 6)).size > 1


def test_roi_pooling_empty_bins_are_zero():
    data, rois = _roi_inputs("random")
    (t,), _ = _run(tmx, "ROIPooling", [data, rois[3:4]],
                   pooled_size=(4, 4), spatial_scale=1.0)
    assert (t[0, :, -1, -1] == 0).all()


@pytest.mark.parametrize("params", [
    dict(pooled_size=(2, 2), spatial_scale=1.0),
    dict(pooled_size=(3, 3), spatial_scale=0.5, sample_ratio=3),
    dict(pooled_size=(7, 7), spatial_scale=1.0, aligned=True),
    dict(pooled_size=(2, 2), spatial_scale=1.0, position_sensitive=True),
])
@pytest.mark.parametrize("kind", ["random", "constant"])
def test_roi_align_forward_and_gradient(params, kind):
    data, rois = _roi_inputs(kind)
    (j, jg), (t, tg) = _both("_contrib_ROIAlign", [data, rois],
                             grad_of=(0,), **params)
    assert t[0].shape == j[0].shape
    assert _rel(t[0], j[0]) <= TOL
    assert _rel(tg[0], jg[0]) <= TOL


# ----------------------------------------------------------- Proposal
def _proposal_inputs(a=12, side=20, seed=0):
    rs = onp.random.RandomState(seed)
    cls_prob = rs.rand(1, 2 * a, side, side).astype("float32")
    bbox = (rs.randn(1, 4 * a, side, side) * 0.1).astype("float32")
    return [cls_prob, bbox, onp.array([[side * 16, side * 16, 1.0]],
                                      "float32")]


PROPOSAL = dict(rpn_pre_nms_top_n=2000, threshold=0.7, rpn_min_size=4,
                output_score=True)


@pytest.mark.parametrize("post", [300, 50])
def test_proposal_matches_reference_but_its_last_row(post):
    """Rows 0 … post - 2 equal the reference's.  The last is pinned as a
    divergence: the reference writes every unselected box to row
    post - 1 (its index clipped before a dropping scatter), so that row
    is zeros there; the port keeps the post-th kept box, which is the
    reference's row post - 1 when it is asked for one row more."""
    inputs = _proposal_inputs()
    (j, _), (t, _) = _both("_contrib_Proposal", inputs,
                           rpn_post_nms_top_n=post, **PROPOSAL)
    assert t[0].shape == (post, 5) and t[1].shape == (post, 1)
    onp.testing.assert_allclose(t[0][:-1], j[0][:-1], rtol=TOL, atol=TOL)
    onp.testing.assert_allclose(t[1][:-1], j[1][:-1], rtol=TOL, atol=TOL)
    assert (j[0][-1, 1:] == 0).all() and j[1][-1, 0] == 0
    (rois, scores), _ = _run(jmx, "_contrib_Proposal", inputs,
                             rpn_post_nms_top_n=post + 1, **PROPOSAL)
    onp.testing.assert_allclose(t[0][-1], rois[post - 1], rtol=TOL,
                                atol=TOL)
    onp.testing.assert_allclose(t[1][-1], scores[post - 1], rtol=TOL,
                                atol=TOL)
    assert (t[0][-1, 1:] != 0).any()


def test_proposal_fewer_kept_than_post_gives_zero_rows():
    inputs = _proposal_inputs(a=12, side=3, seed=2)
    (j, _), (t, _) = _both("_contrib_Proposal", inputs,
                           rpn_post_nms_top_n=300, **PROPOSAL)
    kept = (t[0][:, 1:] != 0).any(axis=1)
    assert 0 < kept.sum() < 300 and not kept[int(kept.sum()):].any()
    onp.testing.assert_allclose(t[0], j[0], rtol=TOL, atol=TOL)


def test_proposal_batch_and_without_scores():
    c, b, info = _proposal_inputs(a=12, side=6, seed=3)
    c2, b2 = onp.concatenate([c, c[:, :, ::-1]]), onp.concatenate([b, b])
    info2 = onp.concatenate([info, info * [1, 1, 2]]).astype("float32")
    (j, _), (t, _) = _both("_contrib_Proposal", [c2, b2, info2],
                           rpn_post_nms_top_n=20, rpn_min_size=4)
    assert len(t) == 1 and t[0].shape == (40, 5)
    onp.testing.assert_allclose(t[0][:19], j[0][:19], rtol=TOL, atol=TOL)
    onp.testing.assert_allclose(t[0][20:39], j[0][20:39], rtol=TOL,
                                atol=TOL)


# -------------------------------------------------------- contrib ops
def _contrib_cases():
    rs = onp.random.RandomState(11)
    x = rs.randn(5, 4).astype("float32")
    bad = x.copy()
    bad[2, 1] = onp.inf
    n, k, t = 3, 2, 6
    return {
        "all_finite": ("all_finite", [x], {}, ()),
        "all_finite_inf": ("all_finite", [bad], {}, ()),
        "multi_all_finite": ("multi_all_finite", [x, bad, x],
                             dict(num_arrays=3), ()),
        "multi_all_finite_ok": ("multi_all_finite", [x, x],
                                dict(num_arrays=2), ()),
        "boolean_mask": ("_contrib_boolean_mask",
                         [x, onp.array([1, 0, 1, 1, 0], "float32")], {},
                         (0,)),
        "boolean_mask_axis1": ("boolean_mask",
                               [x, onp.array([0, 1, 0, 1], "float32")],
                               dict(axis=1), (0,)),
        "index_copy": ("_contrib_index_copy",
                       [x, onp.array([3, -1, 7, 0], "float32"),
                        rs.randn(4, 4).astype("float32")], {}, ()),
        "index_array": ("_contrib_index_array", [rs.randn(2, 3, 4)
                                                 .astype("float32")],
                        dict(axes=(2, 0)), ()),
        "index_array_all": ("_contrib_index_array", [x], {}, ()),
        "fft": ("_contrib_fft", [rs.randn(3, 16).astype("float32")], {}, ()),
        "ifft": ("_contrib_ifft", [rs.randn(3, 32).astype("float32")], {},
                 ()),
        "allclose": ("_contrib_allclose", [x, x + 1e-7], {}, ()),
        "allclose_far": ("_contrib_allclose", [x, x + 1e-2],
                         dict(rtol=1e-3, atol=1e-4), ()),
        "allclose_nan": ("_contrib_allclose",
                         [onp.array([1.0, onp.nan], "f4"),
                          onp.array([1.0, onp.nan], "f4")],
                         dict(equal_nan=True), ()),
        "gradientmultiplier": ("_contrib_gradientmultiplier", [x],
                               dict(scalar=-2.5), (0,)),
        "hawkesll": ("_contrib_hawkesll", [
            (rs.rand(n, k) + 0.1).astype("f4"),
            (rs.rand(k) * 0.5 + 0.1).astype("f4"),
            (rs.rand(k) + 0.5).astype("f4"),
            rs.rand(n, k).astype("f4"),
            (rs.rand(n, t) + 0.1).astype("f4"),
            rs.randint(0, k, (n, t)).astype("int32"),
            onp.array([6, 3, 0], "float32"),
            onp.array([9.0, 5.0, 2.0], "float32")], {}, (0, 1, 2, 3)),
    }


CONTRIB = _contrib_cases()


@pytest.mark.parametrize("case", sorted(CONTRIB))
def test_contrib_op_matches_reference(case):
    name, arrays, params, grad_of = CONTRIB[case]
    (j, jg), (t, tg) = _both(name, arrays, grad_of=grad_of, **params)
    assert len(t) == len(j)
    for a, b in zip(t + tg, j + jg):
        assert a.shape == b.shape
        assert _rel(a, b) <= TOL


def test_index_array_is_int64_and_boolean_mask_keeps_its_size():
    (ia,), _ = _run(tmx, *CONTRIB["index_array"][:2],
                    **CONTRIB["index_array"][2])
    assert ia.dtype == onp.int64
    (bm,), _ = _run(tmx, *CONTRIB["boolean_mask"][:2])
    x = CONTRIB["boolean_mask"][1][0]
    onp.testing.assert_array_equal(bm, onp.concatenate(
        [x[[0, 2, 3]], onp.zeros((2, 4), "float32")]))


def test_gradientmultiplier_scales_only_the_gradient():
    x = tmx.nd.array(onp.arange(6, dtype="float32"))
    x.attach_grad()
    with tmx.autograd.record():
        y = tmx.nd.contrib.gradientmultiplier(x, scalar=3.0)
        z = (y * y).sum()
    z.backward()
    onp.testing.assert_array_equal(y.asnumpy(), x.asnumpy())
    onp.testing.assert_array_equal(x.grad.asnumpy(), 6 * x.asnumpy())


# ------------------------------------------------- names and registry
NEW_OPS = sorted({
    "sort", "argsort", "topk", "_contrib_MultiBoxPrior", "MultiBoxPrior",
    "_contrib_multibox_prior", "_contrib_MultiBoxTarget", "MultiBoxTarget",
    "_contrib_multibox_target", "_contrib_MultiBoxDetection",
    "MultiBoxDetection", "_contrib_multibox_detection", "_contrib_box_nms",
    "box_nms", "_contrib_box_non_maximum_suppression", "_contrib_box_iou",
    "box_iou", "ROIPooling", "_contrib_ROIPooling", "roi_pooling",
    "_contrib_ROIAlign", "roi_align", "_contrib_Proposal",
    "_contrib_proposal", "all_finite", "multi_all_finite",
    "_contrib_boolean_mask", "boolean_mask", "_contrib_index_copy",
    "_contrib_index_array", "_contrib_fft", "_contrib_ifft",
    "_contrib_allclose", "_contrib_gradientmultiplier",
    "_contrib_hawkesll"})


@pytest.mark.parametrize("name", NEW_OPS)
def test_new_ops_are_the_reference_ones(name):
    j, t = j_reg.get_op(name), t_reg.get_op(name)
    assert t.param_names == j.param_names
    assert inspect.signature(t.fn).parameters.keys() == \
        inspect.signature(j.fn).parameters.keys()
    assert {p: v.default for p, v in inspect.signature(
        t.fn).parameters.items()} == {p: v.default for p, v in
                                      inspect.signature(
                                          j.fn).parameters.items()}
    assert t.differentiable == j.differentiable
    for rt in ("indices", "both"):
        assert t.out_count({"ret_typ": rt}) == j.out_count({"ret_typ": rt})


def test_nd_contrib_namespace():
    from mxnet_tpu.ndarray import contrib as j_contrib

    t_names = {n for n in dir(tmx.nd.contrib) if not n.startswith("_")}
    for name in NEW_OPS:
        if name.startswith("_contrib_"):
            short = name[len("_contrib_"):]
            assert short in t_names and hasattr(j_contrib, short), short
    assert tmx.nd.topk is not None and hasattr(tmx.nd.NDArray, "argsort")
    for name in ("foreach", "while_loop", "cond"):
        with pytest.raises(MXNetError, match="§A 7"):
            getattr(tmx.nd.contrib, name)(None, None, None)


def test_targets_carry_no_graph():
    """``MultiBoxTarget`` takes ``cls_pred`` that requires grad; its
    outputs are constants, so ``backward`` never walks the matching."""
    anchors = _ssd300_anchors()[:, :50]
    cls = tmx.nd.array(onp.random.RandomState(0).randn(1, 3, 50)
                       .astype("float32"))
    cls.attach_grad()
    with tmx.autograd.record():
        outs = tmx.nd.contrib.MultiBoxTarget(
            tmx.nd.array(anchors), tmx.nd.array(_labels(1, 2, 2, 0)), cls,
            negative_mining_ratio=3.0)
    assert all(o._data.grad_fn is None and not o._data.requires_grad
               for o in outs)


def test_ops_read_nothing_on_the_host(monkeypatch):
    """The loops make no host round trip: every tensor method that
    would read a value on the host raises while the ops run."""
    def refuse(*a, **k):
        raise AssertionError("host read")

    anchors = _ssd300_anchors()
    labels = _labels(2, 3, 20, 0)
    cls = onp.random.RandomState(1).randn(2, 21, SSD300_ANCHORS)
    prob, loc = _detection_inputs(2, 3)
    tensors = [torch.from_numpy(a.astype("float32"))
               for a in (anchors, labels, cls, prob, loc)]
    from mxnet_tpu_torch.ops import detection_ops as det

    for meth in ("item", "tolist", "nonzero", "__bool__", "numpy"):
        monkeypatch.setattr(torch.Tensor, meth, refuse)
    det.multibox_target(*tensors[:3], negative_mining_ratio=3.0)
    det.multibox_detection(tensors[3], tensors[4], tensors[0],
                           nms_topk=400)
    det.box_nms(torch.cat([tensors[4].reshape(2, -1, 4)[..., :2],
                           tensors[4].reshape(2, -1, 4)], -1), topk=400)
