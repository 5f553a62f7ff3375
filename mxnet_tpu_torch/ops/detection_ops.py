"""Object-detection operators: the multibox family, NMS, the RoI ops and
RPN proposals (counterpart of ``mxnet_tpu/ops/detection_ops.py``).

Every op is static-shaped and batched along a leading dimension, as the
reference's ``vmap`` is.  Greedy bipartite matching and suppression,
the reference's ``lax.fori_loop``s, are Python loops of a fixed trip
count over device tensors: no step reads a value on the host, so a
call on the card never waits for it.  Orders are the reference's
(:func:`~mxnet_tpu_torch.ops.sort_ops.stable_argsort` for ``jnp.argsort``;
``torch.argmax`` takes the first maximum, as ``jnp.argmax`` does).
Dropped detections carry id -1, as in the reference.

One divergence, pinned by a test: ``_contrib_Proposal`` writes the kept
boxes in rank order, the first ``rpn_post_nms_top_n`` of them, and zero
rows after the last one (upstream's ``proposal.cc``); the reference
also writes every unselected box to the last row.
"""
from __future__ import annotations

import torch

from .registry import register_op
from .sort_ops import stable_argsort

__all__ = ["multibox_prior", "multibox_target", "multibox_detection",
           "box_nms", "box_iou", "roi_pooling", "roi_align", "proposal"]


def _consts(values, device):
    """A float32 vector of Python numbers made on ``device`` by fills, so
    that no host-to-device copy (a host sync) is needed."""
    return torch.stack([torch.full((), float(v), dtype=torch.float32,
                                   device=device) for v in values])


def _div(x, n):
    """``x / n`` as an IEEE division on every device: the card divides
    by a Python number as a multiplication by its reciprocal, an ulp
    off, which moves a bin edge that ``floor``/``ceil`` then reads."""
    return x / torch.full((), n, dtype=x.dtype, device=x.device)


def _corner_iou(a, b):
    """IOU of (..., 4) corner boxes vs (..., 4): broadcasted."""
    tl = torch.maximum(a[..., :2], b[..., :2])
    br = torch.minimum(a[..., 2:4], b[..., 2:4])
    wh = torch.clamp(br - tl, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = torch.clamp(a[..., 2] - a[..., 0], min=0.0) * \
        torch.clamp(a[..., 3] - a[..., 1], min=0.0)
    area_b = torch.clamp(b[..., 2] - b[..., 0], min=0.0) * \
        torch.clamp(b[..., 3] - b[..., 1], min=0.0)
    return inter / torch.clamp(area_a + area_b - inter, min=1e-12)


def _image_index(rois, bsz):
    """The RoIs' image indices as jnp indexes with them: truncated to
    int32, a negative one wrapped once, then clamped into range."""
    b = rois[:, 0].to(torch.int32).to(torch.int64)
    return torch.where(b < 0, b + bsz, b).clamp(0, bsz - 1)


def _take_rows(x, idx):
    """``x[b, idx[b, i]]`` for x (B, N, ...) and idx (B, K)."""
    tail = x.shape[2:]
    g = idx.reshape(idx.shape + (1,) * len(tail)).expand(idx.shape + tail)
    return torch.gather(x, 1, g)


@register_op("_contrib_MultiBoxPrior",
             aliases=("MultiBoxPrior", "_contrib_multibox_prior"),
             differentiable=False)
def multibox_prior(data, *, sizes=(1.0,), ratios=(1.0,), clip=False,
                   steps=(-1.0, -1.0), offsets=(0.5, 0.5)):
    """Anchors (1, H*W*A, 4) in [0, 1] corner coordinates: per cell
    [sizes x ratios[0]] then [sizes[0] x ratios[1:]], the width with the
    in_height/in_width aspect correction of the reference."""
    h, w = data.shape[2], data.shape[3]
    dev = data.device
    step_y = steps[0] if steps[0] > 0 else 1.0 / h
    step_x = steps[1] if steps[1] > 0 else 1.0 / w
    ys = (torch.arange(h, dtype=torch.float32, device=dev) + offsets[0]) \
        * step_y
    xs = (torch.arange(w, dtype=torch.float32, device=dev) + offsets[1]) \
        * step_x
    cy, cx = torch.meshgrid(ys, xs, indexing="ij")

    whs = []
    r0 = float(ratios[0]) ** 0.5
    for s in sizes:
        whs.append((s * h / w * r0 / 2, s / r0 / 2))
    for r in ratios[1:]:
        rs = float(r) ** 0.5
        whs.append((sizes[0] * h / w * rs / 2, sizes[0] / rs / 2))
    half_w = _consts([p[0] for p in whs], dev)
    half_h = _consts([p[1] for p in whs], dev)

    cx = cx[..., None]
    cy = cy[..., None]
    boxes = torch.stack([cx - half_w, cy - half_h, cx + half_w,
                         cy + half_h], dim=-1)
    boxes = boxes.reshape(1, h * w * len(whs), 4)
    if clip:
        boxes = torch.clamp(boxes, 0.0, 1.0)
    return boxes


def _encode_loc(anchors, gt, variances):
    """AssignLocTargets (multibox_target.cc:32-54); anchors (N, 4), gt
    (..., N, 4)."""
    aw = anchors[:, 2] - anchors[:, 0]
    ah = anchors[:, 3] - anchors[:, 1]
    ax = (anchors[:, 0] + anchors[:, 2]) * 0.5
    ay = (anchors[:, 1] + anchors[:, 3]) * 0.5
    gw = gt[..., 2] - gt[..., 0]
    gh = gt[..., 3] - gt[..., 1]
    gx = (gt[..., 0] + gt[..., 2]) * 0.5
    gy = (gt[..., 1] + gt[..., 3]) * 0.5
    vx, vy, vw, vh = variances
    return torch.stack([
        _div((gx - ax) / torch.clamp(aw, min=1e-12), vx),
        _div((gy - ay) / torch.clamp(ah, min=1e-12), vy),
        _div(torch.log(torch.clamp(gw, min=1e-12)
                       / torch.clamp(aw, min=1e-12)), vw),
        _div(torch.log(torch.clamp(gh, min=1e-12)
                       / torch.clamp(ah, min=1e-12)), vh),
    ], dim=-1)


@register_op("_contrib_MultiBoxTarget",
             aliases=("MultiBoxTarget", "_contrib_multibox_target"),
             num_outputs=3, differentiable=False)
def multibox_target(anchor, label, cls_pred, *, overlap_threshold=0.5,
                    ignore_label=-1.0, negative_mining_ratio=-1.0,
                    negative_mining_thresh=0.5,
                    minimum_negative_samples=0,
                    variances=(0.1, 0.1, 0.2, 0.2)):
    """anchor (1, N, 4), label (B, M, 5) rows [cls, xmin, ymin, xmax,
    ymax] with cls = -1 padding, cls_pred (B, num_classes, N) ->
    (loc_target (B, N*4), loc_mask (B, N*4), cls_target (B, N)).

    Greedy bipartite matching (M trips: each takes the best remaining
    (anchor, gt) pair of every image), then per-anchor threshold
    matching, then, with ``negative_mining_ratio > 0``, hard negatives
    ranked by background probability."""
    anchors = anchor.reshape(-1, 4)
    n = anchors.shape[0]
    bsz, m = label.shape[0], label.shape[1]
    dev = anchors.device
    gt_cls = label[..., 0]
    gt_valid = gt_cls >= 0  # (B, M)
    gt_boxes = label[..., 1:5]
    ious = _corner_iou(anchors[None, :, None, :], gt_boxes[:, None, :, :])
    neg1 = torch.full((), -1.0, dtype=ious.dtype, device=dev)
    ious = torch.where(gt_valid[:, None, :], ious, neg1)  # (B, N, M)

    # stage 1: greedy bipartite, M trips
    a_match = torch.full((bsz, n), -1, dtype=torch.int64, device=dev)
    iou_cache = torch.full((bsz, n), -1.0, dtype=ious.dtype, device=dev)
    gt_taken = torch.zeros((bsz, m), dtype=torch.bool, device=dev)
    for _ in range(m):
        free = (a_match[:, :, None] < 0) & ~gt_taken[:, None, :]
        masked = torch.where(free, ious, neg1).reshape(bsz, n * m)
        flat = torch.argmax(masked, dim=1, keepdim=True)  # first maximum
        best = torch.gather(masked, 1, flat)
        ok = best > 1e-6
        bi, bk = flat // m, flat % m
        a_match.scatter_(1, bi, torch.where(
            ok, bk, torch.gather(a_match, 1, bi)))
        iou_cache.scatter_(1, bi, torch.where(
            ok, best, torch.gather(iou_cache, 1, bi)))
        gt_taken.scatter_(1, bk, torch.gather(gt_taken, 1, bk) | ok)

    # stage 2: threshold matching for the rest
    best_iou = torch.amax(ious, dim=2)
    best_gt = torch.argmax(ious, dim=2)  # the first maximum
    matched = a_match >= 0
    if overlap_threshold > 0:
        positive = matched | (best_iou > overlap_threshold)
    else:
        positive = matched
    matched_gt = torch.where(matched, a_match, best_gt)
    matched_iou = torch.where(matched, iou_cache, best_iou)

    # stage 3: negatives
    if negative_mining_ratio > 0:
        num_pos = positive.sum(dim=1, dtype=torch.int32)
        num_neg = torch.minimum(
            (num_pos.to(torch.float32) * negative_mining_ratio)
            .to(torch.int32), n - num_pos)
        num_neg = torch.clamp(num_neg, min=int(minimum_negative_samples))
        logits = cls_pred  # (B, num_classes, N)
        mx = torch.amax(logits, dim=1)
        bg_prob = torch.exp(logits[:, 0] - mx) / \
            torch.sum(torch.exp(logits - mx[:, None]), dim=1)
        cand = ~positive & (matched_iou < negative_mining_thresh)
        score = torch.where(cand, bg_prob, torch.full(
            (), float("inf"), dtype=bg_prob.dtype, device=dev))
        order = stable_argsort(score, 1)  # hardest first
        rank = torch.empty_like(order).scatter_(
            1, order, torch.arange(n, device=dev).expand(bsz, n))
        negative = cand & (rank < num_neg[:, None])
    else:
        negative = ~positive

    safe_gt = matched_gt.clamp(0, m - 1)  # jnp.take's mode="clip"
    cls_t = torch.where(
        positive, torch.gather(gt_cls, 1, safe_gt) + 1.0,
        torch.where(negative, 0.0, float(ignore_label)).to(gt_cls.dtype))
    loc_t = torch.where(positive[..., None],
                        _encode_loc(anchors, _take_rows(gt_boxes, safe_gt),
                                    variances), 0.0)
    loc_m = positive[..., None].expand(bsz, n, 4).to(torch.float32)
    return loc_t.reshape(bsz, -1), loc_m.reshape(bsz, -1), cls_t


def _decode_loc(anchors, pred, variances, clip):
    """multibox_detection.cc:51-70: center-offset decoding; anchors
    (N, 4), pred (B, N, 4)."""
    al, at, ar, ab = (anchors[:, 0], anchors[:, 1], anchors[:, 2],
                      anchors[:, 3])
    aw, ah = ar - al, ab - at
    ax, ay = (al + ar) * 0.5, (at + ab) * 0.5
    vx, vy, vw, vh = variances
    px, py, pw, ph = pred[..., 0], pred[..., 1], pred[..., 2], pred[..., 3]
    ox = px * vx * aw + ax
    oy = py * vy * ah + ay
    ow = torch.exp(pw * vw) * aw / 2
    oh = torch.exp(ph * vh) * ah / 2
    out = torch.stack([ox - ow, oy - oh, ox + ow, oy + oh], dim=-1)
    if clip:
        out = torch.clamp(out, 0.0, 1.0)
    return out


def _nms_scan(boxes, scores, ids, valid, nms_threshold, force_suppress,
              topk):
    """Suppression over score-sorted boxes of every image: boxes (B, N,
    4), scores/ids/valid (B, N) -> (keep (B, N) in sorted order, order
    (B, N)).

    With ``topk > 0`` only the top-k sorted boxes enter the k x k IOU
    matrix and the loop (the reference's ``nms_topk`` pre-filter).  The
    loop makes k trips of one fixed pair of launches: the suppression
    matrix is built once, and trip i clears from ``alive`` what a kept
    box i suppresses among the boxes after it."""
    bsz, n = scores.shape
    order = stable_argsort(-scores, 1)
    k = min(topk, n) if topk > 0 else n
    top = order[:, :k]
    b = _take_rows(boxes, top)
    s_ids = torch.gather(ids, 1, top)
    s_valid = torch.gather(valid, 1, top)
    ious = _corner_iou(b[:, :, None, :], b[:, None, :, :])
    sup = ious > nms_threshold
    if not force_suppress:
        sup &= s_ids[:, :, None] == s_ids[:, None, :]
    sup &= torch.ones(k, k, dtype=torch.bool, device=sup.device).triu(1)
    alive = s_valid.clone()  # a box that is not valid suppresses nothing
    for i in range(k):
        alive.masked_fill_(sup[:, i] & alive[:, i:i + 1], False)
    keep = torch.zeros((bsz, n), dtype=torch.bool, device=scores.device)
    keep[:, :k] = alive
    return keep, order


@register_op("_contrib_MultiBoxDetection",
             aliases=("MultiBoxDetection", "_contrib_multibox_detection"),
             differentiable=False)
def multibox_detection(cls_prob, loc_pred, anchor, *, clip=True,
                       threshold=0.01, background_id=0,
                       nms_threshold=0.5, force_suppress=False,
                       variances=(0.1, 0.1, 0.2, 0.2), nms_topk=-1):
    """cls_prob (B, num_classes, N) softmax probabilities, loc_pred
    (B, N*4), anchor (1, N, 4) -> (B, N, 6) rows [id, score, xmin, ymin,
    xmax, ymax] in descending score order; suppressed or invalid rows
    have id -1."""
    anchors = anchor.reshape(-1, 4)
    bsz, c, n = cls_prob.shape
    not_bg = torch.arange(c, device=cls_prob.device) != background_id
    fg = torch.where(not_bg[None, :, None], cls_prob,
                     torch.full((), -1.0, dtype=cls_prob.dtype,
                                device=cls_prob.device))
    score = torch.amax(fg, dim=1)
    best_cls = torch.argmax(fg, dim=1)  # the first maximum
    valid = score > threshold
    # the reference's id: the class index shifted down past background 0
    ids = (best_cls - 1).to(torch.float32)
    boxes = _decode_loc(anchors, loc_pred.reshape(bsz, n, 4), variances,
                        clip)
    keep, order = _nms_scan(boxes, score, best_cls, valid, nms_threshold,
                            force_suppress, nms_topk)
    s_boxes = _take_rows(boxes, order)
    s_score = torch.gather(score, 1, order)
    s_ids = torch.gather(ids, 1, order)
    return torch.cat([
        torch.where(keep, s_ids, -1.0)[..., None],
        torch.where(keep, s_score, 0.0)[..., None],
        torch.where(keep[..., None], s_boxes, 0.0)], dim=-1)


def _to_corner(b):
    return torch.cat([b[..., :2] - b[..., 2:4] / 2,
                      b[..., :2] + b[..., 2:4] / 2], dim=-1)


def _to_center(b):
    return torch.cat([(b[..., :2] + b[..., 2:4]) / 2,
                      b[..., 2:4] - b[..., :2]], dim=-1)


@register_op("_contrib_box_nms",
             aliases=("box_nms", "_contrib_box_non_maximum_suppression"),
             differentiable=False)
def box_nms(data, *, overlap_thresh=0.5, valid_thresh=0.0, topk=-1,
            coord_start=2, score_index=1, id_index=-1, background_id=-1,
            force_suppress=False, in_format="corner",
            out_format="corner"):
    """data (..., N, K): boxes at coord_start..+4, the score at
    score_index, an optional class at id_index.  Survivors in descending
    score order first, then rows of -1; the shape is kept."""
    shape = data.shape
    flat = data.reshape(-1, shape[-2], shape[-1])
    boxes = flat[..., coord_start:coord_start + 4]
    if in_format == "center":
        boxes = _to_corner(boxes)
    scores = flat[..., score_index]
    if id_index >= 0:
        ids = flat[..., id_index].to(torch.int32)
    else:
        ids = torch.zeros(scores.shape, dtype=torch.int32,
                          device=data.device)
    valid = scores > valid_thresh
    if id_index >= 0 and background_id >= 0:
        valid = valid & (ids != background_id)
    keep, order = _nms_scan(boxes, scores, ids, valid, overlap_thresh,
                            force_suppress or id_index < 0, topk)
    rows = _take_rows(flat, order)
    if out_format != in_format:
        sb = rows[..., coord_start:coord_start + 4]
        conv = _to_corner(sb) if out_format == "corner" else _to_center(sb)
        rows = torch.cat([rows[..., :coord_start], conv,
                          rows[..., coord_start + 4:]], dim=-1)
    # survivors to the front, in order; the tail is -1
    compact = stable_argsort(~keep, 1)
    keep_c = torch.gather(keep, 1, compact)
    rows_c = _take_rows(rows, compact)
    return torch.where(keep_c[..., None], rows_c, -1.0).reshape(shape)


@register_op("_contrib_box_iou", aliases=("box_iou",),
             differentiable=False)
def box_iou(lhs, rhs, *, format="corner"):  # noqa: A002
    a = _to_corner(lhs) if format == "center" else lhs
    b = _to_corner(rhs) if format == "center" else rhs
    a2 = a.reshape(-1, 4)
    b2 = b.reshape(-1, 4)
    out = _corner_iou(a2[:, None, :], b2[None, :, :])
    return out.reshape(a.shape[:-1] + b.shape[:-1])


@register_op("ROIPooling", aliases=("_contrib_ROIPooling", "roi_pooling"))
def roi_pooling(data, rois, *, pooled_size, spatial_scale):
    """data (B, C, H, W); rois (R, 5) rows [batch_idx, x1, y1, x2, y2] in
    image coordinates -> (R, C, ph, pw).  Exact max over quantized bins
    as masked max-reductions (a bin's pixels are a mask, not a slice):
    first over each bin's rows, one bin row at a time, then over its
    columns.  ``torch.amax`` splits a gradient evenly among tied maxima
    as jnp's max does; empty bins give 0 and no gradient."""
    ph, pw = pooled_size
    h, w = data.shape[2], data.shape[3]
    dev = data.device
    bidx = _image_index(rois, data.shape[0])
    x1 = torch.round(rois[:, 1] * spatial_scale)
    y1 = torch.round(rois[:, 2] * spatial_scale)
    x2 = torch.round(rois[:, 3] * spatial_scale)
    y2 = torch.round(rois[:, 4] * spatial_scale)
    rw = torch.clamp(x2 - x1 + 1, min=1.0)
    rh = torch.clamp(y2 - y1 + 1, min=1.0)
    bin_w = _div(rw, pw)
    bin_h = _div(rh, ph)
    img = data[bidx]  # (R, C, H, W)

    def bins(start, size, nbins, extent):
        """(R, extent, nbins): pixel p lies in bin j of each RoI."""
        j = torch.arange(nbins, dtype=torch.float32, device=dev)
        lo = torch.floor(start[:, None] + j * size[:, None])
        hi = torch.ceil(start[:, None] + (j + 1) * size[:, None])
        p = torch.arange(extent, dtype=torch.float32, device=dev)
        p = p[None, :, None]
        return (p >= lo[:, None, :]) & (p < hi[:, None, :]) & \
            (p >= 0) & (p < extent)

    my = bins(y1, bin_h, ph, h)
    mx = bins(x1, bin_w, pw, w)
    neg = torch.full((), torch.finfo(data.dtype).min, dtype=data.dtype,
                     device=dev)
    # max over each bin's rows: (R, C, ph, W)
    rowmax = torch.stack([
        torch.amax(torch.where(my[:, None, :, i, None], img, neg), dim=2)
        for i in range(ph)], dim=2)
    masked = torch.where(mx.transpose(1, 2)[:, None, None, :, :],
                         rowmax[:, :, :, None, :], neg)  # (R, C, ph, pw, W)
    out = torch.amax(masked, dim=4)
    return torch.where(out == neg, 0.0, out)  # empty bins -> 0


@register_op("_contrib_ROIAlign", aliases=("roi_align",))
def roi_align(data, rois, *, pooled_size, spatial_scale, sample_ratio=-1,
              position_sensitive=False, aligned=False):
    """The average of sample_ratio^2 bilinear samples per bin (2 x 2 by
    default) -> (R, C, ph, pw), or (R, C / (ph pw), ph, pw) position
    sensitive (R-FCN).  The backward is a scatter-add of the bilinear
    weights (atomics on the card: its sums are ordered differently)."""
    ph, pw = pooled_size
    bsz, c, h, w = data.shape
    dev = data.device
    sr = sample_ratio if sample_ratio > 0 else 2
    off = 0.5 if aligned else 0.0
    nr = rois.shape[0]
    bidx = _image_index(rois, bsz)
    x1 = rois[:, 1] * spatial_scale - off
    y1 = rois[:, 2] * spatial_scale - off
    x2 = rois[:, 3] * spatial_scale - off
    y2 = rois[:, 4] * spatial_scale - off
    lo = 1.0 if not aligned else 1e-6
    rw = torch.clamp(x2 - x1, min=lo)
    rh = torch.clamp(y2 - y1, min=lo)
    bin_w = _div(rw, pw)
    bin_h = _div(rh, ph)
    iy = torch.arange(ph, dtype=torch.float32, device=dev)
    ix = torch.arange(pw, dtype=torch.float32, device=dev)
    sy = torch.arange(sr, dtype=torch.float32, device=dev)
    frac = _div(sy + 0.5, sr)
    ys = y1[:, None, None] + (iy[None, :, None] + frac) * bin_h[:, None, None]
    xs = x1[:, None, None] + (ix[None, :, None] + frac) * bin_w[:, None, None]
    # (R, ph, pw, sr, sr) sample grids, flattened per RoI
    shp = (nr, ph, pw, sr, sr)
    y = ys[:, :, None, :, None].expand(shp).reshape(nr, -1)
    x = xs[:, None, :, None, :].expand(shp).reshape(nr, -1)

    y = torch.clamp(y, 0.0, h - 1.0)
    x = torch.clamp(x, 0.0, w - 1.0)
    y0 = torch.floor(y).to(torch.int64)
    x0 = torch.floor(x).to(torch.int64)
    y1i = torch.clamp(y0 + 1, max=h - 1)
    x1i = torch.clamp(x0 + 1, max=w - 1)
    wy = y - y0
    wx = x - x0
    flat = data.reshape(bsz, c, h * w).transpose(1, 2)  # (B, HW, C)
    b = bidx[:, None]

    def at(yy, xx):
        return flat[b, yy * w + xx]  # (R, P, C)

    wy, wx = wy[..., None], wx[..., None]
    vals = (at(y0, x0) * (1 - wy) * (1 - wx) + at(y0, x1i) * (1 - wy) * wx
            + at(y1i, x0) * wy * (1 - wx) + at(y1i, x1i) * wy * wx)
    vals = vals.reshape(nr, ph, pw, sr * sr, c).mean(dim=3)
    out = vals.permute(0, 3, 1, 2)  # (R, C, ph, pw)
    if position_sensitive:
        # R-FCN: input channel layout (out_c, ph, pw); bin (i, j) of
        # output channel k reads input channel k*ph*pw + i*pw + j
        out_c = c // (ph * pw)
        grouped = out.reshape(nr, out_c, ph, pw, ph, pw)
        iy2 = torch.arange(ph, device=dev)[:, None]
        ix2 = torch.arange(pw, device=dev)[None, :]
        out = grouped[:, :, iy2, ix2, iy2, ix2]
    return out


def _proposal_anchors(scales, ratios, feature_stride, h, w, device):
    """(H*W*A, 4) anchors, base anchors centered at (stride - 1) / 2 and
    shifted over the grid, as the reference makes them."""
    base = float(feature_stride)
    ctr = (base - 1) / 2
    corners = []  # host float32 arithmetic, as the reference's
    for r in ratios:
        ws = torch.round(torch.sqrt(torch.tensor(base * base / r,
                                                 dtype=torch.float32)))
        hs = torch.round(ws * r)
        for s in scales:
            wss, hss = ws * s, hs * s
            corners += [ctr - (wss - 1) / 2, ctr - (hss - 1) / 2,
                        ctr + (wss - 1) / 2, ctr + (hss - 1) / 2]
    base_anchors = _consts(torch.stack(corners).tolist(),
                           device).reshape(-1, 4)
    shift_x = torch.arange(w, dtype=torch.float32, device=device) * base
    shift_y = torch.arange(h, dtype=torch.float32, device=device) * base
    sy, sx = torch.meshgrid(shift_y, shift_x, indexing="ij")
    shifts = torch.stack([sx, sy, sx, sy], dim=-1).reshape(-1, 1, 4)
    return (base_anchors[None] + shifts).reshape(-1, 4)


@register_op("_contrib_Proposal", aliases=("_contrib_proposal",),
             differentiable=False)
def proposal(cls_prob, bbox_pred, im_info, *, rpn_pre_nms_top_n=6000,
             rpn_post_nms_top_n=300, threshold=0.7, rpn_min_size=16,
             scales=(4, 8, 16, 32), ratios=(0.5, 1, 2),
             feature_stride=16, output_score=False, iou_loss=False):
    """cls_prob (B, 2A, H, W), bbox_pred (B, 4A, H, W), im_info (B, 3) ->
    rois (B * post, 5) [batch_idx, x1, y1, x2, y2]: the kept boxes of
    each image in rank order, the first ``rpn_post_nms_top_n``, zero
    rows after the last kept one (and their scores, (B * post, 1), with
    ``output_score``)."""
    bsz, _, h, w = cls_prob.shape
    dev = cls_prob.device
    a = len(scales) * len(ratios)
    post = rpn_post_nms_top_n
    anchors = _proposal_anchors(scales, ratios, feature_stride, h, w, dev)
    scores = cls_prob[:, a:].permute(0, 2, 3, 1).reshape(bsz, -1)
    deltas = bbox_pred.permute(0, 2, 3, 1).reshape(bsz, -1, 4)
    aw = anchors[:, 2] - anchors[:, 0] + 1
    ah = anchors[:, 3] - anchors[:, 1] + 1
    ax = anchors[:, 0] + aw * 0.5
    ay = anchors[:, 1] + ah * 0.5
    cx = deltas[..., 0] * aw + ax
    cy = deltas[..., 1] * ah + ay
    cw = torch.exp(deltas[..., 2]) * aw
    ch = torch.exp(deltas[..., 3]) * ah
    boxes = torch.stack([cx - cw / 2, cy - ch / 2, cx + cw / 2,
                         cy + ch / 2], dim=-1)
    hi = torch.stack([im_info[:, 1] - 1, im_info[:, 0] - 1,
                      im_info[:, 1] - 1, im_info[:, 0] - 1], dim=-1)
    boxes = torch.minimum(torch.clamp(boxes, min=0.0), hi[:, None, :])
    # FilterBox: min_size in scaled coordinates (min_size * im_info[2])
    min_sz = (rpn_min_size * im_info[:, 2])[:, None]
    keep_sz = ((boxes[..., 2] - boxes[..., 0] + 1 >= min_sz)
               & (boxes[..., 3] - boxes[..., 1] + 1 >= min_sz))
    scores = torch.where(keep_sz, scores, float("-inf"))
    keep, order = _nms_scan(boxes, scores,
                            torch.zeros(scores.shape, dtype=torch.int32,
                                        device=dev),
                            torch.isfinite(scores), threshold, True,
                            rpn_pre_nms_top_n)
    sboxes = _take_rows(boxes, order)
    sscores = torch.gather(scores, 1, order)
    rank = torch.cumsum(keep.to(torch.int64), dim=1) - 1
    sel = keep & (rank < post)
    # every unselected box goes to a spare row post, dropped after
    slot = torch.where(sel, rank, post)
    out = torch.zeros((bsz, post + 1, 4), dtype=boxes.dtype, device=dev)
    out.scatter_(1, slot[..., None].expand(-1, -1, 4),
                 torch.where(sel[..., None], sboxes, 0.0))
    out_s = torch.zeros((bsz, post + 1), dtype=scores.dtype, device=dev)
    out_s.scatter_(1, slot, torch.where(sel, sscores, 0.0))
    bidx = torch.arange(bsz, dtype=torch.float32, device=dev)
    bidx = bidx.repeat_interleave(post)
    rois = torch.cat([bidx[:, None], out[:, :post].reshape(-1, 4)], dim=-1)
    if output_score:
        return rois, out_s[:, :post].reshape(-1, 1)
    return rois
