"""Calibration pass: per-tensor activation ranges for the int8 rewrite
(counterpart of ``mxnet_tpu/quantization/calibrate.py``).

``calib_mode="naive"`` records the running min/max of each observed
tensor; ``calib_mode="entropy"`` accumulates an absolute-value
histogram per tensor (bin-widening, the reference's
``combine_histogram``) and picks the KL-divergence-optimal symmetric
threshold (``optimal_threshold``), so that rare outliers do not stretch
the int8 grid over empty space.  The histogram and threshold code is
the reference's, in numpy, so the thresholds are its own.

Two front doors, one collector:

* **Gluon blocks**: forward pre/post hooks on every quantizable leaf
  layer (Dense, channel-first Conv, Pooling, Flatten) observe the
  layer's input and output while the calibration batches run eagerly
  (hybridization is suspended for the passes and restored after).  A
  naive collector reads only each tensor's min and max from the device.
* **Module**: the symbol graph's quantizable nodes are tapped through
  ``get_internals()``-style symbols, one group executor over the
  module's trained parameters, evaluated per calibration batch.

The result maps LAYER NAME -> ``{"in": (min, max), "out": (min, max)}``;
``excluded_names`` is the per-layer escape hatch the rewrite honors
too.
"""
from __future__ import annotations

import numpy as onp

from ..base import MXNetError

__all__ = ["CalibrationResult", "TensorStats", "calibrate",
           "calibrate_block", "calibrate_module", "optimal_threshold",
           "QUANTIZABLE_OPS"]

#: symbol-graph ops the calibration taps and the rewrite targets
QUANTIZABLE_OPS = ("FullyConnected", "Convolution", "Pooling",
                   "Flatten")

_NBINS = 2048  # histogram resolution of the entropy collector
#: widening cap: past this many bins the histogram REBINS back to
#: _NBINS over the new range instead of growing (a near-zero first
#: batch must not make a later normal-magnitude batch allocate a
#: range/width-ratio-sized array)
_MAX_BINS = 8 * _NBINS


def optimal_threshold(hist, hist_th, num_quantized_bins=255,
                      max_sweeps=96):
    """KL-divergence-optimal symmetric threshold over an absolute-value
    histogram spanning ``[0, hist_th]`` (reference
    ``_get_optimal_threshold``): sweep candidate clip points, quantize
    the clipped distribution into ``num_quantized_bins`` levels, expand
    back, and keep the threshold minimizing KL(p || q).  ``max_sweeps``
    strides the sweep so a fat histogram stays O(bins * sweeps)."""
    hist = onp.asarray(hist, dtype="float64").copy()
    nbins = len(hist)
    if nbins == 0 or hist.sum() == 0 or hist_th <= 0:
        return float(hist_th) if hist_th > 0 else 1.0
    if nbins <= num_quantized_bins:
        return float(hist_th)
    # drop the zero bin from the divergence: zeros (the ReLU spike —
    # often MOST of the mass) are exactly representable at any
    # threshold, so their count carries no information about where to
    # clip, but left in they drown the saturation penalty and the
    # sweep happily clips real tail mass
    hist[0] = 0.0
    if hist.sum() == 0:
        return float(hist_th)
    width = hist_th / nbins
    stops = range(num_quantized_bins, nbins + 1,
                  max(1, (nbins - num_quantized_bins) // max_sweeps))
    best_kl, best_stop = onp.inf, nbins
    for stop in stops:
        # p: the clipped distribution — everything past the candidate
        # threshold SATURATES into the last kept bin (what the int8
        # clamp does to real data)
        raw = hist[:stop]
        p = raw.copy()
        p[-1] += hist[stop:].sum()
        total = p.sum()
        if total == 0:
            continue
        # q: the int8 representation of the IN-RANGE counts only —
        # quantize raw into num_quantized_bins levels and expand back
        # uniformly over each level's NONZERO source bins.  Built from
        # raw, NOT p: piling the outlier mass into q too would hide
        # the saturation cost and every sweep would pick the smallest
        # threshold (KL(p||p) = 0)
        factor = stop / num_quantized_bins
        q = onp.zeros(stop)
        for i in range(num_quantized_bins):
            lo = int(round(i * factor))
            hi = max(int(round((i + 1) * factor)), lo + 1)
            chunk = raw[lo:hi]
            nz = chunk > 0
            if nz.any():
                q[lo:hi] = onp.where(nz, chunk.sum() / nz.sum(), 0.0)
        pn = p / total
        qsum = q.sum()
        if qsum == 0:
            continue
        qn = q / qsum
        mask = pn > 0
        kl = float((pn[mask]
                    * onp.log(pn[mask]
                              / onp.maximum(qn[mask], 1e-12))).sum())
        if kl < best_kl:
            best_kl, best_stop = kl, stop
    return float(best_stop * width)


class TensorStats:
    """Running distribution of ONE observed tensor: min/max always;
    an absolute-value histogram (bin-widening on range growth, the
    reference's ``combine_histogram``) when entropy mode will need
    it."""

    def __init__(self, collect_hist=False):
        self.min = onp.inf
        self.max = -onp.inf
        self.batches = 0
        self._collect_hist = collect_hist
        self._hist = None
        self._th = 0.0

    def update(self, arr):
        """Fold one observed array (numpy, or a torch tensor, whose
        min and max a naive collector reads on its device)."""
        import torch

        if isinstance(arr, torch.Tensor):
            if arr.numel() == 0:
                return
            if not self._collect_hist:
                lo, hi = torch.aminmax(arr.detach())
                self.batches += 1
                self.min = min(self.min, float(lo))
                self.max = max(self.max, float(hi))
                return
            arr = arr.detach().float().cpu().numpy()
        arr = onp.asarray(arr)
        if arr.size == 0:
            return
        self.batches += 1
        self.min = min(self.min, float(arr.min()))
        self.max = max(self.max, float(arr.max()))
        if not self._collect_hist:
            return
        a = onp.abs(arr.astype("float32", copy=False)).ravel()
        amax = float(a.max())
        if self._hist is None:
            self._th = max(amax, 1e-12)
            self._hist = onp.zeros(_NBINS, dtype="int64")
        elif amax > self._th:
            # widen by whole bins (bin width preserved, so earlier
            # counts stay exactly placed) — reference combine_histogram
            width = self._th / len(self._hist)
            nbins = int(onp.ceil(amax / width))
            if nbins > _MAX_BINS:
                # range grew too far for exact widening (e.g. a
                # near-zero first batch seeded a tiny threshold):
                # REBIN the existing counts proportionally into
                # _NBINS bins over the new range instead of
                # allocating range/width bins
                new_th = float(amax)
                old_edges = onp.linspace(0.0, self._th,
                                         len(self._hist) + 1)
                centers = (old_edges[:-1] + old_edges[1:]) / 2
                idx = onp.minimum(
                    (centers / new_th * _NBINS).astype("int64"),
                    _NBINS - 1)
                rebinned = onp.zeros(_NBINS, dtype="int64")
                onp.add.at(rebinned, idx, self._hist)
                self._hist = rebinned
                self._th = new_th
            else:
                widened = onp.zeros(nbins, dtype="int64")
                widened[:len(self._hist)] = self._hist
                self._hist = widened
                self._th = nbins * width
        h, _ = onp.histogram(a, bins=len(self._hist),
                             range=(0.0, self._th))
        self._hist += h

    def range(self, mode):
        """The calibrated (min, max) under ``mode``.  naive = running
        min/max; entropy = the KL-optimal symmetric threshold."""
        if self.batches == 0:
            raise MXNetError("TensorStats.range() before any update")
        if mode == "naive":
            return float(self.min), float(self.max)
        if mode != "entropy":
            raise MXNetError(f"unknown calib mode {mode!r}")
        if self._hist is None:
            raise MXNetError(
                "entropy range requested from a naive-mode collector")
        th = optimal_threshold(self._hist, self._th)
        return -th, th


class CalibrationResult:
    """Per-layer calibrated ranges: ``result[name]`` ->
    ``{"in": (min, max), "out": (min, max)}`` plus the collection
    metadata the rewrite stamps into telemetry."""

    def __init__(self, ranges, mode, num_batches, excluded=()):
        self._ranges = dict(ranges)
        self.mode = mode
        self.num_batches = num_batches
        self.excluded = tuple(excluded)

    def __contains__(self, name):
        return name in self._ranges

    def __getitem__(self, name):
        return self._ranges[name]

    def __len__(self):
        return len(self._ranges)

    def __iter__(self):
        return iter(self._ranges)

    def layers(self):
        return sorted(self._ranges)

    def range(self, name, which="in"):
        """The calibrated (min, max) of ``name``'s input or output, or
        None when the layer was never observed."""
        entry = self._ranges.get(name)
        return entry.get(which) if entry else None

    def amax(self, name, which="in"):
        """``max(|min|, |max|)`` of the calibrated range — the one
        statistic the fp8 arm needs (round 19: per-tensor symmetric
        e4m3 scaling consumes only the amax out of the same collected
        range the int8 arm uses — no second calibration pass).  None
        when the layer was never observed."""
        r = self.range(name, which)
        if r is None:
            return None
        return max(abs(float(r[0])), abs(float(r[1])))

    def as_dict(self):
        return {n: dict(e) for n, e in self._ranges.items()}


def _calib_defaults(mode, num_batches):
    from ..config import get_env

    if mode is None:
        mode = get_env("MXNET_QUANT_CALIB_MODE")
    if mode not in ("naive", "entropy"):
        raise MXNetError(
            f"unknown calib_mode {mode!r} (naive | entropy)")
    if num_batches is None:
        num_batches = int(get_env("MXNET_QUANT_CALIB_BATCHES"))
    return mode, max(1, int(num_batches))


def _quantizable_blocks(net, excluded_names):
    """(name, block) of every quantizable LEAF layer under ``net`` (the
    rewrite's eligibility set), without the names the caller fenced
    off."""
    from ..gluon.nn.basic_layers import Dense, Flatten
    from ..gluon.nn.conv_layers import _Conv, _Pooling

    found = []

    def _walk(block):
        for child in block._children.values():
            if isinstance(child, (Dense, Flatten, _Pooling, _Conv)):
                if child.name not in excluded_names:
                    found.append((child.name, child))
            else:
                _walk(child)

    _walk(net)
    return found


def _batches(calib_data, num_batches, like):
    """The first ``num_batches`` batches of ``calib_data`` as NDArrays
    (numpy batches go to the context of ``like``'s parameters)."""
    from ..ndarray.ndarray import NDArray, array

    from ..context import from_torch_device

    ctx = from_torch_device(like.device) if like is not None else None
    seen = 0
    for batch in calib_data:
        if seen >= num_batches:
            break
        if isinstance(batch, NDArray):
            yield batch
        else:
            import torch

            if isinstance(batch, torch.Tensor):
                yield NDArray(batch)
            else:
                yield array(onp.asarray(batch), ctx=ctx)
        seen += 1


def calibrate_block(net, calib_data, num_batches=None, mode=None,
                    excluded_names=()):
    """Run ``calib_data`` through a Gluon ``net`` eagerly, observing every
    quantizable layer's input and output through forward hooks.
    ``calib_data`` yields batches (NDArray, tensor or numpy; numpy
    batches go to the device of the net's parameters).  Returns a
    :class:`CalibrationResult`."""
    from ..gluon.block import HybridBlock, _collect_all_params

    mode, num_batches = _calib_defaults(mode, num_batches)
    targets = _quantizable_blocks(net, set(excluded_names))
    if not targets:
        raise MXNetError(
            "calibrate: no quantizable layers in the net (check "
            "excluded_names / layer eligibility)")
    collect_hist = mode == "entropy"
    stats = {name: {"in": TensorStats(collect_hist),
                    "out": TensorStats(collect_hist)}
             for name, _ in targets}

    # a cached (hybridized) call captures its children: run the
    # calibration passes eagerly, restoring hybridization after
    hybrid = [b for b in net.modules()
              if isinstance(b, HybridBlock) and b._active]
    for b in hybrid:
        b._active = False
    handles = []
    seen = 0
    params = _collect_all_params(net)
    like = params[0]._tensor() if params else None
    try:
        for name, child in targets:
            def pre(blk, inputs, _s=stats[name]["in"]):
                if inputs and hasattr(inputs[0], "_data"):
                    _s.update(inputs[0]._data)

            def post(blk, inputs, out, _s=stats[name]["out"]):
                o = out[0] if isinstance(out, (list, tuple)) else out
                if hasattr(o, "_data"):
                    _s.update(o._data)

            handles.append(child.register_forward_pre_hook(pre))
            handles.append(child.register_forward_hook(post))
        for x in _batches(calib_data, num_batches, like):
            net(x)
            seen += 1
    finally:
        for h in handles:
            h.detach()
        for b in hybrid:
            b._active = True
    if seen == 0:
        raise MXNetError("calibrate: calib_data yielded no batches")
    return _finish(stats, mode, seen, excluded_names)


def calibrate_module(mod, calib_data, num_batches=None, mode=None,
                     excluded_names=()):
    """Calibrate a bound :class:`~mxnet_tpu_torch.module.Module`: tap the
    data input and output of every quantizable symbol node through one
    group executor bound over the module's trained parameters, on the
    module's context, and fold each calibration batch through the
    collector.  Batches are arrays for the module's single data
    input."""
    from .. import ndarray as nd
    from .. import symbol as sym_mod

    mode, num_batches = _calib_defaults(mode, num_batches)
    sym = mod._symbol
    arg_params, aux_params = mod.get_params()
    excluded = set(excluded_names)

    taps = []  # (layer_name, which, Symbol)
    for node in sym._topo():
        if node.op in QUANTIZABLE_OPS and node.name not in excluded:
            data_node, data_idx = node.inputs[0]
            taps.append((node.name, "in",
                         sym_mod.Symbol(data_node, data_idx)))
            taps.append((node.name, "out", sym_mod.Symbol(node, 0)))
    if not taps:
        raise MXNetError(
            "calibrate: no quantizable layers in the module symbol")
    group = sym_mod.Group([t[2] for t in taps])

    collect_hist = mode == "entropy"
    stats = {}
    for name, which, _ in taps:
        stats.setdefault(name, {})[which] = TensorStats(collect_hist)

    data_names = list(getattr(mod, "_data_names", None) or ["data"])
    ctx = getattr(mod, "_context", None)
    params = dict(arg_params)
    seen = 0
    for batch in calib_data:
        if seen >= num_batches:
            break
        x = batch if isinstance(batch, nd.NDArray) else \
            nd.array(onp.asarray(batch), ctx=ctx)
        ex = group.bind(ctx, args={data_names[0]: x, **params},
                        aux_states=dict(aux_params))
        outs = ex.forward(is_train=False)
        for (name, which, _), o in zip(taps, outs):
            stats[name][which].update(o._data)
        seen += 1
    if seen == 0:
        raise MXNetError("calibrate: calib_data yielded no batches")
    return _finish(stats, mode, seen, excluded_names)


def _finish(stats, mode, num_batches, excluded_names):
    ranges = {}
    for name, entry in stats.items():
        if not any(s.batches for s in entry.values()):
            continue  # layer never executed (dead branch)
        ranges[name] = {
            which: s.range(mode)
            for which, s in entry.items() if s.batches
        }
    return CalibrationResult(ranges, mode, num_batches, excluded_names)


def calibrate(net_or_module, calib_data, num_batches=None, mode=None,
              excluded_names=()):
    """Front door: a Gluon ``Block`` calibrates through forward hooks, a
    ``Module`` through symbol taps.  ``mode`` None follows
    ``MXNET_QUANT_CALIB_MODE``; ``num_batches`` None follows
    ``MXNET_QUANT_CALIB_BATCHES``."""
    from ..gluon.block import Block

    if isinstance(net_or_module, Block):
        return calibrate_block(net_or_module, calib_data,
                               num_batches=num_batches, mode=mode,
                               excluded_names=excluded_names)
    if hasattr(net_or_module, "_symbol"):
        return calibrate_module(net_or_module, calib_data,
                                num_batches=num_batches, mode=mode,
                                excluded_names=excluded_names)
    raise MXNetError(
        "calibrate: expected a gluon Block or a Module, got "
        f"{type(net_or_module).__name__}")
