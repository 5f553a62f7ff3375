"""The older model-quantization entry point (counterpart of
``mxnet_tpu/contrib/quantization.py``, upstream's
``contrib/quantization.py:87 quantize_model`` for Gluon).

INT8 post-training quantization of a Gluon net's Dense layers: each
swaps to a :class:`QuantizedDense` (int8 weights, a calibrated input
range, the ``_contrib_quantized_*`` ops, a dequantized output);
everything else stays float.  :mod:`mxnet_tpu_torch.quantization` is
the full pipeline (conv, pooling, fp8, the race, export).
"""
from __future__ import annotations

import numpy as onp

from ..base import MXNetError
from ..gluon.block import HybridBlock
from ..ops import quantization_ops as Q

__all__ = ["quantize_net", "calib_minmax", "calib_entropy",
           "QuantizedDense"]


def _host(s):
    return onp.asarray(s.asnumpy() if hasattr(s, "asnumpy") else s)


def calib_minmax(samples):
    """naive calibration: the global min and max (``calib_mode='naive'``)."""
    mn = min(float(_host(s).min()) for s in samples)
    mx = max(float(_host(s).max()) for s in samples)
    return mn, mx


def calib_entropy(samples, num_bins=1001, num_quantized_bins=255):
    """KL-divergence threshold calibration (upstream
    ``_get_optimal_threshold``, the reference's simplified sweep)."""
    arr = onp.concatenate([onp.abs(_host(s)).ravel() for s in samples])
    amax = float(arr.max()) if arr.size else 1.0
    if amax == 0:
        return -1.0, 1.0
    hist, edges = onp.histogram(arr, bins=num_bins, range=(0, amax))
    best_kl, best_t = onp.inf, amax
    for stop in range(num_quantized_bins, num_bins + 1, 50):
        t = edges[stop]
        p = hist[:stop].astype("float64").copy()
        p[-1] += hist[stop:].sum()  # clip outliers into the last bin
        if p.sum() == 0:
            continue
        # quantize p into num_quantized_bins then expand back
        factor = stop / num_quantized_bins
        q = onp.zeros_like(p)
        for i in range(num_quantized_bins):
            lo = int(i * factor)
            hi = max(int((i + 1) * factor), lo + 1)
            chunk = p[lo:hi]
            nz = (chunk > 0).sum()
            if nz:
                q[lo:hi] = onp.where(chunk > 0, chunk.sum() / nz, 0)
        pn = p / p.sum()
        qn = q / max(q.sum(), 1e-12)
        mask = pn > 0
        kl = float((pn[mask] * onp.log(
            pn[mask] / onp.maximum(qn[mask], 1e-12))).sum())
        if kl < best_kl:
            best_kl, best_t = kl, t
    return -best_t, best_t


class QuantizedDense(HybridBlock):
    """INT8 Dense: a calibrated input range and int8 weights feeding
    ``_contrib_quantized_fully_connected``, the output dequantized (and
    the Dense's activation applied)."""

    def __init__(self, dense, act_range, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        w = dense._reg_params["weight"].data()._data
        b_param = dense._reg_params.get("bias")
        b = b_param.data()._data if b_param is not None else None
        self._units = w.shape[0]
        wq, wmin, wmax = Q.quantize_v2(w)
        self.register_buffer("_wq", wq)
        self.register_buffer("_wmin", wmin)
        self.register_buffer("_wmax", wmax)
        if b is not None:
            bq, bmin, bmax = Q.quantize_v2(b)
        else:
            bq = w.new_zeros((self._units,), dtype=wq.dtype)
            bmin, bmax = w.new_tensor([-1.0]), w.new_tensor([1.0])
        self.register_buffer("_bq", bq)
        self.register_buffer("_bmin", bmin)
        self.register_buffer("_bmax", bmax)
        self._no_bias = b is None
        self._amin, self._amax = act_range
        self._act = getattr(dense, "act", None)  # the fused activation

    def forward(self, x):
        xq, xmin, xmax = Q.quantize_v2(x, min_calib_range=self._amin,
                                       max_calib_range=self._amax)
        acc, omin, omax = Q.quantized_fully_connected(
            xq, self._wq, self._bq, xmin, xmax, self._wmin, self._wmax,
            self._bmin, self._bmax, num_hidden=self._units,
            no_bias=self._no_bias)
        out = Q.dequantize(acc, omin, omax)
        return self._act(out) if self._act is not None else out


def quantize_net(net, calib_data, calib_mode="naive",
                 quantized_dtype="int8", exclude_layers=()):
    """Post-training quantize a Gluon net's Dense layers in place
    (upstream ``quantize_model``, Gluon flavor).  ``calib_data``: input
    batches that record each Dense layer's input range.  Returns the
    net."""
    from ..gluon.nn import Dense
    from ..ndarray.ndarray import NDArray, array

    if quantized_dtype != "int8":
        raise MXNetError("only int8 quantization is supported")
    if calib_mode not in ("naive", "entropy"):
        raise MXNetError(f"unknown calib_mode {calib_mode!r}")
    calib = calib_minmax if calib_mode == "naive" else calib_entropy

    # a cached (hybridized) call captures its children: calibrate
    # eagerly, restoring hybridization after
    hybrid = [b for b in net.modules()
              if isinstance(b, HybridBlock) and b._active]
    for b in hybrid:
        b.hybridize(False)

    taps = {}
    handles = []

    def _walk(block):
        for child in block._children.values():
            if isinstance(child, Dense) and child.name not in \
                    exclude_layers:
                taps.setdefault(child.name, [])

                def hook(blk, inputs, _tap=taps[child.name]):
                    _tap.append(inputs[0])

                handles.append(child.register_forward_pre_hook(hook))
            else:
                _walk(child)

    _walk(net)
    try:
        for batch in calib_data:
            net(batch if isinstance(batch, NDArray) else array(batch))
    finally:
        for h in handles:
            h.detach()

    def _swap(block):
        for name, child in list(block._children.items()):
            if isinstance(child, Dense) and taps.get(child.name):
                block._modules[name] = QuantizedDense(
                    child, calib(taps[child.name]))
            else:
                _swap(child)

    _swap(net)
    for b in hybrid:
        b.hybridize(True)
    return net
