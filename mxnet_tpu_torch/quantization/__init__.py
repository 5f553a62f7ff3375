"""Quantized inference (counterpart of ``mxnet_tpu/quantization``): the
calibrate -> rewrite -> race -> export pipeline, carried to a served
artifact.

1. :func:`calibrate` runs calibration batches through a trained Gluon
   block (forward hooks) or Module (symbol taps), collecting per-tensor
   ranges: ``naive`` min/max or ``entropy`` KL-optimal thresholds, with
   ``excluded_names`` as the per-layer escape.
2. :func:`quantize_net` rewrites eligible layers into int8 wrappers
   (``quantized_conv`` / ``quantized_fully_connected`` / ``quantized_
   pooling`` / ``quantized_flatten`` with calibrated ``quantize_v2`` /
   ``requantize`` / ``dequantize`` stitching) that also carry an fp8
   arm and their fp32 original.
3. :func:`tune_quantized` races the int8, fp8 and fp32 arms on the real
   forward (autotune ops ``quantized_conv`` / ``quantized_fc``);
   winners persist in ``autotune.json`` keyed by platform, and
   ``MXNET_QUANTIZE`` is the hand override.
4. ``deploy.export_model`` writes the arm the trace takes, with
   ``quantized``, ``quantized_layers`` and ``param_dtypes`` in the
   header, and ``serving.ModelServer.from_artifact`` serves it.

:mod:`.kv` holds the KV cache's per-(token, head) int8 pair.

Env knobs: ``MXNET_QUANTIZE``, ``MXNET_QUANT_CALIB_MODE``,
``MXNET_QUANT_CALIB_BATCHES``; the KV cache reads ``MXNET_KV_DTYPE``.
"""
from .calibrate import (  # noqa: F401
    QUANTIZABLE_OPS,
    CalibrationResult,
    TensorStats,
    calibrate,
    calibrate_block,
    calibrate_module,
    optimal_threshold,
)
from .kv import kv_dequantize, kv_page_bytes, kv_quantize  # noqa: F401
from .rewrite import (  # noqa: F401
    QuantizedConv,
    QuantizedDense,
    QuantizedFlatten,
    QuantizedPooling,
    quantize_net,
    quantized_layers,
    tune_quantized,
)

__all__ = [
    "calibrate", "calibrate_block", "calibrate_module",
    "CalibrationResult", "TensorStats", "optimal_threshold",
    "QUANTIZABLE_OPS", "quantize_net", "tune_quantized",
    "quantized_layers", "QuantizedDense", "QuantizedConv",
    "QuantizedPooling", "QuantizedFlatten",
    "kv_quantize", "kv_dequantize", "kv_page_bytes",
]
