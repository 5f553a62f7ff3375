"""Quantization (the KV-cache part so far)."""
from .kv import kv_dequantize, kv_page_bytes, kv_quantize  # noqa: F401

__all__ = ["kv_quantize", "kv_dequantize", "kv_page_bytes"]
