"""Deployment: framed inference artifacts (counterpart of
``mxnet_tpu/deploy.py``).

The reference ships a C predictor that loads symbol-JSON + params with
no model Python; ``mxnet_tpu`` frames a ``jax.export`` StableHLO program
instead.  The port keeps that frame byte for byte and carries, as its
payload, the program format this package can run without the model's
code: the graph a Gluon net's symbolic trace writes (``HybridBlock.
export``'s ``-symbol.json`` text) and its ``.params`` bytes, the
reference's bytes for the same weights.  Loaded, the graph runs as a
:class:`~mxnet_tpu_torch.gluon.SymbolBlock` on the card (or the host),
hybridized with both static flags, so each batch shape it is called at
is one captured CUDA graph.

    path = mx.deploy.export_model(net, example_x, "model.mxje")
    f = mx.deploy.load_model(path)     # -> callable on nd/np arrays
    y = f(x)

Why not ``torch.export``: its serialized programs are not promised to
load across PyTorch versions, and the port's CUDA kernels are not
``torch.library`` ops an exported program could hold; the symbol graph
needs neither.  A StableHLO artifact of the JAX package raises a clean
:class:`MXNetError` naming the path, and :func:`stablehlo_text` raises.

Framing (the reference's): a v2 file is ``MXJE\\x02\\n``, then ``<IQI``
= CRC32(metadata + payload), len(payload), len(metadata), the JSON
metadata segment (input signature, ``quantized``, ``quantized_layers``,
``param_dtypes``, ``platforms``, the caller's ``extra_meta``) and the
payload; a v1 file
is ``MXJE\\x01\\n``, ``<IQ`` = CRC32(payload), len(payload), payload;
a file without either magic is all payload.  Integrity is checked
before the payload is read.  Generative (decoder) artifacts carry the
parameter tree as an npz payload and cross between the two packages
both ways.
"""
from __future__ import annotations

import collections
import io
import json
import struct
import zlib

import numpy as onp

from .base import MXNetError

__all__ = ["export_model", "export_generative", "load_model",
           "load_exported", "load_generative", "stablehlo_text",
           "artifact_info", "read_artifact_meta"]

#: v1 artifact header: magic, then ``<IQ`` = CRC32(payload),
#: len(payload)
_MAGIC = b"MXJE\x01\n"
_HEADER = struct.Struct("<IQ")
#: v2 artifact header: magic, then ``<IQI`` = CRC32(meta_json +
#: payload), len(payload), len(meta_json); the JSON metadata segment
#: follows the header, the payload follows it
_MAGIC2 = b"MXJE\x02\n"
_HEADER2 = struct.Struct("<IQI")
#: the port's dense payload: magic, then ``<QQ`` = len(graph JSON),
#: len(.params bytes), the graph's UTF-8 JSON text, the .params bytes
_SYMBOL_MAGIC = b"MXJSYM\x01\n"
_SYMBOL_HEADER = struct.Struct("<QQ")
#: the bytecode magic of the MLIR module inside a ``jax.export``
#: serialization: how a JAX package artifact is told apart
_MLIR_MAGIC = b"ML\xefR"

#: the shape and dtype of one input or output of an artifact's program
Aval = collections.namedtuple("Aval", ["shape", "dtype"])


def _dtype_name(dt):
    """``float32`` for numpy, torch and string dtypes alike."""
    return str(dt).replace("torch.", "")


def _example_array(x):
    """``(shape, dtype name, NDArray)`` of an example input given as an
    NDArray, a torch tensor or anything numpy takes."""
    import torch

    from .ndarray.ndarray import NDArray, array

    if isinstance(x, NDArray):
        nd = x
    elif isinstance(x, torch.Tensor):
        nd = NDArray(x)
    else:
        nd = array(onp.asarray(x))
    return tuple(int(s) for s in nd.shape), _dtype_name(nd._data.dtype), nd


def _net_meta(net, shape, dtype, platforms):
    """The v2 header metadata of an export: the input signature,
    ``quantized`` (does the program run int8 or fp8 layers),
    ``quantized_layers`` and a ``param_dtypes`` histogram of the weights
    the program bakes, counted as the reference's ``_net_meta`` counts
    them: each block's own parameters, then its children's; a quantized
    wrapper whose arm is int8 or fp8 counts its baked weights
    (``export_dtypes``) in place of its fp32 original's, one armed fp32
    counts the original's, a pooling/flatten wrapper nothing.  Computed
    under the same autotune scope as the export trace, so it describes
    the program, not the net's potential."""
    dtype_counts = {}
    quantized = False
    q_layers = 0

    def _count(dt):
        dt = _dtype_name(dt)
        dtype_counts[dt] = dtype_counts.get(dt, 0) + 1

    def _walk(block):
        nonlocal quantized, q_layers
        if getattr(block, "_mxnet_quantized", False):
            if block.variant_op is None:
                return  # pooling/flatten pass-through: no weights
            if block._arm() != "fp32":
                quantized = True
                q_layers += 1
                for dt in block.export_dtypes():
                    _count(dt)
                return  # the shadowed fp32 original is dead here
            _walk(block._orig)
            return
        for p in getattr(block, "_reg_params", {}).values():
            _count(p.dtype)
        for child in getattr(block, "_children", {}).values():
            _walk(child)

    _walk(net)
    return {
        "batch": int(shape[0]) if shape else 1,
        "item_shape": [int(s) for s in shape[1:]],
        "dtype": dtype,
        "platforms": list(platforms),
        "quantized": bool(quantized),
        "quantized_layers": int(q_layers),
        "param_dtypes": dtype_counts,
    }


def _frame(meta_doc, blob, extra_meta):
    """The v2 file bytes: ``extra_meta`` keys join the metadata unless
    they would override one of its own (reserved) keys."""
    if extra_meta:
        for k, v in dict(extra_meta).items():
            if k not in meta_doc:
                meta_doc[k] = v
    meta = json.dumps(meta_doc, sort_keys=True).encode("utf-8")
    return _MAGIC2 + _HEADER2.pack(zlib.crc32(meta + blob) & 0xFFFFFFFF,
                                   len(blob), len(meta)) + meta + blob


def export_model(net, example_input, path, platforms=("cpu", "cuda"),
                 extra_meta=None):
    """Write ``net``'s inference program (weights included) to ``path``
    as a framed artifact.  ``example_input`` (NDArray, tensor or numpy)
    fixes the input signature the metadata records: its batch is the
    batch the artifact serves (``ModelServer.from_artifact`` pads every
    batch to it).  ``net`` is a HybridBlock whose layers have a symbolic
    form (``HybridBlock.export``'s trace); deferred widths are resolved
    from the example first.  ``extra_meta``: extra JSON-able keys for
    the metadata (``model_version``, ``stream_cursor``, ...); the
    reserved keys (``batch``, ``item_shape``, ...) cannot be overridden.
    The write is atomic (temp file, fsync, rename).  Returns ``path``."""
    from .gluon.block import HybridBlock, _collect_all_params
    from .resilience.checkpoint import atomic_write_bytes

    if not isinstance(net, HybridBlock):
        raise MXNetError(
            f"export_model needs a HybridBlock: the artifact carries the "
            f"net's symbol graph, and a {type(net).__name__} has no "
            "symbolic form")
    shape, dtype, x = _example_array(example_input)
    if any(p._tensor() is None for p in _collect_all_params(net)):
        net.infer_shape(x)
    out, graph, params = net._export_bytes()
    # the metadata right after the trace, under the caller's autotune
    # scope: it must describe the arm the trace baked
    meta_doc = _net_meta(net, shape, dtype, platforms)
    if "data" not in out.list_inputs():
        raise MXNetError("export_model: the traced graph reads no 'data' "
                         "input")
    graph = graph.encode("utf-8")
    blob = _SYMBOL_MAGIC + _SYMBOL_HEADER.pack(len(graph), len(params)) \
        + graph + params
    atomic_write_bytes(path, _frame(meta_doc, blob, extra_meta),
                       inject_point=None)
    if meta_doc.get("quantized"):
        try:
            from . import telemetry

            telemetry.quantize(
                "export", mode="",
                layers=int(meta_doc["quantized_layers"]))
        except Exception:
            pass  # telemetry must never kill an export
    return path


def _to_numpy(a):
    import torch

    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return onp.asarray(a)


def _flatten_params(tree, prefix=""):
    """Flatten a nested dict/list param tree into ``{"a/0/b": array}``
    (numpy) — the npz keys of a generative artifact payload, the
    reference's."""
    flat = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            flat.update(_flatten_params(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            flat.update(_flatten_params(v, f"{prefix}{i}/"))
    else:
        flat[prefix[:-1]] = _to_numpy(tree)
    return flat


def _unflatten_params(flat):
    root = {}
    for key in sorted(flat):
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = flat[key]

    def fix(node):
        if isinstance(node, dict):
            if node and all(k.isdigit() for k in node):
                return [fix(node[str(i)]) for i in range(len(node))]
            return {k: fix(v) for k, v in node.items()}
        return node

    return fix(root)


def _dtype_histogram(flat):
    counts = {}
    for arr in flat.values():
        dt = str(arr.dtype)
        counts[dt] = counts.get(dt, 0) + 1
    return counts


def export_generative(params, path, *, vocab, layers, heads, head_dim,
                      prompt_buckets=(4, 8, 16), max_new=16,
                      extra_meta=None):
    """Write a generative (decoder-only) model as a v2 artifact: the
    parameter tree (tensors or arrays) as the npz payload, the decode
    configuration under a ``"gen"`` metadata key and ``"generative":
    true`` in the header.  The file loads in either package
    (:func:`load_generative`); the fleet's ``ModelHost`` serves it
    through a ``GenerativeServer``."""
    from .resilience.checkpoint import atomic_write_bytes

    flat = _flatten_params(params)
    buf = io.BytesIO()
    onp.savez(buf, **flat)
    meta_doc = {
        "generative": True,
        # token-stream input signature: what admission/residency
        # reports show for a generative artifact
        "batch": 1,
        "item_shape": [int(max(prompt_buckets))],
        "dtype": "int32",
        "platforms": ["cpu", "cuda"],
        "quantized": False,
        "param_dtypes": _dtype_histogram(flat),
        "gen": {"vocab": int(vocab), "layers": int(layers),
                "heads": int(heads), "head_dim": int(head_dim),
                "prompt_buckets": [int(b) for b in prompt_buckets],
                "max_new": int(max_new)},
    }
    atomic_write_bytes(path, _frame(meta_doc, buf.getvalue(), extra_meta),
                       inject_point=None)
    return path


def load_generative(path):
    """Load + verify a generative artifact; returns ``(params, gen)``:
    the decoder's parameter tree as numpy arrays and the decode
    configuration the exporter stamped.  Refuses a dense artifact with a
    clean :class:`MXNetError`."""
    meta, payload = _read_meta_payload(path)
    if not (meta or {}).get("generative"):
        raise MXNetError(
            f"deploy artifact {path!r} is not a generative export "
            "(load it with deploy.load_model / load_exported)")
    try:
        with onp.load(io.BytesIO(payload)) as z:
            flat = {k: z[k] for k in z.files}
    except Exception as e:  # noqa: BLE001 — name the artifact, always
        raise MXNetError(
            f"failed to deserialize generative artifact {path!r}: "
            f"{e!r}") from e
    return _unflatten_params(flat), dict(meta.get("gen") or {})


def _read_meta_payload(path):
    """Read + integrity-check an artifact; returns ``(meta, payload)``
    where ``meta`` is the v2 header metadata dict (None for v1 /
    headerless files).  v2 verifies CRC32 over meta+payload, v1 over
    the payload; headerless files pass through whole."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError as e:
        raise MXNetError(
            f"cannot read deploy artifact {path!r}: {e}") from e
    if data.startswith(_MAGIC2):
        off = len(_MAGIC2)
        if len(data) < off + _HEADER2.size:
            raise MXNetError(
                f"corrupt deploy artifact {path!r}: truncated header "
                f"({len(data)} bytes)")
        crc, length, meta_len = _HEADER2.unpack_from(data, off)
        body = data[off + _HEADER2.size:]
        if len(body) != meta_len + length:
            raise MXNetError(
                f"corrupt deploy artifact {path!r}: body is "
                f"{len(body)} bytes, header says {meta_len} metadata "
                f"+ {length} payload (truncated or partially written)")
        if zlib.crc32(body) & 0xFFFFFFFF != crc:
            raise MXNetError(
                f"corrupt deploy artifact {path!r}: CRC32 mismatch "
                "(bit rot or torn write)")
        try:
            meta = json.loads(body[:meta_len].decode("utf-8"))
        except ValueError as e:
            raise MXNetError(
                f"corrupt deploy artifact {path!r}: unparseable "
                f"metadata segment ({e})") from e
        return meta, body[meta_len:]
    if not data.startswith(_MAGIC):
        return None, data  # legacy headerless: best-effort load
    off = len(_MAGIC)
    if len(data) < off + _HEADER.size:
        raise MXNetError(
            f"corrupt deploy artifact {path!r}: truncated header "
            f"({len(data)} bytes)")
    crc, length = _HEADER.unpack_from(data, off)
    blob = data[off + _HEADER.size:]
    if len(blob) != length:
        raise MXNetError(
            f"corrupt deploy artifact {path!r}: payload is "
            f"{len(blob)} bytes, header says {length} (truncated or "
            "partially written)")
    if zlib.crc32(blob) & 0xFFFFFFFF != crc:
        raise MXNetError(
            f"corrupt deploy artifact {path!r}: CRC32 mismatch "
            "(bit rot or torn write)")
    return None, blob


def read_artifact_meta(path):
    """The v2 header metadata WITHOUT reading the payload: magic +
    header + the (small) metadata segment, no CRC verification (the
    caller has loaded, and so verified, the artifact already); the
    cheap identity probe for residency reports.  None for v1/headerless
    artifacts or on any read problem."""
    try:
        with open(path, "rb") as f:
            head = f.read(len(_MAGIC2) + _HEADER2.size)
            if not head.startswith(_MAGIC2) \
                    or len(head) < len(_MAGIC2) + _HEADER2.size:
                return None
            _, _, meta_len = _HEADER2.unpack_from(head, len(_MAGIC2))
            if meta_len > (1 << 20):
                return None  # implausible header: refuse to trust it
            meta = f.read(meta_len)
            if len(meta) != meta_len:
                return None
            doc = json.loads(meta.decode("utf-8"))
            return doc if isinstance(doc, dict) else None
    except (OSError, ValueError):
        return None


class Exported:
    """A loaded dense artifact: the handle ``ModelServer.from_artifact``
    and ``ModelHost`` serve (the reference's ``jax.export.Exported``).

    ``in_avals``/``out_avals``: the shapes and dtypes of the one input
    (the metadata's signature) and of the outputs; ``platforms``: the
    metadata's; ``block``: the graph as a SymbolBlock on ``device``,
    hybridized with both static flags (on the card each input shape is
    one captured CUDA graph); ``call(x)``: the outputs for one input
    (a tensor, an NDArray or numpy), a tensor or a list of them on
    ``device``."""

    def __init__(self, path, meta, graph, params, device):
        from .context import Context, cpu
        from .gluon.block import SymbolBlock
        from .ndarray.ndarray import load_buffer
        from .symbol.symbol import load_json, var

        self.path = str(path)
        self.meta = dict(meta)
        self.device = device
        sym = load_json(graph)
        block = SymbolBlock(sym, [var("data")])
        ctx = Context("gpu", device.index or 0) if device.type == "cuda" \
            else cpu()
        block.collect_params().initialize(ctx=ctx)
        block._load_parameter_dict(load_buffer(params, ctx=cpu()),
                                   self.path)
        block.hybridize(static_alloc=True, static_shape=True)
        self.block = block
        shape = (int(meta["batch"]),) + tuple(int(s) for s in
                                              meta["item_shape"])
        self.in_avals = (Aval(shape, onp.dtype(meta["dtype"])),)
        _, out_shapes, _ = sym.infer_shape(data=shape)
        self.out_avals = tuple(Aval(tuple(s), onp.dtype(meta["dtype"]))
                               for s in out_shapes)
        self.platforms = tuple(meta.get("platforms", ()))

    def call(self, x):
        import torch

        from .ndarray.ndarray import NDArray

        if isinstance(x, NDArray):
            x = x._data
        elif not isinstance(x, torch.Tensor):
            x = torch.from_numpy(onp.ascontiguousarray(x))
        out = self.block(NDArray(x.to(self.device)))
        if isinstance(out, (list, tuple)):
            return [o._data for o in out]
        return out._data


def _what_payload(blob):
    if _MLIR_MAGIC in blob[:4096]:
        return ("a StableHLO program serialized by jax.export (the JAX "
                "package's export_model)")
    return "no symbol graph this package wrote"


def load_exported(path, ctx=None):
    """Load + verify an artifact: the :class:`Exported` handle the model
    server warm-starts from, its graph on ``ctx`` (default: the current
    context, ``gpu(0)``).  A generative artifact, an artifact of the JAX
    package (a StableHLO payload) or a payload that does not parse
    raises :class:`MXNetError` naming the path."""
    from .context import current_context, resolve_device

    meta, blob = _read_meta_payload(path)
    if (meta or {}).get("generative"):
        raise MXNetError(
            f"deploy artifact {path!r} is a generative export — load "
            "it with deploy.load_generative (the fleet's ModelHost "
            "does this automatically)")
    if not blob.startswith(_SYMBOL_MAGIC):
        raise MXNetError(
            f"deploy artifact {path!r} holds {_what_payload(blob)}; this "
            "package runs the symbol graph and .params that its own "
            "deploy.export_model writes (re-export the net with "
            "mxnet_tpu_torch.deploy.export_model)")
    if meta is None:
        raise MXNetError(
            f"deploy artifact {path!r} has a symbol graph but no "
            "metadata segment (no input signature)")
    device = resolve_device(ctx if ctx is not None else current_context())
    try:
        off = len(_SYMBOL_MAGIC)
        n_graph, n_params = _SYMBOL_HEADER.unpack_from(blob, off)
        off += _SYMBOL_HEADER.size
        if len(blob) != off + n_graph + n_params:
            raise ValueError(f"payload is {len(blob)} bytes, its header "
                             f"says {off + n_graph + n_params}")
        graph = blob[off:off + n_graph].decode("utf-8")
        params = blob[off + n_graph:]
        return Exported(path, meta, graph, params, device)
    except MXNetError:
        raise
    except Exception as e:  # noqa: BLE001 — name the artifact, always
        raise MXNetError(
            f"failed to deserialize deploy artifact {path!r}: {e!r} "
            "(re-export with deploy.export_model)") from e


def artifact_info(path):
    """Shape/dtype metadata of an artifact's input signature without
    building the runner: ``{"batch", "item_shape", "dtype",
    "platforms", "quantized", "param_dtypes"}``, from the verified v2
    metadata alone; a v1/headerless artifact falls back to loading it
    (on the host), with ``quantized`` and ``param_dtypes`` None."""
    meta, _ = _read_meta_payload(path)
    if meta is not None:
        return {"batch": int(meta["batch"]),
                "item_shape": tuple(int(s)
                                    for s in meta["item_shape"]),
                "dtype": str(meta["dtype"]),
                "platforms": tuple(meta.get("platforms", ())),
                "quantized": meta.get("quantized"),
                "param_dtypes": meta.get("param_dtypes")}
    exp = load_exported(path, ctx="cpu")
    aval = exp.in_avals[0]
    return {"batch": int(aval.shape[0]),
            "item_shape": tuple(int(s) for s in aval.shape[1:]),
            "dtype": str(aval.dtype),
            "platforms": tuple(exp.platforms),
            "quantized": None, "param_dtypes": None}


def load_model(path, ctx=None):
    """Load a serialized artifact; returns ``f(x) -> NDArray`` (a list
    of them for several outputs) on ``ctx`` (default: the current
    context).  No model Python code is needed: the artifact carries the
    graph and the weights.  Integrity is verified before the payload is
    read; corruption raises :class:`MXNetError` naming the path."""
    from .ndarray.ndarray import NDArray

    exp = load_exported(path, ctx=ctx)

    def run(x):
        out = exp.call(x)
        if isinstance(out, list):
            return [NDArray(o) for o in out]
        return NDArray(out)

    return run


def stablehlo_text(net, example_input):
    """The reference returns the StableHLO text of the inference
    forward.  This package's programs are symbol graphs run by PyTorch,
    so it raises (ROADMAP §C); ``HybridBlock.export`` writes the graph's
    JSON, the exchange format of this package's artifacts."""
    raise MXNetError(
        "stablehlo_text is not available: this package's deploy "
        "artifacts carry the net's symbol graph and .params (run by "
        "PyTorch), not StableHLO; HybridBlock.export writes the graph's "
        "JSON")
