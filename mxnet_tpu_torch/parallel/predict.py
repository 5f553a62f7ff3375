"""Inference predictor with a measured micro-batch split (counterpart of
``mxnet_tpu/parallel/predict.py``).

The reference runs a batch-B forward as k sequential chunks of B/k
inside one jitted program and picks k by measuring, as upstream's
``cudnn_tune='fastest'`` picks a convolution algorithm at bind time.  On
the card the program is a CUDA graph (``gluon/_graph.py``), one for each
input shape a predictor is called at:

* ``unroll=True`` (the reference's k chunk programs inlined): one graph
  over all k chunks and their concatenation;
* ``unroll=False`` (the reference's ``lax.map``, one compiled chunk
  body): one graph of a single chunk, replayed k times, the outputs
  concatenated.

On the host both forms run the same loop of k chunks, op by op.  The
race (:func:`tune_microbatch`) times each form with CUDA events and
persists its winner through :mod:`~mxnet_tpu_torch.autotune`, keyed on
the reference's parameter-signature digest, the sample batch's shape
and dtype, and the platform (``cuda`` or ``cpu``).
"""
from __future__ import annotations

import hashlib

import torch

__all__ = ["make_predict_fn", "tune_microbatch"]

#: chunk counts up to this unroll by default (the reference's limit)
_UNROLL_LIMIT = 8


def _flat(out):
    """``(tensors, is_sequence)`` of a forward's output."""
    if isinstance(out, torch.Tensor):
        return [out], False
    return list(out), True


def _cat(chunks, seq):
    """Concatenate the per-chunk outputs along the batch axis."""
    if not seq:
        return torch.cat([c[0] for c in chunks], 0)
    return [torch.cat(parts, 0) for parts in zip(*chunks)]


def make_predict_fn(apply_fn, *, microbatch=1, unroll="auto"):
    """``predict(params, x)`` that runs ``apply_fn(params, xc)`` over
    ``microbatch`` sequential chunks of the leading batch axis and
    concatenates each output (a tensor or a sequence of tensors).
    microbatch=1 is the plain full-batch forward.  On a CUDA tensor the
    forward replays CUDA graphs, one program per input shape and dtype
    (module docstring); ``unroll`` chooses the form ("auto": unrolled
    for k <= 8).  Parameters are read
    by address: update them in place.  A batch that k does not divide
    raises ``ValueError``."""
    from ..gluon._graph import GraphProgram

    k = int(microbatch)
    if unroll == "auto":
        unroll = k <= _UNROLL_LIMIT
    unroll = bool(unroll)
    programs = {}
    seq = {}

    def chunked(params, x):
        outs = [_flat(apply_fn(params, c)) for c in x.chunk(k, 0)]
        seq["out"] = outs[0][1]
        return _cat([o for o, _ in outs], outs[0][1])

    def whole(params, x):
        out, seq["out"] = _flat(apply_fn(params, x))
        return out if seq["out"] else out[0]

    def program(params, x, body):
        key = (tuple(x.shape), x.dtype, x.device)
        prog = programs.get(key)
        if prog is None:
            def fn(_aliases, xin):
                out = body(params, xin)
                return out if isinstance(out, list) else [out]

            prog = programs[key] = GraphProgram(
                fn, [x], [], [], False, f"predict(k={k}, "
                f"{'unroll' if unroll else 'map'})")
        outs = prog.forward([x])
        return outs if seq["out"] else outs[0]

    @torch.no_grad()
    def predict(params, x):
        b = x.shape[0]
        if k > 1 and b % k:
            raise ValueError(f"batch {b} not divisible by microbatch {k}")
        if x.device.type != "cuda":
            return whole(params, x) if k == 1 else chunked(params, x)
        if k == 1:
            return program(params, x, whole)
        if unroll:
            return program(params, x, chunked)
        outs = [program(params, c.contiguous(), whole)
                for c in x.chunk(k, 0)]
        return _cat([o if seq["out"] else [o] for o in outs], seq["out"])

    return predict


def _leaves(tree):
    """The leaves of a params tree in ``jax.tree_util``'s order (dict
    keys sorted, sequences in order)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [tree]


def _params_digest(params):
    """The reference's params-signature digest (leaf shapes and dtype
    names), so two nets that share an input shape keep their own
    winners and the key reads as the reference's."""
    sig = ",".join(
        f"{tuple(getattr(leaf, 'shape', ()))}"
        f"{str(getattr(leaf, 'dtype', '')).replace('torch.', '')}"
        for leaf in _leaves(params))
    return hashlib.sha1(sig.encode()).hexdigest()[:12]


def _enc_form(k, unroll):
    return f"{k}:{'unroll' if unroll else 'map'}"


def tune_microbatch(apply_fn, params, sample_x, candidates=(1, 2, 4),
                    iters=20, try_unroll=True, use_cache=None):
    """Time ``apply_fn`` under each micro-batch split of the sample batch
    (for k > 1 both the map and unrolled forms) and return ``(best,
    results)``: best = ``(k, unroll)``, results maps ``(k, unroll)`` to
    seconds a call.  Candidates that do not divide the batch are
    skipped.  Timing: ``autotune.time_call`` (one warm-up call, which
    captures the graph, then ``iters`` calls between two CUDA events; a
    host clock on the CPU).

    The winner persists in ``autotune.json`` (op ``predict_microbatch:``
    + the params digest, the batch's shape and dtype, platform ``cuda``
    or ``cpu``): a later call, or another process, with the same
    signature reloads the recorded winner and timings when the stored
    race is exactly the one this call would run.  ``use_cache=None``
    follows ``MXNET_AUTOTUNE`` (level 2 re-times even on a hit);
    ``use_cache=False`` bypasses."""
    from .. import autotune as at

    b = sample_x.shape[0]
    candidates = tuple(candidates)
    if not any(k >= 1 and b % k == 0 for k in candidates):
        candidates = candidates + (1,)  # always have a valid baseline
    op_key = "predict_microbatch:" + _params_digest(params)
    dtype = str(sample_x.dtype).replace("torch.", "")
    platform = "cuda" if sample_x.device.type == "cuda" else "cpu"
    want = set()
    for k in candidates:
        if k < 1 or b % k:
            continue
        want.add((k, False))
        if k > 1 and try_unroll:
            want.add((k, True))
    lvl = at.autotune_level() if use_cache is None else \
        int(bool(use_cache))
    if lvl == 1:
        entry = at.lookup_entry(op_key, sample_x.shape, dtype, platform)
        # a corrupt or partly written autotune.json means re-tune,
        # never a crash
        try:
            w = entry.get("winner") if entry else None
        except AttributeError:
            w = None
        if isinstance(w, (list, tuple)) and len(w) == 2 \
                and w[0] in candidates and b % int(w[0]) == 0:
            results = {}
            try:
                for ks, t in (entry.get("timings") or {}).items():
                    kk, form = str(ks).split(":")
                    results[(int(kk), form == "unroll")] = float(t)
            except (AttributeError, TypeError, ValueError):
                results = {}
            best = (int(w[0]), bool(w[1]))
            # the stored race must be exactly what this call would run
            if best in results and results[best] == min(results.values()) \
                    and set(results) == want:
                return best, results
    results = {}
    for k, unroll in sorted(want):
        pred = make_predict_fn(apply_fn, microbatch=k, unroll=unroll)
        results[(k, unroll)] = at.time_call(
            lambda: pred(params, sample_x), sample_x.device, iters=iters)
        del pred
    best = min(results, key=results.get)
    if lvl >= 1:
        at.record(op_key, sample_x.shape, dtype,
                  [int(best[0]), bool(best[1])], platform,
                  timings={_enc_form(k, u): float(t)
                           for (k, u), t in results.items()})
    return best, results
