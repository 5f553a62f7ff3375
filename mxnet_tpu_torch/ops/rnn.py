"""Fused multi-layer RNN op (LSTM / GRU / vanilla RNN), the counterpart
of ``mxnet_tpu/ops/rnn.py``.

The reference runs one ``lax.scan`` per (layer, direction); upstream
MXNet's GPU op calls cuDNN (``rnn-inl.h:444-476``).  The port has two
arms, picked by the data's device, each counting its calls:

- :func:`loop_layer`, the plain version: the reference's time loop in
  PyTorch, step by step.  It is the CPU path and the parity oracle
  (``loop_layer.launches`` counts layers run);
- :func:`cudnn_layer`: one ``torch._VF`` call per layer (both
  directions), what ``torch.nn.LSTM.forward`` calls, which on a CUDA
  tensor runs cuDNN's RNN (``cudnn_layer.launches`` counts them).  It
  is no kernel port: no Pallas kernel lies on this path.

On a CUDA tensor :func:`rnn` runs the cuDNN arm or raises (cuDNN
disabled, a dtype cuDNN refuses); it never runs the loop.  On any other
device it runs the loop.  One call per layer, not one for the stack,
because the reference's dropout between layers is the port's own draw
(``_rng.draw_bernoulli``), which a check can feed.

Weight packing is the reference's (cuDNN's) flat vector: for each layer,
for each direction, W_i2h (G*H, in), W_h2h (G*H, r) [, W_proj (r, H)
under LSTMP]; then for each layer and direction b_i2h (G*H), b_h2h
(G*H).  Gate order: LSTM [i, f, g, o]; GRU [r, z, n] with
``n = tanh(ni + r·nh)``.  The cuDNN arm's weights are views into that
vector, packed per layer by one ``torch.cat`` into cuDNN's layout,
which is that order for one layer (so cuDNN takes the buffer as it is
and does not compact it again), and their gradients reach the vector
through autograd.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import _rng
from ..base import MXNetError
from .registry import register_op

__all__ = ["unpack_rnn_params", "rnn_param_size", "rnn", "rnn_arm",
           "loop_layer", "cudnn_layer"]

_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}


def unpack_rnn_params(params, mode, num_layers, input_size, state_size,
                      bidirectional=False, projection_size=None):
    """Split the flat parameter vector into per (layer, direction)
    ``(w_i2h, w_h2h, w_proj)`` and ``(b_i2h, b_h2h)`` views (``w_proj``
    None without a projection)."""
    g = _GATES[mode]
    d = 2 if bidirectional else 1
    h = state_size
    r = projection_size if projection_size else h
    ws, bs = [], []
    off = 0
    for layer in range(num_layers):
        ins = input_size if layer == 0 else r * d
        for _ in range(d):
            w_i2h = params[off:off + g * h * ins].reshape(g * h, ins)
            off += g * h * ins
            w_h2h = params[off:off + g * h * r].reshape(g * h, r)
            off += g * h * r
            if projection_size:
                w_proj = params[off:off + r * h].reshape(r, h)
                off += r * h
            else:
                w_proj = None
            ws.append((w_i2h, w_h2h, w_proj))
    for layer in range(num_layers):
        for _ in range(d):
            b_i2h = params[off:off + g * h]
            off += g * h
            b_h2h = params[off:off + g * h]
            off += g * h
            bs.append((b_i2h, b_h2h))
    return ws, bs


def rnn_param_size(mode, num_layers, input_size, state_size,
                   bidirectional=False, projection_size=None):
    g = _GATES[mode]
    d = 2 if bidirectional else 1
    h = state_size
    r = projection_size if projection_size else h
    size = 0
    for layer in range(num_layers):
        ins = input_size if layer == 0 else r * d
        size += d * (g * h * ins + g * h * r + 2 * g * h)
        if projection_size:
            size += d * r * h
    return size


def _cell_step(mode, w_i2h, w_h2h, b_i2h, b_h2h, x, h_prev, c_prev,
               w_proj=None):
    gi = F.linear(x, w_i2h, b_i2h)
    gh = F.linear(h_prev, w_h2h, b_h2h)
    if mode == "lstm":
        i, f, g, o = torch.chunk(gi + gh, 4, dim=-1)
        i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
        c = f * c_prev + i * torch.tanh(g)
        h = o * torch.tanh(c)
        if w_proj is not None:  # LSTMP recurrent projection
            h = F.linear(h, w_proj)
        return h, c
    if mode == "gru":
        ri, zi, ni = torch.chunk(gi, 3, dim=-1)
        rh, zh, nh = torch.chunk(gh, 3, dim=-1)
        r = torch.sigmoid(ri + rh)
        z = torch.sigmoid(zi + zh)
        n = torch.tanh(ni + r * nh)
        return (1 - z) * n + z * h_prev, c_prev
    act = torch.relu if mode == "rnn_relu" else torch.tanh
    return act(gi + gh), c_prev


def loop_layer(mode, wbs, x, h0, c0):
    """One layer, the plain version: per direction the reference's scan
    as a loop over time steps (the second direction runs backwards and
    its outputs stay at their steps).  ``wbs`` holds one ``(weights,
    biases)`` per direction, ``h0``/``c0`` (D, N, ·).  Returns the
    layer's output (T, N, D·r) and the final ``h``, ``c`` per
    direction."""
    if x.device.type != "meta":
        loop_layer.launches += 1
    outs, h_fin, c_fin = [], [], []
    t_len = x.shape[0]
    for direction, ((w_i2h, w_h2h, w_proj), (b_i2h, b_h2h)) in \
            enumerate(wbs):
        h, c = h0[direction], c0[direction]
        ys = [None] * t_len
        steps = range(t_len - 1, -1, -1) if direction == 1 \
            else range(t_len)
        for t in steps:
            h, c = _cell_step(mode, w_i2h, w_h2h, b_i2h, b_h2h, x[t], h, c,
                              w_proj)
            ys[t] = h
        outs.append(torch.stack(ys))
        h_fin.append(h)
        c_fin.append(c)
    return (outs[0] if len(outs) == 1 else torch.cat(outs, dim=-1),
            h_fin, c_fin)


loop_layer.launches = 0


def cudnn_layer(mode, wbs, x, h0, c0):
    """One layer, both directions, in one ``torch._VF`` call: cuDNN's
    RNN on a CUDA tensor (raises where cuDNN would not run it), torch's
    own fused loop on the host (what the CPU tests hold the packing
    with).  Same arguments and results as :func:`loop_layer`."""
    proj = wbs[0][0][2] is not None
    if x.is_cuda:
        if not torch.backends.cudnn.is_acceptable(x):
            raise MXNetError(
                f"the RNN op runs cuDNN on a CUDA tensor, and cuDNN does "
                f"not take this one (dtype {x.dtype}, cuDNN enabled: "
                f"{torch.backends.cudnn.enabled}); no other arm runs on "
                f"the card")
        if proj and h0.shape[-1] == c0.shape[-1]:
            raise MXNetError("cuDNN's LSTMP needs projection_size != "
                             "state_size")
    cudnn_layer.launches += 1
    # one buffer in cuDNN's layout for the layer (every direction's
    # W_ih, W_hh [, W_hr], then every direction's b_ih, b_hh: the
    # reference's own order, one layer of it), so cuDNN takes it without
    # compacting it again; torch._VF takes the views per direction as
    # W_ih, W_hh, b_ih, b_hh [, W_hr]
    n_w = 3 if proj else 2
    weights = [w for ws, _ in wbs for w in ws[:n_w]]
    biases = [b for _, bs in wbs for b in bs]
    flat = weights + biases
    buf = torch.cat([t.reshape(-1) for t in flat])
    parts = [v.view(t.shape) for v, t in
             zip(buf.split([t.numel() for t in flat]), flat)]
    views = []
    for k in range(len(wbs)):
        w = parts[k * n_w:(k + 1) * n_w]
        b = parts[len(weights) + 2 * k:len(weights) + 2 * k + 2]
        views += [w[0], w[1], b[0], b[1]] + w[2:]
    bidirectional = len(wbs) == 2
    fn = getattr(torch._VF, mode)  # lstm, gru, rnn_tanh, rnn_relu
    args = (views, True, 1, 0.0, torch.is_grad_enabled(), bidirectional,
            False)
    x = x.contiguous()
    if mode == "lstm":
        out, h_n, c_n = fn(x, (h0.contiguous(), c0.contiguous()), *args)
        return out, list(h_n.unbind(0)), list(c_n.unbind(0))
    out, h_n = fn(x, h0.contiguous(), *args)
    return out, list(h_n.unbind(0)), list(c0.unbind(0))


cudnn_layer.launches = 0


def _rnn_nout(p):
    n = 1
    if p.get("state_outputs", False):
        n += 2 if p.get("mode", "lstm") == "lstm" else 1
    return n


def rnn_arm(layer_fn, data, parameters, state, state_cell=None, *,
            state_size, num_layers, mode="lstm", bidirectional=False,
            p=0.0, state_outputs=False, projection_size=None,
            lstm_state_clip_min=None, lstm_state_clip_max=None,
            lstm_state_clip_nan=False, use_sequence_length=False,
            key=None, train=False):
    """The RNN op with its layers run by ``layer_fn`` (:func:`loop_layer`
    or :func:`cudnn_layer`) on any device."""
    t, n, input_size = data.shape
    d = 2 if bidirectional else 1
    if projection_size is not None and mode != "lstm":
        raise ValueError("projection_size is LSTM-only (rnn-inl.h:444)")
    ws, bs = unpack_rnn_params(parameters, mode, num_layers, input_size,
                               state_size, bidirectional, projection_size)
    x = data
    h_fin, c_fin = [], []
    for layer in range(num_layers):
        rows = slice(layer * d, (layer + 1) * d)
        h0 = state[rows]
        if mode == "lstm" and state_cell is not None:
            c0 = state_cell[rows]
        else:
            c0 = torch.zeros((d, n, state_size), dtype=h0.dtype,
                             device=h0.device)
        x, h_t, c_t = layer_fn(mode, list(zip(ws[rows], bs[rows])), x, h0,
                               c0)
        h_fin += h_t
        c_fin += c_t
        if train and p > 0 and layer < num_layers - 1 and key is not None:
            mask = _rng.draw_bernoulli(1 - p, tuple(x.shape), x.device, key)
            x = torch.where(mask, x / (1 - p), torch.zeros((), dtype=x.dtype,
                                                         device=x.device))
    # the final cell states are clipped, not the cell states of each step
    if mode == "lstm" and lstm_state_clip_min is not None:
        c_fin = [torch.clamp(c, lstm_state_clip_min, lstm_state_clip_max)
                 for c in c_fin]
    if not state_outputs:
        return x
    hs = torch.stack(h_fin)
    if mode == "lstm":
        return x, hs, torch.stack(c_fin)
    return x, hs


@register_op("RNN", num_outputs=_rnn_nout, key_param="key",
             train_param="train")
def rnn(data, parameters, state, state_cell=None, *, state_size, num_layers,
        mode="lstm", bidirectional=False, p=0.0, state_outputs=False,
        projection_size=None, lstm_state_clip_min=None,
        lstm_state_clip_max=None, lstm_state_clip_nan=False,
        use_sequence_length=False, key=None, train=False):
    """data: (T, N, I); state: (L*dir, N, r). Returns output (T, N,
    r*dir) [+ final h [+ final c for lstm] when state_outputs].  The
    cuDNN arm on a CUDA tensor, the loop elsewhere; the dropout between
    layers draws from ``key`` (a ``torch.Generator``) when training."""
    return rnn_arm(
        cudnn_layer if data.is_cuda else loop_layer, data, parameters,
        state, state_cell, state_size=state_size, num_layers=num_layers,
        mode=mode, bidirectional=bidirectional, p=p,
        state_outputs=state_outputs, projection_size=projection_size,
        lstm_state_clip_min=lstm_state_clip_min,
        lstm_state_clip_max=lstm_state_clip_max,
        lstm_state_clip_nan=lstm_state_clip_nan,
        use_sequence_length=use_sequence_length, key=key, train=train)
