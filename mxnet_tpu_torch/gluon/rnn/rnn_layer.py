"""RNN / LSTM / GRU layers over the fused RNN op (counterpart of
``mxnet_tpu/gluon/rnn/rnn_layer.py``).

Parameters are kept per (layer, direction) under the reference's names
(``{l,r}{i}_{i2h,h2h,h2r}_{weight,bias}``) and packed into the op's flat
vector at each forward, weights then biases, layer-major and
direction-minor (``ops/rnn.py``), by one ``torch.cat`` through which
the gradients reach them.  The input width may be deferred
(``input_size=0``); layouts TNC and NTC.
"""
from __future__ import annotations

import torch

from ... import _rng
from ...base import MXNetError
from ...ops.rnn import rnn
from ..block import HybridBlock

__all__ = ["RNN", "LSTM", "GRU"]

_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}


class _RNNLayer(HybridBlock):
    def __init__(self, hidden_size, num_layers, layout, dropout,
                 bidirectional, input_size, i2h_weight_initializer,
                 h2h_weight_initializer, i2h_bias_initializer,
                 h2h_bias_initializer, mode, projection_size=None, **kwargs):
        super().__init__(**kwargs)
        if layout not in ("TNC", "NTC"):
            raise MXNetError(f"Invalid layout {layout}; must be TNC or NTC")
        if projection_size is not None and mode != "lstm":
            raise MXNetError("projection_size is LSTM-only "
                             "(reference rnn-inl.h:444)")
        self._hidden_size = hidden_size
        self._projection_size = projection_size
        self._num_layers = num_layers
        self._mode = mode
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        self._gates = _GATES[mode]
        ng, ni, nh = self._gates, input_size, hidden_size
        nr = projection_size if projection_size else nh
        with self.name_scope():
            for i in range(num_layers):
                for j in ["l", "r"][: self._dir]:
                    self._register_param(f"{j}{i}_i2h_weight", (ng * nh, ni),
                                         i2h_weight_initializer)
                    self._register_param(f"{j}{i}_h2h_weight", (ng * nh, nr),
                                         h2h_weight_initializer)
                    if projection_size:
                        self._register_param(f"{j}{i}_h2r_weight", (nr, nh),
                                             h2h_weight_initializer)
                    self._register_param(f"{j}{i}_i2h_bias", (ng * nh,),
                                         i2h_bias_initializer)
                    self._register_param(f"{j}{i}_h2h_bias", (ng * nh,),
                                         h2h_bias_initializer)
                ni = nr * self._dir

    def _register_param(self, name, shape, init):
        p = self.params.get(name, shape=shape, init=init,
                            allow_deferred_init=True)
        setattr(self, name, p)
        return p

    def _infer_param_shapes(self, x, *args):
        ng, nh = self._gates, self._hidden_size
        nr = self._projection_size if self._projection_size else nh
        ni = x.shape[2]  # C is axis 2 in both TNC and NTC
        self._input_size = ni
        for i in range(self._num_layers):
            for j in ["l", "r"][: self._dir]:
                self._reg_params[f"{j}{i}_i2h_weight"].shape = (ng * nh, ni)
            ni = nr * self._dir

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """The initial states, ``func(shape=..., **kwargs)`` each
        (default ``mx.nd.zeros``)."""
        from ... import ndarray as nd

        if func is None:
            func = nd.zeros
        return [func(shape=info["shape"], **kwargs) if "shape" in info
                else func(**kwargs) for info in self.state_info(batch_size)]

    def _packed(self):
        """The op's flat parameter vector: every weight, then every bias,
        layer-major, direction-minor."""
        names = []
        for i in range(self._num_layers):
            for j in ["l", "r"][: self._dir]:
                names += [f"{j}{i}_i2h_weight", f"{j}{i}_h2h_weight"]
                if self._projection_size:
                    names.append(f"{j}{i}_h2r_weight")
        for i in range(self._num_layers):
            for j in ["l", "r"][: self._dir]:
                names += [f"{j}{i}_i2h_bias", f"{j}{i}_h2h_bias"]
        return torch.cat([getattr(self, n).reshape(-1) for n in names])

    def forward(self, inputs, states=None):
        if self._layout == "NTC":
            inputs = torch.swapaxes(inputs, 0, 1)
        batch_size = inputs.shape[1]
        skip_states = states is None
        if skip_states:
            states = [torch.zeros(info["shape"], dtype=inputs.dtype,
                                  device=inputs.device)
                      for info in self.state_info(batch_size)]
        if isinstance(states, torch.Tensor):
            states = [states]
        out = rnn(inputs, self._packed(), *states,
                  state_size=self._hidden_size,
                  num_layers=self._num_layers,
                  bidirectional=self._dir == 2, p=self._dropout,
                  state_outputs=True, mode=self._mode,
                  projection_size=self._projection_size,
                  key=_rng.take_key(inputs.device), train=self.training)
        outputs, states = out[0], list(out[1:])
        if self._layout == "NTC":
            outputs = torch.swapaxes(outputs, 0, 1)
        if skip_states:
            return outputs
        return outputs, states

    def __repr__(self):
        s = "{name}({mapping}, {_layout}"
        if self._num_layers != 1:
            s += ", num_layers={_num_layers}"
        if self._dropout != 0:
            s += ", dropout={_dropout}"
        if self._dir == 2:
            s += ", bidirectional"
        s += ")"
        mapping = "{0} -> {1}".format(
            self._input_size if self._input_size else None,
            self._hidden_size)
        return s.format(name=self.__class__.__name__, mapping=mapping,
                        **self.__dict__)


class RNN(_RNNLayer):
    """Vanilla multi-layer Elman RNN (tanh or relu)."""

    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 layout="TNC", dropout=0, bidirectional=False,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, **kwargs):
        super().__init__(
            hidden_size, num_layers, layout, dropout, bidirectional,
            input_size, i2h_weight_initializer, h2h_weight_initializer,
            i2h_bias_initializer, h2h_bias_initializer,
            "rnn_" + activation, **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]


class LSTM(_RNNLayer):
    """Multi-layer LSTM; ``projection_size`` makes it an LSTMP."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 projection_size=None, **kwargs):
        super().__init__(
            hidden_size, num_layers, layout, dropout, bidirectional,
            input_size, i2h_weight_initializer, h2h_weight_initializer,
            i2h_bias_initializer, h2h_bias_initializer, "lstm",
            projection_size, **kwargs)

    def state_info(self, batch_size=0):
        # h state uses the projected size under LSTMP; c keeps H
        r = self._projection_size or self._hidden_size
        return [
            {"shape": (self._num_layers * self._dir, batch_size, r),
             "__layout__": "LNC"},
            {"shape": (self._num_layers * self._dir, batch_size,
                       self._hidden_size), "__layout__": "LNC"},
        ]


class GRU(_RNNLayer):
    """Multi-layer GRU."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(
            hidden_size, num_layers, layout, dropout, bidirectional,
            input_size, i2h_weight_initializer, h2h_weight_initializer,
            i2h_bias_initializer, h2h_bias_initializer, "gru", **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]
