"""Recurrent cells with an explicit ``unroll`` (counterpart of
``mxnet_tpu/gluon/rnn/rnn_cell.py``).

A cell computes one time step, ``cell(x_t, states) -> (out_t,
states)``; ``unroll`` runs ``length`` steps, merging the outputs along
the layout's time axis on request and, with ``valid_length``, masking
the outputs past each sequence's length (``SequenceMask``) and taking
each sequence's last state (``SequenceLast``).  Cells compute on
tensors; called (or unrolled) on NDArrays they run in the imperative
scope of ``Block`` and give NDArrays back, as the reference's do.
"""
from __future__ import annotations

import torch

from ...base import MXNetError
from ...ops.nn import activation as _activation_op
from ...ops.nn import dropout, fully_connected
from ...ops.sequence_ops import sequence_last, sequence_mask, \
    sequence_reverse
from ..block import Block, HybridBlock, imperative

__all__ = [
    "RecurrentCell",
    "HybridRecurrentCell",
    "RNNCell",
    "LSTMCell",
    "GRUCell",
    "SequentialRNNCell",
    "HybridSequentialRNNCell",
    "DropoutCell",
    "ZoneoutCell",
    "ResidualCell",
    "BidirectionalCell",
]


def _cells_state_info(cells, batch_size):
    return sum([c.state_info(batch_size) for c in cells], [])


def _cells_begin_state(cells, **kwargs):
    return sum([c.begin_state(**kwargs) for c in cells], [])


def _get_begin_state(cell, begin_state, inputs, batch_size):
    """``begin_state``, or the cell's zero states beside the inputs."""
    if begin_state is None:
        x = inputs if isinstance(inputs, torch.Tensor) else inputs[0]
        begin_state = cell.begin_state(
            batch_size=batch_size,
            func=lambda shape, **kw: torch.zeros(shape, dtype=x.dtype,
                                                 device=x.device))
    return begin_state


def _format_sequence(length, inputs, layout, merge):
    """``(inputs, time axis, batch size)``: a tensor split into its steps
    when ``merge`` is False, a list of steps stacked when it is True."""
    axis = layout.find("T")
    batch_axis = layout.find("N")
    if isinstance(inputs, torch.Tensor):
        batch_size = inputs.shape[batch_axis]
        if merge is False:
            inputs = list(torch.unbind(inputs, dim=axis))
    else:
        assert length is None or len(inputs) == length
        batch_size = inputs[0].shape[batch_axis]
        if merge is True:
            inputs = torch.stack(list(inputs), dim=axis)
    if isinstance(inputs, tuple):
        inputs = list(inputs)
    return inputs, axis, batch_size


def _mask_sequence_variable_length(data, length, valid_length, time_axis,
                                   merge):
    assert valid_length is not None
    if isinstance(data, (list, tuple)):
        data = torch.stack(list(data), dim=time_axis)
    outputs = sequence_mask(data, valid_length, use_sequence_length=True,
                            axis=time_axis)
    if not merge:
        outputs = list(torch.unbind(outputs, dim=time_axis))
    return outputs


class RecurrentCell(Block):
    """Abstract cell: one step (``forward``) and ``unroll``."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._modified = False
        self.reset()

    def reset(self):
        self._init_counter = -1
        self._counter = -1
        for cell in self._children.values():
            if isinstance(cell, RecurrentCell):
                cell.reset()

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """The initial states, ``func(shape, dtype=, ctx=)`` each
        (default ``mx.nd.zeros``)."""
        from ... import ndarray as nd

        assert not self._modified, (
            "After applying modifier cells (e.g. ZoneoutCell) the base "
            "cell cannot be called directly. Call the modifier cell instead."
        )
        if func is None:
            func = nd.zeros
        states = []
        for info in self.state_info(batch_size):
            self._init_counter += 1
            if info is not None:
                info.update(kwargs)
            else:
                info = kwargs
            shape = info.pop("shape", None)
            info.pop("__layout__", None)
            states.append(func(shape, **{k: v for k, v in info.items()
                                         if k in ("dtype", "ctx")}))
        return states

    @imperative
    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        """Run ``length`` steps over ``inputs`` (a tensor in ``layout``
        or a list of steps).  Returns ``(outputs, states)``."""
        self.reset()
        inputs, axis, batch_size = _format_sequence(length, inputs, layout,
                                                    False)
        states = _get_begin_state(self, begin_state, inputs, batch_size)
        outputs, all_states = [], []
        for i in range(length):
            output, states = self(inputs[i], states)
            outputs.append(output)
            if valid_length is not None:
                all_states.append(states)
        if valid_length is not None:
            states = [sequence_last(torch.stack(list(ele), dim=0),
                                    valid_length, use_sequence_length=True,
                                    axis=0) for ele in zip(*all_states)]
            outputs = _mask_sequence_variable_length(
                outputs, length, valid_length, axis,
                merge_outputs is not False)
        if merge_outputs and not isinstance(outputs, torch.Tensor):
            outputs = torch.stack(outputs, dim=axis)
        elif merge_outputs is False and isinstance(outputs, torch.Tensor):
            outputs = list(torch.unbind(outputs, dim=axis))
        return outputs, states

    def _get_activation(self, inputs, activation, **kwargs):
        if isinstance(activation, str):
            return _activation_op(inputs, act_type=activation, **kwargs)
        return activation(inputs, **kwargs)


class HybridRecurrentCell(RecurrentCell, HybridBlock):
    """A cell the reference can hybridize; the port runs it eagerly."""


class _GatedCell(HybridRecurrentCell):
    """What the three cells share: ``gates × hidden`` rows of i2h and
    h2h weights and biases, the input width deferred to the first
    step."""

    def _init_params(self, gates, hidden_size, input_size,
                     i2h_weight_initializer, h2h_weight_initializer,
                     i2h_bias_initializer, h2h_bias_initializer):
        self._hidden_size = hidden_size
        self._input_size = input_size
        self._gates = gates
        n = gates * hidden_size
        with self.name_scope():
            self.i2h_weight = self.params.get(
                "i2h_weight", shape=(n, self._input_size),
                init=i2h_weight_initializer, allow_deferred_init=True)
            self.h2h_weight = self.params.get(
                "h2h_weight", shape=(n, self._hidden_size),
                init=h2h_weight_initializer, allow_deferred_init=True)
            self.i2h_bias = self.params.get(
                "i2h_bias", shape=(n,), init=i2h_bias_initializer,
                allow_deferred_init=True)
            self.h2h_bias = self.params.get(
                "h2h_bias", shape=(n,), init=h2h_bias_initializer,
                allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _infer_param_shapes(self, x, *args):
        self._reg_params["i2h_weight"].shape = (
            self._gates * self._hidden_size, x.shape[-1])

    def _i2h_h2h(self, inputs, h):
        n = self._gates * self._hidden_size
        return (fully_connected(inputs, self.i2h_weight, self.i2h_bias,
                                num_hidden=n),
                fully_connected(h, self.h2h_weight, self.h2h_bias,
                                num_hidden=n))


class RNNCell(_GatedCell):
    """Elman cell: ``act(W_i2h x + b_i2h + W_h2h h + b_h2h)``."""

    def __init__(self, hidden_size, activation="tanh",
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._activation = activation
        self._init_params(1, hidden_size, input_size,
                          i2h_weight_initializer, h2h_weight_initializer,
                          i2h_bias_initializer, h2h_bias_initializer)

    def _alias(self):
        return "rnn"

    def forward(self, inputs, states):
        self._counter += 1
        i2h, h2h = self._i2h_h2h(inputs, states[0])
        output = self._get_activation(i2h + h2h, self._activation)
        return output, [output]


class LSTMCell(_GatedCell):
    """LSTM cell, gates [i, f, g, o]."""

    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, prefix=None, params=None,
                 activation="tanh", recurrent_activation="sigmoid"):
        super().__init__(prefix=prefix, params=params)
        self._activation = activation
        self._recurrent_activation = recurrent_activation
        self._init_params(4, hidden_size, input_size,
                          i2h_weight_initializer, h2h_weight_initializer,
                          i2h_bias_initializer, h2h_bias_initializer)

    def state_info(self, batch_size=0):
        return [
            {"shape": (batch_size, self._hidden_size), "__layout__": "NC"},
            {"shape": (batch_size, self._hidden_size), "__layout__": "NC"},
        ]

    def _alias(self):
        return "lstm"

    def forward(self, inputs, states):
        self._counter += 1
        i2h, h2h = self._i2h_h2h(inputs, states[0])
        gates = torch.chunk(i2h + h2h, 4, dim=-1)
        rec = self._recurrent_activation
        in_gate = self._get_activation(gates[0], rec)
        forget_gate = self._get_activation(gates[1], rec)
        in_transform = self._get_activation(gates[2], self._activation)
        out_gate = self._get_activation(gates[3], rec)
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * self._get_activation(next_c, self._activation)
        return next_h, [next_h, next_c]


class GRUCell(_GatedCell):
    """GRU cell, gates [r, z, n], ``n = tanh(ni + r·nh)``."""

    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._init_params(3, hidden_size, input_size,
                          i2h_weight_initializer, h2h_weight_initializer,
                          i2h_bias_initializer, h2h_bias_initializer)

    def _alias(self):
        return "gru"

    def forward(self, inputs, states):
        self._counter += 1
        prev_state_h = states[0]
        i2h, h2h = self._i2h_h2h(inputs, prev_state_h)
        i2h_r, i2h_z, i2h = torch.chunk(i2h, 3, dim=-1)
        h2h_r, h2h_z, h2h = torch.chunk(h2h, 3, dim=-1)
        reset_gate = torch.sigmoid(i2h_r + h2h_r)
        update_gate = torch.sigmoid(i2h_z + h2h_z)
        next_h_tmp = torch.tanh(i2h + reset_gate * h2h)
        next_h = (1.0 - update_gate) * next_h_tmp \
            + update_gate * prev_state_h
        return next_h, [next_h]


class SequentialRNNCell(RecurrentCell):
    """Stack of cells applied in sequence each step."""

    def add(self, cell):
        self.register_child(cell)

    def state_info(self, batch_size=0):
        return _cells_state_info(self._children.values(), batch_size)

    def begin_state(self, **kwargs):
        assert not self._modified
        return _cells_begin_state(self._children.values(), **kwargs)

    def forward(self, inputs, states):
        self._counter += 1
        next_states = []
        p = 0
        for cell in self._children.values():
            assert not isinstance(cell, BidirectionalCell)
            n = len(cell.state_info())
            state = states[p:p + n]
            p += n
            inputs, state = cell(inputs, state)
            next_states.append(state)
        return inputs, sum(next_states, [])

    @imperative
    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        self.reset()
        inputs, _, batch_size = _format_sequence(length, inputs, layout,
                                                 None)
        num_cells = len(self._children)
        begin_state = _get_begin_state(self, begin_state, inputs,
                                       batch_size)
        p = 0
        next_states = []
        for i, cell in enumerate(self._children.values()):
            n = len(cell.state_info())
            states = begin_state[p:p + n]
            p += n
            inputs, states = cell.unroll(
                length, inputs=inputs, begin_state=states, layout=layout,
                merge_outputs=None if i < num_cells - 1 else merge_outputs,
                valid_length=valid_length)
            next_states.extend(states)
        return inputs, next_states

    def __getitem__(self, i):
        return list(self._children.values())[i]

    def __len__(self):
        return len(self._children)


class HybridSequentialRNNCell(SequentialRNNCell, HybridRecurrentCell):
    """Hybridizable stack of cells."""


class DropoutCell(HybridRecurrentCell):
    """Dropout on the step's input while training; no state."""

    def __init__(self, rate, axes=(), prefix=None, params=None):
        super().__init__(prefix, params)
        assert isinstance(rate, (int, float))
        self._rate = rate
        self._axes = axes

    def state_info(self, batch_size=0):
        return []

    def _alias(self):
        return "dropout"

    def forward(self, inputs, states):
        self._counter += 1
        if self._rate > 0:
            inputs = dropout(inputs, p=self._rate, axes=self._axes,
                             train=self.training)
        return inputs, states


class ModifierCell(HybridRecurrentCell):
    """Base for cells wrapping another cell."""

    def __init__(self, base_cell):
        assert not base_cell._modified, (
            "Cell %s is already modified. One cell cannot be modified "
            "twice" % base_cell.name)
        base_cell._modified = True
        super().__init__(prefix=base_cell.prefix + self._alias(),
                         params=None)
        self.base_cell = base_cell

    @property
    def params(self):
        return self.base_cell.params

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, func=None, **kwargs):
        assert not self._modified
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(func=func, **kwargs)
        self.base_cell._modified = True
        return begin


class ZoneoutCell(ModifierCell):
    """Zoneout: while training, each output and state element keeps its
    previous value with probability ``zoneout_outputs`` /
    ``zoneout_states`` (the masks are Dropout draws)."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        assert not isinstance(base_cell, BidirectionalCell), (
            "BidirectionalCell doesn't support zoneout. "
            "Please add ZoneoutCell to the cells underneath instead.")
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self._prev_output = None

    def _alias(self):
        return "zoneout"

    def reset(self):
        super().reset()
        self._prev_output = None

    def forward(self, inputs, states):
        self._counter += 1
        cell, p_outputs, p_states = (
            self.base_cell, self.zoneout_outputs, self.zoneout_states)
        next_output, next_states = cell(inputs, states)

        def mask(p, like):
            return dropout(torch.ones_like(like), p=p,
                           train=self.training) != 0

        prev_output = self._prev_output
        if prev_output is None:
            prev_output = torch.zeros_like(next_output)
        output = (torch.where(mask(p_outputs, next_output), next_output,
                              prev_output)
                  if p_outputs != 0.0 else next_output)
        new_states = (
            [torch.where(mask(p_states, new_s), new_s, old_s)
             for new_s, old_s in zip(next_states, states)]
            if p_states != 0.0 else next_states)
        self._prev_output = output
        return output, new_states


class ResidualCell(ModifierCell):
    """The base cell's output plus its input."""

    def _alias(self):
        return "residual"

    def forward(self, inputs, states):
        self._counter += 1
        output, states = self.base_cell(inputs, states)
        return output + inputs, states

    @imperative
    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        self.reset()
        self.base_cell._modified = False
        outputs, states = self.base_cell.unroll(
            length, inputs=inputs, begin_state=begin_state, layout=layout,
            merge_outputs=merge_outputs, valid_length=valid_length)
        self.base_cell._modified = True
        merge_outputs = (isinstance(outputs, torch.Tensor)
                         if merge_outputs is None else merge_outputs)
        inputs, axis, _ = _format_sequence(length, inputs, layout,
                                           merge_outputs)
        if valid_length is not None:
            inputs = _mask_sequence_variable_length(
                inputs, length, valid_length, axis, merge_outputs)
        if merge_outputs:
            outputs = outputs + inputs
        else:
            outputs = [o + i for o, i in zip(outputs, inputs)]
        return outputs, states


class BidirectionalCell(HybridRecurrentCell):
    """Two cells over the sequence, the second one reversed; their
    outputs concatenated.  Only ``unroll`` runs it."""

    def __init__(self, l_cell, r_cell, output_prefix="bi_"):
        super().__init__(prefix="", params=None)
        self.register_child(l_cell, "l_cell")
        self.register_child(r_cell, "r_cell")
        self._output_prefix = output_prefix

    def __call__(self, inputs, states):
        raise MXNetError(
            "Bidirectional cannot be stepped. Please use unroll")

    def state_info(self, batch_size=0):
        return _cells_state_info(self._children.values(), batch_size)

    def begin_state(self, **kwargs):
        assert not self._modified
        return _cells_begin_state(self._children.values(), **kwargs)

    @imperative
    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        self.reset()
        inputs, axis, batch_size = _format_sequence(length, inputs, layout,
                                                    False)
        reversed_inputs = list(reversed(inputs))
        states = _get_begin_state(self, begin_state, inputs, batch_size)
        l_cell, r_cell = self._children.values()
        n_l = len(l_cell.state_info())
        l_outputs, l_states = l_cell.unroll(
            length, inputs=inputs, begin_state=states[:n_l], layout=layout,
            merge_outputs=merge_outputs, valid_length=valid_length)
        r_outputs, r_states = r_cell.unroll(
            length, inputs=reversed_inputs, begin_state=states[n_l:],
            layout=layout, merge_outputs=False, valid_length=valid_length)
        if valid_length is None:
            reversed_r_outputs = list(reversed(r_outputs))
        else:
            reversed_r_outputs = list(torch.unbind(sequence_reverse(
                torch.stack(r_outputs, dim=0), valid_length,
                use_sequence_length=True, axis=0), dim=0))
        if merge_outputs is None:
            merge_outputs = isinstance(l_outputs, torch.Tensor)
            l_outputs, _, _ = _format_sequence(None, l_outputs, layout,
                                               merge_outputs)
        if merge_outputs:
            reversed_r_outputs = torch.stack(reversed_r_outputs, dim=axis)
            outputs = torch.cat([l_outputs, reversed_r_outputs], dim=2)
        else:
            outputs = [torch.cat([l_o, r_o], dim=1)
                       for l_o, r_o in zip(l_outputs, reversed_r_outputs)]
        if valid_length is not None:
            outputs = _mask_sequence_variable_length(
                outputs, length, valid_length, axis, merge_outputs)
        return outputs, l_states + r_states
