"""Symbolic RNN cells (reference `python/mxnet/rnn/rnn_cell.py`).

PyTorch port of `incubator_mxnet_tpu/rnn/rnn_cell.py`: the same cells,
parameter names and graphs.  Each cell composes Symbol ops; a merged
unroll over a symbolic sequence is one `_foreach` node
(`ops/control_flow.py`), so a bucket's graph does not grow with its
length.  `FusedRNNCell` is the `RNN` op (`ops/nn.py`: cuDNN's fused RNN
on the card).

As in the JAX package, a cell's begin states are Variables of shape
(0, H) initialised to zero, not `sym.zeros`: a Module treats them as
parameters, so they are learned (README "Declared divergences").
"""
from __future__ import annotations

from ..base import MXNetError
from .. import symbol as sym


class BaseRNNCell:
    """Reference `rnn_cell.py:BaseRNNCell`."""

    def __init__(self, prefix="", params=None):
        self._prefix = prefix
        self._own_params = params is None
        self._params = params if params is not None else _RNNParams(prefix)
        self._modified = False
        self.reset()

    def reset(self):
        self._init_counter = -1
        self._counter = -1

    @property
    def params(self):
        return self._params

    @property
    def state_info(self):
        raise NotImplementedError

    @property
    def _gate_names(self):
        return ()

    def state_shape(self):
        return [info["shape"] for info in self.state_info]

    def begin_state(self, func=None, **kwargs):
        """Initial-state symbols.  Default: Variables initialised to zero
        (the reference uses `sym.zeros`; the JAX package's Variables,
        which a Module learns, are kept)."""
        assert not self._modified
        states = []
        for info in self.state_info:
            self._init_counter += 1
            name = f"{self._prefix}begin_state_{self._init_counter}"
            if func is None:
                state = sym.Variable(name, shape=info.get("shape"),
                                     init='["zero", {}]',
                                     __layout__=info.get("__layout__"))
            else:
                state = func(name=name, **info, **kwargs)
            states.append(state)
        return states

    def __call__(self, inputs, states):
        raise NotImplementedError

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        """Reference `BaseRNNCell.unroll`: returns (outputs, states).

        A merged-output unroll over a symbolic sequence emits ONE
        `_foreach` node instead of T copies of the cell body, so a
        bucketed LSTM graph's size does not depend on the sequence
        length.  Cells whose body cannot loop (aux states) fall back to
        the classic static unroll."""
        self.reset()
        axis = layout.find("T")
        if isinstance(inputs, sym.Symbol) and merge_outputs:
            if begin_state is None:
                begin_state = self.begin_state()
            try:
                from ..symbol.contrib import foreach_unroll
                return foreach_unroll(lambda x, st: self(x, st), inputs,
                                      begin_state, layout, length)
            except Exception:
                self.reset()   # e.g. aux-state layers: static unroll
        if isinstance(inputs, sym.Symbol):
            inputs = sym.split(inputs, num_outputs=length, axis=axis,
                               squeeze_axis=1)
            inputs = [inputs[i] for i in range(length)]
        if begin_state is None:
            begin_state = self.begin_state()
        states = begin_state
        outputs = []
        for i in range(length):
            out, states = self(inputs[i], states)
            outputs.append(out)
        if merge_outputs:
            outputs = sym.concat(*[sym.expand_dims(o, axis=axis)
                                   for o in outputs], dim=axis)
        return outputs, states

    def _get_weight(self, name, **kwargs):
        return self._params.get(f"{self._prefix}{name}", **kwargs)


class _RNNParams:
    def __init__(self, prefix):
        self._prefix = prefix
        self._params = {}

    def get(self, name, **kwargs):
        if name not in self._params:
            self._params[name] = sym.Variable(name, **kwargs)
        return self._params[name]


class RNNCell(BaseRNNCell):
    """tanh Elman cell (reference `rnn_cell.py:RNNCell`)."""

    def __init__(self, num_hidden, activation="tanh", prefix="rnn_",
                 params=None):
        super().__init__(prefix, params)
        self._num_hidden = num_hidden
        self._activation = activation

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    def __call__(self, inputs, states):
        self._counter += 1
        name = f"{self._prefix}t{self._counter}_"
        i2h = sym.FullyConnected(inputs, self._get_weight("i2h_weight"),
                                 self._get_weight("i2h_bias"),
                                 num_hidden=self._num_hidden,
                                 name=f"{name}i2h")
        h2h = sym.FullyConnected(states[0], self._get_weight("h2h_weight"),
                                 self._get_weight("h2h_bias"),
                                 num_hidden=self._num_hidden,
                                 name=f"{name}h2h")
        output = sym.Activation(i2h + h2h, act_type=self._activation,
                                name=f"{name}out")
        return output, [output]


class LSTMCell(BaseRNNCell):
    """Reference `rnn_cell.py:LSTMCell`."""

    def __init__(self, num_hidden, prefix="lstm_", params=None,
                 forget_bias=1.0):
        super().__init__(prefix, params)
        self._num_hidden = num_hidden
        self._forget_bias = forget_bias

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"},
                {"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("_i", "_f", "_c", "_o")

    def __call__(self, inputs, states):
        self._counter += 1
        name = f"{self._prefix}t{self._counter}_"
        # forget_bias is applied through the i2h_bias initializer
        # (reference init.LSTMBias) rather than an inline graph term, so
        # reference-trained checkpoints — whose saved bias already absorbed
        # it — load without shifting the forget gate
        import json as _json
        i2h_bias = self._get_weight(
            "i2h_bias",
            init=_json.dumps(["lstmbias",
                              {"forget_bias": self._forget_bias}]))
        i2h = sym.FullyConnected(inputs, self._get_weight("i2h_weight"),
                                 i2h_bias,
                                 num_hidden=4 * self._num_hidden,
                                 name=f"{name}i2h")
        h2h = sym.FullyConnected(states[0], self._get_weight("h2h_weight"),
                                 self._get_weight("h2h_bias"),
                                 num_hidden=4 * self._num_hidden,
                                 name=f"{name}h2h")
        gates = i2h + h2h
        slices = sym.split(gates, num_outputs=4, axis=1)
        in_gate = sym.Activation(slices[0], act_type="sigmoid")
        forget_gate = sym.Activation(slices[1], act_type="sigmoid")
        in_trans = sym.Activation(slices[2], act_type="tanh")
        out_gate = sym.Activation(slices[3], act_type="sigmoid")
        next_c = forget_gate * states[1] + in_gate * in_trans
        next_h = out_gate * sym.Activation(next_c, act_type="tanh")
        return next_h, [next_h, next_c]


class GRUCell(BaseRNNCell):
    """Reference `rnn_cell.py:GRUCell`."""

    def __init__(self, num_hidden, prefix="gru_", params=None):
        super().__init__(prefix, params)
        self._num_hidden = num_hidden

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    def __call__(self, inputs, states):
        self._counter += 1
        name = f"{self._prefix}t{self._counter}_"
        i2h = sym.FullyConnected(inputs, self._get_weight("i2h_weight"),
                                 self._get_weight("i2h_bias"),
                                 num_hidden=3 * self._num_hidden,
                                 name=f"{name}i2h")
        h2h = sym.FullyConnected(states[0], self._get_weight("h2h_weight"),
                                 self._get_weight("h2h_bias"),
                                 num_hidden=3 * self._num_hidden,
                                 name=f"{name}h2h")
        i2h_s = sym.split(i2h, num_outputs=3, axis=1)
        h2h_s = sym.split(h2h, num_outputs=3, axis=1)
        reset = sym.Activation(i2h_s[0] + h2h_s[0], act_type="sigmoid")
        update = sym.Activation(i2h_s[1] + h2h_s[1], act_type="sigmoid")
        cand = sym.Activation(i2h_s[2] + reset * h2h_s[2], act_type="tanh")
        next_h = update * states[0] + (1.0 - update) * cand
        return next_h, [next_h]


class FusedRNNCell(BaseRNNCell):
    """Whole-sequence cell lowering to the `RNN` op — the cuDNN fused path
    of the reference (`rnn_cell.py:FusedRNNCell`)."""

    def __init__(self, num_hidden, num_layers=1, mode="lstm",
                 bidirectional=False, dropout=0.0, prefix=None, params=None):
        prefix = f"{mode}_" if prefix is None else prefix
        super().__init__(prefix, params)
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._dropout = dropout

    @property
    def state_info(self):
        d = 2 if self._bidirectional else 1
        info = [{"shape": (self._num_layers * d, 0, self._num_hidden),
                 "__layout__": "LNC"}]
        if self._mode == "lstm":
            info.append({"shape": (self._num_layers * d, 0,
                                   self._num_hidden),
                         "__layout__": "LNC"})
        return info

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        if isinstance(inputs, (list, tuple)):
            axis = layout.find("T")
            inputs = sym.concat(*[sym.expand_dims(i, axis=axis)
                                  for i in inputs], dim=axis)
        if layout == "NTC":
            inputs = sym.transpose(inputs, axes=(1, 0, 2))   # RNN op is TNC
        if begin_state is None:
            begin_state = self.begin_state()
        states = list(begin_state)
        args = [inputs, self._get_weight("parameters"), states[0]]
        if self._mode == "lstm":
            args.append(states[1])
        out = sym.RNN(*args, state_size=self._num_hidden,
                      num_layers=self._num_layers, mode=self._mode,
                      bidirectional=self._bidirectional, p=self._dropout,
                      state_outputs=True,
                      name=f"{self._prefix}rnn")
        outputs = out[0]
        if layout == "NTC":
            outputs = sym.transpose(outputs, axes=(1, 0, 2))
        n_states = len(self.state_info)
        new_states = [out[1 + i] for i in range(n_states)]
        if merge_outputs is False:
            outputs = [o for o in sym.split(outputs, num_outputs=length,
                                            axis=layout.find("T"),
                                            squeeze_axis=1)]
        return outputs, new_states

    def unfuse(self):
        """Reference `FusedRNNCell.unfuse`: equivalent stacked plain cells."""
        stack = SequentialRNNCell()
        get = {"rnn_tanh": lambda p: RNNCell(self._num_hidden, "tanh", p),
               "rnn_relu": lambda p: RNNCell(self._num_hidden, "relu", p),
               "lstm": lambda p: LSTMCell(self._num_hidden, p),
               "gru": lambda p: GRUCell(self._num_hidden, p)}[self._mode]
        for i in range(self._num_layers):
            stack.add(get(f"{self._prefix}l{i}_"))
            if self._dropout > 0 and i < self._num_layers - 1:
                stack.add(DropoutCell(self._dropout,
                                      prefix=f"{self._prefix}_dropout{i}_"))
        return stack


class SequentialRNNCell(BaseRNNCell):
    """Reference `rnn_cell.py:SequentialRNNCell`."""

    def __init__(self, params=None):
        super().__init__("", params)
        self._cells = []

    def add(self, cell):
        self._cells.append(cell)
        return self

    @property
    def state_info(self):
        return [info for c in self._cells for info in c.state_info]

    def begin_state(self, **kwargs):
        return [s for c in self._cells for s in c.begin_state(**kwargs)]

    def __call__(self, inputs, states):
        next_states = []
        pos = 0
        for cell in self._cells:
            n = len(cell.state_info)
            inputs, st = cell(inputs, states[pos:pos + n])
            pos += n
            next_states.extend(st)
        return inputs, next_states


class DropoutCell(BaseRNNCell):
    """Reference `rnn_cell.py:DropoutCell`."""

    def __init__(self, dropout, prefix="dropout_", params=None):
        super().__init__(prefix, params)
        self._dropout = dropout

    @property
    def state_info(self):
        return []

    def __call__(self, inputs, states):
        if self._dropout > 0:
            inputs = sym.Dropout(inputs, p=self._dropout)
        return inputs, states


class ZoneoutCell(BaseRNNCell):
    """Reference `rnn_cell.py:ZoneoutCell` (state-preserving dropout)."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        super().__init__(base_cell._prefix + "zoneout_", base_cell.params)
        self.base_cell = base_cell
        self._zo = zoneout_outputs
        self._zs = zoneout_states
        self._prev_output = None

    def reset(self):
        super().reset()
        if hasattr(self, "base_cell"):
            self.base_cell.reset()
        # forget cross-graph state: a fresh unroll (e.g. the next bucket's
        # graph) must not reference the previous graph's output symbols
        self._prev_output = None

    @property
    def state_info(self):
        return self.base_cell.state_info

    def begin_state(self, **kwargs):
        return self.base_cell.begin_state(**kwargs)

    @staticmethod
    def _binary_mask(like, p):
        # Dropout emits {0, 1/(1-p)} (inverted dropout); scale back to a
        # true 0/1 keep-mask so the convex blend keeps magnitudes intact
        return sym.Dropout(sym.ones_like(like), p=p) * (1.0 - p)

    def __call__(self, inputs, states):
        out, next_states = self.base_cell(inputs, states)
        if self._zo > 0:
            mask = self._binary_mask(out, self._zo)
            prev = self._prev_output if self._prev_output is not None \
                else sym.zeros_like(out)
            out = mask * out + (1.0 - mask) * prev
        self._prev_output = out
        if self._zs > 0:
            blended = []
            for ns, s in zip(next_states, states):
                mask = self._binary_mask(ns, self._zs)  # ONE mask per state
                blended.append(mask * ns + (1.0 - mask) * s)
            next_states = blended
        return out, next_states


class ResidualCell(BaseRNNCell):
    """Reference `rnn_cell.py:ResidualCell`."""

    def __init__(self, base_cell):
        super().__init__(base_cell._prefix + "residual_", base_cell.params)
        self.base_cell = base_cell

    @property
    def state_info(self):
        return self.base_cell.state_info

    def begin_state(self, **kwargs):
        return self.base_cell.begin_state(**kwargs)

    def __call__(self, inputs, states):
        out, next_states = self.base_cell(inputs, states)
        return out + inputs, next_states
