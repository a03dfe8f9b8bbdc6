"""Recurrent cells (reference `python/mxnet/gluon/rnn/rnn_cell.py` :105-730).

PyTorch port of `incubator_mxnet_tpu/gluon/rnn/rnn_cell.py`: the same
cells, names and graphs.  Cells are fine-grained recurrent units with an
explicit `unroll`: on NDArrays each step runs eagerly, op by op (what
`autograd.record()` records); on Symbols a merged unroll is one
`_foreach` node (`sym.contrib.foreach`).  As in the JAX package, a
cell's `forward` does not read `hybridize()`: a hybridized cell steps
eagerly."""
from __future__ import annotations

from ..block import Block, HybridBlock
from ..parameter import DeferredInitializationError
from ...base import MXNetError

__all__ = ["RecurrentCell", "HybridRecurrentCell", "RNNCell", "LSTMCell",
           "GRUCell", "SequentialRNNCell", "DropoutCell", "ModifierCell",
           "ZoneoutCell", "ResidualCell", "BidirectionalCell"]


def _cells_state_info(cells, batch_size):
    return sum([c.state_info(batch_size) for c in cells], [])


def _cells_begin_state(cells, **kwargs):
    return sum([c.begin_state(**kwargs) for c in cells], [])


def _format_sequence(length, inputs, layout, merge, F=None):
    from ...ndarray.ndarray import NDArray
    from ... import ndarray as nd_mod
    from ... import symbol as sym_mod
    axis = layout.find("T")
    batch_axis = layout.find("N")
    if isinstance(inputs, (list, tuple)):
        F = nd_mod if isinstance(inputs[0], NDArray) else sym_mod
        in_axis = 0
        if merge is True:
            inputs = F.stack(*inputs, axis=axis, num_args=len(inputs))
        return inputs, axis, F, len(inputs) if isinstance(inputs, (list, tuple)) else length
    F = nd_mod if isinstance(inputs, NDArray) else sym_mod
    if merge is False:
        seq = F.split(inputs, num_outputs=length, axis=axis, squeeze_axis=True)
        if not isinstance(seq, (list, tuple)):
            seq = [seq]
        return list(seq), axis, F, length
    return inputs, axis, F, length


class RecurrentCell(Block):
    """Base recurrent cell (reference `rnn_cell.py:RecurrentCell`)."""

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
        raise NotImplementedError()

    def begin_state(self, batch_size=0, func=None, **kwargs):
        assert not self._modified, \
            "After applying modifier cells the base cell cannot be called " \
            "directly. Call the modifier cell instead."
        from ... import ndarray as nd_mod
        states = []
        for info in self.state_info(batch_size):
            self._init_counter += 1
            if info is not None:
                info = dict(info)
                info.pop("__layout__", None)
                states.append((func or nd_mod.zeros)(**{**info, **kwargs}))
            else:
                states.append((func or nd_mod.zeros)(**kwargs))
        return states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        """Unroll over time (reference `rnn_cell.py unroll`).

        Symbolic sequences with merged outputs emit ONE `_foreach` node
        instead of T copies of the cell body (the reference's
        `control_flow.cc` foreach path); cells that cannot loop
        (aux-state layers in the body) fall back to the classic static
        unroll."""
        self.reset()
        from ...symbol.symbol import Symbol as _SymT
        if merge_outputs and valid_length is None and \
                isinstance(inputs, _SymT) and begin_state is not None:
            try:
                return self._unroll_foreach(length, inputs, begin_state,
                                            layout)
            except Exception:
                self.reset()   # e.g. BatchNorm in the body: static unroll
        inputs, axis, F, length = _format_sequence(length, inputs, layout,
                                                   False)
        if begin_state is None:
            batch_size = inputs[0].shape[0]
            begin_state = self.begin_state(batch_size,
                                           ctx=inputs[0].context
                                           if hasattr(inputs[0], "context")
                                           else None)
        states = begin_state
        outputs = []
        for i in range(length):
            output, states = self(inputs[i], states)
            outputs.append(output)
        if merge_outputs:
            outputs = F.stack(*outputs, axis=layout.find("T"),
                              num_args=len(outputs))
        return outputs, states

    def _unroll_foreach(self, length, inputs, begin_state, layout):
        """One-node unroll: the cell body traced once into a `_foreach`
        (`symbol.contrib.foreach_unroll`)."""
        from ...symbol.contrib import foreach_unroll
        return foreach_unroll(lambda x, st: self(x, st), inputs,
                              begin_state, layout, length)

    def forward(self, inputs, states):
        self._counter += 1
        return super().forward(inputs, states)


class HybridRecurrentCell(RecurrentCell, HybridBlock):
    """Hybridizable recurrent cell."""

    def __init__(self, prefix=None, params=None):
        RecurrentCell.__init__(self, prefix=prefix, params=params)

    def forward(self, inputs, states):
        self._counter += 1
        from ...ndarray.ndarray import NDArray
        from ... import ndarray as nd_mod
        if isinstance(inputs, NDArray):
            ctx = inputs.context
            try:
                params = {name: p.data(ctx)
                          for name, p in self._reg_params.items()}
            except DeferredInitializationError:
                for p in self._reg_params.values():
                    if p.shape and 0 in p.shape:
                        self._infer_cell_shape(inputs)
                        break
                for p in self.collect_params().values():
                    if p._deferred_init:
                        p._finish_deferred_init()
                params = {name: p.data(ctx)
                          for name, p in self._reg_params.items()}
            return self.hybrid_forward(nd_mod, inputs, states, **params)
        from ... import symbol as sym_mod
        params = {name: p.var() for name, p in self._reg_params.items()}
        return self.hybrid_forward(sym_mod, inputs, states, **params)

    def _infer_cell_shape(self, inputs):
        in_dim = inputs.shape[-1]
        for name, p in self._reg_params.items():
            if "i2h_weight" in name and p.shape and p.shape[-1] == 0:
                p.shape = (p.shape[0], in_dim)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError


class RNNCell(HybridRecurrentCell):
    """Elman cell (reference `rnn_cell.py RNNCell`)."""

    def __init__(self, hidden_size, activation="tanh",
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._activation = activation
        self._input_size = input_size
        self.i2h_weight = self.params.get("i2h_weight",
                                          shape=(hidden_size, input_size),
                                          init=i2h_weight_initializer,
                                          allow_deferred_init=True)
        self.h2h_weight = self.params.get("h2h_weight",
                                          shape=(hidden_size, hidden_size),
                                          init=h2h_weight_initializer,
                                          allow_deferred_init=True)
        self.i2h_bias = self.params.get("i2h_bias", shape=(hidden_size,),
                                        init=i2h_bias_initializer,
                                        allow_deferred_init=True)
        self.h2h_bias = self.params.get("h2h_bias", shape=(hidden_size,),
                                        init=h2h_bias_initializer,
                                        allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size), "__layout__": "NC"}]

    def _alias(self):
        return "rnn"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=self._hidden_size, name="i2h")
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=self._hidden_size, name="h2h")
        output = F.Activation(i2h + h2h, act_type=self._activation,
                              name="out")
        return output, [output]


class LSTMCell(HybridRecurrentCell):
    """LSTM cell (reference `rnn_cell.py LSTMCell`); gate order i,f,g,o
    matching the fused op's cuDNN layout."""

    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        self.i2h_weight = self.params.get("i2h_weight",
                                          shape=(4 * hidden_size, input_size),
                                          init=i2h_weight_initializer,
                                          allow_deferred_init=True)
        self.h2h_weight = self.params.get("h2h_weight",
                                          shape=(4 * hidden_size, hidden_size),
                                          init=h2h_weight_initializer,
                                          allow_deferred_init=True)
        self.i2h_bias = self.params.get("i2h_bias", shape=(4 * hidden_size,),
                                        init=i2h_bias_initializer,
                                        allow_deferred_init=True)
        self.h2h_bias = self.params.get("h2h_bias", shape=(4 * hidden_size,),
                                        init=h2h_bias_initializer,
                                        allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size), "__layout__": "NC"},
                {"shape": (batch_size, self._hidden_size), "__layout__": "NC"}]

    def _alias(self):
        return "lstm"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=self._hidden_size * 4, name="i2h")
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=self._hidden_size * 4, name="h2h")
        gates = i2h + h2h
        slices = F.SliceChannel(gates, num_outputs=4, axis=1, name="slice")
        in_gate = F.Activation(slices[0], act_type="sigmoid", name="i")
        forget_gate = F.Activation(slices[1], act_type="sigmoid", name="f")
        in_transform = F.Activation(slices[2], act_type="tanh", name="c")
        out_gate = F.Activation(slices[3], act_type="sigmoid", name="o")
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * F.Activation(next_c, act_type="tanh")
        return next_h, [next_h, next_c]


class GRUCell(HybridRecurrentCell):
    """GRU cell (reference `rnn_cell.py GRUCell`); gate order r,z,n."""

    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        self.i2h_weight = self.params.get("i2h_weight",
                                          shape=(3 * hidden_size, input_size),
                                          init=i2h_weight_initializer,
                                          allow_deferred_init=True)
        self.h2h_weight = self.params.get("h2h_weight",
                                          shape=(3 * hidden_size, hidden_size),
                                          init=h2h_weight_initializer,
                                          allow_deferred_init=True)
        self.i2h_bias = self.params.get("i2h_bias", shape=(3 * hidden_size,),
                                        init=i2h_bias_initializer,
                                        allow_deferred_init=True)
        self.h2h_bias = self.params.get("h2h_bias", shape=(3 * hidden_size,),
                                        init=h2h_bias_initializer,
                                        allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size), "__layout__": "NC"}]

    def _alias(self):
        return "gru"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        prev_state_h = states[0]
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=self._hidden_size * 3, name="i2h")
        h2h = F.FullyConnected(prev_state_h, h2h_weight, h2h_bias,
                               num_hidden=self._hidden_size * 3, name="h2h")
        i2h_s = F.SliceChannel(i2h, num_outputs=3, axis=1, name="i2h_slice")
        h2h_s = F.SliceChannel(h2h, num_outputs=3, axis=1, name="h2h_slice")
        reset_gate = F.Activation(i2h_s[0] + h2h_s[0], act_type="sigmoid")
        update_gate = F.Activation(i2h_s[1] + h2h_s[1], act_type="sigmoid")
        next_h_tmp = F.Activation(i2h_s[2] + reset_gate * h2h_s[2],
                                  act_type="tanh")
        next_h = (1. - update_gate) * next_h_tmp + update_gate * prev_state_h
        return next_h, [next_h]


class SequentialRNNCell(RecurrentCell):
    """Stack of cells (reference `rnn_cell.py SequentialRNNCell`)."""

    def add(self, cell):
        self.register_child(cell)

    def state_info(self, batch_size=0):
        return _cells_state_info(self._children.values(), batch_size)

    def begin_state(self, **kwargs):
        assert not self._modified
        return _cells_begin_state(self._children.values(), **kwargs)

    def __call__(self, inputs, states):
        self._counter += 1
        next_states = []
        p = 0
        for cell in self._children.values():
            n = len(cell.state_info())
            inputs, new_states = cell(inputs, states[p:p + n])
            p += n
            next_states.extend(new_states)
        return inputs, next_states

    def __len__(self):
        return len(self._children)

    def __getitem__(self, i):
        return list(self._children.values())[i]

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        self.reset()
        inputs, _, F, length = _format_sequence(length, inputs, layout, False)
        if begin_state is None:
            batch_size = inputs[0].shape[0]
            begin_state = self.begin_state(batch_size=batch_size,
                                           ctx=inputs[0].context)
        p = 0
        next_states = []
        cells = list(self._children.values())
        for i, cell in enumerate(cells):
            n = len(cell.state_info())
            states = begin_state[p:p + n]
            p += n
            inputs, states = cell.unroll(
                length, inputs=inputs, begin_state=states, layout=layout,
                merge_outputs=None if i < len(cells) - 1 else merge_outputs)
            next_states.extend(states)
        return inputs, next_states


class DropoutCell(HybridRecurrentCell):
    """Reference `rnn_cell.py DropoutCell`."""

    def __init__(self, rate, axes=(), prefix=None, params=None):
        super().__init__(prefix, params)
        assert isinstance(rate, (int, float))
        self._rate = rate
        self._axes = axes

    def state_info(self, batch_size=0):
        return []

    def _alias(self):
        return "dropout"

    def hybrid_forward(self, F, inputs, states):
        if self._rate > 0:
            inputs = F.Dropout(inputs, p=self._rate, axes=self._axes)
        return inputs, states


class ModifierCell(HybridRecurrentCell):
    """Base for cells that modify another cell (reference ModifierCell)."""

    def __init__(self, base_cell):
        assert not base_cell._modified, \
            "Cell %s is already modified." % base_cell.name
        base_cell._modified = True
        super().__init__(prefix=base_cell.prefix + self._alias(),
                         params=None)
        self.base_cell = base_cell

    @property
    def params(self):
        return self.base_cell.params

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, batch_size=0, func=None, **kwargs):
        assert not self._modified
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(batch_size, func=func, **kwargs)
        self.base_cell._modified = True
        return begin


class ZoneoutCell(ModifierCell):
    """Reference `rnn_cell.py ZoneoutCell`."""

    def __init__(self, base_cell, zoneout_outputs=0., zoneout_states=0.):
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self._prev_output = None

    def _alias(self):
        return "zoneout"

    def reset(self):
        super().reset()
        self._prev_output = None

    def hybrid_forward(self, F, inputs, states):
        cell, p_outputs, p_states = self.base_cell, self.zoneout_outputs, \
            self.zoneout_states
        next_output, next_states = cell(inputs, states)
        mask = lambda p, like: F.Dropout(F.ones_like(like), p=p)
        prev_output = self._prev_output
        if prev_output is None:
            prev_output = F.zeros_like(next_output)
        output = (F.where(mask(p_outputs, next_output), next_output,
                          prev_output) if p_outputs != 0. else next_output)
        new_states = ([F.where(mask(p_states, new_s), new_s, old_s)
                       for new_s, old_s in zip(next_states, states)]
                      if p_states != 0. else next_states)
        self._prev_output = output
        return output, new_states


class ResidualCell(ModifierCell):
    """Reference `rnn_cell.py ResidualCell`."""

    def hybrid_forward(self, F, inputs, states):
        output, states = self.base_cell(inputs, states)
        output = output + inputs
        return output, states

    def _alias(self):
        return "residual"


class BidirectionalCell(HybridRecurrentCell):
    """Reference `rnn_cell.py BidirectionalCell`."""

    def __init__(self, l_cell, r_cell, output_prefix="bi_"):
        super().__init__(prefix="", params=None)
        self.register_child(l_cell, "l_cell")
        self.register_child(r_cell, "r_cell")
        self._output_prefix = output_prefix

    def __call__(self, inputs, states):
        raise NotImplementedError("Bidirectional cannot be stepped. "
                                  "Please use unroll")

    def state_info(self, batch_size=0):
        return _cells_state_info(self._children.values(), batch_size)

    def begin_state(self, **kwargs):
        assert not self._modified
        return _cells_begin_state(self._children.values(), **kwargs)

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        self.reset()
        inputs, axis, F, length = _format_sequence(length, inputs, layout,
                                                   False)
        if begin_state is None:
            batch_size = inputs[0].shape[0]
            begin_state = self.begin_state(batch_size=batch_size,
                                           ctx=inputs[0].context)
        states = begin_state
        l_cell, r_cell = self._children.values()
        n_l = len(l_cell.state_info())
        l_outputs, l_states = l_cell.unroll(length, inputs=inputs,
                                            begin_state=states[:n_l],
                                            layout=layout,
                                            merge_outputs=False)
        r_outputs, r_states = r_cell.unroll(length,
                                            inputs=list(reversed(inputs)),
                                            begin_state=states[n_l:],
                                            layout=layout,
                                            merge_outputs=False)
        outputs = [F.Concat(l_o, r_o, dim=1, num_args=2)
                   for l_o, r_o in zip(l_outputs, reversed(r_outputs))]
        if merge_outputs:
            outputs = F.stack(*outputs, axis=layout.find("T"),
                              num_args=len(outputs))
        return outputs, l_states + r_states
