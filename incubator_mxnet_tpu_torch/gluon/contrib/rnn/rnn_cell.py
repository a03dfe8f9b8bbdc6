"""Contrib recurrent cells (reference `python/mxnet/gluon/contrib/rnn/
rnn_cell.py`), ported from `incubator_mxnet_tpu/gluon/contrib/rnn/
rnn_cell.py`: `VariationalDropoutCell` and `LSTMPCell`."""
from __future__ import annotations

from ...rnn.rnn_cell import HybridRecurrentCell, ModifierCell

__all__ = ["VariationalDropoutCell", "LSTMPCell"]


class VariationalDropoutCell(ModifierCell):
    """Variational (locked) dropout (Gal & Ghahramani): one mask per
    sequence for the inputs, the first state and the outputs, drawn at
    the first step after `reset` (every `unroll` resets) and reused at
    every later one."""

    def __init__(self, base_cell, drop_inputs=0.0, drop_states=0.0,
                 drop_outputs=0.0):
        super().__init__(base_cell)
        self.drop_inputs = drop_inputs
        self.drop_states = drop_states
        self.drop_outputs = drop_outputs
        self._input_mask = None
        self._state_mask = None
        self._output_mask = None

    def _alias(self):
        return "vardrop"

    def reset(self):
        super().reset()
        self._input_mask = None
        self._state_mask = None
        self._output_mask = None

    @staticmethod
    def _mask(F, like, p):
        # Dropout of ones is the inverted-dropout mask {0, 1/(1-p)}
        return F.Dropout(F.ones_like(like), p=p)

    def __call__(self, inputs, states):
        from .... import ndarray as nd_mod
        from .... import symbol as sym_mod
        from ....ndarray.ndarray import NDArray
        F = nd_mod if isinstance(inputs, NDArray) else sym_mod
        if self.drop_inputs:
            if self._input_mask is None:
                self._input_mask = self._mask(F, inputs, self.drop_inputs)
            inputs = inputs * self._input_mask
        if self.drop_states:
            if self._state_mask is None:
                self._state_mask = self._mask(F, states[0],
                                              self.drop_states)
            states = [states[0] * self._state_mask] + list(states[1:])
        output, states = self.base_cell(inputs, states)
        if self.drop_outputs:
            if self._output_mask is None:
                self._output_mask = self._mask(F, output, self.drop_outputs)
            output = output * self._output_mask
        return output, states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        self.reset()
        return super().unroll(length, inputs, begin_state, layout,
                              merge_outputs, valid_length)


class LSTMPCell(HybridRecurrentCell):
    """LSTM with a projection of the hidden state (LSTMP, Sak et al.
    2014): the recurrent state and the output are ``h2r_weight`` times
    the LSTM's hidden output, of width `projection_size`."""

    def __init__(self, hidden_size, projection_size,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 h2r_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._projection_size = projection_size
        self._input_size = input_size
        self.i2h_weight = self.params.get(
            "i2h_weight", shape=(4 * hidden_size, input_size),
            init=i2h_weight_initializer, allow_deferred_init=True)
        self.h2h_weight = self.params.get(
            "h2h_weight", shape=(4 * hidden_size, projection_size),
            init=h2h_weight_initializer, allow_deferred_init=True)
        self.h2r_weight = self.params.get(
            "h2r_weight", shape=(projection_size, hidden_size),
            init=h2r_weight_initializer, allow_deferred_init=True)
        self.i2h_bias = self.params.get(
            "i2h_bias", shape=(4 * hidden_size,),
            init=i2h_bias_initializer, allow_deferred_init=True)
        self.h2h_bias = self.params.get(
            "h2h_bias", shape=(4 * hidden_size,),
            init=h2h_bias_initializer, allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._projection_size),
                 "__layout__": "NC"},
                {"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _alias(self):
        return "lstmp"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       h2r_weight, i2h_bias, h2h_bias):
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=4 * self._hidden_size)
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=4 * self._hidden_size)
        sl = F.SliceChannel(i2h + h2h, num_outputs=4, axis=1)
        i = F.Activation(sl[0], act_type="sigmoid")
        f = F.Activation(sl[1], act_type="sigmoid")
        g = F.Activation(sl[2], act_type="tanh")
        o = F.Activation(sl[3], act_type="sigmoid")
        next_c = f * states[1] + i * g
        hidden = o * F.Activation(next_c, act_type="tanh")
        next_r = F.FullyConnected(hidden, h2r_weight, no_bias=True,
                                  num_hidden=self._projection_size)
        return next_r, [next_r, next_c]
