"""Convolutional recurrent cells (reference `python/mxnet/gluon/contrib/
rnn/conv_rnn_cell.py`), ported from `incubator_mxnet_tpu/gluon/contrib/
rnn/conv_rnn_cell.py`: the gates' pre-activations are convolutions over
feature maps instead of dense products, and the state is (hidden
channels, *spatial); `Conv{1,2,3}D{RNN,LSTM,GRU}Cell`."""
from __future__ import annotations

from ....base import MXNetError
from ...rnn.rnn_cell import HybridRecurrentCell

__all__ = ["Conv1DRNNCell", "Conv2DRNNCell", "Conv3DRNNCell",
           "Conv1DLSTMCell", "Conv2DLSTMCell", "Conv3DLSTMCell",
           "Conv1DGRUCell", "Conv2DGRUCell", "Conv3DGRUCell"]


def _conv_out_shape(in_shape, kernel, pad, dilate):
    return tuple((s + 2 * p - d * (k - 1) - 1) + 1
                 for s, k, p, d in zip(in_shape, kernel, pad, dilate))


class _BaseConvRNNCell(HybridRecurrentCell):
    def __init__(self, input_shape, hidden_channels, i2h_kernel, h2h_kernel,
                 i2h_pad, i2h_dilate, h2h_dilate, activation, prefix, params,
                 dims, n_gates):
        super().__init__(prefix=prefix, params=params)
        self._input_shape = tuple(input_shape)   # (C_in, *spatial)
        self._hidden_channels = hidden_channels
        self._activation = activation
        self._dims = dims
        self._n_gates = n_gates

        def _tup(v):
            return (v,) * dims if isinstance(v, int) else tuple(v)

        self._i2h_kernel = _tup(i2h_kernel)
        self._h2h_kernel = _tup(h2h_kernel)
        if any(k % 2 == 0 for k in self._h2h_kernel):
            raise MXNetError(
                f"h2h_kernel must be odd so the state keeps its shape; "
                f"got {self._h2h_kernel}")
        self._i2h_pad = _tup(i2h_pad)
        self._i2h_dilate = _tup(i2h_dilate)
        self._h2h_dilate = _tup(h2h_dilate)
        self._h2h_pad = tuple(d * (k - 1) // 2 for d, k in
                              zip(self._h2h_dilate, self._h2h_kernel))
        self._state_shape = (hidden_channels,) + _conv_out_shape(
            self._input_shape[1:], self._i2h_kernel, self._i2h_pad,
            self._i2h_dilate)
        g = n_gates
        self.i2h_weight = self.params.get(
            "i2h_weight",
            shape=(g * hidden_channels, self._input_shape[0])
            + self._i2h_kernel)
        self.h2h_weight = self.params.get(
            "h2h_weight",
            shape=(g * hidden_channels, hidden_channels) + self._h2h_kernel)
        self.i2h_bias = self.params.get(
            "i2h_bias", shape=(g * hidden_channels,), init="zeros")
        self.h2h_bias = self.params.get(
            "h2h_bias", shape=(g * hidden_channels,), init="zeros")

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size,) + self._state_shape,
                 "__layout__": "NC" + "DHW"[3 - self._dims:]}] \
            * self._n_states

    def _conv_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                      i2h_bias, h2h_bias):
        g = self._n_gates
        i2h = F.Convolution(inputs, i2h_weight, i2h_bias,
                            kernel=self._i2h_kernel, pad=self._i2h_pad,
                            dilate=self._i2h_dilate,
                            num_filter=g * self._hidden_channels)
        h2h = F.Convolution(states[0], h2h_weight, h2h_bias,
                            kernel=self._h2h_kernel, pad=self._h2h_pad,
                            dilate=self._h2h_dilate,
                            num_filter=g * self._hidden_channels)
        return i2h, h2h


class _ConvRNNCell(_BaseConvRNNCell):
    _n_states = 1
    _gates = 1

    def _alias(self):
        return "conv_rnn"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h, h2h = self._conv_forward(F, inputs, states, i2h_weight,
                                      h2h_weight, i2h_bias, h2h_bias)
        output = F.Activation(i2h + h2h, act_type=self._activation)
        return output, [output]


class _ConvLSTMCell(_BaseConvRNNCell):
    _n_states = 2
    _gates = 4

    def _alias(self):
        return "conv_lstm"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h, h2h = self._conv_forward(F, inputs, states, i2h_weight,
                                      h2h_weight, i2h_bias, h2h_bias)
        sl = F.SliceChannel(i2h + h2h, num_outputs=4, axis=1)
        i = F.Activation(sl[0], act_type="sigmoid")
        f = F.Activation(sl[1], act_type="sigmoid")
        g = F.Activation(sl[2], act_type=self._activation)
        o = F.Activation(sl[3], act_type="sigmoid")
        next_c = f * states[1] + i * g
        next_h = o * F.Activation(next_c, act_type=self._activation)
        return next_h, [next_h, next_c]


class _ConvGRUCell(_BaseConvRNNCell):
    _n_states = 1
    _gates = 3

    def _alias(self):
        return "conv_gru"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h, h2h = self._conv_forward(F, inputs, states, i2h_weight,
                                      h2h_weight, i2h_bias, h2h_bias)
        i2h_s = F.SliceChannel(i2h, num_outputs=3, axis=1)
        h2h_s = F.SliceChannel(h2h, num_outputs=3, axis=1)
        reset = F.Activation(i2h_s[0] + h2h_s[0], act_type="sigmoid")
        update = F.Activation(i2h_s[1] + h2h_s[1], act_type="sigmoid")
        cand = F.Activation(i2h_s[2] + reset * h2h_s[2],
                            act_type=self._activation)
        next_h = update * states[0] + (1.0 - update) * cand
        return next_h, [next_h]


def _make(base, dims, default_act):
    def __init__(self, input_shape, hidden_channels, i2h_kernel, h2h_kernel,
                 i2h_pad=0, i2h_dilate=1, h2h_dilate=1,
                 activation=default_act, prefix=None, params=None):
        _BaseConvRNNCell.__init__(
            self, input_shape, hidden_channels, i2h_kernel, h2h_kernel,
            i2h_pad, i2h_dilate, h2h_dilate, activation, prefix, params,
            dims, base._gates)
    kind = base.__name__[5:-4]          # RNN, LSTM, GRU
    name = f"Conv{dims}D{kind}Cell"
    return type(name, (base,), {
        "__init__": __init__, "__doc__": f"{dims}-D convolutional {kind} "
        f"cell (reference `conv_rnn_cell.py:{name}`)."})


Conv1DRNNCell, Conv2DRNNCell, Conv3DRNNCell = (
    _make(_ConvRNNCell, n, "tanh") for n in (1, 2, 3))
Conv1DLSTMCell, Conv2DLSTMCell, Conv3DLSTMCell = (
    _make(_ConvLSTMCell, n, "tanh") for n in (1, 2, 3))
Conv1DGRUCell, Conv2DGRUCell, Conv3DGRUCell = (
    _make(_ConvGRUCell, n, "tanh") for n in (1, 2, 3))
