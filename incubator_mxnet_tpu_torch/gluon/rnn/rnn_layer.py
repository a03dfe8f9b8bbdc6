"""Fused recurrent layers RNN/LSTM/GRU
(reference `python/mxnet/gluon/rnn/rnn_layer.py` — RNN:234, LSTM:328, GRU:433).

PyTorch port of `incubator_mxnet_tpu/gluon/rnn/rnn_layer.py`.  Parameters
are stored per layer and direction (`l0_i2h_weight`, `l0_h2h_weight`,
biases, `r0_*` for reverse) exactly like the reference, so checkpoints
map 1:1; at call time they are packed into the flat cuDNN-layout vector
the `RNN` op consumes (`ops/nn.py`: cuDNN's fused RNN on the card, the
plain loop elsewhere).  Called on NDArrays a layer runs eagerly; after
`hybridize()` it runs its traced graph (data and states in, outputs and
states out) through the Symbol interpreter, as the port's other
HybridBlocks do (the JAX package's layers ignore `hybridize()`); both
give the same numbers.  A Symbol input must come with its states."""
from __future__ import annotations

from ..block import HybridBlock
from ...base import MXNetError
from ... import ndarray as nd

__all__ = ["RNN", "LSTM", "GRU"]


def _sym():
    from ... import symbol
    return symbol


class _RNNLayer(HybridBlock):
    def __init__(self, hidden_size, num_layers, layout, dropout, bidirectional,
                 input_size, i2h_weight_initializer, h2h_weight_initializer,
                 i2h_bias_initializer, h2h_bias_initializer, mode, **kwargs):
        super().__init__(**kwargs)
        assert layout in ("TNC", "NTC"), \
            f"Invalid layout {layout}; must be one of ['TNC' or 'NTC']"
        self._hidden_size = hidden_size
        self._num_layers = num_layers
        self._mode = mode
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        self._i2h_weight_initializer = i2h_weight_initializer
        self._h2h_weight_initializer = h2h_weight_initializer
        self._i2h_bias_initializer = i2h_bias_initializer
        self._h2h_bias_initializer = h2h_bias_initializer

        self._gates = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}[mode]
        ng, ni, nh = self._gates, input_size, hidden_size
        for i in range(num_layers):
            for j in ["l", "r"][:self._dir]:
                self._register_param(f"{j}{i}_i2h_weight", (ng * nh, ni),
                                     i2h_weight_initializer)
                self._register_param(f"{j}{i}_h2h_weight", (ng * nh, nh),
                                     h2h_weight_initializer)
                self._register_param(f"{j}{i}_i2h_bias", (ng * nh,),
                                     i2h_bias_initializer)
                self._register_param(f"{j}{i}_h2h_bias", (ng * nh,),
                                     h2h_bias_initializer)
            ni = nh * self._dir

    def _register_param(self, name, shape, init):
        p = self.params.get(name, shape=shape, init=init,
                            allow_deferred_init=True)
        self._reg_params[name] = p
        setattr(self, name, p)

    def __repr__(self):
        return f"{self.__class__.__name__}({self._input_size} -> " \
               f"{self._hidden_size}, {self._layout}" + \
               (", bidirectional" if self._dir == 2 else "") + ")"

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """Initial states (reference `rnn_layer.py begin_state`)."""
        from ... import ndarray as nd_mod
        states = []
        for info in self.state_info(batch_size):
            states.append(nd_mod.zeros(**{**info, **kwargs}))
        return states

    def hybrid_forward(self, F, inputs, states=None, **params):
        if self._layout == "NTC":
            inputs = F.swapaxes(inputs, dim1=0, dim2=1)
        if states is None:
            batch_size = inputs.shape[1] if hasattr(inputs, "shape") else 0
            states = self.begin_state(batch_size, ctx=inputs.context
                                      if hasattr(inputs, "context") else None)
        if not isinstance(states, (list, tuple)):
            states = [states]
        flat = self._pack_params(F, params)
        rnn_args = [inputs, flat] + list(states)
        out = F.RNN(*rnn_args, state_size=self._hidden_size,
                    num_layers=self._num_layers,
                    bidirectional=self._dir == 2, mode=self._mode,
                    p=self._dropout, state_outputs=True)
        outputs, out_states = out[0], list(out[1:])
        if self._layout == "NTC":
            outputs = F.swapaxes(outputs, dim1=0, dim2=1)
        return outputs, out_states

    def _pack_params(self, F, params):
        """Pack per-layer params into the flat cuDNN layout: all weights
        (layer-major, Wx then Wh per direction), then all biases."""
        chunks = []
        for i in range(self._num_layers):
            for j in ["l", "r"][:self._dir]:
                chunks.append(F.Reshape(params[f"{j}{i}_i2h_weight"],
                                        shape=(-1,)))
                chunks.append(F.Reshape(params[f"{j}{i}_h2h_weight"],
                                        shape=(-1,)))
        for i in range(self._num_layers):
            for j in ["l", "r"][:self._dir]:
                chunks.append(params[f"{j}{i}_i2h_bias"])
                chunks.append(params[f"{j}{i}_h2h_bias"])
        return F.Concat(*chunks, dim=0, num_args=len(chunks))

    def forward(self, inputs, states=None):
        """Eager (or, hybridized, the traced graph's) pass; without
        `states`, zeros, and only the output is returned."""
        from ...ndarray.ndarray import NDArray
        from ...symbol.symbol import Symbol
        if isinstance(inputs, Symbol):
            if states is None:
                raise MXNetError("RNN layers called on a Symbol need their "
                                 "begin states")
            params = {name: p.var() for name, p in self._reg_params.items()}
            return self.hybrid_forward(_sym(), inputs, states, **params)
        if not isinstance(inputs, NDArray):
            raise MXNetError("RNN layers take NDArray or Symbol inputs")
        batch_size = inputs.shape[0 if self._layout == "NTC" else 1]
        skip_states = states is None
        if skip_states:
            states = self.begin_state(batch_size, ctx=inputs.context)
        if isinstance(states, NDArray):
            states = [states]
        ctx = inputs.context
        if any(p._data is None for p in self._reg_params.values()):
            self._deferred_infer_shape_rnn(inputs)
            for p in self.collect_params().values():
                if p._deferred_init:
                    p._finish_deferred_init()
        if self._active:
            outs = self._call_graph(inputs, list(states))
            out, out_states = outs[0], list(outs[1:])
        else:
            params = {name: p.data(ctx)
                      for name, p in self._reg_params.items()}
            out, out_states = self.hybrid_forward(nd, inputs, states,
                                                  **params)
        return out if skip_states else (out, out_states)

    def _call_graph(self, inputs, states):
        """The traced graph of `hybrid_forward` over Variables ``data`` and
        ``state0``.., built once, run by `gluon.block._CachedGraph`."""
        if self._cached_graph is None:
            from ..block import _CachedGraph
            sym = _sym()
            names = ["data"] + [f"state{i}" for i in range(len(states))]
            params = {name: p.var() for name, p in self._reg_params.items()}
            out, out_states = self.hybrid_forward(
                sym, sym.var("data"), [sym.var(n) for n in names[1:]],
                **params)
            self._cached_graph = _CachedGraph(
                sym.Group([out] + list(out_states)), names,
                {p.name: p for p in self._reg_params.values()})
        cg = self._cached_graph
        return cg(dict(zip(cg.data_names, [inputs] + states)),
                  inputs.context)

    def _deferred_infer_shape_rnn(self, inputs):
        ni = inputs.shape[2] if self._layout == "TNC" else inputs.shape[2]
        ng, nh = self._gates, self._hidden_size
        cur = ni
        for i in range(self._num_layers):
            for j in ["l", "r"][:self._dir]:
                self._reg_params[f"{j}{i}_i2h_weight"].shape = (ng * nh, cur)
            cur = nh * self._dir


class RNN(_RNNLayer):
    """Vanilla RNN (reference `rnn_layer.py:234 RNN`)."""

    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 layout="TNC", dropout=0, bidirectional=False,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "rnn_" + activation, **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]


class LSTM(_RNNLayer):
    """LSTM (reference `rnn_layer.py:328 LSTM`)."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "lstm", **kwargs)

    def state_info(self, batch_size=0):
        shape = (self._num_layers * self._dir, batch_size, self._hidden_size)
        return [{"shape": shape, "__layout__": "LNC"},
                {"shape": shape, "__layout__": "LNC"}]


class GRU(_RNNLayer):
    """GRU (reference `rnn_layer.py:433 GRU`)."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "gru", **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]
