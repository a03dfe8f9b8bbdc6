"""Gluon Block and HybridBlock (reference `python/mxnet/gluon/block.py`).

PyTorch port of `incubator_mxnet_tpu/gluon/block.py`.  Blocks name
themselves and their parameters exactly as the JAX package's do (the
`_BlockScope` prefix counters), so a network composed in either package
gives the same parameter, aux-state and op-node names and the same
symbol JSON.

A `HybridBlock` called on a Symbol composes ``hybrid_forward`` with the
symbolic frontend (``F = mx.sym``): this is how `Module` trains a gluon
network.  Called on NDArrays it runs ``hybrid_forward(nd, ...)``
eagerly, op by op through `ndarray.invoke`, so `autograd.record()`
records it.  After `hybridize()` the same call runs the block's traced
symbol instead (`_CachedGraph`, the JAX package's cached op): the Symbol
interpreter (`symbol.graph_eval_fn`) in training or predict mode as
`autograd` says, recorded as one op whose inputs are the data and every
parameter, and in training mode the new BatchNorm moving statistics are
written into their Parameters in place.  Either way deferred shapes are
finished from the first input.

`Block.__call__` runs the forward pre-hooks and hooks around `forward`,
and `summary` prints one row per block a forward reaches through them
(a hybridized block's children run inside its graph and have no rows),
as the JAX package does.  `SymbolBlock` wraps a Symbol as a block whose
forward is that graph's `_CachedGraph`; `SymbolBlock.imports` loads an
`export`ed pair onto ``ctx``, by default `current_context()`, the card,
as `Module()` does (the JAX one defaults to the CPU).  Its parameters
are registered once each, under their names in the symbol.
"""
from __future__ import annotations

import re
import threading

import torch

from ..base import MXNetError
from ..ndarray.ndarray import NDArray
from .. import ndarray as nd
from .. import autograd as _autograd
from .parameter import Parameter, ParameterDict, _load_into, \
    DeferredInitializationError

__all__ = ["Block", "HybridBlock", "SymbolBlock"]


class _BlockScope:
    """Name manager for Block prefixes (reference `block.py:_BlockScope`):
    outside any scope a block takes the next global ``{hint}_{n}_``; inside
    its parent's scope, ``{parent prefix}{hint}{n}_`` with a counter per
    hint and parent."""

    _current = threading.local()

    def __init__(self, block):
        self._block = block
        self._counter = {}
        self._old_scope = None

    @staticmethod
    def create(prefix, params, hint):
        current = getattr(_BlockScope._current, "value", None)
        if current is None:
            if prefix is None:
                from ..symbol.symbol import _NameManager
                prefix = _NameManager.next_name(hint + "_") + "_"
            if params is None:
                params = ParameterDict(prefix)
            else:
                params = ParameterDict(params.prefix, params)
            return prefix, params
        if prefix is None:
            count = current._counter.get(hint, 0)
            prefix = f"{hint}{count}_"
            current._counter[hint] = count + 1
        if params is None:
            parent = current._block.params
            params = ParameterDict(parent.prefix + prefix, parent._shared)
        else:
            params = ParameterDict(params.prefix, params)
        return current._block.prefix + prefix, params

    def __enter__(self):
        if self._block._empty_prefix:
            return self
        self._old_scope = getattr(_BlockScope._current, "value", None)
        _BlockScope._current.value = self
        return self

    def __exit__(self, ptype, value, trace):
        if self._block._empty_prefix:
            return
        _BlockScope._current.value = self._old_scope


class Block:
    """Base building block (reference `block.py:126 Block`)."""

    def __init__(self, prefix=None, params=None):
        self._empty_prefix = prefix == ""
        self._prefix, self._params = _BlockScope.create(prefix, params,
                                                        self._alias())
        self._name = self._prefix[:-1] if self._prefix.endswith("_") \
            else self._prefix
        self._scope = _BlockScope(self)
        self._children = {}
        self._reg_params = {}
        self._forward_hooks = {}
        self._forward_pre_hooks = {}

    def _alias(self):
        return self.__class__.__name__.lower()

    def __repr__(self):
        modstr = "\n".join(f"  ({key}): {_indent(repr(block), 2)}"
                           for key, block in self._children.items())
        return f"{self.__class__.__name__}(\n{modstr}\n)"

    def __setattr__(self, name, value):
        if hasattr(self, name):
            existing = getattr(self, name)
            if isinstance(existing, (Parameter, Block)) and \
                    not isinstance(value, type(existing)) and \
                    not isinstance(existing, type(value)):
                raise TypeError(f"Changing attribute type for {name} from "
                                f"{type(existing)} to {type(value)} is not "
                                "allowed.")
        if isinstance(value, Block):
            self.register_child(value, name)
        elif isinstance(value, Parameter):
            if self._reg_params.get(name, value) is not value:
                raise MXNetError(f"Overriding Parameter attribute {name} is "
                                 "not allowed.")
            self._reg_params[name] = value
        super().__setattr__(name, value)

    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._name

    def name_scope(self):
        """The scope children created under it are named in."""
        return self._scope

    @property
    def params(self):
        return self._params

    def collect_params(self, select=None):
        """This block's and its children's parameters, those whose name
        matches the regular expression `select` if given."""
        ret = ParameterDict(self._params.prefix)
        if not select:
            ret.update(self.params)
        else:
            pattern = re.compile(select)
            ret.update({name: value for name, value in self.params.items()
                        if pattern.match(name)})
        for cld in self._children.values():
            ret.update(cld.collect_params(select=select))
        return ret

    def register_child(self, block, name=None):
        if name is None:
            name = str(len(self._children))
        self._children[name] = block

    def register_forward_hook(self, hook):
        """Call ``hook(block, inputs, output)`` after every forward;
        returns the handle that keys it in ``_forward_hooks``."""
        handle = len(self._forward_hooks)
        self._forward_hooks[handle] = hook
        return handle

    def register_forward_pre_hook(self, hook):
        """Call ``hook(block, inputs)`` before every forward; returns the
        handle that keys it in ``_forward_pre_hooks``."""
        handle = len(self._forward_pre_hooks)
        self._forward_pre_hooks[handle] = hook
        return handle

    def apply(self, fn):
        for cld in self._children.values():
            cld.apply(fn)
        fn(self)
        return self

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        from .. import initializer as init_mod
        self.collect_params().initialize(init or init_mod.Uniform(), ctx,
                                         verbose, force_reinit)

    def hybridize(self, active=True, **kwargs):
        for cld in self._children.values():
            cld.hybridize(active, **kwargs)

    def cast(self, dtype):
        for child in self._children.values():
            child.cast(dtype)
        for _, param in self.params.items():
            param.cast(dtype)

    def save_parameters(self, filename, deduplicate=False):
        """The parameters under their structural names (``features.0.
        weight``), in the reference's `.params` format."""
        params = self._collect_params_with_prefix()
        nd.save(filename, {key: val._reduce() for key, val in
                           params.items()})

    def load_parameters(self, filename, ctx=None, allow_missing=False,
                        ignore_extra=False, cast_dtype=False,
                        dtype_source="current"):
        """Load `save_parameters`' file (either package's); a file of
        full parameter names (``ParameterDict.save``) also loads."""
        loaded = nd.load(filename)
        params = self._collect_params_with_prefix()
        if not loaded and not params:
            return
        if not any("." in k for k in loaded):
            self.collect_params().load(filename, ctx, allow_missing,
                                       ignore_extra, self.prefix)
            return
        _load_into(params, loaded, f"file '{filename}'", ctx,
                   allow_missing, ignore_extra)

    save_params = save_parameters
    load_params = load_parameters

    def _collect_params_with_prefix(self, prefix=""):
        if prefix:
            prefix += "."
        ret = {prefix + key: val for key, val in self._reg_params.items()}
        for name, child in self._children.items():
            ret.update(child._collect_params_with_prefix(prefix + name))
        return ret

    def __call__(self, *args):
        for hook in self._forward_pre_hooks.values():
            hook(self, args)
        out = self.forward(*args)
        for hook in self._forward_hooks.values():
            hook(self, args, out)
        return out

    def forward(self, *args):
        raise NotImplementedError

    def summary(self, *inputs):
        """Run a forward on `inputs` with a hook on every block and print
        a row per block it reached, in the order they finished: name,
        type, the (first) output's shape and the count of the block's own
        initialized parameter values; then the total."""
        rows = []

        def hook(blk, inp, out):
            o = out[0] if isinstance(out, (list, tuple)) else out
            n_params = sum(int(p.data().size)
                           for p in blk._reg_params.values()
                           if p._data is not None)
            rows.append((blk.name, type(blk).__name__,
                         tuple(o.shape) if hasattr(o, "shape") else "?",
                         n_params))

        handles = []

        def walk(b):
            handles.append((b, b.register_forward_hook(hook)))
            for c in b._children.values():
                walk(c)
        walk(self)
        try:
            self(*inputs)
        finally:
            for b, h in handles:
                b._forward_hooks.pop(h, None)
        print(f"{'Layer':<30}{'Type':<20}{'Output Shape':<24}{'Params':<12}")
        print("-" * 86)
        total = 0
        for name, typ, shape, n in rows:
            print(f"{name:<30}{typ:<20}{str(shape):<24}{n:<12}")
            total += n
        print("-" * 86)
        print(f"Total params: {total}")


def _indent(s, num_spaces):
    lines = s.split("\n")
    if len(lines) == 1:
        return s
    first = lines.pop(0)
    return first + "\n" + "\n".join(" " * num_spaces + line
                                    for line in lines)


class _CachedGraph:
    """A HybridBlock's traced symbol run by the Symbol interpreter (the JAX
    package's `_CachedGraph`, without the compile): one interpreter per
    mode, recorded on the autograd tape as one op."""

    def __init__(self, symbol, data_names, params):
        from ..symbol.symbol import graph_eval_fn
        self.symbol = symbol
        self.data_names = data_names
        self.params = params          # {name: Parameter}
        self._fns = {}
        fn, arg_nodes, aux_nodes = graph_eval_fn(symbol, False)
        self._fns[False] = fn
        self.arg_names = [n.name for n in arg_nodes]
        self.aux_names = [n.name for n in aux_nodes]
        self._needs_rng = any(not n.is_variable and n.op.draws(n.attrs)
                              for n in symbol._topo())

    def _fn(self, is_train):
        if is_train not in self._fns:
            from ..symbol.symbol import graph_eval_fn
            self._fns[is_train] = graph_eval_fn(self.symbol, True)[0]
        return self._fns[is_train]

    def __call__(self, inputs, ctx):
        """Outputs (NDArrays on `ctx`) for `inputs` ({data name:
        NDArray})."""
        params = self.params
        st = _autograd._st()
        train = st.training
        args = [inputs[n] if n in inputs else params[n].data(ctx)
                for n in self.arg_names]
        auxs = [params[n].data(ctx) for n in self.aux_names]
        rng = None
        if train and self._needs_rng:
            from .. import random as _random
            rng = _random.generator(ctx.torch_device)
        fn = self._fn(train)
        with torch.set_grad_enabled(st.recording):
            outs, new_aux = fn([a.data for a in args],
                               [a.data for a in auxs], rng)
        if train:
            changed = [(a.data, v) for a, v in zip(auxs, new_aux)
                       if v is not a.data]
            if changed:
                with torch.no_grad():
                    torch._foreach_copy_(*(list(c) for c in zip(*changed)))
        outs = [NDArray(o, ctx=ctx) for o in outs]
        if st.recording and any(a.data.requires_grad for a in args):
            _autograd._record(args + auxs, outs)
        return outs[0] if len(outs) == 1 else outs


class HybridBlock(Block):
    """A Block whose ``hybrid_forward`` composes symbolically (reference
    `block.py:672 HybridBlock`)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._active = False
        self._cached_graph = None
        self._n_inputs = 0      # inputs of the last NDArray call (export)

    def __setattr__(self, name, value):
        super().__setattr__(name, value)
        if isinstance(value, HybridBlock):
            self._cached_graph = None

    def hybridize(self, active=True, **kwargs):
        self._active = active
        self._cached_graph = None
        super().hybridize(active, **kwargs)

    def cast(self, dtype):
        self._cached_graph = None
        super().cast(dtype)

    def infer_shape(self, *args):
        """Fill the parameters' unknown dims from the inputs' shapes."""
        out, names = self._trace_symbol(len(args))
        arg_shapes, _, aux_shapes = out.infer_shape(
            **{n: a.shape for n, a in zip(names, args)})
        known = dict(zip(out.list_arguments(), arg_shapes))
        known.update(zip(out.list_auxiliary_states(), aux_shapes))
        for p in self.collect_params().values():
            if known.get(p.name) is not None:
                p.shape = known[p.name]

    def _trace_symbol(self, n_inputs):
        """``hybrid_forward`` over Variables ``data`` (``data0``, ... for
        several inputs): (output Symbol, data names)."""
        from .. import symbol as sym_mod
        data = [sym_mod.var(f"data{i}" if n_inputs > 1 else "data")
                for i in range(n_inputs)]
        params = {name: p.var() for name, p in self._reg_params.items()}
        out = self.hybrid_forward(sym_mod, *data, **params)
        if isinstance(out, (list, tuple)):
            out = sym_mod.Group(list(out))
        return out, [s.name for s in data]

    def forward(self, x, *args):
        from .. import symbol as sym_mod
        if isinstance(x, sym_mod.Symbol):
            params = {name: p.var() for name, p in self._reg_params.items()}
            return self.hybrid_forward(sym_mod, x, *args, **params)
        if not isinstance(x, NDArray):
            raise MXNetError(f"{type(self).__name__}: call on an NDArray or "
                             f"a Symbol, got {type(x).__name__}")
        ctx = x.context
        self._n_inputs = 1 + len(args)
        if self._active:
            return self._call_cached_op(x, *args)
        try:
            params = {name: p.data(ctx)
                      for name, p in self._reg_params.items()}
        except DeferredInitializationError:
            self._finish_deferred(self._reg_params.values(), x, *args)
            params = {name: p.data(ctx)
                      for name, p in self._reg_params.items()}
        return self.hybrid_forward(nd, x, *args, **params)

    def _finish_deferred(self, params, *inputs):
        """Initialise `params` that wait for a shape, inferring the
        unknown dims from the inputs' shapes first."""
        pending = [p for p in params if p._data is None]
        if any(p._deferred_init and (p.shape is None or 0 in p.shape)
               for p in pending):
            self.infer_shape(*[a for a in inputs if isinstance(a, NDArray)])
        for p in pending:
            p._finish_deferred_init()

    def _call_cached_op(self, *args):
        inputs = [a for a in args if isinstance(a, NDArray)]
        if self._cached_graph is None:
            params = {p.name: p for p in self.collect_params().values()}
            self._finish_deferred(params.values(), *inputs)
            out, names = self._trace_symbol(len(inputs))
            self._cached_graph = _CachedGraph(out, names, params)
        cg = self._cached_graph
        return cg(dict(zip(cg.data_names, inputs)), inputs[0].context)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError

    def export(self, path, epoch=0):
        """``path-symbol.json`` and ``path-%04d.params`` (``arg:``/``aux:``
        keys) of the traced graph, for `Module.load` or serving."""
        if self._cached_graph is not None:
            sym = self._cached_graph.symbol
        elif self._n_inputs:
            sym = self._trace_symbol(self._n_inputs)[0]
        else:
            raise MXNetError("Please first call the block on data at least "
                             "once before calling export.")
        sym.save(f"{path}-symbol.json")
        arg_names = set(sym.list_arguments())
        aux_names = set(sym.list_auxiliary_states())
        arg_dict = {}
        for param in self.collect_params().values():
            if param.name in arg_names:
                arg_dict[f"arg:{param.name}"] = param._reduce()
            elif param.name in aux_names:
                arg_dict[f"aux:{param.name}"] = param._reduce()
        nd.save("%s-%04d.params" % (path, epoch), arg_dict)


class SymbolBlock(HybridBlock):
    """A Symbol as a block (reference `block.py:953 SymbolBlock`): every
    argument of `outputs` that is not one of `inputs` is a parameter,
    every auxiliary state one with ``grad_req="null"``, each registered
    once under its name in the symbol; the forward runs the graph as a
    hybridized block's `_CachedGraph` does."""

    def __init__(self, outputs, inputs, params=None):
        super().__init__(prefix=None, params=params)
        from ..symbol.symbol import Symbol, Group
        if isinstance(outputs, (list, tuple)):
            outputs = Group(list(outputs))
        if isinstance(inputs, Symbol):
            inputs = [inputs]
        self._output_symbol = outputs
        self._input_names = [i.name for i in inputs]
        for name in outputs.list_arguments():
            if name not in self._input_names:
                self._add_param(name)
        for name in outputs.list_auxiliary_states():
            self._add_param(name, grad_req="null")
        # the graph stays when hybridize() or cast() drops _cached_graph
        self._graph = self._cached_graph = _CachedGraph(
            outputs, self._input_names, self._reg_params)

    def _add_param(self, name, **kwargs):
        param = Parameter(name, allow_deferred_init=True, **kwargs)
        self.params._params[name] = param
        self._reg_params[name] = param

    @staticmethod
    def imports(symbol_file, input_names, param_file=None, ctx=None):
        """A SymbolBlock of ``symbol_file`` with data `input_names` (a
        name or a list), its parameters (``arg:``/``aux:`` keys, or bare
        names) loaded from `param_file` onto `ctx`, by default
        `current_context()` (reference `block.py:986`)."""
        from .. import symbol as sym_mod
        from ..context import current_context
        output = sym_mod.load(symbol_file)
        if isinstance(input_names, str):
            input_names = [input_names]
        ret = SymbolBlock(output, [sym_mod.var(n) for n in input_names])
        if param_file is not None:
            loaded = {k.split(":", 1)[1] if ":" in k else k: v
                      for k, v in nd.load(param_file).items()}
            for name, param in ret._reg_params.items():
                if name in loaded:
                    param.shape = loaded[name].shape
                    param.initialize(ctx=ctx or [current_context()])
                    param.set_data(loaded[name])
        return ret

    def forward(self, x, *args):
        if not isinstance(x, NDArray):
            raise MXNetError("SymbolBlock requires NDArray inputs")
        inputs = [x] + [a for a in args if isinstance(a, NDArray)]
        ctx = x.context
        for p in self._reg_params.values():
            if p._data is None and not p._deferred_init:
                p.initialize(ctx=ctx)
            elif p._deferred_init:
                p._finish_deferred_init()
        return self._graph(dict(zip(self._input_names, inputs)), ctx)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError
