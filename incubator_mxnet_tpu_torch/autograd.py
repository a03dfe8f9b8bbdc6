"""Autograd: recording and differentiating the imperative API.

PyTorch port of `incubator_mxnet_tpu/autograd.py` (reference
`python/mxnet/autograd.py`, `src/imperative/imperative.cc`).  The JAX
package keeps a tape of (op, params, inputs, outputs) and takes each
op's gradient with `jax.vjp`; here torch's autograd is the tape's
arithmetic:

* an NDArray with an attached gradient (`NDArray.attach_grad`,
  `mark_variables`) or a gluon `Parameter` whose ``grad_req`` is not
  ``"null"`` holds a leaf tensor with ``requires_grad``;
* under `record()` every op of `ndarray.invoke` runs with grad mode on,
  elsewhere under `torch.no_grad`; `pause()` inside `record()` stops
  recording without changing the mode;
* the tape keeps, per recorded op, a key for each input and output
  tensor and the inputs that carry a gradient array (the marked
  variables, alive anyway), never an activation: torch's graph keeps
  what backward needs and frees the rest as it goes.  Which marked
  variables a backward reaches, and which head a discarded scope left
  behind, are read from it exactly as the JAX package reads its own
  tape;
* `backward` walks the tape back from the heads, takes the gradients of
  the marked variables it reached with one `torch.autograd.grad`, and
  then writes (``grad_req="write"``) or adds (``"add"``) them into the
  variables' gradient arrays, in place.  A variable that an op on the
  walk consumed without depending on it gets zeros, as `jax.vjp` gives
  it; a variable only ops off the walk consumed keeps its gradient.
  torch's own ``tensor.grad`` is never used: torch accumulates there,
  which is MXNet's ``add``, not ``write``.

A fresh outermost `record()` starts a new tape.  `Function` is a
`torch.autograd.Function` around the user's `forward` and `backward`.
`get_symbol` raises, as the JAX package's does: a block's graph comes
from `hybridize()` and `export`.
"""
from __future__ import annotations

import itertools
import threading

import torch

from .base import MXNetError

__all__ = ["record", "pause", "train_mode", "predict_mode",
           "mark_variables", "backward", "grad", "is_recording",
           "is_training", "set_recording", "set_training", "get_symbol",
           "Function"]

_state = threading.local()


def _st():
    if not hasattr(_state, "recording"):
        _state.recording = False
        _state.training = False
        # [(input keys, inputs with a gradient array, output keys,
        #   function?)]
        _state.tape = []
        _state.scope_depth = 0
    return _state


_KEY = "_mx_tape_key"
_keys = itertools.count()


def _key(t):
    """The tensor's key on the tape: a serial number stored on it when it
    is first recorded (an id would be reused once the tensor is freed)."""
    k = getattr(t, _KEY, None)
    if k is None:
        k = next(_keys)
        setattr(t, _KEY, k)
    return k


def is_recording():
    """Whether ops are recorded for backward (reference
    `autograd.py:32`)."""
    return _st().recording


def is_training():
    """Whether mode-dependent ops (BatchNorm, Dropout) run in training
    mode."""
    return _st().training


def set_recording(is_record):
    st = _st()
    prev, st.recording = st.recording, bool(is_record)
    return prev


def set_training(train_mode_):
    st = _st()
    prev, st.training = st.training, bool(train_mode_)
    return prev


class _RecordingStateScope:
    """Sets recording and training for a `with` block and restores them
    after (reference `autograd.py:_RecordingStateScope`)."""

    def __init__(self, is_record, train_mode_):
        self._enter_is_record = is_record
        self._enter_train_mode = train_mode_
        self._prev_is_record = None
        self._prev_train_mode = None
        self._grad_mode = None

    def __enter__(self):
        st = _st()
        if self._enter_is_record is not None:
            # a fresh outermost record() starts a new graph
            if self._enter_is_record and st.scope_depth == 0 and st.tape:
                st.tape = []
            st.scope_depth += 1
            self._prev_is_record = set_recording(self._enter_is_record)
            if self._enter_is_record:
                self._grad_mode = torch.is_grad_enabled()
                torch.set_grad_enabled(True)
        if self._enter_train_mode is not None:
            self._prev_train_mode = set_training(self._enter_train_mode)
        return self

    def __exit__(self, ptype, value, trace):
        if self._enter_is_record is not None:
            _st().scope_depth -= 1
            set_recording(self._prev_is_record)
            if self._grad_mode is not None:
                torch.set_grad_enabled(self._grad_mode)
        if self._enter_train_mode is not None:
            set_training(self._prev_train_mode)


def record(train_mode=True):
    """Record the ops in the block for backward, in training mode unless
    ``train_mode=False`` (reference `autograd.py:122`)."""
    return _RecordingStateScope(True, train_mode)


def pause(train_mode=False):
    """Stop recording inside a `record` block (reference
    `autograd.py:146`)."""
    return _RecordingStateScope(False, train_mode)


def train_mode():
    """Training-mode op behaviour without recording."""
    return _RecordingStateScope(None, True)


def predict_mode():
    """Predict-mode op behaviour (reference `autograd.py:181`)."""
    return _RecordingStateScope(None, False)


def mark_variables(variables, gradients, grad_reqs="write"):
    """Make `variables` leaves whose gradients `backward` writes into
    `gradients` (reference `autograd.py:197`)."""
    if not isinstance(variables, (list, tuple)):
        variables, gradients = [variables], [gradients]
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for v, g, req in zip(variables, gradients, grad_reqs):
        v._mark_variable(g, req)


def _record(inputs, outputs, function=False):
    """Called by `ndarray.invoke` (and `Function`) after an op ran under
    `record()` on an input that requires a gradient."""
    _st().tape.append((tuple(_key(d._data) for d in inputs),
                       tuple(d for d in inputs if d._grad is not None),
                       tuple(_key(o._data) for o in outputs), function))


def _marked(arr):
    return arr._grad is not None and arr._grad_req not in (None, "null")


def _walk(heads, retain_graph, create_graph=False):
    """One reverse pass over the tape from `heads`: (keys of the tensors
    it reached, the marked NDArrays among the inputs of the ops it passed
    and the heads, in first-seen order).  Entries walked are dropped from
    the tape unless `retain_graph`."""
    st = _st()
    tape = st.tape
    live = {getattr(h._data, _KEY, -1) for h in heads}
    marked, seen = [], set()
    visited = set()
    for i in range(len(tape) - 1, -1, -1):
        in_keys, inputs, out_keys, function = tape[i]
        if live.isdisjoint(out_keys):
            continue
        if function and create_graph:
            raise MXNetError(
                "create_graph=True cannot differentiate through a custom "
                "autograd.Function (its backward runs outside the graph); "
                "express the op with registered operators or take "
                "first-order gradients only")
        visited.add(i)
        live.update(in_keys)
        for d in inputs:
            if _marked(d) and id(d) not in seen:
                seen.add(id(d))
                marked.append(d)
    for h in heads:
        if _marked(h) and id(h) not in seen:
            seen.add(id(h))
            marked.append(h)
    if not retain_graph:
        st.tape = [e for i, e in enumerate(tape) if i not in visited]
    return live, marked


def _grads(heads, head_grads, leaves, retain_graph, create_graph):
    """torch.autograd.grad of the heads (a ones head gradient where
    `head_grads` has None) with respect to `leaves`; zeros where a leaf
    gets none."""
    outs, cts = [], []
    for h, hg in zip(heads, head_grads):
        t = h._data
        if not t.requires_grad:
            continue
        outs.append(t)
        cts.append(torch.ones_like(t) if hg is None
                   else hg._data.to(t.device, t.dtype))
    grads = [None] * len(leaves)
    want = [i for i, leaf in enumerate(leaves) if leaf.requires_grad]
    if outs and want:
        got = torch.autograd.grad(outs, [leaves[i] for i in want], cts,
                                  retain_graph=retain_graph or create_graph,
                                  create_graph=create_graph,
                                  allow_unused=True)
        for i, g in zip(want, got):
            grads[i] = g
    return [torch.zeros_like(leaf) if g is None else g
            for leaf, g in zip(leaves, grads)]


def _as_list(heads, head_grads):
    if not isinstance(heads, (list, tuple)):
        heads = [heads]
        head_grads = [head_grads] if head_grads is not None else None
    if head_grads is None:
        head_grads = [None] * len(heads)
    elif not isinstance(head_grads, (list, tuple)):
        head_grads = [head_grads]
    return list(heads), list(head_grads)


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """Gradients of `heads` into the gradient arrays of the marked
    variables they reach (reference `autograd.py:243`); a head without a
    head gradient gets ones of its shape."""
    heads, head_grads = _as_list(heads, head_grads)
    st = _st()
    on_tape = {k for _, _, outs, _ in st.tape for k in outs}
    for h in heads:
        if h._data.requires_grad and h._grad is None and \
                getattr(h._data, _KEY, -1) not in on_tape:
            raise MXNetError(
                "backward() head is not on the current autograd tape: it was "
                "recorded in an earlier record() scope whose graph was "
                "discarded when a new outermost record() scope started; "
                "call backward before opening the next record scope")
    _, marked = _walk(heads, retain_graph)
    if not marked:
        return
    grads = _grads(heads, head_grads, [v._data for v in marked],
                   retain_graph, False)
    with torch.no_grad():
        for v, g in zip(marked, grads):
            tgt = v._grad._data
            if v._grad_req == "add":
                tgt.add_(g.to(tgt.dtype))
            else:
                tgt.copy_(g)


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """The gradients of `heads` with respect to `variables` as new
    NDArrays, leaving the gradient arrays alone (reference
    `autograd.py:270`).  With ``create_graph`` they are recorded, so a
    later backward differentiates through them."""
    from .ndarray.ndarray import NDArray
    heads, head_grads = _as_list(heads, head_grads)
    single = not isinstance(variables, (list, tuple))
    if single:
        variables = [variables]
    retain = bool(retain_graph) if retain_graph is not None \
        else create_graph
    live, _ = _walk(heads, retain, create_graph)
    for v in variables:
        if getattr(v._data, _KEY, -1) not in live:
            raise MXNetError("Some variables are not used by or not "
                             "reachable from the heads")
    with torch.set_grad_enabled(create_graph or torch.is_grad_enabled()):
        grads = _grads(heads, head_grads, [v._data for v in variables],
                       retain, create_graph)
    out = [NDArray(g if create_graph else g.detach(), ctx=v.context)
           for v, g in zip(variables, grads)]
    if create_graph and is_recording():
        _record(list(heads) + list(variables), out)
    return out[0] if single else out


def get_symbol(x):
    """The Symbol of the recorded computation of `x`: not available, as
    in the JAX package; trace a block with `hybridize()` instead."""
    raise MXNetError("autograd.get_symbol: use hybridize()/CachedOp "
                     "tracing instead")


class Function:
    """A differentiable function with a hand-written backward (reference
    `autograd.py:363`): subclass and define ``forward`` and ``backward``
    on NDArrays.  Both run with recording paused; the pair becomes a
    `torch.autograd.Function`, so the user's backward is what autograd
    calls for it."""

    def __init__(self):
        self._saved = ()

    def save_for_backward(self, *args):
        self._saved = args

    @property
    def saved_tensors(self):
        return self._saved

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError

    def __call__(self, *inputs):
        from .ndarray.ndarray import NDArray
        func = self
        ctx = inputs[0].context
        shape = {}

        class _Apply(torch.autograd.Function):
            @staticmethod
            def forward(_, *tensors):
                with pause():
                    out = func.forward(*(NDArray(t, ctx=ctx)
                                         for t in tensors))
                shape["single"] = not isinstance(out, (list, tuple))
                outs = [out] if shape["single"] else list(out)
                return tuple(o._data for o in outs)

            @staticmethod
            def backward(_, *cts):
                with pause():
                    igrads = func.backward(*(NDArray(c, ctx=ctx)
                                             for c in cts))
                if not isinstance(igrads, (list, tuple)):
                    igrads = [igrads]
                return tuple(None if g is None else g._data
                             for g in igrads)

        recording = is_recording() and any(
            i._data.requires_grad for i in inputs)
        with torch.set_grad_enabled(recording):
            tensors = _Apply.apply(*(i._data for i in inputs))
        outs = [NDArray(t, ctx=ctx) for t in tensors]
        if recording:
            _record(list(inputs), outs, True)
        return outs[0] if shape["single"] else outs
