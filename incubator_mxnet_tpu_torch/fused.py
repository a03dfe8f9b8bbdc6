"""FusedInference: the request path's evaluator over pinned parameters;
FusedTrainStep: `Module.fit`'s training step in one call.

PyTorch port of `FusedInference` in `incubator_mxnet_tpu/fused.py`.  The
JAX class compiles the Symbol into one XLA program per input signature,
keyed in the unified program cache.  PyTorch runs eagerly, so here the
parameters are pinned on the device once (`set_params`) and every
dispatch is one eager pass of the graph interpreter
(`symbol.graph_eval_fn`) under `torch.inference_mode`.  The program cache,
its disk tier, the recompile auditor and scan dedup have no counterpart
here (ROADMAP.md lists what a later slice may bring).
"""
from __future__ import annotations

import numpy as _np
import torch

from .base import MXNetError
from .ndarray import sparse as _sparse
from .ndarray.ndarray import NDArray
from .symbol.symbol import graph_eval_fn

__all__ = ["FusedInference", "FusedTrainStep"]


def _as_tensor(v, device):
    """NDArray / tensor / numpy -> tensor on `device` (a sparse array
    densified there)."""
    if isinstance(v, _sparse.BaseSparseNDArray):
        return _sparse.dense_tensor(v, device)
    if isinstance(v, NDArray):
        v = v.data
    if not isinstance(v, torch.Tensor):
        v = torch.from_numpy(_np.ascontiguousarray(v))
    return v.to(device=device)


class FusedInference:
    """Inference over a pinned parameter set, one eager graph pass per call.

    Thread-safe for concurrent callers: dispatch state is per call; the
    only mutation, `set_params`, swaps the whole (params, aux) snapshot
    at once, so in-flight calls finish against the snapshot they captured.
    """

    def __init__(self, symbol, ctx, data_names):
        self._symbol = symbol
        self._ctx = ctx
        self._device = ctx.torch_device
        self._arg_names = symbol.list_arguments()
        self._aux_names = symbol.list_auxiliary_states()
        unknown = [n for n in data_names if n not in self._arg_names]
        if unknown:
            raise MXNetError(
                f"FusedInference: data names {unknown} are not arguments "
                f"of the symbol (has {self._arg_names})")
        self._data_names = list(data_names)
        # every non-data argument is a slot the param dict fills, except
        # a loss head's label, which becomes a per-call input
        self._slot_names = [n for n in self._arg_names
                            if n not in self._data_names]
        self._label_slots = _label_slots(symbol)
        self._gfn, _, _ = graph_eval_fn(symbol, False)
        self._state = None   # ({name: tensor}, [aux tensors], extra names)

    @property
    def output_names(self):
        return self._symbol.list_outputs()

    @property
    def device(self):
        return self._device

    @property
    def extra_names(self):
        """Argument slots the param dict left unfilled (loss-head labels),
        fed per call: `__call__`'s ``extras``, in this order."""
        return [] if self._state is None else list(self._state[2])

    def set_params(self, arg_params, aux_params=None):
        """Pin the parameter set on the device.  Every parameter argument
        and aux state must have a value; an argument that feeds only the
        ``label`` input of its ops (a loss head's label) may be left out
        and becomes a per-call input, as in the JAX package (which makes
        any unfilled slot one)."""
        aux_params = aux_params or {}
        unfilled = [n for n in self._slot_names if n not in arg_params]
        missing = [n for n in unfilled if n not in self._label_slots] + \
            [n for n in self._aux_names if n not in aux_params]
        if missing:
            raise MXNetError(f"FusedInference: no value for {missing}")
        params = {n: _as_tensor(arg_params[n], self._device)
                  for n in self._slot_names if n in arg_params}
        aux = [_as_tensor(aux_params[n], self._device)
               for n in self._aux_names]
        self._state = (params, aux, unfilled)

    def __call__(self, inputs, extras=()):
        """Run the graph on `inputs` (arrays ordered like `data_names`)
        and `extras` (ordered like `extra_names`); returns the output
        tensors, on the device, possibly still being computed."""
        state = self._state
        if state is None:
            raise MXNetError("FusedInference: set_params before calling")
        params, aux, extra_names = state
        feed = dict(params)
        feed.update(zip(self._data_names,
                        (_as_tensor(v, self._device) for v in inputs)))
        feed.update(zip(extra_names,
                        (_as_tensor(v, self._device) for v in extras)))
        with torch.inference_mode():
            outs, _ = self._gfn([feed[n] for n in self._arg_names], aux)
        return outs


def _label_slots(symbol):
    """Names of the variables that feed only ``label`` input slots."""
    slots = {}
    for node in symbol._topo():
        if node.is_variable:
            continue
        names = node.op.list_input_names(node.attrs) or []
        for i, (src, _) in enumerate(node.inputs):
            if src.is_variable:
                slot = names[i] if i < len(names) else None
                slots.setdefault(src.name, set()).add(slot)
    return {n for n, s in slots.items() if s == {"label"}}


class FusedTrainStep:
    """`Module.fit`'s step in one call: the training forward, the backward
    through the executor's autograd graph, the optimizer's multi-tensor
    update of every parameter in place, the BatchNorm aux write-back and
    the metric's update on the device (PyTorch port of `FusedTrainStep`
    in `incubator_mxnet_tpu/fused.py`).

    Nothing in a step waits for the device: the gradients never land in
    the executor's gradient arrays, the update reads them straight from
    autograd, and the metric adds to totals that stay on the device until
    its `get`.  Every write is in place, so nothing is deferred and the
    module's arrays are current after each call.  The JAX class compiles
    the step into one program (and K steps into one scan) with donated
    buffers and a program cache; this one runs eagerly, and capturing it
    as a CUDA graph is ROADMAP work.

    With a training guardian attached (`attach_guardian`) each step also
    computes the health word on the device, as the JAX step does in its
    program: the gradients times the guardian's multiplier, one
    all-finite flag over the gradients, the floating outputs and the
    new weights, and the displacement ratio ||w_new - w|| / ||w||,
    handed to `TrainingGuardian.record_health` as device scalars.  A
    step that is not finite leaves the weights, the optimizer states, the
    BatchNorm aux and the metric's totals bit for bit as they were; the
    update counts and the random streams advance.  The step copies the
    parameters, states and aux into buffers first (`torch._foreach_copy_`)
    and afterwards keeps ``torch.where(flag, new, old)`` of each, a select
    that gives ``new`` or ``old`` bit for bit whatever the floats hold.
    The flag is the finiteness of each tensor's L2 norm, accumulated in
    float32 (`torch._foreach_norm`, whose sums carry a NaN or an infinity
    through); a tensor whose norm overflows float32 counts as not finite.
    A healthy step's results are bit-identical to the unguarded step's,
    and nothing reads the device.

    Built by `Module.init_optimizer` when `Module._fusable` allows it;
    optimizer state lives in the module's updater either way, so the
    per-batch path and this one share it.
    """

    def __init__(self, module, updater):
        group = module._exec_group
        self._exec = group.execs[0]
        self._updater = updater
        self._input_names = group.data_names + group.label_names
        self._label_names = group.label_names
        arg_names = self._exec._arg_names
        wrt = [arg_names[i] for i in self._exec._wrt]
        # the updated parameters: every argument the executor takes a
        # gradient for (Module gives inputs no gradient here)
        self._param_names = [n for n in group.param_names
                             if group.grad_req.get(n) == "write"]
        self._grad_pos = [wrt.index(n) for n in self._param_names]
        self._indices = [group.param_names.index(n)
                         for n in self._param_names]
        self._shapes = {n: self._exec.arg_dict[n].shape
                        for n in self._input_names}
        self.steps = 0
        self._guardian = None
        self._plan = None         # the guarded step's tensors and buffers

    def attach_guardian(self, guardian):
        """Arm (or, with None, disarm) the training guardian's health
        word and the select of a step that is not finite."""
        armed = guardian is not None and getattr(guardian, "in_graph", True)
        self._guardian = guardian if armed else None

    def __call__(self, data_batch, eval_metric=None):
        """Run one step on `data_batch`.  Returns False, having done
        nothing, when the step cannot take it (a metric without
        `device_update`, a batch of another shape, an optimizer that
        draws random numbers, as `SGLD` does: the JAX step declines one
        whose update draws while it traces): the caller then runs the
        per-batch path."""
        leaves = _metric_leaves(eval_metric)
        values = list(data_batch.data) + list(data_batch.label or [])
        if getattr(self._updater.optimizer, "draws_rng", False):
            return False
        if leaves is None or len(values) != len(self._input_names) or any(
                tuple(v.shape) != self._shapes[n]
                for n, v in zip(self._input_names, values)):
            return False
        exe = self._exec
        guardian = self._guardian
        if guardian is not None:
            plan = self._guard_plan()
            for live, old in plan[4]:
                torch._foreach_copy_(old, live)
        outs = exe.forward(is_train=True,
                           **dict(zip(self._input_names, values)))
        grads = exe._grads()
        grads = [grads[p] for p in self._grad_pos]
        if guardian is not None:
            gmul = guardian.step_multipliers(1)[0]
            if gmul != 1.0:   # NaN or the spike scale, injected
                torch._foreach_mul_(grads, gmul)
        self._updater.update_multi(
            self._indices, [NDArray(g) for g in grads],
            [exe.arg_dict[n] for n in self._param_names])
        finite = None
        if guardian is not None:
            finite, signal = self._health(grads, outs, plan)
            guardian.record_health(1, finite, signal)
        labels = [exe.arg_dict[n] for n in self._label_names]
        for metric in leaves:
            totals = metric.device_update(labels, outs)
            if finite is not None:
                # a refused step adds nothing to the metric's totals
                totals = [torch.where(finite, t, 0) for t in totals]
            metric._accumulate(*totals)
        self.steps += 1
        return True

    # -- the guardian's health word ------------------------------------------
    def _guard_plan(self):
        """(key, live, copies, number of weights, (live, copies) by
        dtype): the tensors a step may change (weights, optimizer-state
        leaves, aux) and their copy buffers, also grouped by dtype (a
        multi-tensor copy of one dtype takes the fused route; a mixed list
        is copied tensor by tensor).  Built once, and again only when the
        module replaced a
        weight, an index's optimizer state or an aux array (`key` holds
        them; the optimizers update in place, so a step never does).
        Every updated index's state is created first, as `update_multi`
        would."""
        exe, upd = self._exec, self._updater
        for i, n in zip(self._indices, self._param_names):
            if i not in upd.states:
                upd.states[i] = upd.optimizer.create_state_multi_precision(
                    i, exe.arg_dict[n])
        ws = [exe.arg_dict[n].data for n in self._param_names]
        states = [upd.states[i] for i in self._indices]
        aux = [a.data for a in exe.aux_arrays]
        key = ws + states + aux
        plan = self._plan
        if plan is not None and len(plan[0]) == len(key) and \
                all(a is b for a, b in zip(plan[0], key)):
            return plan
        leaves, stack = [], list(reversed(states))
        while stack:
            st = stack.pop()
            if isinstance(st, NDArray):
                leaves.append(st.data)
            elif isinstance(st, torch.Tensor):
                leaves.append(st)
            elif isinstance(st, (tuple, list)):
                stack.extend(reversed(st))
        live = ws + leaves + aux
        old = [torch.empty_like(t) for t in live]
        groups = {}
        for t, o in zip(live, old):
            if t.numel():
                pair = groups.setdefault(t.dtype, ([], []))
                pair[0].append(t)
                pair[1].append(o)
        self._plan = (key, live, old, len(ws), list(groups.values()))
        return self._plan

    def _health(self, grads, outs, plan):
        """The health word of the step just applied: (all-finite flag,
        displacement ratio) as device scalars.  The flag covers the
        gradients, the floating outputs and the new weights (as the JAX
        step's does); a step that is not finite is selected away and its
        ratio is NaN.  The displacement is taken after the select, into
        the old weights' buffers, so no weight-sized temporary is made."""
        _, live, old, n, _ = plan
        ws, old_ws = live[:n], old[:n]
        floats = [o.data for o in outs if o.data.is_floating_point()]
        dev = self._exec._device
        finite = _norms(grads + floats + ws, dev).isfinite().all()
        wn = torch.linalg.vector_norm(_norms(old_ws, dev))
        _select(finite, live, old)
        if ws:
            torch._foreach_sub_(old_ws, ws)    # old - new: its norm is dn
        dn = torch.linalg.vector_norm(_norms(old_ws, dev))
        return finite, torch.where(finite, dn / (wn + 1e-12), float("nan"))

    def ring_placement(self):
        """Where the h2d ring lands this step's batches
        (`io_plane.RingPlacement`): the executor's device and, per input,
        the bound argument's dtype (labels uncast), so the executor takes
        each one with a device-to-device copy and no cast."""
        from .io_plane import RingPlacement
        return RingPlacement.for_fused_step(self)


def _norms(tensors, device):
    """A float32 vector of the tensors' L2 norms, one multi-tensor launch
    a dtype (a mixed list would be normed tensor by tensor), accumulated
    in float32 (float64 tensors in float64), in the order of the dtypes'
    first tensors; a NaN or infinity in a tensor carries through its
    norm."""
    groups = {}
    for t in tensors:
        if t.numel():
            groups.setdefault(t.dtype, []).append(t)
    parts = [torch.stack(torch._foreach_norm(ts) if dt == torch.float64
                         else torch._foreach_norm(ts, 2,
                                                  dtype=torch.float32)
                         ).float() for dt, ts in groups.items()]
    if not parts:
        return torch.zeros(0, device=device)
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _select(flag, live, old):
    """``live = live if flag else old`` for every pair, in place and bit
    for bit (a select, not arithmetic: a NaN of `live` is not carried
    into `old`), without reading `flag` on the host.  There is no
    multi-tensor where, so it is one launch a tensor."""
    for t, o in zip(live, old):
        torch.where(flag, t, o, out=t)


def _metric_leaves(eval_metric):
    """The leaf metrics of `eval_metric`, or None when one of them cannot
    count on the device."""
    from . import metric as _metric
    if eval_metric is None:
        return []
    leaves = eval_metric.metrics if isinstance(
        eval_metric, _metric.CompositeEvalMetric) else [eval_metric]
    if not all(getattr(m, "device_update", None) is not None
               for m in leaves):
        return None
    return leaves
