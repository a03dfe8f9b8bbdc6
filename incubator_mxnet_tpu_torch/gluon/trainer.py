"""Gluon Trainer (reference `python/mxnet/gluon/trainer.py`).

PyTorch port of `incubator_mxnet_tpu/gluon/trainer.py` on one context.
`step(batch_size)` sets the optimizer's ``rescale_grad`` to the scale the
trainer was given (``optimizer_params["rescale_grad"]``, default 1)
over `batch_size`, exactly as the JAX package does, then updates every
parameter that takes a gradient with one `Updater.update_multi` call
(the multi-tensor SGD, with fp32 master weights for bf16 parameters
under ``multi_precision``), reading the gradient arrays `autograd`
filled.  The update runs in place on the parameters' autograd leaves,
outside the graph, so the next `autograd.record()` sees the new values.

A ``dist_*`` kvstore on one context is created and its keys initialized
at the first step, with the compression asked for, as the JAX package
does (`trainer.py:105-118`); `allreduce_grads` sums only gradients held
on several contexts (`:145-166`), so on one context it pushes nothing,
as there.  Without ``dist`` one context needs no kvstore (the JAX
package creates none either).  Parameters on several contexts are not
ported yet (ROADMAP).  ZeRO state
partitioning (``zero=``) and a device mesh (``mesh=``) need more than
one card and raise.  `save_states` / `load_states` pickle the updater's
states and the optimizer in the port's own format.
"""
from __future__ import annotations

from ..base import MXNetError
from .. import kvstore as kvs
from .. import optimizer as opt
from ..optimizer import states_on_ctx as _on_ctx
from .parameter import ParameterDict, Parameter

__all__ = ["Trainer"]


class Trainer:
    """Applies an optimizer to a set of Parameters (reference
    `gluon/trainer.py:27`)."""

    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None, zero=None, mesh=None):
        if zero not in (None, False) or mesh is not None:
            raise MXNetError(
                "Trainer(zero=..., mesh=...) shards optimizer state over "
                "several cards; the port trains on one (ROADMAP Queue 1, "
                "item 14)")
        if isinstance(params, (dict, ParameterDict)):
            params = list(params.values())
        if not isinstance(params, (list, tuple)):
            raise ValueError("First argument must be a list or dict of "
                             f"Parameters, got {type(params)}.")
        self._params = []
        self._param2idx = {}
        for i, param in enumerate(params):
            if not isinstance(param, Parameter):
                raise ValueError("First argument must be a list or dict of "
                                 f"Parameters, got list of {type(param)}.")
            self._param2idx[param.name] = i
            self._params.append(param)
        optimizer_params = dict(optimizer_params or {})
        self._scale = float(optimizer_params.get("rescale_grad", 1.0))
        self._contexts = self._check_contexts()
        if len(self._contexts) > 1:
            raise MXNetError("Trainer: the port trains on one context; the "
                             f"parameters live on {self._contexts}")
        self._init_optimizer(optimizer, optimizer_params)
        self._kvstore_type = kvstore
        self._compression_params = compression_params
        self._kvstore = None
        self._update_on_kvstore = False
        self._kv_initialized = False

    def _init_kvstore(self):
        """A ``dist`` store (a name, or a dist store) with every live
        parameter's key initialized; else none."""
        kind = self._kvstore_type
        if "dist" in str(kind):
            kv = kvs.create(kind) if isinstance(kind, str) else kind
            if self._compression_params:
                kv.set_gradient_compression(self._compression_params)
            for i, param in enumerate(self._params):
                if param.grad_req != "null":
                    kv.init(i, param.list_data()[0])
            self._kvstore = kv
        self._kv_initialized = True

    def _check_contexts(self):
        contexts = None
        for param in self._params:
            ctx = param.list_ctx()
            if contexts is not None and contexts != ctx:
                raise MXNetError("All Parameters must be initialized on the "
                                 "same set of contexts")
            contexts = ctx
        return contexts or []

    def _init_optimizer(self, optimizer, optimizer_params):
        param_dict = dict(enumerate(self._params))
        if isinstance(optimizer, opt.Optimizer):
            if optimizer_params:
                raise MXNetError("optimizer_params must be None if optimizer "
                                 "is an Optimizer instance")
            self._optimizer = optimizer
            self._optimizer.param_dict = param_dict
        else:
            self._optimizer = opt.create(optimizer, param_dict=param_dict,
                                         **optimizer_params)
        self._updaters = [opt.get_updater(self._optimizer)]

    @property
    def learning_rate(self):
        o = self._optimizer
        return o.lr if o.lr_scheduler is None else o.lr_scheduler(
            o.num_update)

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def step(self, batch_size, ignore_stale_grad=False):
        """`allreduce_grads`, then `update` (reference `trainer.py:254`)."""
        self.allreduce_grads()
        self.update(batch_size, ignore_stale_grad)

    def allreduce_grads(self):
        """Sum through the kvstore the gradients held on several contexts
        (on one context, none)."""
        if not self._kv_initialized:
            self._init_kvstore()
        if self._kvstore is None:
            return
        live = [(i, p.list_grad()) for i, p in enumerate(self._params)
                if p.grad_req != "null" and len(p.list_grad()) > 1]
        for i, grads in live:
            self._kvstore.push(i, grads, priority=-i)
            self._kvstore.pull(i, grads, priority=-i)

    def update(self, batch_size, ignore_stale_grad=False):
        """Set ``rescale_grad`` to the trainer's scale over `batch_size`
        and update every parameter that takes a gradient."""
        if not self._kv_initialized:
            self._init_kvstore()
        self._optimizer.rescale_grad = self._scale / batch_size
        live = [(i, p) for i, p in enumerate(self._params)
                if p.grad_req != "null"]
        if live:
            self._updaters[0].update_multi(
                [i for i, _ in live], [p.list_grad()[0] for _, p in live],
                [p.list_data()[0] for _, p in live])

    def get_checkpoint_state(self):
        """The updater's states (host arrays) and the pickled optimizer
        (update counts, learning-rate schedule) as one bytes blob, what an
        elastic checkpoint stores per Trainer (`checkpoint/state.py`)."""
        return self._updaters[0].get_states(dump_optimizer=True)

    def set_checkpoint_state(self, blob):
        """Restore a `get_checkpoint_state` blob: its states, each on its
        parameter's context, and its optimizer replace the trainer's."""
        updater = self._updaters[0]
        updater.set_states(blob)
        for i, state in updater.states.items():
            updater.states[i] = _on_ctx(state,
                                        self._params[i].list_ctx()[0])
        self._optimizer = updater.optimizer
        self._optimizer.param_dict = dict(enumerate(self._params))

    def save_states(self, fname):
        """`get_checkpoint_state` to `fname`."""
        with open(fname, "wb") as f:
            f.write(self.get_checkpoint_state())

    def load_states(self, fname):
        """Restore `save_states`' file."""
        with open(fname, "rb") as f:
            self.set_checkpoint_state(f.read())
