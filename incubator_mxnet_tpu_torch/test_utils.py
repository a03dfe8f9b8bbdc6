"""Test utilities (reference `python/mxnet/test_utils.py`).

PyTorch port of `incubator_mxnet_tpu/test_utils.py`: the operator-test
backbone — `check_numeric_gradient` (central differences against the
registered gradient), `check_symbolic_forward` / `check_symbolic_backward`,
`assert_almost_equal` — and `check_consistency`, which runs one symbol
on several (context, dtype) configurations and holds their outputs and
gradients to the last one's: ``[{"ctx": mx.cpu(0), ...}, {"ctx":
mx.gpu(0), ...}]`` is the port's card-against-CPU parity harness.
`default_context()` is the card unless `set_default_context` says
otherwise.  Divergence: `check_numeric_gradient` binds its arguments in
``dtype`` (float64 by default), where the JAX function binds float32
whatever ``dtype`` says.  `get_mnist_like` is the synthetic MNIST the
examples and tests train on without the downloaded files.
"""
from __future__ import annotations

import numpy as np
import torch

from .context import current_context
from .ndarray.ndarray import NDArray, array

__all__ = ["default_context", "set_default_context", "same", "almost_equal",
           "assert_almost_equal", "numeric_grad", "check_numeric_gradient",
           "check_symbolic_forward", "check_symbolic_backward",
           "check_consistency", "get_mnist_like"]

_default_ctx = [None]


def default_context():
    """The context the checks run on unless told otherwise: the one
    `set_default_context` set, else `current_context()` (the card)."""
    return _default_ctx[0] or current_context()


def set_default_context(ctx):
    _default_ctx[0] = ctx


def _np(a):
    return a.asnumpy() if isinstance(a, NDArray) else np.asarray(a)


def same(a, b):
    return np.array_equal(_np(a), _np(b))


def almost_equal(a, b, rtol=None, atol=None, equal_nan=False):
    return np.allclose(_np(a), _np(b), rtol=1e-5 if rtol is None else rtol,
                       atol=1e-20 if atol is None else atol,
                       equal_nan=equal_nan)


def assert_almost_equal(a, b, rtol=None, atol=None, names=("a", "b"),
                        equal_nan=False):
    """Raise AssertionError unless |a - b| <= atol + rtol |b| everywhere
    (reference `test_utils.py:470`)."""
    np.testing.assert_allclose(_np(a), _np(b),
                               rtol=1e-5 if rtol is None else rtol,
                               atol=1e-20 if atol is None else atol,
                               equal_nan=equal_nan,
                               err_msg=f"{names[0]} vs {names[1]}")


def _parse_location(sym, location, ctx, dtype=np.float32):
    """{argument name: NDArray on `ctx`}; a list is taken in
    ``sym.list_arguments()`` order."""
    if not isinstance(location, dict):
        location = dict(zip(sym.list_arguments(), location))
    return {k: v if isinstance(v, NDArray) else
            array(v, ctx=ctx, dtype=getattr(v, "dtype", dtype))
            for k, v in location.items()}


def _write(arr, value):
    """Overwrite a bound array with `value` (numpy, tensor or NDArray),
    cast to its dtype and moved to its device."""
    if isinstance(value, NDArray):
        value = value.data
    elif not isinstance(value, torch.Tensor):
        value = torch.from_numpy(np.ascontiguousarray(value))
    arr._set_data(value.to(arr.data.device, arr.data.dtype))


def _bind(sym, ctx, grad_req, location, dtype=None):
    shapes = {k: v.shape for k, v in location.items()}
    type_dict = None if dtype is None else \
        {k: np.dtype(dtype).name for k in location}
    ex = sym.simple_bind(ctx=ctx, grad_req=grad_req, type_dict=type_dict,
                         **shapes)
    for k, v in location.items():
        _write(ex.arg_dict[k], v)
    return ex


def _set_aux(ex, aux_states):
    for k, v in (aux_states or {}).items():
        _write(ex.aux_dict[k], v)


def numeric_grad(executor, location, aux_states=None, eps=1e-4,
                 use_forward_train=True):
    """Central differences of sum(outputs) with respect to each array of
    `location` (name -> NDArray), one element at a time, in float64 on
    the host; the bound arrays are restored after."""
    del aux_states
    approx_grads = {}
    for name, arr in location.items():
        base = arr.asnumpy().astype("float64")
        target = executor.arg_dict[name]
        grad = np.zeros_like(base)
        it = np.nditer(base, flags=["multi_index"])
        while not it.finished:
            idx = it.multi_index
            orig = base[idx]
            vals = []
            for sign in (1, -1):
                base[idx] = orig + sign * eps
                _write(target, base)
                outs = executor.forward(is_train=use_forward_train)
                vals.append(sum(float(o.asnumpy().astype("float64").sum())
                                for o in outs))
            base[idx] = orig
            grad[idx] = (vals[0] - vals[1]) / (2 * eps)
            it.iternext()
        _write(target, base)
        approx_grads[name] = grad
    return approx_grads


def check_numeric_gradient(sym, location, aux_states=None, numeric_eps=1e-3,
                           rtol=1e-2, atol=None, grad_nodes=None,
                           use_forward_train=True, ctx=None,
                           grad_stype_dict=None, dtype=np.float64):
    """Hold the registered gradient of sum(outputs) (a ones cotangent)
    to central finite differences (reference `test_utils.py:790`).  A
    loss head whose gradient is implicit (``SoftmaxOutput``: p - onehot,
    whatever the cotangent) is not the derivative of its output, and is
    rejected, as it is by the JAX function."""
    ctx = ctx or default_context()
    location = _parse_location(sym, location, ctx, dtype)
    if grad_nodes is None:
        grad_nodes = [n for n in sym.list_arguments() if n in location]
    ex = _bind(sym, ctx, {n: ("write" if n in grad_nodes else "null")
                          for n in sym.list_arguments()}, location, dtype)
    _set_aux(ex, aux_states)
    ex.forward(is_train=use_forward_train)
    ex.backward()
    analytic = {n: ex.grad_dict[n].asnumpy() for n in grad_nodes}
    approx = numeric_grad(ex, {k: location[k] for k in grad_nodes},
                          eps=numeric_eps,
                          use_forward_train=use_forward_train)
    for name in grad_nodes:
        assert_almost_equal(analytic[name], approx[name], rtol=rtol,
                            atol=atol if atol is not None else 1e-4,
                            names=(f"analytic_{name}", f"numeric_{name}"))


def check_symbolic_forward(sym, location, expected, rtol=1e-5, atol=None,
                           aux_states=None, ctx=None, dtype=np.float32,
                           equal_nan=False):
    """Hold an inference forward's outputs to `expected` (reference
    `test_utils.py:923`); returns the outputs as numpy."""
    ctx = ctx or default_context()
    location = _parse_location(sym, location, ctx, dtype)
    ex = _bind(sym, ctx, "null", location)
    _set_aux(ex, aux_states)
    outputs = ex.forward(is_train=False)
    for out, exp in zip(outputs, expected):
        assert_almost_equal(out.asnumpy(), exp, rtol=rtol,
                            atol=atol if atol is not None else 1e-20,
                            equal_nan=equal_nan)
    return [o.asnumpy() for o in outputs]


def check_symbolic_backward(sym, location, out_grads, expected, rtol=1e-5,
                            atol=None, aux_states=None, grad_req="write",
                            ctx=None, grad_stypes=None, equal_nan=False,
                            dtype=np.float32):
    """Hold the gradients of a training forward and its backward (with
    `out_grads` as cotangents) to `expected` ({name: array}, or a list in
    argument order); returns the gradients as numpy."""
    ctx = ctx or default_context()
    location = _parse_location(sym, location, ctx, dtype)
    if isinstance(expected, (list, tuple)):
        expected = dict(zip(sym.list_arguments(), expected))
    ex = _bind(sym, ctx, grad_req, location)
    _set_aux(ex, aux_states)
    ex.forward(is_train=True)
    if out_grads is not None and not isinstance(out_grads, (list, tuple)):
        out_grads = [out_grads]
    if out_grads is not None:
        out_grads = [g if isinstance(g, NDArray) else array(g, ctx=ctx)
                     for g in out_grads]
    ex.backward(out_grads)
    grads = {n: ex.grad_dict[n].asnumpy() for n in expected
             if ex.grad_dict.get(n) is not None}
    for name, exp in expected.items():
        if name in grads:
            assert_almost_equal(grads[name], exp, rtol=rtol,
                                atol=atol if atol is not None else 1e-20,
                                names=(f"grad_{name}", "expected"),
                                equal_nan=equal_nan)
    return grads


def check_consistency(sym, ctx_list, scale=1.0, dtype=None,
                      grad_req="write", arg_params=None, aux_params=None,
                      tol=None, raise_on_err=True, ground_truth=None,
                      equal_nan=False, use_uniform=False):
    """Run `sym` (or one symbol per configuration) on every configuration
    of `ctx_list` (``{"ctx": ..., name: shape, ..., "type_dict": {...}}``)
    from the same inputs — normal(0, `scale`) from numpy seeded 0, then
    `arg_params` and `aux_params` over them — and hold each one's outputs
    and gradients to the last configuration's, at the per-dtype
    tolerance of the less precise of the two (reference
    `test_utils.py:1204`).  Returns every configuration's outputs."""
    if tol is None:
        tol = {np.dtype(np.float16): 1e-1, np.dtype(np.float32): 1e-3,
               np.dtype(np.float64): 1e-5, np.dtype(np.uint8): 0,
               np.dtype(np.int32): 0, np.dtype(np.int64): 0}
    elif isinstance(tol, float):
        tol = {np.dtype(t): tol for t in (np.float16, np.float32, np.float64,
                                          np.uint8, np.int32, np.int64)}
    assert len(ctx_list) > 1
    sym_list = list(sym) if isinstance(sym, (list, tuple)) \
        else [sym] * len(ctx_list)
    arg_names = sym_list[0].list_arguments()
    np.random.seed(0)
    base_inputs = {}
    output_data, grad_datas = [], []
    for config, s in zip(ctx_list, sym_list):
        shapes = {k: v for k, v in config.items()
                  if k != "ctx" and not k.endswith("type_dict")}
        ex = s.simple_bind(ctx=config["ctx"], grad_req=grad_req,
                           type_dict=config.get("type_dict", {}), **shapes)
        for name in arg_names:
            if name not in base_inputs:
                base_inputs[name] = np.random.normal(
                    size=ex.arg_dict[name].shape, scale=scale)
            _write(ex.arg_dict[name], base_inputs[name])
        for k, v in (arg_params or {}).items():
            _write(ex.arg_dict[k], _np(v))
        for k, v in (aux_params or {}).items():
            _write(ex.aux_dict[k], _np(v))
        outs = ex.forward(is_train=grad_req != "null")
        if grad_req != "null":
            ex.backward()
            grad_datas.append({n: ex.grad_dict[n].asnumpy()
                               for n in arg_names
                               if ex.grad_dict.get(n) is not None})
        output_data.append([o.asnumpy() for o in outs])
    gt = len(output_data) - 1
    max_dtype = max((np.dtype(o.dtype) for o in output_data[gt]),
                    key=lambda d: d.itemsize)
    for i, outs in enumerate(output_data[:gt]):
        this_tol = max(tol.get(np.dtype(outs[0].dtype), 1e-3),
                       tol.get(max_dtype, 1e-5))
        for o, ref in zip(outs, output_data[gt]):
            assert_almost_equal(o.astype("float64"), ref.astype("float64"),
                                rtol=this_tol, atol=this_tol,
                                equal_nan=equal_nan)
    for i, grads in enumerate(grad_datas[:gt] if grad_datas else []):
        for name, g in grads.items():
            this_tol = max(tol.get(np.dtype(g.dtype), 1e-3),
                           tol.get(max_dtype, 1e-5))
            assert_almost_equal(g.astype("float64"),
                                grad_datas[gt][name].astype("float64"),
                                rtol=this_tol, atol=this_tol,
                                names=(f"grad_{name}_{i}", "ground_truth"),
                                equal_nan=equal_nan)
    return output_data


def get_mnist_like(num=1000, seed=0):
    """Synthetic MNIST-like dataset (deterministic) for training tests and
    the MNIST example without the downloaded files: 10 class prototypes
    plus noise, (num, 1, 28, 28) float32 images and float32 labels."""
    rng = np.random.RandomState(seed)
    protos = rng.rand(10, 1, 28, 28).astype("f4")
    labels = rng.randint(0, 10, num)
    imgs = protos[labels] + 0.1 * rng.rand(num, 1, 28, 28).astype("f4")
    return imgs.astype("f4"), labels.astype("f4")

