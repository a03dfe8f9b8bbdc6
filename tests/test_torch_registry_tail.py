"""The op registry's tail in the PyTorch port against the JAX package,
on the CPU: `ops/matrix.py`'s indexing, ordering and Sequence ops,
`nn.py`'s Deconvolution, InstanceNorm, L2Normalization, LRN,
SoftmaxActivation and UpSampling, `init_ops.py`, `linalg_ops.py`,
`ctc.py`, `contrib_ops.py`, `contrib_tail.py` and `random_ops.py`.

Each case runs the JAX op's `OpDef.fn(params, *arrays)` and the port's
on the same seeded numpy inputs, and the gradient of the inputs marked
differentiable through `jax.vjp` and torch autograd with one seeded
cotangent.  Tolerances by family:

* "exact": indexing, reshaping, ordering and creation ops: the forward
  bit for bit; their gradients (sums over repeated indices) at the
  arithmetic tolerance.
* "arith": rtol 1e-5 plus 1e-6 of the largest value (float32 sums in
  another order).
* "prod": products and decompositions (Deconvolution, linalg, the
  resizes, the interleaved matmuls, fft, khatri_rao, CTC): rtol 1e-4
  plus 1e-5 of the largest value.

`linalg_gelqf` and `linalg_syevd` are held by their products (L Q = A,
Q Qᵀ = I; U A Uᵀ = diag λ, U Uᵀ = I) and |u_i · u_ref_i| = 1: LAPACK and
XLA may choose other signs for Q's rows and the eigenvectors.  The
random ops agree with the JAX package in distribution only: their draws
are held to the distribution's mean and variance (5 sigma) and a KS
test, and a seed to the same draws.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu.ops import registry as jreg

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch.ops import registry as treg
from incubator_mxnet_tpu_torch.ops import ctc as tctc
from incubator_mxnet_tpu_torch.ops import nn as tnn

TOL = {"exact": None, "arith": (1e-5, 1e-6), "prod": (1e-4, 1e-5)}
QUANTIZATION = {"_contrib_dequantize", "_contrib_quantize",
                "_contrib_quantize_v2", "_contrib_quantized_conv",
                "_contrib_quantized_fully_connected",
                "_contrib_quantized_pooling", "_contrib_requantize",
                "dequantize", "quantize"}


def _close(got, want, tol, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if tol is None:
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    rtol, atol = tol
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol * max(np.abs(want).max(initial=0),
                                               1e-30), err_msg=what)


def _tuple(x):
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


def _pair(op, params, inputs, grad_idx=(), seed=0):
    """((outs, grads) port, (outs, grads) JAX) of `op` on numpy
    `inputs`; gradients of the inputs `grad_idx` under one random
    cotangent on the first output."""
    jop, top = jreg.get(op), treg.get(op)
    jp, tp = jop.canonicalize_params(params), top.canonicalize_params(params)
    for p in (jp, tp):
        p.pop("ctx", None)
        if jop.mode_dependent:
            p["_train"] = True
    if not inputs:
        jout = _tuple(jop.fn(jp))
        tout = _tuple(top.fn(tp, device=torch.device("cpu")))
        return ([t.numpy() for t in tout], []), \
            ([np.asarray(j) for j in jout], [])

    def jf(*diff):
        xs = [jnp.asarray(a) for a in inputs]
        for i, d in zip(grad_idx, diff):
            xs[i] = d
        return _tuple(jop.fn(jp, *xs))

    if grad_idx:
        jout, vjp = jax.vjp(jf, *(jnp.asarray(inputs[i]) for i in grad_idx))
    else:
        jout = jf()
    xs = [torch.from_numpy(np.array(a, copy=True)) for a in inputs]
    for i in grad_idx:
        xs[i].requires_grad_()
    tout = _tuple(top.fn(tp, *xs))
    jgrads, tgrads = [], []
    if grad_idx:
        ct = np.random.RandomState(seed + 100).normal(
            0, 1, jout[0].shape).astype(np.asarray(jout[0]).dtype)
        cts = (jnp.asarray(ct),) + tuple(jnp.zeros_like(o) for o in jout[1:])
        jgrads = [np.asarray(g) for g in vjp(cts)]
        tg = torch.autograd.grad(tout[0], [xs[i] for i in grad_idx],
                                 torch.from_numpy(ct), allow_unused=True)
        tgrads = [np.zeros(inputs[i].shape) if g is None else g.numpy()
                  for i, g in zip(grad_idx, tg)]
    return ([t.detach().numpy() for t in tout], tgrads), \
        ([np.asarray(j) for j in jout], jgrads)


def _check(op, params, inputs, family, grad_idx=(), seed=0):
    (tout, tg), (jout, jg) = _pair(op, params, inputs, grad_idx, seed)
    assert len(tout) == len(jout), op
    for k, (a, b) in enumerate(zip(tout, jout)):
        _close(a, b, TOL[family], f"{op} {params} output {k}")
    gtol = TOL["arith"] if family == "exact" else TOL[family]
    for i, a, b in zip(grad_idx, tg, jg):
        _close(a, b, gtol, f"{op} {params} grad of input {i}")


def _r(*shape, seed=0, dtype=np.float32):
    return np.random.RandomState(seed).normal(0, 1, shape).astype(dtype)


def _ties(*shape, seed=0):
    """Values on a coarse grid, so many of them tie."""
    return np.round(_r(*shape, seed=seed) * 2) / 2


def _spd(n, batch=2, seed=0):
    a = _r(batch, n, n, seed=seed, dtype=np.float64)
    return a @ a.transpose(0, 2, 1) + n * np.eye(n)


def _ints(vals):
    return np.asarray(vals, np.float32)


# -- coverage --------------------------------------------------------------------

def test_registry_covers_jax_package():
    """Every JAX op name, the 9 quantization ones included (345 of 345),
    is in the port's registry, with the same param table and arity."""
    jnames = set(jreg.list_ops())
    missing = sorted(jnames - set(treg.list_ops()))
    assert not missing, missing
    assert QUANTIZATION <= jnames
    assert QUANTIZATION <= set(treg.list_ops())
    for name in sorted(jnames):
        j, t = jreg.get(name), treg.get(name)
        assert j.nin == t.nin, name
        assert set(j.params) == set(t.params), name
        for k, v in j.params.items():
            if v is jreg.REQUIRED:
                assert t.params[k] is treg.REQUIRED, (name, k)
            else:
                assert t.params[k] == v, (name, k)
        assert j.needs_rng == t.needs_rng, name
        assert j.mode_dependent == t.mode_dependent, name
        assert j.num_outputs(j.params) == t.num_outputs(t.params) \
            if not callable(j.nout) else callable(t.nout), name


def test_training_api_covers_jax_package():
    """Every optimizer, metric and initializer class of the JAX package,
    and Monitor, AttrScope and the module family."""
    for reg, treg_ in ((jmx.optimizer.Optimizer.opt_registry,
                        tmx.optimizer.Optimizer.opt_registry),
                       (jmx.metric._METRIC_REGISTRY,
                        tmx.metric._METRIC_REGISTRY),
                       (jmx.initializer._INIT_REGISTRY,
                        tmx.initializer._INIT_REGISTRY)):
        assert set(reg) <= set(treg_), sorted(set(reg) - set(treg_))
    for name in ("Load", "Mixed"):
        assert hasattr(tmx.initializer, name)
    for name in ("SequentialModule", "PythonModule", "PythonLossModule"):
        assert hasattr(tmx.mod, name)
    assert tmx.Monitor and tmx.AttrScope
    for name in ("eye", "linspace", "moveaxis", "maximum", "minimum", "add",
                 "subtract", "multiply", "divide", "modulo", "power"):
        assert hasattr(tmx.nd, name), name
    for ns in ("random", "linalg"):
        jns, tns = getattr(jmx.nd, ns), getattr(tmx.nd, ns)
        for name in dir(jns):
            if not name.startswith("_") and callable(getattr(jns, name)) \
                    and name not in ("NDArray", "invoke", "annotations"):
                assert hasattr(tns, name), (ns, name)
        assert hasattr(tmx.sym, ns)


# -- matrix ----------------------------------------------------------------------

X456 = _r(4, 5, 6)

MATRIX = [
    ("slice", {"begin": (1, None, 0), "end": (3, None, 6),
               "step": (1, None, 2)}, [X456], (0,)),
    ("slice", {"begin": (3,), "end": (0,), "step": (-1,)}, [X456], (0,)),
    ("crop", {"begin": (0, 1), "end": (2, 4)}, [X456], (0,)),
    ("slice_like", {"axes": (0, 1)}, [X456, _r(2, 3, 6)], (0,)),
    ("slice_like", {}, [X456, _r(3, 2, 4)], (0,)),
    ("reverse", {"axis": 1}, [X456], (0,)),
    ("flip", {"axis": (0, 2)}, [X456], (0,)),
    ("tile", {"reps": (2, 1, 3)}, [_r(2, 3)], (0,)),
    ("repeat", {"repeats": 2, "axis": 1}, [_r(2, 3)], (0,)),
    ("repeat", {"repeats": 3}, [_r(2, 3)], (0,)),
    ("Pad", {"mode": "constant", "pad_width": (0, 0, 0, 0, 1, 2, 2, 1),
             "constant_value": 0.5}, [_r(2, 3, 4, 5)], (0,)),
    ("pad", {"mode": "edge", "pad_width": (0, 0, 0, 0, 2, 1, 1, 3)},
     [_r(2, 3, 4, 5)], (0,)),
    ("Pad", {"mode": "reflect", "pad_width": (0, 0, 0, 0, 1, 2, 3, 1)},
     [_r(2, 3, 4, 5)], (0,)),
    ("take", {}, [_r(6, 4), _ints([[0, 5], [7, -1]])], (0,)),
    ("take", {"mode": "wrap", "axis": 1}, [_r(3, 4), _ints([1, 5, -2, 3])],
     (0,)),
    ("batch_take", {}, [_r(4, 5), _ints([0, 4, 2, 9])], (0,)),
    ("one_hot", {"depth": 5, "on_value": 2.0, "off_value": -1.0},
     [_ints([[0, 3], [-1, 5], [4, 4]])], ()),
    ("gather_nd", {}, [_r(4, 5, 3), _ints([[0, 3, 1, 3], [4, 0, 2, 4]])],
     (0,)),
    ("scatter_nd", {"shape": (4, 5)}, [_r(3), _ints([[0, 3, 1], [4, 0, 2]])],
     (0,)),
    ("topk", {"k": 3, "ret_typ": "both"}, [_ties(4, 8)], (0,)),
    ("topk", {"k": 2, "ret_typ": "mask", "axis": 0}, [_ties(5, 3)], ()),
    ("topk", {"k": 4, "ret_typ": "value", "is_ascend": True}, [_ties(3, 9)],
     (0,)),
    ("topk", {"k": 2, "axis": 0, "dtype": "int32"}, [_ties(6, 3)], ()),
    ("sort", {}, [_ties(4, 7)], (0,)),
    ("sort", {"axis": 0, "is_ascend": False}, [_ties(6, 3)], (0,)),
    ("argsort", {}, [_ties(4, 7)], ()),
    ("argsort", {"axis": 0, "is_ascend": False}, [_ties(6, 3)], ()),
    ("shape_array", {}, [X456], ()),
    ("size_array", {}, [X456], ()),
    ("diag", {"k": 1}, [_r(4, 5)], (0,)),
    ("diag", {"k": -1}, [_r(4)], (0,)),
    ("diag", {"k": 0, "axis1": 1, "axis2": 2}, [_r(2, 3, 4)], (0,)),
    ("depth_to_space", {"block_size": 2}, [_r(1, 8, 2, 3)], (0,)),
    ("space_to_depth", {"block_size": 2}, [_r(1, 2, 4, 6)], (0,)),
    ("SequenceLast", {}, [_r(5, 3, 2)], (0,)),
    ("SequenceLast", {"use_sequence_length": True},
     [_r(5, 3, 2), _ints([2, 5, 1])], (0,)),
    ("SequenceLast", {"use_sequence_length": True, "axis": 1},
     [_r(3, 5, 2), _ints([4, 1, 5])], (0,)),
    ("SequenceMask", {"use_sequence_length": True, "value": -2.0},
     [_r(5, 3, 2), _ints([2, 5, 0])], (0,)),
    ("SequenceMask", {"use_sequence_length": True, "axis": 1},
     [_r(3, 5, 2), _ints([4, 1, 3])], (0,)),
    ("SequenceMask", {}, [_r(4, 2)], (0,)),
    ("SequenceReverse", {}, [_r(5, 3, 2)], (0,)),
    ("SequenceReverse", {"use_sequence_length": True},
     [_r(5, 3, 2), _ints([2, 5, 3])], (0,)),
]


@pytest.mark.parametrize("op,params,inputs,grad_idx", MATRIX,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(MATRIX)])
def test_matrix_op(op, params, inputs, grad_idx):
    _check(op, params, inputs, "exact", grad_idx)


# -- nn ----------------------------------------------------------------------------

def _deconv_case(shape, wshape, **params):
    params.setdefault("no_bias", False)
    inputs = [_r(*shape), 0.3 * _r(*wshape, seed=1)]
    if not params["no_bias"]:
        inputs.append(_r(params["num_filter"], seed=2))
    return params, inputs


DECONV = [
    _deconv_case((2, 4, 5, 5), (4, 3, 4, 4), kernel=(4, 4), stride=(2, 2),
                 pad=(1, 1), num_filter=3),
    _deconv_case((1, 4, 4, 6), (4, 2, 3, 3), kernel=(3, 3), stride=(2, 2),
                 pad=(1, 1), adj=(1, 1), num_filter=4, num_group=2,
                 no_bias=True),
    _deconv_case((2, 3, 4, 4), (3, 2, 3, 3), kernel=(3, 3), stride=(2, 2),
                 pad=(1, 1), target_shape=(8, 8), num_filter=2),
    _deconv_case((2, 2, 5, 5), (2, 3, 3, 3), kernel=(3, 3), dilate=(2, 2),
                 num_filter=3),
    _deconv_case((2, 3, 7), (3, 2, 3), kernel=(3,), stride=(2,),
                 num_filter=2),
]


@pytest.mark.parametrize("params,inputs", DECONV)
def test_deconvolution(params, inputs):
    """The library route against the JAX op, and the plain version
    (`deconv_plain`) against the route."""
    _check("Deconvolution", params, inputs, "prod",
           tuple(range(len(inputs))))
    p = treg.get("Deconvolution").canonicalize_params(params)
    xs = [torch.from_numpy(a) for a in inputs]
    plain = tnn.deconv_plain(p, xs[0], xs[1], None if p["no_bias"]
                             else xs[2])
    lib = treg.get("Deconvolution").fn(p, *xs)
    _close(plain.numpy(), lib.numpy(), TOL["prod"], "deconv_plain")


NN = [
    ("InstanceNorm", {"eps": 1e-3}, [_r(2, 3, 4, 5), _r(3, seed=1),
                                     _r(3, seed=2)], (0, 1, 2)),
    ("L2Normalization", {}, [_r(2, 3, 4)], (0,)),
    ("L2Normalization", {"mode": "channel"}, [_r(2, 3, 4, 4)], (0,)),
    ("L2Normalization", {"mode": "spatial"}, [_r(2, 3, 4, 4)], (0,)),
    ("LRN", {"nsize": 5}, [_r(2, 7, 4, 4)], (0,)),
    ("LRN", {"nsize": 3, "alpha": 1e-2, "beta": 0.5, "knorm": 1.0},
     [_r(2, 4, 3, 3)], (0,)),
    ("SoftmaxActivation", {}, [_r(3, 4, 2)], (0,)),
    ("SoftmaxActivation", {"mode": "channel"}, [_r(2, 5, 3)], (0,)),
    ("UpSampling", {"scale": 2, "sample_type": "nearest"}, [_r(2, 3, 4, 5)],
     (0,)),
    ("UpSampling", {"scale": 3, "sample_type": "nearest", "num_args": 2,
                    "multi_input_mode": "sum"},
     [_r(1, 2, 3, 3), _r(1, 2, 3, 3, seed=1)], (0, 1)),
    ("UpSampling", {"scale": 2, "sample_type": "nearest", "num_args": 2},
     [_r(1, 2, 3, 3), _r(1, 1, 3, 3, seed=1)], (0, 1)),
]


@pytest.mark.parametrize("op,params,inputs,grad_idx", NN,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(NN)])
def test_nn_op(op, params, inputs, grad_idx):
    _check(op, params, inputs, "arith", grad_idx)


@pytest.mark.parametrize("shape,scale", [((2, 3, 4, 5), 2), ((1, 2, 3, 3), 3),
                                         ((1, 1, 1, 4), 2)])
def test_upsampling_bilinear_edges(shape, scale):
    """The JAX op's `jax.image.resize` math, the image edges included:
    the first and last output rows and columns equal the JAX ones."""
    inputs = [_r(*shape)]
    params = {"scale": scale, "sample_type": "bilinear"}
    _check("UpSampling", params, inputs, "prod", (0,))
    (tout, _), (jout, _) = _pair("UpSampling", params, inputs)
    for sl in (np.s_[..., 0, :], np.s_[..., -1, :], np.s_[..., :, 0],
               np.s_[..., :, -1]):
        _close(tout[0][sl], jout[0][sl], TOL["prod"], f"edge {sl}")


# -- init ops and nd helpers ------------------------------------------------------

INIT = [
    ("_arange", {"start": 1.0, "stop": 7.0, "step": 1.5, "repeat": 2}),
    ("_arange", {"start": 5.0, "dtype": "int32"}),
    ("_eye", {"N": 4, "M": 5, "k": 1}),
    ("_eye", {"N": 3, "k": -1, "dtype": "float64"}),
    ("_linspace", {"start": 0.0, "stop": 1.0, "num": 7}),
    ("_linspace", {"start": -2.0, "stop": 3.0, "num": 6,
                   "endpoint": False}),
]


@pytest.mark.parametrize("op,params", INIT)
def test_init_op(op, params):
    _check(op, params, [], "arith")


def test_nd_helpers_match_jax():
    a = _r(3, 4)
    b = _r(3, 4, seed=1) + 3.0
    t, j = tmx.nd.array(a, ctx=tmx.cpu()), jmx.nd.array(a)
    tb, jb = tmx.nd.array(b, ctx=tmx.cpu()), jmx.nd.array(b)
    for name in ("maximum", "minimum", "add", "subtract", "multiply",
                 "divide", "modulo", "power"):
        for args_t, args_j in (((t, tb), (j, jb)), ((t, 2.0), (j, 2.0)),
                               ((2.0, tb), (2.0, jb))):
            if name == "power":
                args_t = tuple(abs(x) if isinstance(x, tmx.nd.NDArray)
                               else x for x in args_t)
                args_j = tuple(abs(x) if isinstance(x, jmx.nd.NDArray)
                               else x for x in args_j)
            got = getattr(tmx.nd, name)(*args_t).asnumpy()
            want = getattr(jmx.nd, name)(*args_j).asnumpy()
            _close(got, want, TOL["arith"], name)
    _close(tmx.nd.moveaxis(tmx.nd.array(_r(2, 3, 4), ctx=tmx.cpu()), 0,
                           -1).asnumpy(),
           jmx.nd.moveaxis(jmx.nd.array(_r(2, 3, 4)), 0, -1).asnumpy(),
           None, "moveaxis")
    _close(tmx.nd.eye(3, 4, 1, ctx=tmx.cpu()).asnumpy(),
           jmx.nd.eye(3, 4, 1).asnumpy(), None, "eye")
    _close(tmx.nd.linspace(0, 2, 5, ctx=tmx.cpu()).asnumpy(),
           jmx.nd.linspace(0, 2, 5).asnumpy(), TOL["arith"], "linspace")


# -- linalg ------------------------------------------------------------------------

def _lower(n, batch=2, seed=0):
    return np.linalg.cholesky(_spd(n, batch, seed))


LINALG = [
    ("linalg_gemm", {"transpose_a": True, "alpha": 0.5, "beta": 2.0},
     [_r(2, 4, 3, dtype=np.float64), _r(2, 4, 5, seed=1, dtype=np.float64),
      _r(2, 3, 5, seed=2, dtype=np.float64)], (0, 1, 2)),
    ("linalg_gemm2", {"transpose_b": True, "alpha": 1.5},
     [_r(2, 3, 4, dtype=np.float64), _r(2, 5, 4, seed=1, dtype=np.float64)],
     (0, 1)),
    ("linalg_potrf", {}, [_spd(4)], (0,)),
    ("linalg_potri", {}, [_lower(4)], (0,)),
    ("linalg_trmm", {"alpha": 2.0}, [_lower(3), _r(2, 3, 4,
                                                   dtype=np.float64)],
     (0, 1)),
    ("linalg_trmm", {"transpose": True, "rightside": True, "lower": False},
     [_lower(3).transpose(0, 2, 1), _r(2, 4, 3, dtype=np.float64)], (0, 1)),
    ("linalg_syrk", {"alpha": 0.5}, [_r(2, 3, 4, dtype=np.float64)], (0,)),
    ("linalg_syrk", {"transpose": True}, [_r(2, 3, 4, dtype=np.float64)],
     (0,)),
    ("linalg_sumlogdiag", {}, [_lower(4)], (0,)),
    ("linalg_extractdiag", {"offset": 1}, [_r(2, 4, 4, dtype=np.float64)],
     (0,)),
    ("linalg_makediag", {"offset": -1}, [_r(2, 3, dtype=np.float64)], (0,)),
    ("linalg_extracttrian", {}, [_r(2, 4, 4, dtype=np.float64)], (0,)),
    ("linalg_extracttrian", {"offset": 1, "lower": False},
     [_r(2, 4, 4, dtype=np.float64)], (0,)),
    ("linalg_extracttrian", {"offset": -1}, [_r(4, 4, dtype=np.float64)],
     (0,)),
    ("linalg_inverse", {}, [_spd(4)], (0,)),
    ("linalg_det", {}, [_spd(3)], (0,)),
    ("linalg_slogdet", {}, [_r(2, 4, 4, dtype=np.float64)], (0,)),
] + [("linalg_trsm", {"transpose": t, "rightside": r, "lower": lo,
                      "alpha": 1.5},
      [_lower(3) if lo else _lower(3).transpose(0, 2, 1),
       _r(2, 4, 3, dtype=np.float64) if r else _r(2, 3, 4,
                                                  dtype=np.float64)],
      (0, 1))
     for t in (False, True) for r in (False, True) for lo in (True, False)]


@pytest.mark.parametrize("op,params,inputs,grad_idx", LINALG,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(LINALG)])
def test_linalg_op(op, params, inputs, grad_idx):
    _check(op, params, inputs, "prod", grad_idx)


def test_linalg_gelqf_syevd_signs():
    """Held by their products, and each row against the JAX one up to
    its sign (LAPACK and XLA may pick either)."""
    a = _r(2, 3, 5, dtype=np.float64)
    (tout, _), (jout, _) = _pair("linalg_gelqf", {}, [a])
    low, q = tout
    _close(low @ q, a, TOL["prod"], "L Q = A")
    _close(q @ q.transpose(0, 2, 1), np.broadcast_to(np.eye(3), (2, 3, 3)),
           TOL["prod"], "Q Qt = I")
    _close(np.abs((q * jout[1]).sum(-1)), np.ones((2, 3)), TOL["prod"],
           "|q_i . q_ref_i|")
    _close(np.abs(low), np.abs(jout[0]), TOL["prod"], "|L|")
    s = _spd(4)
    (tout, _), (jout, _) = _pair("linalg_syevd", {}, [s])
    u, lam = tout
    _close(lam, jout[1], TOL["prod"], "eigenvalues")
    _close(u @ s @ u.transpose(0, 2, 1),
           np.stack([np.diag(v) for v in lam]), TOL["prod"], "U A Ut")
    _close(np.abs((u * jout[0]).sum(-1)), np.ones((2, 4)), TOL["prod"],
           "|u_i . u_ref_i|")


# -- contrib ---------------------------------------------------------------------

QKV = _r(5, 2, 2 * 3 * 4)

CONTRIB = [
    ("_contrib_quadratic", {"a": 0.5, "b": -1.0, "c": 2.0}, [_r(3, 4)],
     (0,), "arith"),
    ("quadratic", {"a": 1.0}, [_r(5)], (0,), "arith"),
    ("_contrib_arange_like", {"start": 1.0, "step": 0.5, "repeat": 2},
     [_r(3, 5)], (), "arith"),
    ("_contrib_arange_like", {"axis": 1, "start": 2.0}, [_r(3, 5)], (),
     "arith"),
    ("_contrib_AdaptiveAvgPooling2D", {"output_size": (2, 3)},
     [_r(2, 3, 4, 6)], (0,), "arith"),
    ("_contrib_AdaptiveAvgPooling2D", {"output_size": 3}, [_r(1, 2, 5, 7)],
     (0,), "prod"),
    ("_contrib_BilinearResize2D", {"height": 7, "width": 9},
     [_r(2, 3, 4, 5)], (0,), "prod"),
    ("_contrib_BilinearResize2D", {"height": 3, "width": 4},
     [_r(1, 2, 7, 9)], (0,), "prod"),
    ("_contrib_BilinearResize2D", {"scale_height": 1.5, "scale_width": 0.5},
     [_r(1, 2, 4, 6)], (0,), "prod"),
    ("_contrib_div_sqrt_dim", {}, [_r(3, 16)], (0,), "arith"),
    ("_contrib_interleaved_matmul_selfatt_qk", {"heads": 2}, [QKV], (0,),
     "prod"),
    ("_contrib_interleaved_matmul_selfatt_valatt", {"heads": 2},
     [QKV, _r(4, 5, 5, seed=1)], (0, 1), "prod"),
    ("_contrib_boolean_mask_supported", {}, [], (), "exact"),
    ("_contrib_index_copy", {}, [_r(5, 3), _ints([4, 0]), _r(2, 3, seed=1)],
     (0, 2), "exact"),
    ("_contrib_index_array", {}, [_r(2, 3)], (), "exact"),
    ("_contrib_index_array", {"axes": (1,)}, [_r(2, 3, 4)], (), "exact"),
    ("_contrib_getnnz", {}, [np.where(_r(4, 5) > 0, _r(4, 5), 0)], (),
     "exact"),
    ("_contrib_getnnz", {"axis": 0}, [np.where(_r(4, 5) > 0, 1.0, 0)], (),
     "exact"),
    ("fft", {}, [_r(3, 8)], (0,), "prod"),
    ("_contrib_ifft", {}, [_r(2, 3, 10)], (0,), "prod"),
    ("_contrib_count_sketch", {"out_dim": 5},
     [_r(3, 8), _ints([0, 4, 2, 2, 1, 4, 0, 3]),
      _ints([1, -1, 1, 1, -1, 1, -1, 1])], (0,), "arith"),
    ("khatri_rao", {"num_args": 3}, [_r(2, 4), _r(3, 4, seed=1),
                                     _r(2, 4, seed=2)], (0, 1, 2), "prod"),
    ("_ravel_multi_index", {"shape": (3, 4, 5)},
     [_ints([[0, 2, 1], [3, 0, 2], [4, 1, 0]])], (), "exact"),
    ("unravel_index", {"shape": (3, 4, 5)}, [_ints([0, 59, 17, 33])], (),
     "exact"),
    ("_square_sum", {}, [_r(3, 4)], (0,), "arith"),
    ("_square_sum", {"axis": 1, "keepdims": True}, [_r(3, 4, 2)], (0,),
     "arith"),
    ("_square_sum", {"axis": 1, "exclude": True}, [_r(3, 4, 2)], (0,),
     "arith"),
    ("cast_storage", {"stype": "row_sparse"}, [_r(3, 4)], (0,), "exact"),
    ("sparse_retain", {}, [_r(5, 3), _ints([3, 0])], (0,), "exact"),
    ("SyncBatchNorm", {"fix_gamma": False, "momentum": 0.8},
     [_r(4, 3, 2, 2), _r(3, seed=1), _r(3, seed=2), _r(3, seed=3),
      np.abs(_r(3, seed=4)) + 0.5], (0, 1, 2), "arith"),
    ("_contrib_SyncBatchNorm", {"output_mean_var": True, "ndev": 2,
                                "key": "bn"},
     [_r(4, 3, 2), np.ones(3, np.float32), np.zeros(3, np.float32),
      np.zeros(3, np.float32), np.ones(3, np.float32)], (0,), "arith"),
]


@pytest.mark.parametrize("op,params,inputs,grad_idx,family", CONTRIB,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CONTRIB)])
def test_contrib_op(op, params, inputs, grad_idx, family):
    _check(op, params, inputs, family, grad_idx)


def test_histogram():
    """Counts equal outside values within 1e-6 of a bin edge (none in
    this draw: counted, required 0); edges at the arithmetic
    tolerance; explicit edges too."""
    x = _r(2000)
    for params, inputs in (({"bin_cnt": 10, "range": (-2.0, 2.0)}, [x]),
                           ({"num_args": 2},
                            [x, _ints([-3.0, -1.0, 0.0, 0.5, 2.0])])):
        (tout, _), (jout, _) = _pair("_histogram", params, inputs)
        near = np.abs(x[:, None] - jout[1][None, :]).min() < 1e-6
        assert not near
        _close(tout[0], jout[0], None, "counts")
        _close(tout[1], jout[1], TOL["arith"], "edges")


# -- CTC ---------------------------------------------------------------------------

def _ctc_inputs(T=12, N=4, C=5, L=4, seed=0):
    data = _r(T, N, C, seed=seed)
    label = _ints([[1, 2, 2, 0], [3, 0, 0, 0], [4, 1, 3, 2],
                   [2, 2, 2, 2]][:N])
    return data, label


@pytest.mark.parametrize("params,extra", [
    ({}, []),
    ({"use_data_lengths": True}, [_ints([12, 7, 9, 5])]),
    ({"use_label_lengths": True, "blank_label": "last"},
     [_ints([2, 1, 4, 3])]),
])
def test_ctc_loss(params, extra):
    """The JAX op's loss and gradient; the last row of the second case
    cannot fit its 4 repeated labels in 5 steps, and both give the
    same finite loss."""
    data, label = _ctc_inputs()
    _check("ctc_loss", params, [data, label] + extra, "prod", (0,))
    (tout, _), _ = _pair("ctc_loss", params, [data, label] + extra)
    assert np.isfinite(tout[0]).all()


def test_ctc_plain_against_library_route():
    """`ctc_plain` against `F.ctc_loss` on the rows the card route gives
    the library (no CUDA needed: the comparison is of the functions)."""
    data, label = _ctc_inputs(T=20, N=4)
    logp = torch.log_softmax(torch.from_numpy(data).double(), -1)
    lab = torch.from_numpy(label).long()
    in_len = torch.tensor([20, 15, 18, 20])
    lab_len = (lab > 0).sum(1)
    plain = tctc.ctc_plain(logp, lab, in_len, lab_len)
    lib, held = tctc._library_rows(logp, lab, in_len, lab_len)
    assert held.all()
    _close(plain.numpy(), lib.numpy(), TOL["prod"], "ctc routes")
    short = torch.tensor([20, 15, 18, 6])      # 4 twos need 7 steps
    _, held = tctc._library_rows(logp, lab, short, lab_len)
    assert held.tolist() == [True, True, True, False]


# -- random ------------------------------------------------------------------------

N_DRAWS = 40000


def _moments(x, mean, var, what):
    x = np.asarray(x, np.float64).ravel()
    n = x.size
    assert abs(x.mean() - mean) < 5 * np.sqrt(var / n), (what, x.mean())
    # the variance of the sample variance, bounded by the 4th moment
    m4 = ((x - x.mean()) ** 4).mean()
    assert abs(x.var() - var) < 5 * np.sqrt(max(m4 - var ** 2, 1e-12) / n), \
        (what, x.var())


RANDOM = [
    ("uniform", dict(low=-1.0, high=3.0), 1.0, 16 / 12, "uniform",
     (-1.0, 4.0)),
    ("normal", dict(loc=2.0, scale=0.5), 2.0, 0.25, "norm", (2.0, 0.5)),
    ("gamma", dict(alpha=2.5, beta=1.5), 3.75, 2.5 * 2.25, "gamma",
     (2.5, 0, 1.5)),
    ("exponential", dict(lam=2.0), 0.5, 0.25, "expon", (0, 0.5)),
    ("poisson", dict(lam=3.0), 3.0, 3.0, None, None),
    ("negative_binomial", dict(k=3, p=0.4), 4.5, 4.5 / 0.4, None, None),
    ("generalized_negative_binomial", dict(mu=2.0, alpha=0.5), 2.0, 4.0,
     None, None),
    ("randint", dict(low=-3, high=5), 0.5, (64 - 1) / 12, None, None),
]


@pytest.mark.parametrize("name,kw,mean,var,dist,args", RANDOM,
                         ids=[c[0] for c in RANDOM])
def test_random_moments(name, kw, mean, var, dist, args):
    """The port's draws against the distribution (mean and variance
    within 5 sigma, a KS test for the continuous ones), the same seed
    the same draws, and the JAX op's shape and dtype."""
    from scipy import stats
    tmx.random.seed(11)
    got = getattr(tmx.nd.random, name)(shape=(N_DRAWS,), ctx=tmx.cpu(),
                                       **kw)
    tmx.random.seed(11)
    again = getattr(tmx.nd.random, name)(shape=(N_DRAWS,), ctx=tmx.cpu(),
                                         **kw)
    np.testing.assert_array_equal(got.asnumpy(), again.asnumpy())
    ref = getattr(jmx.nd.random, name)(shape=(7,), **kw)
    assert got.dtype == ref.dtype
    _moments(got.asnumpy(), mean, var, name)
    if dist is not None:
        cdf = getattr(stats, dist)(*args).cdf
        assert stats.kstest(got.asnumpy().astype(np.float64),
                            cdf).pvalue > 1e-4


def test_random_sample_ops_and_shuffle():
    """_sample_* draw `shape` per parameter element (the JAX ops'
    output shapes), multinomial follows its probabilities, shuffle
    permutes the first axis."""
    mu = tmx.nd.array([0.0, 10.0], ctx=tmx.cpu())
    sigma = tmx.nd.array([1.0, 0.1], ctx=tmx.cpu())
    out = tmx.nd.random.normal(mu, sigma, shape=(5000,))
    ref = jmx.nd.random.normal(jmx.nd.array([0.0, 10.0]),
                               jmx.nd.array([1.0, 0.1]), shape=(3,))
    assert out.shape == (2, 5000) and ref.shape == (2, 3)
    _moments(out.asnumpy()[1], 10.0, 0.01, "sample_normal")
    u = tmx.nd.random.uniform(tmx.nd.array([0.0, 2.0], ctx=tmx.cpu()),
                              tmx.nd.array([1.0, 6.0], ctx=tmx.cpu()),
                              shape=(5000,))
    _moments(u.asnumpy()[1], 4.0, 16 / 12, "sample_uniform")
    g = tmx.nd.random.gamma(tmx.nd.array([2.0], ctx=tmx.cpu()),
                            tmx.nd.array([3.0], ctx=tmx.cpu()),
                            shape=(5000,))
    _moments(g.asnumpy(), 6.0, 18.0, "sample_gamma")
    probs = np.array([[0.1, 0.6, 0.3], [0.5, 0.0, 0.5]], np.float32)
    s, lp = tmx.nd.random.multinomial(tmx.nd.array(probs, ctx=tmx.cpu()),
                                      shape=(4000,), get_prob=True)
    js = jmx.nd.random.multinomial(jmx.nd.array(probs), shape=(4,),
                                   get_prob=True)
    assert s.shape == (2, 4000) and js[0].shape == (2, 4)
    s = s.asnumpy()
    for row in range(2):
        freq = np.bincount(s[row], minlength=3) / 4000
        assert np.abs(freq - probs[row]).max() < 5 * np.sqrt(0.25 / 4000)
    np.testing.assert_allclose(lp.asnumpy(), np.log(np.maximum(
        probs[np.arange(2)[:, None], s], 1e-37)), rtol=1e-6)
    x = np.arange(50, dtype=np.float32).reshape(25, 2)
    sh = tmx.nd.random.shuffle(tmx.nd.array(x, ctx=tmx.cpu())).asnumpy()
    assert sorted(sh[:, 0].tolist()) == x[:, 0].tolist()
    np.testing.assert_array_equal(sh[:, 1], sh[:, 0] + 1)


def test_random_ops_in_a_graph():
    """The symbolic face: a graph of random ops binds, infers its shape
    and draws; `sym.random` builds the ops the JAX package's does."""
    z = tmx.sym.random.normal(loc=1.0, scale=2.0, shape=(3, 4))
    assert z.infer_shape()[1] == [(3, 4)]
    exe = z.simple_bind(ctx=tmx.cpu())
    out = exe.forward()[0].asnumpy()
    assert out.shape == (3, 4) and np.isfinite(out).all()
    jz = jmx.sym.random.normal(loc=1.0, scale=2.0, shape=(3, 4))
    assert [n["op"] for n in __import__("json").loads(z.tojson())["nodes"]] \
        == [n["op"] for n in __import__("json").loads(jz.tojson())["nodes"]]
