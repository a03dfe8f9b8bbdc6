"""Training the transformer LM in the PyTorch port against the JAX package
on the CPU: the backward of every op `lm_symbol` uses, the whole
graph's gradients, and 10 `Module.fit` steps, at `tests/test_llm.py`'s
`_cfg()` size (vocab 40, 2 layers, 2 heads, hidden 16).

Each op's gradient is held to `jax.vjp` of the JAX op on the same inputs
and cotangent from a numpy seed, in float64 (rtol 1e-9 + 1e-9 * max|ref|)
and in float32 (rtol 1e-4 + 1e-5 * max|ref|); `SoftmaxOutput`'s gradient
is its own (softmax minus one-hot) and ignores the cotangent in both,
and its softmax runs in float32 for any input dtype.
The graph and the fit are float32: each package composes the symbol
(under the same names), both initialised by
`Xavier` under one `random.seed` (bitwise the same parameters), and the
JAX side runs its per-batch path (``MXNET_FUSED_TRAIN_STEP=0``) while
the port runs its fused step.
"""
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import llm as jllm
from incubator_mxnet_tpu.ops import registry as jreg

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import llm as tllm
from incubator_mxnet_tpu_torch.ops import registry as treg

TOL = {np.float64: (1e-9, 1e-9), np.float32: (1e-4, 1e-5)}
CPU = tmx.cpu()
V, T, B, C = 40, 12, 4, 16


def _close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    rtol, atol = tol
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _vjp_both(fn_j, fn_t, inputs, diff, dtype, seed=0):
    """Outputs and gradients (wrt the inputs at `diff`) of `fn_j` under
    `jax.vjp` and `fn_t` under torch autograd, one cotangent."""
    def jf(*d):
        xs = [jnp.asarray(a) for a in inputs]
        for i, v in zip(diff, d):
            xs[i] = v
        return fn_j(*xs)

    jout, vjp = jax.vjp(jf, *(jnp.asarray(inputs[i]) for i in diff))
    ct = np.random.RandomState(seed + 100).normal(
        0, 1, jout.shape).astype(dtype)
    jgrads = vjp(jnp.asarray(ct))
    xs = [torch.from_numpy(a.copy()) for a in inputs]
    for i in diff:
        xs[i].requires_grad_()
    tout = fn_t(*xs)
    tgrads = torch.autograd.grad(tout, [xs[i] for i in diff],
                                 torch.from_numpy(ct))
    return ((tout.detach().numpy(), [g.numpy() for g in tgrads]),
            (np.asarray(jout), [np.asarray(g) for g in jgrads]))


def _check_op(op, params, inputs, diff, dtype):
    jop, top = jreg.get(op), treg.get(op)
    jp, tp = jop.canonicalize_params(params), top.canonicalize_params(params)
    (tout, tg), (jout, jg) = _vjp_both(
        lambda *x: jop.fn(jp, *x), lambda *x: top.fn(tp, *x), inputs, diff,
        dtype)
    tol = TOL[dtype]
    assert tout.shape == jout.shape and tout.dtype == jout.dtype
    _close(tout, jout, tol, f"{op} forward")
    for i, a, b in zip(diff, tg, jg):
        assert a.shape == b.shape
        _close(a, b, tol, f"{op} grad of input {i}")


def _rand(*shape, dtype=np.float32, seed=0, scale=1.0):
    return (scale * np.random.RandomState(seed).normal(0, 1, shape)
            ).astype(dtype)


def _tokens(seed=0):
    return np.random.RandomState(seed).randint(0, V, (B, T)).astype(
        np.float32)


DTYPES = pytest.mark.parametrize("dtype", [np.float64, np.float32],
                                 ids=["float64", "float32"])


@DTYPES
def test_embedding_gradient(dtype):
    """The lookup's gradient is the scatter-add of the cotangent rows."""
    _check_op("Embedding", {"input_dim": V, "output_dim": C},
              [_tokens(), _rand(V, C, dtype=dtype)], [1], dtype)


@DTYPES
def test_tied_embedding_gradient(dtype):
    """`embed_weight` feeds the lookup and the head (`llm/model.py`): its
    gradient is the sum of the lookup's scatter and the head's product."""
    def build(reg):
        emb, fc = reg.get("Embedding"), reg.get("FullyConnected")
        pe = emb.canonicalize_params({"input_dim": V, "output_dim": C})
        pf = fc.canonicalize_params({"num_hidden": V, "no_bias": True,
                                     "flatten": False})
        return lambda tok, w: fc.fn(pf, emb.fn(pe, tok, w), w)
    (tout, tg), (jout, jg) = _vjp_both(
        build(jreg), build(treg), [_tokens(), _rand(V, C, dtype=dtype)],
        [1], dtype)
    tol = TOL[dtype]
    _close(tout, jout, tol, "tied forward")
    _close(tg[0], jg[0], tol, "tied embed_weight gradient")


@DTYPES
def test_layer_norm_gradient(dtype):
    _check_op("LayerNorm", {}, [_rand(B, T, C, dtype=dtype),
                                _rand(C, dtype=dtype, seed=1, scale=0.3) + 1,
                                _rand(C, dtype=dtype, seed=2, scale=0.3)],
              [0, 1, 2], dtype)


@DTYPES
@pytest.mark.parametrize("begin,end", [(0, C), (C, 2 * C), (2 * C, 3 * C)])
def test_slice_axis_gradient(dtype, begin, end):
    _check_op("slice_axis", {"axis": -1, "begin": begin, "end": end},
              [_rand(B, T, 3 * C, dtype=dtype)], [0], dtype)


@DTYPES
@pytest.mark.parametrize("block_size", [None, 4, 5])
def test_blockwise_attention_gradient(dtype, block_size):
    """One block of T (`block_size=None`), and blocks smaller than T
    (5 does not divide 12)."""
    params = {"num_heads": 2, "causal": True, "block_size": block_size}
    _check_op("BlockwiseAttention", params,
              [_rand(B, T, C, dtype=dtype, seed=s) for s in range(3)],
              [0, 1, 2], dtype)


@DTYPES
def test_gelu_gradient(dtype):
    """`LeakyReLU(act_type="gelu")`, the exact erf form."""
    _check_op("LeakyReLU", {"act_type": "gelu"},
              [_rand(B, T, 4 * C, dtype=dtype)], [0], dtype)


@DTYPES
def test_fully_connected_flatten_false_gradient(dtype):
    _check_op("FullyConnected", {"num_hidden": 3 * C, "flatten": False},
              [_rand(B, T, C, dtype=dtype), _rand(3 * C, C, dtype=dtype,
                                                  seed=1),
               _rand(3 * C, dtype=dtype, seed=2)], [0, 1, 2], dtype)
    _check_op("FullyConnected", {"num_hidden": V, "flatten": False,
                                 "no_bias": True},
              [_rand(B, T, C, dtype=dtype), _rand(V, C, dtype=dtype,
                                                  seed=1)], [0, 1], dtype)


@DTYPES
def test_reshape_gradient(dtype):
    _check_op("Reshape", {"shape": (-1, V)}, [_rand(B, T, V, dtype=dtype)],
              [0], dtype)


@DTYPES
def test_softmax_output_over_flattened_tokens(dtype):
    """`SoftmaxOutput` over (B*T, V) logits with the (B, T) label
    reshaped to (B*T,): softmax forward, (softmax - one-hot) backward.
    Both packages compute the softmax in float32 for any input dtype
    (the JAX op's choice), so float64 inputs are held to the float32
    tolerance."""
    def build(reg):
        rs, so = reg.get("Reshape"), reg.get("SoftmaxOutput")
        p_pred = rs.canonicalize_params({"shape": (-1, V)})
        p_lab = rs.canonicalize_params({"shape": (-1,)})
        p_so = so.canonicalize_params({})
        return lambda x, lab: so.fn(p_so, rs.fn(p_pred, x),
                                    rs.fn(p_lab, lab))
    logits = _rand(B, T, V, dtype=dtype)
    label = _tokens(seed=1).astype(dtype)
    (tout, tg), (jout, jg) = _vjp_both(build(jreg), build(treg),
                                       [logits, label], [0], dtype)
    tol = TOL[np.float32]
    _close(tout, jout, tol, "softmax")
    _close(tg[0], jg[0], tol, "softmax-output gradient")


def test_accuracy_takes_flattened_predictions():
    """`Accuracy` of (B*T, V) predictions against (B, T) labels, as the
    JAX metric counts them."""
    pred = _rand(B * T, V)
    label = _tokens(seed=2)
    jm, tm = jmx.metric.create("acc"), tmx.metric.create("acc")
    jm.update([jmx.nd.array(label)], [jmx.nd.array(pred)])
    tm.update([tmx.nd.array(label, ctx=CPU)], [tmx.nd.array(pred, ctx=CPU)])
    assert tm.get() == jm.get()
    assert tm.num_inst == B * T


# -- the graph and the fit ---------------------------------------------------

def _cfg(pkg_llm=tllm, **kw):
    base = dict(vocab_size=V, num_layers=2, num_heads=2, hidden=C,
                max_len=48, eos_id=0)
    base.update(kw)
    return pkg_llm.LMConfig(**base)


def _fresh(fn):
    """fn() in a new thread (fresh gluon name counters)."""
    out = {}

    def run():
        out["v"] = fn()
    t = threading.Thread(target=run)
    t.start()
    t.join(240)
    assert not t.is_alive() and "v" in out
    return out["v"]


def _symbols():
    """The LM symbol of each package, composed by each package's gluon
    (the JAX package cannot infer shapes of a loaded composed JSON)."""
    tsym = _fresh(lambda: tllm.lm_symbol(_cfg()))
    jsym = _fresh(lambda: jllm.lm_symbol(_cfg(jllm)))
    assert tsym.list_arguments() == jsym.list_arguments()
    return tsym, jsym


def _batch(pkg, ctx, seed=0, bs=8):
    rng = np.random.default_rng(seed)
    x = rng.integers(1, V, (bs, T)).astype(np.float32)
    return pkg.io.DataBatch(data=[pkg.nd.array(x, ctx=ctx)],
                            label=[pkg.nd.array(np.roll(x, -1, 1), ctx=ctx)])


def _bound(pkg, symbol, ctx, bs=8):
    pkg.random.seed(11)
    mod = pkg.mod.Module(symbol, context=ctx)
    mod.bind(data_shapes=[pkg.io.DataDesc("data", (bs, T))],
             label_shapes=[pkg.io.DataDesc("softmax_label", (bs, T))])
    mod.init_params(pkg.initializer.Xavier())
    return mod


def test_lm_symbol_gradients_match_jax():
    """One forward/backward of the whole `lm_symbol` graph: the same
    Xavier parameters (bitwise), the softmax output, and every
    parameter's gradient, `embed_weight`'s (lookup + head) included."""
    tsym, jsym = _symbols()
    jmod, tmod = _bound(jmx, jsym, jmx.cpu()), _bound(tmx, tsym, CPU)
    jarg, targ = jmod.get_params()[0], tmod.get_params()[0]
    assert jarg.keys() == targ.keys() and len(targ) == 12 * 2 + 3
    for k in jarg:
        np.testing.assert_array_equal(targ[k].asnumpy(), jarg[k].asnumpy())
    jmod.forward_backward(_batch(jmx, jmx.cpu()))
    tmod.forward_backward(_batch(tmx, CPU))
    tol = TOL[np.float32]
    _close(tmod.get_outputs()[0].asnumpy(), jmod.get_outputs()[0].asnumpy(),
           tol, "softmax output")
    jex, tex = jmod._exec_group.execs[0], tmod._exec_group.execs[0]
    for k in jarg:
        _close(tex.grad_dict[k].asnumpy(), jex.grad_dict[k].asnumpy(), tol,
               f"gradient of {k}")


def _lm_iter(pkg, n=80, bs=8, seed=3):
    """`tests/test_llm.py`'s periodic token stream."""
    rng = np.random.default_rng(seed)
    base = rng.integers(1, V, T + 1)
    x = np.empty((n, T), np.float32)
    y = np.empty((n, T), np.float32)
    for i in range(n):
        roll = np.roll(base, i % (T + 1))
        x[i] = roll[:T]
        y[i] = roll[1:]
    return pkg.io.NDArrayIter(x, y, batch_size=bs, shuffle=False,
                              label_name="softmax_label")


def _fit(pkg, symbol, ctx):
    pkg.random.seed(11)
    np.random.seed(11)
    mod = pkg.mod.Module(symbol, context=ctx)
    losses = []

    def record(param):
        name, val = param.eval_metric.get()
        losses.append(dict(zip(name, val))["cross-entropy"])
    mod.fit(_lm_iter(pkg), num_epoch=1, optimizer="sgd",
            optimizer_params={"learning_rate": 0.05, "momentum": 0.9},
            eval_metric=pkg.metric.create(["acc", "ce"]),
            initializer=pkg.initializer.Xavier(),
            batch_end_callback=record)
    return mod, losses


def test_lm_fit_ten_steps_match_jax(monkeypatch):
    """10 `Module.fit` steps (SGD lr 0.05, momentum 0.9, Xavier, acc):
    the running train loss after every step, and the parameters and
    momenta at the end (a momentum's absolute tolerance is its
    weight's); the port's fused step ran every step."""
    tsym, jsym = _symbols()
    monkeypatch.setenv("MXNET_FUSED_TRAIN_STEP", "0")
    jmod, jlosses = _fresh(lambda: _fit(jmx, jsym, jmx.cpu()))
    monkeypatch.setenv("MXNET_FUSED_TRAIN_STEP", "1")
    tmod, tlosses = _fit(tmx, tsym, CPU)
    assert tmod._fused_step is not None and tmod._fused_step.steps == 10
    assert len(tlosses) == len(jlosses) == 10
    tol = TOL[np.float32]
    _close(tlosses, jlosses, tol, "running loss")
    assert tlosses[-1] < tlosses[0]
    jarg, targ = jmod.get_params()[0], tmod.get_params()[0]
    for k in jarg:
        _close(targ[k].asnumpy(), jarg[k].asnumpy(), tol, k)
    # a momentum is the last step, w_t - w_(t-1): its error is the
    # weight's, so its absolute tolerance scales with the weight
    names = tmod._exec_group.param_names
    for i, mom in tmod._updater.states.items():
        want = jmod._updater.states[i].asnumpy()
        np.testing.assert_allclose(
            mom.asnumpy(), want, rtol=tol[0],
            atol=tol[1] * np.abs(jarg[names[i]].asnumpy()).max(),
            err_msg=f"momentum of {names[i]}")


def test_bf16_param_dtype_binds_float32_in_both_packages():
    """`LMConfig(param_dtype="bfloat16")` sets the gluon Dense dtypes,
    which `lm_symbol`'s variables do not carry: `Module` binds float32
    parameters for it in the JAX package and in the port alike, so there
    is no bfloat16 `Module.fit` lane of the LM to port."""
    cfg_t = _cfg(param_dtype="bfloat16")
    cfg_j = _cfg(jllm, param_dtype="bfloat16")
    tsym = _fresh(lambda: tllm.lm_symbol(cfg_t))
    jsym = _fresh(lambda: jllm.lm_symbol(cfg_j))
    assert jsym.list_arguments() == tsym.list_arguments()
    for pkg, symbol, ctx in ((jmx, jsym, jmx.cpu()), (tmx, tsym, CPU)):
        arg = _bound(pkg, symbol, ctx).get_params()[0]
        assert {str(np.dtype(v.dtype)) for v in arg.values()} == \
            {"float32"}
