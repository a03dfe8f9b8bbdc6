"""The port's BatchNorm op against the JAX package's on the CPU.

The same inputs, drawn from numpy seeds, go through the JAX op
(`incubator_mxnet_tpu/ops/nn.py` BatchNorm, jnp math) and the port's
(`incubator_mxnet_tpu_torch/ops/nn.py`, `torch.native_batch_norm`).

Tolerances: float32, the same sums in other orders, rtol 1e-5 +
1e-5 * max|ref| (gradients 1e-4: the backward sums B*H*W products).
bfloat16 data: both compute in float32 and round the output to bf16,
which may land one bf16 ulp apart (2**-8 relative), so rtol 2**-7 +
2**-7 * max|ref|; bf16 gradients come back in bf16 after an fp32
backward, the same bound.  Moving statistics are float32 in both.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incubator_mxnet_tpu.ops import registry as jreg
import incubator_mxnet_tpu as jmx

from incubator_mxnet_tpu_torch.ops import registry as treg
import incubator_mxnet_tpu_torch as tmx

TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2.0 ** -7, 2.0 ** -7)}
GRAD_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (2.0 ** -7, 2.0 ** -7)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _close(got, want, tol, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    rtol, atol = tol
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _inputs(shape, axis, seed=0):
    rng = np.random.RandomState(seed)
    c = shape[axis]
    x = rng.normal(0.5, 2.0, shape).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, c).astype(np.float32)
    beta = rng.normal(0, 0.5, c).astype(np.float32)
    mm = rng.normal(0, 1, c).astype(np.float32)
    mv = rng.uniform(0.5, 2.0, c).astype(np.float32)
    return x, gamma, beta, mm, mv


def _params(pkg_reg, train, **kw):
    p = pkg_reg.get("BatchNorm").canonicalize_params(kw)
    p["_train"] = train
    return p


def _run_jax(x, gamma, beta, mm, mv, dtype, train, ct=None, **kw):
    """(outputs, (dx, dgamma, dbeta) or None) of the JAX op; the
    cotangents `ct` go to the outputs (not the moving updates)."""
    params = _params(jreg, train, **kw)
    fn = jreg.get("BatchNorm").fn
    nout = 3 if params["output_mean_var"] else 1

    def f(x_, g_, b_):
        out = fn(params, x_, g_, b_, jnp.asarray(mm), jnp.asarray(mv))
        out = out if isinstance(out, tuple) else (out,)
        return out[:nout], out[nout:]

    args = (jnp.asarray(x).astype(JDT[dtype]), jnp.asarray(gamma),
            jnp.asarray(beta))
    outs, aux = f(*args)
    if ct is None:
        return outs + aux, None
    _, vjp = jax.vjp(lambda *a: f(*a)[0], *args)
    grads = vjp(tuple(jnp.asarray(c).astype(o.dtype)
                      for c, o in zip(ct, outs)))
    return outs + aux, grads


def _run_port(x, gamma, beta, mm, mv, dtype, train, ct=None, **kw):
    params = _params(treg, train, **kw)
    nout = 3 if params["output_mean_var"] else 1
    xt = torch.from_numpy(x).to(TDT[dtype]).requires_grad_()
    gt = torch.from_numpy(gamma).requires_grad_()
    bt = torch.from_numpy(beta).requires_grad_()
    out = treg.get("BatchNorm").fn(params, xt, gt, bt, torch.from_numpy(mm),
                                   torch.from_numpy(mv))
    out = out if isinstance(out, tuple) else (out,)
    if ct is None:
        return out, None
    pairs = [(o, torch.from_numpy(c).to(o.dtype))
             for o, c in zip(out[:nout], ct) if o.requires_grad]
    grads = torch.autograd.grad([o for o, _ in pairs], [xt, gt, bt],
                                [c for _, c in pairs], allow_unused=True)
    return out, [torch.zeros_like(t) if g is None else g
                 for t, g in zip((xt, gt, bt), grads)]


@pytest.mark.parametrize("axis", [1, -1])
@pytest.mark.parametrize("fix_gamma", [True, False])
@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_jax(dtype, train, fix_gamma, axis):
    """Output (and, in training, the moving updates) in train and
    predict mode, over channel axis 1 (NCHW) and -1 (NHWC)."""
    shape = (4, 6, 5, 3) if axis == 1 else (4, 5, 3, 6)
    x, g, b, mm, mv = _inputs(shape, axis)
    kw = dict(fix_gamma=fix_gamma, axis=axis, eps=1e-5)
    jout, _ = _run_jax(x, g, b, mm, mv, dtype, train, **kw)
    tout, _ = _run_port(x, g, b, mm, mv, dtype, train, **kw)
    assert len(jout) == len(tout) == (3 if train else 1)
    assert tout[0].dtype == TDT[dtype]
    _close(_np(tout[0]), _np(jout[0]), TOL[dtype], "output")
    for name, t, j in zip(("moving_mean", "moving_var"), tout[1:],
                          jout[1:]):
        assert t.dtype == torch.float32
        _close(_np(t), _np(j), TOL["float32"], name)


@pytest.mark.parametrize("fix_gamma", [True, False])
@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gradients_match_jax_vjp(dtype, train, fix_gamma):
    """d(data), d(gamma), d(beta) for a random cotangent against
    `jax.vjp` of the JAX op; with fix_gamma, gamma's gradient is 0."""
    x, g, b, mm, mv = _inputs((4, 6, 5, 3), 1, seed=1)
    ct = [np.random.RandomState(2).normal(0, 1, x.shape).astype(np.float32)]
    kw = dict(fix_gamma=fix_gamma, eps=1e-5)
    _, jgrads = _run_jax(x, g, b, mm, mv, dtype, train, ct=ct, **kw)
    _, tgrads = _run_port(x, g, b, mm, mv, dtype, train, ct=ct, **kw)
    for name, t, j in zip(("data", "gamma", "beta"), tgrads, jgrads):
        _close(_np(t), _np(j), GRAD_TOL[dtype], name)
    if fix_gamma:
        assert not tgrads[1].any()
    assert tgrads[0].dtype == TDT[dtype]


@pytest.mark.parametrize("batch", [2, 3, 16])
def test_moving_variance_is_the_biased_one(batch):
    """The moving update is moving * momentum + batch * (1 - momentum)
    with the *biased* batch variance (torch's running update would use
    n / (n - 1) times it and momentum the other way round); at batch 2
    of one pixel the two differ by a factor of 2."""
    x, g, b, mm, mv = _inputs((batch, 4, 1, 1), 1, seed=3)
    momentum = 0.9
    tout, _ = _run_port(x, g, b, mm, mv, "float32", True, momentum=momentum)
    jout, _ = _run_jax(x, g, b, mm, mv, "float32", True, momentum=momentum)
    flat = x.reshape(batch, 4).astype(np.float64)
    biased = flat.var(axis=0)
    want_mean = mm * momentum + flat.mean(axis=0) * (1 - momentum)
    want_var = mv * momentum + biased * (1 - momentum)
    _close(_np(tout[1]), want_mean, TOL["float32"], "moving_mean")
    _close(_np(tout[2]), want_var, TOL["float32"], "moving_var")
    _close(_np(tout[2]), _np(jout[2]), TOL["float32"], "moving_var vs jax")
    unbiased = mv * momentum + flat.var(axis=0, ddof=1) * (1 - momentum)
    assert not np.allclose(_np(tout[2]), unbiased, rtol=1e-3)


def test_moving_variance_of_a_constant_channel():
    """A channel far below eps (constant here) at the op's default eps
    1e-3: its biased variance, recovered from rsqrt(var + eps), is not
    negative, and the moving update matches the JAX op's (which takes
    the variance directly) within eps times float32 rounding, 1e-9."""
    x, g, b, mm, mv = _inputs((4, 6, 5, 3), 1, seed=9)
    x[:, 2] = 0.75
    x[:, 4] = -3.0 + 1e-4 * x[:, 4]     # variance ~1e-8
    mv[2] = mv[4] = 0.0
    tout, _ = _run_port(x, g, b, mm, mv, "float32", True)
    jout, _ = _run_jax(x, g, b, mm, mv, "float32", True)
    got, want = _np(tout[2]), _np(jout[2])
    assert (got >= 0).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("train", [True, False])
def test_use_global_stats_normalises_with_the_moving_statistics(train):
    """use_global_stats: the moving statistics normalise in training
    too, and the training update blends them with themselves."""
    x, g, b, mm, mv = _inputs((4, 6, 5, 3), 1, seed=4)
    kw = dict(use_global_stats=True, fix_gamma=False)
    ct = [np.random.RandomState(5).normal(0, 1, x.shape).astype(np.float32)]
    jout, jgrads = _run_jax(x, g, b, mm, mv, "float32", train, ct=ct, **kw)
    tout, tgrads = _run_port(x, g, b, mm, mv, "float32", train, ct=ct, **kw)
    assert len(tout) == len(jout)
    for k, (t, j) in enumerate(zip(tout, jout)):
        _close(_np(t), _np(j), TOL["float32"], f"output {k}")
    for name, t, j in zip(("data", "gamma", "beta"), tgrads, jgrads):
        _close(_np(t), _np(j), GRAD_TOL["float32"], name)
    pred, _ = _run_port(x, g, b, mm, mv, "float32", False, **kw)
    _close(_np(tout[0]), _np(pred[0]), TOL["float32"], "train vs predict")


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_output_mean_var_matches_jax(dtype, train):
    """output_mean_var: three outputs, the third rsqrt(var + eps) (not
    var), and gradients that reach the statistics' outputs."""
    x, g, b, mm, mv = _inputs((4, 6, 5, 3), 1, seed=6)
    rng = np.random.RandomState(7)
    ct = [rng.normal(0, 1, x.shape).astype(np.float32),
          rng.normal(0, 1, 6).astype(np.float32),
          rng.normal(0, 1, 6).astype(np.float32)]
    kw = dict(output_mean_var=True, fix_gamma=False, eps=1e-3)
    jout, jgrads = _run_jax(x, g, b, mm, mv, dtype, train, ct=ct, **kw)
    tout, tgrads = _run_port(x, g, b, mm, mv, dtype, train, ct=ct, **kw)
    assert len(tout) == len(jout) == (5 if train else 3)
    _close(_np(tout[0]), _np(jout[0]), TOL[dtype], "output")
    for k in range(1, len(tout)):
        _close(_np(tout[k]), _np(jout[k]), TOL["float32"], f"output {k}")
    var = np.asarray(mv, np.float64) if not train else \
        x.astype(np.float64).var(axis=(0, 2, 3))
    if dtype == "float32":
        _close(_np(tout[2]), 1 / np.sqrt(var + 1e-3), TOL["float32"],
               "rsqrt(var + eps)")
    if train or dtype == "float32":
        for name, t, j in zip(("data", "gamma", "beta"), tgrads, jgrads):
            _close(_np(t), _np(j), GRAD_TOL[dtype], name)


@pytest.mark.parametrize("use_global_stats", [False, True])
@pytest.mark.parametrize("fix_gamma", [True, False])
def test_batchnorm_in_a_bound_graph_matches_jax(fix_gamma, use_global_stats):
    """Through the Symbol interpreter: BatchNorm's gamma, beta and aux
    shapes come from infer_shape, a training forward writes the new
    moving statistics into the aux arrays, backward gives the same
    gradients (with use_global_stats too, where the backward reads the
    moving statistics the forward overwrote); the alias BatchNorm_v1
    loads."""
    s = tmx.sym
    net = s.Convolution(s.Variable("data"), kernel=(3, 3), num_filter=4,
                        name="conv")
    net = s.BatchNorm(net, fix_gamma=fix_gamma,
                      use_global_stats=use_global_stats, name="bn")
    net = s.SoftmaxOutput(s.FullyConnected(s.Activation(
        net, act_type="relu"), num_hidden=5, name="fc"), name="softmax")
    jnet = jmx.sym.load_json(net.tojson())
    assert net.list_auxiliary_states() == ["bn_moving_mean", "bn_moving_var"]
    assert net.list_auxiliary_states() == jnet.list_auxiliary_states()
    shapes = dict(data=(3, 2, 6, 6), softmax_label=(3,))
    args, _, aux = net.infer_shape(**shapes)
    jargs, _, jaux = jnet.infer_shape(**shapes)
    assert args == [tuple(a) for a in jargs] and \
        aux == [tuple(a) for a in jaux] == [(4,), (4,)]
    rng = np.random.RandomState(8)
    values = {n: rng.normal(0, 0.5, sh).astype(np.float32)
              for n, sh in zip(net.list_arguments(), args)}
    values["softmax_label"] = rng.randint(0, 5, 3).astype(np.float32)
    auxv = {"bn_moving_mean": rng.normal(0, 0.2, 4).astype(np.float32),
            "bn_moving_var": rng.uniform(0.5, 2, 4).astype(np.float32)}
    exe = net.simple_bind(tmx.cpu(), **shapes)
    jexe = jnet.simple_bind(jmx.cpu(), **shapes)
    exe.copy_params_from(values, auxv)
    jexe.copy_params_from({k: jmx.nd.array(v) for k, v in values.items()},
                          {k: jmx.nd.array(v) for k, v in auxv.items()})
    out = exe.forward(is_train=True)[0].asnumpy()
    jout = jexe.forward(is_train=True)[0].asnumpy()
    _close(out, jout, TOL["float32"], "output")
    exe.backward()
    jexe.backward()
    for n in ("conv_weight", "bn_gamma", "bn_beta", "fc_weight"):
        _close(exe.grad_dict[n].asnumpy(), jexe.grad_dict[n].asnumpy(),
               GRAD_TOL["float32"], n)
    for n in auxv:
        _close(exe.aux_dict[n].asnumpy(), jexe.aux_dict[n].asnumpy(),
               TOL["float32"], n)
        if not use_global_stats:
            assert not np.array_equal(exe.aux_dict[n].asnumpy(), auxv[n])
    legacy = net.tojson().replace('"op": "BatchNorm"', '"op": "BatchNorm_v1"')
    assert tmx.sym.load_json(legacy).list_auxiliary_states() == \
        net.list_auxiliary_states()
