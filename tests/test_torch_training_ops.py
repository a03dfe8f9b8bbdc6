"""The training slice's ops and helpers in the PyTorch port against the
JAX package, on the CPU.

Each op's gradient is held to `jax.vjp` of the JAX op on the same
float32 inputs and cotangent, from a numpy seed: rtol 1e-5 plus 1e-6 of
the largest value (float32 sums in different orders).  Max pooling is
checked on inputs without ties: XLA's `reduce_window` gradient and
torch's `max_pool2d` may send a tied window's gradient to different
elements.  The optimizer ops run one update each; the initializers are
held bitwise under one `random.seed`.
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

RTOL, ATOL = 1e-5, 1e-6


def _close(got, want, what=""):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=RTOL,
                               atol=ATOL * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _vjp_both(op, params, inputs, seed=0, grad_inputs=None):
    """Forward and gradients of `op` in both packages on numpy `inputs`
    with one random cotangent; returns ((out, grads) port, (out, grads)
    JAX).  `grad_inputs`: indices of the inputs to differentiate."""
    idx = list(range(len(inputs))) if grad_inputs is None else grad_inputs
    jop, top = jreg.get(op), treg.get(op)
    jp, tp = jop.canonicalize_params(params), top.canonicalize_params(params)

    def jf(*diff):
        xs = [jnp.asarray(a) for a in inputs]
        for i, d in zip(idx, diff):
            xs[i] = d
        return jop.fn(jp, *xs)

    jout, vjp = jax.vjp(jf, *(jnp.asarray(inputs[i]) for i in idx))
    ct = np.random.RandomState(seed + 100).normal(
        0, 1, jout.shape).astype(np.float32)
    jgrads = vjp(jnp.asarray(ct))
    xs = [torch.from_numpy(a.copy()) for a in inputs]
    for i in idx:
        xs[i].requires_grad_()
    tout = top.fn(tp, *xs)
    tgrads = torch.autograd.grad(tout, [xs[i] for i in idx],
                                 torch.from_numpy(ct), allow_unused=True)
    tgrads = [torch.zeros_like(xs[i]) if g is None else g
              for i, g in zip(idx, tgrads)]
    return ((tout.detach().numpy(), [g.numpy() for g in tgrads]),
            (np.asarray(jout), [np.asarray(g) for g in jgrads]))


def _check(op, params, inputs, **kw):
    (tout, tg), (jout, jg) = _vjp_both(op, params, inputs, **kw)
    assert tout.shape == jout.shape
    _close(tout, jout, f"{op} forward")
    for i, (a, b) in enumerate(zip(tg, jg)):
        assert a.shape == b.shape
        _close(a, b, f"{op} grad of input {i}")


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).normal(0, 1, shape).astype(np.float32)


@pytest.mark.parametrize("params,shape", [
    ({"num_hidden": 6}, (4, 3, 2, 2)),
    ({"num_hidden": 6, "no_bias": True}, (4, 12)),
    ({"num_hidden": 5, "flatten": False}, (2, 3, 7)),
])
def test_fully_connected_gradient(params, shape):
    k = int(np.prod(shape[1:])) if params.get("flatten", True) else shape[-1]
    inputs = [_rand(*shape), _rand(params["num_hidden"], k, seed=1)]
    if not params.get("no_bias"):
        inputs.append(_rand(params["num_hidden"], seed=2))
    _check("FullyConnected", params, inputs)


@pytest.mark.parametrize("params,shape", [
    ({"kernel": (5, 5), "num_filter": 4}, (2, 3, 12, 12)),
    ({"kernel": (3, 3), "num_filter": 4, "pad": (1, 1), "stride": (2, 2)},
     (2, 3, 9, 9)),
    ({"kernel": (3, 3), "num_filter": 4, "num_group": 2, "dilate": (2, 2),
      "no_bias": True}, (1, 4, 10, 10)),
    ({"kernel": (3,), "num_filter": 3, "pad": (1,)}, (2, 2, 11)),
])
def test_convolution_gradient(params, shape):
    g = params.get("num_group", 1)
    nf = params["num_filter"]
    inputs = [_rand(*shape), 0.3 * _rand(nf, shape[1] // g,
                                         *params["kernel"], seed=1)]
    if not params.get("no_bias"):
        inputs.append(_rand(nf, seed=2))
    _check("Convolution", params, inputs)


@pytest.mark.parametrize("params", [
    {"kernel": (2, 2), "stride": (2, 2), "pool_type": "max"},
    {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1), "pool_type": "max",
     "pooling_convention": "full"},
    {"kernel": (3, 3), "stride": (1, 1), "pad": (1, 1), "pool_type": "avg"},
    {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1), "pool_type": "avg",
     "count_include_pad": False},
    {"kernel": (2, 2), "stride": (2, 2), "pool_type": "avg",
     "pooling_convention": "full"},
    {"kernel": (2, 2), "stride": (1, 1), "pool_type": "sum"},
    {"global_pool": True, "pool_type": "max"},
    {"global_pool": True, "pool_type": "avg"},
])
def test_pooling_gradient(params):
    """Normal draws: no two elements of a window tie."""
    _check("Pooling", params, [_rand(2, 3, 7, 7)])


@pytest.mark.parametrize("act", ["relu", "tanh", "sigmoid", "softrelu",
                                 "softsign"])
def test_activation_gradient(act):
    _check("Activation", {"act_type": act}, [_rand(3, 4, 5)])


@pytest.mark.parametrize("op,params,shape", [
    ("Flatten", {}, (2, 3, 4, 5)),
    ("Reshape", {"shape": (0, -1)}, (2, 3, 4)),
    ("Reshape", {"shape": (-3, -2)}, (2, 3, 4, 5)),
    ("Reshape", {"shape": (0, -4, 2, -1, 0)}, (3, 4, 5)),
])
def test_shape_op_gradient(op, params, shape):
    _check(op, params, [_rand(*shape)])


def _labels(n, k, seed=3, ignore=None):
    lab = np.random.RandomState(seed).randint(0, k, n).astype(np.float32)
    if ignore is not None:
        lab[::3] = ignore
    return lab


@pytest.mark.parametrize("params,data_shape,label", [
    ({}, (6, 5), _labels(6, 5)),
    ({"grad_scale": 2.5}, (6, 5), _labels(6, 5)),
    ({"normalization": "batch"}, (6, 5), _labels(6, 5)),
    ({"normalization": "valid", "use_ignore": True, "ignore_label": 2},
     (6, 5), _labels(6, 5, ignore=2)),
    ({"use_ignore": True, "ignore_label": -1}, (6, 5),
     _labels(6, 5, ignore=-1)),
    ({"normalization": "valid"}, (6, 5), _labels(6, 5)),
    ({"smooth_alpha": 0.1}, (6, 5), _labels(6, 5)),
    ({"out_grad": True}, (6, 5), _labels(6, 5)),
    ({"multi_output": True}, (3, 4, 5),
     _labels(15, 4).reshape(3, 5)),
    ({"multi_output": True, "use_ignore": True, "ignore_label": 0,
      "normalization": "valid"}, (3, 4, 5),
     _labels(15, 4, ignore=0).reshape(3, 5)),
    ({"preserve_shape": True}, (2, 3, 4), _labels(6, 4).reshape(2, 3)),
    ({}, (4, 2, 3), _labels(4, 6)),                # N-D input flattened
])
def test_softmax_output_gradient(params, data_shape, label):
    """Forward softmax; the backward ignores the cotangent (unless
    out_grad) and gives softmax - onehot under each parameter; the label's
    gradient is zero in both."""
    _check("SoftmaxOutput", params, [_rand(*data_shape), label])
    assert treg.get("Softmax") is treg.get("SoftmaxOutput")


def _opt_case(seed, shape=(5, 7)):
    rng = np.random.RandomState(seed)
    w = rng.normal(0, 1, shape).astype(np.float32)
    g = rng.normal(0, 3, shape).astype(np.float32)
    mom = rng.normal(0, 0.1, shape).astype(np.float32)
    return w, g, mom


OPT_KW = [dict(lr=0.05, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0),
          dict(lr=0.1, wd=1e-3, rescale_grad=0.125, clip_gradient=0.2),
          dict(lr=0.01, wd=0.1, rescale_grad=2.0, clip_gradient=1.0)]


@pytest.mark.parametrize("kw", OPT_KW)
@pytest.mark.parametrize("op", ["sgd_update", "sgd_mom_update",
                                "mp_sgd_update", "mp_sgd_mom_update"])
def test_optimizer_ops_match_jax(op, kw):
    """One in-place update in the port against the JAX op; weight and
    state (momentum, fp32 master) both.  The mp_ ops run on fp16
    weights with an fp32 master."""
    w, g, mom = _opt_case(7)
    low = op.startswith("mp_")
    wdt = np.float16 if low else np.float32
    extra = {"momentum": 0.9} if "mom" in op else {}
    t = {k: tmx.nd.array(v, ctx=tmx.cpu(), dtype=v.dtype) for k, v in
         (("w", w.astype(wdt)), ("g", g.astype(wdt)), ("mom", mom),
          ("w32", w.astype(wdt).astype(np.float32)))}
    j = {k: jmx.nd.array(v.asnumpy(), dtype=v.asnumpy().dtype)
         for k, v in t.items()}
    args = {"sgd_update": ("w", "g"), "sgd_mom_update": ("w", "g", "mom"),
            "mp_sgd_update": ("w", "g", "w32"),
            "mp_sgd_mom_update": ("w", "g", "mom", "w32")}[op]
    getattr(tmx.nd, op)(*(t[a] for a in args), out=t["w"], **kw, **extra)
    jw = getattr(jmx.nd, op)(*(j[a] for a in args), out=j["w"], **kw,
                             **extra)
    _close(t["w"].asnumpy(), jw.asnumpy(), f"{op} weight")
    for a in args[2:]:
        _close(t[a].asnumpy(), j[a].asnumpy(), f"{op} {a}")


@pytest.mark.parametrize("multi_precision", [False, True])
def test_sgd_optimizer_matches_jax(multi_precision):
    """SGD through `Updater`, three steps with momentum, weight decay on
    the weight and none on the bias (wd_mult), bf16 weights with fp32
    masters under multi_precision (the JAX mp ops keep the same fp32
    arithmetic)."""
    names = {0: "fc_weight", 1: "fc_bias"}
    kw = dict(learning_rate=0.1, momentum=0.9, wd=0.01, rescale_grad=0.5,
              param_idx2name=names, multi_precision=multi_precision)
    dt = "bfloat16" if multi_precision else "float32"
    rng = np.random.RandomState(4)
    ws = [rng.normal(0, 1, s).astype(np.float32) for s in ((4, 3), (4,))]
    gs = [[rng.normal(0, 1, w.shape).astype(np.float32) for w in ws]
          for _ in range(3)]
    upd = tmx.optimizer.get_updater(tmx.optimizer.create("sgd", **kw))
    jupd = jmx.optimizer.get_updater(jmx.optimizer.create("sgd", **kw))
    tw = [tmx.nd.array(w, ctx=tmx.cpu(), dtype=dt) for w in ws]
    jw = [jmx.nd.array(w, dtype=dt) for w in ws]
    for step in gs:
        for i, g in enumerate(step):
            upd(i, tmx.nd.array(g, ctx=tmx.cpu(), dtype=dt), tw[i])
            jupd(i, jmx.nd.array(g, dtype=dt), jw[i])
    for i in range(2):
        _close(tw[i].asnumpy(), np.asarray(jw[i].asnumpy(), np.float32),
               names[i])
    assert upd.optimizer.num_update == jupd.optimizer.num_update == 3


@pytest.mark.parametrize("name,kw", [
    ("xavier", {}),
    ("xavier", {"rnd_type": "gaussian", "factor_type": "in",
                "magnitude": 2}),
    ("uniform", {"scale": 0.3}),
    ("normal", {"sigma": 0.2}),
])
def test_initializers_bitwise_under_one_seed(name, kw):
    got = {}
    for pkg, zeros in ((tmx, lambda s: tmx.nd.zeros(s, ctx=tmx.cpu())),
                       (jmx, jmx.nd.zeros)):
        init = pkg.initializer.create(name, **kw)
        pkg.random.seed(5)
        arrs = []
        for shape in ((20, 30), (8, 3, 5, 5)):
            arr = zeros(shape)
            init(pkg.initializer.InitDesc("conv_weight"), arr)
            arrs.append(arr.asnumpy())
        bias = zeros((7,)) + 1 if pkg is jmx else tmx.nd.ones(
            (7,), ctx=tmx.cpu())
        init(pkg.initializer.InitDesc("conv_bias"), bias)
        arrs.append(bias.asnumpy())
        got[pkg] = arrs
    for a, b in zip(got[tmx], got[jmx]):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert not got[tmx][-1].any()                     # bias -> zeros


def test_initializer_honours_init_attr():
    sym = tmx.sym.Variable("w", init=tmx.initializer.Constant(0.5).dumps())
    attrs = sym.attr_dict()["w"]
    arr = tmx.nd.zeros((2, 2), ctx=tmx.cpu())
    tmx.initializer.Xavier()(tmx.initializer.InitDesc("w", attrs), arr)
    assert (arr.asnumpy() == 0.5).all()


@pytest.mark.parametrize("make", [
    lambda m: m.lr_scheduler.FactorScheduler(step=3, factor=0.5,
                                             stop_factor_lr=1e-3),
    lambda m: m.lr_scheduler.MultiFactorScheduler(step=[2, 5, 9],
                                                  factor=0.3),
    lambda m: m.lr_scheduler.PolyScheduler(max_update=12, base_lr=0.2,
                                           pwr=2),
    lambda m: m.lr_scheduler.CosineScheduler(max_update=12, base_lr=0.2,
                                             final_lr=0.01),
])
def test_lr_schedulers_match_jax(make):
    t, j = make(tmx), make(jmx)
    t.base_lr = j.base_lr = getattr(j, "base_lr_orig", 0.1)
    assert [t(n) for n in range(20)] == [j(n) for n in range(20)]


def test_sgd_with_lr_scheduler_matches_jax():
    rng = np.random.RandomState(6)
    w0 = rng.normal(0, 1, (3, 3)).astype(np.float32)
    grads = [rng.normal(0, 1, (3, 3)).astype(np.float32) for _ in range(6)]
    out = []
    for pkg, arr in ((tmx, lambda a: tmx.nd.array(a, ctx=tmx.cpu())),
                     (jmx, jmx.nd.array)):
        sched = pkg.lr_scheduler.FactorScheduler(step=2, factor=0.5)
        opt = pkg.optimizer.create("sgd", learning_rate=0.2,
                                   lr_scheduler=sched, momentum=0.5)
        upd, w = pkg.optimizer.get_updater(opt), arr(w0)
        for g in grads:
            upd(0, arr(g), w)
        out.append(w.asnumpy())
    _close(out[0], out[1])


def test_metrics_match_jax():
    rng = np.random.RandomState(8)
    batches = [(rng.randint(0, 5, 16).astype(np.float32),
                rng.dirichlet(np.ones(5), 16).astype(np.float32))
               for _ in range(3)]
    for name in ("acc", "ce", ["acc", "ce"]):
        t, j = tmx.metric.create(name), jmx.metric.create(name)
        for lab, pred in batches:
            t.update([tmx.nd.array(lab, ctx=tmx.cpu())],
                     [tmx.nd.array(pred, ctx=tmx.cpu())])
            j.update([jmx.nd.array(lab)], [jmx.nd.array(pred)])
        (tn, tv), (jn, jv) = t.get_name_value()[0], j.get_name_value()[0]
        assert tn == jn
        _close(tv, jv, str(name))
        t.reset()
        assert all(np.isnan(v) for _, v in t.get_name_value())


def test_ndarray_iter_shuffles_like_jax():
    """One numpy seed, one batch order, in both packages; a ragged tail
    is padded from the start, as in the JAX package."""
    x = np.arange(70, dtype=np.float32).reshape(35, 2)
    y = np.arange(35, dtype=np.float32)
    seqs = []
    for pkg in (tmx, jmx):
        np.random.seed(3)
        it = pkg.io.NDArrayIter(x, y, batch_size=8, shuffle=True)
        seq = []
        for _ in range(2):
            seq += [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
                    for b in it]
            it.reset()
        seqs.append(seq)
    assert len(seqs[0]) == len(seqs[1]) == 10
    for (a, b, p), (c, d, q) in zip(*seqs):
        assert np.array_equal(a, c) and np.array_equal(b, d) and p == q
    assert seqs[0][4][2] == 5
