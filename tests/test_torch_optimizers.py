"""The optimizer update ops and every optimizer of the PyTorch port
against the JAX package, on the CPU.

Each update op runs once through its ``nd`` frontend (``out=weight``, the
states written in place) on seeded float32 inputs, under three settings
of lr, wd, rescale_grad and clip_gradient.  Each optimizer takes 6 steps
through an `Updater` on a weight and a bias (weight decay on the weight
only, as ``wd_mult`` gives it) from the same arrays and gradients, and
the weights and every state array are compared after every step.
Tolerance: rtol 1e-5 plus 1e-6 of the largest value (float32 in another
order of operations); the sign-taking updates (signsgd, Signum) and
Ftrl's threshold may land on either side of a near tie, so elements
within 1e-6 of one are counted and excused, and the count is required to
be small.  SGLD's noise is its own: the deterministic part is held, and
the noise's mean and variance over 40000 elements within 5 sigma of N(0,
lr).
"""
import pickle

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import optimizer as topt

RTOL, ATOL = 1e-5, 1e-6

KW = [dict(lr=0.05, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0),
      dict(lr=0.1, wd=1e-3, rescale_grad=0.125, clip_gradient=0.2),
      dict(lr=0.01, wd=0.1, rescale_grad=2.0, clip_gradient=1.0)]

# op: (state names, extra params)
OPS = {
    "sgd_update": ((), {}),
    "sgd_mom_update": (("mom",), {"momentum": 0.9}),
    "mp_sgd_update": (("w32",), {}),
    "mp_sgd_mom_update": (("mom", "w32"), {"momentum": 0.9}),
    "adam_update": (("mean", "var"), {"beta1": 0.8, "beta2": 0.99,
                                      "epsilon": 1e-6}),
    "rmsprop_update": (("n",), {"gamma1": 0.9, "epsilon": 1e-6}),
    "rmspropalex_update": (("n", "g_avg", "delta"),
                           {"gamma1": 0.9, "gamma2": 0.8, "epsilon": 1e-6}),
    "ftrl_update": (("z", "n"), {"lamda1": 0.05, "beta": 1.5}),
    "signsgd_update": ((), {}),
    "signum_update": (("mom",), {"momentum": 0.8, "wd_lh": 0.01}),
}


def _close(got, want, what, near=None):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    ok = np.isclose(got, want, rtol=RTOL,
                    atol=ATOL * max(np.abs(want).max(initial=0), 1e-30))
    if near is not None:
        ok |= near
    assert ok.all(), (what, np.abs(got - want).max(), int((~ok).sum()))


def _state(name, shape, rng):
    if name in ("n", "var"):
        return np.abs(rng.normal(0, 0.5, shape)).astype(np.float32) + 0.1
    return rng.normal(0, 0.3, shape).astype(np.float32)


@pytest.mark.parametrize("kw", KW)
@pytest.mark.parametrize("op", sorted(OPS))
def test_update_op_matches_jax(op, kw):
    """One update through ``nd.<op>(..., out=weight)``: the weight and
    every state, in place, against the JAX op."""
    states, extra = OPS[op]
    rng = np.random.RandomState(3)
    shape = (6, 7)
    w = rng.normal(0, 1, shape).astype(np.float32)
    g = rng.normal(0, 3, shape).astype(np.float32)
    low = op.startswith("mp_")
    wdt = np.float16 if low else np.float32
    arrays = {"w": w.astype(wdt), "g": g.astype(wdt)}
    for s in states:
        arrays[s] = w.astype(wdt).astype(np.float32) if s == "w32" \
            else _state(s, shape, rng)
    if "g_avg" in arrays:     # a running mean of g^2 above its square
        arrays["n"] = arrays["n"] + np.square(arrays["g_avg"])
    t = {k: tmx.nd.array(v, ctx=tmx.cpu(), dtype=v.dtype)
         for k, v in arrays.items()}
    j = {k: jmx.nd.array(v, dtype=v.dtype) for k, v in arrays.items()}
    order = ("w", "g") + states
    getattr(tmx.nd, op)(*(t[a] for a in order), out=t["w"], **kw, **extra)
    getattr(jmx.nd, op)(*(j[a] for a in order), out=j["w"], **kw, **extra)
    near = None
    if op in ("signsgd_update", "signum_update"):
        # sign(g) (or of the new momentum) at a near tie with 0
        src = g * kw["rescale_grad"] if op == "signsgd_update" else \
            j["mom"].asnumpy()
        near = np.abs(src) < 1e-6
    if op == "ftrl_update":
        near = np.abs(np.abs(j["z"].asnumpy()) - extra["lamda1"]) < 1e-6
    for a in ("w",) + states:
        _close(t[a].asnumpy(), j[a].asnumpy(), f"{op} {a}", near)
    if near is not None:
        assert near.sum() <= 2


# -- optimizers --------------------------------------------------------------------

OPTIMIZERS = [
    ("sgd", {"momentum": 0.9}),
    ("nag", {"momentum": 0.9}),
    ("nag", {}),
    ("signum", {"momentum": 0.9, "wd_lh": 0.01}),
    ("signum", {"momentum": 0.0}),
    ("dcasgd", {"momentum": 0.9, "lamda": 0.1}),
    ("dcasgd", {}),
    ("lbsgd", {"momentum": 0.9}),
    ("ftml", {}),
    ("adam", {}),
    ("adagrad", {}),
    ("adadelta", {}),
    ("rmsprop", {}),
    ("rmsprop", {"centered": True, "clip_weights": 1.0}),
    ("ftrl", {"lamda1": 0.05}),
    ("adamax", {}),
    ("nadam", {}),
    ("test", {}),
]
NAMES = {0: "fc_weight", 1: "fc_bias"}


def _steps(n=6, shapes=((5, 4), (5,)), seed=7):
    rng = np.random.RandomState(seed)
    ws = [rng.normal(0, 1, s).astype(np.float32) for s in shapes]
    gs = [[rng.normal(0, 2, s).astype(np.float32) for s in shapes]
          for _ in range(n)]
    return ws, gs


def _flat(state):
    if state is None:
        return []
    if isinstance(state, (tuple, list)):
        return [a for s in state for a in _flat(s)]
    return [state]


def _run(pkg, name, kw, ws, gs, ctx=None, check=None):
    opt = pkg.optimizer.create(name, param_idx2name=NAMES, **kw)
    upd = pkg.optimizer.get_updater(opt)
    arr = (lambda a: pkg.nd.array(a, ctx=ctx)) if ctx is not None \
        else pkg.nd.array
    w = [arr(x) for x in ws]
    for step, grads in enumerate(gs):
        for i, g in enumerate(grads):
            upd(i, arr(g), w[i])
        if check is not None:
            check(step, w, upd)
    return w, upd


@pytest.mark.parametrize("name,kw", OPTIMIZERS,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(OPTIMIZERS)])
def test_optimizer_matches_jax(name, kw):
    """6 steps of each optimizer through `Updater`, every weight and
    state compared after each step (SGLD: `test_sgld`)."""
    kw = dict(kw, learning_rate=0.05, wd=0.01, rescale_grad=0.5,
              clip_gradient=3.0)
    ws, gs = _steps()
    seen, jseen = {}, {}

    def grab(step, w, upd):
        seen[step] = ([x.asnumpy() for x in w],
                      {i: [a.asnumpy() for a in _flat(s)]
                       for i, s in upd.states.items()})

    _, tupd = _run(tmx, name, kw, ws, gs, ctx=tmx.cpu(), check=grab)

    def jgrab(step, w, upd):
        jseen[step] = ([x.asnumpy() for x in w],
                       {i: [a.asnumpy() for a in _flat(s)]
                        for i, s in upd.states.items()})

    _, jupd = _run(jmx, name, kw, ws, gs, check=jgrab)
    for step in range(len(gs)):
        (tws, tst), (jws, jst) = seen[step], jseen[step]
        for i in range(2):
            _close(tws[i], jws[i], f"{name} step {step} weight {i}")
            assert len(tst[i]) == len(jst[i])
            for k, (a, b) in enumerate(zip(tst[i], jst[i])):
                _close(a, b, f"{name} step {step} param {i} state {k}")
    assert tupd.optimizer.num_update == jupd.optimizer.num_update
    if name == "nadam":
        assert tupd.optimizer.m_schedule == pytest.approx(
            jupd.optimizer.m_schedule, rel=1e-12)


def test_sgld():
    """SGLD: weight - lr/2 (g + wd w) + N(0, lr) noise; the update less
    its deterministic part is the noise, whose mean and variance over
    40000 elements are held to N(0, lr) within 5 sigma, and different
    each step."""
    lr, wd = 0.04, 0.01
    rng = np.random.RandomState(2)
    w0 = rng.normal(0, 1, (200, 200)).astype(np.float32)
    g = rng.normal(0, 1, (200, 200)).astype(np.float32)
    opt = tmx.optimizer.create("sgld", learning_rate=lr, wd=wd,
                               param_idx2name={0: "fc_weight"})
    w = tmx.nd.array(w0, ctx=tmx.cpu())
    noises = []
    for _ in range(2):
        before = w.asnumpy()
        opt.update(0, w, tmx.nd.array(g, ctx=tmx.cpu()), None)
        det = before - lr / 2 * (g + wd * before)
        noises.append((w.asnumpy() - det).astype(np.float64).ravel())
    for n in noises:
        assert abs(n.mean()) < 5 * np.sqrt(lr / n.size)
        assert abs(n.var() - lr) < 5 * lr * np.sqrt(2.0 / n.size)
    assert not np.allclose(noises[0], noises[1])


@pytest.mark.parametrize("name", ["rmsprop", "adagrad", "adadelta", "adam",
                                  "adamax", "nadam", "ftml", "ftrl",
                                  "sgld"])
def test_momentum_refused_as_in_jax(name):
    """lstm_bucketing.py hands ``momentum`` to every optimizer; the nine
    without that argument refuse it in both packages, alike."""
    msgs = []
    for pkg in (jmx, tmx):
        with pytest.raises(TypeError) as e:
            pkg.optimizer.create(name, momentum=0.9)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    for name in ("sgd", "nag", "signum", "dcasgd", "lbsgd"):
        assert tmx.optimizer.create(name, momentum=0.9).momentum == 0.9


@pytest.mark.parametrize("name,kw", [("nadam", {}), ("dcasgd",
                                                     {"momentum": 0.9}),
                                     ("rmsprop", {"centered": True}),
                                     ("ftml", {}), ("adamax", {})])
def test_states_round_trip(name, kw):
    """3 steps, the updater's states and optimizer through `dumps_states`
    / `loads_states` into a fresh updater, 3 more steps: equal, bit for
    bit, to 6 uninterrupted steps (tuple states, Nadam's m_schedule and
    DCASGD's previous weights travel)."""
    ws, gs = _steps()
    full, _ = _run(tmx, name, kw, ws, gs, ctx=tmx.cpu())
    half, upd = _run(tmx, name, kw, ws, gs[:3], ctx=tmx.cpu())
    blob = b"".join(bytes(p) for p in topt.dumps_states(
        (upd.states, upd.optimizer)))
    fresh = topt.get_updater(topt.create(name, param_idx2name=NAMES, **kw))
    fresh.set_states(blob)
    for grads in gs[3:]:
        for i, g in enumerate(grads):
            fresh(i, tmx.nd.array(g, ctx=tmx.cpu()), half[i])
    for a, b in zip(half, full):
        np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())
    pickle.loads(upd.get_states(dump_optimizer=True))


def _toy_module(optimizer, kw, fused=True):
    """A 2-layer mlp Module on the CPU, one epoch of 4 batches."""
    import incubator_mxnet_tpu_torch as mx
    data = mx.sym.Variable("data")
    net = mx.sym.FullyConnected(data, num_hidden=8, name="fc1")
    net = mx.sym.Activation(net, act_type="relu")
    net = mx.sym.FullyConnected(net, num_hidden=3, name="fc2")
    net = mx.sym.SoftmaxOutput(net, name="softmax")
    rng = np.random.RandomState(0)
    x = rng.normal(0, 1, (32, 6)).astype(np.float32)
    y = rng.randint(0, 3, 32).astype(np.float32)
    it = mx.io.NDArrayIter(x, y, batch_size=8)
    mod = mx.mod.Module(net, context=mx.cpu())
    mx.random.seed(1)
    mod.fit(it, num_epoch=1, optimizer=optimizer,
            optimizer_params=dict(kw, learning_rate=0.05),
            initializer=mx.init.Xavier(), eval_metric="acc")
    return mod


@pytest.mark.parametrize("name,kw,takes", [
    ("sgld", {}, False), ("nadam", {}, True), ("ftrl", {}, True),
    ("signum", {"momentum": 0.9}, True)])
def test_fused_step_takes_or_declines(name, kw, takes):
    """The fused train step takes every optimizer but SGLD, which draws
    random numbers (the JAX step declines it); a declined step runs the
    per-batch path and the parameters still move."""
    mod = _toy_module(name, kw)
    assert (mod._fused_step.steps > 0) == takes
    assert mod._fused_step.steps in (0, 4)
    args, _ = mod.get_params()
    assert all(np.isfinite(v.asnumpy()).all() for v in args.values())
