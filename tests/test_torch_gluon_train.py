"""Gluon's imperative training pieces in the port against the JAX
package's on the CPU: every ported loss and its gradient, `Trainer.step`
(SGD with and without momentum, weight decay, ``multi_precision`` on a
bfloat16 net, the bench's ``rescale_grad`` of 1/batch on top of step's
1/batch), the trainer's saved states, `hybridize()` against the eager
call (outputs, gradients, BatchNorm's running statistics), deferred
shapes, `Parameter`'s gradient arrays, `gluon.data` and `gluon.utils`.

Networks are built in a fresh thread in each package (the name counters
are per thread, so both give the same names) and the JAX package's
initial parameters are copied into the port's.  Inputs come from one
numpy seed.

Tolerances.  float32: rtol 1e-5 + 1e-6 * max|ref| for one op or loss
(the same ops, each rounded once); rtol 1e-4 + 1e-5 * max|ref| for the
steps of a network (sums in other orders through several layers and
steps).  A hybridized call runs the same torch ops in the same order as
the eager one, so it is held to rtol 1e-6 + 1e-7 * max|ref|.  bfloat16
(as `test_torch_resnet_fit.py` holds it): the weights are the fp32
masters rounded to bfloat16 exactly; the two packages' bf16 runs each
round every layer's output and gradient (2**-8) after sums in their own
order, and part from each other about as far as each parts from the
float32 run (~5e-3 of the momenta in relative L2), so no elementwise
bound between them holds.  The port's masters and momenta are held as
close to the JAX package's float32 run as the JAX package's own bf16 run
is, within a factor 1.5, in relative L2 norm.
"""
import pickle
import threading

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch.compat.weights import (
    block_params_from_numpy, block_params_to_numpy, trainer_states_from_numpy,
    trainer_states_to_numpy)

OP_TOL = (1e-5, 1e-6)
NET_TOL = (1e-4, 1e-5)
HYBRID_TOL = (1e-6, 1e-7)
BF16_FACTOR = 1.5


def _close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    rtol, atol = tol
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _fresh(fn):
    """fn() in a new thread (fresh name counters); returns its result."""
    out = {}

    def run():
        out["v"] = fn()
    t = threading.Thread(target=run)
    t.start()
    t.join(120)
    assert not t.is_alive() and "v" in out
    return out["v"]


def _rng(seed):
    return np.random.RandomState(seed)


# -- losses ------------------------------------------------------------------

def _labels(kind, shape, rng):
    if kind == "real":
        return rng.randn(*shape).astype(np.float32)
    if kind == "binary":
        return rng.randint(0, 2, shape).astype(np.float32)
    if kind == "signed":
        return (rng.randint(0, 2, shape) * 2 - 1).astype(np.float32)
    if kind == "class":
        return rng.randint(0, shape[-1], shape[:-1]).astype(np.float32)
    if kind == "prob":
        p = rng.rand(*shape).astype(np.float32) + 0.1
        return p / p.sum(-1, keepdims=True)
    raise ValueError(kind)


LOSSES = [
    ("L2Loss", {}, "real"), ("L2Loss", {"weight": 0.5}, "real"),
    ("L1Loss", {}, "real"),
    ("SigmoidBinaryCrossEntropyLoss", {}, "binary"),
    ("SigmoidBCELoss", {"from_sigmoid": True}, "binary"),
    ("SoftmaxCrossEntropyLoss", {}, "class"),
    ("SoftmaxCELoss", {"sparse_label": False}, "prob"),
    ("SoftmaxCrossEntropyLoss", {"from_logits": True, "axis": 1}, "class"),
    ("KLDivLoss", {}, "prob"), ("KLDivLoss", {"from_logits": False}, "prob"),
    ("HuberLoss", {"rho": 0.5}, "real"), ("HingeLoss", {}, "signed"),
    ("SquaredHingeLoss", {"margin": 2}, "signed"),
    ("LogisticLoss", {}, "signed"),
    ("LogisticLoss", {"label_format": "binary"}, "binary"),
]


def _loss_case(mx, name, kwargs, kind, sample_weight, hybrid):
    rng = _rng(3)
    shape = (4, 5)
    pred = rng.randn(*shape).astype(np.float32)
    if kwargs.get("from_sigmoid"):
        pred = 1 / (1 + np.exp(-pred))
    if name == "KLDivLoss" and kwargs.get("from_logits", True):
        pred = np.log(_labels("prob", shape, _rng(4)))
    label = _labels(kind, shape, rng)
    fn = getattr(mx.gluon.loss, name)(**kwargs)
    if hybrid:
        fn.hybridize()
    p = mx.nd.array(pred)
    p.attach_grad()
    args = [p, mx.nd.array(label)]
    if sample_weight:
        args.append(mx.nd.array(rng.rand(4, 1).astype(np.float32)))
    with mx.autograd.record():
        loss = fn(*args)
    loss.backward()
    return loss.asnumpy(), p.grad.asnumpy()


@pytest.mark.parametrize("sample_weight", [False, True])
@pytest.mark.parametrize("name,kwargs,kind", LOSSES,
                         ids=[f"{n}-{k}" for n, k, _ in LOSSES])
def test_loss_and_gradient_match_jax(name, kwargs, kind, sample_weight):
    """The loss per sample and its gradient (ones as the head gradient)
    against the JAX package's; hybridized, the port gives the same."""
    want = _loss_case(jmx, name, kwargs, kind, sample_weight, False)
    with tmx.cpu():
        got = _loss_case(tmx, name, kwargs, kind, sample_weight, False)
        hyb = _loss_case(tmx, name, kwargs, kind, sample_weight, True)
    assert got[0].shape == want[0].shape == (4,)
    for g, w, what in zip(got, want, ("loss", "d pred")):
        _close(g, w, OP_TOL, what)
    for h, g, what in zip(hyb, got, ("hybridized loss", "hybridized d")):
        _close(h, g, HYBRID_TOL, what)


def test_triplet_loss_matches_jax():
    def case(mx):
        rng = _rng(5)
        a, p, n = (mx.nd.array(rng.randn(4, 6).astype(np.float32))
                   for _ in range(3))
        for v in (a, p, n):
            v.attach_grad()
        with mx.autograd.record():
            loss = mx.gluon.loss.TripletLoss(margin=0.5)(a, p, n)
        loss.backward()
        return [loss.asnumpy()] + [v.grad.asnumpy() for v in (a, p, n)]
    want = case(jmx)
    with tmx.cpu():
        got = case(tmx)
    for g, w in zip(got, want):
        _close(g, w, OP_TOL)


# -- Trainer -------------------------------------------------------------------

def _mlp(pkg, bn=False):
    def build():
        nn = pkg.gluon.nn
        net = nn.HybridSequential()
        net.add(nn.Dense(16, activation="relu", in_units=12))
        if bn:
            net.add(nn.BatchNorm(in_channels=16))
        net.add(nn.Dense(3, in_units=16))
        return net
    return _fresh(build)


def _pair(bn=False, dtype=None):
    """(port net, JAX net) with the JAX package's Xavier parameters."""
    jmx.random.seed(7)
    jnet, tnet = _mlp(jmx, bn), _mlp(tmx, bn)
    jnet.initialize(jmx.initializer.Xavier(), ctx=jmx.cpu())
    tnet.initialize(ctx=tmx.cpu())
    block_params_from_numpy(tnet, block_params_to_numpy(jnet))
    if dtype:
        jnet.cast(dtype)
        tnet.cast(dtype)
    return tnet, jnet


def _batches(n, batch=8, seed=11):
    rng = _rng(seed)
    return [(rng.randn(batch, 12).astype(np.float32),
             rng.randint(0, 3, batch).astype(np.float32)) for _ in range(n)]


def _train(mx, net, opt_params, batches, dtype=None, hybrid=False):
    """The plain loop over `batches`; (losses, [params after each step],
    the trainer)."""
    if hybrid:
        net.hybridize()
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd", dict(opt_params))
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    losses, states = [], []
    for x, y in batches:
        data = mx.nd.array(x, ctx=mx.cpu())
        if dtype:
            data = data.astype(dtype)
        label = mx.nd.array(y, ctx=mx.cpu())
        with mx.autograd.record():
            loss = loss_fn(net(data), label)
        loss.backward()
        trainer.step(x.shape[0])
        losses.append(float(loss.asnumpy().astype(np.float64).mean()))
        states.append(block_params_to_numpy(net))
    return losses, states, trainer


@pytest.mark.parametrize("opt_params,bn", [
    ({"learning_rate": 0.1}, False),
    ({"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3}, False),
    ({"learning_rate": 0.05, "momentum": 0.9}, True)],
    ids=["sgd", "momentum-wd", "momentum-batchnorm"])
@pytest.mark.parametrize("hybrid", [False, True], ids=["eager", "hybridized"])
def test_trainer_steps_match_jax(opt_params, bn, hybrid):
    """4 steps of record / backward / Trainer.step: every loss, every
    parameter (BatchNorm's running statistics included) after every step,
    and the momenta at the end."""
    tnet, jnet = _pair(bn)
    batches = _batches(4)
    jl, js, jt = _train(jmx, jnet, opt_params, batches, hybrid=hybrid)
    with tmx.cpu():
        tl, ts, tt = _train(tmx, tnet, opt_params, batches, hybrid=hybrid)
    _close(tl, jl, NET_TOL, "losses")
    for k, (g, w) in enumerate(zip(ts, js)):
        assert list(g) == list(w)
        for name in w:
            _close(g[name], w[name], NET_TOL, f"step {k + 1} {name}")
    gs, ws = trainer_states_to_numpy(tt), trainer_states_to_numpy(jt)
    assert sorted(gs) == sorted(ws)
    for i in ws:
        if ws[i] is None:
            assert gs[i] is None
        else:
            _close(gs[i], ws[i], NET_TOL, f"momentum {i}")


def _rel_l2(got, ref):
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def test_trainer_multi_precision_bf16_matches_jax():
    """A bfloat16 net with multi_precision, 3 steps: every bf16 weight is
    exactly its fp32 master rounded; the masters' updates (from the
    bf16-rounded start) and the momenta, each kind over every parameter,
    are no farther (relative L2) from the JAX package's
    float32 run than the JAX package's own bfloat16 run is, within
    BF16_FACTOR."""
    opt = {"learning_rate": 0.1, "momentum": 0.9, "multi_precision": True}
    batches = _batches(3)
    _, jnet = _pair()
    names = [p.name for p in jnet.collect_params().values()]
    init = block_params_to_numpy(jnet)
    _, f32_params, f32 = _train(jmx, jnet, opt, batches)
    f32 = trainer_states_to_numpy(f32)
    tnet, jnet = _pair(dtype="bfloat16")
    _, _, jt = _train(jmx, jnet, opt, batches, dtype="bfloat16")
    with tmx.cpu():
        _, _, tt = _train(tmx, tnet, opt, batches, dtype="bfloat16")
    jax_bf16 = trainer_states_to_numpy(jt)
    port_bf16 = trainer_states_to_numpy(tt)
    start = {n: torch.tensor(v).to(torch.bfloat16).float().numpy()
             for n, v in init.items()}

    def flat(parts):
        return np.concatenate([np.ravel(p) for p in parts])

    idx = sorted(port_bf16)
    kinds = {
        "momenta": (flat(port_bf16[i][0] for i in idx),
                    flat(jax_bf16[i][0] for i in idx),
                    flat(f32[i] for i in idx)),
        "master updates": (
            flat(port_bf16[i][1] - start[names[i]] for i in idx),
            flat(jax_bf16[i][1] - start[names[i]] for i in idx),
            flat(f32_params[-1][names[i]] - init[names[i]] for i in idx))}
    for what, (got, jax, want) in kinds.items():
        d_port, d_jax = _rel_l2(got, want), _rel_l2(jax, want)
        assert d_port <= BF16_FACTOR * d_jax + 1e-6, (what, d_port, d_jax)
    for i, p in enumerate(tnet.collect_params().values()):
        w = p.data().data
        assert port_bf16[i][1].dtype == np.float32
        assert w.dtype == torch.bfloat16
        assert torch.equal(w, torch.tensor(port_bf16[i][1]).to(
            torch.bfloat16)), p.name


def test_bench_rescale_is_one_over_batch_squared():
    """bench.py's gluon lane passes rescale_grad = 1/batch and step(batch)
    divides again: the optimizer's scale is 1/batch**2 in both packages,
    and the steps agree."""
    batch = 8
    opt = {"learning_rate": 0.5, "momentum": 0.9,
           "rescale_grad": 1.0 / batch}
    tnet, jnet = _pair()
    batches = _batches(2, batch=batch)
    _, js, jt = _train(jmx, jnet, opt, batches)
    with tmx.cpu():
        _, ts, tt = _train(tmx, tnet, opt, batches)
    assert tt._optimizer.rescale_grad == jt._optimizer.rescale_grad \
        == 1.0 / batch / batch
    for name in js[-1]:
        _close(ts[-1][name], js[-1][name], NET_TOL, name)


def test_save_and_load_states_round_trip(tmp_path):
    """States saved after 2 steps, loaded into a fresh trainer over the
    same parameters reset to their values then, give the third step
    bitwise; the update count comes back too."""
    opt = {"learning_rate": 0.1, "momentum": 0.9}
    with tmx.cpu():
        net, _ = _pair()
        batches = _batches(3)
        _, states, trainer = _train(tmx, net, opt, batches[:2])
        fname = str(tmp_path / "trainer.states")
        trainer.save_states(fname)
        loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()

        def step(tr):
            x, y = batches[2]
            with tmx.autograd.record():
                loss = loss_fn(net(tmx.nd.array(x)), tmx.nd.array(y))
            loss.backward()
            tr.step(8)
            return block_params_to_numpy(net)

        want = step(trainer)
        block_params_from_numpy(net, states[-1])
        fresh = tmx.gluon.Trainer(net.collect_params(), "sgd", opt)
        fresh.load_states(fname)
        assert fresh._optimizer.num_update == 2
        got = step(fresh)
    for name in want:
        assert np.array_equal(got[name], want[name]), name


def test_trainer_states_carry_across_packages():
    """trainer_states_from_numpy starts the port's trainer from the JAX
    trainer's momenta (and block_params_from_numpy from its parameters):
    the next step agrees."""
    opt = {"learning_rate": 0.1, "momentum": 0.9}
    tnet, jnet = _pair()
    batches = _batches(3)
    _, js, jt = _train(jmx, jnet, opt, batches[:2])
    carried = trainer_states_to_numpy(jt)

    def step(mx, net, trainer):
        x, y = batches[2]
        loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        with mx.autograd.record():
            loss = loss_fn(net(mx.nd.array(x)), mx.nd.array(y))
        loss.backward()
        trainer.step(8)
        return block_params_to_numpy(net)

    want = step(jmx, jnet, jt)
    with tmx.cpu():
        block_params_from_numpy(tnet, js[-1])
        trainer = tmx.gluon.Trainer(tnet.collect_params(), "sgd", opt)
        trainer_states_from_numpy(trainer, carried)
        got = step(tmx, tnet, trainer)
    for name in want:
        _close(got[name], want[name], NET_TOL, name)


def test_trainer_on_several_cards_raises():
    with tmx.cpu():
        net, _ = _pair()
        for kw in ({"zero": True}, {"mesh": object()}):
            with pytest.raises(tmx.MXNetError, match="ROADMAP"):
                tmx.gluon.Trainer(net.collect_params(), "sgd", {}, **kw)


@pytest.mark.parametrize("bucket_mb,devices", [
    (32, (0, 1)), (0.0005, (0, 1)), (32, (0, 0))],
    ids=["one-bucket", "kb-buckets", "one-device"])
def test_trainer_two_contexts_match_jax_one_context(monkeypatch, bucket_mb,
                                                    devices):
    """`Trainer` over parameters on two contexts ([cpu(0), cpu(1)], or
    [cpu(0), cpu(0)]: two replicas on one device, each forward under
    `parameter.replica`), each context fed half of every batch, against
    the JAX package's one-context step on the whole batch (the JAX
    multi-context lanes fail on the CPU, ROADMAP Queue 3): every loss and
    parameter after every step within NET_TOL, both contexts' copies
    equal bit for bit, and one batched push a step reducing in one
    reduction a bucket of the bucketed store."""
    from incubator_mxnet_tpu_torch.gluon.parameter import replica
    monkeypatch.setenv("MXNET_KVSTORE_BUCKET_MB", str(bucket_mb))
    opt = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3}
    batches = _batches(4)
    tnet, jnet = _pair()
    jl, js, _ = _train(jmx, jnet, opt, batches)
    values = block_params_to_numpy(tnet)
    ctxs = [tmx.cpu(i) for i in devices]
    net = _mlp(tmx)
    net.initialize(ctx=ctxs)
    block_params_from_numpy(net, values)
    trainer = tmx.gluon.Trainer(net.collect_params(), "sgd", dict(opt))
    loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    plan = None
    for step, (x, y) in enumerate(batches):
        xs = tmx.gluon.utils.split_and_load(tmx.nd.array(x, ctx=ctxs[0]),
                                            ctxs)
        ys = tmx.gluon.utils.split_and_load(tmx.nd.array(y, ctx=ctxs[0]),
                                            ctxs)
        losses = []
        for k, (a, b) in enumerate(zip(xs, ys)):
            with replica(k), tmx.autograd.record():
                losses.append(loss_fn(net(a), b))
            losses[-1].backward()
        trainer.step(x.shape[0])
        got = float(np.concatenate([v.asnumpy() for v in losses])
                    .astype(np.float64).mean())
        _close(got, jl[step], NET_TOL, f"loss {step + 1}")
        for name, param in net.collect_params().items():
            a, b = (d.asnumpy() for d in param.list_data())
            np.testing.assert_array_equal(a, b, err_msg=name)
            _close(a, js[step][name], NET_TOL, f"step {step + 1} {name}")
        st = trainer._kvstore.stats()
        if plan is None:
            plan = st["buckets"]
        assert st["batched_pushes"] == step + 1
        assert st["allreduce_dispatches"] == st["buckets"] == \
            plan * (step + 1)
    sizes = [v.size * 4 for v in values.values()]
    assert plan == len(tmx.kv.plan_buckets(
        list(reversed(range(len(sizes)))), sizes, ["float32"] * len(sizes),
        int(bucket_mb * (1 << 20)))) == (1 if bucket_mb == 32 else 2)
    assert trainer._kvstore.type == "device"


def test_learning_rate_and_lr_mult():
    """learning_rate / set_learning_rate, and a Parameter's lr_mult and
    wd_mult, as the JAX trainer applies them."""
    tnet, jnet = _pair()

    def case(mx, net):
        net[0].weight.lr_mult = 0.5
        net[1].bias.wd_mult = 0.0
        tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                              {"learning_rate": 0.2, "wd": 0.1})
        lr0 = tr.learning_rate
        tr.set_learning_rate(0.3)
        loss_fn = mx.gluon.loss.L2Loss()
        x = mx.nd.array(_rng(2).randn(4, 12).astype(np.float32))
        with mx.autograd.record():
            loss = loss_fn(net(x), mx.nd.ones((4, 3)))
        loss.backward()
        tr.step(4)
        return lr0, tr.learning_rate, block_params_to_numpy(net)
    want = case(jmx, jnet)
    with tmx.cpu():
        got = case(tmx, tnet)
    assert got[:2] == want[:2] == (0.2, 0.3)
    for name in want[2]:
        _close(got[2][name], want[2][name], NET_TOL, name)


# -- hybridize -----------------------------------------------------------------

def test_hybridize_matches_eager_and_jax():
    """JAX test_gluon.py:61-80: the hybridized forward equals the eager
    one, and gradients flow through the cached graph; here also the
    gradients of every parameter, against the eager port and the JAX
    package."""
    x = _rng(1).rand(5, 12).astype(np.float32)

    def case(mx, net, hybrid):
        if hybrid:
            net.hybridize()
        for p in net.collect_params().values():
            p.zero_grad()
        xx = mx.nd.array(x)
        with mx.autograd.record():
            out = net(xx)
            loss = mx.nd.sum(out * out)
        loss.backward()
        return out.asnumpy(), {p.name: p.grad().asnumpy()
                               for p in net.collect_params().values()}
    tnet, jnet = _pair()
    want = case(jmx, jnet, True)
    with tmx.cpu():
        eager = case(tmx, tnet, False)
        hyb = case(tmx, tnet, True)
    _close(hyb[0], eager[0], HYBRID_TOL, "out")
    _close(hyb[0], want[0], OP_TOL, "out vs jax")
    for name in want[1]:
        _close(hyb[1][name], eager[1][name], HYBRID_TOL, name)
        _close(hyb[1][name], want[1][name], OP_TOL, name)


def test_hybridize_deferred_init():
    """JAX test_gluon.py:83-92: shapes inferred at the first hybridized
    call; also at the first eager call."""
    for hybrid in (True, False):
        with tmx.cpu():
            net = tmx.gluon.nn.HybridSequential()
            net.add(tmx.gluon.nn.Dense(8, activation="relu"),
                    tmx.gluon.nn.Dense(3))
            net.initialize()
            if hybrid:
                net.hybridize()
            out = net(tmx.nd.ones((2, 6)))
        assert out.shape == (2, 3)
        assert net[0].weight.shape == (8, 6)


@pytest.mark.parametrize("hybrid", [True, False], ids=["hybridized", "eager"])
def test_batchnorm_running_stats_update_in_training_only(hybrid):
    """JAX test_gluon.py:95-106: a recorded training call moves the
    running statistics, in place, to the JAX package's values; a
    record(train_mode=False) call and a predict call leave them."""
    x = _rng(2).uniform(1, 2, (16, 12)).astype(np.float32)

    def case(mx, net):
        if hybrid:
            net.hybridize()
        bn = net[1]
        before = bn.running_mean.data()
        seen = []
        for mode in ("train", "record-predict", "predict"):
            if mode == "train":
                with mx.autograd.record():
                    net(mx.nd.array(x))
            elif mode == "record-predict":
                with mx.autograd.record(train_mode=False):
                    net(mx.nd.array(x))
            else:
                net(mx.nd.array(x))
            seen.append((bn.running_mean.data().asnumpy(),
                         bn.running_var.data().asnumpy()))
        return seen, before is bn.running_mean.data()
    tnet, jnet = _pair(bn=True)
    want, _ = case(jmx, jnet)
    with tmx.cpu():
        got, same_array = case(tmx, tnet)
    assert same_array
    assert np.abs(got[0][0]).sum() > 0
    for k, ((gm, gv), (wm, wv)) in enumerate(zip(got, want)):
        _close(gm, wm, OP_TOL, f"running_mean after call {k}")
        _close(gv, wv, OP_TOL, f"running_var after call {k}")


def test_sequential_train_eager_matches_jax():
    """JAX test_gluon.py:41-58: an eager 2-layer net trained 10 steps at
    lr 0.5, loss by loss against the JAX package; the loss falls."""
    rng = _rng(0)
    x = rng.randn(64, 12).astype(np.float32)
    y = (rng.randn(64) > 0).astype(np.float32)
    tnet, jnet = _pair()
    opt = {"learning_rate": 0.5}
    jl, _, _ = _train(jmx, jnet, opt, [(x, y)] * 10)
    with tmx.cpu():
        tl, _, _ = _train(tmx, tnet, opt, [(x, y)] * 10)
    _close(tl, jl, NET_TOL, "losses")
    assert tl[-1] < tl[0] * 0.8


# -- Parameter -----------------------------------------------------------------

def test_parameter_gradients_and_leaves():
    """grad()/list_grad()/zero_grad() act on the arrays backward fills;
    grad_req "add" accumulates, as in the JAX package; changing grad_req
    re-makes the leaf; set_data keeps it; cast keeps a leaf and a
    gradient in the new dtype."""
    def case(mx, net):
        w = net[0].weight
        w.grad_req = "add"
        x = mx.nd.array(_rng(3).randn(4, 12).astype(np.float32))
        for _ in range(2):
            with mx.autograd.record():
                loss = mx.nd.sum(net(x))
            loss.backward()
        added = w.grad().asnumpy()
        w.zero_grad()
        zeroed = w.list_grad()[0].asnumpy()
        w.grad_req = "write"
        with mx.autograd.record():
            loss = mx.nd.sum(net(x))
        loss.backward()
        return added, zeroed, w.grad().asnumpy()
    tnet, jnet = _pair()
    want = case(jmx, jnet)
    with tmx.cpu():
        got = case(tmx, tnet)
    for g, v in zip(got, want):
        _close(g, v, OP_TOL)
    w = tnet[0].weight
    leaf = w.data().data
    assert leaf.is_leaf and leaf.requires_grad
    w.set_data(tmx.nd.ones(w.shape, ctx=tmx.cpu()))
    assert w.data().data is leaf and leaf.requires_grad
    w.grad_req = "null"
    assert not w.data().data.requires_grad
    with pytest.raises(tmx.MXNetError):
        w.grad()
    w.grad_req = "write"
    assert w.data().data.requires_grad and w.data().data.is_leaf
    tnet.cast("float64")
    d = w.data().data
    assert d.dtype == torch.float64 and d.is_leaf and d.requires_grad
    assert w.grad().data.dtype == torch.float64


def test_cast_keeps_the_jax_dtypes():
    """After net.cast("bfloat16") every parameter of a BatchNorm net,
    the running statistics included, has the JAX package's dtype."""
    tnet, jnet = _pair(bn=True, dtype="bfloat16")
    for (n, tp), (_, jp) in zip(tnet.collect_params().items(),
                                jnet.collect_params().items()):
        assert str(jp.data().dtype) == "bfloat16", n
        assert tp.data().data.dtype == torch.bfloat16, n


# -- data and utils ------------------------------------------------------------

@pytest.mark.parametrize("shuffle,last_batch", [
    (False, "keep"), (True, "keep"), (False, "discard"), (True, "rollover")])
def test_dataloader_matches_jax(shuffle, last_batch):
    """ArrayDataset of (numpy, 1-D NDArray) through DataLoader: the same
    batches in the same order (numpy's global stream shuffles both)."""
    rng = _rng(4)
    X = rng.rand(22, 3).astype(np.float32)
    y = np.arange(22).astype(np.float32)

    def case(mx):
        ds = mx.gluon.data.ArrayDataset(X, mx.nd.array(y))
        assert len(ds) == 22
        np.random.seed(5)
        loader = mx.gluon.data.DataLoader(ds, batch_size=5, shuffle=shuffle,
                                          last_batch=last_batch)
        return len(loader), [[a.asnumpy() for a in b] for b in loader]
    want = case(jmx)
    with tmx.cpu():
        got = case(tmx)
    assert got[0] == want[0]
    assert len(got[1]) == len(want[1])
    for g, w in zip(got[1], want[1]):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_dataset_transforms_and_samplers():
    """transform / transform_first (lazy and not), filter, SimpleDataset
    and the samplers against the JAX package."""
    def case(mx):
        data = mx.gluon.data
        ds = data.SimpleDataset([(i, i * 2.0) for i in range(7)])
        t1 = ds.transform(lambda a, b: (a + 1, b * b))
        t2 = ds.transform_first(lambda a: a * 10, lazy=False)
        f = ds.filter(lambda s: s[0] % 2 == 0)
        bs = data.BatchSampler(data.SequentialSampler(7), 3, "rollover")
        return ([t1[i] for i in range(7)], [t2[i] for i in range(7)],
                [f[i] for i in range(len(f))], list(bs), list(bs), len(bs))
    assert case(jmx) == case(tmx)


def test_split_and_load_and_clip_global_norm():
    def case(mx):
        data = mx.nd.arange(0, 16).reshape((8, 2))
        parts = mx.gluon.utils.split_data(data, 3, even_split=False)
        one = mx.gluon.split_and_load(data, [mx.cpu()])
        arrays = [mx.nd.array(_rng(s).randn(3, 4).astype(np.float32))
                  for s in range(3)]
        norm = mx.gluon.utils.clip_global_norm(arrays, 1.0)
        small = [mx.nd.array(np.full((2,), 0.1, np.float32))]
        norm2 = mx.gluon.utils.clip_global_norm(small, 5.0)
        return ([p.asnumpy() for p in parts], one[0].asnumpy(), norm,
                [a.asnumpy() for a in arrays], norm2, small[0].asnumpy())
    want = case(jmx)
    with tmx.cpu():
        got = case(tmx)
        with pytest.raises(ValueError):
            tmx.gluon.utils.split_data(tmx.nd.ones((5, 2)), 2)
    for g, w in zip(got[0], want[0]):
        assert np.array_equal(g, w)
    assert np.array_equal(got[1], want[1])
    _close(got[2], want[2], OP_TOL, "norm")
    for g, w in zip(got[3], want[3]):
        _close(g, w, OP_TOL, "clipped")
    _close(got[4], want[4], OP_TOL, "norm below the limit")
    assert np.array_equal(got[5], want[5])


def test_dataloader_workers_raise():
    """A worker's exception reaches the consumer at its batch's turn
    (the worker threads, `tests/test_torch_gluon_data.py`, hold the
    rest)."""
    class Broken(tmx.gluon.data.Dataset):
        def __len__(self):
            return 4

        def __getitem__(self, i):
            if i == 2:
                raise KeyError("sample 2")
            return np.float32(i)

    got = []
    with pytest.raises(KeyError, match="sample 2"):
        for b in tmx.gluon.data.DataLoader(Broken(), batch_size=1,
                                           num_workers=2):
            got.append(b.asnumpy())
    assert [g.tolist() for g in got] == [[0.0], [1.0]]


def test_optimizer_pickles_without_its_parameters():
    with tmx.cpu():
        net, _ = _pair()
        trainer = tmx.gluon.Trainer(net.collect_params(), "sgd",
                                    {"learning_rate": 0.1})
        opt = pickle.loads(pickle.dumps(trainer._optimizer))
    assert opt.param_dict == {} and opt.lr == 0.1
