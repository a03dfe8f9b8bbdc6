"""The gluon `TransformerLM` trained through gluon in the port against
the JAX package on the CPU: the plain loop (`autograd.record`,
`backward`, `Trainer.step`, SGD lr 0.05 momentum 0.9) and
`Estimator.fit` with the fused gluon step, each 3 steps of a 2-layer LM
of width 32 in float64, the tied `embed_weight`'s gradient (the lookup's
scatter plus the head's product) among the checks; then the bf16 lane
(``LMConfig(param_dtype="bfloat16")``), which the JAX block trains too.

Tolerances.  float64: rtol 1e-6 + 1e-8 * max|ref| for the losses, the
gradient and every parameter and momentum after each step; the two
packages part by ~1e-10 relative at the first step's loss (their gelu
and softmax round in other places), and three momentum steps grow that
far below the bound.  A fused step runs the plain loop's ops on the
same state, so the port's Estimator is held to the JAX plain loop at the
same bound.  bfloat16: each package rounds every op's output to bf16
(2**-8) in its own places, so no elementwise bound between them holds;
the port's parameters after 3 steps are held as close to the JAX float32
run as the JAX bf16 run is, within a factor 1.5, in relative L2 norm
(as `tests/test_torch_gluon_train.py` holds its bf16 nets), and the
loss falls in both.
"""
import threading

import numpy as np
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import llm as jllm

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import llm as tllm
from incubator_mxnet_tpu_torch.compat.weights import block_params_from_numpy

CPU = tmx.cpu()
F64_TOL = (1e-6, 1e-8)
BF16_FACTOR = 1.5
CFG = dict(vocab_size=40, num_layers=2, num_heads=2, hidden=32, max_len=48,
           eos_id=0)
BATCH, T, STEPS = 2, 16, 3
OPT = {"learning_rate": 0.05, "momentum": 0.9}


def _close(got, want, tol=F64_TOL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=tol[0],
                               atol=tol[1] * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _fresh(fn):
    out = {}
    t = threading.Thread(target=lambda: out.setdefault("v", fn()))
    t.start()
    t.join(120)
    assert "v" in out
    return out["v"]


def _values(cfg, dtype, seed=0):
    """Xavier-scale parameters under the LM's names, LayerNorm's gamma
    near 1 and its beta and the biases off 0."""
    rng = np.random.default_rng(seed)
    c, f = cfg["hidden"], 4 * cfg["hidden"]

    def mk(*s, scale=None, offset=0.0):
        scale = scale if scale is not None else np.sqrt(2.0 / sum(s))
        return (offset + scale * rng.standard_normal(s)).astype(dtype)

    v = {"lm_embed_weight": mk(cfg["vocab_size"], c, scale=0.3),
         "lm_final_ln_gamma": mk(c, scale=0.1, offset=1.0),
         "lm_final_ln_beta": mk(c, scale=0.1)}
    for i in range(cfg["num_layers"]):
        p = "lm_block%d_" % i
        for ln in ("ln1", "ln2"):
            v[p + ln + "_gamma"] = mk(c, scale=0.1, offset=1.0)
            v[p + ln + "_beta"] = mk(c, scale=0.1)
        for name, shape in (("qkv", (3 * c, c)), ("out_proj", (c, c)),
                            ("fc1", (f, c)), ("fc2", (c, f))):
            v[p + name + "_weight"] = mk(*shape)
            v[p + name + "_bias"] = mk(shape[0], scale=0.05)
    return v


def _tokens(seed=1):
    rng = np.random.RandomState(seed)
    x = rng.randint(1, CFG["vocab_size"], (STEPS, BATCH, T + 1))
    return x[:, :, :-1].astype(np.int32), x[:, :, 1:].astype(np.float32)


def _net(mx, llm, values, dtype, ctx=None):
    param_dtype = "bfloat16" if dtype == "bfloat16" else "float32"
    net = _fresh(lambda: llm.TransformerLM(
        llm.LMConfig(param_dtype=param_dtype, **CFG), prefix="lm_"))
    if mx is tmx:
        net.initialize(ctx=ctx)
        if dtype == "float64":
            net.cast("float64")
        block_params_from_numpy(net, values, ctx=ctx)
    else:
        net.initialize()
        if dtype == "float64":
            net.cast("float64")
        for name, p in net.collect_params().items():
            p.set_data(mx.nd.array(values[name], dtype=p.dtype))
    return net


def _state(net, trainer):
    params = {k: v.data().asnumpy().astype(np.float64)
              for k, v in net.collect_params().items()}
    moms = {}
    for i, st in trainer._updaters[0].states.items():
        if st is not None:
            moms[trainer._params[i].name] = np.asarray(
                st.asnumpy(), np.float64)
    return params, moms


def _plain(mx, llm, dtype, ctx=None):
    """STEPS steps of the plain loop; per step the loss per sequence,
    the embed_weight gradient and the state after it."""
    values = _values(CFG, np.float64 if dtype == "float64" else np.float32)
    net = _net(mx, llm, values, dtype, ctx)
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd", dict(OPT))
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    kw = {"ctx": ctx} if ctx is not None else {}
    xs, ys = _tokens()
    out = []
    for x, y in zip(xs, ys):
        with mx.autograd.record():
            loss = loss_fn(net(mx.nd.array(x, dtype="int32", **kw)),
                           mx.nd.array(y, **kw))
        loss.backward()
        grad = net.collect_params()["lm_embed_weight"].grad().asnumpy()
        trainer.step(BATCH)
        out.append((loss.asnumpy().astype(np.float64),
                    grad.astype(np.float64), _state(net, trainer)))
    return out


def test_gluon_lm_plain_loop_matches_jax_in_float64():
    want = _plain(jmx, jllm, "float64")
    got = _plain(tmx, tllm, "float64", CPU)
    for k, ((gl, gg, (gp, gm)), (wl, wg, (wp, wm))) in enumerate(
            zip(got, want)):
        _close(gl, wl, what=f"step {k + 1} loss")
        _close(gg, wg, what=f"step {k + 1} embed_weight gradient")
        assert sorted(gp) == sorted(wp) and sorted(gm) == sorted(wm)
        for n in wp:
            _close(gp[n], wp[n], what=f"step {k + 1} {n}")
        for n in wm:
            _close(gm[n], wm[n], what=f"step {k + 1} momentum {n}")
    assert got[-1][0].mean() < got[0][0].mean()


def test_gluon_lm_tied_gradient_is_both_uses():
    """The tied weight's gradient sums the lookup's scatter and the
    head's product: on the rows of tokens the batch never reads it is
    the head's share alone (computed in plain torch from the same hidden
    states), and on the rows it reads the lookup adds to it."""
    values = _values(CFG, np.float64)
    net = _net(tmx, tllm, values, "float64", CPU)
    loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    xs, ys = _tokens()
    x, y = xs[0], ys[0]
    with tmx.autograd.record():
        loss = loss_fn(net(tmx.nd.array(x, dtype="int32", ctx=CPU)),
                       tmx.nd.array(y, ctx=CPU))
    loss.backward()
    grad = net.collect_params()["lm_embed_weight"].grad().asnumpy()
    w = torch.tensor(values["lm_embed_weight"], requires_grad=True)
    h = _hidden(net, x)
    logits = h @ w.T
    logp = torch.log_softmax(logits, -1)
    head = -logp.gather(-1, torch.tensor(y, dtype=torch.long)[..., None])
    head.squeeze(-1).mean(1).sum().backward()
    unread = sorted(set(range(CFG["vocab_size"])) - set(x.ravel().tolist()))
    assert unread
    _close(grad[unread], w.grad.numpy()[unread], what="rows no token reads")
    read = sorted(set(x.ravel().tolist()))
    assert np.abs(grad[read] - w.grad.numpy()[read]).max() > 1e-6


def _hidden(net, x):
    """The final LayerNorm's output of the port's net on tokens `x`, as a
    detached float64 tensor (the head's input)."""
    import torch
    seen = {}
    net.final_ln.register_forward_hook(
        lambda blk, inp, out: seen.setdefault("h", out.data.detach()))
    with tmx.autograd.pause():
        net(tmx.nd.array(x, dtype="int32", ctx=CPU))
    return seen["h"].to(torch.float64)


def test_gluon_lm_estimator_fused_matches_the_jax_plain_loop():
    """Estimator.fit over a loader of the same 3 batches: the fused
    gluon step takes every batch (the net has no Dropout), and the state
    after the fit equals the JAX plain loop's after 3 steps."""
    want = _plain(jmx, jllm, "float64")
    values = _values(CFG, np.float64)
    net = _net(tmx, tllm, values, "float64", CPU)
    trainer = tmx.gluon.Trainer(net.collect_params(), "sgd", dict(OPT))
    xs, ys = _tokens()
    loader = tmx.gluon.data.DataLoader(tmx.gluon.data.ArrayDataset(
        xs.reshape(-1, T), ys.reshape(-1, T)), batch_size=BATCH)
    est = tmx.gluon.contrib.estimator.Estimator(
        net, tmx.gluon.loss.SoftmaxCrossEntropyLoss(),
        train_metrics=[tmx.metric.Accuracy(axis=-1)], trainer=trainer,
        context=CPU)
    est.fit(loader, epochs=1, event_handlers=[])
    assert est._fused is not None and est._fused.steps == STEPS
    gp, gm = _state(net, trainer)
    wp, wm = want[-1][2]
    for n in wp:
        _close(gp[n], wp[n], what=n)
    for n in wm:
        _close(gm[n], wm[n], what=f"momentum {n}")


def _rel_l2(a, b):
    num = sum(float(((a[k] - b[k]) ** 2).sum()) for k in b)
    den = sum(float((b[k] ** 2).sum()) for k in b)
    return np.sqrt(num / den)


def test_gluon_lm_bf16_lane_trains_like_jax():
    """``param_dtype="bfloat16"``: both packages train the block in bf16
    (the loss falls); the port's parameters after 3 steps are as close to
    the JAX float32 run as the JAX bf16 run is, within BF16_FACTOR."""
    ref = _plain(jmx, jllm, "float32")[-1][2][0]
    jbf = _plain(jmx, jllm, "bfloat16")
    tbf = _plain(tmx, tllm, "bfloat16", CPU)
    for run in (jbf, tbf):
        assert run[-1][0].mean() < run[0][0].mean()
    tnet_dtype = tbf[-1][2][0]["lm_embed_weight"].dtype
    assert tnet_dtype == np.float64          # widened by `_state`
    j_dist = _rel_l2(jbf[-1][2][0], ref)
    t_dist = _rel_l2(tbf[-1][2][0], ref)
    assert 0 < j_dist and t_dist <= BF16_FACTOR * j_dist, (t_dist, j_dist)
