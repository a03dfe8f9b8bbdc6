"""Control flow in the PyTorch port (`_foreach`, `_while_loop`, `_cond`,
`sym.contrib`, `nd.contrib`) against the JAX package on the CPU.

Mirrors `tests/test_control_flow.py` case by case, each case run in the
port and held to the JAX package on the same numpy inputs (graphs built
in the port and loaded into the JAX package from their JSON, so both
bind the same graph under the same names), plus JSON written by the JAX
package run in the port.  The JAX side runs `lax.scan`/`lax.cond`; the
port runs the body step by step.

Tolerances: float32 through a few steps, sums in other orders, rtol
1e-5 + 1e-6 * max|ref|; an LSTM fit of 12 steps, rtol 1e-4 + 1e-5 *
max|ref|.  Bodies carry no dropout: the packages draw other random
numbers (README "Declared divergences").
"""
import time

import numpy as np
import pytest

import incubator_mxnet_tpu as jmx

import incubator_mxnet_tpu_torch as tmx

TOL = (1e-5, 1e-6)
FIT_TOL = (1e-4, 1e-5)


def _close(got, want, tol=TOL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=tol[0],
                               atol=tol[1] * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _forward(sym, args, jax_too=True, is_train=False):
    """Outputs of `sym` (a port Symbol) bound on `args` in the port, and
    in the JAX package from its JSON."""
    t = sym.bind(tmx.cpu(), {k: tmx.nd.array(v, ctx=tmx.cpu())
                             for k, v in args.items()})
    outs = [o.asnumpy() for o in t.forward(is_train=is_train)]
    if not jax_too:
        return outs, None
    j = jmx.sym.load_json(sym.tojson()).bind(
        jmx.cpu(), {k: jmx.nd.array(v) for k, v in args.items()})
    return outs, [o.asnumpy() for o in j.forward(is_train=is_train)]


def _grads(sym, args, wrt, pkg):
    """Gradients of sum(sym) with respect to `wrt`, in `pkg` (tmx/jmx)."""
    ctx = pkg.cpu()
    arrays = {k: pkg.nd.array(v, ctx=ctx) for k, v in args.items()}
    grads = {k: pkg.nd.zeros(args[k].shape, ctx=ctx) for k in wrt}
    if pkg is jmx:
        sym = jmx.sym.load_json(sym.tojson())
    ex = sym.bind(ctx, arrays, args_grad=grads)
    ex.forward(is_train=True)
    ex.backward([pkg.nd.ones((), ctx=ctx)])
    return {k: ex.grad_dict[k].asnumpy() for k in wrt}


def _n_foreach(sym):
    return sum(1 for n in sym._topo()
               if not n.is_variable and n.op.name == "_foreach")


def test_foreach_symbolic_imperative_parity():
    s = tmx.sym
    data, init, w = s.Variable("data"), s.Variable("init"), s.Variable("w")

    def body(x, st):
        out = s.broadcast_add(s.broadcast_mul(x, w), st)
        return out, out

    outs, states = s.contrib.foreach(body, data, init)
    g = s.Group([outs, states])
    rng = np.random.RandomState(0)
    args = {"data": rng.rand(5, 4).astype("f4"),
            "init": rng.rand(4).astype("f4"), "w": rng.rand(4).astype("f4")}
    got, want = _forward(g, args)
    wa = tmx.nd.array(args["w"], ctx=tmx.cpu())
    io_, is_ = tmx.nd.contrib.foreach(
        lambda x, st: (x * wa + st, x * wa + st),
        tmx.nd.array(args["data"], ctx=tmx.cpu()),
        tmx.nd.array(args["init"], ctx=tmx.cpu()))
    for a, b, c in zip(got, want, (io_, is_)):
        _close(a, b)
        _close(c.asnumpy(), b)
    assert _n_foreach(g) == 1


def test_foreach_json_roundtrip():
    """A computed closure (w * 2) through the port's own JSON round
    trip, and the JAX package's reload of the port's JSON."""
    s = tmx.sym
    data, init, w = s.Variable("data"), s.Variable("init"), s.Variable("w")
    w2 = w * 2.0
    outs, _ = s.contrib.foreach(
        lambda x, st: (s.broadcast_add(s.broadcast_mul(x, w2), st),
                       st + 1.0), data, init)
    rng = np.random.RandomState(1)
    args = {"data": rng.rand(3, 4).astype("f4"),
            "init": rng.rand(4).astype("f4"), "w": rng.rand(4).astype("f4")}
    got, want = _forward(outs, args)
    again, _ = _forward(s.load_json(outs.tojson()), args, jax_too=False)
    _close(got[0], want[0])
    _close(again[0], got[0], (0, 0))


@pytest.mark.parametrize("kind", ["foreach", "while_loop", "cond"])
def test_jax_written_graph_runs_in_the_port(kind):
    """Control-flow JSON written by the JAX package loads and runs in the
    port with the JAX package's outputs."""
    j = jmx.sym
    rng = np.random.RandomState(7)
    if kind == "foreach":
        x, st, w = j.Variable("x"), j.Variable("st"), j.Variable("w")
        outs, fin = j.contrib.foreach(
            lambda d, s: (j.tanh(j.broadcast_mul(d, w) + s),
                          s * 0.5 + d), x, st)
        g = j.Group([outs, fin])
        args = {"x": rng.rand(6, 3), "st": rng.rand(3), "w": rng.rand(3)}
    elif kind == "while_loop":
        i, s_ = j.Variable("i"), j.Variable("s")
        outs, fin = j.contrib.while_loop(
            cond=lambda i, s: i < 4,
            func=lambda i, s: ([s * i], [i + 1, s + i]),
            loop_vars=[i, s_], max_iterations=7)
        g = j.Group(list(outs) + list(fin))
        args = {"i": np.array([0.0]), "s": rng.rand(1)}
    else:
        a, b = j.Variable("a"), j.Variable("b")
        g = j.contrib.cond(j.sum(a) > 1.0, lambda: a * b, lambda: a - b)
        args = {"a": rng.rand(3), "b": rng.rand(3)}
    args = {k: v.astype("f4") for k, v in args.items()}
    je = g.bind(jmx.cpu(), {k: jmx.nd.array(v) for k, v in args.items()})
    want = [o.asnumpy() for o in je.forward()]
    got, _ = _forward(tmx.sym.load_json(g.tojson()), args, jax_too=False)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        _close(a, b)


def test_foreach_gradient_matches_static_unroll():
    """d/d(w, data, init) through the loop == through T unrolled bodies,
    and == the JAX package's scan gradient."""
    T, C = 4, 3
    rng = np.random.RandomState(2)
    args = {"data": rng.rand(T, C).astype("f4"),
            "init": rng.rand(C).astype("f4"),
            "w": rng.rand(C).astype("f4")}
    s = tmx.sym

    def build_scan():
        data, init, w = s.Variable("data"), s.Variable("init"), \
            s.Variable("w")
        outs, _ = s.contrib.foreach(
            lambda x, st: (s.broadcast_mul(x, w) + st,
                           s.broadcast_mul(x, w) + st), data, init)
        return s.sum(outs)

    def build_unrolled():
        data, st, w = s.Variable("data"), s.Variable("init"), \
            s.Variable("w")
        outs = []
        for t in range(T):
            x = s.squeeze(s.slice_axis(data, axis=0, begin=t, end=t + 1),
                          axis=0)
            st = s.broadcast_mul(x, w) + st
            outs.append(st)
        return s.sum(s.stack(*outs, axis=0, num_args=T))

    wrt = ("w", "data", "init")
    scan = _grads(build_scan(), args, wrt, tmx)
    unrolled = _grads(build_unrolled(), args, wrt, tmx)
    jscan = _grads(build_scan(), args, wrt, jmx)
    for k in wrt:
        _close(scan[k], unrolled[k], what=k)
        _close(scan[k], jscan[k], what=k)


@pytest.mark.parametrize("start", [0.0, 7.0])
def test_while_loop_parity_and_padding(start):
    """Outputs padded to max_iterations with zeros (all of them when the
    condition fails at once), equal to the JAX package's and, over the
    steps run, to the imperative loop's."""
    s = tmx.sym
    i, st = s.Variable("i"), s.Variable("s")
    outs, fin = s.contrib.while_loop(
        cond=lambda i, s_: i < 5,
        func=lambda i, s_: ([i + s_], [i + 1, s_ + i]),
        loop_vars=[i, st], max_iterations=10)
    g = s.Group(list(outs) + list(fin))
    args = {"i": np.array([start], "f4"), "s": np.array([1.0], "f4")}
    got, want = _forward(g, args)
    assert got[0].shape == (10, 1)
    for a, b in zip(got, want):
        _close(a, b)
    io_, if_ = tmx.nd.contrib.while_loop(
        lambda i, s_: (i < 5), lambda i, s_: ([i + s_], [i + 1, s_ + i]),
        [tmx.nd.array(args["i"], ctx=tmx.cpu()),
         tmx.nd.array(args["s"], ctx=tmx.cpu())], max_iterations=10)
    n = io_[0].shape[0] if io_ else 0
    assert n == (5 if start == 0.0 else 0)
    if n:
        _close(got[0][:n], io_[0].asnumpy())
    np.testing.assert_array_equal(got[0][n:], 0.0)
    _close(got[1], if_[0].asnumpy())
    _close(got[2], if_[1].asnumpy())


def test_cond_both_branches():
    s = tmx.sym
    a, b = s.Variable("a"), s.Variable("b")
    out = s.contrib.cond(s.sum(a * b) < 5, lambda: (a + 5) * (b + 5),
                         lambda: (a - 5) * (b - 5))
    for av, bv, want in [(1.0, 2.0, 42.0), (3.0, 4.0, 2.0)]:
        args = {"a": np.array([av], "f4"), "b": np.array([bv], "f4")}
        got, jgot = _forward(out, args)
        _close(got[0], [want])
        _close(got[0], jgot[0])
        nd = tmx.nd
        ta = nd.array([av], ctx=tmx.cpu())
        tb = nd.array([bv], ctx=tmx.cpu())
        imp = nd.contrib.cond(nd.sum(ta * tb) < 5,
                              lambda: (ta + 5) * (tb + 5),
                              lambda: (ta - 5) * (tb - 5))
        _close(imp.asnumpy(), got[0])


def test_cond_gradient_matches_jax():
    """The gradient flows through the branch that ran, on either side."""
    s = tmx.sym
    a, b = s.Variable("a"), s.Variable("b")
    out = s.sum(s.contrib.cond(s.sum(a) > 1.0, lambda: s.exp(a) * b,
                               lambda: a * a - b))
    for av in ([0.1, 0.2, 0.3], [0.5, 0.7, 0.9]):
        args = {"a": np.array(av, "f4"), "b": np.array([1.0, 2.0, 3.0],
                                                       "f4")}
        got = _grads(out, args, ("a", "b"), tmx)
        want = _grads(out, args, ("a", "b"), jmx)
        for k in got:
            _close(got[k], want[k], what=k)


def _cell_args(cell, syms, vals):
    params = {k: v.data().asnumpy()
              for k, v in cell.collect_params().items()}
    args = dict(vals)
    for sym in syms:
        for name in sym.list_arguments():
            if name in params:
                args[name] = params[name]
    return args


def test_cell_unroll_emits_one_foreach():
    """A gluon LSTM cell unrolled over a symbolic sequence is ONE
    `_foreach`, equal to the classic static unroll and to the JAX
    package's scan."""
    T, N, C, H = 5, 2, 3, 4
    cell = tmx.gluon.rnn.LSTMCell(H, input_size=C, prefix="lstm_")
    cell.initialize(ctx=tmx.cpu())
    s = tmx.sym
    data = s.Variable("data")
    begin = [s.Variable("h0"), s.Variable("c0")]
    out_scan, st_scan = cell.unroll(T, data, begin_state=begin,
                                    layout="NTC", merge_outputs=True)
    g_scan = s.Group([out_scan] + list(st_scan))
    assert _n_foreach(g_scan) == 1
    slices = list(s.split(data, num_outputs=T, axis=1, squeeze_axis=True))
    out_st, st_st = cell.unroll(T, slices, begin_state=begin, layout="NTC",
                                merge_outputs=True)
    g_st = s.Group([out_st] + list(st_st))
    rng = np.random.RandomState(3)
    vals = {"data": rng.rand(N, T, C).astype("f4"),
            "h0": rng.rand(N, H).astype("f4"),
            "c0": rng.rand(N, H).astype("f4")}
    args = _cell_args(cell, (g_scan, g_st), vals)
    scan, jscan = _forward(g_scan, {k: args[k] for k in
                                    g_scan.list_arguments()})
    static, _ = _forward(g_st, {k: args[k] for k in g_st.list_arguments()},
                         jax_too=False)
    for a, b, c in zip(scan, static, jscan):
        _close(a, b)
        _close(a, c)


def test_foreach_multi_data_multi_state():
    s = tmx.sym
    d1, d2, s1, s2 = (s.Variable(n) for n in ("d1", "d2", "s1", "s2"))

    def body(xs, ss):
        a, b = xs
        u, v = ss
        return [a + u, b * v], [u + 1.0, v * 2.0]

    outs, states = s.contrib.foreach(body, [d1, d2], [s1, s2])
    g = s.Group(list(outs) + list(states))
    rng = np.random.RandomState(4)
    args = {"d1": rng.rand(3, 2).astype("f4"),
            "d2": rng.rand(3, 2).astype("f4"),
            "s1": rng.rand(2).astype("f4"), "s2": rng.rand(2).astype("f4")}
    got, want = _forward(g, args)
    nd = {k: tmx.nd.array(v, ctx=tmx.cpu()) for k, v in args.items()}
    io_, is_ = tmx.nd.contrib.foreach(
        lambda xs, ss: ([xs[0] + ss[0], xs[1] * ss[1]],
                        [ss[0] + 1.0, ss[1] * 2.0]),
        [nd["d1"], nd["d2"]], [nd["s1"], nd["s2"]])
    for a, b, c in zip(got, want, list(io_) + list(is_)):
        _close(a, b)
        _close(c.asnumpy(), b)


def test_unroll_honors_length():
    """unroll(length=3) over a T=5 symbolic sequence computes exactly 3
    steps, as in the JAX package."""
    T_data, T_req, N, C, H = 5, 3, 2, 3, 4
    cell = tmx.gluon.rnn.LSTMCell(H, input_size=C, prefix="lstm_")
    cell.initialize(ctx=tmx.cpu())
    s = tmx.sym
    begin = [s.Variable("h0"), s.Variable("c0")]
    outs, _ = cell.unroll(T_req, s.Variable("data"), begin_state=begin,
                          layout="NTC", merge_outputs=True)
    rng = np.random.RandomState(0)
    vals = {"data": rng.rand(N, T_data, C).astype("f4"),
            "h0": np.zeros((N, H), "f4"), "c0": np.zeros((N, H), "f4")}
    got, want = _forward(outs, _cell_args(cell, (outs,), vals))
    assert got[0].shape == (N, T_req, H)
    _close(got[0], want[0])


def test_while_loop_gradient_not_poisoned_past_termination():
    """sqrt(x - i) is NaN past termination: `func` must not run there."""
    s = tmx.sym
    x, i = s.Variable("x"), s.Variable("i")
    outs, _ = s.contrib.while_loop(
        cond=lambda i, x: i < 3,
        func=lambda i, x: ([s.sqrt(x - i)], [i + 1, x]),
        loop_vars=[i, x], max_iterations=8)
    loss = s.sum(outs[0])
    args = {"i": np.array([0.0], "f4"), "x": np.array([3.5], "f4")}
    g = _grads(loss, args, ("x",), tmx)["x"]
    assert np.isfinite(g).all(), g
    want = sum(0.5 / np.sqrt(3.5 - t) for t in range(3))
    _close(g, [want])
    _close(g, _grads(loss, args, ("x",), jmx)["x"])


def test_foreach_lstm_module_fit_fused():
    """The lstm_bucketing shape end to end: a Module whose graph holds ONE
    _foreach trains through the port's fused step, loss for loss with
    the JAX package's per-batch fit."""
    vocab, embed, hidden, seq, bs = 40, 8, 16, 6, 8

    def net(pkg):
        stack = pkg.rnn.SequentialRNNCell()
        stack.add(pkg.rnn.LSTMCell(hidden, prefix="lstm_l0_"))
        s = pkg.sym
        emb = s.Embedding(s.Variable("data"), input_dim=vocab,
                          output_dim=embed, name="embed")
        stack.reset()
        outputs, _ = stack.unroll(seq, inputs=emb, merge_outputs=True)
        pred = s.FullyConnected(s.Reshape(outputs, shape=(-1, hidden)),
                                num_hidden=vocab, name="pred")
        return s.SoftmaxOutput(
            pred, s.Reshape(s.Variable("softmax_label"), shape=(-1,)),
            name="softmax")

    rng = np.random.RandomState(0)
    tokens = rng.randint(1, vocab, (64, seq)).astype("f4")
    labels = np.roll(tokens, -1, 1)
    losses = {}
    for name, pkg in (("port", tmx), ("jax", jmx)):
        sym = net(pkg)
        assert _n_foreach(sym) == 1
        pkg.random.seed(0)
        it = pkg.io.NDArrayIter({"data": tokens},
                                {"softmax_label": labels}, batch_size=bs)
        mod = pkg.mod.Module(sym, context=pkg.cpu())
        vals = []
        mod.fit(it, num_epoch=3, optimizer="sgd",
                optimizer_params={"learning_rate": 0.5,
                                  "rescale_grad": 1.0 / bs},
                eval_metric=pkg.metric.Perplexity(0),
                initializer=pkg.initializer.Xavier(),
                batch_end_callback=lambda p: vals.append(
                    p.eval_metric.get()[1]), kvstore=None)
        losses[name] = vals
        if pkg is tmx:
            assert mod._fused_step.steps == 24
    _close(losses["port"], losses["jax"], FIT_TOL)
    assert losses["port"][-1] < losses["port"][0]


def test_while_loop_early_termination_cost():
    """With no per-step outputs the loop stops at the first false
    condition: 5,000,000 max_iterations cost what 100 do."""
    def run(pkg, max_iter):
        t0 = time.perf_counter()
        ctx = pkg.cpu()
        outs, fin = pkg.nd.contrib.while_loop(
            lambda i, s_: i < 5, lambda i, s_: ([], [i + 1, s_ + i]),
            [pkg.nd.array([0.0], ctx=ctx), pkg.nd.array([1.0], ctx=ctx)],
            max_iterations=max_iter)
        assert outs == []
        _close(fin[0].asnumpy(), [5.0])
        _close(fin[1].asnumpy(), [11.0])
        return time.perf_counter() - t0

    run(tmx, 100)
    t_small = run(tmx, 100)
    t_big = run(tmx, 5_000_000)
    assert t_big < max(50 * t_small, 2.0), (t_small, t_big)
    # the symbolic op in inference, no per-step outputs
    s = tmx.sym
    i, st = s.Variable("i"), s.Variable("s")
    _, fin = s.contrib.while_loop(
        cond=lambda i, s_: i < 5, func=lambda i, s_: ([], [i + 1, s_ + i]),
        loop_vars=[i, st], max_iterations=5_000_000)
    args = {"i": np.array([0.0], "f4"), "s": np.array([1.0], "f4")}
    t0 = time.perf_counter()
    got, _ = _forward(s.Group(list(fin)), args, jax_too=False)
    assert time.perf_counter() - t0 < 2.0
    _close(got[0], [5.0])
    _close(got[1], [11.0])


def test_while_loop_fast_path_matches_masked_scan():
    """No-output and output-carrying loops end in the same variables, in
    the port and in the JAX package."""
    cond = lambda i, s_: i < 7  # noqa: E731
    body_out = lambda i, s_: ([i * s_], [i + 1, s_ + i])  # noqa: E731
    body_noout = lambda i, s_: ([], [i + 1, s_ + i])  # noqa: E731
    results = []
    for pkg in (tmx, jmx):
        for body in (body_noout, body_out):
            init = [pkg.nd.array([0.0], ctx=pkg.cpu()),
                    pkg.nd.array([2.0], ctx=pkg.cpu())]
            _, fin = pkg.nd.contrib.while_loop(cond, body, init,
                                               max_iterations=64)
            results.append([f.asnumpy() for f in fin])
    for r in results[1:]:
        for a, b in zip(r, results[0]):
            _close(a, b)


def test_foreach_duplicate_closure_names_bind_correctly():
    """Two distinct outer Variables sharing one NAME each bind their own
    closure slot, before and after the JSON round trip."""
    import torch
    from incubator_mxnet_tpu_torch.symbol.symbol import graph_eval_fn
    s = tmx.sym
    data, init = s.Variable("data"), s.Variable("init")
    w1, w2 = s.Variable("w"), s.Variable("w")

    def body(x, st):
        y = s.broadcast_add(s.broadcast_mul(x, w1), s.broadcast_mul(st, w2))
        return y, st + 1.0

    outs, _ = s.contrib.foreach(body, data, init)
    rng = np.random.RandomState(3)
    dnp, inp = rng.rand(4, 3).astype("f4"), rng.rand(3).astype("f4")
    w1v, w2v = rng.rand(3).astype("f4"), rng.rand(3).astype("f4")
    st = inp.copy()
    want = np.zeros_like(dnp)
    for t in range(dnp.shape[0]):
        want[t] = dnp[t] * w1v + st * w2v
        st = st + 1.0
    for sym in (outs, s.load_json(outs.tojson())):
        gfn, arg_nodes, _ = graph_eval_fn(sym, False)
        assert [n.name for n in arg_nodes].count("w") == 2
        by_pos = {"data": dnp, "init": inp}
        w_feed = [w1v, w2v]
        vals = [torch.from_numpy(by_pos[n.name] if n.name in by_pos
                                 else w_feed.pop(0)) for n in arg_nodes]
        (ys,), _ = gfn(vals, [])
        _close(ys.numpy(), want)
