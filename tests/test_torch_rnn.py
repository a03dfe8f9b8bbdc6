"""Recurrent networks in the PyTorch port against the JAX package on the
CPU: the `RNN` op (four modes, one and two directions), the symbolic
cells of `rnn/`, `BucketSentenceIter`, `gluon.rnn` (cells and the fused
layers), `metric.Perplexity`, `initializer.LSTMBias`, `compat.weights`'
RNN helpers, and `clip` with and without bounds.

Mirrors `tests/test_rnn.py`, `tests/test_operator.py:254,276` and
`tests/test_gluon.py:177-215`, each case held to the JAX package on the
same numpy inputs and parameters.  On the CPU the port's `RNN` op runs
its plain loop (`ops.nn.rnn_plain`).

Tolerances: float32 through a few recurrent steps, rtol 1e-5 + 1e-6 *
max|ref|; fits of up to 96 steps, rtol 1e-4 + 1e-5 * max|ref|;
hybridized against eager in the port, the same ops in the same order,
exact.
"""
import random

import numpy as np
import pytest

import incubator_mxnet_tpu as jmx

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch.compat import weights

TOL = (1e-5, 1e-6)
FIT_TOL = (1e-4, 1e-5)
MODES = ["lstm", "gru", "rnn_tanh", "rnn_relu"]


def _close(got, want, tol=TOL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=tol[0],
                               atol=tol[1] * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _nd(pkg, v):
    return pkg.nd.array(v, ctx=pkg.cpu())


# -- the RNN op ----------------------------------------------------------------

def _rnn_case(mode, bidir, seed=0, T=5, B=3, I=4, H=6, L=2):
    from incubator_mxnet_tpu_torch.ops.nn import rnn_param_size
    rng = np.random.RandomState(seed)
    d = 2 if bidir else 1
    vals = {"data": rng.rand(T, B, I),
            "parameters": rng.uniform(-0.4, 0.4,
                                      rnn_param_size(mode, I, H, L, bidir)),
            "state": rng.rand(L * d, B, H) - 0.5}
    if mode == "lstm":
        vals["state_cell"] = rng.rand(L * d, B, H) - 0.5
    kw = dict(state_size=H, num_layers=L, mode=mode, bidirectional=bidir,
              state_outputs=True)
    return {k: v.astype("f4") for k, v in vals.items()}, kw


def _rnn_run(pkg, vals, kw):
    """Outputs of the RNN op and the gradients of sum(outputs) with
    respect to every input, recorded through autograd."""
    arrays = [_nd(pkg, vals[k]) for k in ("data", "parameters", "state",
                                         "state_cell") if k in vals]
    for a in arrays:
        a.attach_grad()
    with pkg.autograd.record():
        outs = pkg.nd.RNN(*arrays, **kw)
        total = sum(o.sum() for o in outs)
    total.backward()
    return [o.asnumpy() for o in outs], [a.grad.asnumpy() for a in arrays]


@pytest.mark.parametrize("bidir", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_rnn_op_and_its_gradients_match_jax(mode, bidir):
    vals, kw = _rnn_case(mode, bidir)
    outs, grads = _rnn_run(tmx, vals, kw)
    jouts, jgrads = _rnn_run(jmx, vals, kw)
    T, B = vals["data"].shape[:2]
    d = 2 if bidir else 1
    assert outs[0].shape == (T, B, d * 6)
    assert len(outs) == (3 if mode == "lstm" else 2)
    for a, b in zip(outs, jouts):
        _close(a, b)
    for a, b, name in zip(grads, jgrads, ("data", "parameters", "state",
                                          "state_cell")):
        _close(a, b, what=name)


def test_rnn_lstm_shapes():
    T, B, I, H, L = 5, 3, 4, 6, 2
    from incubator_mxnet_tpu_torch.ops.nn import rnn_param_size
    nd = tmx.nd
    for bidir in (False, True):
        d = 2 if bidir else 1
        out = nd.RNN(_nd(tmx, np.random.rand(T, B, I)),
                     _nd(tmx, np.random.rand(rnn_param_size("lstm", I, H, L,
                                                            bidir))),
                     nd.zeros((L * d, B, H), ctx=tmx.cpu()),
                     nd.zeros((L * d, B, H), ctx=tmx.cpu()), state_size=H,
                     num_layers=L, mode="lstm", bidirectional=bidir,
                     state_outputs=True)
        assert [o.shape for o in out] == [(T, B, d * H), (L * d, B, H),
                                          (L * d, B, H)]
    single = nd.RNN(_nd(tmx, np.random.rand(T, B, I)),
                    _nd(tmx, np.random.rand(rnn_param_size("gru", I, H, 1,
                                                           False))),
                    nd.zeros((1, B, H), ctx=tmx.cpu()), state_size=H,
                    num_layers=1, mode="gru")
    assert single.shape == (T, B, H)


def test_rnn_gru_matches_manual():
    """Single-layer GRU against a manual numpy step."""
    T, B, I, H = 3, 2, 4, 5
    from incubator_mxnet_tpu_torch.ops.nn import rnn_param_size
    rng = np.random.RandomState(3)
    flat = rng.uniform(-0.5, 0.5, rnn_param_size("gru", I, H, 1,
                                                 False)).astype("f4")
    data = rng.rand(T, B, I).astype("f4")
    out = tmx.nd.RNN(_nd(tmx, data), _nd(tmx, flat),
                     tmx.nd.zeros((1, B, H), ctx=tmx.cpu()), state_size=H,
                     num_layers=1, mode="gru")
    w = weights.rnn_unpack(flat, "gru", I, H, 1)
    h = np.zeros((B, H), dtype="f4")
    sig = lambda v: 1 / (1 + np.exp(-v))  # noqa: E731
    for t in range(T):
        xr, xz, xn = np.split(data[t] @ w["l0_i2h_weight"].T +
                              w["l0_i2h_bias"], 3, -1)
        hr, hz, hn = np.split(h @ w["l0_h2h_weight"].T + w["l0_h2h_bias"],
                              3, -1)
        r, z = sig(xr + hr), sig(xz + hz)
        h = (1 - z) * np.tanh(xn + r * hn) + z * h
    _close(out.asnumpy()[-1], h, (1e-4, 1e-5))


# -- rnn/: the symbolic cells and the iterator -------------------------------

def test_lstm_cell_unroll_shapes():
    for pkg in (tmx, jmx):
        cell = pkg.rnn.LSTMCell(16, prefix="l_")
        inputs = [pkg.sym.Variable(f"t{i}") for i in range(3)]
        outputs, states = cell.unroll(3, inputs)
        _, out_shapes, _ = pkg.sym.Group(outputs).infer_shape(
            **{f"t{i}": (2, 8) for i in range(3)})
        assert [tuple(s) for s in out_shapes] == [(2, 16)] * 3
        assert len(states) == 2


def _lm(pkg, cells, V, E, H, T):
    stack = pkg.rnn.SequentialRNNCell()
    for c in cells:
        stack.add(c)
    s = pkg.sym
    embed = s.Embedding(s.Variable("data"), input_dim=V, output_dim=E,
                        name="embed")
    outputs, _ = stack.unroll(T, inputs=embed, merge_outputs=True)
    pred = s.FullyConnected(s.Reshape(outputs, shape=(-1, H)),
                            num_hidden=V, name="pred")
    return s.SoftmaxOutput(pred, s.Reshape(s.Variable("softmax_label"),
                                           shape=(-1,)), name="softmax")


def test_stacked_cells_train_like_jax():
    """An LSTM and a GRU cell stacked, trained with Adam for 12 epochs:
    every batch's perplexity equal to the JAX package's, the final one
    better than uniform guessing."""
    V, E, H, T, B = 30, 8, 16, 6, 8
    rng = np.random.RandomState(0)
    X = rng.randint(0, V, (64, T)).astype("f4")
    Y = np.roll(X, -1, axis=1)
    curves, finals = {}, {}
    for name, pkg in (("port", tmx), ("jax", jmx)):
        net = _lm(pkg, [pkg.rnn.LSTMCell(H, prefix="lstm_l0_"),
                        pkg.rnn.GRUCell(H, prefix="gru_l1_")], V, E, H, T)
        pkg.random.seed(0)
        it = pkg.io.NDArrayIter(X, Y, batch_size=B)
        mod = pkg.mod.Module(net, context=pkg.cpu())
        vals = []
        mod.fit(it, num_epoch=12, optimizer="adam",
                eval_metric=pkg.metric.Perplexity(None),
                optimizer_params={"learning_rate": 0.01,
                                  "rescale_grad": 1.0 / (B * T)},
                batch_end_callback=lambda p: vals.append(
                    p.eval_metric.get()[1]))
        it.reset()
        curves[name] = vals
        finals[name] = dict(mod.score(it, pkg.metric.Perplexity(None)))[
            "perplexity"]
    _close(curves["port"], curves["jax"], FIT_TOL)
    _close(finals["port"], finals["jax"], FIT_TOL)
    assert finals["port"] < V * 0.8


def test_fused_cell_matches_its_unfused_stack_and_jax():
    """FusedRNNCell (the RNN op) on a flat vector == its `unfuse()`d
    stack of cells on `rnn_unpack`ed weights == the JAX fused cell."""
    N, T, C, H, L = 4, 5, 7, 12, 2
    rng = np.random.RandomState(5)
    x = rng.rand(N, T, C).astype("f4")
    from incubator_mxnet_tpu_torch.ops.nn import rnn_param_size
    flat = rng.uniform(-0.3, 0.3, rnn_param_size("lstm", C, H, L,
                                                 False)).astype("f4")
    got = {}
    for name, pkg in (("port", tmx), ("jax", jmx)):
        cell = pkg.rnn.FusedRNNCell(H, num_layers=L, mode="lstm",
                                    prefix="f_")
        outputs, _ = cell.unroll(T, inputs=pkg.sym.Variable("data"),
                                 layout="NTC", merge_outputs=True)
        _, shapes, _ = outputs.infer_shape(data=x.shape)
        assert tuple(shapes[0]) == (N, T, H)
        args = {"data": _nd(pkg, x), "f_parameters": _nd(pkg, flat),
                "f_begin_state_0": pkg.nd.zeros((L, N, H), ctx=pkg.cpu()),
                "f_begin_state_1": pkg.nd.zeros((L, N, H), ctx=pkg.cpu())}
        got[name] = outputs.bind(pkg.cpu(), args).forward()[0].asnumpy()
        stack = cell.unfuse()
        assert len(stack._cells) == L
    stack = tmx.rnn.FusedRNNCell(H, num_layers=L, mode="lstm",
                                 prefix="f_").unfuse()
    outs, _ = stack.unroll(T, inputs=tmx.sym.Variable("data"),
                           layout="NTC", merge_outputs=True)
    args = {"data": x}
    args.update(weights.rnn_unpack(flat, "lstm", C, H, L, prefix="f_"))
    for n in outs.list_arguments():
        if "begin_state" in n:
            args[n] = np.zeros((N, H), "f4")
    unfused = outs.bind(tmx.cpu(), {k: _nd(tmx, v) for k, v in
                                    args.items()}).forward()[0].asnumpy()
    _close(got["port"], got["jax"])
    _close(unfused, got["port"])
    np.testing.assert_array_equal(
        weights.rnn_pack(args, "lstm", C, H, L, prefix="f_"), flat)


def test_bucket_sentence_iter_matches_jax():
    """Under one seed the port's iterator yields the JAX package's
    batches, buckets and order, labels shifted left by one."""
    rng = np.random.RandomState(0)
    sentences = [list(rng.randint(1, 50, rng.randint(3, 20)))
                 for _ in range(200)]
    runs = {}
    for name, pkg in (("port", tmx), ("jax", jmx)):
        random.seed(1)
        np.random.seed(1)
        it = pkg.rnn.BucketSentenceIter(sentences, batch_size=8,
                                        buckets=[10, 20], invalid_label=0)
        assert it.default_bucket_key == 20
        batches = []
        for _epoch in range(2):
            for batch in it:
                data = batch.data[0].asnumpy()
                label = batch.label[0].asnumpy()
                assert data.shape == (8, batch.bucket_key)
                assert batch.provide_data[0].shape == data.shape
                np.testing.assert_array_equal(label[:, :-1], data[:, 1:])
                batches.append((batch.bucket_key, data, label))
            it.reset()
        runs[name] = batches
    assert len(runs["port"]) == len(runs["jax"]) > 0
    for (k, d, lab), (jk, jd, jlab) in zip(runs["port"], runs["jax"]):
        assert k == jk
        np.testing.assert_array_equal(d, jd)
        np.testing.assert_array_equal(lab, jlab)


def test_encode_sentences_matches_jax():
    sents = [["a", "b"], ["b", "c"], ["c", "d", "a"]]
    coded, vocab = tmx.rnn.encode_sentences(sents, start_label=1)
    jcoded, jvocab = jmx.rnn.encode_sentences(sents, start_label=1)
    assert coded == jcoded and vocab == jvocab
    assert coded[0][1] == coded[1][0]
    assert len(vocab) == 5
    with pytest.raises(tmx.MXNetError):
        tmx.rnn.encode_sentences([["z"]], vocab=dict(vocab))


# -- gluon.rnn -----------------------------------------------------------------

LAYERS = [("LSTM", dict(num_layers=2)), ("GRU", dict(bidirectional=True)),
          ("RNN", dict(activation="tanh")),
          ("RNN", dict(activation="relu", layout="NTC"))]


def _layer_pair(ctor, kw, input_size):
    t = getattr(tmx.gluon.rnn, ctor)(hidden_size=8, input_size=input_size,
                                     prefix="layer_", **kw)
    t.initialize(ctx=tmx.cpu())
    j = getattr(jmx.gluon.rnn, ctor)(hidden_size=8, input_size=input_size,
                                     prefix="layer_", **kw)
    j.initialize()
    weights.block_params_from_numpy(t, weights.block_params_to_numpy(j))
    return t, j


@pytest.mark.parametrize("ctor,kw", LAYERS)
def test_gluon_rnn_layers_match_jax(ctor, kw):
    """Outputs and states of the fused layers equal the JAX package's,
    with and without begin states; hybridized equals eager, gradients
    of every parameter included."""
    t, j = _layer_pair(ctor, kw, 6)
    x = np.random.RandomState(0).rand(5, 3, 6).astype("f4")
    out, jout = t(_nd(tmx, x)), j(_nd(jmx, x))
    _close(out.asnumpy(), jout.asnumpy())
    batch = x.shape[0 if kw.get("layout") == "NTC" else 1]
    states = [np.random.RandomState(i).rand(*s.shape).astype("f4")
              for i, s in enumerate(t.begin_state(batch_size=batch,
                                                  ctx=tmx.cpu()))]
    out, st = t(_nd(tmx, x), [_nd(tmx, s) for s in states])
    jout, jst = j(_nd(jmx, x), [_nd(jmx, s) for s in states])
    _close(out.asnumpy(), jout.asnumpy())
    for a, b in zip(st, jst):
        _close(a.asnumpy(), b.asnumpy())

    def run():
        xs = _nd(tmx, x)
        with tmx.autograd.record():
            o, s = t(xs, [_nd(tmx, v) for v in states])
            total = o.sum() + sum(v.sum() for v in s)
        total.backward()
        return [o.asnumpy()] + [p.grad().asnumpy().copy() for p in
                                t.collect_params().values()]

    eager = run()
    t.hybridize()
    hybrid = run()
    assert t._cached_graph is not None
    for a, b in zip(hybrid, eager):
        np.testing.assert_array_equal(a, b)


CELLS = [("LSTMCell", {}), ("GRUCell", {}), ("RNNCell", {}),
         ("RNNCell", {"activation": "relu"})]


@pytest.mark.parametrize("ctor,kw", CELLS)
def test_gluon_cells_unroll_like_jax(ctor, kw):
    """An eager unroll over NDArrays (outputs per step and final states)
    equals the JAX package's."""
    t = getattr(tmx.gluon.rnn, ctor)(8, input_size=5, prefix="cell_", **kw)
    j = getattr(jmx.gluon.rnn, ctor)(8, input_size=5, prefix="cell_", **kw)
    t.initialize(ctx=tmx.cpu())
    j.initialize()
    weights.block_params_from_numpy(t, weights.block_params_to_numpy(j))
    x = np.random.RandomState(1).rand(3, 6, 5).astype("f4")
    outs, st = t.unroll(6, _nd(tmx, x), layout="NTC")
    jouts, jst = j.unroll(6, _nd(jmx, x), layout="NTC")
    assert len(outs) == 6 and outs[0].shape == (3, 8)
    for a, b in zip(list(outs) + list(st), list(jouts) + list(jst)):
        _close(a.asnumpy(), b.asnumpy())


def _stacks(pkg):
    rnn = pkg.gluon.rnn
    seq = rnn.SequentialRNNCell(prefix="seq_")
    with seq.name_scope():
        seq.add(rnn.LSTMCell(8, input_size=10))
        seq.add(rnn.ResidualCell(rnn.GRUCell(8, input_size=8)))
        seq.add(rnn.DropoutCell(0.5))
        seq.add(rnn.ZoneoutCell(rnn.RNNCell(8, input_size=8), 0.3, 0.3))
    bi = rnn.BidirectionalCell(rnn.LSTMCell(4, input_size=10,
                                            prefix="bl_"),
                               rnn.GRUCell(4, input_size=10, prefix="br_"))
    return seq, bi


def test_gluon_stacked_and_bidirectional_cells_match_jax():
    """SequentialRNNCell over an LSTM, a residual GRU, dropout and a
    zoneout RNN cell (outside training: dropout and zoneout are the
    identity), and a bidirectional cell: every output and state equals
    the JAX package's."""
    x = np.random.RandomState(2).rand(2, 6, 10).astype("f4")
    got, cells = {}, {}
    for name, pkg in (("jax", jmx), ("port", tmx)):
        cells[name] = _stacks(pkg)
        for cell in cells[name]:
            cell.initialize(ctx=pkg.cpu())
        if pkg is tmx:     # the JAX cells' values, carried as numpy
            for cell, jcell in zip(cells["port"], cells["jax"]):
                weights.block_params_from_numpy(
                    cell, weights.block_params_to_numpy(jcell))
        got[name] = []
        for cell in cells[name]:
            outs, st = cell.unroll(6, _nd(pkg, x), layout="NTC",
                                   merge_outputs=True)
            got[name] += [outs.asnumpy()] + [v.asnumpy() for v in st]
    assert len(got["port"]) == len(got["jax"]) == 9
    for a, b in zip(got["port"], got["jax"]):
        _close(a, b)


# -- metric, initializer, clip ------------------------------------------------

@pytest.mark.parametrize("ignore_label", [None, 0])
def test_perplexity_matches_jax(ignore_label):
    rng = np.random.RandomState(4)
    batches = []
    for _ in range(3):
        logits = rng.rand(12, 7)
        probs = (np.exp(logits) / np.exp(logits).sum(1, keepdims=True))
        probs[0, 0] = 0.0          # clamped at 1e-10
        batches.append((rng.randint(0, 7, (3, 4)).astype("f4"),
                        probs.astype("f4")))
    vals = {}
    for name, pkg in (("port", tmx), ("jax", jmx)):
        m = pkg.metric.Perplexity(ignore_label)
        for lab, pred in batches:
            m.update([_nd(pkg, lab)], [_nd(pkg, pred)])
        vals[name] = m.get()
    assert vals["port"][0] == vals["jax"][0] == "perplexity"
    _close(vals["port"][1], vals["jax"][1])
    m = tmx.metric.create("perplexity", ignore_label)
    assert isinstance(m, tmx.metric.Perplexity)
    lab, pred = batches[0]
    m._accumulate(*m.device_update([_nd(tmx, lab)], [_nd(tmx, pred)]))
    ref = jmx.metric.Perplexity(ignore_label)
    ref.update([_nd(jmx, lab)], [_nd(jmx, pred)])
    _close(m.get()[1], ref.get()[1])


def test_lstm_bias_initializer_matches_jax():
    got = tmx.nd.zeros((24,), ctx=tmx.cpu())
    want = jmx.nd.zeros((24,))
    desc = '["lstmbias", {"forget_bias": 2.5}]'
    tmx.initializer.create(desc)._init_weight("b", got)
    jmx.initializer.create(desc)._init_weight("b", want)
    np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
    assert got.asnumpy()[6:12].tolist() == [2.5] * 6
    assert got.asnumpy().sum() == 15.0
    # through a cell's i2h_bias attribute, as a Module initializes it
    for pkg in (tmx, jmx):
        cell = pkg.rnn.LSTMCell(3, prefix="c_", forget_bias=1.5)
        out, _ = cell(pkg.sym.Variable("x"),
                      [pkg.sym.Variable("h"), pkg.sym.Variable("c")])
        attrs = out.attr_dict()["c_i2h_bias"]
        arr = pkg.nd.zeros((12,), ctx=pkg.cpu())
        pkg.initializer.Xavier()(
            pkg.initializer.InitDesc("c_i2h_bias", attrs), arr)
        assert arr.asnumpy()[3:6].tolist() == [1.5] * 3


@pytest.mark.parametrize("init", ["xavier", "uniform", "lstmbias"])
def test_initializers_on_rnn_parameters_match_jax(init):
    """A global initializer on FusedRNNCell's flat ``parameters`` (Xavier
    cannot take a vector: U(-0.07, 0.07) instead) and on a bias, drawn
    from one seed, bitwise as the JAX package draws them."""
    got = []
    for pkg in (tmx, jmx):
        make = {"xavier": lambda: pkg.initializer.Xavier(),
                "uniform": lambda: pkg.initializer.Uniform(0.2),
                "lstmbias": lambda: pkg.initializer.LSTMBias(2.0)}[init]
        pkg.random.seed(3)
        flat = pkg.nd.zeros((400,), ctx=pkg.cpu())
        bias = pkg.nd.zeros((16,), ctx=pkg.cpu())
        if init != "lstmbias":
            make()(pkg.initializer.InitDesc("lstm_parameters"), flat)
        make()(pkg.initializer.InitDesc("lstm_i2h_bias"), bias)
        got.append((flat.asnumpy(), bias.asnumpy()))
    for a, b in zip(*got):
        np.testing.assert_array_equal(a, b)
    assert init == "lstmbias" or np.abs(got[0][0]).max() > 0


@pytest.mark.parametrize("bounds", [(None, None), (-0.5, None),
                                    (None, 0.25), (-0.5, 0.25)])
def test_clip_matches_jax(bounds):
    """clip with neither bound returns its input, as the JAX op does."""
    x = np.random.RandomState(6).randn(4, 5).astype("f4")
    kw = {k: v for k, v in zip(("a_min", "a_max"), bounds) if v is not None}
    got = tmx.nd.clip(_nd(tmx, x), **kw).asnumpy()
    want = jmx.nd.clip(_nd(jmx, x), **kw).asnumpy()
    np.testing.assert_array_equal(got, want)
    if not kw:
        np.testing.assert_array_equal(got, x)
