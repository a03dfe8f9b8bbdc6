"""The training API's stragglers in the PyTorch port against the JAX
package, on the CPU: `io.pad_to_bucket` and the ragged-tail `predict`,
`callback.ProgressBar` and `callback.elastic_checkpoint`,
`model.FeedForward`, the `test_utils` checks, `state_names` in `Module`
and `BucketingModule`, and `BucketingModule.fit(checkpoint_dir=,
resume=)`.

Tolerances: one forward or one step, float32 sums in other orders, rtol
1e-5 + 1e-6 * max|ref|; a fit of tens of momentum-SGD steps, rtol 1e-4 +
1e-5 * max|ref|; a resumed fit against the uninterrupted one in the same
package, bit for bit.
"""
import hashlib
import logging
import random

import numpy as np
import pytest

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import test_utils as jtu

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import test_utils as ttu
from incubator_mxnet_tpu_torch.compat import weights

TOL = (1e-5, 1e-6)
FIT_TOL = (1e-4, 1e-5)


def _close(got, want, tol=TOL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=tol[0],
                               atol=tol[1] * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _mlp(pkg, hidden=16, classes=3, act="relu"):
    s = pkg.sym
    net = s.FullyConnected(s.Variable("data"), num_hidden=hidden, name="fc1")
    net = s.Activation(net, act_type=act, name="relu1")
    net = s.FullyConnected(net, num_hidden=classes, name="fc2")
    return s.SoftmaxOutput(net, name="softmax")


def _data(n=96, dim=8, classes=3):
    """`tests/test_model_config.py:20`'s separable data."""
    rng = np.random.RandomState(0)
    x = rng.randn(n, dim).astype("f4")
    w = rng.randn(dim, classes).astype("f4")
    return x, (x @ w).argmax(1).astype("f4")


# -- pad_to_bucket and the ragged tail ----------------------------------------

def test_pad_to_bucket_helper_like_jax():
    """`tests/test_serving.py:307` in both packages."""
    x = np.arange(18, dtype=np.float32).reshape(3, 6)
    for pkg in (tmx, jmx):
        io = pkg.io
        b = io.DataBatch(data=[pkg.nd.array(x, ctx=pkg.cpu())],
                         label=[pkg.nd.zeros((3,), ctx=pkg.cpu())])
        padded = b.pad_to_bucket((4, 8))
        assert padded.data[0].shape == (4, 6)
        assert padded.label[0].shape == (4,)
        assert padded.pad == 1 and b.pad is None
        np.testing.assert_array_equal(padded.data[0].asnumpy()[3], x[2])
        b4 = io.DataBatch(data=[pkg.nd.zeros((4, 6), ctx=pkg.cpu())])
        assert io.pad_to_bucket(b4, (4, 8)) is b4
        b9 = io.DataBatch(data=[pkg.nd.zeros((9, 6), ctx=pkg.cpu())])
        assert io.pad_to_bucket(b9, (4, 8)) is b9
    got = tmx.io.pad_to_bucket(tmx.io.DataBatch(data=[x], pad=2), (5,))
    assert got.pad == 4 and got.data[0].shape == (5, 6)
    np.testing.assert_array_equal(got.data[0][3:], [x[2], x[2]])


class _Ragged:
    """`tests/test_serving.py:324`'s iterator: full batches, then a
    ragged tail."""

    def __init__(self, pkg, x, y, batch_size):
        self.pkg, self.x, self.y = pkg, x, y
        self.batch_size = batch_size
        self._cur = 0

    def reset(self):
        self._cur = 0

    def __iter__(self):
        return self

    def __next__(self):
        if self._cur >= len(self.x):
            raise StopIteration
        lo, hi = self._cur, min(self._cur + self.batch_size, len(self.x))
        self._cur = hi
        nd, ctx = self.pkg.nd, self.pkg.cpu()
        return self.pkg.io.DataBatch(data=[nd.array(self.x[lo:hi], ctx=ctx)],
                                     label=[nd.array(self.y[lo:hi], ctx=ctx)])


def _bound(pkg, batch=4):
    mod = pkg.mod.Module(_mlp(pkg), context=pkg.cpu())
    mod.bind([("data", (batch, 6))], [("softmax_label", (batch,))],
             for_training=False)
    pkg.random.seed(0)
    mod.init_params(pkg.initializer.Xavier())
    return mod


def test_predict_pads_ragged_tail_to_bound_batch_like_jax():
    """`tests/test_serving.py:340`: 10 rows in batches of 4; the tail of
    2 runs padded on the bound executor and is sliced back."""
    x = np.random.RandomState(1).randn(10, 6).astype("f4")
    y = np.zeros(10, "f4")
    mod, jmod = _bound(tmx), _bound(jmx)
    exe = mod._exec_group.execs[0]
    out = mod.predict(_Ragged(tmx, x, y, 4))
    assert out.shape == (10, 3)
    assert exe.arg_dict["data"].shape == (4, 6)   # never rebound
    _close(out.asnumpy(), jmod.predict(_Ragged(jmx, x, y, 4)).asnumpy())
    rows = np.concatenate([mod.predict(x[i:i + 1]).asnumpy()
                           for i in range(10)])
    _close(out.asnumpy(), rows)
    outs = [o[0].shape[0] for o, _, _ in
            mod.iter_predict(_Ragged(tmx, x, y, 4))]
    assert outs == [4, 4, 2]


# -- callbacks ----------------------------------------------------------------

def test_progress_bar_logs_like_jax(caplog):
    lines = {}
    for name, pkg in (("port", tmx), ("jax", jmx)):
        caplog.clear()
        bar = pkg.callback.ProgressBar(total=7, length=20)
        with caplog.at_level(logging.INFO):
            for i in range(8):
                bar(pkg.model.BatchEndParam(epoch=0, nbatch=i,
                                            eval_metric=None, locals=None))
        lines[name] = [r.getMessage() for r in caplog.records]
    assert lines["port"] == lines["jax"] and len(lines["port"]) == 8
    assert lines["port"][-1] == "[" + "=" * 20 + "] 100%\r"


def _loop_with_callback(pkg, root, steps=6, period=2):
    """A custom loop of `fit_step` with `elastic_checkpoint` as the
    batch-end callback; returns the module and its parameters after
    each step."""
    x, y = _data(48, 6)
    np.random.seed(0)
    it = pkg.io.NDArrayIter(x, y, batch_size=8, shuffle=True)
    mod = pkg.mod.Module(_mlp(pkg), context=pkg.cpu())
    mod.bind(it.provide_data, it.provide_label)
    pkg.random.seed(0)
    mod.init_params(pkg.initializer.Xavier())
    mod.init_optimizer(optimizer_params={"learning_rate": 0.1,
                                         "momentum": 0.9})
    mgr = pkg.checkpoint.CheckpointManager(root, async_snapshots=True)
    cb = pkg.callback.elastic_checkpoint(mgr, mod, it, period=period)
    metric = pkg.metric.create("acc")
    params = []
    for nbatch in range(steps):
        batch = it.next()
        mod.fit_step(batch, metric)
        cb(pkg.model.BatchEndParam(epoch=0, nbatch=nbatch,
                                   eval_metric=metric, locals=None))
        params.append({k: v.asnumpy() for k, v in
                       mod.get_params()[0].items()})
    mgr.flush()
    mgr.close()
    return mod, params


def test_elastic_checkpoint_drives_fit_step(tmp_path):
    """Snapshots every 2 steps of a `fit_step` loop hold that step's
    parameters, momenta and position; the JAX callback's loop takes the
    same steps and its snapshots hold the same arrays."""
    from incubator_mxnet_tpu_torch import checkpoint as ckpt
    mod, params = _loop_with_callback(tmx, str(tmp_path / "port"))
    _, jparams = _loop_with_callback(jmx, str(tmp_path / "jax"))
    steps = [s for s, _ in ckpt.manifest.list_checkpoints(
        str(tmp_path / "port"))]
    assert steps == [2, 4, 6]
    last = ckpt.load(ckpt.latest(str(tmp_path / "port")))
    assert (last.step, last.epoch, last.nbatch) == (6, 0, 6)
    for k, v in params[-1].items():
        np.testing.assert_array_equal(last.arrays[f"arg:{k}"], v)
        _close(v, jparams[-1][k], TOL, k)
    jlast = jmx.checkpoint.load(jmx.checkpoint.latest(str(tmp_path / "jax")))
    for k in params[-1]:
        _close(last.arrays[f"arg:{k}"], jlast.arrays[f"arg:{k}"], TOL, k)
    # the optimizer's states travel too: a module restored from the
    # snapshot takes the next step as the original does
    fresh = tmx.mod.Module(_mlp(tmx), context=tmx.cpu())
    fresh.bind(mod._data_shapes, mod._label_shapes)
    arg, aux = ckpt.state.split_params(last.arrays)
    fresh.init_params(arg_params=arg, aux_params=aux)
    fresh.init_optimizer(optimizer_params={"learning_rate": 0.1,
                                           "momentum": 0.9})
    fresh.set_optimizer_states_blob(last.blobs["optimizer"])
    for i, s in mod._updater.states.items():
        np.testing.assert_array_equal(fresh._updater.states[i].asnumpy(),
                                      s.asnumpy())


# -- FeedForward --------------------------------------------------------------

def _feedforward(pkg, **kw):
    x, y = _data()
    np.random.seed(0)
    pkg.random.seed(0)
    model = pkg.model.FeedForward(_mlp(pkg), ctx=pkg.cpu(), num_epoch=12,
                                  optimizer="sgd", learning_rate=0.5,
                                  rescale_grad=1.0 / 32,
                                  numpy_batch_size=32, **kw)
    model.fit(x, y)
    return model, x, y


def test_feedforward_fit_predict_score_like_jax():
    """`tests/test_model_config.py:31-45`: fit, predict and score in
    both packages from the same initial parameters and batch order."""
    model, x, y = _feedforward(tmx)
    jmodel, _, _ = _feedforward(jmx)
    preds = model.predict(x)
    assert preds.shape == (96, 3)
    assert (preds.argmax(1) == y).mean() > 0.8
    _close(preds, jmodel.predict(x), FIT_TOL)
    for k, v in jmodel.arg_params.items():
        _close(model.arg_params[k].asnumpy(), v.asnumpy(), FIT_TOL, k)
    acc = model.score(tmx.io.NDArrayIter(x, y, batch_size=32))
    _close(acc, jmodel.score(jmx.io.NDArrayIter(x, y, batch_size=32)))
    assert acc > 0.8


def test_feedforward_save_load_create_and_ragged_predict(tmp_path):
    model, x, y = _feedforward(tmx)
    preds = model.predict(x)
    prefix = str(tmp_path / "ff")
    model.save(prefix, 12)
    loaded = tmx.model.FeedForward.load(prefix, 12, ctx=tmx.cpu(),
                                        numpy_batch_size=32)
    np.testing.assert_array_equal(loaded.predict(x), preds)
    # 90 rows in batches of 32: a ragged tail of 26, row by row equal
    ragged = loaded.predict(x[:90])
    assert ragged.shape == (90, 3)
    _close(ragged, np.concatenate([loaded._module.predict(x[i:i + 1])
                                   .asnumpy() for i in range(90)]))
    # the JAX FeedForward loads what the port saved and predicts alike
    jloaded = jmx.model.FeedForward.load(prefix, 12, ctx=jmx.cpu(),
                                         numpy_batch_size=32)
    _close(ragged, jloaded.predict(x[:90]))
    tmx.random.seed(1)
    m2 = tmx.model.FeedForward.create(_mlp(tmx), x, y, ctx=tmx.cpu(),
                                      num_epoch=5, learning_rate=0.5,
                                      rescale_grad=1.0 / 32)
    assert sorted(m2.arg_params) == sorted(model.arg_params)
    assert tmx.model.FeedForward(_mlp(tmx)).ctx == [tmx.gpu(0)]


def test_feedforward_predicts_fewer_rows_than_its_batch():
    """A dataset smaller than ``numpy_batch_size``: NDArrayIter fills the
    batch cyclically (pad = the rows it added) and predict returns every
    row (the JAX iterator wraps once, so its batch is short and predict
    returns no row; ROADMAP.md Queue 3)."""
    it = tmx.io.NDArrayIter(np.arange(6, dtype="f4").reshape(3, 2),
                            np.arange(3, dtype="f4"), batch_size=8)
    batch = it.next()
    assert batch.data[0].shape == (8, 2) and batch.pad == 5
    np.testing.assert_array_equal(batch.label[0].asnumpy(),
                                  [0, 1, 2, 0, 1, 2, 0, 1])
    model, x, _ = _feedforward(tmx)
    few = model.predict(x[:3])
    assert few.shape == (3, 3)
    _close(few, model.predict(x)[:3])


# -- test_utils ---------------------------------------------------------------

def _fc(pkg):
    return pkg.sym.FullyConnected(pkg.sym.Variable("data"), num_hidden=3,
                                  name="fc")


def _conv(pkg):
    return pkg.sym.Convolution(pkg.sym.Variable("data"), kernel=(3, 3),
                               num_filter=2, name="cv")


def _softmax(pkg):
    return pkg.sym.SoftmaxOutput(pkg.sym.Variable("data"),
                                 pkg.sym.Variable("softmax_label"),
                                 name="sm")


def _blockgrad(pkg):
    """A deliberately wrong gradient: BlockGrad passes its input on and
    reports a zero gradient."""
    return pkg.sym.BlockGrad(pkg.sym.Variable("data") * 2.0)


def _locations():
    rng = np.random.RandomState(0)
    return {
        "fc": {"data": rng.randn(2, 4), "fc_weight": rng.randn(3, 4),
               "fc_bias": rng.randn(3)},
        "conv": {"data": rng.randn(1, 2, 5, 5),
                 "cv_weight": rng.randn(2, 2, 3, 3), "cv_bias": rng.randn(2)},
        "softmax": {"data": rng.randn(3, 4),
                    "softmax_label": np.array([0.0, 1.0, 3.0])},
        "blockgrad": {"data": rng.randn(2, 3)},
    }


@pytest.mark.parametrize("name,build,passes", [
    ("fc", _fc, True), ("conv", _conv, True),
    ("softmax", _softmax, False), ("blockgrad", _blockgrad, False)])
def test_check_numeric_gradient_verdicts_like_jax(name, build, passes):
    """FullyConnected and Convolution pass; SoftmaxOutput (its implicit
    gradient p - onehot is not the derivative of its output) and
    BlockGrad are rejected, by both packages."""
    loc = _locations()[name]
    nodes = ["data"] if name in ("softmax", "blockgrad") else None
    verdicts = []
    for pkg, tu in ((tmx, ttu), (jmx, jtu)):
        try:
            tu.check_numeric_gradient(build(pkg), loc, grad_nodes=nodes,
                                      ctx=pkg.cpu())
            verdicts.append(True)
        except AssertionError:
            verdicts.append(False)
    assert verdicts == [passes, passes]


def test_check_symbolic_forward_backward_like_jax():
    rng = np.random.RandomState(1)
    loc = {"data": rng.randn(2, 4).astype("f4"),
           "fc_weight": rng.randn(3, 4).astype("f4"),
           "fc_bias": rng.randn(3).astype("f4")}
    want = loc["data"] @ loc["fc_weight"].T + loc["fc_bias"]
    for pkg, tu in ((tmx, ttu), (jmx, jtu)):
        got = tu.check_symbolic_forward(_fc(pkg), loc, [want], rtol=1e-5,
                                        atol=1e-5, ctx=pkg.cpu())
        _close(got[0], want)
        with pytest.raises(AssertionError):
            tu.check_symbolic_forward(_fc(pkg), loc, [want + 1e-3],
                                      rtol=1e-5, atol=1e-5, ctx=pkg.cpu())
    og = rng.randn(2, 3).astype("f4")
    expected = {"data": og @ loc["fc_weight"],
                "fc_weight": og.T @ loc["data"], "fc_bias": og.sum(0)}
    for pkg, tu in ((tmx, ttu), (jmx, jtu)):
        grads = tu.check_symbolic_backward(_fc(pkg), loc, [og], expected,
                                           rtol=1e-5, atol=1e-5,
                                           ctx=pkg.cpu())
        assert sorted(grads) == sorted(expected)
        wrong = dict(expected, fc_bias=expected["fc_bias"] + 1e-2)
        with pytest.raises(AssertionError):
            tu.check_symbolic_backward(_fc(pkg), loc, [og], wrong,
                                       rtol=1e-5, atol=1e-5, ctx=pkg.cpu())


def test_check_consistency_like_jax():
    """Two CPU configurations of the mlp (float64 the ground truth),
    the same normal(0, 1) inputs from seed 0 in both packages: every
    output equal to the JAX function's."""
    labels = {"softmax_label": np.array([0.0, 2.0, 1.0, 2.0])}
    outs = []
    for pkg, tu in ((tmx, ttu), (jmx, jtu)):
        ctx_list = [{"ctx": pkg.cpu(0), "data": (4, 5),
                     "type_dict": {"data": np.float32}},
                    {"ctx": pkg.cpu(1), "data": (4, 5),
                     "type_dict": {n: np.float64 for n in
                                   _mlp(pkg).list_arguments()}}]
        outs.append(tu.check_consistency(_mlp(pkg), ctx_list,
                                         arg_params=labels))
    for got, want in zip(outs[0], outs[1]):
        _close(got[0], want[0])
    assert outs[0][1][0].dtype == np.float64
    bad = [{"ctx": tmx.cpu(0), "data": (4, 5)},
           {"ctx": tmx.cpu(1), "data": (4, 5)}]
    with pytest.raises(AssertionError):
        ttu.check_consistency([_mlp(tmx), _mlp(tmx, act="tanh")], bad)


def test_default_context_is_the_card():
    assert ttu.default_context() == tmx.gpu(0)
    ttu.set_default_context(tmx.cpu())
    try:
        assert ttu.default_context() == tmx.cpu()
    finally:
        ttu.set_default_context(None)
    assert ttu.almost_equal(np.ones(3), np.ones(3) + 1e-9)
    assert ttu.same(tmx.nd.ones((2,), ctx=tmx.cpu()), np.ones(2))


# -- state_names --------------------------------------------------------------

def _state_net(pkg):
    s = pkg.sym
    h = s.FullyConnected(s.Variable("data"), num_hidden=5, name="fc1") + \
        s.Variable("state", shape=(4, 5))
    return s.SoftmaxOutput(s.FullyConnected(s.tanh(h), num_hidden=3,
                                            name="fc2"), name="softmax")


def test_module_state_names_like_jax_with_state_fed():
    """A state input is bound, never initialized or trained, takes no
    gradient and keeps what `set_states` wrote: 3 steps equal the JAX
    Module fed the same state as a data input (the JAX Module counts a
    state name among its parameters, ROADMAP.md Queue 3)."""
    rng = np.random.RandomState(2)
    xs = [rng.randn(4, 6).astype("f4") for _ in range(3)]
    ys = [rng.randint(0, 3, 4).astype("f4") for _ in range(3)]
    state = rng.randn(4, 5).astype("f4")
    mod = tmx.mod.Module(_state_net(tmx), state_names=["state"],
                         context=tmx.cpu())
    mod.bind([("data", (4, 6))], [("softmax_label", (4,))])
    tmx.random.seed(0)
    mod.init_params(tmx.initializer.Xavier())
    mod.init_optimizer(optimizer_params={"learning_rate": 0.1,
                                         "momentum": 0.9})
    assert mod._param_names == ["fc1_weight", "fc1_bias", "fc2_weight",
                                "fc2_bias"]
    assert mod._fused_step is None      # the fused step declines
    mod.set_states(states=[state])
    jmod = jmx.mod.Module(jmx.sym.load_json(_state_net(tmx).tojson()),
                          data_names=("data", "state"), context=jmx.cpu())
    jmod.bind([("data", (4, 6)), ("state", (4, 5))],
              [("softmax_label", (4,))])
    jmx.random.seed(0)
    jmod.init_params(jmx.initializer.Xavier())
    jmod.init_optimizer(optimizer_params={"learning_rate": 0.1,
                                          "momentum": 0.9})
    for x, y in zip(xs, ys):
        batch = tmx.io.DataBatch([tmx.nd.array(x, ctx=tmx.cpu())],
                                 [tmx.nd.array(y, ctx=tmx.cpu())])
        mod.fit_step(batch, tmx.metric.create("acc"))
        jmod.forward_backward(jmx.io.DataBatch(
            [jmx.nd.array(x), jmx.nd.array(state)], [jmx.nd.array(y)]))
        jmod.update()
        _close(mod.get_outputs()[0].asnumpy(),
               jmod.get_outputs()[0].asnumpy())
    np.testing.assert_array_equal(mod.get_states()[0].asnumpy(), state)
    got, want = mod.get_params()[0], jmod.get_params()[0]
    assert "state" not in got
    for k, v in got.items():
        _close(v.asnumpy(), want[k].asnumpy(), TOL, k)
    mod.set_states(value=0.0)
    assert not mod.get_states()[0].asnumpy().any()


def test_bucketing_module_state_names():
    """Every bucket binds the state input as a state, not a parameter."""
    def sym_gen(t):
        s = tmx.sym
        h = s.FullyConnected(s.sum(s.Variable("data"), axis=1,
                                   keepdims=True), num_hidden=5,
                             name="fc") + s.Variable("state", shape=(2, 5))
        return s.SoftmaxOutput(h, name="softmax"), ("data",), \
            ("softmax_label",)
    mod = tmx.mod.BucketingModule(sym_gen, default_bucket_key=4,
                                  context=tmx.cpu(), state_names=["state"])
    mod.bind([("data", (2, 4))], [("softmax_label", (2,))])
    mod.init_params()
    mod.init_optimizer()
    mod.set_states(value=1.5)
    batch = tmx.io.DataBatch(
        [tmx.nd.ones((2, 3), ctx=tmx.cpu())],
        [tmx.nd.zeros((2,), ctx=tmx.cpu())], bucket_key=3,
        provide_data=[("data", (2, 3))],
        provide_label=[("softmax_label", (2,))])
    mod.fit_step(batch, tmx.metric.create("acc"))
    assert mod._curr_bucket_key == 3
    for m in mod._buckets.values():
        assert "state" not in m._param_names and m._fused_step is None
    np.testing.assert_array_equal(
        mod._buckets[4].get_states()[0].asnumpy(), np.full((2, 5), 1.5))


# -- BucketingModule elastic resume -------------------------------------------

VOCAB, HIDDEN, BATCH = 24, 8, 4
BUCKETS = [4, 8, 12]


def _corpus():
    rng = np.random.RandomState(0)
    return [rng.randint(1, VOCAB, rng.randint(3, 13)).tolist()
            for _ in range(72)]


def _sym_gen(pkg):
    """`lstm_bucketing.py`'s sym_gen at a small width."""
    stack = pkg.rnn.SequentialRNNCell()
    for i in range(2):
        stack.add(pkg.rnn.LSTMCell(HIDDEN, prefix=f"lstm_l{i}_"))
    s = pkg.sym

    def sym_gen(seq_len):
        embed = s.Embedding(s.Variable("data"), input_dim=VOCAB,
                            output_dim=HIDDEN, name="embed")
        stack.reset()
        outputs, _ = stack.unroll(seq_len, inputs=embed, merge_outputs=True)
        pred = s.FullyConnected(s.Reshape(outputs, shape=(-1, HIDDEN)),
                                num_hidden=VOCAB, name="pred")
        label = s.Reshape(s.Variable("softmax_label"), shape=(-1,))
        return s.SoftmaxOutput(pred, label, name="softmax"), ("data",), \
            ("softmax_label",)
    return sym_gen


class _Stop(Exception):
    pass


def _bucket_fit(pkg, ckpt=None, resume=False, stop_after=None):
    """3 epochs of the bucketed LSTM (momentum SGD); a snapshot every 3
    batches; `stop_after` batches, then an exception (a crash).  Returns
    (module, batches run) or None when stopped."""
    random.seed(0)
    np.random.seed(0)
    pkg.random.seed(0)
    it = pkg.rnn.BucketSentenceIter(_corpus(), BATCH, buckets=list(BUCKETS),
                                    invalid_label=0)
    mod = pkg.mod.BucketingModule(_sym_gen(pkg), default_bucket_key=12,
                                  context=pkg.cpu())
    ran = {"n": 0}

    def on_batch(p):
        ran["n"] += 1
        if ran["n"] == stop_after:
            raise _Stop()

    kw = {} if ckpt is None else dict(checkpoint_dir=ckpt,
                                      checkpoint_period=3, resume=resume)
    try:
        mod.fit(it, eval_metric=pkg.metric.Perplexity(0), optimizer="sgd",
                optimizer_params={"learning_rate": 0.1, "momentum": 0.9,
                                  "rescale_grad": 1.0 / BATCH},
                initializer=pkg.initializer.Xavier(factor_type="in",
                                                   magnitude=2.34),
                num_epoch=3, batch_end_callback=on_batch, kvstore=None, **kw)
    except _Stop:
        return None
    return mod, ran["n"]


def _digests(mod):
    out = {k: hashlib.sha256(v.tobytes()).hexdigest() for k, v in
           weights.bucketing_params_to_numpy(mod).items()}
    default = mod._buckets[12]
    names = default._exec_group.param_names
    out.update({"momentum:" + names[i]: hashlib.sha256(
        s.asnumpy().tobytes()).hexdigest()
        for i, s in default._updater.states.items()})
    out["num_update"] = default._optimizer.num_update
    return out


@pytest.mark.parametrize("stop_after", [7, 20])
def test_bucketing_resume_is_bitwise(tmp_path, stop_after):
    """A fit stopped after batch `stop_after` (mid-epoch; past an epoch's
    end) and resumed equals the uninterrupted fit bit for bit: every
    bucket's parameters (its own begin states), the shared momenta and
    the update count; the resumed fit runs only what was left."""
    full, n_full = _bucket_fit(tmx)
    ckpt = str(tmp_path / "ckpt")
    assert _bucket_fit(tmx, ckpt, stop_after=stop_after) is None
    resumed, n_resumed = _bucket_fit(tmx, ckpt, resume=True)
    want, got = _digests(full), _digests(resumed)
    assert sorted(got) == sorted(want)
    assert sum("begin_state" in k and ":" not in k for k in got) == \
        4 * len(BUCKETS)
    assert [k for k in want if got[k] != want[k]] == []
    assert n_resumed < n_full
    assert {k: m._fused_step is not None
            for k, m in resumed._buckets.items()} == \
        {k: True for k in BUCKETS}


def test_bucketing_resume_matches_jax_fit(tmp_path):
    """The resumed fit against the JAX package's uninterrupted fit (the
    JAX BucketingModule's elastic path fails on its first snapshot,
    ROADMAP.md Queue 3): every bucket's parameters at the fit's
    tolerance."""
    ckpt = str(tmp_path / "ckpt")
    assert _bucket_fit(tmx, ckpt, stop_after=11) is None
    resumed, _ = _bucket_fit(tmx, ckpt, resume=True)
    jfull, _ = _bucket_fit(jmx)
    got = weights.bucketing_params_to_numpy(resumed)
    want = weights.bucketing_params_to_numpy(jfull)
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k], FIT_TOL, k)
