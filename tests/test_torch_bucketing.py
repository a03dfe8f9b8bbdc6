"""`mod.BucketingModule` in the PyTorch port against the JAX package on
the CPU, and the slice as a whole: the bucketed LSTM language model of
BASELINE config #4 (`examples/rnn/lstm_bucketing.py`) at a small size,
trained through `BucketingModule.fit` on `BucketSentenceIter` batches
with `Perplexity(0)`.

The port's buckets bind the default bucket's tensors and share its
updater; the JAX package's buckets hold arrays of their own and copy the
parameters after every update.  The numbers must agree all the same:
every batch's perplexity and every parameter of every bucket (each
bucket's own begin states included) after 2 epochs.

Tolerances: one step, float32 sums in other orders, rtol 1e-5 + 1e-6 *
max|ref|; a fit (up to 50 steps of momentum SGD through a recurrence),
rtol 1e-4 + 1e-5 * max|ref|.
"""
import random

import numpy as np
import pytest

import incubator_mxnet_tpu as jmx

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch.compat import weights

TOL = (1e-5, 1e-6)
FIT_TOL = (1e-4, 1e-5)
VOCAB, EMBED, HIDDEN, LAYERS, BATCH = 40, 8, 16, 2, 8
BUCKETS = [4, 8, 12]


def _close(got, want, tol=TOL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=tol[0],
                               atol=tol[1] * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _fc_sym_gen(pkg):
    """`tests/test_module.py:120`'s per-length graphs."""
    s = pkg.sym

    def sym_gen(seq_len):
        f = s.FullyConnected(s.Variable("data"), num_hidden=16,
                             name="fc_shared", flatten=False)
        f = s.Reshape(s.mean(f, axis=1), shape=(-1, 16))
        out = s.FullyConnected(f, num_hidden=4, name="out_shared")
        return s.SoftmaxOutput(out, s.Variable("softmax_label"),
                               name="softmax"), ("data",), ("softmax_label",)
    return sym_gen


def _fc_batch(pkg, key, rng):
    io = pkg.io
    return io.DataBatch(
        data=[pkg.nd.array(rng.rand(4, key, 12), ctx=pkg.cpu())],
        label=[pkg.nd.array(np.arange(4) % 4, ctx=pkg.cpu())],
        bucket_key=key,
        provide_data=[io.DataDesc("data", (4, key, 12))],
        provide_label=[io.DataDesc("softmax_label", (4,))])


def _fc_module(pkg):
    mod = pkg.mod.BucketingModule(_fc_sym_gen(pkg), default_bucket_key=8,
                                  context=pkg.cpu())
    mod.bind(data_shapes=[pkg.io.DataDesc("data", (4, 8, 12))],
             label_shapes=[pkg.io.DataDesc("softmax_label", (4,))])
    pkg.random.seed(0)
    mod.init_params(initializer=pkg.initializer.Xavier())
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.1,
                                         "momentum": 0.9})
    return mod


def test_bucketing_module_matches_jax():
    """Per-length graphs share their parameters: forward_backward and
    update over buckets 8, 4, 8, 12, output for output and parameter
    for parameter with the JAX package."""
    mods = {"port": _fc_module(tmx), "jax": _fc_module(jmx)}
    for key in (8, 4, 8, 12):
        outs = {}
        for name, pkg in (("port", tmx), ("jax", jmx)):
            mod = mods[name]
            mod.forward_backward(_fc_batch(pkg, key,
                                           np.random.RandomState(key)))
            mod.update()
            outs[name] = mod.get_outputs()[0].asnumpy()
        _close(outs["port"], outs["jax"], what=f"bucket {key}")
    assert set(mods["port"]._buckets) == set(mods["jax"]._buckets) == \
        {4, 8, 12}
    args, _ = mods["port"].get_params()
    jargs, _ = mods["jax"].get_params()
    assert sorted(args) == sorted(jargs)
    for k in args:
        _close(args[k].asnumpy(), jargs[k].asnumpy(), what=k)


def test_buckets_share_parameter_gradient_and_momentum_tensors():
    """After switch_bucket and an update, another bucket's weight,
    gradient and momentum are the default bucket's tensors themselves,
    and its fused step runs on them."""
    mod = _fc_module(tmx)
    rng = np.random.RandomState(0)
    mod.forward_backward(_fc_batch(tmx, 4, rng))
    mod.update()
    mod.fit_step(_fc_batch(tmx, 12, rng), tmx.metric.create("acc"))
    default, other = mod._buckets[8], mod._buckets[4]
    assert mod._curr_bucket_key == 12
    for mine in (other, mod._buckets[12]):
        g, dg = mine._exec_group, default._exec_group
        for i, name in enumerate(g.param_names):
            assert g.param_arrays[i][0] is dg.param_arrays[i][0], name
            assert g.param_arrays[i][0].data.data_ptr() == \
                dg.param_arrays[i][0].data.data_ptr()
            assert g.grad_arrays[i][0] is dg.grad_arrays[i][0], name
        assert mine._updater is default._updater
    assert mod._buckets[12]._fused_step.steps == 1
    states = default._updater.states
    assert sorted(states) == [0, 1, 2, 3]
    w = default._exec_group.param_arrays[0][0].data.clone()
    mom = states[0].data.clone()
    mod.fit_step(_fc_batch(tmx, 4, rng), tmx.metric.create("acc"))
    # the update of bucket 4 moved the one weight and the one momentum
    assert not bool((default._exec_group.param_arrays[0][0].data ==
                     w).all())
    assert default._updater.states[0] is states[0]
    assert not bool((states[0].data == mom).all())


def _corpus(n=120, seed=0):
    """`lstm_bucketing.py`'s power-law corpus at a small vocabulary."""
    rng = np.random.RandomState(seed)
    probs = 1.0 / np.arange(1, VOCAB + 1)
    probs /= probs.sum()
    return [rng.choice(VOCAB, size=int(rng.randint(3, 13)), p=probs).tolist()
            for _ in range(n)]


def _lstm_sym_gen(pkg):
    """`lstm_bucketing.py`'s `sym_gen`."""
    stack = pkg.rnn.SequentialRNNCell()
    for i in range(LAYERS):
        stack.add(pkg.rnn.LSTMCell(HIDDEN, prefix=f"lstm_l{i}_"))
    s = pkg.sym

    def sym_gen(seq_len):
        embed = s.Embedding(s.Variable("data"), input_dim=VOCAB,
                            output_dim=EMBED, name="embed")
        stack.reset()
        outputs, _ = stack.unroll(seq_len, inputs=embed, merge_outputs=True)
        pred = s.FullyConnected(s.Reshape(outputs, shape=(-1, HIDDEN)),
                                num_hidden=VOCAB, name="pred")
        label = s.Reshape(s.Variable("softmax_label"), shape=(-1,))
        return s.SoftmaxOutput(pred, label, name="softmax"), ("data",), \
            ("softmax_label",)
    return sym_gen


def _lstm_fit(pkg, epochs=2, momentum=0.9, arg_params=None):
    """The example's BucketingModule.fit; returns (module, perplexity
    after each batch, buckets in batch order)."""
    random.seed(0)
    np.random.seed(0)
    pkg.random.seed(0)
    it = pkg.rnn.BucketSentenceIter(_corpus(), BATCH, buckets=list(BUCKETS),
                                    invalid_label=0)
    mod = pkg.mod.BucketingModule(_lstm_sym_gen(pkg),
                                  default_bucket_key=it.default_bucket_key,
                                  context=pkg.cpu())
    curve, keys = [], []

    def on_batch(p):
        curve.append(p.eval_metric.get()[1])
        keys.append(mod._curr_bucket_key)

    mod.fit(it, eval_metric=pkg.metric.Perplexity(0), optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": momentum,
                              "wd": 1e-5, "rescale_grad": 1.0 / BATCH},
            initializer=pkg.initializer.Xavier(factor_type="in",
                                               magnitude=2.34),
            arg_params=arg_params, num_epoch=epochs,
            batch_end_callback=on_batch, kvstore=None)
    return mod, curve, keys


def test_bucketing_fit_matches_jax():
    """The slice as a whole: 2 epochs of the bucketed 2-layer LSTM LM
    over 3 buckets, port against the JAX package: every batch's
    perplexity, the buckets in the same order, and every parameter of
    every bucket (its own begin states included) at the end."""
    mod, curve, keys = _lstm_fit(tmx)
    jmod, jcurve, jkeys = _lstm_fit(jmx)
    assert keys == jkeys and set(keys) == set(BUCKETS)
    assert len(curve) > 20
    # a bucket left and switched back to
    assert any(keys[i] != keys[i + 1] and keys[i] in keys[i + 2:]
               for i in range(len(keys) - 2))
    _close(curve, jcurve, FIT_TOL, "perplexity")
    assert np.isfinite(curve).all()
    got = weights.bucketing_params_to_numpy(mod)
    want = weights.bucketing_params_to_numpy(jmod)
    assert sorted(got) == sorted(want)
    assert sum("begin_state" in k for k in got) == 4 * len(BUCKETS)
    for k in want:
        _close(got[k], want[k], FIT_TOL, k)
    # the fused step ran every batch, in every bucket
    steps = {k: m._fused_step.steps for k, m in mod._buckets.items()}
    assert sum(steps.values()) == len(curve) and min(steps.values()) > 0


def test_bucketing_params_carry_from_jax_and_score():
    """The JAX package's parameters, carried as numpy into the port's
    bound buckets, score the same perplexity on the corpus."""
    jmod, _, _ = _lstm_fit(jmx, epochs=1, momentum=0.0)
    mod, _, _ = _lstm_fit(tmx, epochs=1, momentum=0.0)
    values = weights.bucketing_params_to_numpy(jmod)
    weights.bucketing_params_from_numpy(mod, values)
    got = weights.bucketing_params_to_numpy(mod)
    for k in values:
        np.testing.assert_array_equal(got[k], values[k])
    scores = []
    for pkg, m in ((tmx, mod), (jmx, jmod)):
        random.seed(3)
        np.random.seed(3)
        it = pkg.rnn.BucketSentenceIter(_corpus(seed=1), BATCH,
                                        buckets=list(BUCKETS),
                                        invalid_label=0)
        scores.append(dict(m.score(it, pkg.metric.Perplexity(0)))[
            "perplexity"])
    _close(scores[0], scores[1], TOL)


def test_bucketing_fit_refuses_what_is_not_ported(tmp_path):
    """`bind(shared_module=)` is not ported for bucketing, and an elastic
    fit refuses a directory that holds another run's checkpoints (state
    names and `fit(checkpoint_dir=)` are ported: see
    tests/test_torch_training_api.py)."""
    mod = tmx.mod.BucketingModule(_lstm_sym_gen(tmx), default_bucket_key=12,
                                  context=tmx.cpu(), state_names=[])
    other = tmx.mod.BucketingModule(_lstm_sym_gen(tmx),
                                    default_bucket_key=12, context=tmx.cpu())
    with pytest.raises(tmx.MXNetError):
        mod.bind([("data", (BATCH, 12))], [("softmax_label", (BATCH, 12))],
                 shared_module=other)
    it = tmx.rnn.BucketSentenceIter(_corpus(), BATCH, buckets=list(BUCKETS),
                                    invalid_label=0)
    mod.fit(it, num_epoch=1, checkpoint_dir=str(tmp_path), kvstore=None)
    again = tmx.mod.BucketingModule(_lstm_sym_gen(tmx),
                                    default_bucket_key=12, context=tmx.cpu())
    with pytest.raises(tmx.MXNetError, match="previous run"):
        again.fit(it, num_epoch=1, checkpoint_dir=str(tmp_path))
