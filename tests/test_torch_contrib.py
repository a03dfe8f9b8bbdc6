"""`mx.contrib` in the port against the JAX package on the CPU: `io`'s
`DataLoaderIter` (its contract, and `Module.fit` fed by it against
`NDArrayIter` and against the JAX package), `svrg_optimization`'s
`SVRGModule` (the JAX package's three tests ported, the JAX class's
swap-back fault, and a fit held to the JAX class with that fault
repaired), `autograd`'s legacy names, `text` and the JSONL sink of
`tensorboard`; `quantization` and `onnx` are there (their own tests:
`test_torch_quantization.py`, `test_torch_onnx.py`).

Tolerances: the same batches through the same module in one package,
bit for bit; one forward or step in the two packages, rtol 1e-5 + 1e-6 *
max|ref| (float32 sums in other orders); a fit of tens of steps, rtol
1e-4 + 1e-5 * max|ref|; the JAX package's own SVRG checks keep their
tolerances (rtol 1e-5, atol 1e-6 at the snapshot; a difference above
1e-4 after a step).  Text and the metric sink move no arithmetic: equal.
"""
import importlib
import json
import os
import threading
import time

import numpy as np
import pytest

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu.contrib import autograd as jold_ag
from incubator_mxnet_tpu.contrib import tensorboard as jtb
from incubator_mxnet_tpu.contrib import text as jtext
from incubator_mxnet_tpu.contrib.io import DataLoaderIter as JDataLoaderIter
from incubator_mxnet_tpu.contrib.svrg_optimization import (
    SVRGModule as JSVRGModule)

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch.contrib import autograd as told_ag
from incubator_mxnet_tpu_torch.contrib import tensorboard as ttb
from incubator_mxnet_tpu_torch.contrib import text as ttext
from incubator_mxnet_tpu_torch.contrib.io import DataLoaderIter
from incubator_mxnet_tpu_torch.contrib.svrg_optimization import SVRGModule

CPU = tmx.cpu()
TOL = (1e-5, 1e-6)
FIT_TOL = (1e-4, 1e-5)


def _close(got, want, tol=TOL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=tol[0],
                               atol=tol[1] * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _params(mod):
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def _mlp(mx, hidden=8, classes=3):
    s = mx.sym
    h = s.Activation(s.FullyConnected(s.Variable("data"), num_hidden=hidden,
                                      name="fc1"), act_type="relu")
    return s.SoftmaxOutput(s.FullyConnected(h, num_hidden=classes,
                                            name="fc2"), name="softmax")


def _data(n=64, d=6, classes=3, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d).astype("f4")
    y = (x[:, :classes].argmax(1) + rng.randint(0, 2, n)) % classes
    return x, y.astype("f4")


# -- io.DataLoaderIter --------------------------------------------------------

def test_dataloader_iter_contract_matches_jax():
    """The JAX package's own check (`tests/test_model_config.py`) on
    both, then the contract: the first batch read at construction,
    ``pad=0`` on a short last batch, the descriptors, `reset`."""
    rng = np.random.RandomState(0)
    X = rng.randn(70, 6).astype("f4")
    Y = rng.randint(0, 3, 70).astype("f4")

    def run(mx, It):
        loader = mx.gluon.data.DataLoader(mx.gluon.data.ArrayDataset(
            mx.nd.array(X), mx.nd.array(Y)), batch_size=16)
        it = It(loader)
        desc = ([(d.name, d.shape) for d in it.provide_data],
                [(d.name, d.shape) for d in it.provide_label])
        epoch = [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
                 for b in it]
        it.reset()
        first = next(iter(it)).data[0].asnumpy()
        return desc, epoch, first, it.batch_size

    want = run(jmx, JDataLoaderIter)
    with tmx.cpu():
        got = run(tmx, DataLoaderIter)
    assert got[0] == want[0] == ([("data", (16, 6))],
                                 [("softmax_label", (16,))])
    assert [e[0].shape[0] for e in got[1]] == [16, 16, 16, 16, 6]
    assert [e[2] for e in got[1]] == [e[2] for e in want[1]] == [0] * 5
    for (gd, gl, _), (wd, wl, _) in zip(got[1], want[1]):
        assert np.array_equal(gd, wd) and np.array_equal(gl, wl)
    assert np.array_equal(got[2], want[2]) and got[3] == want[3] == 16


def test_dataloader_iter_reset_mid_epoch_stops_the_workers():
    x, y = _data(96)
    loader = tmx.gluon.data.DataLoader(tmx.gluon.data.ArrayDataset(x, y),
                                       batch_size=8, num_workers=3)
    it = DataLoaderIter(loader)
    next(it)
    next(it)
    it.reset()
    assert len(list(it)) == 12
    it.reset()
    next(it)
    it.close()
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline and any(
            t.name.startswith("mx-dataloader-worker")
            for t in threading.enumerate()):
        time.sleep(0.01)
    assert not [t for t in threading.enumerate()
                if t.name.startswith("mx-dataloader-worker")]


def _fit(mx, it, ctx, epochs=2):
    mod = mx.mod.Module(_mlp(mx), context=ctx)
    mx.random.seed(0)
    mod.fit(it, num_epoch=epochs, optimizer_params={"learning_rate": 0.1,
                                                    "momentum": 0.9},
            initializer=mx.init.Xavier())
    return _params(mod)


@pytest.mark.parametrize("rows,workers", [(64, 0), (64, 3), (70, 2)])
def test_module_fit_from_a_dataloader(rows, workers):
    """`Module.fit` fed by `DataLoaderIter` over a threaded loader equals
    the fit fed by `NDArrayIter` over the same batches bit for bit, and
    the JAX package's fit fed by its `DataLoaderIter` (at 0 workers)
    within the fit tolerance; 70 rows end on a short batch of 6, which
    both packages train on."""
    x, y = _data(rows)

    def loader(mx, n):
        return mx.gluon.data.DataLoader(
            mx.gluon.data.ArrayDataset(x, y), batch_size=16, num_workers=n)

    want = _fit(jmx, JDataLoaderIter(loader(jmx, 0)), jmx.cpu())
    got = _fit(tmx, DataLoaderIter(loader(tmx, workers)), CPU)
    for k in want:
        _close(got[k], want[k], FIT_TOL, k)
    if rows % 16 == 0:
        plain = _fit(tmx, tmx.io.NDArrayIter(x, y, 16), CPU)
        for k in plain:
            assert np.array_equal(got[k], plain[k]), k


# -- svrg_optimization.SVRGModule ----------------------------------------------

def _problem(mx):
    """The JAX package's SVRG problem (`tests/test_svrg.py`)."""
    rng = np.random.RandomState(0)
    X = rng.randn(128, 6).astype("f4")
    W = rng.randn(6, 1).astype("f4")
    Y = (X @ W + 0.05 * rng.randn(128, 1)).astype("f4")
    out = mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=1,
                                name="fc")
    out = mx.sym.LinearRegressionOutput(out, name="lro")
    it = mx.io.NDArrayIter(X, Y, batch_size=32, label_name="lro_label")
    return out, it


def _bound(mod, it, lr):
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label,
             for_training=True)
    mod.init_params()
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params=(("learning_rate", lr),))
    return mod


def test_svrg_converges():
    sym, it = _problem(tmx)
    mod = SVRGModule(sym, label_names=("lro_label",), update_freq=2,
                     context=CPU)
    mod.fit(it, num_epoch=25, eval_metric="mse", optimizer="sgd",
            optimizer_params={"learning_rate": 0.3,
                              "rescale_grad": 1.0 / 32})
    it.reset()
    score = dict(mod.score(it, tmx.metric.MSE()))["mse"]
    assert score < 0.05, score


def test_svrg_estimator_unbiased_at_snapshot():
    """At w == w_snap on the same batch the correction vanishes."""
    sym, it = _problem(tmx)
    mod = _bound(SVRGModule(sym, label_names=("lro_label",), update_freq=1,
                            context=CPU), it, 0.0)
    mod._take_snapshot(it)
    it.reset()
    batch = next(iter(it))
    mod.forward_backward(batch)
    live = {k: g.asnumpy().copy() for k, g in mod._live_grads().items()}
    snap = {k: g.asnumpy() for k, g in mod._grad_at_snapshot(batch).items()}
    for k in live:
        np.testing.assert_allclose(live[k], snap[k], rtol=1e-5, atol=1e-6)


def test_svrg_correction_is_not_plain_mu_after_update():
    """One step from the snapshot, g_live != g_snap, and the corrected
    gradient written for `update` is g_live - g_snap + mu, not mu: it
    lands in the gradient arrays the update reads."""
    sym, it = _problem(tmx)
    mod = _bound(SVRGModule(sym, label_names=("lro_label",), update_freq=1,
                            context=CPU), it, 0.05)
    mod._take_snapshot(it)
    it.reset()
    batches = list(it)
    mod.forward_backward(batches[0])
    mod.update()
    mod.forward_backward(batches[1])
    live = {k: g.copyto(g.context) for k, g in mod._live_grads().items()}
    snap = mod._grad_at_snapshot(batches[1])
    diff = sum(float(np.abs((live[k] - snap[k]).asnumpy()).sum())
               for k in live)
    assert diff > 1e-4, "live and snapshot grads identical: aliasing bug"
    before = _params(mod)
    for k, g in mod._live_grads().items():
        g._set_data(live[k] - snap[k] + mod._mu[k])
    mod.update()
    after = _params(mod)
    lr, scale = 0.05, 1.0 / 32
    for k in live:
        corr = (live[k] - snap[k] + mod._mu[k]).asnumpy()
        _close(after[k], before[k] - lr * scale * corr, TOL, k)
        assert not np.allclose(corr, mod._mu[k].asnumpy())


def test_jax_svrg_leaves_the_parameters_at_the_snapshot():
    """The JAX `_grad_at_snapshot` swaps back to the dict `get_params`
    returned, which the swap itself overwrote: after it, the module's
    parameters are w_snap, not the live ones (ROADMAP Queue 3).  The
    port's parameters are back at their live values."""
    for mx, cls, ctx in ((jmx, JSVRGModule, jmx.cpu()),
                         (tmx, SVRGModule, CPU)):
        sym, it = _problem(mx)
        mod = _bound(cls(sym, label_names=("lro_label",), update_freq=1,
                         context=ctx), it, 0.05)
        mod._take_snapshot(it)
        it.reset()
        batches = list(it)
        mod.forward_backward(batches[0])
        mod.update()
        live = _params(mod)["fc_weight"].copy()
        snap = mod._snap_params["fc_weight"].asnumpy()
        assert not np.allclose(live, snap)
        mod.forward_backward(batches[1])
        mod._grad_at_snapshot(batches[1])
        after = _params(mod)["fc_weight"]
        if mx is jmx:
            assert np.array_equal(after, snap)
        else:
            assert np.array_equal(after, live)


class _RepairedJSVRG(JSVRGModule):
    """The JAX class with the live parameters copied before the swap:
    the reference's SVRG, as the port computes it."""

    def _grad_at_snapshot(self, batch):
        args, aux = self.get_params()
        live = {k: v.copyto(v.context) for k, v in args.items()}
        self.set_params(self._snap_params, aux, force_init=True)
        self.forward_backward(batch)
        snap = {k: g.copyto(g.context) for k, g in self._live_grads().items()}
        self.set_params(live, aux, force_init=True)
        return snap


def test_svrg_fit_matches_the_repaired_jax_module():
    """SVRGModule.fit of an mlp (batch 16, update_freq 2, 3 epochs, the
    default Uniform(0.01) initializer under one seed, a batch-end
    callback) against the JAX class with the swap repaired: the same
    per-batch metric and the parameters within the fit tolerance; the
    unrepaired JAX fit lands elsewhere."""
    x, y = _data(64)

    def run(mx, cls, ctx):
        it = mx.io.NDArrayIter(x, y, 16)
        mod = cls(_mlp(mx), update_freq=2, context=ctx)
        seen = []
        mx.random.seed(0)
        mod.fit(it, num_epoch=3, eval_metric="acc", optimizer="sgd",
                optimizer_params={"learning_rate": 0.5},
                batch_end_callback=lambda p: seen.append(
                    p.eval_metric.get()[1]))
        return _params(mod), seen

    want, wseen = run(jmx, _RepairedJSVRG, jmx.cpu())
    got, gseen = run(tmx, SVRGModule, CPU)
    assert len(gseen) == len(wseen) == 12
    _close(gseen, wseen, TOL, "per-batch accuracy")
    for k in want:
        _close(got[k], want[k], FIT_TOL, k)
    faulty, _ = run(jmx, JSVRGModule, jmx.cpu())
    assert any(not np.allclose(faulty[k], want[k], rtol=1e-3, atol=1e-4)
               for k in want)


def test_svrg_fit_refuses_a_kvstore():
    sym, it = _problem(tmx)
    mod = SVRGModule(sym, label_names=("lro_label",), context=CPU)
    with pytest.raises(tmx.MXNetError, match="kvstore"):
        mod.fit(it, num_epoch=1, kvstore="device")
    with pytest.raises(tmx.MXNetError, match="update_freq"):
        SVRGModule(sym, label_names=("lro_label",), update_freq=0,
                   context=CPU)
    with pytest.raises(tmx.MXNetError, match="resume"):
        mod.fit(it, num_epoch=1, resume=True)
    with pytest.raises(TypeError):
        mod.fit(it, num_epoch=1, no_such_option=1)


def test_svrg_fit_takes_module_fit_options():
    """`SVRGModule.fit` is `Module.fit`'s loop: given `arg_params` start
    the fit (at learning rate 0 they are where it ends), a Monitor sees
    the SVRG steps and changes no value (bit for bit against the same fit
    without it), and the swap writes the bound tensors in place: the
    executor's parameter storage is the same before and after."""
    x, y = _data(64)
    start = {"fc1_weight": np.full((8, 6), 0.1, "f4"),
             "fc1_bias": np.zeros(8, "f4"),
             "fc2_weight": np.full((3, 8), -0.2, "f4"),
             "fc2_bias": np.zeros(3, "f4")}
    args = {k: tmx.nd.array(v, ctx=CPU) for k, v in start.items()}

    def run(lr, monitor=None):
        mod = SVRGModule(_mlp(tmx), update_freq=2, context=CPU)
        mod.fit(tmx.io.NDArrayIter(x, y, 16), num_epoch=3,
                optimizer_params={"learning_rate": lr}, arg_params=args,
                monitor=monitor)
        return mod

    frozen = _params(run(0.0))
    for k in start:
        assert np.array_equal(frozen[k], start[k]), k
    plain = run(0.5)
    seen = []
    mon = tmx.monitor.Monitor(1, stat_func=lambda a: a.norm(), pattern="fc1.*")
    mon.toc_print = lambda: seen.append(len(mon.toc()))
    watched = run(0.5, mon)
    assert len(seen) == 12 and all(seen)
    want, got = _params(plain), _params(watched)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    ptrs = [a[0]._data.data_ptr() for a in plain._exec_group.param_arrays]
    plain._grad_at_snapshot(next(iter(tmx.io.NDArrayIter(x, y, 16))))
    assert ptrs == [a[0]._data.data_ptr()
                    for a in plain._exec_group.param_arrays]


# -- autograd, text, tensorboard ----------------------------------------------

def test_legacy_autograd_names_match_jax():
    def run(mx, ag, ctx):
        x = mx.nd.array([2.0, -3.0], ctx=ctx) if ctx else \
            mx.nd.array([2.0, -3.0])
        x.attach_grad()
        with ag.train_section():
            y = x * x * x
        ag.backward([y])
        g1 = x.grad.asnumpy().copy()
        with ag.train_section():
            z = x * 4.0
        g2 = ag.compute_gradient([z])
        with ag.test_section():
            recording = mx.autograd.is_recording()
        prev = ag.set_is_training(True)
        state = (mx.autograd.is_recording(), mx.autograd.is_training())
        ag.set_is_training(False)
        return g1, x.grad.asnumpy(), g2[0], recording, prev, state

    want = run(jmx, jold_ag, None)
    got = run(tmx, told_ag, CPU)
    _close(got[0], want[0])
    _close(got[1], want[1])
    assert got[2] is None and want[2] is None
    assert got[3:] == want[3:] == (False, False, (True, True))


def test_text_vocabulary_and_embedding_match_jax(tmp_path):
    text = "the cat sat on the mat\nthe dog sat\nA cat a DOG the end"
    path = tmp_path / "vecs.txt"
    rng = np.random.RandomState(0)
    words = ["the", "cat", "sat", "mat", "dog", "zebra", "on"]
    path.write_text("".join(
        w + " " + " ".join(f"{v:.6f}" for v in rng.randn(4)) + "\n"
        for w in words) + "broken\n")

    def run(text_mod, ctx):
        counter = text_mod.count_tokens_from_str(text, to_lower=True)
        counter = text_mod.count_tokens_from_str("sat sat", counter_to_update=
                                                 counter)
        vocab = text_mod.Vocabulary(counter, most_freq_count=5, min_freq=2,
                                    reserved_tokens=["<pad>"])
        full = text_mod.Vocabulary(counter)
        kw = {"ctx": ctx} if ctx else {}
        emb = text_mod.CustomEmbedding(str(path), vocabulary=vocab, **kw)
        emb_all = text_mod.CustomEmbedding(str(path), **kw)
        return (dict(counter), len(vocab), vocab.idx_to_token,
                vocab.token_to_idx, vocab.to_indices(["the", "zebra", "sat"]),
                vocab.to_indices("cat"), vocab.to_tokens([0, 2, 3]),
                vocab.to_tokens(1), vocab.unknown_token, full.idx_to_token,
                emb.vec_len,
                emb.get_vecs_by_tokens(["sat", "nope", "the"]).asnumpy(),
                emb.get_vecs_by_tokens("zebra").asnumpy(),
                emb_all.get_vecs_by_tokens("zebra").asnumpy())

    want = run(jtext, None)
    got = run(ttext, CPU)
    assert got[:11] == want[:11]
    for g, w in zip(got[11:], want[11:]):
        assert np.array_equal(g, w)


def test_tensorboard_jsonl_sink_matches_jax(tmp_path, monkeypatch):
    """With neither tensorboardX nor torch.utils.tensorboard importable,
    both packages write one JSON line a metric a batch, the same lines."""
    real = importlib.import_module

    def no_tensorboard(name, *a, **kw):
        if "tensorboard" in name.lower():
            raise ImportError(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(importlib, "import_module", no_tensorboard)

    def run(mx, tb, root):
        cb = tb.LogMetricsCallback(str(root), prefix="train")
        metric = mx.metric.create(["acc", "ce"])
        ctx = {"ctx": CPU} if mx is tmx else {}
        for i in range(3):
            metric.update([mx.nd.array([1.0, 0.0, float(i % 2)], **ctx)],
                          [mx.nd.array([[0.1, 0.9], [0.8, 0.2],
                                        [0.6, 0.4]], **ctx)])
            cb(mx.model.BatchEndParam(epoch=0, nbatch=i, eval_metric=metric,
                                      locals=None))
        cb(mx.model.BatchEndParam(epoch=0, nbatch=3, eval_metric=None,
                                  locals=None))
        cb.close()
        return [json.loads(line) for line in
                open(os.path.join(str(root), "events.jsonl"))]

    want = run(jmx, jtb, tmp_path / "jax")
    got = run(tmx, ttb, tmp_path / "port")
    assert len(got) == len(want) == 6
    assert [(e["tag"], e["step"]) for e in got] == \
        [(e["tag"], e["step"]) for e in want]
    _close([e["value"] for e in got], [e["value"] for e in want])
    assert got[0]["tag"] == "train-accuracy"


@pytest.mark.parametrize("name", ["quantization", "onnx"])
def test_unported_contrib_modules_name_their_item(name):
    """`quantization` and `onnx`, which raised naming ROADMAP item 14
    until they were ported, are modules of `mx.contrib` with the JAX
    package's entry points; an unknown name raises AttributeError."""
    mod = getattr(tmx.contrib, name)
    jmod = importlib.import_module(f"incubator_mxnet_tpu.contrib.{name}")
    for entry in {"quantization": ["quantize_model"],
                  "onnx": ["export_model", "import_model"]}[name]:
        assert callable(getattr(mod, entry)) and hasattr(jmod, entry)
    with pytest.raises(AttributeError):
        tmx.contrib.no_such_module  # noqa: B018
