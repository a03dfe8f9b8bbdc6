"""The metrics and initializers the PyTorch port adds, against the JAX
package, on the CPU.

Metrics: three seeded batches through the port's `update` and the JAX
package's, and the same batches through the port's `device_update`
(the fused train step's path) where the metric has one; the values
agree to rtol 1e-6 (float64 totals; the device path sums float32
elements in another order).  `create` of a function is a
`CustomMetric`.  Initializers: under one `random.seed` both packages
draw the same host stream, so the values are bitwise equal.
"""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx


def _batches(kind, seed=0, n=3):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        if kind == "binary":
            pred = rng.rand(16, 2).astype(np.float32)
            label = rng.randint(0, 2, 16).astype(np.float32)
        elif kind == "binary1d":
            pred = rng.rand(16).astype(np.float32)
            label = rng.randint(0, 2, 16).astype(np.float32)
        elif kind == "regress":
            pred = rng.normal(0, 1, (12, 3)).astype(np.float32)
            label = (pred + rng.normal(0, 0.5, (12, 3))).astype(np.float32)
        elif kind == "regress1d":
            pred = rng.normal(0, 1, 12).astype(np.float32)
            label = (pred + rng.normal(0, 0.5, 12)).astype(np.float32)
        else:   # probabilities
            logits = rng.normal(0, 1, (10, 5))
            pred = (np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
                    ).astype(np.float32)
            label = rng.randint(0, 5, 10).astype(np.float32)
        out.append((label, pred))
    return out


METRICS = [
    ("f1", {}, "binary"),
    ("f1", {"average": "micro"}, "binary"),
    ("f1", {}, "binary1d"),
    ("mcc", {}, "binary"),
    ("mcc", {"average": "micro"}, "binary"),
    ("mae", {}, "regress"),
    ("mse", {}, "regress1d"),
    ("rmse", {}, "regress"),
    ("nll_loss", {}, "probs"),
    ("pearsonr", {}, "regress"),
    ("loss", {}, "regress"),
    ("torch", {}, "regress"),
    ("caffe", {}, "probs"),
]


def _value(metric):
    return float(metric.get()[1])


@pytest.mark.parametrize("name,kw,kind", METRICS,
                         ids=[f"{n}-{i}" for i, (n, _, _) in
                              enumerate(METRICS)])
def test_metric_matches_jax(name, kw, kind):
    tm, jm = tmx.metric.create(name, **kw), jmx.metric.create(name, **kw)
    assert type(tm).__name__ == type(jm).__name__
    dev = tmx.metric.create(name, **kw)
    for label, pred in _batches(kind):
        tm.update([tmx.nd.array(label, ctx=tmx.cpu())],
                  [tmx.nd.array(pred, ctx=tmx.cpu())])
        jm.update([jmx.nd.array(label)], [jmx.nd.array(pred)])
        if getattr(dev, "device_update", None) is not None:
            dev._accumulate(*dev.device_update(
                [torch.from_numpy(label)], [torch.from_numpy(pred)]))
    assert tm.get()[0] == jm.get()[0]
    np.testing.assert_allclose(_value(tm), _value(jm), rtol=1e-6)
    if getattr(dev, "device_update", None) is not None:
        np.testing.assert_allclose(_value(dev), _value(jm), rtol=1e-6)
    else:
        assert kw.get("average") == "micro"


def test_custom_metric_and_np():
    def feval(label, pred):
        return float(np.abs(label - pred.argmax(1)).sum()), label.size

    def mean_p(label, pred):
        return float(pred.max(1).mean())

    for make in (lambda pkg: pkg.metric.create(feval),
                 lambda pkg: pkg.metric.np(mean_p, name="mp"),
                 lambda pkg: pkg.metric.CustomMetric(mean_p)):
        tm, jm = make(tmx), make(jmx)
        assert getattr(tm, "device_update", None) is None
        for label, pred in _batches("probs"):
            tm.update([tmx.nd.array(label, ctx=tmx.cpu())],
                      [tmx.nd.array(pred, ctx=tmx.cpu())])
            jm.update([jmx.nd.array(label)], [jmx.nd.array(pred)])
        assert tm.get()[0] == jm.get()[0]
        np.testing.assert_allclose(_value(tm), _value(jm), rtol=1e-12)


def test_composite_with_custom_metric():
    """acc + nll_loss + a CustomMetric, as phase 15c's eval_metric."""
    def err(label, pred):
        return float((pred.argmax(1) != label).mean())

    tm = tmx.metric.create(["acc", "nll_loss", err])
    jm = jmx.metric.create(["acc", "nll_loss", err])
    for label, pred in _batches("probs"):
        tm.update([tmx.nd.array(label, ctx=tmx.cpu())],
                  [tmx.nd.array(pred, ctx=tmx.cpu())])
        jm.update([jmx.nd.array(label)], [jmx.nd.array(pred)])
    tn, tv = tm.get()
    jn, jv = jm.get()
    assert tn == jn
    np.testing.assert_allclose(tv, jv, rtol=1e-6)


def test_binary_metric_refuses_three_classes():
    for pkg in (tmx, jmx):
        m = pkg.metric.create("f1")
        ctx = {"ctx": tmx.cpu()} if pkg is tmx else {}
        with pytest.raises(ValueError):
            m.update([pkg.nd.array([0, 1, 2], **ctx)],
                     [pkg.nd.array(np.eye(3, 2), **ctx)])


# -- initializers ------------------------------------------------------------------

INITS = [
    ("msraprelu", {}, (20, 30)),
    ("msraprelu", {"factor_type": "in", "slope": 0.1}, (8, 3, 5, 5)),
    ("orthogonal", {}, (12, 20)),
    ("orthogonal", {"scale": 1.0, "rand_type": "normal"}, (20, 6, 2)),
    ("bilinear", {}, (4, 1, 4, 4)),
    ("bilinear", {}, (2, 3, 5, 3)),
]


def _draw(pkg, init, shape, name="w_weight"):
    ctx = {"ctx": tmx.cpu()} if pkg is tmx else {}
    arr = pkg.nd.zeros(shape, **ctx)
    pkg.random.seed(5)
    init(pkg.initializer.InitDesc(name), arr)
    return arr.asnumpy()


@pytest.mark.parametrize("name,kw,shape", INITS)
def test_initializer_bitwise(name, kw, shape):
    got = _draw(tmx, tmx.initializer.create(name, **kw), shape)
    want = _draw(jmx, jmx.initializer.create(name, **kw), shape)
    np.testing.assert_array_equal(got, want)


def test_orthogonal_is_orthonormal():
    w = _draw(tmx, tmx.init.Orthogonal(scale=1.0), (6, 10))
    np.testing.assert_allclose(w @ w.T, np.eye(6), atol=1e-5)


def test_mixed_and_load():
    """Mixed dispatches by the first matching pattern; Load takes saved
    values (``arg:`` prefixes dropped) and falls back to its default."""
    got, want = {}, {}
    for pkg, out in ((tmx, got), (jmx, want)):
        ctx = {"ctx": tmx.cpu()} if pkg is tmx else {}
        mixed = pkg.init.Mixed([".*fc1.*", ".*"],
                               [pkg.init.Orthogonal(),
                                pkg.init.MSRAPrelu()])
        pkg.random.seed(3)
        for name, shape in (("fc1_weight", (8, 5)), ("fc2_weight", (4, 8)),
                            ("fc1_bias", (8,))):
            arr = pkg.nd.zeros(shape, **ctx)
            mixed(pkg.initializer.InitDesc(name), arr)
            out[name] = arr.asnumpy()
        saved = {"arg:a_weight": pkg.nd.array(np.arange(6.0).reshape(2, 3),
                                              **ctx)}
        load = pkg.init.Load(saved, default_init=pkg.init.Constant(0.5))
        for name in ("a_weight", "b_weight"):
            arr = pkg.nd.zeros((2, 3), **ctx)
            load(name, arr)
            out[name] = arr.asnumpy()
        with pytest.raises(ValueError):
            load("a_weight", pkg.nd.zeros((3, 2), **ctx))
        with pytest.raises(ValueError):
            mixed2 = pkg.init.Mixed(["^x"], [pkg.init.Zero()])
            mixed2("y_weight", pkg.nd.zeros((2,), **ctx))
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    assert (got["fc1_bias"] == 0).all()
    np.testing.assert_array_equal(got["b_weight"], np.full((2, 3), 0.5))
