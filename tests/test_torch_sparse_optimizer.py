"""The port's lazy row-sparse optimizer updates against the JAX package.

The five cases of `tests/test_sparse_optimizer.py`, each run through
both packages on the same numpy inputs (the port on the CPU): touched
rows get the dense update, untouched rows keep weight and state bit for
bit, an empty gradient changes nothing, a lazy step leaves aliases of
the weight readable, and ``lazy_update=False`` densifies.  fp32 in the
same order of operations: rtol 1e-6 + 1e-6 * max|array|; the untouched
rows and the no-op equal.
"""
import numpy as np
import pytest

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu.ndarray.sparse import RowSparseNDArray as JRS
from incubator_mxnet_tpu_torch.ndarray.sparse import RowSparseNDArray as TRS

TOL = (1e-6, 1e-6)


def _close(got, want, what=""):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want,
                               rtol=TOL[0],
                               atol=TOL[1] * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _arr(mx, x):
    return mx.nd.array(np.asarray(x, np.float32), ctx=mx.cpu())


def _both(fn):
    return (fn(jmx, JRS), fn(tmx, TRS))


def test_sgd_momentum_lazy_row_sparse():
    rng = np.random.RandomState(0)
    V, D = 20, 8
    w0 = rng.randn(V, D).astype("f4")
    m0 = rng.randn(V, D).astype("f4") * 0.1
    rows = np.array([2, 5, 11], np.int64)
    gvals = rng.randn(3, D).astype("f4")

    def run(mx, RS):
        opt = mx.optimizer.SGD(learning_rate=0.1, momentum=0.9, wd=0.01,
                               rescale_grad=0.5, lazy_update=True)
        w, mom = _arr(mx, w0), _arr(mx, m0)
        opt.update(0, w, RS(gvals, rows, (V, D)), mom)
        return w.asnumpy(), mom.asnumpy()

    (jw, jm), (tw, tm) = _both(run)
    _close(tw, jw, "weight")
    _close(tm, jm, "momentum")
    untouched = [i for i in range(V) if i not in rows]
    np.testing.assert_array_equal(tw[untouched], w0[untouched])
    np.testing.assert_array_equal(tm[untouched], m0[untouched])


def test_adam_lazy_row_sparse():
    rng = np.random.RandomState(1)
    V, D = 16, 4
    w0 = rng.randn(V, D).astype("f4")
    rows = np.array([0, 7], np.int64)
    gvals = rng.randn(2, D).astype("f4")

    def run(mx, RS):
        opt = mx.optimizer.Adam(learning_rate=0.01, lazy_update=True)
        w = _arr(mx, w0)
        mean, var = (mx.nd.zeros((V, D), ctx=mx.cpu()) for _ in range(2))
        opt.update(0, w, RS(gvals, rows, (V, D)), (mean, var))
        return w.asnumpy(), mean.asnumpy(), var.asnumpy()

    j, t = _both(run)
    for a, b, what in zip(t, j, ("weight", "mean", "var")):
        _close(a, b, what)
    untouched = [i for i in range(V) if i not in rows]
    np.testing.assert_array_equal(t[0][untouched], w0[untouched])
    np.testing.assert_array_equal(t[1][untouched], 0.0)


def test_lazy_empty_grad_is_noop():
    V, D = 5, 3
    w0 = np.ones((V, D), "f4")
    m0 = np.full((V, D), 0.5, "f4")

    def run(mx, RS):
        opt = mx.optimizer.SGD(learning_rate=0.1, momentum=0.9, wd=0.01,
                               lazy_update=True)
        w, mom = _arr(mx, w0), _arr(mx, m0)
        empty = RS(np.zeros((0, D), "f4"), np.zeros((0,), np.int64), (V, D))
        opt.update(0, w, empty, mom)
        return w.asnumpy(), mom.asnumpy()

    for w, m in _both(run):
        np.testing.assert_array_equal(w, w0)
        np.testing.assert_array_equal(m, m0)


def test_lazy_update_does_not_invalidate_aliases():
    V, D = 6, 2

    def run(mx, RS):
        w = _arr(mx, np.ones((V, D)))
        snap = w.detach()
        opt = mx.optimizer.SGD(learning_rate=0.1, lazy_update=True)
        opt.update(0, w, RS(np.ones((1, D), "f4"), np.array([1]), (V, D)),
                   None)
        return snap.asnumpy(), w.asnumpy()

    (jsnap, jw), (tsnap, tw) = _both(run)
    # the JAX package's detached copy keeps the old values; the port's
    # detach() shares storage (torch semantics) and so sees the update
    np.testing.assert_array_equal(jsnap, np.ones((V, D), "f4"))
    np.testing.assert_array_equal(tsnap, tw)
    _close(tw, jw)
    assert np.isfinite(tsnap).all()


@pytest.mark.parametrize("momentum", [0.9, 0.0])
def test_lazy_update_off_densifies(momentum):
    V, D = 6, 3
    w0 = np.ones((V, D), "f4")
    m0 = np.full((V, D), 0.5, "f4")
    rows = np.array([1], np.int64)
    gvals = np.ones((1, D), "f4")

    def run(mx, RS):
        opt = mx.optimizer.SGD(learning_rate=0.1, momentum=momentum,
                               lazy_update=False)
        w = _arr(mx, w0)
        mom = _arr(mx, m0) if momentum else None
        opt.update(0, w, RS(gvals, rows, (V, D)), mom)
        return w.asnumpy(), None if mom is None else mom.asnumpy()

    (jw, jm), (tw, tm) = _both(run)
    _close(tw, jw, "weight")
    if momentum:
        _close(tm, jm, "momentum")
        assert np.allclose(tm[0], 0.45), tm[0]


def test_duplicate_ids_presum_in_a_stable_order():
    """A gradient touching a row twice: the rows sum on the host before
    the unique-row write, as the JAX package sums them."""
    V, D = 8, 2
    rows = np.array([3, 5, 3, 3], np.int64)
    gvals = np.random.RandomState(2).randn(4, D).astype("f4")

    def run(mx, RS):
        opt = mx.optimizer.SGD(learning_rate=0.5, momentum=0.9)
        w, mom = _arr(mx, np.zeros((V, D))), _arr(mx, np.zeros((V, D)))
        opt.update(0, w, RS(gvals, rows, (V, D)), mom)
        return w.asnumpy(), mom.asnumpy()

    (jw, jm), (tw, tm) = _both(run)
    np.testing.assert_array_equal(tw, jw)
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_allclose(tw[3], -0.5 * (gvals[0] + gvals[2] +
                                              gvals[3]), rtol=1e-6)
