"""The port's small public modules against the JAX package on the CPU:
`operator` (`CustomOp`, `CustomOpProp`, `register`, ``nd.Custom``),
`engine` (`bulk`, `waitall`, NaiveEngine), `visualization` (``mx.viz``)
and `libinfo`.

One `CustomOp` class body, a softmax with a hand-written backward, is
registered in both packages and run through ``nd.Custom`` under
``autograd.record()``: outputs and input gradients agree within rtol
1e-6.  A bulk initialisation is bit-equal to an unbulked one and moves
its arrays in one copy; NaiveEngine names the op that failed;
`print_summary` prints the JAX package's table but for the "Param #"
column, which the port fills with the reference's counts (the JAX
package prints 0: ROADMAP Queue 3, shown in
tests/test_torch_parallel.py); `libinfo` reports the port's runtime.
"""
import contextlib
import io

import numpy as np
import pytest

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx


def _softmax_op(m, name):
    """Register `name` in package `m`: a row softmax whose backward is
    written by hand, y * (g - sum(g * y))."""

    class Softmax(m.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0]
            e = m.nd.exp(x - m.nd.max(x, axis=1, keepdims=True))
            self.assign(out_data[0], req[0],
                        e / m.nd.sum(e, axis=1, keepdims=True))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            y, g = out_data[0], out_grad[0]
            self.assign(in_grad[0], req[0],
                        y * (g - m.nd.sum(g * y, axis=1, keepdims=True)))

    @m.operator.register(name)
    class SoftmaxProp(m.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=True)

        def create_operator(self, ctx, shapes, dtypes):
            return Softmax()

    return Softmax


def _run_custom(m, name, x_np, w_np):
    kw = {} if m is jmx else {"ctx": tmx.cpu()}
    x = m.nd.array(x_np, **kw)
    w = m.nd.array(w_np, **kw)
    x.attach_grad()
    with m.autograd.record():
        y = m.nd.Custom(x, op_type=name)
        loss = m.nd.sum(y * w)
    loss.backward()
    return y.asnumpy(), x.grad.asnumpy()


def test_custom_softmax_matches_jax():
    _softmax_op(jmx, "softmax24")
    _softmax_op(tmx, "softmax24")
    rng = np.random.RandomState(0)
    x = rng.randn(6, 10).astype("f4")
    w = rng.randn(6, 10).astype("f4")
    jy, jg = _run_custom(jmx, "softmax24", x, w)
    ty, tg = _run_custom(tmx, "softmax24", x, w)
    np.testing.assert_allclose(ty, jy, rtol=1e-6)
    np.testing.assert_allclose(tg, jg, rtol=1e-6, atol=1e-7)
    # and both against the closed form
    e = np.exp(x - x.max(1, keepdims=True))
    y = e / e.sum(1, keepdims=True)
    np.testing.assert_allclose(ty, y, rtol=1e-5)
    np.testing.assert_allclose(
        tg, y * (w - (w * y).sum(1, keepdims=True)), rtol=1e-4, atol=1e-6)
    assert "softmax24" in tmx.operator.get_all_registered_operators()


def test_custom_op_unregistered_raises_like_jax():
    for m in (jmx, tmx):
        kw = {} if m is jmx else {"ctx": tmx.cpu()}
        with pytest.raises(m.MXNetError, match="not registered"):
            m.nd.Custom(m.nd.ones((2, 2), **kw), op_type="nope24")


@pytest.mark.parametrize("req", ["write", "inplace", "add", "null"])
def test_assign_semantics_match_jax(req):
    out = {}
    for m in (jmx, tmx):
        kw = {} if m is jmx else {"ctx": tmx.cpu()}
        dst = m.nd.array(np.full((2, 3), 2.0, "f4"), **kw)
        src = m.nd.array(np.arange(6, dtype="f4").reshape(2, 3), **kw)
        m.operator.CustomOp().assign(dst, req, src)
        out[m] = dst.asnumpy()
    np.testing.assert_array_equal(out[tmx], out[jmx])


def test_custom_op_default_prop_matches_jax():
    for m in (jmx, tmx):
        p = m.operator.CustomOpProp(need_top_grad=False)
        assert p.infer_shape([[2, 3]]) == ([[2, 3]], [[2, 3]], [])
        assert p.list_arguments() == ["data"]
        assert p.declare_backward_dependency([1], [2], [3]) == [2, 3]


# -- engine ----------------------------------------------------------------

def _alex_init(bulk):
    net = tmx.gluon.model_zoo.vision.alexnet(classes=10, prefix="alex24_")
    net.infer_shape(tmx.nd.zeros((1, 3, 63, 63), ctx=tmx.cpu()))
    tmx.random.seed(3)
    if bulk:
        with tmx.engine.bulk(64):
            net.initialize(tmx.init.Xavier(), ctx=tmx.cpu())
    else:
        net.initialize(tmx.init.Xavier(), ctx=tmx.cpu())
    return net


def test_bulk_initialisation_is_bit_equal_in_one_copy():
    """AlexNet's parameters initialised inside `engine.bulk` equal the
    unbulked ones bit for bit; the scope's exit moved all 16 in ONE copy
    (one device), and the network then runs and trains on them."""
    plain = _alex_init(False)
    copies, staged = tmx.engine.h2d_copies, tmx.engine.staged_total
    net = _alex_init(True)
    assert tmx.engine.h2d_copies - copies == 1
    assert tmx.engine.staged_total - staged == 16
    for (k, a), b in zip(plain.collect_params().items(),
                         net.collect_params().values()):
        assert np.array_equal(a.data().asnumpy(), b.data().asnumpy()), k
    x = tmx.nd.ones((2, 3, 63, 63), ctx=tmx.cpu())
    with tmx.autograd.record():
        loss = net(x).sum()
    loss.backward()
    trainer = tmx.gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.1})
    trainer.step(2)
    assert np.isfinite(net(x).asnumpy()).all()


def test_bulk_nests_and_flushes_at_the_outermost_exit():
    with tmx.engine.bulk(8):
        a = tmx.nd.ones((3,), ctx=tmx.cpu())
        with tmx.engine.bulk(8):
            b = tmx.nd.zeros((2, 2), ctx=tmx.cpu())
        assert tmx.engine.bulk_active()
    assert not tmx.engine.bulk_active()
    assert a.asnumpy().tolist() == [1.0] * 3 and b.asnumpy().sum() == 0
    assert tmx.engine.set_bulk_size(5) == 0
    assert tmx.engine.set_bulk_size(0) == 5


def test_naive_engine_names_the_failing_op(monkeypatch):
    """Under NaiveEngine a failed op is an MXNetError naming it, as the
    JAX engine's ``track`` says; the engine then serves new work (the
    JAX package's test_engine_recovers_after_failure)."""
    monkeypatch.setenv("MXNET_ENGINE_TYPE", "NaiveEngine")
    assert tmx.engine.engine_type() == jmx.engine.engine_type() == \
        "NaiveEngine"
    a = tmx.nd.ones((2, 3), ctx=tmx.cpu())
    with pytest.raises(tmx.MXNetError, match="NaiveEngine: operator 'dot'"):
        tmx.nd.dot(a, tmx.nd.ones((7, 2), ctx=tmx.cpu()))
    out = tmx.nd.dot(a, tmx.nd.ones((3, 2), ctx=tmx.cpu()))
    tmx.engine.waitall()
    np.testing.assert_allclose(out.asnumpy(), 3.0)
    monkeypatch.delenv("MXNET_ENGINE_TYPE")
    assert not tmx.engine.naive()


def test_waitall_and_wait_to_read():
    x = tmx.nd.ones((4,), ctx=tmx.cpu()) * 2
    x.wait_to_read()
    tmx.nd.waitall()
    assert tmx.nd.waitall is tmx.engine.waitall
    assert x.asnumpy().tolist() == [2.0] * 4


# -- visualization ---------------------------------------------------------

def _mlp(m):
    s = m.sym
    x = s.Variable("data")
    x = s.Activation(s.FullyConnected(x, num_hidden=8, name="fc1"),
                     act_type="relu", name="relu1")
    x = s.BatchNorm(x, name="bn1")
    return s.SoftmaxOutput(s.FullyConnected(x, num_hidden=3, name="fc2"),
                           name="softmax")


def _summary(m, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        m.viz.print_summary(_mlp(m), **kw)
    return buf.getvalue().splitlines()


@pytest.mark.parametrize("shape", [None, {"data": (2, 5)}])
def test_print_summary_matches_jax_but_the_counts(shape):
    want = _summary(jmx, shape=shape)
    got = _summary(tmx, shape=shape)
    lo, hi = int(120 * .64), int(120 * .74)
    assert len(got) == len(want) + 2
    for g, w in zip(got, want):
        assert g[:lo] + g[hi:] == w[:lo] + w[hi:]
    counts = {ln.split("(")[0]: int(ln[lo:hi]) for ln in got
              if "(" in ln.split(" ")[0]}
    if shape is None:
        assert set(counts.values()) == {0}
        assert got[-2] == "Total params: 0"
    else:
        # hand counts: weights + biases; BatchNorm's gamma, beta and its
        # two moving statistics
        assert counts == {"fc1": 5 * 8 + 8, "relu1": 0, "bn1": 4 * 8,
                          "fc2": 8 * 3 + 3, "softmax": 0}
        assert got[-2] == f"Total params: {48 + 32 + 27}"


def test_plot_network_matches_jax():
    """With graphviz the two graphs have the same source; without it
    both raise the JAX package's ImportError."""
    try:
        import graphviz  # noqa: F401
    except ImportError:
        for m in (jmx, tmx):
            with pytest.raises(ImportError, match="requires graphviz"):
                m.viz.plot_network(_mlp(m))
        return
    for hide in (True, False):
        assert tmx.viz.plot_network(_mlp(tmx), hide_weights=hide).source \
            == jmx.viz.plot_network(_mlp(jmx), hide_weights=hide).source


# -- libinfo ---------------------------------------------------------------

def test_libinfo_reports_the_port():
    f = tmx.libinfo.features()
    assert {"CUDA", "DEVICE", "CUDA_VERSION", "TORCH_VERSION", "NATIVE_IO",
            "BACKENDS", "KERNELS"} <= set(f)
    assert f["CUDA"] is False and f["DEVICE"] is None    # no card here
    assert "gloo" in f["BACKENDS"]
    assert f["KERNELS"] == list(tmx.kernels._build.SOURCES)
    paths = tmx.libinfo.find_lib_path()
    assert isinstance(paths, list)
    if f["NATIVE_IO"]:
        assert str(tmx.native.lib_path()) in paths
    assert tmx.libinfo.find_include_path() == \
        jmx.libinfo.find_include_path()
    assert tmx.libinfo.__version__ == jmx.libinfo.__version__
