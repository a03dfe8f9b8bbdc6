"""The port's imperative API (`nd.<Op>` through `ndarray.invoke`, the
NDArray operators and `autograd`) against the JAX package's on the CPU.

Each case of the JAX package's `tests/test_autograd.py` runs in both
packages on the same inputs, drawn from one numpy seed, and every value
and gradient it produces is compared: the simple and chained gradients,
a head gradient, ``grad_req="add"``, `pause` and `detach`, the training
flags, `autograd.grad`, `BlockGrad`, a multi-output op, a custom
`Function`, BatchNorm with its aux update, slicing, a new `record` scope,
and second-order gradients.  Dropout runs only in predict mode or at
p = 0, where it draws nothing: the two packages' random streams differ.
Beyond those, what a backward leaves in the gradient arrays of variables
it does not reach, or reaches without depending on them, is held to
what the JAX tape leaves there.

Tolerance: float32, rtol 1e-5 + 1e-6 * max|ref| (the same ops, each
rounded once, in one order or another).
"""
import numpy as np
import pytest

import incubator_mxnet_tpu as jmx

import incubator_mxnet_tpu_torch as tmx

TOL = (1e-5, 1e-6)


def _close(got, want, tol=TOL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    rtol, atol = tol
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _both(case):
    """The case's {name: value} in each package, on the CPU."""
    out = {}
    for name, pkg in (("jax", jmx), ("port", tmx)):
        with pkg.cpu():
            out[name] = case(pkg)
    return out["port"], out["jax"]


def _compare(case):
    got, want = _both(case)
    assert list(got) == list(want)
    for k in want:
        _close(got[k], want[k], what=k)


def _simple(mx):
    x = mx.nd.array([1.0, 2.0, 3.0])
    x.attach_grad()
    with mx.autograd.record():
        y = x * x + 2 * x
    y.backward()
    return {"y": y.asnumpy(), "dx": x.grad.asnumpy()}


def _chain_broadcast(mx):
    x, w = mx.nd.array(_rand(3, 4)), mx.nd.array(_rand(5, 4, seed=1))
    x.attach_grad()
    w.attach_grad()
    with mx.autograd.record():
        y = mx.nd.dot(x, w, transpose_b=True)
        z = mx.nd.sum(mx.nd.relu(y - 1.0))
    z.backward()
    return {"z": z.asnumpy(), "dx": x.grad.asnumpy(),
            "dw": w.grad.asnumpy()}


def _head_gradient(mx):
    x = mx.nd.array([1.0, 2.0])
    x.attach_grad()
    with mx.autograd.record():
        y = x * 3
    y.backward(mx.nd.array([10.0, 100.0]))
    return {"dx": x.grad.asnumpy()}


def _grad_req_add(mx):
    x = mx.nd.array([2.0, -1.5])
    x.attach_grad(grad_req="add")
    for _ in range(3):
        with mx.autograd.record():
            y = x * x
        y.backward()
    return {"dx": x.grad.asnumpy()}


def _pause_and_detach(mx):
    x = mx.nd.array([2.0])
    x.attach_grad()
    with mx.autograd.record():
        y = x * x
        with mx.autograd.pause():
            z = y * 2
        w = y + 1
    w.backward()
    x2 = mx.nd.array([3.0])
    x2.attach_grad()
    with mx.autograd.record():
        y2 = (x2 * x2).detach() * x2
    y2.backward()
    return {"z": z.asnumpy(), "dx": x.grad.asnumpy(),
            "dx2": x2.grad.asnumpy()}


def _flags(mx):
    ag = mx.autograd
    seen = [ag.is_recording(), ag.is_training()]
    with ag.record():
        seen += [ag.is_recording(), ag.is_training()]
        with ag.predict_mode():
            seen += [ag.is_recording(), ag.is_training()]
        with ag.pause():
            seen += [ag.is_recording(), ag.is_training()]
        seen += [ag.is_recording(), ag.is_training()]
    with ag.record(train_mode=False):
        seen += [ag.is_recording(), ag.is_training()]
    with ag.train_mode():
        seen += [ag.is_recording(), ag.is_training()]
    seen += [ag.is_recording(), ag.is_training()]
    return {"flags": np.array(seen, np.float32)}


def _grad_api(mx):
    x = mx.nd.array(_rand(4))
    x.attach_grad()
    with mx.autograd.record():
        y = mx.nd.sum(x * x * x)
    (gx,) = mx.autograd.grad([y], [x])
    return {"gx": gx.asnumpy(), "x.grad untouched": x.grad.asnumpy()}


def _stop_gradient(mx):
    x = mx.nd.array([2.0, 0.5])
    x.attach_grad()
    with mx.autograd.record():
        y = x * x + mx.nd.BlockGrad(x * 5) + mx.nd.stop_gradient(x)
    y.backward()
    return {"y": y.asnumpy(), "dx": x.grad.asnumpy()}


def _multi_output(mx):
    x = mx.nd.array(np.arange(8, dtype="f4").reshape(2, 4))
    x.attach_grad()
    with mx.autograd.record():
        parts = mx.nd.split(x, num_outputs=2, axis=1)
        y = mx.nd.sum(parts[0] * 2) + mx.nd.sum(parts[1] * 3)
    y.backward()
    return {"y": y.asnumpy(), "dx": x.grad.asnumpy()}


def _function(mx):
    class Sigmoid(mx.autograd.Function):
        def forward(self, x):
            y = mx.nd.sigmoid(x)
            self.save_for_backward(y)
            return y

        def backward(self, dy):
            (y,) = self.saved_tensors
            return dy * y * (1 - y)

    x = mx.nd.array(_rand(5) * 4 - 2)
    x.attach_grad()
    with mx.autograd.record():
        y = Sigmoid()(x)
        z = mx.nd.sum(y * y)
    z.backward()
    return {"y": y.asnumpy(), "dx": x.grad.asnumpy()}


def _dropout_modes(mx):
    x = mx.nd.array(_rand(8, 8))
    with mx.autograd.record(train_mode=False):
        a = mx.nd.Dropout(x, p=0.5)
    with mx.autograd.record(train_mode=True):
        b = mx.nd.Dropout(x, p=0.0)
    return {"predict p=0.5": a.asnumpy(), "train p=0": b.asnumpy()}


@pytest.mark.parametrize("fix_gamma", [False, True])
def test_batchnorm_backward_with_aux(fix_gamma):
    """nd.BatchNorm recorded in training mode: the output, the gradients
    of x, gamma and beta of sum(y * r) for a random r (gamma's is 0 with
    fix_gamma), and the moving statistics written back into the aux
    arrays; then in predict mode, which leaves them alone."""
    def case(mx):
        x = mx.nd.array(_rand(4, 3, 2, 2) * 3 - 1)
        gamma = mx.nd.array(_rand(3, seed=2) + 0.5)
        beta = mx.nd.array(_rand(3, seed=3))
        mmean, mvar = mx.nd.zeros((3,)), mx.nd.ones((3,))
        for a in (x, gamma, beta):
            a.attach_grad()
        r = mx.nd.array(_rand(4, 3, 2, 2, seed=7))
        with mx.autograd.record():
            y = mx.nd.BatchNorm(x, gamma, beta, mmean, mvar,
                                fix_gamma=fix_gamma, momentum=0.8)
            z = mx.nd.sum(y * r)
        z.backward()
        out = {"y": y.asnumpy(), "dx": x.grad.asnumpy(),
               "dgamma": gamma.grad.asnumpy(), "dbeta": beta.grad.asnumpy(),
               "moving_mean": mmean.asnumpy(), "moving_var": mvar.asnumpy()}
        with mx.autograd.record(train_mode=False):
            y2 = mx.nd.BatchNorm(x, gamma, beta, mmean, mvar,
                                 fix_gamma=fix_gamma)
        out.update({"y predict": y2.asnumpy(),
                    "moving_mean after predict": mmean.asnumpy()})
        return out
    _compare(case)


def _slicing(mx):
    x = mx.nd.array(np.arange(6, dtype="f4").reshape(3, 2))
    x.attach_grad()
    with mx.autograd.record():
        y = mx.nd.sum(x[0:2] * 2.0)
    y.backward()
    x2 = mx.nd.array(np.arange(6, dtype="f4").reshape(3, 2))
    x2.attach_grad()
    idx = mx.nd.array([0, 2], dtype="int32")
    with mx.autograd.record():
        y2 = mx.nd.sum(x2[idx] * 3.0)
    y2.backward()
    return {"dx": x.grad.asnumpy(), "dx2": x2.grad.asnumpy()}


def _tape_scope(mx):
    x = mx.nd.array([1.0, -2.0])
    x.attach_grad()
    for k in range(5):
        with mx.autograd.record():
            y = mx.nd.relu(x) * (k + 2)
    y.backward()
    return {"dx": x.grad.asnumpy()}


def _higher_order(mx):
    x = mx.nd.array([1.0, 2.0, 3.0])
    x.attach_grad()
    with mx.autograd.record():
        y = x * x * x
        dy = mx.autograd.grad(y, [x], create_graph=True,
                              retain_graph=True)[0]
        z = mx.nd.sum(dy * dy)
    z.backward()
    return {"dy": dy.asnumpy(), "dx": x.grad.asnumpy()}


def _second_derivative(mx):
    x = mx.nd.array([0.3, 1.1, -0.7])
    x.attach_grad()
    with mx.autograd.record():
        y = mx.nd.sin(x)
        g1 = mx.autograd.grad(y, [x], create_graph=True,
                              retain_graph=True)[0]
        g2 = mx.autograd.grad(g1, [x], create_graph=False,
                              retain_graph=False)[0]
    return {"g1": g1.asnumpy(), "g2": g2.asnumpy()}


def _unreached_and_independent(mx):
    """What backward leaves in gradient arrays filled beforehand: a
    variable only an op off the walk consumed keeps its gradient; one an
    op on the walk consumed without depending on it gets zeros."""
    x, w, u = (mx.nd.array(_rand(3, seed=s)) for s in (4, 5, 6))
    for a, req in ((x, "write"), (w, "write"), (u, "add")):
        a.attach_grad(grad_req=req)
        a.grad[:] = 7.0
    with mx.autograd.record():
        off_walk = w * 3
        y = mx.nd.zeros_like(x) + mx.nd.ones_like(u) + x * x
    y.backward()
    return {"off walk": off_walk.asnumpy(), "dx": x.grad.asnumpy(),
            "dw kept": w.grad.asnumpy(), "du added zero": u.grad.asnumpy()}


def _arithmetic(mx):
    """The NDArray operators: scalar and array forms, reflected forms,
    comparisons, negation, and their gradients."""
    a, b = mx.nd.array(_rand(2, 3) + 0.5), mx.nd.array(_rand(3, seed=1) + .5)
    a.attach_grad()
    b.attach_grad()
    with mx.autograd.record():
        y = (-a + 1.5) * b - a / b + 2.0 / a - (3 - b) + a ** 2 \
            + (a > b) * a + (a <= 1.0) + (a == a) * 0.5
        z = mx.nd.sum(y) + mx.nd.mean(a * b, axis=1).sum()
    z.backward()
    return {"y": y.asnumpy(), "z": z.asnumpy(), "da": a.grad.asnumpy(),
            "db": b.grad.asnumpy(), "scalar": np.array(z.asscalar())}


@pytest.mark.parametrize("case", [
    _simple, _chain_broadcast, _head_gradient, _grad_req_add,
    _pause_and_detach, _flags, _grad_api, _stop_gradient, _multi_output,
    _function, _dropout_modes, _slicing, _tape_scope, _higher_order,
    _second_derivative, _unreached_and_independent, _arithmetic],
    ids=lambda f: f.__name__.strip("_"))
def test_matches_jax(case):
    _compare(case)


@pytest.mark.parametrize("name,kwargs", [
    ("log_softmax", {"axis": -1}), ("log_softmax", {"axis": 0}),
    ("sum", {"axis": 1, "keepdims": True}), ("mean", {"axis": (0, 2)}),
    ("max", {"axis": 2}), ("min", {"axis": 1, "exclude": True}),
    ("sum", {}), ("mean", {"axis": 1, "exclude": True}),
    ("LeakyReLU", {"act_type": "leaky", "slope": 0.1}),
    ("LeakyReLU", {"act_type": "elu", "slope": 0.3}),
    ("LeakyReLU", {"act_type": "gelu"}), ("LeakyReLU", {"act_type": "selu"}),
    ("square", {}), ("abs", {}), ("exp", {}), ("sigmoid", {}),
    ("tanh", {}), ("softsign", {}), ("transpose", {"axes": (2, 0, 1)}),
    ("expand_dims", {"axis": 1}), ("clip", {"a_min": -0.2, "a_max": 0.3}),
    ("Activation", {"act_type": "softrelu"}), ("relu", {}),
    ("softmax", {"axis": 1}), ("Cast", {"dtype": "float64"}),
    ("norm", {}), ("argmax", {"axis": 1})])
def test_unary_ops_and_gradients(name, kwargs):
    """The ops the losses, metrics and layers call imperatively, each
    with the gradient of sum(op(x) * r) for a random r."""
    def case(mx):
        x = mx.nd.array(_rand(2, 3, 4) * 2 - 1)
        x.attach_grad()
        with mx.autograd.record():
            y = getattr(mx.nd, name)(x, **kwargs)
            r = mx.nd.array(np.random.RandomState(9).rand(*y.shape))
            z = mx.nd.sum(y * r.astype(y.dtype))
        z.backward()
        return {"y": y.asnumpy(), "dx": x.grad.asnumpy()}
    _compare(case)


@pytest.mark.parametrize("name,kwargs", [
    ("pick", {"axis": -1}), ("pick", {"axis": 1, "keepdims": True}),
    ("pick", {"axis": 0, "mode": "wrap"}),
    ("broadcast_mul", {}), ("broadcast_sub", {}), ("broadcast_div", {}),
    ("broadcast_greater", {}), ("broadcast_maximum", {}),
    ("where", {}), ("reshape_like", {})])
def test_binary_ops_and_gradients(name, kwargs):
    def case(mx):
        x = mx.nd.array(_rand(3, 5) * 2 - 1)
        x.attach_grad()
        if name == "pick":
            # out-of-range indices clip, or wrap with mode="wrap"
            other = mx.nd.array(np.array([0, 4, 2, 7, -1] if kwargs["axis"]
                                         == 0 else [1, 4, 6], np.float32))
        elif name == "reshape_like":
            other = mx.nd.zeros((5, 3))
        else:
            other = mx.nd.array(_rand(1, 5, seed=3) + 0.5)
        with mx.autograd.record():
            if name == "where":
                y = mx.nd.where(x > 0, x * 2, mx.nd.ones_like(x))
            else:
                y = getattr(mx.nd, name)(x, other, **kwargs)
            z = mx.nd.sum(y * y)
        z.backward()
        return {"y": y.asnumpy(), "dx": x.grad.asnumpy()}
    _compare(case)


def test_out_kwarg_rejected_under_recording():
    for mx in (jmx, tmx):
        with mx.cpu():
            x = mx.nd.ones((2,))
            x.attach_grad()
            y = mx.nd.zeros((2,))
            with pytest.raises(mx.MXNetError):
                with mx.autograd.record():
                    mx.nd.relu(x, out=y)
            mx.nd.relu(x - 2, out=y)
            _close(y.asnumpy(), [0.0, 0.0])


def test_boolean_mask_index_raises():
    for mx in (jmx, tmx):
        with mx.cpu():
            x = mx.nd.array([1.0, -1.0, 2.0])
            with pytest.raises(mx.MXNetError):
                x[np.array([True, False, True])]


def test_backward_of_a_discarded_scope_raises():
    """A head recorded in a scope whose tape a newer outermost record()
    discarded raises in both packages."""
    for mx in (jmx, tmx):
        with mx.cpu():
            x = mx.nd.ones((2,))
            x.attach_grad()
            with mx.autograd.record():
                old = x * 2
            with mx.autograd.record():
                x * 3
            with pytest.raises(mx.MXNetError):
                old.backward()


def test_in_place_write_of_a_leaf_while_recording_raises():
    for mx in (jmx, tmx):
        with mx.cpu():
            x = mx.nd.ones((2,))
            x.attach_grad()
            with pytest.raises(mx.MXNetError):
                with mx.autograd.record():
                    x += 1


def test_create_graph_through_a_function_raises():
    """Second order through a custom Function is refused, as in the JAX
    package (its backward runs with recording paused)."""
    class Square(tmx.autograd.Function):
        def forward(self, x):
            self.save_for_backward(x)
            return x * x

        def backward(self, dy):
            return 2 * dy * self.saved_tensors[0]

    with tmx.cpu():
        x = tmx.nd.array([1.0, 2.0])
        x.attach_grad()
        with tmx.autograd.record():
            y = Square()(x)
            with pytest.raises(tmx.MXNetError):
                tmx.autograd.grad(y, [x], create_graph=True)


def test_outside_record_nothing_is_recorded():
    """Ops outside record() run without a graph (no requires_grad on the
    result, nothing on the tape), and so do ops under pause()."""
    from incubator_mxnet_tpu_torch.autograd import _st
    with tmx.cpu():
        x = tmx.nd.ones((2,))
        x.attach_grad()
        y = x * 2
        assert not y.data.requires_grad
        with tmx.autograd.record():
            with tmx.autograd.pause():
                z = x * 3
            w = x * 4
        assert not z.data.requires_grad and w.data.requires_grad
        assert len(_st().tape) == 1


def test_tape_holds_no_activation():
    """The tape keeps keys, not arrays: an intermediate result that
    nothing else holds is freed before backward, and backward still
    reaches the variable through it.  A freed tensor's id, reused by a
    later one, does not join the walk."""
    import gc
    import weakref
    with tmx.cpu():
        x = tmx.nd.array([1.0, 2.0])
        x.attach_grad()
        v = tmx.nd.array([5.0, 7.0])
        v.attach_grad()
        v.grad[:] = -1
        with tmx.autograd.record():
            y = x + 1               # add and scalar mul save nothing
            gone = weakref.ref(y.data)
            z = y * 3
            del y
            gc.collect()
            assert gone() is None
            for _ in range(50):     # fresh tensors, some on freed ids
                (v * 2).data
        z.backward()
    np.testing.assert_array_equal(x.grad.asnumpy(), [3.0, 3.0])
    np.testing.assert_array_equal(v.grad.asnumpy(), [-1.0, -1.0])
