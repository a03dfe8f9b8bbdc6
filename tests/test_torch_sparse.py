"""The port's sparse arrays (`ndarray/sparse.py`) against the JAX package
on the CPU: `CSRNDArray` and `RowSparseNDArray` are `NDArray`s, an op
given one computes on its dense form, `sparse.dot` in every transpose
combination with the sparse operand on either side, and LibSVM batches
through `Module.fit`, `score` and `predict` (the CSR batch crosses as
its parts and is densified where the executor runs, directly and through
the h2d ring), held against the JAX `Module` fed the same rows densified
by `NDArrayIter` (the JAX `Module` cannot take the CSR batch: its
`_slice_batch` raises, see the last test).

Tolerances: densifying, slicing, pickling and storing move no
arithmetic: equal.  A product in the two packages sums in other orders:
rtol 1e-5 + 1e-6 * max|ref|; integer-valued operands, whose sums are
exact, bit for bit.  A fit of 8 steps: rtol 1e-4 + 1e-5 * max|ref|.
"""
import pickle

import numpy as np
import pytest

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu.ndarray import sparse as jsp

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch.ndarray import sparse as tsp

CPU = tmx.cpu()
TOL = (1e-5, 1e-6)
FIT_TOL = (1e-4, 1e-5)


def _close(got, want, tol=TOL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=tol[0],
                               atol=tol[1] * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _sparse_rows(rng, m, n, density=0.3, ints=False):
    vals = rng.randint(-4, 5, (m, n)) if ints else rng.randn(m, n)
    return ((rng.rand(m, n) < density) * vals).astype(np.float32)


@pytest.mark.parametrize("kind", ["csr", "row_sparse"])
def test_sparse_classes_are_ndarrays(kind):
    """As in the JAX package, both storage types are NDArrays, report
    their stype, shape and dtype, and hold their parts on their context."""
    rng = np.random.RandomState(0)
    dense = _sparse_rows(rng, 5, 7)
    if kind == "csr":
        j, t = jsp.csr_matrix(dense), tsp.csr_matrix(dense, ctx=CPU)
        np.testing.assert_array_equal(t.indptr.asnumpy(),
                                      j.indptr.asnumpy())
    else:
        j = jsp.row_sparse_array(dense)
        t = tsp.row_sparse_array(dense, ctx=CPU)
    assert isinstance(j, jmx.nd.NDArray)
    assert isinstance(t, tmx.nd.NDArray)
    assert isinstance(t, tsp.BaseSparseNDArray)
    assert t.stype == j._stype == kind
    assert t.shape == j.shape == (5, 7)
    assert t.dtype == j.dtype == np.float32
    assert t.context == CPU
    for part in ("data", "indices"):
        np.testing.assert_array_equal(getattr(t, part).asnumpy(),
                                      getattr(j, part).asnumpy())
    np.testing.assert_array_equal(t.asnumpy(), dense)
    np.testing.assert_array_equal(t.tostype("default").asnumpy(), dense)
    np.testing.assert_array_equal(
        pickle.loads(pickle.dumps(t)).asnumpy(), dense)
    assert type(t.copy()) is type(t)


@pytest.mark.parametrize("case", ["relu", "dot", "add", "sum"])
def test_op_inputs_densify(case):
    """`mx.nd.<op>` given a sparse array computes on its dense form, as
    the JAX package's `_apply_op` does; the result is a dense NDArray."""
    rng = np.random.RandomState(1)
    dense = _sparse_rows(rng, 6, 5)
    w = rng.randn(5, 3).astype(np.float32)
    other = rng.randn(6, 5).astype(np.float32)

    def run(mx, sp, arr):
        c = sp.csr_matrix(dense, **arr)
        if case == "relu":
            return mx.nd.relu(c)
        if case == "dot":
            return mx.nd.dot(c, mx.nd.array(w, **arr))
        if case == "add":
            return mx.nd.broadcast_add(sp.row_sparse_array(dense, **arr),
                                       mx.nd.array(other, **arr))
        return c.sum(axis=1)

    got = run(tmx, tsp, {"ctx": CPU})
    want = run(jmx, jsp, {})
    assert type(got) is tmx.nd.NDArray
    _close(got.asnumpy(), want.asnumpy(), what=case)


@pytest.mark.parametrize("ints", [False, True], ids=["floats", "ints"])
@pytest.mark.parametrize("transpose_b", [False, True])
@pytest.mark.parametrize("transpose_a", [False, True])
@pytest.mark.parametrize("sparse_side", ["lhs", "rhs", "both",
                                         "row_sparse"])
def test_sparse_dot(sparse_side, transpose_a, transpose_b, ints):
    """`sparse.dot(lhs, rhs, transpose_a, transpose_b)` against the JAX
    package's: a CSR operand beside a dense one through torch's sparse
    product, else densified; integer values bit for bit."""
    rng = np.random.RandomState(2)
    m, k, n = 5, 7, 4
    a = _sparse_rows(rng, *((k, m) if transpose_a else (m, k)), ints=ints)
    b = _sparse_rows(rng, *((n, k) if transpose_b else (k, n)), ints=ints)

    def operands(mx, sp, arr):
        if sparse_side == "row_sparse":
            return sp.row_sparse_array(a, **arr), mx.nd.array(b, **arr)
        lhs = sp.csr_matrix(a, **arr) if sparse_side in ("lhs", "both") \
            else mx.nd.array(a, **arr)
        rhs = sp.csr_matrix(b, **arr) if sparse_side in ("rhs", "both") \
            else mx.nd.array(b, **arr)
        return lhs, rhs

    got = tsp.dot(*operands(tmx, tsp, {"ctx": CPU}),
                  transpose_a=transpose_a, transpose_b=transpose_b)
    want = jsp.dot(*operands(jmx, jsp, {}), transpose_a=transpose_a,
                   transpose_b=transpose_b)
    assert type(got) is tmx.nd.NDArray and got.shape == (m, n)
    if ints:
        np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
    else:
        _close(got.asnumpy(), want.asnumpy())


def test_csr_rows_slice_and_context():
    """A CSR array's row slice (a context's shard of a batch) and its
    move to another context keep its rows."""
    rng = np.random.RandomState(3)
    dense = _sparse_rows(rng, 8, 6)
    c = tsp.csr_matrix(dense, ctx=CPU)
    np.testing.assert_array_equal(c._slice_rows(2, 7).asnumpy(), dense[2:7])
    moved = c.as_in_context(tmx.cpu(1))
    assert moved.context == tmx.cpu(1)
    np.testing.assert_array_equal(moved.asnumpy(), dense)
    np.testing.assert_array_equal(
        tsp.dense_tensor(c, CPU.torch_device).numpy(), dense)


# -- LibSVM batches through Module ----------------------------------------------

FEATURES, ROWS, BATCH = 60, 64, 16


def _libsvm(tmp_path, seed=4):
    """A LibSVM file of ROWS rows, 6 distinct features each, labels 0/1;
    returns (path, the dense rows, the labels)."""
    rng = np.random.RandomState(seed)
    dense = np.zeros((ROWS, FEATURES), np.float32)
    labels = rng.randint(0, 2, ROWS)
    lines = []
    for i in range(ROWS):
        cols = np.sort(rng.choice(FEATURES, 6, replace=False))
        vals = rng.rand(6).astype(np.float32)
        dense[i, cols] = vals
        lines.append(f"{labels[i]} " + " ".join(
            f"{c}:{v!r}" for c, v in zip(cols, vals.tolist())))
    path = tmp_path / "train.libsvm"
    path.write_text("\n".join(lines) + "\n")
    return str(path), dense, labels.astype(np.float32)


def _linear(mx):
    h = mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=2,
                              name="fc")
    return mx.sym.SoftmaxOutput(h, name="softmax")


def _fit(mx, it, ctx, w0, epochs=2):
    mod = mx.mod.Module(_linear(mx), context=ctx)
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params(arg_params={"fc_weight": mx.nd.array(w0),
                                "fc_bias": mx.nd.zeros((2,))})
    mod.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": 0.5, "momentum": 0.9})
    mod.fit(it, num_epoch=epochs)
    args, _ = mod.get_params()
    it.reset()
    pred = mod.predict(it).asnumpy()
    it.reset()
    score = dict(mod.score(it, "acc"))["accuracy"]
    return args["fc_weight"].asnumpy(), pred, score


@pytest.mark.parametrize("ring", ["1", "0"], ids=["ring", "no_ring"])
def test_libsvm_module_fit_matches_jax_on_the_dense_rows(tmp_path,
                                                         monkeypatch, ring):
    """`LibSVMIter` into the port's `Module.fit` (8 steps), `predict` and
    `score`, through the h2d ring and without it, against the JAX
    `Module` fed the same rows densified by `NDArrayIter`."""
    monkeypatch.setenv("MXNET_IO_RING", ring)
    path, dense, labels = _libsvm(tmp_path)
    w0 = np.random.RandomState(5).randn(2, FEATURES).astype(np.float32)
    it = tmx.io.LibSVMIter(data_libsvm=path, data_shape=(FEATURES,),
                           batch_size=BATCH)
    with CPU:
        got = _fit(tmx, it, CPU, w0)
    want = _fit(jmx, jmx.io.NDArrayIter(dense, labels, batch_size=BATCH,
                                        label_name="softmax_label"),
                jmx.cpu(), w0)
    _close(got[0], want[0], FIT_TOL, "fc_weight")
    _close(got[1], want[1], FIT_TOL, "predictions")
    assert got[2] == pytest.approx(want[2])


def test_libsvm_batch_crosses_as_its_parts(tmp_path, monkeypatch):
    """The executor densifies a CSR batch where it runs, from its parts:
    the bound input equals the dense rows bit for bit, and the host copy
    of the batch (`asnumpy`) is never made."""
    path, dense, _ = _libsvm(tmp_path)
    it = tmx.io.LibSVMIter(data_libsvm=path, data_shape=(FEATURES,),
                           batch_size=BATCH)
    mod = tmx.mod.Module(_linear(tmx), context=CPU)
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params()

    def no_host_copy(self):
        raise AssertionError("the CSR batch was densified by asnumpy")
    monkeypatch.setattr(tsp.BaseSparseNDArray, "asnumpy", no_host_copy)
    for i, batch in enumerate(it):
        assert isinstance(batch.data[0], tsp.CSRNDArray)
        mod.forward(batch, is_train=False)
        bound = mod._exec_group.execs[0].arg_dict["data"].data.numpy()
        np.testing.assert_array_equal(bound,
                                      dense[i * BATCH:(i + 1) * BATCH])


def test_libsvm_fit_over_two_contexts(tmp_path):
    """A CSR batch split between two contexts (each takes its rows as a
    CSR slice) trains as one context does."""
    path, _, _ = _libsvm(tmp_path)
    w0 = np.random.RandomState(6).randn(2, FEATURES).astype(np.float32)

    def run(ctx):
        it = tmx.io.LibSVMIter(data_libsvm=path, data_shape=(FEATURES,),
                               batch_size=BATCH)
        with CPU:
            return _fit(tmx, it, ctx, w0, epochs=1)

    got, want = run([tmx.cpu(0), tmx.cpu(1)]), run(CPU)
    _close(got[0], want[0], TOL, "fc_weight")
    _close(got[1], want[1], TOL, "predictions")


def test_jax_libsvm_module_fit_raises(tmp_path):
    """The JAX `Module` cannot take a CSR batch: `_slice_batch`
    (`module/executor_group.py:160`) indexes it and raises IndexError
    (ROADMAP Queue 3).  The port's fit of the same iterator runs."""
    path, _, _ = _libsvm(tmp_path)
    it = jmx.io.LibSVMIter(data_libsvm=path, data_shape=(FEATURES,),
                           batch_size=BATCH)
    mod = jmx.mod.Module(_linear(jmx), context=jmx.cpu())
    with pytest.raises(IndexError):
        mod.fit(it, num_epoch=1)
