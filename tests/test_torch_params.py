"""`.params` files and checkpoint pairs interchange between the JAX
package and the PyTorch port, byte for byte."""
import numpy as np
import pytest

import incubator_mxnet_tpu as jmx

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch.compat.mxnet_params import (load_params,
                                                           save_params)
from incubator_mxnet_tpu_torch.compat.weights import params_from_numpy

_DTYPES = ["float32", "float64", "float16", "uint8", "int8", "int32",
           "int64"]


def _arrays(seed=0):
    rng = np.random.RandomState(seed)
    out = {}
    for i, dt in enumerate(_DTYPES):
        shape = [(3, 4), (5,), (2, 1, 3), (7, 2), (1,), (2, 2, 2), (6,)][i]
        out[f"arg:p{i}_{dt}"] = (rng.normal(0, 10, shape)).astype(dt)
    out["aux:scalar_like"] = np.float32([1.5])
    return out


@pytest.mark.parametrize("named", [True, False])
def test_port_bytes_equal_jax_bytes(tmp_path, named):
    data = _arrays()
    if not named:
        data = list(data.values())
    jpath = tmp_path / "jax.params"
    jmx.nd.save(str(jpath), {k: jmx.nd.array(v, dtype=v.dtype)
                             for k, v in data.items()} if named else
                [jmx.nd.array(v, dtype=v.dtype) for v in data])
    tpath = tmp_path / "port.params"
    conv = {k: tmx.nd.array(v, ctx=tmx.cpu(), dtype=v.dtype)
            for k, v in data.items()} if named else \
        [tmx.nd.array(v, ctx=tmx.cpu(), dtype=v.dtype) for v in data]
    tmx.nd.save(str(tpath), conv)
    assert tpath.read_bytes() == jpath.read_bytes()
    assert save_params(None, data) == jpath.read_bytes()


def test_jax_file_loads_bit_identical_in_port(tmp_path):
    data = _arrays(1)
    path = tmp_path / "jax.params"
    jmx.nd.save(str(path), {k: jmx.nd.array(v, dtype=v.dtype)
                            for k, v in data.items()})
    got = tmx.nd.load(str(path))
    assert list(got) == list(data)
    for k, v in data.items():
        a = got[k].asnumpy()
        assert a.dtype == v.dtype and a.tobytes() == v.tobytes(), k
        assert got[k].context == tmx.cpu()


def test_port_file_loads_bit_identical_in_jax(tmp_path):
    data = _arrays(2)
    path = tmp_path / "port.params"
    tmx.nd.save(str(path), {k: tmx.nd.array(v, ctx=tmx.cpu(), dtype=v.dtype)
                            for k, v in data.items()})
    got = jmx.nd.load(str(path))
    for k, v in data.items():
        a = got[k].asnumpy()
        assert a.dtype == v.dtype and a.tobytes() == v.tobytes(), k
    assert isinstance(load_params(path.read_bytes()), dict)


def test_checkpoint_pair_crosses_packages(tmp_path):
    sym = tmx.subgraph.partition_graph(tmx.model_zoo.vgg_symbol(11),
                                       "TPU_PALLAS")
    shapes, _, _ = sym.infer_shape(data=(1, 3, 32, 32))
    rng = np.random.RandomState(3)
    args = {n: rng.normal(0, 1, s).astype(np.float32)
            for n, s in zip(sym.list_arguments(), shapes) if n != "data"}
    port_args, _ = params_from_numpy(args, None, ctx=tmx.cpu())
    tmx.save_checkpoint(str(tmp_path / "port"), 3, sym, port_args, {})
    jsym, jargs, jaux = jmx.model.load_checkpoint(str(tmp_path / "port"), 3)
    assert jsym.tojson().count("_sg_pallas_fc_relu") == 2
    assert set(jargs) == set(args) and not jaux
    jmx.model.save_checkpoint(str(tmp_path / "jax"), 3, jsym, jargs, {})
    assert (tmp_path / "jax-0003.params").read_bytes() == \
        (tmp_path / "port-0003.params").read_bytes()
    psym, pargs, _ = tmx.load_checkpoint(str(tmp_path / "jax"), 3)
    assert psym.list_arguments() == sym.list_arguments()
    for k, v in args.items():
        assert pargs[k].asnumpy().tobytes() == v.tobytes()


def test_sparse_array_in_file_raises(tmp_path):
    """Sparse arrays in a file no longer raise: a row_sparse and a csr
    array written by the JAX package load in the port as the same
    storage types, and the port writes the same bytes."""
    from incubator_mxnet_tpu.ndarray import sparse
    from incubator_mxnet_tpu_torch.ndarray import sparse as tsparse
    rows = np.ones((2, 3), np.float32)
    path = tmp_path / "sparse.params"
    rs = sparse.RowSparseNDArray(data=rows, indices=np.array([0, 4]),
                                 shape=(6, 3))
    jmx.nd.save(str(path), {"w": rs})
    got = tmx.nd.load(str(path))["w"]
    assert isinstance(got, tsparse.RowSparseNDArray)
    np.testing.assert_array_equal(got.asnumpy(), rs.asnumpy())
    tmx.nd.save(str(tmp_path / "port.params"), {"w": got})
    assert (tmp_path / "port.params").read_bytes() == path.read_bytes()


def _sparse_pair(kind, mx, sparse, rng_seed=1):
    rng = np.random.RandomState(rng_seed)
    dense = ((rng.rand(5, 8) < 0.3) * rng.randn(5, 8)).astype(np.float32)
    ctx = {"ctx": tmx.cpu()} if mx is tmx else {}
    if kind == "csr":
        return sparse.csr_matrix(dense, **ctx), dense
    rows = rng.randn(3, 8).astype(np.float32)
    dense = np.zeros((7, 8), np.float32)
    dense[[1, 4, 6]] = rows
    return sparse.RowSparseNDArray(rows, np.array([1, 4, 6]), (7, 8),
                                   **ctx), dense


@pytest.mark.parametrize("kind", ["csr", "row_sparse"])
def test_sparse_bytes_equal_jax_bytes(tmp_path, kind):
    """A sparse array beside dense ones (int8 among them): the port's
    file is the JAX writer's byte for byte, and each package loads the
    other's file to the same storage type and values."""
    from incubator_mxnet_tpu.ndarray import sparse as jsparse
    from incubator_mxnet_tpu_torch.ndarray import sparse as tsparse
    q = np.random.RandomState(2).randint(-127, 128, (4, 5)).astype(np.int8)
    jarr, dense = _sparse_pair(kind, jmx, jsparse)
    tarr, _ = _sparse_pair(kind, tmx, tsparse)
    jmx.nd.save(str(tmp_path / "j.params"),
                {"s": jarr, "q": jmx.nd.array(q, dtype="int8")})
    tmx.nd.save(str(tmp_path / "t.params"),
                {"s": tarr, "q": tmx.nd.array(q, ctx=tmx.cpu(),
                                              dtype="int8")})
    assert (tmp_path / "t.params").read_bytes() == \
        (tmp_path / "j.params").read_bytes()
    mine = tmx.nd.load(str(tmp_path / "j.params"))
    theirs = jmx.nd.load(str(tmp_path / "t.params"))
    assert type(mine["s"]).__name__ == type(theirs["s"]).__name__ == \
        type(tarr).__name__
    for got in (mine, theirs):
        np.testing.assert_array_equal(got["s"].asnumpy(), dense)
        assert got["q"].asnumpy().dtype == np.int8
        np.testing.assert_array_equal(got["q"].asnumpy(), q)


def test_sparse_values_in_a_checkpoint_pair(tmp_path):
    """`save_checkpoint`/`load_checkpoint` carry a row_sparse and a csr
    value with the dense ones."""
    from incubator_mxnet_tpu_torch.ndarray import sparse as tsparse
    rs, rs_dense = _sparse_pair("row_sparse", tmx, tsparse)
    c, c_dense = _sparse_pair("csr", tmx, tsparse)
    sym = tmx.sym.FullyConnected(tmx.sym.Variable("data"), num_hidden=2,
                                 name="fc")
    w = tmx.nd.array(np.ones((2, 8), np.float32), ctx=tmx.cpu())
    tmx.model.save_checkpoint(str(tmp_path / "m"), 1, sym,
                              {"fc_weight": w, "rows": rs}, {"c": c})
    _, args, auxs = tmx.model.load_checkpoint(str(tmp_path / "m"), 1)
    assert isinstance(args["rows"], tsparse.RowSparseNDArray)
    assert isinstance(auxs["c"], tsparse.CSRNDArray)
    np.testing.assert_array_equal(args["rows"].asnumpy(), rs_dense)
    np.testing.assert_array_equal(auxs["c"].asnumpy(), c_dense)
    np.testing.assert_array_equal(args["fc_weight"].asnumpy(), 1.0)
