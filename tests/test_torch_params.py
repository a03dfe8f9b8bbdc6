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
    from incubator_mxnet_tpu.ndarray import sparse
    path = tmp_path / "sparse.params"
    rs = sparse.RowSparseNDArray(data=np.ones((2, 3), np.float32),
                                 indices=np.array([0, 4]), shape=(6, 3))
    jmx.nd.save(str(path), {"w": rs})
    with pytest.raises(tmx.MXNetError, match="dense arrays only"):
        tmx.nd.load(str(path))
