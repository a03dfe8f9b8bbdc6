"""The PyTorch port's fused FC+bias+ReLU (kernel K1) and its TPU_PALLAS
partitioning, held against the JAX package.

On the CPU the port's `fc_relu` runs its plain version; the JAX side runs
its Pallas kernel in interpret mode, as the JAX package's own tests do.
The CUDA kernel itself is tested on the card by
`test_torch_kernels_cuda.py`.
Inputs come from a numpy seed as float32 (conftest turns on x64 for JAX).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import subgraph as jsubgraph
from incubator_mxnet_tpu.subgraph.fused_ops import (_fc_relu_pallas,
                                                    _fused_fc_relu_fn)

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch.subgraph.fused_ops import FCRelu, fc_relu

# float32 dots of at most 784 unit-scale terms: the two frameworks sum in
# different orders, ~1e-7 absolute apart
RTOL, ATOL = 1e-5, 1e-6


def _inputs(m, k, n, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.normal(0, 1, (m, k)).astype(np.float32)
    w = (rng.normal(0, 1, (n, k)) / np.sqrt(k)).astype(np.float32)
    b = rng.normal(0, 0.1, (n,)).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("m,k,n", [(8, 10, 16), (5, 784, 128)])
def test_fc_relu_matches_pallas_kernel(m, k, n):
    x, w, b = _inputs(m, k, n)
    want = np.asarray(_fc_relu_pallas(jnp.asarray(x), jnp.asarray(w),
                                      jnp.asarray(b)))
    got = fc_relu(*map(torch.from_numpy, (x, w, b)))
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_fc_relu_bf16_plain_version_keeps_dtype():
    x, w, b = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _inputs(5, 784, 128))
    got = fc_relu(x, w, b)
    assert got.dtype == torch.bfloat16
    want = torch.relu(x.float() @ w.float().T + b.float())
    torch.testing.assert_close(got.float(), want.to(torch.bfloat16).float())


@pytest.mark.parametrize("m,k,n", [(8, 10, 16), (5, 784, 128)])
def test_fc_relu_gradients_match_custom_vjp(m, k, n):
    x, w, b = _inputs(m, k, n, seed=1)
    g = np.random.RandomState(2).normal(0, 1, (m, n)).astype(np.float32)
    _, vjp = jax.vjp(_fused_fc_relu_fn(), jnp.asarray(x), jnp.asarray(w),
                     jnp.asarray(b))
    want = vjp(jnp.asarray(g))
    tx, tw, tb = (torch.from_numpy(a).requires_grad_() for a in (x, w, b))
    FCRelu.apply(tx, tw, tb).backward(torch.from_numpy(g))
    for got, ref, name in zip((tx.grad, tw.grad, tb.grad), want,
                              ("x", "w", "b")):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                                   atol=ATOL, err_msg=name)


def test_fc_relu_rejects_bad_operands():
    x, w, b = map(torch.from_numpy, _inputs(4, 10, 6))
    with pytest.raises(tmx.MXNetError, match="dtype"):
        fc_relu(x, w.double(), b)
    with pytest.raises(tmx.MXNetError, match="shape"):
        fc_relu(x, w[:, :9], b)
    with pytest.raises(tmx.MXNetError, match="no kernel for device"):
        fc_relu(x.to("meta"), w.to("meta"), b.to("meta"))


def test_fc_relu_kernel_counts_only_cuda_launches():
    x, w, b = map(torch.from_numpy, _inputs(3, 10, 6))
    before = fc_relu.launches
    fc_relu(x, w, b)
    assert fc_relu.launches == before


# -- TPU_PALLAS partitioning (tests/test_subgraph.py, in the port) ----------

def _mlp(mod):
    data = mod.sym.Variable("data")
    h = mod.sym.FullyConnected(data, num_hidden=16, name="fc1")
    h = mod.sym.Activation(h, act_type="relu", name="relu1")
    h = mod.sym.FullyConnected(h, num_hidden=8, name="fc2")
    h = mod.sym.Activation(h, act_type="relu", name="relu2")
    return mod.sym.FullyConnected(h, num_hidden=4, name="fc3")


def test_partition_replaces_chains_like_jax():
    sym = _mlp(tmx)
    part = tmx.subgraph.partition_graph(sym, "TPU_PALLAS")
    js = part.tojson()
    assert js.count('"_sg_pallas_fc_relu"') == 2       # fc1/relu1, fc2/relu2
    assert "relu1_output" not in part.get_internals().list_outputs()
    jpart = jsubgraph.partition_graph(_mlp(jmx), "TPU_PALLAS")
    import json
    assert json.loads(js)["nodes"] == json.loads(jpart.tojson())["nodes"]


def test_partition_keeps_argument_surface():
    sym = _mlp(tmx)
    part = tmx.subgraph.partition_graph(sym, "TPU_PALLAS")
    assert part.list_arguments() == sym.list_arguments()
    assert part.infer_shape(data=(8, 10)) == sym.infer_shape(data=(8, 10))


def test_partition_convexity_guard():
    """A chain whose interior feeds an outside consumer must NOT fuse."""
    data = tmx.sym.Variable("data")
    fc = tmx.sym.FullyConnected(data, num_hidden=8, name="fc1")
    relu = tmx.sym.Activation(fc, act_type="relu")
    out = relu + fc                     # fc has a second consumer
    part = tmx.subgraph.partition_graph(out, "TPU_PALLAS")
    assert "_sg_pallas_fc_relu" not in part.tojson()


def test_partitioned_mlp_forward_matches_jax():
    sym = tmx.subgraph.partition_graph(_mlp(tmx), "TPU_PALLAS")
    jsym = jmx.sym.load_json(sym.tojson())
    rng = np.random.RandomState(3)
    x = rng.normal(0, 1, (5, 10)).astype(np.float32)
    shapes, _, _ = sym.infer_shape(data=x.shape)
    args = {n: rng.normal(0, 0.5, s).astype(np.float32)
            for n, s in zip(sym.list_arguments(), shapes) if n != "data"}
    exe = jsym.simple_bind(ctx=jmx.cpu(), grad_req="null", data=x.shape)
    exe.copy_params_from({k: jmx.nd.array(v) for k, v in args.items()}, {})
    want = exe.forward(is_train=False, data=jmx.nd.array(x))[0].asnumpy()
    gfn, arg_nodes, _ = tmx.sym.graph_eval_fn(sym, False)
    feed = {k: torch.from_numpy(v) for k, v in args.items()}
    feed["data"] = torch.from_numpy(x)
    got = gfn([feed[n.name] for n in arg_nodes], [])[0][0]
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
