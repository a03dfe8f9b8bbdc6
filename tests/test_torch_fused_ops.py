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


# float16: both sides sum in fp32 (jnp.dot with preferred_element_type
# float32, torch on the fp32 copies) and round once to fp16, which may land
# one fp16 ulp (2**-10 relative) apart
FP16_TOL = dict(rtol=2.0 ** -9, atol=2.0 ** -9)


@pytest.mark.parametrize("m,k,n", [(8, 10, 16), (5, 784, 128)])
def test_fc_relu_fp16_matches_pallas_kernel(m, k, n):
    """K1's plain version in float16 (the dtype the card's kernels took
    last) against the interpreted Pallas kernel in float16."""
    x, w, b = (a.astype(np.float16) for a in _inputs(m, k, n, seed=4))
    want = np.asarray(_fc_relu_pallas(jnp.asarray(x), jnp.asarray(w),
                                      jnp.asarray(b)))
    assert want.dtype == np.float16
    got = fc_relu(*map(torch.from_numpy, (x, w, b)))
    assert got.dtype == torch.float16 and got.shape == (m, n)
    np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32),
                               **FP16_TOL)


def test_fc_relu_takes_non_contiguous_operands():
    """x and w as transposed views (strides (1, M) and (1, N)) and b as a
    strided slice give the contiguous operands' result, as the JAX kernel
    computes it; on the card the wrapper copies them to contiguous
    tensors and launches."""
    x, w, b = _inputs(5, 784, 128, seed=5)
    want = np.asarray(_fc_relu_pallas(jnp.asarray(x), jnp.asarray(w),
                                      jnp.asarray(b)))
    tx = torch.from_numpy(np.ascontiguousarray(x.T)).T
    tw = torch.from_numpy(np.ascontiguousarray(w.T)).T
    tb = torch.from_numpy(np.repeat(b, 2))[::2]
    assert not (tx.is_contiguous() or tw.is_contiguous()
                or tb.is_contiguous())
    got = fc_relu(tx, tw, tb)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    got = FCRelu.apply(tx, tw, tb)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL,
                               atol=ATOL)


# -- the tensor-core route's float32 arithmetic, emulated ------------------
#
# csrc/fc_relu.cu's tensor_core route in float32: x and w split into TF32
# hi and lo (cvt.rna: round to nearest, ties away), three TF32 products
# per k8 step (w_lo x_hi, w_hi x_lo, then w_hi x_hi) added to a tensor-core
# accumulator whose fp32 sums round toward zero, that accumulator added
# to a CUDA-core total (round to nearest) every PROMOTE elements of K,
# the split partials summed in split order, then bias and ReLU.  The
# tensor core's sum of one k8 step's 8 products is taken as exact.

def _tf32(a):
    """a (float32) rounded to TF32 as cvt.rna.tf32.f32 does."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _toward_zero(a):
    """float64 a rounded to float32 toward zero."""
    f = a.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(a)
    return np.where(over, np.nextafter(f, np.float32(0)), f)


def _emulate_k1_fp32(x, w, b, passes, k_chunk, promote):
    m, k = x.shape
    n = w.shape[0]
    steps = k // 8

    def k8_sums(a, c):           # exact sum of each k8 step: (steps, m, n)
        return np.einsum("msk,nsk->smn",
                         a.reshape(m, steps, 8).astype(np.float64),
                         c.reshape(n, steps, 8).astype(np.float64))
    xh, wh = _tf32(x), _tf32(w)
    terms = [k8_sums(xh, wh)]
    if passes == 3:
        terms = [k8_sums(xh, _tf32(w - wh)), k8_sums(_tf32(x - xh), wh),
                 terms[0]]
    total = np.zeros((m, n), np.float32)
    for k0 in range(0, k, k_chunk):
        part = np.zeros((m, n), np.float32)
        for p0 in range(k0, min(k, k0 + k_chunk), promote):
            span = range(p0 // 8, min(k, k0 + k_chunk, p0 + promote) // 8)
            acc = np.zeros((m, n), np.float32)
            order = [(s, sums) for s in span for sums in terms[:-1]]
            order += [(s, terms[-1]) for s in span]   # hi x hi last
            for s, sums in order:
                acc = _toward_zero(acc.astype(np.float64) + sums[s])
            part = (part + acc).astype(np.float32)
        total = (total + part).astype(np.float32)
    return np.maximum(total + b, 0).astype(np.float32)


def test_k1_fp32_route_arithmetic_meets_the_tolerance():
    """At VGG-16's fc6 (K = 25088), with the plan of M = 32 on 132 SMs (9
    K ranges of 2816) and the chosen promotion interval (one ring stage,
    32 of K), 3xTF32 meets chip_smoke's float32 tolerance (rtol 1e-4 +
    1e-4*max|ref|, against the exact product) at 1e-3 of it; one TF32
    pass misses it; and one unpromoted K chain of 25088 drifts over 20x
    further from the exact product than the promoted sums (the
    accumulator's rounding toward zero)."""
    x, w, b = _inputs(8, 25088, 32, seed=6)
    ref = np.maximum(x.astype(np.float64) @ w.astype(np.float64).T + b, 0)

    def err(**plan):
        got = _emulate_k1_fp32(x, w, b, **plan)
        d = np.abs(got - ref)
        bound = 1e-4 * np.abs(ref) + 1e-4 * np.abs(ref).max()
        return d.max(), (d / bound).max()
    promoted, share = err(passes=3, k_chunk=2816, promote=32)
    assert share < 0.01
    assert err(passes=1, k_chunk=2816, promote=32)[1] > 1
    assert err(passes=3, k_chunk=25088, promote=25088)[0] > 20 * promoted


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


# -- mixed operand dtypes ----------------------------------------------------
#
# The JAX kernel promotes inside (jnp.dot of a bf16 x and an fp32 w sums in
# fp32) and returns x's dtype; the port casts the operands to their
# promoted dtype, runs that kernel (here its plain version) and casts the
# result to x's dtype.  Both round one fp32 sum to x's dtype, which may
# land one ulp apart: 2**-8 relative in bf16, 2**-11 in fp16.
MIXED_TOL = {np.float32: (RTOL, ATOL), "bfloat16": (2.0 ** -7, 2.0 ** -8),
             np.float16: (2.0 ** -10, 2.0 ** -11)}


def _as(a, dt):
    """numpy float32 a -> (torch tensor, jax array) in dtype dt."""
    t = torch.from_numpy(a)
    if dt == "bfloat16":
        t = t.to(torch.bfloat16)
        return t, jnp.asarray(a).astype(jnp.bfloat16)
    return t.to(getattr(torch, np.dtype(dt).name)), jnp.asarray(a.astype(dt))


@pytest.mark.parametrize("xdt,wdt", [("bfloat16", np.float32),
                                     (np.float16, np.float32),
                                     (np.float32, "bfloat16"),
                                     ("bfloat16", np.float16)])
def test_fc_relu_mixed_dtypes_match_pallas_kernel(xdt, wdt):
    """bf16 x against fp32 w and b gives bf16, as the JAX kernel does; an
    fp32 x against bf16 parameters gives fp32."""
    x, w, b = _inputs(16, 784, 128, seed=9)
    tx, jx = _as(x, xdt)
    (tw, jw), (tb, jb) = _as(w, wdt), _as(b, wdt)
    want = _fc_relu_pallas(jx, jw, jb)
    got = fc_relu(tx, tw, tb)
    assert str(got.dtype).replace("torch.", "") == str(want.dtype)
    rtol, atol = MIXED_TOL[xdt]
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol,
                               atol=atol * np.abs(want).max())


def test_fc_relu_mixed_dtypes_backward_keeps_each_input_dtype():
    """FCRelu's gradients come back in each input's own dtype, computed
    in the promoted dtype: equal to the fp32 gradients of the same
    (bf16-exact) values, rounded once."""
    x, w, b = _inputs(8, 64, 32, seed=10)
    tx = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    g = torch.from_numpy(np.random.RandomState(1).rand(8, 32)
                         .astype(np.float32)).to(torch.bfloat16)
    FCRelu.apply(tx, tw, tb).backward(g)
    assert (tx.grad.dtype, tw.grad.dtype, tb.grad.dtype) == \
        (torch.bfloat16, torch.float32, torch.float32)
    rx = tx.detach().float().requires_grad_()
    rw, rb = (t.detach().clone().requires_grad_() for t in (tw, tb))
    FCRelu.apply(rx, rw, rb).backward(g.float())
    np.testing.assert_allclose(tx.grad.float().numpy(),
                               rx.grad.to(torch.bfloat16).float().numpy(),
                               rtol=2.0 ** -7, atol=1e-6)
    for got, want in ((tw.grad, rw.grad), (tb.grad, rb.grad)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("op,params,wshape", [
    ("FullyConnected", {"num_hidden": 12}, (12, 48)),
    ("Convolution", {"kernel": (3, 3), "num_filter": 4, "pad": (1, 1)},
     (4, 3, 3, 3)),
])
def test_fc_and_conv_mixed_dtypes_match_jax(op, params, wshape):
    """bf16 data against fp32 parameters: the output is bf16 in both.
    The JAX op rounds the parameters to bf16 first, the port computes in
    the promoted fp32, so they differ by that rounding (2**-9 relative
    per parameter, averaging out over the sum) and the output's rounding:
    rtol 2**-6, atol 2**-7*max."""
    from incubator_mxnet_tpu.ops import registry as jreg
    from incubator_mxnet_tpu_torch.ops import registry as treg
    rng = np.random.RandomState(11)
    x = rng.normal(0, 1, (2, 3, 4, 4)).astype(np.float32)
    w = (rng.normal(0, 1, wshape) / np.sqrt(np.prod(wshape[1:]))
         ).astype(np.float32)
    b = rng.normal(0, 0.1, wshape[:1]).astype(np.float32)
    tx, jx = _as(x, "bfloat16")
    want = jreg.get(op).fn(jreg.get(op).canonicalize_params(params), jx,
                           jnp.asarray(w), jnp.asarray(b))
    got = treg.get(op).fn(treg.get(op).canonicalize_params(params), tx,
                          torch.from_numpy(w), torch.from_numpy(b))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0 ** -6,
                               atol=2.0 ** -7 * np.abs(want).max())
