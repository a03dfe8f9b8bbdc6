"""The port's attention (`ops.flash_attention`, `parallel.ring_attention`,
the ``BlockwiseAttention`` op) against the JAX package, on the CPU.

Inputs come from a numpy seed and go through both packages as float32.
The port runs its kernels' plain versions here (CPU tensors).  The JAX
side runs as its own tests do: with ``MXNET_FLASH_INTERPRET=1`` for the
interpreted Pallas kernel, without it for its `_partial_ref` fallback.
Tolerance 2e-5 (the JAX tests' own): fp32 sums over at most 64 keys in
different orders.  Rows that see no key are checked against the
interpreted kernel only: the JAX fallback gives l = kv_len there.
"""
import math
import os
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import test_utils as tu
from incubator_mxnet_tpu.ops import flash_attention as jfa
from incubator_mxnet_tpu.parallel.ring_attention import (
    blockwise_attention as jax_blockwise, ring_attention as jax_ring)

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch.ops import flash_attention as tfa
from incubator_mxnet_tpu_torch.parallel import (blockwise_attention,
                                                ring_attention)

TOL = dict(rtol=2e-5, atol=2e-5)


def _qkv(B, T, H, D, seed=0):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(B, T, H, D).astype(np.float32) for _ in range(3))


def _jax_partial(monkeypatch, interpret, q, k, v, *args):
    if interpret:
        monkeypatch.setenv("MXNET_FLASH_INTERPRET", "1")
    else:
        monkeypatch.delenv("MXNET_FLASH_INTERPRET", raising=False)
    out = jfa.flash_attention_partial(*(jnp.asarray(x) for x in (q, k, v)),
                                      *args)
    monkeypatch.delenv("MXNET_FLASH_INTERPRET", raising=False)
    return [np.asarray(x) for x in out]


def _port_partial(q, k, v, *args):
    return [x.numpy() for x in tfa.flash_attention_partial(
        *(torch.from_numpy(x) for x in (q, k, v)), *args)]


def _close(got, want, what):
    for g, w, name in zip(got, want, ("o", "m", "l")):
        np.testing.assert_allclose(g, w, err_msg=f"{what}: {name}", **TOL)


@pytest.mark.parametrize("offsets", [(0, 0), (64, 0), (32, 0)])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("block", [16, 32])
@pytest.mark.parametrize("shape", [(2, 64, 2, 16), (1, 32, 1, 8)])
def test_partial_matches_both_jax_routes(monkeypatch, shape, block, causal,
                                         offsets):
    q, k, v = _qkv(*shape)
    args = (*offsets, causal, block, block)
    got = _port_partial(q, k, v, *args)
    assert got[0].shape == shape and got[1].shape == (shape[0], shape[2],
                                                      shape[1])
    _close(got, _jax_partial(monkeypatch, True, q, k, v, *args),
           "interpreted kernel")
    _close(got, _jax_partial(monkeypatch, False, q, k, v, *args),
           "_partial_ref")


def test_rows_that_see_no_key_follow_the_kernel(monkeypatch):
    """Causal, every key after every query (q_off=0, k_off=64): the
    interpreted kernel skips every block, so m = -1e30, l = 0, o = 0."""
    q, k, v = _qkv(1, 32, 1, 8)
    args = (0, 64, True, 16, 16)
    got = _port_partial(q, k, v, *args)
    _close(got, _jax_partial(monkeypatch, True, q, k, v, *args),
           "interpreted kernel")
    assert (got[0] == 0).all() and (got[2] == 0).all()
    assert (got[1] == np.float32(-1e30)).all()


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("D", [20, 100, 130])
def test_padded_head_matches_the_interpreted_kernel(monkeypatch, D, causal):
    """The CUDA wrappers' head padding, through the plain version: q, k, v
    zero-padded to a multiple of 8 (`_pad_head`), scaled by 1/sqrt of the
    original D, o sliced back; against the JAX package's interpreted
    kernel at the unpadded D."""
    q, k, v = _qkv(1, 32, 2, D, seed=9)
    padded = [tfa._pad_head(torch.from_numpy(x)) for x in (q, k, v)]
    assert padded[0].shape[3] == -(-D // 8) * 8 > D
    o, m, l = tfa._ref_bthd(*padded, 16, 0, causal, 16,
                            scale=1.0 / math.sqrt(D))
    assert (o[..., D:] == 0).all()
    got = [o[..., :D].numpy(), m.numpy(), l.numpy()]
    _close(got, _jax_partial(monkeypatch, True, q, k, v, 16, 0, causal, 16,
                             16), "interpreted kernel")
    same = torch.zeros(1, 4, 1, 24)
    assert tfa._pad_head(same) is same


# float16 and head sizes past 128 (the kernels' column groups of O) and
# past 256 (the CUDA-core route), through the plain version here.  float16
# tolerance: o is rounded to fp16 (2**-11 relative) after fp32 sums taken
# in other orders, so the two roundings may land one fp16 ulp apart
# (2**-10 relative); 2e-3.
WIDE = [("float32", 136), ("float32", 200), ("float32", 256),
        ("float16", 16), ("float16", 136), ("float16", 256),
        ("float32", 264), ("float16", 320), ("float32", 512)]
WIDE_TOL = {"float32": TOL, "float16": dict(rtol=2e-3, atol=2e-3)}


def _as_dtype(arrays, dtype):
    return tuple(a.astype(np.float16 if dtype == "float16" else np.float32)
                 for a in arrays)


@pytest.mark.parametrize("route", ["whole", "stream"])
@pytest.mark.parametrize("offsets", [(0, 0), (32, 0)])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype,D", WIDE)
def test_partial_fp16_and_wide_heads(monkeypatch, dtype, D, causal, offsets,
                                     route):
    """K2 and K3's plain version at float16 and D = 136..512 against the
    JAX package's interpreted kernel of the same route (the stream route
    under a 0.001 MiB budget)."""
    if route == "stream":
        monkeypatch.setenv("MXNET_FLASH_VMEM_MB", "0.001")
    q, k, v = _as_dtype(_qkv(1, 32, 2, D, seed=D), dtype)
    assert tfa._route(32, D, getattr(torch, dtype)) == route
    args = (*offsets, causal, 16, 16)
    got = _port_partial(q, k, v, *args)
    assert got[0].dtype == q.dtype
    want = _jax_partial(monkeypatch, True, q, k, v, *args)
    for g, w, name in zip(got, want, ("o", "m", "l")):
        np.testing.assert_allclose(g.astype(np.float32), w.astype(np.float32),
                                   err_msg=name, **WIDE_TOL[dtype])


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype,D", [("float16", 16), ("float32", 136),
                                     ("float16", 200), ("float32", 256)])
def test_flash_attention_fp16_and_wide_heads(monkeypatch, dtype, D, causal):
    """Output and gradients of `FlashAttention` at float16 and D past 128
    against jax.grad through the JAX custom VJP over the interpreted
    kernel.  float16: out and the gradients are rounded to fp16 after
    fp32 math that starts from the fp16 out (the same in both), so a few
    fp16 ulps of the largest value."""
    monkeypatch.setenv("MXNET_FLASH_INTERPRET", "1")
    q, k, v = _as_dtype(_qkv(2, 32, 2, D, seed=D + 1), dtype)
    tgt = _as_dtype([np.random.RandomState(2).randn(*q.shape)], dtype)[0]

    def jloss(q, k, v):
        out = jfa.flash_attention(q, k, v, causal, 16, 16)
        return jnp.sum((out.astype(jnp.float32) - tgt.astype(np.float32))
                       ** 2)

    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    jout = jfa.flash_attention(jq, jk, jv, causal, 16, 16)
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, causal, 16, 16)
    assert out.dtype == tq.dtype
    ((out.float() - torch.from_numpy(tgt).float()) ** 2).sum().backward()
    tol = 5e-4 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(out.detach().float().numpy(),
                               np.asarray(jout, np.float32), rtol=tol,
                               atol=tol)
    for got, want, name in zip((tq.grad, tk.grad, tv.grad), jgrads, "qkv"):
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                                   atol=tol * max(1.0, np.abs(want).max()),
                                   err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
def test_unreadable_layouts_are_copied(monkeypatch, causal):
    """Operands the kernels cannot read as they lie (a stride of 13
    elements, a head dimension with stride 2, data 4 bytes past an aligned
    address) become fresh contiguous copies (`_readable`), and a readable
    operand is passed through; the partial attention of such operands
    (the plain version here) matches the interpreted JAX kernel."""
    q, k, v = _qkv(1, 32, 2, 13, seed=11)
    tq = torch.from_numpy(q)[..., :12]                   # strides of 13
    tk = torch.from_numpy(np.repeat(k[..., :12], 2, axis=3))[..., ::2]
    flat = torch.zeros(v[..., :12].size + 1)
    tv = flat[1:].view(1, 32, 2, 12).copy_(torch.from_numpy(v[..., :12]))
    assert tq.stride()[2] == 13 and tk.stride()[3] == 2
    assert tv.data_ptr() % 16 == 4
    for t in (tq, tk, tv):
        c = tfa._readable(t)
        assert c is not t and c.is_contiguous() and c.data_ptr() % 16 == 0
        assert torch.equal(c, t)
    ready = torch.zeros(1, 32, 2, 16)
    assert tfa._readable(ready) is ready
    args = (0, 0, causal, 16, 16)
    got = [x.numpy() for x in tfa.flash_attention_partial(tq, tk, tv,
                                                          *args)]
    want = _jax_partial(monkeypatch, True, *(x.numpy() for x in
                                             (tq, tk, tv)), *args)
    _close(got, want, "interpreted kernel")


def _tf32(x):
    """x rounded to TF32 (10 mantissa bits, to nearest, ties away from
    zero, as cvt.rna.tf32.f32), on the bits of the fp32 values."""
    u = x.contiguous().view(torch.int32)
    return ((u + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(x):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _emulate_fp32_route(q3, k3, v3, q_off, k_off, causal, passes=3):
    """The fp32 route of K2 in plain torch on (BH, T, D) float32: the
    kernel's KV tiles (64 keys at D <= 64, 32 at D <= 128, 16 above), q
    scaled then split into TF32 hi and lo, K, V and p split the same
    way, each product as 3 TF32 products summed in fp32 (passes=3) or
    hi x hi alone (passes=1), exp as 2**(s log2(e) - m log2(e))."""
    BH, Tq, D = q3.shape
    Tk = k3.shape[1]
    bk = 64 if D <= 64 else 32 if D <= 128 else 16
    log2e = 1.4426950408889634
    qh, ql = _split(q3 * (1.0 / math.sqrt(D)))
    m = torch.full((BH, Tq), -1e30)
    l = torch.zeros(BH, Tq)
    acc = torch.zeros(BH, Tq, D)
    q_pos = q_off + torch.arange(Tq)

    def product(ah, al, bh, bl):
        hi = ah @ bh
        return hi if passes == 1 else hi + (ah @ bl + al @ bh)

    for i in range(-(-Tk // bk)):
        kh, kl = _split(k3[:, i * bk:(i + 1) * bk])
        vh, vl = _split(v3[:, i * bk:(i + 1) * bk])
        s = product(qh, ql, kh.transpose(1, 2), kl.transpose(1, 2))
        if causal:
            k_pos = k_off + i * bk + torch.arange(kh.shape[1])
            s = s.masked_fill(q_pos[:, None] < k_pos[None, :], -math.inf)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp2(s * log2e - (m_new * log2e)[..., None])
        alpha = torch.exp2((m - m_new) * log2e)
        l = l * alpha + p.sum(dim=-1)
        ph, pl = _split(p)
        acc = acc * alpha[..., None] + product(ph, pl, vh, vl)
        m = m_new
    return acc, m, l


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("D", [64, 128, 256])
def test_3xtf32_arithmetic_meets_the_fp32_tolerance(monkeypatch, D, causal):
    """The fp32 route's arithmetic (3xTF32 products on the kernel's tiles),
    emulated in plain torch, against the JAX package's interpreted kernel
    at the card's fp32 tolerance (rtol 1e-4, atol 1e-5*max|o|); one TF32
    pass alone misses it."""
    q, k, v = _qkv(1, 100, 2, D, seed=D + 2)
    args = (0, 0, causal, 256, 256)
    want = _jax_partial(monkeypatch, True, q, k, v, *args)
    q3, k3, v3 = (tfa._to3(torch.from_numpy(x)) for x in (q, k, v))

    def close(passes):
        o3, m3, l3 = _emulate_fp32_route(q3, k3, v3, 0, 0, causal, passes)
        got = (o3.reshape(1, 2, 100, D).permute(0, 2, 1, 3),
               m3.reshape(1, 2, 100), l3.reshape(1, 2, 100))
        return all(np.allclose(g.numpy(), w, rtol=1e-4,
                               atol=1e-5 * np.abs(w).max())
                   for g, w in zip(got, want))
    assert close(3)
    assert not close(1)


@pytest.mark.parametrize("causal", [False, True])
def test_ragged_length(monkeypatch, causal):
    """T = 48: the JAX kernel halves its blocks of 32 to 16; the port's
    plain version keeps 32 and a ragged last block."""
    q, k, v = _qkv(2, 48, 2, 16, seed=3)
    args = (0, 0, causal, 32, 32)
    got = _port_partial(q, k, v, *args)
    _close(got, _jax_partial(monkeypatch, True, q, k, v, *args),
           "interpreted kernel")
    _close(got, _jax_partial(monkeypatch, False, q, k, v, *args),
           "_partial_ref")


@pytest.mark.parametrize("offsets", [(0, 0), (32, 0)])
@pytest.mark.parametrize("causal", [False, True])
def test_stream_route(monkeypatch, causal, offsets):
    """A budget of 0.001 MiB sends both packages down the KV-streaming
    route (K3; the interpreted `_fwd_kernel_stream` on the JAX side)."""
    monkeypatch.setenv("MXNET_FLASH_VMEM_MB", "0.001")
    q, k, v = _qkv(2, 64, 2, 16, seed=4)
    assert tfa._route(64, 16, torch.float32) == "stream"
    before = (tfa.flash_fwd.launches, tfa.flash_fwd_stream.launches)
    args = (*offsets, causal, 16, 16)
    got = _port_partial(q, k, v, *args)
    # CPU tensors take the plain version: no kernel launch is counted
    assert (tfa.flash_fwd.launches, tfa.flash_fwd_stream.launches) == before
    _close(got, _jax_partial(monkeypatch, True, q, k, v, *args),
           "interpreted stream kernel")


# Mixed dtypes: a 16-bit q against fp32 k and v.  Both packages run the
# promoted fp32 arithmetic (the JAX kernel's q.k and p.v promote; the port
# casts q up and runs the fp32 kernel) and return o in q's dtype.  D = 16:
# the scale 1/4 is exact in every dtype, so m and l agree to fp32 (TOL)
# and o up to its one rounding to q's dtype (one ulp: 2**-8 relative in
# bf16, 2**-11 in fp16).
MIXED_O_TOL = {"bfloat16": (2.0 ** -7, 2.0 ** -8),
               "float16": (2.0 ** -10, 2.0 ** -11)}


@pytest.mark.parametrize("qdt", ["bfloat16", "float16"])
@pytest.mark.parametrize("budget", [None, "0.001"])
@pytest.mark.parametrize("causal", [False, True])
def test_partial_mixed_dtypes_match_both_jax_routes(monkeypatch, qdt, budget,
                                                    causal):
    """q in 16 bits, k and v in fp32, through K2's route and (budget
    0.001 MiB) K3's, against the JAX package's interpreted kernels."""
    if budget is None:
        monkeypatch.delenv("MXNET_FLASH_VMEM_MB", raising=False)
    else:
        monkeypatch.setenv("MXNET_FLASH_VMEM_MB", budget)
    q, k, v = _qkv(2, 64, 2, 16, seed=12)
    tq = torch.from_numpy(q).to(getattr(torch, qdt))
    jq = jnp.asarray(q).astype(getattr(jnp, qdt))
    assert tfa._route(64, 16, tq.dtype) == \
        ("stream" if budget else "whole")
    args = (32, 0, causal, 16, 16)
    got = tfa.flash_attention_partial(tq, torch.from_numpy(k),
                                      torch.from_numpy(v), *args)
    monkeypatch.setenv("MXNET_FLASH_INTERPRET", "1")
    want = jfa.flash_attention_partial(jq, jnp.asarray(k), jnp.asarray(v),
                                       *args)
    assert got[0].dtype == tq.dtype and want[0].dtype == jq.dtype
    assert got[1].dtype == got[2].dtype == torch.float32
    wo = np.asarray(want[0].astype(jnp.float32))
    rtol, atol = MIXED_O_TOL[qdt]
    np.testing.assert_allclose(got[0].float().numpy(), wo, rtol=rtol,
                               atol=atol * np.abs(wo).max())
    for g, w, name in zip(got[1:], want[1:], ("m", "l")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **TOL)


@pytest.mark.parametrize("budget", [None, "4", "0.001", "64"])
def test_route_matches_jax_rule(monkeypatch, budget):
    if budget is None:
        monkeypatch.delenv("MXNET_FLASH_VMEM_MB", raising=False)
    else:
        monkeypatch.setenv("MXNET_FLASH_VMEM_MB", budget)
    for kv_len, d, tdt, ndt in [(64, 16, torch.float32, np.float32),
                                (32, 8, torch.float32, np.float32),
                                (8192, 64, torch.bfloat16, jnp.bfloat16),
                                (8192, 64, torch.float32, np.float32),
                                (32768, 64, torch.bfloat16, jnp.bfloat16),
                                (32768, 64, torch.float32, np.float32)]:
        jax_stream = 2 * kv_len * d * np.dtype(ndt).itemsize > \
            jfa._vmem_budget_bytes()
        assert tfa._route(kv_len, d, tdt) == (
            "stream" if jax_stream else "whole"), (kv_len, d, tdt, budget)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_forward_and_gradients(causal):
    """Output and dq, dk, dv of sum((out - tgt)^2): torch autograd through
    `FlashAttention` against jax.grad through the JAX custom VJP."""
    q, k, v = _qkv(2, 32, 2, 16)
    tgt = np.random.RandomState(1).randn(*q.shape).astype(np.float32)

    def jloss(q, k, v):
        return jnp.sum((jfa.flash_attention(q, k, v, causal, 16, 16)
                        - tgt) ** 2)

    jout = jfa.flash_attention(*(jnp.asarray(x) for x in (q, k, v)),
                               causal, 16, 16)
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, causal, 16, 16)
    ((out - torch.from_numpy(tgt)) ** 2).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=5e-4, atol=5e-4)
    for got, want, name in zip((tq.grad, tk.grad, tv.grad), jgrads, "qkv"):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=5e-4, atol=5e-4, err_msg=name)


@pytest.mark.parametrize("block", [None, 16, 24])
@pytest.mark.parametrize("causal", [False, True])
def test_blockwise_attention(causal, block):
    q, k, v = _qkv(2, 64, 2, 16, seed=5)
    want = jax_blockwise(*(jnp.asarray(x) for x in (q, k, v)),
                         block_size=block, causal=causal)
    got = blockwise_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                              block_size=block, causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_blockwise_attention_op_through_the_symbol_interpreter(causal):
    rng = np.random.RandomState(6)
    x = {n: rng.randn(2, 32, 12).astype(np.float32) for n in "qkv"}
    params = dict(num_heads=3, causal=causal, block_size=8)

    jsym = jmx.sym.BlockwiseAttention(*(jmx.sym.var(n) for n in "qkv"),
                                      name="att", **params)
    exe = jsym.simple_bind(ctx=jmx.cpu(), grad_req="null",
                           **{n: a.shape for n, a in x.items()})
    want = exe.forward(is_train=False, **{n: jmx.nd.array(a)
                                          for n, a in x.items()})[0]
    tsym = tmx.sym.load_json(jsym.tojson())
    gfn, arg_nodes, _ = tmx.sym.graph_eval_fn(tsym, False)
    got = gfn([torch.from_numpy(x[n.name]) for n in arg_nodes], [])[0][0]
    np.testing.assert_allclose(got.numpy(), want.asnumpy(), **TOL)
    assert tsym.infer_shape(q=(2, 32, 12), k=(2, 32, 12),
                            v=(2, 32, 12))[1] == [(2, 32, 12)]
    naive = tmx.ops.attention.naive_attention(
        *(torch.from_numpy(x[n]) for n in "qkv"), 3, causal)
    np.testing.assert_allclose(naive.numpy(), want.asnumpy(), **TOL)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_without_a_group(causal, use_pallas):
    """No process group: a ring of one, equal to blockwise attention."""
    q, k, v = _qkv(2, 64, 2, 16, seed=7)
    want = jax_blockwise(*(jnp.asarray(x) for x in (q, k, v)),
                         causal=causal)
    got = ring_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                         causal=causal, use_pallas=use_pallas)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


RING_WORLD = 4
RING_DEADLINE_S = 120.0


@pytest.mark.skipif(not tu.has_stable_shard_map(),
                    reason="this jax build lacks the stable jax.shard_map "
                           "API the JAX ring is written against")
def test_ring_attention_four_gloo_ranks(tmp_path):
    """Four spawned ranks on a gloo group (a FileStore, no TCP ports) each
    hold one sequence shard; every rank's output shard equals the JAX
    package's 4-device shard_map ring, for use_pallas False and True and
    causal and not."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P
    from incubator_mxnet_tpu import parallel as par
    import torch.multiprocessing as tmp_mp
    import _torch_ring_worker as worker

    q, k, v = _qkv(2, 64, 2, 16, seed=8)
    inputs = tmp_path / "qkv.npz"
    np.savez(inputs, q=q, k=k, v=v)
    ctx = tmp_mp.get_context("spawn")
    procs = [ctx.Process(target=worker.run,
                         args=(r, RING_WORLD, str(tmp_path / "store"),
                               str(inputs), str(tmp_path)),
                         name=f"ring-rank-{r}")
             for r in range(RING_WORLD)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + RING_DEADLINE_S
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        hung = [p.name for p in procs if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    assert not hung, f"ranks past the {RING_DEADLINE_S:.0f} s deadline: {hung}"
    assert [p.exitcode for p in procs] == [0] * RING_WORLD

    mesh = par.make_mesh({"sp": RING_WORLD},
                         devices=jax.devices()[:RING_WORLD])
    shard = q.shape[1] // RING_WORLD
    for causal in (False, True):
        for use_pallas in (False, True):
            fn = shard_map(
                lambda a, b, c: jax_ring(
                    a, b, c, "sp", causal=causal, use_pallas=use_pallas),
                mesh=mesh, in_specs=(P(None, "sp"),) * 3,
                out_specs=P(None, "sp"), check_vma=False)
            want = np.asarray(jax.jit(fn)(*(jnp.asarray(x)
                                            for x in (q, k, v))))
            for r in range(RING_WORLD):
                got = np.load(os.path.join(
                    tmp_path, f"r{r}_c{int(causal)}_p{int(use_pallas)}.npy"))
                np.testing.assert_allclose(
                    got, want[:, r * shard:(r + 1) * shard],
                    err_msg=f"rank {r} causal={causal} "
                            f"use_pallas={use_pallas}", **TOL)
