"""The port's CUDA kernels on a card against their plain PyTorch versions:
K1 (`fc_relu`, csrc/fc_relu.cu) and its launch plan; K2 and K3
(`flash_fwd`, `flash_fwd_stream`, csrc/flash_attn.cu) and K3's split plan;
the kernels on mixed operand dtypes; a few `Module` steps of the MNIST
mlp on the card against the CPU; BatchNorm and fused train steps of a
thumbnail ResNet on the card against the CPU; the plain gluon loop on a
hybridized thumbnail ResNet v2 on the card against the CPU, and the
fused gluon step against the eager loop on the card; the checkpoint
plane's pinned staging ordered before the next in-place update, and an
optimizer blob written on the card loading where there is none; the
`RNN` op's cuDNN route against its plain loop, control flow, and the
bucketed LSTM language model's `BucketingModule.fit` on the card
against the CPU; the native IO library's build, the h2d ring's card
batches against the host batches, ImageNormalize on the card against
the host fp32 finish and `TopKAccuracy.device_update` on the card; the
detection, spatial and deformable ops on the card against the CPU, the
NMS route against its per-box loop, and two steps of a small SSD; the
kvstore's cases with their values on the card against the CPU, two
contexts on the one card against one (K1 in each executor),
wide_deep.py's copy at 2 000 rows on the card against the CPU; the
registry's tail (phase 15a's cases), the CTC and Deconvolution routes
against their plain versions, random draws on the card, and the mlp as
a SequentialModule under a Monitor (K1 in both modules); the mlp
through `model.FeedForward` (K1), the C predict ABI's shim and
`c_predict` with dev_type 2, `test_utils.check_consistency` over
[cpu(0), gpu(0)] and a `Module(state_names=)` step; K1 at AlexNet's fc6
(9216 -> 4096) and AlexNet's first Module.fit steps on the card against
the CPU; the quantized FC's float64 route exact at fc8's K, and a LibSVM
CSR batch densified on the card; K1's launch counter exact across
threads, and a router over two LocalReplicas on the card against the
CPU; a traced LocalReplica whose batch spans and K1 count agree, and K1
at the mlp's small weights on cuda_core against `fc_relu_ref`; the
training guardian's mlp step with K1 (no synchronizing call between
polls beyond the unguarded step's, a NaN-injected step leaving every
weight and momentum bit for bit) and a torn ``checkpoint.commit`` never
resumed from.

Every test here needs a card and skips without one.  The module imports
no JAX, so on a machine with a card and no JAX it runs alone:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernels_cuda.py

`chip_smoke.py` covers the full VGG-16 and long-context attention shapes.
"""
import os
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.ops import flash_attention as fa
from incubator_mxnet_tpu_torch.subgraph.fused_ops import (ROUTES, fc_relu,
                                                          fc_relu_ref,
                                                          launch_plan)


def _inputs(m, k, n, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.normal(0, 1, (m, k)).astype(np.float32)
    w = (rng.normal(0, 1, (n, k)) / np.sqrt(k)).astype(np.float32)
    b = rng.normal(0, 0.1, (n,)).astype(np.float32)
    return x, w, b


@pytest.mark.cuda
def test_launch_plan_covers_k_and_fills_the_card():
    """The kernel library's own launch plan (it lives beside the tile
    constants in csrc/fc_relu.cu), for the library's route and each
    route asked for: cuda_core blocks of 1-8 rows of x stepping K by
    32 lane loads; tensor_core M tiles of 8-64 rows stepping K by 128
    bytes (a ring stage), its float32 workspace holding x_hi and x_lo
    before the split partials; K covered by the splits; the VGG-16
    classifier filling the card (tensor_core: in one wave)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for m, k, n, dt in [(1, 25088, 4096, torch.float32),
                        (8, 4096, 4096, torch.bfloat16),
                        (32, 25088, 4096, torch.float32),
                        (32, 25088, 4096, torch.bfloat16),
                        (128, 4096, 4096, torch.float16),
                        (5, 784, 128, torch.float32),
                        (8, 10, 16, torch.float32)]:
        x = torch.zeros(m, k, dtype=dt, device="cuda")
        w = torch.zeros(n, k, dtype=dt, device="cuda")
        wide = 16 // x.element_size()
        chosen = launch_plan(x, w)
        assert chosen["route"] in ROUTES
        if k % wide:
            assert chosen["route"] == "cuda_core"
            assert launch_plan(x, w, "tensor_core") is None
        for route in ROUTES:
            plan = launch_plan(x, w, route)
            if plan is None:
                continue
            assert plan["route"] == route
            if route == chosen["route"]:
                assert plan == chosen
            splits, k_chunk = plan["splits"], plan["k_chunk"]
            assert k_chunk % plan["step"] == 0
            assert splits * k_chunk >= k > (splits - 1) * k_chunk
            partials = splits * m * n if splits > 1 else 0
            if route == "cuda_core":
                vec = plan["vec"]
                assert vec == (wide if k % wide == 0 else 1)
                assert plan["rows"] >= min(m, 8)
                assert plan["rows"] in (1, 2, 4, 8)
                assert plan["step"] == 32 * vec
                assert plan["workspace"] == partials
                blocks = -(-m // plan["rows"]) * -(-n // 32) * splits
                if k == 25088:
                    assert blocks >= sms    # at least a block per SM
            else:
                assert plan["vec"] == 0 and plan["step"] == wide * 8
                assert plan["rows"] in (8, 16, 32, 64)
                assert plan["rows"] >= min(m, 32)
                hilo = 2 * m * k if dt == torch.float32 else 0
                assert plan["workspace"] == partials + hilo
                blocks = -(-m // plan["rows"]) * -(-n // 128) * splits
                if k == 25088:
                    # one wave of two blocks per SM, at least 90 % full
                    assert 0.9 * 2 * sms <= blocks <= 2 * sms
    x = torch.zeros(2, 64, device="cuda")
    too_wide = torch.zeros(1, 64, device="cuda").expand(2 ** 21 + 1, 64)
    assert launch_plan(x, too_wide) is None


# K1 vs its plain version.  float32: the same fp32 products (3xTF32 on
# the tensor cores, ~2**-21 relative each) summed in other orders.  16-bit:
# both round an fp32 sum to the dtype, which may land one ulp apart
# (2**-8 relative in bf16, 2**-11 in fp16).
K1_TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -6,
          torch.float16: 2.0 ** -9}
# (M, K, N): every M tile edge of both routes, ragged N, and K % 4 != 0
# (a row stride TMA cannot read: cuda_core only)
K1_SHAPES = ([(m, 1024, 256) for m in (1, 7, 8, 9, 16, 32, 33, 128)]
             + [(5, 784, 128), (8, 10, 16), (3, 4096, 100), (40, 2048, 100),
                (9, 4098, 64)])


def _k1_call(x, w, b, route=None):
    before = fc_relu.launches
    got = fc_relu(x, w, b, route)
    torch.cuda.synchronize()
    assert fc_relu.launches == before + 1
    tol = K1_TOL[x.dtype]
    torch.testing.assert_close(got.float(), fc_relu_ref(x, w, b).float(),
                               rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_fc_relu_kernel_on_card(dtype):
    """K1 on the card against its plain version, through the library's
    route and each route that takes the shape; the route the plan
    reports; non-contiguous operands (copied) and an x 4 bytes past an
    aligned address (cuda_core in 16-bit, whose TMA reads x directly).
    The chip smoke covers the full VGG-16 shapes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card")
    dt = getattr(torch, dtype)
    wide = 16 // torch.empty((), dtype=dt).element_size()
    for m, k, n in K1_SHAPES:
        x, w, b = (torch.from_numpy(a).to("cuda", dt)
                   for a in _inputs(m, k, n))
        plan = launch_plan(x, w)
        if k % wide:
            assert plan["route"] == "cuda_core"
        _k1_call(x, w, b)
        for route in ROUTES:
            if launch_plan(x, w, route) is not None:
                _k1_call(x, w, b, route)
    x, w, b = (torch.from_numpy(a).to("cuda", dt)
               for a in _inputs(33, 1024, 256, seed=1))
    _k1_call(x.T.contiguous().T, w.T.contiguous().T, b)   # strides (1, M)
    flat = torch.empty(33 * 1024 + wide, dtype=dt, device="cuda")
    shift = 4 // flat.element_size()
    xs = flat[shift:shift + 33 * 1024].view(33, 1024).copy_(x)
    assert xs.data_ptr() % 16 == 4
    if dt == torch.float32:     # TMA reads x's TF32 halves, not x
        assert launch_plan(xs, w, "tensor_core") is not None
    else:
        assert launch_plan(xs, w, "tensor_core") is None
        plan = launch_plan(xs, w)
        assert plan["route"] == "cuda_core" and plan["vec"] == 1
    _k1_call(xs, w, b)
    for route in ROUTES:
        if launch_plan(xs, w, route) is not None:
            _k1_call(xs, w, b, route)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card")


def _attn_inputs(B, T, H, D, dtype, seed=0, Tk=None):
    """q (B, T, H, D) and k, v (B, Tk, H, D), Tk = T by default."""
    rng = np.random.RandomState(seed)
    return tuple(torch.from_numpy(rng.normal(0, 1, (B, t, H, D)).astype(
        np.float32)).to("cuda", dtype) for t in (T, Tk or T, Tk or T))


def _packed_inputs(B, T, H, D, dtype, seed=0):
    """q, k, v as views of one packed (B, T, 3, H, D) tensor."""
    rng = np.random.RandomState(seed)
    qkv = torch.from_numpy(rng.normal(0, 1, (B, T, 3, H, D)).astype(
        np.float32)).to("cuda", dtype)
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]


# fp32: kernel and plain version add the same terms in other orders, the
# kernel's products 3xTF32 (about 2^-21 relative each; 1e-6 relative at
# these lengths).  bf16: o is rounded to bf16 (2**-8 relative), and every
# p is rounded to bf16 against a running max that depends on the tiling;
# where the split-KV kernel's ranges differ from the plain version's
# blocks, that rounding noise (2**-9 of each p*v term) reaches
# 0.0044*max|o| at T = 100..128 (a CPU emulation of the split), hence
# atol 2**-7*max|plain|.  fp16: the same with 3 more mantissa bits (2**-11
# rounding of o, 2**-12 of each p*v term): 2**-8, 2**-9*max|plain|.
ATTN_TOL = {torch.float32: (1e-4, 1e-5),
            torch.bfloat16: (2.0 ** -6, 2.0 ** -7),
            torch.float16: (2.0 ** -8, 2.0 ** -9)}


def _assert_partial_close(got, want, dtype):
    rtol, atol = ATTN_TOL[dtype]
    for g, w, name in zip(got, want, ("o", "m", "l")):
        w = w.float()
        torch.testing.assert_close(
            g.float(), w, rtol=rtol, atol=atol * max(w.abs().max().item(),
                                                     1.0),
            msg=lambda m, name=name: f"{name}: {m}")


# (B, Tq, Tk, H, D) of test_flash_kernels_on_card, every dtype: D 16, 64
# and 128 and a ragged T = 100; every head size the TMA boxes treat
# differently (8, 24 and 96 zero-filled past D, 100 padded by the
# wrapper), a ragged T = 1000 over several KV tiles, and Tq != Tk both
# ways; above D = 128, two column groups of O: 136 (the second group 8
# columns wide), 200 and 256; above 256 (the CUDA-core route), 264 (a
# third group 8 columns wide and a 64-column chunk of D with 8), 320 and
# 512, at ragged T
ATTN_SHAPES = [(2, 64, 64, 2, 16), (1, 100, 100, 2, 64), (2, 128, 128, 1, 128),
               (1, 64, 64, 2, 100)]
ATTN_SHAPES_EDGE = [(1, 130, 130, 2, 8), (1, 200, 200, 1, 24),
                    (2, 256, 256, 1, 96), (1, 1000, 1000, 2, 64),
                    (1, 100, 100, 1, 128), (1, 64, 320, 2, 64),
                    (1, 320, 64, 1, 64)]
ATTN_SHAPES_WIDE = [(1, 100, 100, 2, 136), (1, 130, 200, 1, 200),
                    (2, 96, 96, 1, 256), (1, 300, 300, 1, 256)]
ATTN_SHAPES_PAST_256 = [(1, 100, 100, 2, 264), (1, 130, 200, 1, 320),
                        (1, 200, 70, 1, 512)]
# (q_off, k_off): 32 and 96 put the diagonal inside a 128-row q tile
ATTN_OFFSETS = [(0, 0), (64, 0), (32, 0), (96, 0)]


def _check_call(fwd, dt, q, k, v, q_off, k_off, causal):
    before = fwd.launches
    got = fwd(q, k, v, q_off, k_off, causal)
    torch.cuda.synchronize()
    assert fwd.launches == before + 1
    B, Tq, H, D = q.shape
    assert got[0].dtype == dt and got[0].shape == q.shape
    assert got[1].shape == got[2].shape == (B, H, Tq)
    want = fa._ref_bthd(q, k, v, q_off, k_off, causal, 64)
    _assert_partial_close(got, want, dt)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("wrapper", ["flash_fwd", "flash_fwd_stream"])
def test_flash_kernels_on_card(wrapper, dtype):
    """K2 and K3 against `_partial_ref` at small shapes (ATTN_SHAPES,
    ATTN_SHAPES_EDGE, ATTN_SHAPES_WIDE, ATTN_SHAPES_PAST_256), causal and
    not, at ring offsets; the fully-above shard; q, k, v sliced from one
    packed tensor."""
    _need_card()
    dt = getattr(torch, dtype)
    fwd = getattr(fa, wrapper)
    for B, Tq, Tk, H, D in (ATTN_SHAPES + ATTN_SHAPES_EDGE + ATTN_SHAPES_WIDE
                            + ATTN_SHAPES_PAST_256):
        q, k, v = _attn_inputs(B, Tq, H, D, dt, Tk=Tk)
        for causal in (False, True):
            for q_off, k_off in ATTN_OFFSETS:
                _check_call(fwd, dt, q, k, v, q_off, k_off, causal)
        # every key after every query: the contract for rows with no key
        got = fwd(q, k, v, 0, Tq, True)
        torch.cuda.synchronize()
        assert (got[0] == 0).all() and (got[2] == 0).all()
        assert (got[1] == -1e30).all()
    q, k, v = _packed_inputs(2, 200, 2, 64, dt)
    assert not q.is_contiguous()
    for causal in (False, True):
        _check_call(fwd, dt, q, k, v, 0, 0, causal)


@pytest.mark.cuda
def test_wgmma_tf32_facts_the_fp32_route_relies_on(tmp_path):
    """tests/cuda/wgmma_tf32_probe.cu: the tf32 A fragment the fp32 route
    feeds P in (a1 is row + 8, a2 column + 4), and 128-byte-swizzled
    K-major operands with 32-byte k-steps.  Whatever the card does with an
    operand's low 13 bits, the route rounds hi and lo itself."""
    _need_card()
    from incubator_mxnet_tpu_torch.kernels import _build
    exe = tmp_path / "probe"
    subprocess.run([_build._nvcc(), "-gencode",
                    "arch=compute_90a,code=sm_90a", "-o", str(exe),
                    str(Path(__file__).parent / "cuda" /
                        "wgmma_tf32_probe.cu")],
                   check=True, capture_output=True, timeout=600)
    out = subprocess.run([str(exe)], check=True, capture_output=True,
                         text=True, timeout=60).stdout
    print(out)
    facts = dict(line.split() for line in out.splitlines())
    assert facts["a_fragment"] == "rows_plus_8"
    assert facts["kmajor_swizzled"] == "exact"
    assert facts["low_bits"] in ("truncate", "round", "keep")


@pytest.mark.cuda
def test_flash_routes_by_budget(monkeypatch):
    """The budget picks K2 or K3, also above D = 256 (K3 forced with
    MXNET_FLASH_VMEM_MB=0.001), in every dtype, at a ring offset."""
    _need_card()
    q, k, v = _attn_inputs(1, 256, 2, 64, torch.bfloat16)
    for budget, wrapper in [("10", fa.flash_fwd),
                            ("0.01", fa.flash_fwd_stream)]:
        monkeypatch.setenv("MXNET_FLASH_VMEM_MB", budget)
        before = wrapper.launches
        fa.flash_attention_partial(q, k, v, causal=True)
        assert wrapper.launches == before + 1
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        q, k, v = _attn_inputs(1, 150, 2, 320, dt, seed=3)
        for budget, wrapper in [("10", fa.flash_fwd),
                                ("0.001", fa.flash_fwd_stream)]:
            monkeypatch.setenv("MXNET_FLASH_VMEM_MB", budget)
            before = wrapper.launches
            got = fa.flash_attention_partial(q, k, v, 40, 0, causal=True)
            torch.cuda.synchronize()
            assert wrapper.launches == before + 1
            _assert_partial_close(
                got, fa._ref_bthd(q, k, v, 40, 0, True, 64), dt)


@pytest.mark.cuda
def test_flash_rejects_what_it_cannot_take():
    """Only a dtype without a kernel raises.  A head dimension that is not
    contiguous, a stride that is not a multiple of 8 and an operand 4
    bytes past an aligned address are copied to fresh contiguous tensors
    and launched; every head size runs."""
    _need_card()
    q, k, v = _attn_inputs(1, 64, 2, 32, torch.float32)
    with pytest.raises(MXNetError, match="float32, bfloat16 or float16"):
        fa.flash_fwd(q.double(), k.double(), v.double())
    for fwd in (fa.flash_fwd, fa.flash_fwd_stream):
        # head dimension not contiguous
        _check_call(fwd, torch.float32, q[..., ::2], k[..., ::2],
                    v[..., ::2], 0, 0, True)
        # strides of 33 elements: the first 32 columns of a (..., 33) tensor
        wide = [torch.nn.functional.pad(x, (0, 1)) for x in (q, k, v)]
        assert wide[0][..., :32].stride()[2] == 33
        _check_call(fwd, torch.float32, *(x[..., :32] for x in wide), 0, 0,
                    True)
        # 4 bytes past an aligned address
        flat = torch.empty(q.numel() + 4, device="cuda")
        qs = flat[1:1 + q.numel()].view(q.shape).copy_(q)
        assert qs.data_ptr() % 16 == 4
        _check_call(fwd, torch.float32, qs, k, v, 0, 0, True)
    # float16 and every head size run
    before = fa.flash_fwd.launches
    o, m, l = fa.flash_fwd(q.half(), k.half(), v.half(), causal=True)
    assert fa.flash_fwd.launches == before + 1 and o.dtype == torch.float16
    for D in (1, 7, 129, 255, 256, 257, 264, 300):
        q, k, v = _attn_inputs(1, 40, 1, D, torch.float32, seed=D)
        _check_call(fa.flash_fwd, torch.float32, q, k, v, 0, 0, True)


@pytest.mark.cuda
def test_stream_plan_covers_kv_and_splits_the_long_causal_shape():
    """The plan counts in its route's tiles (fp32: 128 query rows by 64
    keys at D <= 64, 64 by 32 at D <= 128, 64 by 16 to 256; bf16 and
    fp16: 128 by 128, 64 keys at D > 64; every dtype above 256: 64 by
    64), a column group of O per 128 columns above D = 128, and cuts the
    causal triangle into balanced ranges."""
    _need_card()
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        for B, T, H, D, causal in [(1, 32768, 1, 64, True),
                                   (2, 8192, 8, 64, False),
                                   (1, 100, 2, 64, True),
                                   (1, 64, 1, 16, False),
                                   (1, 100, 1, 20, True),
                                   (1, 1000, 2, 128, True),
                                   (2, 8192, 8, 256, True),
                                   (1, 1000, 2, 136, False),
                                   (1, 1000, 2, 264, True),
                                   (2, 2048, 8, 512, True)]:
            q = torch.zeros(B, T, H, D, device="cuda", dtype=dt)
            plan = fa.stream_plan(q, q, causal=causal)
            d8 = -(-D // 8) * 8
            if d8 > 256:
                tiles = (64, 64)
            elif dt == torch.float32:
                tiles = (128, 64) if d8 <= 64 else \
                    (64, 32) if d8 <= 128 else (64, 16)
            else:
                tiles = (128, 128 if d8 <= 64 else 64)
            assert (plan["rows"], plan["tile"]) == tiles
            assert plan["groups"] == (1 if d8 <= 128 else -(-d8 // 128))
            nk = -(-T // plan["tile"])
            assert plan["splits"] * plan["chunk"] >= nk > \
                (plan["splits"] - 1) * plan["chunk"]
            assert plan["splits"] >= min(2, nk)
            assert plan["workspace"] == plan["splits"] * B * H * T * (d8 + 2)
        # the causal triangle at T = 32768: no range longer than the
        # balanced share of 8 blocks per SM
        q = torch.zeros(1, 32768, 1, 64, device="cuda", dtype=dt)
        plan = fa.stream_plan(q, q, causal=True)
        nk = 32768 // plan["tile"]
        nq = 32768 // plan["rows"]
        work = sum(min(nk, -(-(i + 1) * plan["rows"] // plan["tile"]))
                   for i in range(nq))
        assert plan["chunk"] <= -(-work // (8 * plan["sm_count"]))


# -- the training slice: K1 at the mlp's shapes, mixed dtypes, Module.fit ----

@pytest.mark.cuda
def test_fc_relu_at_the_mlp_shapes_through_both_routes():
    """train_mnist's mlp runs K1 at (64, 784 -> 128) and (64, 128 -> 64)
    in fp32 in every step; fc2's N = 64 is half of one 128-row w slab of
    the tensor_core route (TMA zero-fills the rest)."""
    _need_card()
    for m, k, n in [(64, 784, 128), (64, 128, 64)]:
        x, w, b = (torch.from_numpy(a).cuda() for a in _inputs(m, k, n))
        routes = [r for r in ROUTES if launch_plan(x, w, r) is not None]
        assert routes == list(ROUTES)
        _k1_call(x, w, b)
        for route in routes:
            _k1_call(x, w, b, route)


@pytest.mark.cuda
def test_mixed_dtypes_run_the_promoted_kernel():
    """A bf16 x against fp32 w and b launches the fp32 K1 and returns
    bf16; a bf16 q against fp32 k and v launches the fp32 K2 or K3 and
    returns o in bf16; each against its plain version on the promoted
    operands, rounded once to bf16 (one bf16 ulp)."""
    _need_card()
    x, w, b = (torch.from_numpy(a).cuda() for a in _inputs(64, 784, 128))
    xb = x.to(torch.bfloat16)
    before = fc_relu.launches
    got = fc_relu(xb, w, b)
    torch.cuda.synchronize()
    assert fc_relu.launches == before + 1 and got.dtype == torch.bfloat16
    want = fc_relu_ref(xb.float(), w, b)
    torch.testing.assert_close(got.float(), want, rtol=2.0 ** -7,
                               atol=2.0 ** -7 * want.abs().max().item())
    q, k, v = _attn_inputs(2, 200, 2, 64, torch.float32, seed=5)
    qb = q.to(torch.bfloat16)
    for fwd in (fa.flash_fwd, fa.flash_fwd_stream):
        before = fwd.launches
        o, m, l = fwd(qb, k, v, 0, 0, True)
        torch.cuda.synchronize()
        assert fwd.launches == before + 1 and o.dtype == torch.bfloat16
        wo, wm, wl = fa._ref_bthd(qb.float(), k, v, 0, 0, True, 64)
        torch.testing.assert_close(o.float(), wo.to(torch.bfloat16).float(),
                                   rtol=2.0 ** -7,
                                   atol=2.0 ** -7 * wo.abs().max().item())
        for g, r in ((m, wm), (l, wl)):
            torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-5)


def _mlp_symbol(mx):
    s = mx.sym
    x = s.Flatten(s.Variable("data"))
    x = s.Activation(s.FullyConnected(x, name="fc1", num_hidden=128),
                     name="relu1", act_type="relu")
    x = s.Activation(s.FullyConnected(x, name="fc2", num_hidden=64),
                     name="relu2", act_type="relu")
    return s.SoftmaxOutput(s.FullyConnected(x, name="fc3", num_hidden=10),
                           name="softmax")


@pytest.mark.cuda
def test_module_steps_of_the_mlp_on_card_match_the_cpu(monkeypatch):
    """4 steps of the mlp (TPU_PALLAS, train_mnist's batch 64, SGD lr 0.05
    momentum 0.9) on the card and on the CPU from the same parameters and
    batches, TF32 off: per-step loss within rtol 1e-3 and parameters
    within rtol 1e-3 + 1e-4 * max|param| (fp32 sums in other orders,
    through 4 momentum steps); K1 twice per forward on the card."""
    _need_card()
    import incubator_mxnet_tpu_torch as mx
    monkeypatch.setenv("MXNET_SUBGRAPH_BACKEND", "TPU_PALLAS")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    x, y = mx.test_utils.get_mnist_like(256, seed=0)
    batches = [mx.io.DataBatch([mx.nd.array(x[i:i + 64], ctx=mx.cpu())],
                               [mx.nd.array(y[i:i + 64], ctx=mx.cpu())])
               for i in range(0, 256, 64)]
    runs = {}
    for ctx in (mx.cpu(), mx.gpu(0)):
        mod = mx.mod.Module(_mlp_symbol(mx), context=ctx)
        mod.bind([("data", (64, 1, 28, 28))], [("softmax_label", (64,))])
        mx.random.seed(3)
        mod.init_params(mx.initializer.Xavier())
        mod.init_optimizer(optimizer_params={"learning_rate": 0.05,
                                             "momentum": 0.9})
        before = fc_relu.launches
        losses = []
        for batch in batches:
            mod.forward_backward(batch)
            mod.update()
            p = mod.get_outputs()[0].asnumpy()
            losses.append(-np.log(p[np.arange(64),
                                    batch.label[0].asnumpy().astype(int)]
                                  ).mean())
        launches = fc_relu.launches - before
        runs[ctx.device_type] = (np.array(losses), {
            k: v.asnumpy() for k, v in mod.get_params()[0].items()},
            launches)
    (gl, gp, gk), (cl, cp, ck) = runs["gpu"], runs["cpu"]
    assert (gk, ck) == (2 * len(batches), 0)
    np.testing.assert_allclose(gl, cl, rtol=1e-3)
    for k, v in cp.items():
        np.testing.assert_allclose(gp[k], v, rtol=1e-3,
                                   atol=1e-4 * np.abs(v).max(), err_msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batchnorm_on_card_matches_the_cpu(dtype, train):
    """The BatchNorm op (torch.native_batch_norm on the card) against the
    same op on the CPU: output, gradients of data, gamma and beta, and
    the moving update.  fp32: sums in other orders over 2*8*14*14 values,
    rtol 1e-5 + 1e-5 * max|cpu| (gradients 1e-4); bf16 output and data
    gradient may round one bf16 ulp apart, 2**-7 + 2**-7 * max|cpu|."""
    _need_card()
    from incubator_mxnet_tpu_torch.ops import registry
    op = registry.get("BatchNorm")
    params = op.canonicalize_params({"fix_gamma": False, "eps": 1e-5})
    params["_train"] = train
    rng = np.random.RandomState(11)
    host = [rng.normal(0.5, 2, (2, 8, 14, 14)), rng.uniform(0.5, 1.5, 8),
            rng.normal(0, 0.5, 8), rng.normal(0, 1, 8),
            rng.uniform(0.5, 2, 8)]
    ct = torch.from_numpy(rng.normal(0, 1, (2, 8, 14, 14)).astype(
        np.float32)).to(dtype)
    got = {}
    for dev in ("cpu", "cuda"):
        x, g, b, mm, mv = (torch.from_numpy(a.astype(np.float32)).to(dev)
                           for a in host)
        x = x.to(dtype).requires_grad_()
        g.requires_grad_()
        b.requires_grad_()
        out = op.fn(params, x, g, b, mm, mv)
        out = out if isinstance(out, tuple) else (out,)
        grads = torch.autograd.grad(out[0], (x, g, b), ct.to(dev))
        got[dev] = [t.detach().float().cpu().numpy()
                    for t in tuple(out) + tuple(grads)]
    tol = (1e-5, 1e-5) if dtype == torch.float32 else (2.0 ** -7, 2.0 ** -7)
    gtol = (1e-4, 1e-4) if dtype == torch.float32 else tol
    n = 3 if train else 1
    names = ["out", "moving_mean", "moving_var"][:n] + ["dx", "dgamma",
                                                        "dbeta"]
    for k, (a, ref) in enumerate(zip(got["cuda"], got["cpu"])):
        if k >= n:                  # gradients
            rtol, atol = gtol
        elif k:                     # the moving statistics, in fp32
            rtol, atol = 1e-5, 1e-5
        else:
            rtol, atol = tol
        np.testing.assert_allclose(a, ref, rtol=rtol,
                                   atol=atol * np.abs(ref).max(),
                                   err_msg=names[k])


def _bn_fed_biases(sym):
    """Biases of convolutions that feed a BatchNorm: the batch mean
    removes them, so their gradient is 0 in exact arithmetic."""
    out = set()
    for node in sym._topo():
        if not node.is_variable and node.op.name == "BatchNorm":
            src = node.inputs[0][0]
            if not src.is_variable and src.op.name == "Convolution" and \
                    not src.attrs["no_bias"]:
                out.add(src.inputs[2][0].name)
    return out


def _as_float64(mod):
    """A bound float32 Module's arrays, all but the labels, as float64
    (before init_params): the Module binds float32, as the JAX
    package's does."""
    exe = mod._exec_group.execs[0]
    labels = set(mod._exec_group.label_names)
    arrays = [a for n, a in exe.arg_dict.items() if n not in labels]
    arrays += [g for g in exe.grad_dict.values() if g is not None]
    for a in arrays + list(exe.aux_dict.values()):
        a._data = a.data.double()


class _ReluLog:
    """Stands in for `torch.relu` (the port's Activation calls it) and
    keeps a CPU float64 copy of every input while `steps` is a list: one
    list of inputs per step, in the order the executor runs the nodes."""

    def __init__(self, relu):
        self.relu, self.steps = relu, None

    def __call__(self, x):
        if self.steps is not None:
            self.steps[-1].append(x.detach().to("cpu", torch.float64))
        return self.relu(x)


def _relu_upstream(sym):
    """For each relu node of `sym`, in the executor's order, the
    variables upstream of it: the parameters its gradient reaches."""
    out = []
    for node in sym._topo():
        if node.is_variable or node.op.name != "Activation" or \
                node.attrs["act_type"] != "relu":
            continue
        seen, names, todo = set(), set(), [node]
        while todo:
            n = todo.pop()
            if id(n) in seen:
                continue
            seen.add(id(n))
            if n.is_variable:
                names.add(n.name)
            else:
                todo.extend(src for src, _ in n.inputs)
        out.append(names)
    return out


def _thumbnail_steps(mx, sym, ctx, dtype, batches, log, teacher=None):
    """3 fused steps of `sym` on `ctx` in `dtype` from Xavier parameters
    under one seed: (per-step losses, [{name: array} of parameters,
    moving statistics and momenta ("name:momentum") after each step],
    [the relu inputs of each step]).  With `teacher` (another run's
    states), step k > 1 starts from the teacher's state after step k-1,
    cast to `dtype`."""
    mod = mx.mod.Module(sym, context=ctx)
    mod.bind([("data", (8, 3, 32, 32))], [("softmax_label", (8,))])
    if dtype == "float64":
        _as_float64(mod)
    mx.random.seed(5)
    mod.init_params(mx.initializer.Xavier(rnd_type="gaussian",
                                          factor_type="in", magnitude=2))
    mod.init_optimizer(optimizer_params={"learning_rate": 0.05,
                                         "momentum": 0.9})
    names = mod._exec_group.param_names
    losses, states, log.steps = [], [], []
    for k, batch in enumerate(batches):
        if teacher is not None and k:
            before = teacher[k - 1]
            mod.set_params({n: before[n] for n in names},
                           {n: before[n] for n in mod._exec_group.aux_names})
            for i, n in enumerate(names):
                mod._updater.states[i]._set_data(before[n + ":momentum"])
        log.steps.append([])
        mod.fit_step(batch, mx.metric.create("acc"))
        p = mod.get_outputs()[0].asnumpy()
        losses.append(-np.log(p[np.arange(8), batch.label[0].asnumpy()
                                .astype(int)]).mean())
        args, auxs = mod.get_params()
        assert all(a.dtype == np.dtype(dtype) for a in args.values())
        state = {k: a.asnumpy() for k, a in {**args, **auxs}.items()}
        for i, n in enumerate(names):
            state[n + ":momentum"] = mod._updater.states[i].asnumpy()
        states.append(state)
    assert mod._fused_step.steps == 3
    relus, log.steps = log.steps, None
    return np.array(losses), states, relus


def _rel_l2(got, ref, keys):
    a = np.concatenate([got[k].ravel().astype(np.float64) for k in keys])
    b = np.concatenate([ref[k].ravel().astype(np.float64) for k in keys])
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _relu_flips(relus, ref):
    """[(step, relu index, units whose input changed sign against `ref`,
    their largest |input| in `ref` over that relu's largest |input|)]."""
    out = []
    for k, (got_k, ref_k) in enumerate(zip(relus, ref)):
        assert len(got_k) == len(ref_k)
        for i, (a, b) in enumerate(zip(got_k, ref_k)):
            flip = (a > 0) != (b > 0)
            if flip.any():
                out.append((k, i, int(flip.sum()),
                            float(b.abs()[flip].max() / b.abs().max())))
    return out


@pytest.mark.cuda
def test_fused_resnet_steps_on_card_match_the_cpu(monkeypatch):
    """3 fused train steps of a thumbnail ResNet v1 (15 BatchNorms,
    batch 8 of 3x32x32, SGD lr 0.05 momentum 0.9) on the card and on the
    CPU from the same Xavier parameters, TF32 off, cuDNN in its default
    algorithms.  float64: per-step loss within rtol 1e-3; parameters,
    momenta and moving statistics within rtol 1e-3 + 1e-4 * max|cpu|; a
    convolution bias that feeds a BatchNorm has a zero gradient in exact
    arithmetic, so it (initialised at 0) and its momentum are rounding
    noise, held below 1e-9.

    float32, on each device, held against float64 as parameters, momenta
    and moving statistics in relative L2 norm (the CPU's float32 step is
    within ~1e-6) and the loss within rtol 1e-3:
    - free running, the state after 3 steps within 1e-4, held when no
      relu input changed sign against the float64 run on the way;
    - each step from the float64 CPU's state before it, the state after
      it within 1e-4.  A relu input within rounding of 0 may land on the
      other side on the card (the default backward adds with atomics, in
      an order that varies from run to run): the unit then passes or
      stops its gradient, which moves every parameter upstream of it.
      So, as phase 7a of chip_smoke.py excuses a flipped max-pool
      window, at a step where a relu input flipped the parameters and
      momenta upstream of that relu are left out of that step's norm;
      a flipped input farther than 1e-4 * max|input| from 0 fails.
    On an H100 one such input (2e-7 of that relu's largest, at stage 3's
    first relu in step 2) flipped in about half the runs, and moved the
    free-running momenta 8e-2 from float64."""
    _need_card()
    import incubator_mxnet_tpu_torch as mx
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    log = _ReluLog(torch.relu)
    monkeypatch.setattr(torch, "relu", log)
    v = mx.gluon.model_zoo.vision
    net = v.ResNetV1(v.BottleneckV1, [1, 1, 1, 1], [16, 16, 32, 64, 128],
                     classes=10, thumbnail=True)
    sym = mx.sym.SoftmaxOutput(net(mx.sym.Variable("data")), name="softmax")
    zero = _bn_fed_biases(sym)
    assert len(zero) == 8
    zero |= {n + ":momentum" for n in zero}     # initialised at 0
    aux = set(sym.list_auxiliary_states())
    upstream = [names - aux for names in _relu_upstream(sym)]
    assert len(upstream) == 12
    rng = np.random.RandomState(12)
    batches = [mx.io.DataBatch(
        [mx.nd.array(rng.uniform(-1, 1, (8, 3, 32, 32)), ctx=mx.cpu())],
        [mx.nd.array(rng.randint(0, 10, 8), ctx=mx.cpu())])
        for _ in range(3)]
    ctxs = {"cpu": mx.cpu(), "gpu": mx.gpu(0)}
    runs = {(dev, dt): _thumbnail_steps(mx, sym, ctx, dt, batches, log)
            for dev, ctx in ctxs.items() for dt in ("float64", "float32")}
    (gl, gs, _), (cl, cs, cr) = runs["gpu", "float64"], \
        runs["cpu", "float64"]
    assert all(len(r) == len(upstream) for r in cr)
    np.testing.assert_allclose(gl, cl, rtol=1e-3)
    for k, ref in cs[-1].items():
        if k in zero:
            assert np.abs(gs[-1][k]).max() < 1e-9 and \
                np.abs(ref).max() < 1e-9, k
            continue
        np.testing.assert_allclose(gs[-1][k], ref, rtol=1e-3,
                                   atol=1e-4 * np.abs(ref).max(), err_msg=k)

    def kinds(ref, skip=()):
        return {kind: [k for k in ref if k not in zero and
                       k.split(":")[0] not in skip and
                       (kind in k if kind != "weight" else
                        ":" not in k and "running" not in k)]
                for kind in ("momentum", "running", "weight")}

    dist, free_flips, forced_flips = {}, {}, {}
    for dev in ("cpu", "gpu"):
        losses, states, relus = runs[dev, "float32"]
        np.testing.assert_allclose(losses, cl, rtol=1e-3)
        free_flips[dev] = _relu_flips(relus, cr)
        if not free_flips[dev]:
            for kind, keys in kinds(cs[-1]).items():
                dist[dev, "free", kind] = _rel_l2(states[-1], cs[-1], keys)
        losses, states, relus = _thumbnail_steps(
            mx, sym, ctxs[dev], "float32", batches, log, teacher=cs)
        np.testing.assert_allclose(losses, cl, rtol=1e-3)
        flips = forced_flips[dev] = _relu_flips(relus, cr)
        assert all(far <= 1e-4 for *_, far in flips), (dev, flips)
        for k in range(3):
            skip = set().union(*(upstream[i] for s, i, *_ in flips
                                 if s == k))
            for kind, keys in kinds(cs[k], skip).items():
                dist[dev, k + 1, kind] = _rel_l2(states[k], cs[k], keys)
    print(f"relu inputs flipped against float64 as (step - 1, relu, "
          f"units, |x| / max|x|): free running {free_flips}; each step "
          f"from the float64 state {forced_flips}; float32 distances "
          f"{ {k: f'{d:.2e}' for k, d in dist.items()} }")
    assert free_flips["cpu"] == [], free_flips
    assert all(d < 1e-4 for d in dist.values()), (dist, free_flips)


# -- gluon's imperative training on the card ---------------------------------

def _thumbnail_v2(mx, ctx, dtype, seed=3):
    """The thumbnail ResNet v2 on `ctx` in `dtype`, its parameters drawn
    from one numpy seed (fan-in scaled Gaussian weights, gamma near 1)."""
    v = mx.gluon.model_zoo.vision
    net = v.ResNetV2(v.BottleneckV2, [1, 1, 1, 1], [16, 16, 32, 64, 128],
                     classes=10, thumbnail=True)
    net.initialize(ctx=ctx)
    net(mx.nd.zeros((1, 3, 32, 32), ctx=ctx))
    rng = np.random.RandomState(seed)
    for name, p in sorted(net.collect_params().items()):
        s = p.shape
        if name.endswith("weight"):
            val = rng.normal(0, 1, s) * np.sqrt(2.0 / np.prod(s[1:]))
        elif name.endswith("gamma"):
            val = rng.uniform(0.8, 1.2, s)
        elif name.endswith("running_var"):
            val = np.ones(s)
        elif name.endswith("running_mean"):
            val = np.zeros(s)
        else:
            val = rng.normal(0, 0.1, s)
        p.set_data(mx.nd.array(val, ctx=ctx, dtype="float32"))
    net.cast(dtype)
    return net


def _v2_steps(mx, ctx, dtype, hybrid, steps=3, batch=8):
    """`steps` of record / backward / Trainer.step (SGD lr 0.05 momentum
    0.9): (losses, {structural parameter name or "i:momentum": array},
    the gradients and loss of the first step)."""
    net = _thumbnail_v2(mx, ctx, dtype)
    if hybrid:
        net.hybridize()
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.05, "momentum": 0.9})
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    rng = np.random.RandomState(4)
    losses, first = [], None
    for k in range(steps):
        x = mx.nd.array(rng.uniform(-1, 1, (batch, 3, 32, 32)), ctx=ctx,
                        dtype=dtype)
        y = mx.nd.array(rng.randint(0, 10, batch), ctx=ctx)
        with mx.autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        if k == 0:
            first = {n: p.grad().asnumpy() for n, p in
                     net._collect_params_with_prefix().items()
                     if p.grad_req != "null"}
            first["loss"] = loss.asnumpy()
        trainer.step(batch)
        losses.append(float(loss.asnumpy().mean()))
    state = {n: p.data().asnumpy()
             for n, p in net._collect_params_with_prefix().items()}
    for i, s in trainer._updaters[0].states.items():
        state[f"{i}:momentum"] = s.asnumpy()
    return np.array(losses), state, first


@pytest.mark.cuda
def test_hybridized_resnet_v2_steps_on_card_match_the_cpu(monkeypatch):
    """3 steps of the plain gluon loop (record, backward, Trainer.step) on
    a hybridized thumbnail ResNet v2 in float64, card against CPU, TF32
    off, cuDNN in its default algorithms: losses within rtol 1e-3;
    parameters, moving statistics and momenta within rtol 1e-3 + 1e-4 *
    max|cpu| (chip_smoke phase 7a's gates).  Then one step hybridized
    against not, on the card: the loss and every gradient within rtol
    1e-9 + 1e-12 * max|g| (the same ops in the same order), cuDNN in its
    deterministic algorithms for that step (its default backward adds
    with atomics, in an order that varies from run to run)."""
    _need_card()
    import incubator_mxnet_tpu_torch as mx
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    cl, cs, _ = _v2_steps(mx, mx.cpu(), "float64", True)
    gl, gs, _ = _v2_steps(mx, mx.gpu(0), "float64", True)
    np.testing.assert_allclose(gl, cl, rtol=1e-3)
    assert list(gs) == list(cs)
    for k, ref in cs.items():
        np.testing.assert_allclose(gs[k], ref, rtol=1e-3,
                                   atol=1e-4 * np.abs(ref).max(), err_msg=k)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    _, _, ghyb = _v2_steps(mx, mx.gpu(0), "float64", True, steps=1)
    _, _, geager = _v2_steps(mx, mx.gpu(0), "float64", False, steps=1)
    assert list(ghyb) == list(geager)
    for k, ref in geager.items():
        np.testing.assert_allclose(ghyb[k], ref, rtol=1e-9,
                                   atol=1e-12 * np.abs(ref).max(), err_msg=k)


@pytest.mark.cuda
def test_gluon_fused_step_on_card_matches_the_eager_loop(monkeypatch):
    """Estimator.fit on the card, 4 batches of a Dense -> BatchNorm ->
    Dense net in float32: the fused gluon step (every batch) against
    the eager record / backward / step loop (MXNET_FUSED_TRAIN_STEP=0),
    parameters, moving statistics, momenta and accuracy within rtol
    1e-6 + 1e-7 * max|eager| (the same ops on the same card)."""
    _need_card()
    import incubator_mxnet_tpu_torch as mx
    ctx = mx.gpu(0)
    rng = np.random.RandomState(8)
    X = rng.randn(64, 12).astype("f4")
    y = rng.randint(0, 3, 64).astype("f4")

    def fit(fused):
        monkeypatch.setenv("MXNET_FUSED_TRAIN_STEP", "1" if fused else "0")
        net = mx.gluon.nn.HybridSequential()
        net.add(mx.gluon.nn.Dense(16, in_units=12),
                mx.gluon.nn.BatchNorm(in_channels=16),
                mx.gluon.nn.Activation("relu"),
                mx.gluon.nn.Dense(3, in_units=16))
        mx.random.seed(2)
        net.initialize(mx.initializer.Xavier(), ctx=ctx)
        trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                                   {"learning_rate": 0.1, "momentum": 0.9})
        est = mx.gluon.contrib.estimator.Estimator(
            net, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
            train_metrics=[mx.metric.Accuracy()], trainer=trainer)
        batches = [(mx.nd.array(X[i:i + 16], ctx=ctx),
                    mx.nd.array(y[i:i + 16], ctx=ctx))
                   for i in range(0, 64, 16)]
        est.fit(batches, event_handlers=[])
        state = {n: p.data().asnumpy()
                 for n, p in net._collect_params_with_prefix().items()}
        state.update({f"{i}:momentum": s.asnumpy() for i, s in
                      trainer._updaters[0].states.items()})
        return state, est.train_metrics[0].get()[1], est._fused

    fused, acc_fused, step = fit(True)
    eager, acc_eager, none = fit(False)
    assert step is not None and step.steps == 4 and none is None
    assert acc_fused == acc_eager
    for k, ref in eager.items():
        np.testing.assert_allclose(fused[k], ref, rtol=1e-6,
                                   atol=1e-7 * np.abs(ref).max(), err_msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_decode_plane_on_card_matches_the_cpu(dtype):
    """The decode plane of a small LM (vocab 40, 2 layers, 2 heads,
    hidden 16) on the card against the CPU, from the same parameters:
    two prefills (buckets 8 and 16) and 4 decode steps fed the CPU's
    tokens; logits and the caches' written rows within rtol 1e-4 +
    1e-5 * max|cpu| in float32 (TF32 off), relative L2 2**-6 in
    bfloat16 (parameters and cache), whose argmax must agree wherever
    the CPU's top-2 margin exceeds 2**-5 * max|logit|."""
    _need_card()
    from incubator_mxnet_tpu_torch import cpu, gpu
    from incubator_mxnet_tpu_torch.llm import (DecodePrograms, LMConfig,
                                               init_kv_cache,
                                               stack_lm_params)
    cfg = LMConfig(vocab_size=40, num_layers=2, num_heads=2, hidden=16,
                   max_len=48, param_dtype=dtype)
    rng = np.random.RandomState(12)
    c, f = cfg.hidden, cfg.hidden * cfg.ffn_mult
    shapes = {"embed_weight": (40, c), "final_ln_gamma": (c,),
              "final_ln_beta": (c,)}
    for i in range(cfg.num_layers):
        for name, shape in (("ln1_gamma", (c,)), ("ln1_beta", (c,)),
                            ("qkv_weight", (3 * c, c)), ("qkv_bias", (3 * c,)),
                            ("out_proj_weight", (c, c)),
                            ("out_proj_bias", (c,)), ("ln2_gamma", (c,)),
                            ("ln2_beta", (c,)), ("fc1_weight", (f, c)),
                            ("fc1_bias", (f,)), ("fc2_weight", (c, f)),
                            ("fc2_bias", (c,))):
            shapes[f"block{i}_{name}"] = shape
    values = {f"lm_{k}": torch.from_numpy(
        (rng.normal(0, 0.3, s) + (1.0 if k.endswith("gamma") else 0.0))
        .astype("f4")).to(getattr(torch, dtype))
        for k, s in shapes.items()}
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        planes = []
        for ctx in (cpu(), gpu(0)):
            progs = DecodePrograms(cfg, stack_lm_params(values, cfg, ctx))
            planes.append((progs,) + init_kv_cache(cfg, 3, ctx))
        tokens = np.zeros(3, np.int32)
        positions = np.zeros(3, np.int32)
        calls = []
        for slot, n, tb in ((0, 5, 8), (2, 11, 16)):
            prompt = np.zeros((1, tb), np.int32)
            prompt[0, :n] = rng.randint(1, 40, n)
            outs = [p.prefill(p.params, ck, cv, prompt, slot, n)
                    for p, ck, cv in planes]
            calls.append(outs)
            tokens[slot], positions[slot] = int(outs[0][2]), n
        for _ in range(4):
            outs = [p.step(p.params, ck, cv, tokens, positions)
                    for p, ck, cv in planes]
            calls.append(outs)
            tokens = outs[0][2].numpy().astype(np.int32)
            positions = positions + 1
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    for (_, _, _, want), (_, _, got_tok, got) in calls:
        want, got = want.float(), got.float().cpu()
        if dtype == "float32":
            np.testing.assert_allclose(
                got.numpy(), want.numpy(), rtol=1e-4,
                atol=1e-5 * want.abs().max().item())
            continue
        assert (got - want).norm() <= 2.0 ** -6 * want.norm()
        top2 = want.topk(2, dim=-1).values
        clear = (top2[..., 0] - top2[..., 1]) > 2.0 ** -5 * want.abs().max()
        assert (want.argmax(-1) == got_tok.long().cpu())[clear].all()
    rows = positions.max()
    for a, b in zip(planes[0][1:], planes[1][1:]):
        a, b = a[:, :, :rows].float(), b[:, :, :rows].float().cpu()
        if dtype == "float32":
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-4,
                                       atol=1e-5 * a.abs().max().item())
        else:
            assert (b - a).norm() <= 2.0 ** -6 * a.norm()


@pytest.mark.cuda
def test_snapshot_staging_is_ordered_before_the_next_update():
    """`checkpoint.snapshot.gather_to_pool` copies card tensors into
    pinned host buffers on the current stream: an in-place update queued
    right after it (as the next train step's SGD is) cannot reach the
    staged bytes, and `wait()` returns once they landed."""
    _need_card()
    from incubator_mxnet_tpu_torch.checkpoint.snapshot import gather_to_pool
    from incubator_mxnet_tpu_torch.storage import HostStagingPool
    pool = HostStagingPool(pin=True)
    w = torch.randn(4096, 4096, device="cuda")
    big = torch.randn(8192, 8192, device="cuda")
    want = w.cpu()
    big @ big                       # keep the stream busy
    staged = gather_to_pool({"w": w, "b": w.to(torch.bfloat16)}, pool)
    w.mul_(-3.0).add_(1.0)          # the next step's in-place update
    staged.wait()
    assert staged.arrays["w"].is_pinned()
    assert torch.equal(staged.arrays["w"], want)
    assert torch.equal(staged.arrays["b"], want.to(torch.bfloat16))
    staged.release()
    assert pool.stats()["held_bytes"] > 0


@pytest.mark.cuda
def test_card_optimizer_blob_loads_without_a_card(tmp_path):
    """A Module's optimizer blob written on the card unpickles in a
    process that sees no card, its states on the CPU."""
    _need_card()
    import os
    import sys
    import incubator_mxnet_tpu_torch as mx
    s = mx.sym
    net = s.SoftmaxOutput(s.FullyConnected(s.Variable("data"),
                                           num_hidden=4, name="fc"),
                          name="softmax")
    mod = mx.mod.Module(net, context=mx.gpu(0))
    mod.bind([("data", (8, 6))], [("softmax_label", (8,))])
    mod.init_params()
    mod.init_optimizer(optimizer_params={"learning_rate": 0.1,
                                         "momentum": 0.9})
    batch = mx.io.DataBatch([mx.nd.ones((8, 6), ctx=mx.gpu(0))],
                            [mx.nd.zeros((8,), ctx=mx.gpu(0))])
    mod.forward_backward(batch)
    mod.update()
    path = tmp_path / "opt.bin"
    path.write_bytes(mod.get_optimizer_states_blob())
    code = ("import pickle, sys; states, opt = pickle.loads(open(sys.argv[1],"
            " 'rb').read()); print(sorted({str(s.context) for s in "
            "states.values()}), opt.num_update)")
    root = Path(__file__).resolve().parents[1]
    out = subprocess.run(
        [sys.executable, "-c", "import incubator_mxnet_tpu_torch; " + code,
         str(path)], capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES="",
                 PYTHONPATH=str(root)))
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["['cpu(0)']", "1"]


# -- slice 9: the RNN op, control flow, the bucketed LSTM LM ------------------

@pytest.mark.cuda
@pytest.mark.parametrize("bidir", [False, True])
@pytest.mark.parametrize("mode", ["lstm", "gru", "rnn_tanh", "rnn_relu"])
def test_rnn_cudnn_route_matches_the_plain_loop(mode, bidir):
    """The `RNN` op on the card (cuDNN's fused RNN through torch.lstm and
    friends) against its plain loop on the card, fp32 with TF32 off:
    outputs, final states and the gradient of every input, rtol 1e-4 +
    1e-5 * max|ref|."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card")
    from incubator_mxnet_tpu_torch.ops import nn as ops_nn
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    T, B, I, H, L = 7, 3, 5, 8, 2
    d = 2 if bidir else 1
    rng = np.random.RandomState(0)
    n = ops_nn.rnn_param_size(mode, I, H, L, bidir)
    vals = [rng.rand(T, B, I), rng.uniform(-0.4, 0.4, n),
            rng.rand(L * d, B, H) - 0.5]
    if mode == "lstm":
        vals.append(rng.rand(L * d, B, H) - 0.5)
    params = {"mode": mode, "num_layers": L, "state_size": H,
              "bidirectional": bidir, "p": 0.0, "_train": True}
    results = []
    for route in (ops_nn.rnn_cudnn, ops_nn.rnn_plain):
        ins = [torch.tensor(v, dtype=torch.float32, device="cuda",
                            requires_grad=True) for v in vals]
        outs = [o for o in route(params, *ins) if o is not None]
        sum(o.sum() for o in outs).backward()
        results.append([o.detach().cpu().numpy() for o in outs] +
                       [t.grad.cpu().numpy() for t in ins])
    for got, want in zip(*results):
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-5 * np.abs(want).max())
    before = dict(ops_nn.rnn_routes)
    ops_nn._rnn(dict(params, state_outputs=True),
                *[torch.tensor(v, dtype=torch.float32, device="cuda")
                  for v in vals], None)
    assert ops_nn.rnn_routes["cudnn"] == before["cudnn"] + 1


@pytest.mark.cuda
def test_control_flow_on_card_matches_the_cpu():
    """`_foreach` with its gradient, `_while_loop` (padded, and without
    outputs) and `_cond` on both branches, card against CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card")
    import incubator_mxnet_tpu_torch as mx
    s = mx.sym
    x, st, w = s.Variable("x"), s.Variable("st"), s.Variable("w")
    outs, fin = s.contrib.foreach(
        lambda d, h: (s.tanh(s.broadcast_mul(d, w) + h), h * 0.5 + d),
        x, st)
    i, v = s.Variable("i"), s.Variable("v")
    wl, wfin = s.contrib.while_loop(
        cond=lambda i, v: i < 4, func=lambda i, v: ([v * i], [i + 1, v + i]),
        loop_vars=[i, v], max_iterations=7)
    _, nfin = s.contrib.while_loop(
        cond=lambda i, v: i < 4, func=lambda i, v: ([], [i + 1, v * 2.0]),
        loop_vars=[i, v], max_iterations=1000)
    c = s.contrib.cond(s.sum(v) > 1.0, lambda: v * w, lambda: v - w)
    graph = s.Group([s.sum(outs) + s.sum(fin)] + list(wl) + list(wfin) +
                    list(nfin) + [c])
    rng = np.random.RandomState(1)
    results = []
    for ctx in (mx.cpu(), mx.gpu(0)):
        for vv in (np.array([0.3], "f4"), np.array([1.7], "f4")):
            args = {"x": rng.rand(6, 3), "st": rng.rand(3), "w": rng.rand(3),
                    "i": np.array([0.0]), "v": vv}
            args = {k: mx.nd.array(a, ctx=ctx) for k, a in args.items()}
            grads = {"x": mx.nd.zeros((6, 3), ctx=ctx),
                     "w": mx.nd.zeros((3,), ctx=ctx)}
            ex = graph.bind(ctx, args, args_grad=grads)
            out = [o.asnumpy() for o in ex.forward(is_train=True)]
            ex.backward([mx.nd.ones(o.shape, ctx=ctx) for o in
                         ex.outputs])
            results.append(out + [g.asnumpy() for g in grads.values()])
        rng = np.random.RandomState(1)
    for got, want in zip(results[2:], results[:2]):
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, rtol=1e-5,
                                       atol=1e-6 * max(np.abs(b).max(), 1))


@pytest.mark.cuda
def test_bucketed_lstm_fit_on_card_matches_the_cpu():
    """Two epochs of the bucketed 2-layer LSTM LM (`lstm_bucketing.py`'s
    sym_gen, vocab 40, 16 hidden, buckets 4/8/12) through
    `BucketingModule.fit`, card against CPU from the same seed: every
    batch's perplexity and every bucket's parameters, rtol 1e-4 + 1e-5 *
    max|ref| (fp32, TF32 off)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card")
    import random
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch.compat import weights
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    V, E, H = 40, 8, 16
    rng = np.random.RandomState(0)
    probs = 1.0 / np.arange(1, V + 1)
    probs /= probs.sum()
    corpus = [rng.choice(V, size=int(rng.randint(3, 13)), p=probs).tolist()
              for _ in range(120)]
    runs = []
    for ctx in (mx.cpu(), mx.gpu(0)):
        random.seed(0)
        np.random.seed(0)
        mx.random.seed(0)
        it = mx.rnn.BucketSentenceIter(corpus, 8, buckets=[4, 8, 12],
                                       invalid_label=0)
        stack = mx.rnn.SequentialRNNCell()
        for i in range(2):
            stack.add(mx.rnn.LSTMCell(H, prefix=f"lstm_l{i}_"))

        def sym_gen(t):
            emb = mx.sym.Embedding(mx.sym.Variable("data"), input_dim=V,
                                   output_dim=E, name="embed")
            stack.reset()
            out, _ = stack.unroll(t, inputs=emb, merge_outputs=True)
            pred = mx.sym.FullyConnected(mx.sym.Reshape(out, shape=(-1, H)),
                                         num_hidden=V, name="pred")
            lab = mx.sym.Reshape(mx.sym.Variable("softmax_label"),
                                 shape=(-1,))
            return mx.sym.SoftmaxOutput(pred, lab, name="softmax"), \
                ("data",), ("softmax_label",)

        mod = mx.mod.BucketingModule(sym_gen, default_bucket_key=12,
                                     context=ctx)
        curve = []
        mod.fit(it, eval_metric=mx.metric.Perplexity(0), optimizer="sgd",
                optimizer_params={"learning_rate": 0.1, "momentum": 0.9,
                                  "wd": 1e-5, "rescale_grad": 1.0 / 8},
                initializer=mx.initializer.Xavier(factor_type="in",
                                                  magnitude=2.34),
                num_epoch=2, batch_end_callback=lambda p: curve.append(
                    p.eval_metric.get()[1]))
        runs.append((curve, weights.bucketing_params_to_numpy(mod)))
    (curve, params), (gcurve, gparams) = runs
    np.testing.assert_allclose(gcurve, curve, rtol=1e-4)
    assert sorted(gparams) == sorted(params)
    for k, want in params.items():
        np.testing.assert_allclose(gparams[k], want, rtol=1e-4,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=k)


# -- slice 10: the data plane of config #2 on the card ------------------------

def _rec_corpus(tmp_path, n=12, fmt=".jpg"):
    from incubator_mxnet_tpu_torch import recordio
    rng = np.random.RandomState(0)
    rec = str(tmp_path / "c.rec")
    w = recordio.MXIndexedRecordIO(str(tmp_path / "c.idx"), rec, "w")
    for i in range(n):
        img = rng.randint(0, 256, (40 + i % 3, 44, 3), np.uint8)
        w.write_idx(i, recordio.pack_img(recordio.IRHeader(0, float(i), i, 0),
                                         img, img_fmt=fmt))
    w.close()
    return rec


@pytest.mark.cuda
def test_native_io_library_builds_from_the_source():
    """The native IO library compiles from src/io_native.cc into build/
    on this machine (the prebuilt src/libmxtpu_io.so is never read)."""
    _need_card()
    from incubator_mxnet_tpu_torch import native
    lib = native.lib()
    assert lib is not None, native.unavailable_reason()
    assert native.lib_path().exists()
    assert native.lib_path().parent.parent.name == "build"


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["float32", "uint8"])
def test_ring_batches_on_the_card_equal_the_host_batches(tmp_path, wire):
    """The ring's card batches (pinned staging, the copy stream, the
    event the current stream waits on) equal the iterator's host batches
    bit for bit, and every staging buffer went back to its pool."""
    _need_card()
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import io_plane, storage
    rec = _rec_corpus(tmp_path)
    kw = dict(path_imgrec=rec, data_shape=(3, 32, 32), batch_size=4,
              rand_crop=True, rand_mirror=True, resize=36, shuffle=True,
              device_augment=wire == "uint8", mean_r=123.68, std_g=57.1)
    host = [(b.data[0].asnumpy(), b.label[0].asnumpy())
            for b in mx.io.ImageRecordIter(**kw)]
    pool = storage.default_pool()
    assert pool.pinned
    hits = pool.stats()["hits"]
    dtypes = [torch.uint8 if wire == "uint8" else torch.float32, None]
    ring = io_plane.DevicePrefetchIter(
        mx.io.ImageRecordIter(**kw),
        placement=io_plane.RingPlacement(ctx=mx.gpu(0), dtypes=dtypes))
    got = []
    for b in ring:
        assert b.data[0].data.is_cuda and b.label[0].data.is_cuda
        got.append((b.data[0].asnumpy(), b.label[0].asnumpy()))
    torch.cuda.synchronize()
    assert len(got) == len(host) == 3
    for (gd, gl), (hd, hl) in zip(got, host):
        assert gd.dtype == hd.dtype and np.array_equal(gd, hd)
        assert np.array_equal(gl, hl)
    stats = ring.ring_stats()
    per_batch = 4 * 32 * 32 * 3 * (1 if wire == "uint8" else 4) + 4 * 4
    assert stats["bytes"] == stats["batches"] * per_batch
    # each batch's buffers came back before the next batch took them
    assert pool.stats()["hits"] - hits >= 2 * (stats["batches"] - 1)
    ring.close()


@pytest.mark.cuda
def test_image_normalize_on_the_card_equals_the_host_fp32_path(tmp_path):
    """uint8 batches through ImageNormalize on the card equal the
    iterator's fp32 host finish (the native library) bit for bit."""
    _need_card()
    import incubator_mxnet_tpu_torch as mx
    rec = _rec_corpus(tmp_path)
    kw = dict(path_imgrec=rec, data_shape=(3, 32, 32), batch_size=4,
              rand_crop=True, rand_mirror=True, resize=36, seed=2,
              mean_r=123.68, mean_g=116.78, mean_b=103.94, std_r=58.4,
              std_g=57.1, std_b=57.4)
    host = mx.io.ImageRecordIter(device_augment=False, **kw)
    wire = mx.io.ImageRecordIter(device_augment=True, **kw)
    sym = wire.normalize_symbol(mx.sym.Variable("data"))
    for hb, wb in zip(host, wire):
        u8 = wb.data[0].as_in_context(mx.gpu(0))
        exe = sym.bind(mx.gpu(0), {"data": u8})
        got = exe.forward()[0]
        assert got.data.is_cuda
        assert np.array_equal(got.asnumpy(), hb.data[0].asnumpy())


@pytest.mark.cuda
@pytest.mark.parametrize("k,classes", [(5, 1000), (8, 6)])
def test_topk_device_update_on_the_card_equals_update(k, classes):
    _need_card()
    import incubator_mxnet_tpu_torch as mx
    rng = np.random.RandomState(k)
    host, dev = mx.metric.TopKAccuracy(top_k=k), \
        mx.metric.TopKAccuracy(top_k=k)
    for _ in range(3):
        pred = rng.rand(128, classes).astype(np.float32)
        lab = rng.randint(0, classes, 128).astype(np.float32)
        host.update([mx.nd.array(lab, ctx=mx.cpu())],
                    [mx.nd.array(pred, ctx=mx.cpu())])
        s, n = dev.device_update([mx.nd.array(lab, ctx=mx.gpu(0))],
                                 [mx.nd.array(pred, ctx=mx.gpu(0))])
        assert s.is_cuda and n.is_cuda
        dev._accumulate(s, n)
    assert dev.get() == host.get()


def _chip_smoke():
    import importlib.util
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("_chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _det_case(name):
    """(op, params, inputs, indices of the inputs to differentiate) at a
    small SSD's shapes (64x64: 280 anchors), seeded."""
    import incubator_mxnet_tpu_torch as mx
    cs = _chip_smoke()
    prob, loc, anchors, labels = cs.ssd_head_inputs(mx, 64, 4)
    rng = np.random.RandomState(3)

    def rand(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.normal(0, 1, shape))
                                .astype("f4"))

    rois = np.zeros((5, 5), "f4")
    rois[:, 0] = rng.randint(0, 2, 5)
    xy = rng.uniform(0, 40, (5, 2))
    rois[:, 1:3], rois[:, 3:5] = xy, xy + rng.uniform(4, 20, (5, 2))
    rois = torch.from_numpy(rois)
    feat = rand(2, 16, 8, 8)
    return {
        "MultiBoxTarget": ("MultiBoxTarget", {}, [anchors, labels, prob],
                           []),
        "MultiBoxDetection": ("MultiBoxDetection", {"nms_threshold": 0.45},
                              [prob, loc, anchors], []),
        "ROIPooling": ("ROIPooling", {"pooled_size": (3, 3),
                                      "spatial_scale": 0.125},
                       [feat, rois], [0]),
        "ROIAlign": ("_contrib_ROIAlign", {"pooled_size": (3, 3),
                                           "spatial_scale": 0.125},
                     [feat, rois], [0]),
        "BilinearSampler": ("BilinearSampler", {}, [
            feat, torch.from_numpy(rng.uniform(-1.1, 1.1, (2, 2, 5, 6))
                                   .astype("f4"))], [0, 1]),
        "DeformableConvolution": (
            "_contrib_DeformableConvolution",
            {"kernel": (3, 3), "num_filter": 8, "pad": (1, 1)},
            [feat, rand(2, 18, 8, 8, scale=0.7),
             rand(8, 16, 3, 3, scale=0.2), rand(8)], [0, 1, 2, 3]),
        "DeformablePSROIPooling": (
            "_contrib_DeformablePSROIPooling",
            {"spatial_scale": 0.125, "output_dim": 4, "group_size": 2,
             "pooled_size": 2, "sample_per_part": 2, "trans_std": 0.1},
            [feat, rois, rand(5, 8, 2, 2)], [0, 2]),
    }[name]


@pytest.mark.cuda
@pytest.mark.parametrize("name", [
    "MultiBoxTarget", "MultiBoxDetection", "ROIPooling", "ROIAlign",
    "BilinearSampler", "DeformableConvolution", "DeformablePSROIPooling"])
def test_detection_ops_on_the_card_match_the_cpu(name):
    """The detection, spatial and deformable ops on the card against the
    CPU on the same inputs (chip_smoke's `op_pair`): the discrete
    outputs of MultiBoxTarget (class targets, masks) and
    MultiBoxDetection (classes, scores) equal, the rest and every
    gradient within rtol 1e-5 + 1e-6 * max|ref| (chip_smoke 13a's gate;
    the seeded inputs hold no near tie)."""
    _need_card()
    cs = _chip_smoke()
    op, params, inputs, grad_idx = _det_case(name)
    (c, cg), (g, gg) = cs.op_pair(op, params, inputs, grad_idx)
    if name == "MultiBoxTarget":
        assert np.array_equal(c[1], g[1]) and np.array_equal(c[2], g[2])
        assert cs.op_ratio(g[0], c[0]) <= 1
    elif name == "MultiBoxDetection":
        assert np.array_equal(c[0][..., :2], g[0][..., :2])
        assert cs.op_ratio(g[0][..., 2:], c[0][..., 2:]) <= 1
    else:
        for a, b in zip(g + gg, c + cg):
            assert a.shape == b.shape and cs.op_ratio(a, b) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["decoded", "chain", "random"])
def test_nms_route_equals_the_loop_on_the_card(case):
    """`greedy_nms` on the card is bitwise the per-box loop: on a small
    SSD's decoded candidates, on a chain (the worst case) and on a
    random suppression matrix."""
    _need_card()
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch.ops.detection import (
        detection_candidates, greedy_nms)
    cs = _chip_smoke()
    if case == "decoded":
        prob, loc, anchors, _ = cs.ssd_head_inputs(mx, 64, 4)
        params = {"clip": True, "threshold": 0.01, "nms_threshold": 0.45,
                  "force_suppress": False,
                  "variances": (0.1, 0.1, 0.2, 0.2)}
        _, score, _, sup = detection_candidates(
            params, prob.cuda(), loc.cuda(), anchors.cuda())
        valid = score > 0
    elif case == "chain":
        n = 300
        sup = torch.zeros(2, n, n, dtype=torch.bool, device="cuda")
        i = torch.arange(n - 1, device="cuda")
        sup[:, i, i + 1] = True
        valid = torch.ones(2, n, dtype=torch.bool, device="cuda")
    else:
        gen = torch.Generator(device="cuda").manual_seed(0)
        sup = torch.rand(3, 200, 200, generator=gen, device="cuda") < 0.2
        valid = torch.rand(3, 200, generator=gen, device="cuda") < 0.8
    assert torch.equal(greedy_nms(sup, valid), cs.nms_loop(sup, valid))


@pytest.mark.cuda
def test_ssd_steps_on_the_card_match_the_cpu():
    """Two steps of the quarter-width SSD at 64x64, batch 4, fp32 (TF32
    off), on the card against the CPU from the same Xavier parameters
    and batches (chip_smoke's `ssd_steps`): readouts rtol 1e-3,
    parameters and momenta rtol 1e-3 + 1e-4 * max|array|."""
    _need_card()
    import incubator_mxnet_tpu_torch as mx
    cs = _chip_smoke()
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        sym = cs.ssd_symbol(mx, 3, small=True)
        cs.SSD_CFG = dict(cs.SSD_CFG, image=64)
        batches = [b for _, b in zip(range(2), cs.ssd_iter(mx, 8, 4, 64))]
        cpu_reads, cpu = cs.ssd_steps(mx, sym, mx.cpu(), batches)
        gpu_reads, gpu = cs.ssd_steps(mx, sym, mx.gpu(0), batches)
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = tf32
    np.testing.assert_allclose(gpu_reads, cpu_reads, rtol=1e-3)
    for got, ref in zip(gpu[-1], cpu[-1]):
        assert cs.ssd_ratio(got, ref)[0] <= 1


@pytest.mark.cuda
def test_kvstore_cases_on_the_card_equal_the_cpu():
    """chip_smoke's 14a cases at its shapes: reductions, 2-bit codes and
    residuals bit for bit; optimizer results rtol 1e-6 + 1e-6 * max."""
    _need_card()
    import incubator_mxnet_tpu_torch as mx
    cs = _chip_smoke()
    got = cs.kv_cases(mx, mx.gpu(0))
    want = cs.kv_cases(mx, mx.cpu(), cpu_store=True)
    for name, ref in want.items():
        if name.startswith("set_optimizer"):
            np.testing.assert_allclose(got[name], ref, rtol=1e-6,
                                       atol=1e-6 * np.abs(ref).max(),
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(got[name], ref, err_msg=name)


@pytest.mark.cuda
def test_two_contexts_on_one_card_match_one_context(monkeypatch):
    """train_mnist's mlp on [gpu(0), gpu(0)] through kvstore='device',
    3 steps, against one context on the card (TF32 off): loss rtol 1e-5,
    parameters and momenta rtol 1e-5 + 1e-6 * max|array|; K1 launches
    twice in each executor's forward."""
    _need_card()
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch.subgraph import fused_ops
    cs = _chip_smoke()
    monkeypatch.setenv("MXNET_SUBGRAPH_BACKEND", "TPU_PALLAS")
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        sym = cs.mlp_symbol(mx)
        train, _ = cs.mnist_iters(mx)
        batches = [next(train) for _ in range(3)]
        init = cs.dp_init(mx, sym)
        _, ref_loss, ref_p, ref_m, _ = cs.dp_steps(
            mx, sym, [mx.gpu(0)], batches, init, "local")
        fused_ops.fc_relu.launches = 0
        _, loss, p, m, _ = cs.dp_steps(mx, sym, [mx.gpu(0), mx.gpu(0)],
                                       batches, init, "device")
        launches = fused_ops.fc_relu.launches
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = tf32
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-5)
    assert cs.held_worst(p, ref_p, cs.DP_TOL)[0] <= 1
    assert cs.held_worst(m, ref_m, cs.DP_TOL)[0] <= 1
    assert launches == 4 * len(batches)


@pytest.mark.cuda
def test_wide_deep_small_on_the_card_matches_the_cpu(monkeypatch):
    """wide_deep.py's copy at 2 000 rows, 512 samples, one epoch, on the
    card (TPU_PALLAS, the cache on the card) against the CPU: the tower
    and the table rtol 1e-4 + 1e-5 * max|array|; the tier's counters
    equal; K1 once a forward."""
    _need_card()
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch.subgraph import fused_ops
    cs = _chip_smoke()
    monkeypatch.setenv("MXNET_SUBGRAPH_BACKEND", "TPU_PALLAS")
    cfg = dict(cs.WD_CFG, rows=2000, samples=512, epochs=1)
    sym = cs.wd_tower(mx, cs.WD_SLOTS * cfg["dim"], 4)
    shapes, _, _ = sym.infer_shape(emb=(64, 32), dense=(64, 4))
    rng = np.random.RandomState(0)
    init = {n: rng.uniform(-0.1, 0.1, s).astype(np.float32)
            for n, s in zip(sym.list_arguments(), shapes)
            if n not in ("emb", "dense", "softmax_label")}
    states = []
    for ctx in (mx.cpu(), mx.gpu(0)):
        fused_ops.fc_relu.launches = 0
        run = cs.wide_deep(mx, cfg, ctx, arg_params=init)
        try:
            states.append((cs.wd_state(run), fused_ops.fc_relu.launches))
        finally:
            cs.wide_deep_close(run)
    (ref, _), (got, launches) = states
    assert cs.held_worst(got["tower"], ref["tower"], cs.WD_TOL)[0] <= 1
    assert cs.held_worst({"t": got["table"]}, {"t": ref["table"]},
                         cs.WD_TOL)[0] <= 1
    assert got["counters"] == ref["counters"]
    assert launches == 512 // 64


@pytest.mark.cuda
def test_registry_tail_on_the_card_matches_the_cpu():
    """chip_smoke's 15a cases at a tenth of their sizes' rows where they
    are large: every op this slice registered, forward and gradients,
    card against CPU within its family's tolerance (exact, arith,
    prod); the update ops with their near ties counted."""
    _need_card()
    import incubator_mxnet_tpu_torch as mx
    cs = _chip_smoke()
    for op, params, inputs, gidx, fam in cs.ops15_cases():
        if op in ("LRN", "Deconvolution", "InstanceNorm"):
            inputs = [inputs[0][:4]] + list(inputs[1:])
        (c_out, c_g), (g_out, g_g) = cs.pair15(op, params, inputs, gidx)
        for g, c in zip(g_out, c_out):
            assert cs.ratio15(g, c, cs.OPS15_TOL[fam], op) <= 1
        for g, c in zip(g_g, c_g):
            assert cs.ratio15(g, c, cs.OPS15_TOL["arith" if fam == "exact"
                                                 else fam], op) <= 1
    assert cs.ops15_updates(mx)[0][0] <= 1


@pytest.mark.cuda
def test_ctc_and_deconvolution_routes_equal_their_plain_versions():
    """On the card: `F.ctc_loss` for the rows it computes alike and the
    plain loop for a row that cannot fit, against `ctc_plain`; cuDNN's
    transposed convolution against `deconv_plain`."""
    _need_card()
    from incubator_mxnet_tpu_torch.ops import ctc, nn, registry
    rng = np.random.RandomState(0)
    data = torch.from_numpy(rng.normal(0, 1, (30, 8, 6)).astype("f4"))
    label = rng.randint(1, 6, (8, 3)).astype("f4")
    label[2] = [4, 4, 4]
    lens = np.full(8, 30, "f4")
    lens[2] = 4
    dev = torch.device("cuda")
    op = registry.get("ctc_loss")
    p = op.canonicalize_params({"use_data_lengths": True})
    before = dict(ctc.ctc_routes)
    got = op.fn(p, data.to(dev), torch.from_numpy(label).to(dev),
                torch.from_numpy(lens).to(dev))
    assert ctc.ctc_routes["library"] - before["library"] == 7
    assert ctc.ctc_routes["plain"] - before["plain"] == 1
    logp = torch.log_softmax(data.to(dev), -1)
    lab = torch.from_numpy(label).long().to(dev)
    want = ctc.ctc_plain(logp, lab, torch.from_numpy(lens).long().to(dev),
                         (lab > 0).sum(1))
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-4)
    dp = registry.get("Deconvolution").canonicalize_params(
        {"kernel": (4, 4), "stride": (2, 2), "pad": (1, 1),
         "num_filter": 16, "no_bias": True})
    x = torch.from_numpy(rng.normal(0, 1, (4, 32, 8, 8)).astype("f4"))
    w = torch.from_numpy(rng.normal(0, 0.05, (32, 16, 4, 4)).astype("f4"))
    lib = registry.get("Deconvolution").fn(dp, x.to(dev), w.to(dev))
    plain = nn.deconv_plain(dp, x.to(dev), w.to(dev))
    np.testing.assert_allclose(lib.cpu().numpy(), plain.cpu().numpy(),
                               rtol=1e-4, atol=1e-5 * plain.abs().max()
                               .item())


@pytest.mark.cuda
def test_random_draws_on_the_card():
    """The same seed draws the same values on the card; the draws'
    moments within 5 sigma; shuffle permutes."""
    _need_card()
    import incubator_mxnet_tpu_torch as mx
    cs = _chip_smoke()
    draws = []
    for _ in range(2):
        mx.random.seed(3)
        draws.append(mx.nd.random.normal(1.0, 2.0, shape=(200000,),
                                         ctx=mx.gpu(0)).asnumpy())
    np.testing.assert_array_equal(draws[0], draws[1])
    assert cs.moments15(draws[0], 1.0, 4.0, "normal") <= 5
    x = mx.nd.array(np.arange(1000, dtype="f4"), ctx=mx.gpu(0))
    perm = mx.nd.random.shuffle(x).asnumpy()
    assert sorted(perm.tolist()) == list(range(1000))


@pytest.mark.cuda
def test_sequential_mlp_on_the_card_matches_the_cpu(monkeypatch):
    """chip_smoke's 15c at 3 steps: the mlp as a SequentialModule under
    TPU_PALLAS on the card against the CPU (phase 6's gate) and against
    one Module on the card (rtol 1e-5 + 1e-6 * max), the monitor's
    statistics rtol 1e-4 + 1e-5 * max, K1 twice a train forward."""
    _need_card()
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch.subgraph import fused_ops
    cs = _chip_smoke()
    monkeypatch.setenv("MXNET_SUBGRAPH_BACKEND", "TPU_PALLAS")
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        train, _ = cs.mnist_iters(mx)
        batches = [next(train) for _ in range(3)]
        fused_ops.fc_relu.launches = 0
        g_loss, g_st, g_rows, _ = cs.seq15_steps(mx, mx.gpu(0), batches,
                                                 monitor=mx.Monitor(1))
        launches = fused_ops.fc_relu.launches
        c_loss, c_st, c_rows, _ = cs.seq15_steps(mx, mx.cpu(), batches,
                                                 monitor=mx.Monitor(1))
        o_loss, o_st, _, _ = cs.seq15_steps(mx, mx.gpu(0), batches,
                                            split=False)
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = tf32
    assert launches == 2 * len(batches)
    np.testing.assert_allclose(g_loss, c_loss, rtol=cs.PARITY_TOL[0])
    np.testing.assert_allclose(g_loss, o_loss, rtol=cs.SEQ15_TOL[0])
    assert cs.param_ratio(g_st[-1][0], c_st[-1][0])[0] <= 1
    assert cs.seq15_ratio(g_st[-1][0], o_st[-1][0], cs.SEQ15_TOL)[0] <= 1
    keys = sorted(c_rows)
    assert sorted(g_rows) == keys
    assert cs.op_ratio([g_rows[k] for k in keys], [c_rows[k] for k in keys],
                       cs.MON15_TOL) <= 1


def _tf32_off():
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return old


def _tf32_restore(old):
    torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32 = old


@pytest.mark.cuda
def test_feedforward_mlp_on_the_card(monkeypatch, tmp_path):
    """chip_smoke's 16a: FeedForward against Module.fit on the card (rtol
    1e-5 + 1e-6 * max) and the CPU, K1 twice a train forward, save/load,
    a ragged predict against row-by-row answers."""
    _need_card()
    import incubator_mxnet_tpu_torch as mx
    cs = _chip_smoke()
    monkeypatch.setenv("MXNET_SUBGRAPH_BACKEND", "TPU_PALLAS")
    old = _tf32_off()
    try:
        out = cs.ff16(mx, "card", str(tmp_path))
    finally:
        _tf32_restore(old)
    assert out["vs_module"] <= 1.0 and out["k1_launches"] > 0


@pytest.mark.cuda
def test_c_predict_on_the_card(monkeypatch, tmp_path):
    """chip_smoke's 16d: the C program through the shim with dev_type 2
    against an in-process predictor (rtol 1e-6), K1 twice a forward,
    dev_type 1 against the card, dev_type 7 refused."""
    _need_card()
    import incubator_mxnet_tpu_torch as mx
    cs = _chip_smoke()
    monkeypatch.setenv("MXNET_SUBGRAPH_BACKEND", "TPU_PALLAS")
    old = _tf32_off()
    try:
        out = cs.c16(mx, "card", str(tmp_path))
    finally:
        _tf32_restore(old)
    assert out["k1_launches"] == 2


@pytest.mark.cuda
def test_test_utils_and_state_names_on_the_card():
    """chip_smoke's 16f and 16e's state step: check_consistency over
    [cpu(0), gpu(0)] (K1 in the card's forward), check_numeric_gradient
    in float64, a Module(state_names=) step against the CPU."""
    _need_card()
    import incubator_mxnet_tpu_torch as mx
    cs = _chip_smoke()
    old = _tf32_off()
    try:
        out = cs.utils16(mx, "card")
        worst = cs.state16(mx, "card")
    finally:
        _tf32_restore(old)
    assert out["k1_launches"] == 2 and worst <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_fc_relu_at_alexnet_fc6_on_card(dtype):
    """K1 at AlexNet's fc6, (M, 9216 -> 4096), for the served buckets'
    edges and the training batch, through the library's route and each
    route that takes the shape, against its plain version."""
    _need_card()
    dt = getattr(torch, dtype)
    for m in (1, 8, 32, 128):
        x, w, b = (torch.from_numpy(a).to("cuda", dt)
                   for a in _inputs(m, 9216, 4096, seed=m))
        _k1_call(x, w, b)
        for route in ROUTES:
            if launch_plan(x, w, route) is not None:
                _k1_call(x, w, b, route)


@pytest.mark.cuda
def test_alexnet_steps_on_the_card_match_the_cpu(monkeypatch):
    """chip_smoke's 17a: AlexNet composed on a Symbol under TPU_PALLAS,
    3 fused Module.fit steps at batch 8, 224x224, fp32, card against the
    CPU (phase 6's gates, K1 twice a step on the card), and the
    Dropout(0.5) train forward's kept share and scale."""
    _need_card()
    import incubator_mxnet_tpu_torch as mx
    cs = _chip_smoke()
    monkeypatch.setenv("MXNET_SUBGRAPH_BACKEND", "TPU_PALLAS")
    old = _tf32_off()
    try:
        out = cs.alex_parity(mx, "card")
    finally:
        _tf32_restore(old)
    assert out["worst"] <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 8, 17, 32])
def test_int8_fc_route_exact_on_card(m):
    """The quantized FC's route (a float64 GEMM) at fc8's K = 4096 gives
    the exact integer sums on the card, as on the CPU, at every served
    M; the whole op's outputs equal the CPU's."""
    _need_card()
    from incubator_mxnet_tpu_torch.ops import registry
    from incubator_mxnet_tpu_torch.ops.quantization import _int_dot
    rng = np.random.RandomState(m)
    x = rng.randint(-127, 128, (m, 4096)).astype(np.int8)
    w = rng.randint(-127, 128, (1000, 4096)).astype(np.int8)
    x[0] = 127
    w[0] = 127                          # a sum of 4096 * 127^2 > 2^24
    exact = x.astype(np.int64) @ w.astype(np.int64).T
    got = _int_dot(torch.from_numpy(x).cuda(), torch.from_numpy(w).cuda())
    np.testing.assert_array_equal(got.cpu().numpy(), exact)
    op = registry.get("_contrib_quantized_fully_connected")
    params = op.canonicalize_params({"num_hidden": 1000, "no_bias": True})
    r = np.array([1.5], np.float32)
    ins = [x, w, -r, r, -r * 0.5, r * 0.5]
    card = op.fn(params, *[torch.from_numpy(a).cuda() for a in ins])
    host = op.fn(params, *[torch.from_numpy(a) for a in ins])
    for c, h in zip(card, host):
        np.testing.assert_array_equal(c.cpu().numpy(), h.numpy())


@pytest.mark.cuda
def test_csr_batch_densified_on_card(tmp_path):
    """A LibSVM CSR batch crosses to the card as its parts and is
    densified there, by `dense_tensor` and by the h2d ring, equal to its
    rows bit for bit."""
    _need_card()
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import io_plane
    from incubator_mxnet_tpu_torch.ndarray import sparse
    rng = np.random.RandomState(0)
    dense = np.zeros((32, 5000), np.float32)
    lines = []
    for i in range(32):
        cols = np.sort(rng.choice(5000, 7, replace=False))
        vals = rng.rand(7).astype(np.float32)
        dense[i, cols] = vals
        lines.append("1 " + " ".join(f"{c}:{v!r}"
                                     for c, v in zip(cols, vals.tolist())))
    path = tmp_path / "rows.libsvm"
    path.write_text("\n".join(lines) + "\n")
    it = mx.io.LibSVMIter(data_libsvm=str(path), data_shape=(5000,),
                          batch_size=16)
    batches = list(it)
    for i, b in enumerate(batches):
        got = sparse.dense_tensor(b.data[0], torch.device("cuda", 0))
        assert got.is_cuda
        np.testing.assert_array_equal(got.cpu().numpy(),
                                      dense[16 * i:16 * (i + 1)])
    it.reset()
    ring = io_plane.DevicePrefetchIter(
        it, placement=io_plane.RingPlacement(ctx=mx.gpu(0)))
    for i, b in enumerate(ring):
        assert b.data[0].data.is_cuda
        np.testing.assert_array_equal(b.data[0].asnumpy(),
                                      dense[16 * i:16 * (i + 1)])


@pytest.mark.cuda
def test_fc_relu_launch_count_exact_across_threads():
    """`fc_relu.launches` counts every launch when 4 threads launch K1 at
    once (LocalReplicas' batcher threads): 4 x 50 calls count 200."""
    _need_card()
    import threading
    from incubator_mxnet_tpu_torch.subgraph import fused_ops
    x, w, b = (torch.from_numpy(a).cuda() for a in _inputs(4, 64, 32))
    fused_ops.fc_relu.launches = 0
    start = threading.Barrier(4)

    def calls():
        start.wait()
        for _ in range(50):
            fc_relu(x, w, b)

    threads = [threading.Thread(target=calls) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    assert fused_ops.fc_relu.launches == 200


@pytest.mark.cuda
def test_router_over_local_replicas_on_the_card(tmp_path):
    """A partitioned FC->ReLU mlp (6 -> 16 -> 3) served by a router over
    two LocalReplicas on gpu(0): answers within rtol 1e-4 + 1e-5 of the
    CPU's, both replicas served, and K1 launched once a served batch."""
    _need_card()
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch.compat.weights import params_from_numpy
    from incubator_mxnet_tpu_torch.subgraph import fused_ops
    s = mx.sym
    net = s.SoftmaxOutput(s.FullyConnected(s.Activation(s.FullyConnected(
        s.Variable("data"), num_hidden=16, name="fc0"), act_type="relu"),
        num_hidden=3, name="head"), name="softmax")
    sym = mx.subgraph.partition_graph(net, "TPU_PALLAS")
    rng = np.random.RandomState(0)
    params = {"fc0_weight": rng.normal(0, .5, (16, 6)).astype("f4"),
              "fc0_bias": rng.normal(0, .1, 16).astype("f4"),
              "head_weight": rng.normal(0, .5, (3, 16)).astype("f4"),
              "head_bias": rng.normal(0, .1, 3).astype("f4")}
    prefix = str(tmp_path / "mlp")
    mx.save_checkpoint(prefix, 0, sym,
                       params_from_numpy(params, None, ctx=mx.cpu())[0], {})
    kw = dict(data_shapes=[("data", (1, 6))], buckets=(1, 2, 4))
    host = mx.serving.ServedModel.load(prefix, 0, ctx=mx.cpu(), **kw)
    reps = [mx.serving.LocalReplica(mx.serving.ServedModel.load(
        prefix, 0, ctx=mx.gpu(0), **kw), replica_id=f"r{i}")
        for i in range(2)]
    reqs = [rng.randn(1 + i % 4, 6).astype("f4") for i in range(40)]
    fused_ops.fc_relu.launches = 0
    with mx.serving.ReplicaRouter(reps, health_interval_s=1e3) as router:
        futs = [router.submit({"data": x}) for x in reqs]
        got = [f.result(60)[0].asnumpy() for f in futs]
        batches = [r.stats()["batches"] for r in reps]
    assert fused_ops.fc_relu.launches == sum(batches)
    assert all(n > 0 for n in batches)
    for x, g in zip(reqs, got):
        want = host.infer({"data": x})[0].asnumpy()
        np.testing.assert_allclose(g, want, rtol=1e-4,
                                   atol=1e-5 * np.abs(want).max())


@pytest.mark.cuda
def test_traced_local_replica_batch_spans_match_k1(tmp_path):
    """A traced LocalReplica on gpu(0): one ``batcher.execute`` span per
    executed batch, each parented into a ``router.request`` trace, and K1
    launched once per span (the mlp has one K1 node)."""
    _need_card()
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch.compat.weights import params_from_numpy
    from incubator_mxnet_tpu_torch.obs import trace
    from incubator_mxnet_tpu_torch.subgraph import fused_ops
    s = mx.sym
    net = s.SoftmaxOutput(s.FullyConnected(s.Activation(s.FullyConnected(
        s.Variable("data"), num_hidden=16, name="fc0"), act_type="relu"),
        num_hidden=3, name="head"), name="softmax")
    sym = mx.subgraph.partition_graph(net, "TPU_PALLAS")
    rng = np.random.RandomState(0)
    params = {"fc0_weight": rng.normal(0, .5, (16, 6)).astype("f4"),
              "fc0_bias": rng.normal(0, .1, 16).astype("f4"),
              "head_weight": rng.normal(0, .5, (3, 16)).astype("f4"),
              "head_bias": rng.normal(0, .1, 3).astype("f4")}
    prefix = str(tmp_path / "mlp")
    mx.save_checkpoint(prefix, 0, sym,
                       params_from_numpy(params, None, ctx=mx.cpu())[0], {})
    rep = mx.serving.LocalReplica(mx.serving.ServedModel.load(
        prefix, 0, ctx=mx.gpu(0), data_shapes=[("data", (1, 6))],
        buckets=(1, 2, 4)), replica_id="r0")
    trace.enable()
    trace.reset()
    try:
        fused_ops.fc_relu.launches = 0
        with mx.serving.ReplicaRouter([rep], health_interval_s=1e3) as r:
            futs = [r.submit({"data": rng.randn(1 + i % 3, 6).astype("f4")})
                    for i in range(24)]
            for f in futs:
                f.result(60)
        spans = trace.buffered()
    finally:
        trace.disable()
        trace.reset()
    batches = [sp for sp in spans if sp["name"] == "batcher.execute"]
    roots = {sp["sp"]: sp for sp in spans if sp["name"] == "router.request"}
    assert len(roots) == 24
    assert batches and fused_ops.fc_relu.launches == len(batches)
    assert all(b["pa"] in roots and b["tr"] == roots[b["pa"]]["tr"]
               for b in batches)
    assert sum(b["args"]["requests"] for b in batches) == 24


@pytest.mark.cuda
@pytest.mark.parametrize("shape,route", [
    ((64, 128, 64), "cuda_core"), ((32, 128, 64), "cuda_core"),
    ((16, 128, 64), "cuda_core"), ((8, 128, 64), "cuda_core"),
    ((64, 32, 32), "cuda_core"), ((64, 784, 128), "tensor_core"),
    ((32, 784, 128), "tensor_core"), ((4, 784, 128), "cuda_core")])
def test_fc_relu_route_at_the_mlp_shapes(shape, route):
    """The library sends small fp32 weights (the mlp's fc2, wide_deep's
    deep1: N * K below fc_relu.cu's kTcMinWeights) to cuda_core and fc1
    by its kTcMinRows rule; each route agrees with `fc_relu_ref`."""
    _need_card()
    m, k, n = shape
    x, w, b = (torch.from_numpy(a).cuda() for a in _inputs(m, k, n))
    assert launch_plan(x, w)["route"] == route
    before = fc_relu.launches
    got = fc_relu(x, w, b)
    torch.cuda.synchronize()
    assert fc_relu.launches == before + 1
    ref = fc_relu_ref(x, w, b)
    torch.testing.assert_close(got, ref, rtol=1e-4,
                               atol=1e-4 * ref.abs().max().item())


def _guarded_mlp(mx, cs, momentum=0.9):
    """train_mnist's mlp under TPU_PALLAS on the card with phase 22's
    seeded parameters, bound and optimized, a guardian armed that never
    polls; returns (module, guardian, batches)."""
    from incubator_mxnet_tpu_torch.resilience import TrainingGuardian
    x, y = mx.test_utils.get_mnist_like(256)
    it = mx.io.NDArrayIter(x, y, 64, shuffle=False)
    mod = mx.mod.Module(cs.mlp_symbol(mx), context=mx.gpu(0))
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(arg_params={k: mx.nd.array(v, ctx=mx.cpu())
                                for k, v in cs.guard22_params(mx).items()})
    mod.init_optimizer(kvstore=None, optimizer="sgd", optimizer_params={
        "learning_rate": 0.1, "momentum": momentum})
    guardian = TrainingGuardian(interval=10 ** 9)
    guardian.attach(mod)
    return mod, guardian, list(it)


@pytest.mark.cuda
def test_guarded_mlp_step_makes_no_host_sync(monkeypatch):
    """22b's gate on the mlp: between polls the guarded fused step (K1 at
    fc1 and fc2) makes no synchronizing call the unguarded one does not
    (torch.cuda.set_sync_debug_mode('warn'); unguarded windows before and
    after the guarded one), and K1 ran twice a step."""
    _need_card()
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch.subgraph.fused_ops import fc_relu
    cs = _chip_smoke()
    monkeypatch.setenv("MXNET_SUBGRAPH_BACKEND", "TPU_PALLAS")
    mod, guardian, batches = _guarded_mlp(mx, cs)
    metric = mx.metric.create("acc")
    fs = mod._fused_step
    assert fs._guardian is guardian
    step = iter(batches * 8)

    def one():
        assert mod._fused_step(next(step), metric)

    counts = {}
    for name, g in (("plain", None), ("guarded", guardian),
                    ("plain2", None)):
        fs.attach_guardian(g)
        one()
        before = fc_relu.launches
        counts[name] = cs.sync_calls(one, 6)
        assert fc_relu.launches - before == 12
    plain = min(counts["plain"][0], counts["plain2"][0])
    assert counts["guarded"][0] <= plain, counts
    assert guardian.stats()["polls"] == 0
    assert guardian.stats()["steps_observed"] == 7


@pytest.mark.cuda
def test_nan_step_leaves_parameters_and_momenta_bit_identical(monkeypatch):
    """An injected grad.nonfinite step on the card leaves every weight
    and momentum bit for bit as it was (the guarded step's select), and
    the next poll counts one skip."""
    _need_card()
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch.resilience import faults
    cs = _chip_smoke()
    monkeypatch.setenv("MXNET_SUBGRAPH_BACKEND", "TPU_PALLAS")
    mod, guardian, batches = _guarded_mlp(mx, cs)
    metric = mx.metric.create("acc")
    mod.fit_step(batches[0], metric)

    def state():
        exe = mod._exec_group.execs[0]
        ws = [exe.arg_dict[n].data.clone() for n in sorted(exe.arg_dict)
              if n not in ("data", "softmax_label")]
        return ws + [s.data.clone() for _, s in
                     sorted(mod._updater.states.items())]

    before = state()
    faults.configure("grad.nonfinite:error(at=1)")
    try:
        mod.fit_step(batches[1], metric)
    finally:
        faults.clear()
    after = state()
    assert len(before) == len(after) == 12
    for a, b in zip(before, after):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    guardian.maybe_poll(2, force=True)
    assert guardian.stats()["skips"] == 1
    mod.fit_step(batches[2], metric)      # the next step trains again
    assert not all(torch.equal(a, b) for a, b in zip(after, state()))


@pytest.mark.cuda
def test_torn_checkpoint_commit_is_never_resumed(monkeypatch, tmp_path):
    """A ``checkpoint.commit`` torn write of the mlp's fit on the card
    commits a directory without its manifest: `latest` passes over it
    and a resume starts from the commit before it."""
    _need_card()
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import checkpoint as ckpt
    from incubator_mxnet_tpu_torch.resilience import faults
    cs = _chip_smoke()
    monkeypatch.setenv("MXNET_SUBGRAPH_BACKEND", "TPU_PALLAS")
    root = str(tmp_path / "ck")
    # commits at steps 4 and 8 and at the epoch's end (8 again: 8
    # batches of 64); the third is torn and replaces step 8's
    cs.guard22_fit(mx, mx.gpu(0), root, "checkpoint.commit:torn(at=3)",
                   num_epoch=1)
    torn = tmp_path / "ck" / ("ckpt-%010d" % 8)
    assert torn.is_dir() and not (torn / "manifest.json").exists()
    assert ckpt.latest(root).endswith("ckpt-%010d" % 4)
    resumed = cs.guard22_fit(mx, mx.gpu(0), root, resume=True, num_epoch=1)
    assert resumed._guardian is not None
    got = ckpt.latest(root)
    assert got is not None and (tmp_path / "ck" / os.path.basename(got) /
                                "manifest.json").exists()
