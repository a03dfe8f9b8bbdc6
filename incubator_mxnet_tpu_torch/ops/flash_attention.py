"""Flash attention: the forward as hand-written CUDA kernels.

PyTorch port of `incubator_mxnet_tpu/ops/flash_attention.py`.  Two
surfaces, with the JAX package's names and signatures:

* `flash_attention(q, k, v, causal, block_q, block_k)`: exact attention,
  differentiable (`FlashAttention`; the backward recomputes blockwise in
  plain torch from the saved row max and sum, as the JAX package's
  custom VJP does in jnp).
* `flash_attention_partial(q, k, v, q_off, k_off, causal, ...)`: the
  UNNORMALISED output and the per-row max m and sum l (fp32) of one KV
  shard, the contract of one ring step (`parallel.ring_attention`).

Layout (B, T, H, D) at the API.  Two kernels, in ``csrc/flash_attn.cu``
(see the note there for what bounds them on the card and what their
design does about it):

* K2, `flash_fwd`: one block walks the whole KV range (replaces the
  Pallas `_fwd_kernel` behind `_partial_tpu`);
* K3, `flash_fwd_stream`: the KV range split across blocks, then merged
  (replaces the Pallas `_fwd_kernel_stream` behind `_stream_tpu`).

Up to D = 256 both run on the tensor cores (``wgmma``, K/V tiles fed by
TMA): bf16 and fp16 in one pass, fp32 in three TF32 passes (3xTF32,
fp32-accurate).
`_route` picks between K2 and K3 with the JAX package's rule
(``MXNET_FLASH_VMEM_MB``, see `config`).  On a CUDA tensor a wrapper
launches its kernel or raises; only a tensor on the CPU takes the plain
version `_partial_ref`.  The kernels take head sizes that are multiples
of 8 (above 256 on a CUDA-core kernel of their own); the wrappers
zero-pad any other D to the next multiple of 8 (`_pad_head`), scale by
1/sqrt of the original D and slice o back, and copy an operand whose
layout the kernels cannot read (`_readable`).  On the card ``block_q``
and ``block_k`` steer only the plain version and the backward's loop:
the kernels choose their own tiles.  A row that sees no key (causal,
``q_off + row < k_off``) gives m = -1e30, l = 0 and o = 0, as the TPU
kernel does.  In float16 the unnormalised o of a long row can pass 65504
and become inf, as the TPU kernel's cast of its fp32 accumulator does;
the normalised output of `flash_attention` is then not finite either.
"""
from __future__ import annotations

import ctypes
import math

import torch

from .. import config as _config
from ..base import MXNetError

__all__ = ["flash_attention", "flash_attention_partial", "flash_fwd",
           "flash_fwd_stream", "stream_plan", "FlashAttention"]

_NEG = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _partial_ref(q3, k3, v3, q_off, k_off, causal, block_k, scale=None):
    """The plain version of K2 and K3 on (BH, T, D) tensors: the
    blockwise online softmax, with the kernels' rounding points (q scaled
    by ``scale``, 1/sqrt(D) by default, and rounded to its dtype, fp32
    scores and sums, p cast to v's dtype before P.V).  Masked keys get
    p = 0, so a row with no visible key keeps m = -1e30, l = 0, o = 0."""
    BH, Tq, D = q3.shape
    kv_len = k3.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    dev = q3.device
    qs = (q3.float() * scale).to(q3.dtype).float()
    m = torch.full((BH, Tq), _NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((BH, Tq), dtype=torch.float32, device=dev)
    acc = torch.zeros((BH, Tq, D), dtype=torch.float32, device=dev)
    q_pos = q_off + torch.arange(Tq, device=dev)
    for i in range(-(-kv_len // block_k)):
        ks = k3[:, i * block_k:(i + 1) * block_k].float()
        vs = v3[:, i * block_k:(i + 1) * block_k]
        s = qs @ ks.transpose(1, 2)
        if causal:
            k_pos = k_off + i * block_k + torch.arange(ks.shape[1],
                                                       device=dev)
            s = s.masked_fill(q_pos[:, None] < k_pos[None, :], -math.inf)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + p.to(vs.dtype).float() @ vs.float()
        m = m_new
    return acc.to(q3.dtype), m, l


def _to3(x):
    b, t, h, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b * h, t, d)


def _ref_bthd(q, k, v, q_off, k_off, causal, block_k, scale=None):
    """`_partial_ref` at the API layout: o (B, Tq, H, D), m, l (B, H, Tq)."""
    B, Tq, H, D = q.shape
    o3, m3, l3 = _partial_ref(_to3(q), _to3(k), _to3(v), q_off, k_off,
                              causal, block_k, scale)
    return (o3.reshape(B, H, Tq, D).permute(0, 2, 1, 3),
            m3.reshape(B, H, Tq), l3.reshape(B, H, Tq))


def _route(kv_len, D, dtype):
    """``"whole"`` (K2) or ``"stream"`` (K3): the JAX package's rule, K3
    when one head's K and V take more than ``MXNET_FLASH_VMEM_MB`` MiB."""
    item = torch.empty((), dtype=dtype).element_size()
    budget = int(float(_config.get("MXNET_FLASH_VMEM_MB")) * 2 ** 20)
    return "stream" if 2 * kv_len * D * item > budget else "whole"


def _check(name, q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise MXNetError(f"{name}: expects q, k, v as (B, T, H, D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, _, H, D = q.shape
    if k.shape != v.shape or (k.shape[0], k.shape[2], k.shape[3]) != \
            (B, H, D):
        raise MXNetError(f"{name}: shape mismatch q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if not (q.device == k.device == v.device):
        raise MXNetError(f"{name}: q, k, v must share a device; got "
                         f"{q.device}, {k.device}, {v.device}")


def _promote(name, q, k, v):
    """Validate; returns q, k, v cast to the dtype they promote to
    (`torch.promote_types`), the dtype whose kernel runs.  The wrappers
    cast o back to q's dtype, as the JAX kernels' promoted products
    give it."""
    _check(name, q, k, v)
    dt = torch.promote_types(torch.promote_types(q.dtype, k.dtype), v.dtype)
    return q.to(dt), k.to(dt), v.to(dt)


def _lib():
    from ..kernels import _build
    lib = _build.load("flash_attn")
    if lib.mx_flash_fwd.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        ll = ctypes.c_longlong
        arr = ctypes.POINTER(ll)
        f = ctypes.c_float
        lib.mx_flash_fwd.argtypes = [p, p, p, p, p, p, arr, arr, f, i, p]
        lib.mx_flash_fwd.restype = i
        lib.mx_flash_fwd_stream_plan.argtypes = [arr, i, i, arr]
        lib.mx_flash_fwd_stream_plan.restype = i
        lib.mx_flash_fwd_stream.argtypes = [p, p, p, p, p, p, p, ll, arr,
                                            arr, f, i, i, p]
        lib.mx_flash_fwd_stream.restype = i
        lib.mx_cuda_error_string.argtypes = [i]
        lib.mx_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _pad_head(x):
    """x with its head dimension zero-padded up to a multiple of 8, the
    kernels' multiple (x itself when D already is one).  Zero columns add
    nothing to q.k and give zero columns of o, which the wrappers slice
    off."""
    pad = -x.shape[3] % 8
    return torch.nn.functional.pad(x, (0, pad)) if pad else x


def _readable(x):
    """x, or a fresh contiguous copy of it where the kernels cannot read
    its layout: the head dimension contiguous, the other strides multiples
    of 8 elements and the data 16-byte aligned (TMA's rule)."""
    st = x.stride()
    if st[3] != 1 or any(s % 8 for s in st[:3]) or x.data_ptr() % 16:
        return x.clone(memory_format=torch.contiguous_format)
    return x


def _kernel_call(name, q, k, v, q_off, k_off, causal):
    """Validate CUDA operands, pad their head dimension (`_pad_head`) and
    copy what the kernels cannot read (`_readable`); allocate o (padded),
    m, l (uninitialised: the kernels write every row); the dims and
    strides arrays of the C interface.  Returns the padded q, k, v, then
    o, m, l, dims, strides; None for the arrays when the call has no work
    (an empty dimension): then o, m, l already hold the result."""
    if q.device.type != "cuda":
        raise MXNetError(f"{name}: no kernel for device {q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise MXNetError(f"{name}: kernel takes float32, bfloat16 or "
                         f"float16, got {q.dtype}")
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    q, k, v = (_readable(_pad_head(x)) for x in (q, k, v))
    Dp = q.shape[3]
    o = torch.empty((B, Tq, H, Dp), dtype=q.dtype, device=q.device)
    if B * H * Tq == 0 or Tk == 0:
        m = torch.full((B, H, Tq), _NEG, dtype=torch.float32, device=q.device)
        l = torch.zeros((B, H, Tq), dtype=torch.float32, device=q.device)
        return q, k, v, o.zero_(), m, l, None, None
    m = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    l = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    dims = (ctypes.c_longlong * 8)(B, H, Tq, Tk, Dp, int(q_off), int(k_off),
                                   int(bool(causal)))
    strides = (ctypes.c_longlong * 12)(*(q.stride()[:3] + k.stride()[:3]
                                         + v.stride()[:3] + o.stride()[:3]))
    return q, k, v, o, m, l, dims, strides


def _raise_on(name, lib, err):
    if err:
        raise MXNetError(f"{name}: kernel launch failed: "
                         + lib.mx_cuda_error_string(err).decode())


def flash_fwd(q, k, v, q_off=0, k_off=0, causal=False, block_k=256):
    """K2: partial attention with the whole KV range in one block's loop.
    CUDA tensors launch the kernel (counted in ``flash_fwd.launches``);
    CPU tensors take `_partial_ref` with ``block_k``.  Operands of mixed
    dtypes run in their promoted dtype; o comes back in q's."""
    out_dtype = q.dtype
    q, k, v = _promote("flash_fwd", q, k, v)
    if q.device.type == "cpu":
        o, m, l = _ref_bthd(q, k, v, q_off, k_off, causal, block_k)
        return o.to(out_dtype), m, l
    D = q.shape[3]
    qp, kp, vp, o, m, l, dims, strides = _kernel_call(
        "flash_fwd", q, k, v, q_off, k_off, causal)
    if dims is None:
        return o[..., :D].to(out_dtype), m, l
    lib = _lib()
    with torch.cuda.device(q.device):
        err = lib.mx_flash_fwd(
            qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), o.data_ptr(),
            m.data_ptr(), l.data_ptr(), dims, strides, 1.0 / math.sqrt(D),
            _DTYPE_CODE[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on("flash_fwd", lib, err)
    flash_fwd.launches += 1
    return o[..., :D].to(out_dtype), m, l


flash_fwd.launches = 0


def stream_plan(q, k, q_off=0, k_off=0, causal=False):
    """K3's split-KV plan for q, k on their CUDA device, as the kernel
    library computes it for q's dtype and head size (padded to a multiple
    of 8): a dict of KV ranges (``splits``), KV tiles per range
    (``chunk``), fp32 workspace elements (``workspace``), the dtype's
    route's keys per KV tile (``tile``), query rows per block (``rows``)
    and column groups of O (``groups``: D / 128 rounded up above
    D = 128), and the SM count; None outside the kernel's range."""
    if q.dtype not in _DTYPE_CODE:
        return None
    lib = _lib()
    B, Tq, H, D = q.shape
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    dims = (ctypes.c_longlong * 8)(B, H, Tq, k.shape[1], -(-D // 8) * 8,
                                   int(q_off), int(k_off), int(bool(causal)))
    plan = (ctypes.c_longlong * 6)()
    if lib.mx_flash_fwd_stream_plan(dims, _DTYPE_CODE[q.dtype], sms, plan):
        return None
    return dict(zip(("splits", "chunk", "workspace", "tile", "rows",
                     "groups"), plan), sm_count=sms)


def flash_fwd_stream(q, k, v, q_off=0, k_off=0, causal=False, block_k=256):
    """K3: partial attention with the KV range split across blocks and
    merged by a second kernel; both launches count once in
    ``flash_fwd_stream.launches``.  CPU tensors take `_partial_ref`.
    Operands of mixed dtypes run in their promoted dtype; o comes back in
    q's."""
    out_dtype = q.dtype
    q, k, v = _promote("flash_fwd_stream", q, k, v)
    if q.device.type == "cpu":
        o, m, l = _ref_bthd(q, k, v, q_off, k_off, causal, block_k)
        return o.to(out_dtype), m, l
    D = q.shape[3]
    qp, kp, vp, o, m, l, dims, strides = _kernel_call(
        "flash_fwd_stream", q, k, v, q_off, k_off, causal)
    if dims is None:
        return o[..., :D].to(out_dtype), m, l
    plan = stream_plan(qp, kp, q_off, k_off, causal)
    if plan is None:
        raise MXNetError(f"flash_fwd_stream: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)} are outside the kernel's range")
    ws = torch.empty(plan["workspace"], dtype=torch.float32, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        err = lib.mx_flash_fwd_stream(
            qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), o.data_ptr(),
            m.data_ptr(), l.data_ptr(), ws.data_ptr(), plan["workspace"],
            dims, strides, 1.0 / math.sqrt(D), _DTYPE_CODE[q.dtype],
            plan["sm_count"], torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on("flash_fwd_stream", lib, err)
    flash_fwd_stream.launches += 1
    return o[..., :D].to(out_dtype), m, l


flash_fwd_stream.launches = 0


def flash_attention_partial(q, k, v, q_off=0, k_off=0, causal=False,
                            block_q=256, block_k=256):
    """Unnormalised attention over one KV shard.

    q: (B, Tq, H, D), k/v: (B, Tk, H, D).  Returns (o_unnorm, m, l) with
    o_unnorm (B, Tq, H, D) in q's dtype and m/l (B, H, Tq) in fp32 (k
    and v may have other dtypes: the call runs in the promoted one),
    combinable across shards with the online-softmax merge (ring
    attention's carry).  q_off/k_off are the global sequence offsets for
    the causal mask.  ``block_q`` is kept for the JAX signature; only
    ``block_k`` steers the plain version."""
    _check("flash_attention_partial", q, k, v)
    fwd = flash_fwd if _route(k.shape[1], q.shape[3], q.dtype) == "whole" \
        else flash_fwd_stream
    return fwd(q, k, v, q_off, k_off, causal, block_k)


class FlashAttention(torch.autograd.Function):
    """Exact attention without the (T, T) score tensor: the forward is K2
    or K3 and the division by l; the backward is a plain-torch
    transcription of the JAX package's `_flash_bwd` (fp32, one loop over
    ``block_k`` key blocks, the delta = rowsum(dO * O) shortcut)."""

    @staticmethod
    def forward(ctx, q, k, v, causal=False, block_q=256, block_k=256):
        o, m, l = flash_attention_partial(q, k, v, 0, 0, causal, block_q,
                                          block_k)
        out = o / l.transpose(1, 2)[..., None].to(o.dtype)
        ctx.save_for_backward(q, k, v, out, m, l)
        ctx.causal = causal
        ctx.block_k = block_k
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, m, l = ctx.saved_tensors
        causal, block_k = ctx.causal, ctx.block_k
        T, D = q.shape[1], q.shape[3]
        Tk = k.shape[1]
        scale = 1.0 / math.sqrt(D)
        delta = (g.float() * out.float()).sum(dim=-1).transpose(1, 2)
        qh = q.transpose(1, 2).float()                   # (B, H, T, D)
        kh = k.transpose(1, 2).float()
        vh = v.transpose(1, 2).float()
        gh = g.transpose(1, 2).float()
        dq = torch.zeros_like(qh)
        dk = torch.zeros_like(kh)
        dv = torch.zeros_like(vh)
        q_pos = torch.arange(T, device=q.device)
        for i in range(-(-Tk // block_k)):
            sl = slice(i * block_k, (i + 1) * block_k)
            ks, vs = kh[:, :, sl], vh[:, :, sl]
            s = (qh @ ks.transpose(-1, -2)) * scale
            if causal:
                k_pos = torch.arange(Tk, device=q.device)[sl]
                s = torch.where(q_pos[:, None] >= k_pos[None, :], s,
                                torch.full_like(s, _NEG))
            p = torch.exp(s - m[..., None]) / l[..., None]
            dv[:, :, sl] += p.transpose(-1, -2) @ gh
            dp = gh @ vs.transpose(-1, -2)
            ds = p * (dp - delta[..., None]) * scale
            dq += ds @ ks
            dk[:, :, sl] += ds.transpose(-1, -2) @ qh

        def back(a, like):
            return a.transpose(1, 2).to(like.dtype)
        return back(dq, q), back(dk, k), back(dv, v), None, None, None


def flash_attention(q, k, v, causal=False, block_q=256, block_k=256):
    """Exact attention, q/k/v (B, T, H, D) -> (B, T, H, D), through
    `FlashAttention` (K2 or K3 forward, plain-torch backward)."""
    return FlashAttention.apply(q, k, v, causal, block_q, block_k)
