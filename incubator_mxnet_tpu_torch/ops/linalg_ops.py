"""Linear-algebra ops (reference `src/operator/tensor/la_op.cc`).

PyTorch port of `incubator_mxnet_tpu/ops/linalg_ops.py`: gemm, gemm2,
potrf, potri, trsm, trmm, syrk, gelqf, syevd, sumlogdiag, extractdiag,
makediag, extracttrian, inverse, det and slogdet, each over the last
two axes with the leading ones as a batch.  The decompositions are
`torch.linalg`'s (LAPACK on the CPU, cuSOLVER/cuBLAS on the card); their
gradients are autograd's through them, as the JAX ops' are `jax.vjp`'s.

Signs: `gelqf` is the QR of Aᵀ, so L's diagonal and Q's rows carry the
signs the QR routine picks, and `syevd`'s eigenvectors (returned as
rows) are unique only up to sign.  LAPACK, cuSOLVER and XLA may pick
them differently; L·Q = A, Q·Qᵀ = I and U·A·Uᵀ = diag(λ) hold whatever
they pick.
"""
from __future__ import annotations

import torch

from .registry import register


def _mt(a):
    return a.transpose(-1, -2)


@register("linalg_gemm", nin=3,
          params={"transpose_a": False, "transpose_b": False, "alpha": 1.0,
                  "beta": 1.0, "axis": -2})
def _linalg_gemm(params, a, b, c):
    """alpha * op(a) @ op(b) + beta * c."""
    a = _mt(a) if params["transpose_a"] else a
    b = _mt(b) if params["transpose_b"] else b
    return float(params["alpha"]) * torch.matmul(a, b) + \
        float(params["beta"]) * c


@register("linalg_gemm2", nin=2,
          params={"transpose_a": False, "transpose_b": False, "alpha": 1.0,
                  "axis": -2})
def _linalg_gemm2(params, a, b):
    a = _mt(a) if params["transpose_a"] else a
    b = _mt(b) if params["transpose_b"] else b
    return float(params["alpha"]) * torch.matmul(a, b)


@register("linalg_potrf", nin=1)
def _linalg_potrf(params, a):
    """The lower Cholesky factor L of a = L Lᵀ."""
    return torch.linalg.cholesky(a)


@register("linalg_potri", nin=1)
def _linalg_potri(params, a):
    """The inverse of L Lᵀ given its Cholesky factor L."""
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device).expand(
        a.shape)
    linv = torch.linalg.solve_triangular(a, eye, upper=False)
    return torch.matmul(_mt(linv), linv)


@register("linalg_trsm", nin=2,
          params={"transpose": False, "rightside": False, "lower": True,
                  "alpha": 1.0})
def _linalg_trsm(params, a, b):
    """X with op(a) X = alpha b (X op(a) = alpha b with ``rightside``),
    a triangular; the JAX op's reading of the flags."""
    alpha = float(params["alpha"])
    trans, lower = params["transpose"], params["lower"]
    solve = torch.linalg.solve_triangular
    if params["rightside"]:
        if trans:
            xt = solve(a, _mt(b) * alpha, upper=not lower)
        else:
            xt = solve(_mt(a), _mt(b) * alpha, upper=lower)
        return _mt(xt)
    if trans:
        return solve(_mt(a), b * alpha, upper=lower)
    return solve(a, b * alpha, upper=not lower)


@register("linalg_trmm", nin=2,
          params={"transpose": False, "rightside": False, "lower": True,
                  "alpha": 1.0})
def _linalg_trmm(params, a, b):
    alpha = float(params["alpha"])
    tri = torch.tril(a) if params["lower"] else torch.triu(a)
    if params["transpose"]:
        tri = _mt(tri)
    if params["rightside"]:
        return alpha * torch.matmul(b, tri)
    return alpha * torch.matmul(tri, b)


@register("linalg_syrk", nin=1, params={"transpose": False, "alpha": 1.0})
def _linalg_syrk(params, a):
    if params["transpose"]:
        return float(params["alpha"]) * torch.matmul(_mt(a), a)
    return float(params["alpha"]) * torch.matmul(a, _mt(a))


@register("linalg_gelqf", nin=1, nout=2)
def _linalg_gelqf(params, a):
    """(L, Q) with a = L Q, from the QR of aᵀ."""
    q, r = torch.linalg.qr(_mt(a))
    return _mt(r), _mt(q)


@register("linalg_syevd", nin=1, nout=2)
def _linalg_syevd(params, a):
    """(U, λ): the eigenvectors of symmetric a as the rows of U, the
    eigenvalues ascending."""
    w, v = torch.linalg.eigh(a)
    return _mt(v), w


@register("linalg_sumlogdiag", nin=1)
def _linalg_sumlogdiag(params, a):
    return torch.log(torch.diagonal(a, dim1=-2, dim2=-1)).sum(dim=-1)


@register("linalg_extractdiag", nin=1, params={"offset": 0})
def _linalg_extractdiag(params, a):
    return torch.diagonal(a, offset=int(params["offset"]), dim1=-2, dim2=-1)


@register("linalg_makediag", nin=1, params={"offset": 0})
def _linalg_makediag(params, a):
    return torch.diag_embed(a, offset=int(params["offset"]))


@register("linalg_extracttrian", nin=1, params={"offset": 0, "lower": True})
def _linalg_extracttrian(params, a):
    """The triangle at diagonal `offset`, packed row by row (lower:
    offset <= 0 moves below the diagonal; upper: offset >= 0 above)."""
    n = a.shape[-1]
    k = int(params["offset"])
    fn = torch.tril_indices if params["lower"] else torch.triu_indices
    ii, jj = fn(n, n, offset=k, device=a.device)
    return a[..., ii, jj]


@register("linalg_inverse", nin=1)
def _linalg_inverse(params, a):
    return torch.linalg.inv(a)


@register("linalg_det", nin=1)
def _linalg_det(params, a):
    return torch.linalg.det(a)


@register("linalg_slogdet", nin=1, nout=2)
def _linalg_slogdet(params, a):
    sign, logdet = torch.linalg.slogdet(a)
    return sign, logdet
