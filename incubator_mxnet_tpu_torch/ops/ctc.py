"""CTC loss (reference `src/operator/contrib/ctc_loss.cc` over warpctc).

PyTorch port of `incubator_mxnet_tpu/ops/ctc.py`.  Blank is class 0
whatever ``blank_label`` says ("last" is accepted and ignored, as in the
JAX op), and without ``use_label_lengths`` a label's length is its count
of labels above 0, the padding value.  Two routes compute the same
function:

* `ctc_plain`: the JAX op's forward (alpha) recursion in log space, one
  step per time step over the batch, with a finite NEG = -1e30 for
  unreachable states, so an alignment that cannot fit gives a finite
  loss; autograd through it gives the gradient, as `jax.vjp` of the
  JAX op's `lax.scan` does.  Tensors off the card take it.
* on the card, `torch.nn.functional.ctc_loss` (the library's kernels)
  for every row it computes alike: the labels are a run of positive
  classes and the input is long enough for them, so the loss is
  finite.  The other rows, where the library would give inf or
  read the labels otherwise, take `ctc_plain`.  ``ctc_routes`` counts
  the rows each route computed.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .registry import register

NEG = -1e30

ctc_routes = {"library": 0, "plain": 0}


def _lse3(a, b, c):
    m = torch.maximum(torch.maximum(a, b), c)
    return m + torch.log(torch.exp(a - m) + torch.exp(b - m) +
                         torch.exp(c - m))


def ctc_plain(logp, labels, input_len, label_len):
    """-log p(label | input) per sequence.  logp (T, N, C) log-probs;
    labels (N, L) int64; input_len, label_len (N,) int64."""
    T, N, C = logp.shape
    L = labels.shape[1]
    S = 2 * L + 1
    dev, dt = logp.device, logp.dtype
    ext = torch.zeros((N, S), dtype=torch.int64, device=dev)
    ext[:, 1::2] = labels
    s_idx = torch.arange(S, device=dev)
    valid_s = s_idx[None, :] < (2 * label_len[:, None] + 1)
    ext_m2 = torch.cat([torch.full((N, 2), -1, dtype=torch.int64,
                                   device=dev), ext[:, :-2]], dim=1)
    can_skip = (ext != 0) & (ext != ext_m2)
    neg = torch.full((N, S), NEG, dtype=dt, device=dev)
    lp0 = logp[0].gather(1, ext)                          # (N, S)
    alpha = torch.where(s_idx[None, :] == 0, lp0, neg)
    alpha = torch.where((s_idx[None, :] == 1) & (label_len[:, None] > 0),
                        lp0, alpha)
    pad1 = torch.full((N, 1), NEG, dtype=dt, device=dev)
    pad2 = torch.full((N, 2), NEG, dtype=dt, device=dev)
    for t in range(1, T):
        a1 = torch.cat([pad1, alpha[:, :-1]], dim=1)
        a2 = torch.where(can_skip, torch.cat([pad2, alpha[:, :-2]], dim=1),
                         neg)
        new = _lse3(alpha, a1, a2) + logp[t].gather(1, ext)
        new = torch.where(valid_s, new, neg)
        alpha = torch.where((t < input_len)[:, None], new, alpha)
    end1 = alpha.gather(1, (2 * label_len).clamp_min(0)[:, None])[:, 0]
    end2 = torch.where(label_len > 0, alpha.gather(
        1, (2 * label_len - 1).clamp_min(0)[:, None])[:, 0],
        torch.full_like(end1, NEG))
    m = torch.maximum(end1, end2)
    return -(m + torch.log(torch.exp(end1 - m) + torch.exp(end2 - m)))


def _library_rows(logp, labels, input_len, label_len):
    """(loss, rows it holds) of `F.ctc_loss`: rows whose labels are a
    run of label_len positive classes and whose input is long enough to
    fit them (a blank between each repeated pair), where the loss is
    finite."""
    L = labels.shape[1]
    pos = torch.arange(L, device=labels.device)[None, :]
    inside = pos < label_len[:, None]
    regular = ((labels > 0) | ~inside).all(dim=1) & (label_len <= L)
    repeats = ((labels[:, 1:] == labels[:, :-1]) & inside[:, 1:]).sum(dim=1)
    fits = input_len >= torch.clamp(label_len + repeats, min=1)
    loss = F.ctc_loss(logp, labels.clamp_min(0), input_len, label_len,
                      blank=0, reduction="none", zero_infinity=True)
    return loss, regular & fits


@register("ctc_loss", nin=-1,
          aliases=("CTCLoss", "_contrib_ctc_loss", "_contrib_CTCLoss"),
          params={"use_data_lengths": False, "use_label_lengths": False,
                  "blank_label": "first"})
def _ctc_loss(params, data, label, *rest):
    """data (T, N, C) activations (softmax inside, as warpctc); label
    (N, L) padded with 0; optional data_lengths (N,) and label_lengths
    (N,).  Returns the loss per sequence (N,)."""
    T, N, C = data.shape
    logp = torch.log_softmax(data, dim=-1)
    idx = 0
    if params["use_data_lengths"]:
        data_lens = rest[idx].to(torch.int64)
        idx += 1
    else:
        data_lens = torch.full((N,), T, dtype=torch.int64,
                               device=data.device)
    labels = label.to(torch.int64)
    if params["use_label_lengths"]:
        label_lens = rest[idx].to(torch.int64)
    else:
        label_lens = (labels > 0).to(torch.int64).sum(dim=1)
    if data.device.type == "meta":
        return torch.empty((N,), dtype=data.dtype, device="meta")
    if not data.is_cuda:
        ctc_routes["plain"] += N
        return ctc_plain(logp, labels, data_lens, label_lens)
    loss, held = _library_rows(logp, labels, data_lens, label_lens)
    n_lib = int(held.sum())
    ctc_routes["library"] += n_lib
    if n_lib == N:
        return loss.to(data.dtype)
    ctc_routes["plain"] += N - n_lib
    rows = torch.nonzero(~held)[:, 0]
    plain = ctc_plain(logp[:, rows], labels[rows], data_lens[rows],
                      label_lens[rows])
    return loss.to(data.dtype).index_put((rows,), plain.to(data.dtype))
