"""Object-detection operators.

PyTorch port of `incubator_mxnet_tpu/ops/detection.py` (reference
`src/operator/contrib/` multibox_prior.cc, multibox_target.cc,
multibox_detection.cc, bounding_box.cc box_nms/box_iou, roi_align.cc;
legacy `roi_pooling.cc`), with the JAX ops' names, params and outputs.
They feed the SSD config (BASELINE config #5).

Two of them run a greedy non-maximum suppression: `MultiBoxDetection` and
`box_nms`.  The JAX ops walk the N score-sorted boxes in a `fori_loop`;
an eager loop would cost a few launches a box.  `greedy_nms` computes the
same function in a few launches a round: see its docstring.  Ties follow
the JAX ops: sorts are stable (`jnp.argsort`), arg-maxima take the first
maximum, and `MultiBoxTarget`'s force-match scatter keeps the last label
row of those that pick the same anchor (XLA applies duplicate scatter
indices in order).
"""
from __future__ import annotations

import numpy as np
import torch

from .registry import register, REQUIRED


def true_div(x, d):
    """x / d for a Python number d, rounded as the CPU rounds it: CUDA
    turns a division by a host scalar into a product with its
    reciprocal, an ulp off, enough to move a floor or a ceil."""
    return x / torch.tensor(d, dtype=x.dtype, device=x.device)


def _parse_floats(v, default):
    if v is None or v == ():
        return tuple(default)
    if isinstance(v, (int, float)):
        return (float(v),)
    return tuple(float(x) for x in v)


@register("_contrib_MultiBoxPrior", aliases=("MultiBoxPrior",),
          params={"sizes": (1.0,), "ratios": (1.0,), "clip": False,
                  "steps": (-1.0, -1.0), "offsets": (0.5, 0.5)})
def _multibox_prior(params, data):
    """Anchors of a (B, C, H, W) feature map, (1, H*W*A, 4) corners
    (reference multibox_prior-inl.h): for each cell, (sizes[0], r) for
    every ratio r, then every further size at ratios[0].  They depend on
    the map's shape only."""
    sizes = _parse_floats(params["sizes"], [1.0])
    ratios = _parse_floats(params["ratios"], [1.0])
    offsets = _parse_floats(params["offsets"], [0.5, 0.5])
    steps = _parse_floats(params["steps"], [-1.0, -1.0])
    h, w = data.shape[2], data.shape[3]
    step_y = steps[0] if steps[0] > 0 else 1.0 / h
    step_x = steps[1] if steps[1] > 0 else 1.0 / w
    f32 = dict(dtype=torch.float32, device=data.device)
    cy = (torch.arange(h, **f32) + offsets[0]) * step_y
    cx = (torch.arange(w, **f32) + offsets[1]) * step_x
    whs = [(sizes[0] * np.sqrt(r), sizes[0] / np.sqrt(r)) for r in ratios]
    whs += [(s * np.sqrt(ratios[0]), s / np.sqrt(ratios[0]))
            for s in sizes[1:]]
    half = torch.tensor(whs, **f32) / 2                     # (A, 2) w, h
    na = half.shape[0]
    gy, gx = torch.meshgrid(cy, cx, indexing="ij")
    cxy = torch.stack([gx, gy], dim=-1)[:, :, None, :].expand(h, w, na, 2)
    half = half[None, None].expand(h, w, na, 2)
    boxes = torch.cat([cxy - half, cxy + half], dim=-1).reshape(1, -1, 4)
    if params["clip"]:
        boxes = torch.clamp(boxes, 0.0, 1.0)
    return boxes.to(data.dtype)


def box_iou_xyxy(a, b):
    """IoU between (..., Na, 4) and (..., Nb, 4) corner boxes, 0 where
    the union is empty; (..., Na, Nb).  Coordinate by coordinate, so no
    (..., Na, Nb, 2) temporary is made; the same values as the JAX op's
    pairwise form."""
    def pair(f, k):
        return f(a[..., :, None, k], b[..., None, :, k])

    iw = torch.clamp(pair(torch.minimum, 2) - pair(torch.maximum, 0),
                     min=0.0)
    ih = torch.clamp(pair(torch.minimum, 3) - pair(torch.maximum, 1),
                     min=0.0)
    inter = iw * ih
    del iw, ih
    area_a = torch.clamp((a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1]),
                         min=0.0)
    area_b = torch.clamp((b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1]),
                         min=0.0)
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / union, 0.0)


def _center_to_corner(b):
    xy, wh = b[..., :2], b[..., 2:]
    return torch.cat([xy - wh / 2, xy + wh / 2], -1)


@register("_contrib_box_iou", nin=2, params={"format": "corner"})
def _box_iou(params, lhs, rhs):
    """Reference bounding_box.cc box_iou ("corner" or "center")."""
    if params["format"] == "center":
        lhs, rhs = _center_to_corner(lhs), _center_to_corner(rhs)
    return box_iou_xyxy(lhs, rhs)


def _last_wins(index, values, n, fill):
    """out[b, index[b, m]] = values[b, m] for m in order, into a (B, n)
    array of `fill`: where several m pick one slot, the last of them
    wins (the JAX op's scatter).  In a fixed number of launches, the same
    on every device (`index_put_` leaves duplicates undefined on CUDA)."""
    m = index.shape[1]
    hit = index[:, :, None] == torch.arange(n, device=index.device)
    rows = torch.arange(m, device=index.device)[None, :, None]
    last = torch.where(hit, rows, -1).amax(dim=1)             # (B, n)
    got = torch.gather(values, 1, last.clamp(min=0))
    return torch.where(last >= 0, got, torch.full_like(got, fill))


@register("_contrib_MultiBoxTarget", aliases=("MultiBoxTarget",), nin=3,
          nout=3,
          params={"overlap_threshold": 0.5, "ignore_label": -1.0,
                  "negative_mining_ratio": -1.0, "negative_mining_thresh": 0.5,
                  "minimum_negative_samples": 0,
                  "variances": (0.1, 0.1, 0.2, 0.2)})
def _multibox_target(params, anchors, labels, cls_preds):
    """Anchor matching and target encoding, as the JAX op (reference
    multibox_target-inl.h).  anchors (1, N, 4); labels (B, M, 5) rows
    [cls, x1, y1, x2, y2], -1 padded; cls_preds (B, C+1, N), read for
    nothing.  An anchor is positive when its best IoU reaches the
    threshold or a label row claims it as its best anchor; every other
    anchor is background (class 0): like the JAX op, no hard-negative
    mining and no ignore label.  Returns loc_target (B, N*4), loc_mask
    (B, N*4), cls_target (B, N), none with a gradient."""
    var = _parse_floats(params["variances"], [0.1, 0.1, 0.2, 0.2])
    thresh = float(params["overlap_threshold"])
    anc = anchors[0].detach()                                 # (N, 4)
    labels = labels.detach()
    n = anc.shape[0]
    valid = labels[:, :, 0] >= 0                              # (B, M)
    gt = labels[:, :, 1:5]
    ious = box_iou_xyxy(anc[None], gt)                        # (B, N, M)
    ious = torch.where(valid[:, None, :], ious, -1.0)
    best_iou = ious.amax(dim=2)
    best_gt = torch.argmax(ious, dim=2)                       # the first
    matched = best_iou >= thresh
    best_anchor = torch.argmax(ious, dim=1)                   # (B, M)
    forced = _last_wins(best_anchor, valid, n, False)
    forced_gt = _last_wins(best_anchor, torch.arange(
        labels.shape[1], device=labels.device).expand_as(best_anchor), n, 0)
    gt_idx = torch.where(forced, forced_gt, best_gt)
    pos = matched | forced

    m_gt = torch.gather(gt, 1, gt_idx[:, :, None].expand(-1, -1, 4))
    acx = (anc[:, 0] + anc[:, 2]) / 2
    acy = (anc[:, 1] + anc[:, 3]) / 2
    aw = torch.clamp(anc[:, 2] - anc[:, 0], min=1e-8)
    ah = torch.clamp(anc[:, 3] - anc[:, 1], min=1e-8)
    gcx = (m_gt[..., 0] + m_gt[..., 2]) / 2
    gcy = (m_gt[..., 1] + m_gt[..., 3]) / 2
    gw = torch.clamp(m_gt[..., 2] - m_gt[..., 0], min=1e-8)
    gh = torch.clamp(m_gt[..., 3] - m_gt[..., 1], min=1e-8)
    # divide by tensors: a scalar divisor becomes a product with its
    # reciprocal on CUDA, an ulp from the CPU's quotient
    v = torch.tensor(var, dtype=anc.dtype, device=anc.device)
    loc = torch.stack([(gcx - acx) / aw / v[0], (gcy - acy) / ah / v[1],
                       torch.log(gw / aw) / v[2],
                       torch.log(gh / ah) / v[3]], dim=-1)    # (B, N, 4)
    mask = pos[:, :, None].to(anc.dtype).expand(-1, -1, 4)
    cls_lab = torch.gather(labels[:, :, 0], 1, gt_idx)
    cls_t = torch.where(pos, cls_lab + 1, 0.0)
    b = labels.shape[0]
    return (loc * mask).reshape(b, -1), mask.reshape(b, -1), \
        cls_t.to(labels.dtype)


def greedy_nms(sup, valid):
    """Greedy suppression over boxes sorted by score: box i is kept when
    it is valid and no kept box j < i has sup[j, i].  sup (B, N, N) bool,
    valid (B, N) bool; returns kept (B, N) bool.

    The JAX ops run the recursion box by box (N steps).  Here it is
    iterated whole: alive <- valid & ~any_{j<i}(sup[j, i] & alive[j]),
    from alive = valid, until it stops changing; each round is one
    batched product.  Exact: after round r every box i < r is right (it
    depends on boxes before it only), so the rounds end within N + 1; and
    a fixed point satisfies the greedy recursion, whose solution is
    unique.  Rounds take as many as the longest chain of boxes whose
    fate hangs on the one before; a handful on SSD's outputs.  The
    product counts suppressors in fp32 (0/1 entries, exact), so a count
    is > 0 exactly when one exists.  On ``meta`` tensors (shape
    inference) it returns valid's shape without running."""
    if valid.device.type == "meta":
        return torch.empty_like(valid)
    n = valid.shape[-1]
    upper = torch.ones(n, n, dtype=torch.bool, device=sup.device).triu(1)
    s = (sup & upper).to(torch.float32)
    alive = valid
    rounds = 0
    while True:
        rounds += 1
        hit = torch.bmm(alive.to(torch.float32)[:, None, :], s)[:, 0] > 0
        nxt = valid & ~hit
        if torch.equal(nxt, alive):
            break
        alive = nxt
    greedy_nms.rounds = rounds
    return alive


greedy_nms.rounds = 0      # rounds of the last call (phase 13d prints it)


def detection_candidates(params, cls_prob, loc_pred, anchors):
    """`MultiBoxDetection` before its suppression: the decoded boxes
    sorted by score (stable), their scores (0 below ``threshold``) and
    class ids, and sup[b, j, i] = IoU(j, i) > nms_threshold among boxes
    of one class (or all with ``force_suppress``): (boxes (B, N, 4),
    score (B, N), cls (B, N), sup (B, N, N) bool)."""
    var = _parse_floats(params["variances"], [0.1, 0.1, 0.2, 0.2])
    b, _, n = cls_prob.shape
    anc = anchors[0].detach()
    acx = (anc[:, 0] + anc[:, 2]) / 2
    acy = (anc[:, 1] + anc[:, 3]) / 2
    aw = anc[:, 2] - anc[:, 0]
    ah = anc[:, 3] - anc[:, 1]
    loc = loc_pred.detach().reshape(b, n, 4)
    cx = loc[..., 0] * var[0] * aw + acx
    cy = loc[..., 1] * var[1] * ah + acy
    w = torch.exp(loc[..., 2] * var[2]) * aw
    h = torch.exp(loc[..., 3] * var[3]) * ah
    boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    if params["clip"]:
        boxes = torch.clamp(boxes, 0.0, 1.0)
    probs = cls_prob.detach()[:, 1:]
    score = probs.amax(dim=1)
    cls_id = torch.argmax(probs, dim=1).to(torch.float32)   # the first
    score = torch.where(score > float(params["threshold"]), score, 0.0)
    order = torch.argsort(-score, dim=1, stable=True)
    boxes_o = torch.gather(boxes, 1, order[:, :, None].expand(-1, -1, 4))
    score_o = torch.gather(score, 1, order)
    cls_o = torch.gather(cls_id, 1, order)
    sup = box_iou_xyxy(boxes_o, boxes_o) > float(params["nms_threshold"])
    if not params["force_suppress"]:
        sup &= cls_o[:, :, None] == cls_o[:, None, :]
    return boxes_o, score_o, cls_o, sup


@register("_contrib_MultiBoxDetection", aliases=("MultiBoxDetection",),
          nin=3,
          params={"clip": True, "threshold": 0.01, "background_id": 0,
                  "nms_threshold": 0.5, "force_suppress": False,
                  "variances": (0.1, 0.1, 0.2, 0.2), "nms_topk": -1})
def _multibox_detection(params, cls_prob, loc_pred, anchors):
    """Decode and NMS, as the JAX op (reference
    multibox_detection-inl.h; ``background_id`` and ``nms_topk`` read
    for nothing, as there).  cls_prob (B, C+1, N), loc_pred (B, N*4),
    anchors (1, N, 4).  Output (B, N, 6) rows [cls_id, score, x1, y1,
    x2, y2] sorted by score, suppressed or sub-threshold rows with class
    -1 and score 0.  No gradient."""
    b, _, n = cls_prob.shape
    if cls_prob.device.type == "meta":
        return torch.empty((b, n, 6), dtype=cls_prob.dtype, device="meta")
    boxes_o, score_o, cls_o, sup = detection_candidates(
        params, cls_prob, loc_pred, anchors)
    alive = greedy_nms(sup, score_o > 0)
    out_cls = torch.where(alive, cls_o, -1.0)
    out_score = torch.where(alive, score_o, 0.0)
    return torch.cat([out_cls[..., None].to(boxes_o.dtype),
                      out_score[..., None], boxes_o], dim=-1)


@register("_contrib_box_nms",
          aliases=("_contrib_box_non_maximum_suppression",),
          params={"overlap_thresh": 0.5, "valid_thresh": 0.0, "topk": -1,
                  "coord_start": 2, "score_index": 1, "id_index": -1,
                  "background_id": -1, "force_suppress": False,
                  "in_format": "corner", "out_format": "corner"})
def _box_nms(params, data):
    """Reference bounding_box.cc box_nms, as the JAX op: the rows of
    each (N, K) batch sorted by score (rows at or below ``valid_thresh``
    last), suppressed and invalid rows set to -1.  With ``id_index`` and
    without ``force_suppress`` only rows of one id suppress each other.
    No gradient."""
    cs = int(params["coord_start"])
    si = int(params["score_index"])
    ii = int(params["id_index"])
    thresh = float(params["overlap_thresh"])
    valid_thresh = float(params["valid_thresh"])
    if data.device.type == "meta":
        return torch.empty_like(data)
    data = data.detach()
    flat = data.reshape((-1,) + tuple(data.shape[-2:]))     # (B, N, K)
    score = flat[:, :, si]
    valid = score > valid_thresh
    order = torch.argsort(-torch.where(valid, score, -torch.inf), dim=1,
                          stable=True)
    rows_o = torch.gather(flat, 1, order[:, :, None].expand_as(flat))
    valid_o = torch.gather(valid, 1, order)
    boxes_o = rows_o[:, :, cs:cs + 4]
    if params["in_format"] == "center":
        boxes_o = _center_to_corner(boxes_o)
    sup = box_iou_xyxy(boxes_o, boxes_o) > thresh
    if ii >= 0 and not params["force_suppress"]:
        ids = rows_o[:, :, ii]
        sup &= ids[:, :, None] == ids[:, None, :]
    alive = greedy_nms(sup, valid_o)
    out = torch.where(alive[:, :, None], rows_o, -torch.ones_like(rows_o))
    return out.reshape(data.shape)


def _pooled(ps):
    return (ps, ps) if isinstance(ps, int) else tuple(ps)


@register("ROIPooling", nin=2,
          params={"pooled_size": REQUIRED, "spatial_scale": REQUIRED})
def _roi_pooling(params, data, rois):
    """Reference `roi_pooling.cc`, as the JAX op: the max over each bin
    of a (ph, pw) grid on the rounded ROI, 0 for an empty bin.  rois
    (R, 5) rows [batch_idx, x1, y1, x2, y2]; output (R, C, ph, pw).  The
    gradient of a maximum tied within a bin is shared equally (as
    `jnp.max`'s)."""
    ph, pw = _pooled(params["pooled_size"])
    scale = float(params["spatial_scale"])
    _, _, hgt, wid = data.shape
    rois = rois.detach()
    bidx = rois[:, 0].to(torch.int64)
    x1 = torch.round(rois[:, 1] * scale)
    y1 = torch.round(rois[:, 2] * scale)
    x2 = torch.round(rois[:, 3] * scale)
    y2 = torch.round(rois[:, 4] * scale)
    bin_w = true_div(torch.clamp(x2 - x1 + 1, min=1.0), pw)
    bin_h = true_div(torch.clamp(y2 - y1 + 1, min=1.0), ph)
    f32 = dict(dtype=torch.float32, device=data.device)
    ys, xs = torch.arange(hgt, **f32), torch.arange(wid, **f32)
    iy, ix = torch.arange(ph, **f32), torch.arange(pw, **f32)

    def span(lo, size, i, grid):
        start = lo[:, None] + i[None] * size[:, None]          # (R, P)
        stop = lo[:, None] + (i[None] + 1) * size[:, None]
        return (grid >= torch.floor(start)[..., None]) & \
            (grid < torch.ceil(stop)[..., None])               # (R, P, S)

    ymask, xmask = span(y1, bin_h, iy, ys), span(x1, bin_w, ix, xs)
    mask = ymask[:, :, None, :, None] & xmask[:, None, :, None, :]
    img = data[bidx]                                           # (R,C,H,W)
    masked = torch.where(mask[:, None], img[:, :, None, None],
                         -torch.inf)
    out = masked.amax(dim=(-1, -2))
    return torch.where(mask.any(dim=(-1, -2))[:, None], out, 0.0)


@register("_contrib_ROIAlign", nin=2,
          params={"pooled_size": REQUIRED, "spatial_scale": REQUIRED,
                  "sample_ratio": -1, "position_sensitive": False})
def _roi_align(params, data, rois):
    """Reference `contrib/roi_align.cc`, as the JAX op: one bilinear
    sample at the centre of each of the (ph, pw) bins (``sample_ratio``
    and ``position_sensitive`` read for nothing).  Output (R, C, ph,
    pw)."""
    ph, pw = _pooled(params["pooled_size"])
    scale = float(params["spatial_scale"])
    _, c, hgt, wid = data.shape
    rois = rois.detach()
    bidx = rois[:, 0].to(torch.int64)
    x1, y1 = rois[:, 1] * scale, rois[:, 2] * scale
    rw = torch.clamp(rois[:, 3] * scale - x1, min=1.0)
    rh = torch.clamp(rois[:, 4] * scale - y1, min=1.0)
    f32 = dict(dtype=torch.float32, device=data.device)
    y = true_div((torch.arange(ph, **f32)[None] + 0.5) * rh[:, None], ph) \
        + y1[:, None]
    x = true_div((torch.arange(pw, **f32)[None] + 0.5) * rw[:, None], pw) \
        + x1[:, None]
    y, x = y[:, :, None].expand(-1, ph, pw), x[:, None, :].expand(-1, ph, pw)
    y0 = torch.clamp(torch.floor(y), 0, hgt - 1)
    x0 = torch.clamp(torch.floor(x), 0, wid - 1)
    y1_ = torch.clamp(y0 + 1, 0, hgt - 1)
    x1_ = torch.clamp(x0 + 1, 0, wid - 1)
    wy, wx = y - y0, x - x0
    img = data[bidx].reshape(len(bidx), c, hgt * wid)

    def at(yi, xi):
        flat = (yi.to(torch.int64) * wid + xi.to(torch.int64)).reshape(
            len(bidx), 1, -1).expand(-1, c, -1)
        return torch.gather(img, 2, flat).reshape(len(bidx), c, ph, pw)

    wy, wx = wy[:, None], wx[:, None]
    return (at(y0, x0) * (1 - wy) * (1 - wx) +
            at(y1_, x0) * wy * (1 - wx) +
            at(y0, x1_) * (1 - wy) * wx +
            at(y1_, x1_) * wy * wx)


@register("_contrib_bipartite_matching", nout=2,
          params={"is_ascend": False, "threshold": REQUIRED, "topk": -1})
def _bipartite_matching(params, dist):
    """Greedy bipartite matching (reference bounding_box.cc), as the JAX
    op: min(n, m) rounds, each matching the best remaining pair (the
    first maximum) while it beats the threshold.  (B, n, m) or (n, m)
    -> row matches (.., n) and column matches (.., m), -1 unmatched."""
    thresh = float(params["threshold"])
    asc = bool(params["is_ascend"])
    batched = dist.dim() == 3
    d = dist.detach() if batched else dist.detach()[None]
    b, n, m = d.shape
    if d.device.type == "meta":
        rm = torch.empty((b, n), device="meta")
        cm = torch.empty((b, m), device="meta")
        return (rm, cm) if batched else (rm[0], cm[0])
    s = (-d if asc else d).clone()
    rm = -torch.ones((b, n), dtype=torch.float32, device=d.device)
    cm = -torch.ones((b, m), dtype=torch.float32, device=d.device)
    rows = torch.arange(b, device=d.device)
    bound = -thresh if asc else thresh
    for _ in range(min(n, m)):
        idx = torch.argmax(s.reshape(b, -1), dim=1)
        i, j = idx // m, idx % m
        ok = s[rows, i, j] > bound
        rm[rows, i] = torch.where(ok, j.to(torch.float32), rm[rows, i])
        cm[rows, j] = torch.where(ok, i.to(torch.float32), cm[rows, j])
        s[rows, i, :] = -torch.inf
        s[rows, :, j] = -torch.inf
        s = torch.where(ok[:, None, None], s, -torch.inf)
    return (rm, cm) if batched else (rm[0], cm[0])
