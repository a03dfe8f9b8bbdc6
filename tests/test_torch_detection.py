"""The detection slice's ops in the PyTorch port against the JAX package,
on the CPU: `ops/detection.py` (MultiBoxPrior, MultiBoxTarget,
MultiBoxDetection, box_iou, box_nms, ROIPooling, ROIAlign,
bipartite_matching), the loss heads of `ops/loss_output.py` (MakeLoss,
the regression outputs, SVMOutput, IdentityAttachKLSparseReg, and
SoftmaxOutput as the SSD runs it), `ops/elemwise.py`'s smooth_l1 and the
other ops the port lacked, `ops/spatial.py` and the two deformable ops.

Each op runs through both registries (`OpDef.fn(params, *tensors)`) on
the same float32 numpy inputs from a seed; a gradient is held to
`jax.vjp` of the JAX op with one random cotangent.  Tolerances: rtol
1e-5 + 1e-6 * max|ref| (float32 sums in other orders; the special
functions erfinv, gamma and gammaln are other implementations, rtol 1e-5
+ 1e-6 * max|ref| too).  The discrete outputs are held exactly: anchor
matches, class targets, masks, the kept rows of NMS, matchings.  An
anchor or pair whose IoU lies within 1e-6 of a threshold, or of the
runner-up, is a near tie that rounding may tip either way; each test
counts them and requires none in its data, so equality is exact.

The NMS route (`detection.greedy_nms`, a fixed-point iteration) is held
bitwise to the literal per-box loop of the JAX ops (`nms_loop` below) on
adversarial chains, ties, all-suppressed rows and random matrices.
"""
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu.ops import registry as jreg

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch.ops import registry as treg
from incubator_mxnet_tpu_torch.ops.detection import greedy_nms

RTOL, ATOL = 1e-5, 1e-6
NEAR = 1e-6


def _close(got, want, what="", tol=(RTOL, ATOL)):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want,
                               rtol=tol[0],
                               atol=tol[1] * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _rand(*shape, seed=0, scale=1.0):
    return (scale * np.random.RandomState(seed).normal(0, 1, shape)).astype(
        np.float32)


def _fwd_both(op, params, inputs):
    """Outputs of `op` in both packages on numpy `inputs` (tuples)."""
    jop, top = jreg.get(op), treg.get(op)
    jout = jop.fn(jop.canonicalize_params(params),
                  *(jnp.asarray(a) for a in inputs))
    with torch.no_grad():
        tout = top.fn(top.canonicalize_params(params),
                      *(torch.from_numpy(a.copy()) for a in inputs))
    as_t = (lambda o: tuple(o) if isinstance(o, (tuple, list)) else (o,))
    return ([np.asarray(o.detach()) for o in as_t(tout)],
            [np.asarray(o) for o in as_t(jout)])


def _vjp_both(op, params, inputs, grad_inputs, seed=0):
    """The first output of `op` and its gradients with respect to
    `grad_inputs` (indices) in both packages, one random cotangent."""
    jop, top = jreg.get(op), treg.get(op)
    jp, tp = jop.canonicalize_params(params), top.canonicalize_params(params)

    def first(o):
        return o[0] if isinstance(o, (tuple, list)) else o

    def jf(*diff):
        xs = [jnp.asarray(a) for a in inputs]
        for i, d in zip(grad_inputs, diff):
            xs[i] = d
        return first(jop.fn(jp, *xs))

    jout, vjp = jax.vjp(jf, *(jnp.asarray(inputs[i]) for i in grad_inputs))
    ct = _rand(*jout.shape, seed=seed + 100)
    jgrads = vjp(jnp.asarray(ct, jout.dtype))
    xs = [torch.from_numpy(a.copy()) for a in inputs]
    for i in grad_inputs:
        xs[i].requires_grad_()
    tout = first(top.fn(tp, *xs))
    tgrads = torch.autograd.grad(tout, [xs[i] for i in grad_inputs],
                                 torch.from_numpy(ct), allow_unused=True)
    tgrads = [torch.zeros_like(xs[i]) if g is None else g
              for i, g in zip(grad_inputs, tgrads)]
    return ((tout.detach().numpy(), [g.numpy() for g in tgrads]),
            (np.asarray(jout), [np.asarray(g) for g in jgrads]))


def _check_grad(op, params, inputs, grad_inputs, tol=(RTOL, ATOL)):
    (tout, tg), (jout, jg) = _vjp_both(op, params, inputs, grad_inputs)
    assert tout.shape == jout.shape
    _close(tout, jout, f"{op} forward", tol)
    for i, a, b in zip(grad_inputs, tg, jg):
        assert a.shape == b.shape
        _close(a, b, f"{op} gradient of input {i}", tol)


def nms_loop(sup, valid):
    """The JAX ops' greedy suppression, box by box (their `fori_loop`
    body): the plain version `greedy_nms` is held to."""
    n = valid.shape[-1]
    alive = valid.clone()
    later = torch.arange(n, device=valid.device)
    for i in range(n):
        row = sup[:, i] & alive[:, i:i + 1] & (later > i)
        alive = alive & ~row
    return alive


# ---------------------------------------------------------------------------
# elemwise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op,lo,hi", [
    ("cbrt", -8.0, 8.0), ("rcbrt", 0.1, 8.0), ("degrees", -4.0, 4.0),
    ("radians", -400.0, 400.0), ("erfinv", -0.99, 0.99),
    ("gamma", -3.7, 5.5), ("gammaln", 0.1, 9.0),
])
def test_unary_ops_match_jax(op, lo, hi):
    """The unary ops the port lacked, on values inside their domains
    (gamma's away from its poles)."""
    x = np.random.RandomState(0).uniform(lo, hi, (7, 9)).astype(np.float32)
    if op == "gamma":
        x = np.where(np.abs(x - np.round(x)) < 0.05, x + 0.3, x)
    (t,), (j,) = _fwd_both(op, {}, [x])
    _close(t, j, op)


@pytest.mark.parametrize("op,scalar", [
    ("_hypot_scalar", 2.5), ("_logical_xor_scalar", 1.0),
    ("_logical_xor_scalar", 0.0)])
def test_scalar_ops_match_jax(op, scalar):
    x = np.round(_rand(5, 6), 0)
    (t,), (j,) = _fwd_both(op, {"scalar": scalar}, [x])
    assert t.dtype == j.dtype
    _close(t, j, op)


@pytest.mark.parametrize("scalar", [1.0, 2.0, 0.5])
def test_smooth_l1_and_its_gradient(scalar):
    """The SSD's box loss before MakeLoss: both branches of smooth_l1 and
    the gradient of each."""
    _check_grad("smooth_l1", {"scalar": scalar}, [_rand(6, 40)], [0])


# ---------------------------------------------------------------------------
# loss heads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("params", [
    {}, {"grad_scale": 2.0, "normalization": "batch"},
    {"grad_scale": 1.0, "normalization": "valid"},
    {"grad_scale": 0.5, "normalization": "valid", "valid_thresh": 0.3}])
def test_make_loss_gradient_ignores_the_cotangent(params):
    """MakeLoss: the identity forward; the gradient is grad_scale over
    the batch or over the count of elements above valid_thresh, whatever
    the cotangent (the JAX custom VJP)."""
    x = np.abs(_rand(4, 30))
    x[:, ::3] = 0.0                         # not valid under thresh 0
    _check_grad("MakeLoss", params, [x], [0])


@pytest.mark.parametrize("op", ["LinearRegressionOutput",
                                "LogisticRegressionOutput",
                                "MAERegressionOutput"])
def test_regression_outputs(op):
    _check_grad(op, {"grad_scale": 1.5}, [_rand(5, 3), _rand(5, 3, seed=1)],
                [0, 1])


@pytest.mark.parametrize("linear", [False, True])
def test_svm_output(linear):
    label = np.random.RandomState(2).randint(0, 6, (8,)).astype(np.float32)
    _check_grad("SVMOutput", {"margin": 1.5, "use_linear": linear,
                              "regularization_coefficient": 0.7},
                [_rand(8, 6), label], [0, 1])


def test_identity_attach_kl_sparse_reg():
    _check_grad("IdentityAttachKLSparseReg", {"penalty": 0.01},
                [_rand(3, 7)], [0])


def test_softmax_output_as_the_ssd_runs_it():
    """SoftmaxOutput with multi_output, use_ignore (-1) and "valid"
    normalization on (B, C+1, N) data and (B, N) labels: softmax over
    axis 1; the gradient (p - onehot) over the count of labels not -1,
    zero at ignored anchors."""
    rng = np.random.RandomState(3)
    label = rng.randint(-1, 4, (3, 50)).astype(np.float32)
    _check_grad("SoftmaxOutput",
                {"multi_output": True, "use_ignore": True,
                 "ignore_label": -1, "normalization": "valid"},
                [_rand(3, 4, 50), label], [0])


# ---------------------------------------------------------------------------
# detection
# ---------------------------------------------------------------------------

PRIORS = [
    {"sizes": (0.1, 0.14), "ratios": (1.0, 2.0, 0.5), "clip": True},
    {"sizes": (0.27,), "ratios": (1.0,)},
    {"sizes": (0.5, 0.7, 0.9), "ratios": (1.0, 3.0), "steps": (0.2, 0.1),
     "offsets": (0.25, 0.75)},
]


@pytest.mark.parametrize("params", PRIORS)
@pytest.mark.parametrize("hw", [(8, 8), (3, 5)])
def test_multibox_prior(params, hw):
    """Anchors depend on the map's shape only: (1, H*W*A, 4), within 1
    ulp of the largest coordinate of the JAX op's (which computes the
    centres in float64 under the tests' x64 and rounds once)."""
    x = _rand(2, 3, *hw)
    (t,), (j,) = _fwd_both("MultiBoxPrior", params, [x])
    assert t.shape == j.shape
    np.testing.assert_allclose(t, j, rtol=0,
                               atol=np.spacing(np.abs(j).max()))


def _anchors(maps=((8, 8), (4, 4), (2, 2))):
    out = []
    for i, hw in enumerate(maps):
        (a,), _ = _fwd_both("MultiBoxPrior", PRIORS[0], [_rand(1, 1, *hw)])
        out.append(a)
    return np.concatenate(out, axis=1)


def _labels(b, m, seed=0, pad=True):
    rng = np.random.RandomState(seed)
    lab = np.full((b, m, 5), -1.0, np.float32)
    for i in range(b):
        for k in range(rng.randint(1, m + 1) if pad else m):
            w, h = rng.uniform(0.1, 0.6, 2)
            x1, y1 = rng.uniform(0, 1 - w), rng.uniform(0, 1 - h)
            lab[i, k] = [rng.randint(0, 3), x1, y1, x1 + w, y1 + h]
    return lab


def _target_near_ties(anchors, labels, thresh):
    """Anchors whose best IoU lies within NEAR of the threshold, or
    above a runner-up by less than NEAR (an exact tie goes to the first
    in both packages), and label rows whose best anchor does (by the
    JAX op's IoU)."""
    from incubator_mxnet_tpu.ops.detection import _box_iou_xyxy
    n = 0
    for lab in labels:
        ious = np.asarray(_box_iou_xyxy(jnp.asarray(anchors[0]),
                                        jnp.asarray(lab[:, 1:5])))
        ious = np.where(lab[None, :, 0] >= 0, ious, -1.0)
        best = ious.max(1)
        n += int((np.abs(best - thresh) < NEAR).sum())
        for axis in (0, 1):
            s = np.sort(ious, axis=axis)
            if s.shape[axis] > 1:
                gap = np.take(s, -1, axis) - np.take(s, -2, axis)
                n += int(((gap > 0) & (gap < NEAR)).sum())
    return n


@pytest.mark.parametrize("thresh,seed", [(0.5, 0), (0.3, 1), (0.7, 2)])
def test_multibox_target(thresh, seed):
    """Matching and encoding on the SSD's multi-scale anchors, padded
    labels: class targets and masks equal, loc targets within
    tolerance."""
    anchors = _anchors()
    labels = _labels(4, 3, seed=seed)
    cls_preds = _rand(4, 4, anchors.shape[1], seed=seed)
    assert _target_near_ties(anchors, labels, thresh) == 0
    params = {"overlap_threshold": thresh, "negative_mining_ratio": 3,
              "variances": (0.1, 0.1, 0.2, 0.2)}
    (tl, tm, tc), (jl, jm, jc) = _fwd_both(
        "MultiBoxTarget", params, [anchors, labels, cls_preds])
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(tm, jm)
    _close(tl, jl, "loc_target")
    assert (tc > 0).any() and (tc == 0).any()


def test_multibox_target_padded_rows_unforce_anchor_zero():
    """A padded label row (all -1) has every IoU -1, so its best anchor
    is anchor 0; the JAX op's force-match scatter applies the rows in
    order, last wins, and a padded row after a valid one resets anchor
    0's forced flag.  The port reproduces that: with the valid box
    claiming anchor 0 first, anchor 0 stays background; with the valid
    box last, it is forced positive."""
    anchors = _anchors(((4, 4),))
    a0 = anchors[0, 0]                 # its best anchor, at IoU 0.83
    box = [1.0, a0[0] - 0.005, a0[1] - 0.005, a0[2] + 0.005, a0[3] + 0.005]
    pad = [-1.0] * 5
    for rows, forced in (([box, pad, pad], False), ([pad, pad, box], True)):
        labels = np.asarray([rows], np.float32)
        (tl, tm, tc), (jl, jm, jc) = _fwd_both(
            "MultiBoxTarget", {"overlap_threshold": 0.95},
            [anchors, labels, _rand(1, 3, anchors.shape[1])])
        np.testing.assert_array_equal(tc, jc)
        np.testing.assert_array_equal(tm, jm)
        _close(tl, jl, "loc_target")
        assert tc[0, 0] == (2.0 if forced else 0.0)


def test_multibox_target_gives_no_gradient():
    """No output of MultiBoxTarget reaches cls_preds, the anchors or the
    labels (the executor takes the missing gradient as zeros)."""
    anchors = _anchors(((4, 4),))
    xs = [torch.from_numpy(a).requires_grad_() for a in
          (anchors, _labels(2, 3), _rand(2, 4, anchors.shape[1]))]
    op = treg.get("MultiBoxTarget")
    outs = op.fn(op.canonicalize_params({}), *xs)
    assert not any(o.requires_grad for o in outs)


def _detection_inputs(b, n_maps, seed, classes=3):
    anchors = _anchors(n_maps)
    n = anchors.shape[1]
    logits = _rand(b, classes + 1, n, seed=seed, scale=2.0)
    prob = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    loc = _rand(b, n * 4, seed=seed + 1, scale=0.5)
    return [prob.astype(np.float32), loc, anchors]


def _nms_near_ties(det, thresh):
    """Pairs of same-class kept-or-not boxes whose IoU lies within NEAR
    of the NMS threshold, and equal nonzero scores, in the JAX output."""
    from incubator_mxnet_tpu.ops.detection import _box_iou_xyxy
    n = 0
    for rows in det:
        ious = np.asarray(_box_iou_xyxy(jnp.asarray(rows[:, 2:]),
                                        jnp.asarray(rows[:, 2:])))
        n += int((np.abs(ious - thresh) < NEAR).sum())
        s = rows[:, 1][rows[:, 1] > 0]
        n += int((np.diff(np.sort(s)) == 0).sum())
    return n


@pytest.mark.parametrize("params", [
    {"nms_threshold": 0.45, "variances": (0.1, 0.1, 0.2, 0.2)},
    {"nms_threshold": 0.3, "force_suppress": True},
    {"nms_threshold": 0.6, "threshold": 0.3, "clip": False},
])
@pytest.mark.parametrize("seed", [0, 1])
def test_multibox_detection(params, seed):
    """Decode and NMS over the SSD's anchors, the rows equal to the JAX
    op's: classes, scores and which rows are kept exactly, boxes within
    tolerance (exp and products in other orders)."""
    inputs = _detection_inputs(3, ((8, 8), (4, 4), (2, 2)), seed)
    (t,), (j,) = _fwd_both("MultiBoxDetection", params, inputs)
    assert t.shape == j.shape == (3, inputs[2].shape[1], 6)
    # the JAX op's boxes without suppression, to count near ties
    assert _nms_near_ties(j, params["nms_threshold"]) == 0
    np.testing.assert_array_equal(t[..., :2], j[..., :2])
    _close(t[..., 2:], j[..., 2:], "boxes")
    assert (t[..., 0] >= 0).sum() > 0 and (t[..., 0] < 0).sum() > 0


@pytest.mark.parametrize("params", [
    {},
    {"overlap_thresh": 0.3, "id_index": 0, "score_index": 1,
     "coord_start": 2},
    {"overlap_thresh": 0.3, "id_index": 0, "force_suppress": True},
    {"overlap_thresh": 0.4, "valid_thresh": 0.5, "in_format": "center"},
])
def test_box_nms(params):
    """box_nms on (2, 3, 40, 6) rows [id, score, x1, y1, x2, y2] (or
    centre boxes): suppressed and invalid rows -1, the rest sorted by
    score, equal to the JAX op's."""
    rng = np.random.RandomState(5)
    rows = np.zeros((2, 3, 40, 6), np.float32)
    rows[..., 0] = rng.randint(0, 3, (2, 3, 40))
    rows[..., 1] = rng.uniform(0, 1, (2, 3, 40))
    xy = rng.uniform(0, 0.7, (2, 3, 40, 2))
    wh = rng.uniform(0.1, 0.3, (2, 3, 40, 2))
    if params.get("in_format") == "center":
        rows[..., 2:4], rows[..., 4:6] = xy + wh / 2, wh
    else:
        rows[..., 2:4], rows[..., 4:6] = xy, xy + wh
    (t,), (j,) = _fwd_both("_contrib_box_nms", params, [rows])
    assert t.shape == rows.shape
    np.testing.assert_array_equal(t, j)
    assert (t[..., 1] == -1).any() and (t[..., 1] >= 0).any()


@pytest.mark.parametrize("fmt", ["corner", "center"])
def test_box_iou(fmt):
    rng = np.random.RandomState(6)
    a = rng.uniform(0.1, 0.6, (2, 7, 4)).astype(np.float32)
    b = rng.uniform(0.1, 0.6, (2, 5, 4)).astype(np.float32)
    if fmt == "corner":
        a[..., 2:] += a[..., :2]
        b[..., 2:] += b[..., :2]
    (t,), (j,) = _fwd_both("_contrib_box_iou", {"format": fmt}, [a, b])
    assert t.shape == j.shape == (2, 7, 5)
    _close(t, j, "box_iou")


@pytest.mark.parametrize("case", ["chain", "all", "none", "ties", "dense",
                                  "sparse", "invalid", "long_chain"])
def test_greedy_nms_equals_the_per_box_loop(case):
    """`greedy_nms` (the route MultiBoxDetection and box_nms take) is
    bitwise the per-box loop: a chain where each box suppresses only the
    next (alternate boxes kept, N/2 rounds), everything suppressing
    everything, nothing, tied boxes (symmetric suppression), dense and
    sparse random matrices, rows with no valid box, and a chain of 300
    (the worst case: rounds grow with its length)."""
    rng = np.random.RandomState(7)
    n = 300 if case == "long_chain" else 64
    b = 3
    valid = torch.ones(b, n, dtype=torch.bool)
    if case in ("chain", "long_chain"):
        sup = torch.zeros(b, n, n, dtype=torch.bool)
        idx = torch.arange(n - 1)
        sup[:, idx, idx + 1] = True
    elif case == "all":
        sup = torch.ones(b, n, n, dtype=torch.bool)
    elif case == "none":
        sup = torch.zeros(b, n, n, dtype=torch.bool)
    elif case == "ties":
        groups = torch.from_numpy(rng.randint(0, 5, (b, n)))
        sup = groups[:, :, None] == groups[:, None, :]
    else:
        p = {"dense": 0.6, "sparse": 0.05, "invalid": 0.3}[case]
        sup = torch.from_numpy(rng.uniform(0, 1, (b, n, n)) < p)
        valid = torch.from_numpy(rng.uniform(0, 1, (b, n)) < 0.7)
        if case == "invalid":
            valid[1] = False
    got = greedy_nms(sup, valid)
    want = nms_loop(sup, valid)
    assert torch.equal(got, want)
    if case in ("chain", "long_chain"):
        assert torch.equal(got[0], torch.arange(n) % 2 == 0)
        assert greedy_nms.rounds >= n // 2
    if case == "all":
        assert got.sum().item() == b
    if case == "invalid":
        assert not got[1].any()


def test_nms_ops_give_shapes_on_meta_tensors():
    """Shape inference runs the ops on meta tensors: the NMS ops and
    bipartite matching answer with their shapes and read nothing."""
    m = lambda *s: torch.empty(s, device="meta")   # noqa: E731
    for name, params, ins, shapes in [
            ("MultiBoxDetection", {}, [m(2, 4, 30), m(2, 120), m(1, 30, 4)],
             [(2, 30, 6)]),
            ("_contrib_box_nms", {}, [m(2, 30, 6)], [(2, 30, 6)]),
            ("_contrib_bipartite_matching", {"threshold": 0.1},
             [m(2, 5, 7)], [(2, 5), (2, 7)])]:
        op = treg.get(name)
        out = op.fn(op.canonicalize_params(params), *ins)
        out = out if isinstance(out, tuple) else (out,)
        assert [tuple(o.shape) for o in out] == shapes
        assert all(o.device.type == "meta" for o in out)


def _rois(r, b, h, w, seed=8, scale=1.0):
    rng = np.random.RandomState(seed)
    out = np.zeros((r, 5), np.float32)
    out[:, 0] = rng.randint(0, b, r)
    x1 = rng.uniform(0, w * 0.6, r)
    y1 = rng.uniform(0, h * 0.6, r)
    out[:, 1], out[:, 2] = x1, y1
    out[:, 3] = x1 + rng.uniform(1, w * 0.4, r)
    out[:, 4] = y1 + rng.uniform(1, h * 0.4, r)
    out[:, 1:] /= scale
    return out


@pytest.mark.parametrize("pooled,scale", [((3, 3), 1.0), (2, 0.5),
                                          ((2, 4), 0.25)])
def test_roi_pooling_and_its_gradient(pooled, scale):
    data = _rand(2, 3, 12, 10)
    _check_grad("ROIPooling", {"pooled_size": pooled,
                               "spatial_scale": scale},
                [data, _rois(5, 2, 12, 10, scale=scale)], [0])


@pytest.mark.parametrize("pooled,scale", [((3, 3), 1.0), (2, 0.5)])
def test_roi_align_and_its_gradient(pooled, scale):
    data = _rand(2, 3, 12, 10)
    _check_grad("_contrib_ROIAlign", {"pooled_size": pooled,
                                      "spatial_scale": scale},
                [data, _rois(5, 2, 12, 10, scale=scale)], [0])


@pytest.mark.parametrize("asc,shape,thresh", [
    (False, (2, 6, 4), 0.2), (True, (5, 7), 0.8), (False, (3, 4, 4), -1.0)])
def test_bipartite_matching(asc, shape, thresh):
    d = np.random.RandomState(9).uniform(0, 1, shape).astype(np.float32)
    (trm, tcm), (jrm, jcm) = _fwd_both(
        "_contrib_bipartite_matching", {"is_ascend": asc,
                                        "threshold": thresh}, [d])
    np.testing.assert_array_equal(trm, jrm)
    np.testing.assert_array_equal(tcm, jcm)


# ---------------------------------------------------------------------------
# spatial
# ---------------------------------------------------------------------------

def test_bilinear_sampler_and_its_gradient():
    """Grid points inside and outside the image (zero padding)."""
    grid = np.random.RandomState(10).uniform(-1.2, 1.2, (2, 2, 5, 6)) \
        .astype(np.float32)
    _check_grad("BilinearSampler", {}, [_rand(2, 3, 7, 8), grid], [0, 1])


@pytest.mark.parametrize("tt", ["affine", "warp"])
def test_grid_generator_and_its_gradient(tt):
    if tt == "affine":
        params, x = {"transform_type": "affine",
                     "target_shape": (5, 7)}, _rand(3, 6)
    else:
        params, x = {"transform_type": "warp"}, _rand(2, 2, 5, 6)
    _check_grad("GridGenerator", params, [x], [0])


def test_spatial_transformer_and_its_gradient():
    theta = np.tile(np.asarray([0.9, 0.1, 0.05, -0.1, 0.8, -0.05],
                               np.float32), (2, 1)) + _rand(2, 6, scale=0.05)
    _check_grad("SpatialTransformer", {"target_shape": (6, 5)},
                [_rand(2, 3, 8, 9), theta], [0, 1])


@pytest.mark.parametrize("params", [
    {"max_displacement": 2, "pad_size": 2},
    {"max_displacement": 2, "stride2": 2, "stride1": 2, "pad_size": 2},
    {"max_displacement": 1, "is_multiply": False, "pad_size": 1}])
def test_correlation_and_its_gradient(params):
    _check_grad("Correlation", params, [_rand(2, 4, 8, 9),
                                        _rand(2, 4, 8, 9, seed=1)], [0, 1])


@pytest.mark.parametrize("params,n", [
    ({"num_args": 2}, 2), ({"num_args": 1, "h_w": (4, 5),
                            "offset": (1, 2)}, 1),
    ({"num_args": 2, "center_crop": True}, 2)])
def test_crop(params, n):
    ins = [_rand(2, 3, 9, 10), _rand(2, 1, 5, 6, seed=1)][:n]
    _check_grad("Crop", params, ins, [0])


def test_crop_fills_num_args_from_its_inputs():
    """Crop is variadic: the symbolic frontend writes num_args, as the
    JAX package's does, so the JSON is the same."""
    def build(mx):
        a, b = mx.sym.Variable("a"), mx.sym.Variable("b")
        return json.loads(mx.sym.Crop(a, b, center_crop=True,
                                      name="crop").tojson())["nodes"]
    assert build(tmx) == build(jmx)


# ---------------------------------------------------------------------------
# deformable
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("params", [
    {"kernel": (3, 3), "num_filter": 4, "pad": (1, 1)},
    {"kernel": (3, 3), "num_filter": 4, "stride": (2, 2), "dilate": (2, 2),
     "pad": (2, 2), "num_group": 2, "num_deformable_group": 2,
     "no_bias": True},
])
def test_deformable_convolution_and_its_gradient(params):
    n, c, h, w = 2, 4, 9, 8
    kh, kw = params["kernel"]
    sh, sw = params.get("stride", (1, 1))
    dh, dw = params.get("dilate", (1, 1))
    ph, pw = params["pad"]
    ho = (h + 2 * ph - (dh * (kh - 1) + 1)) // sh + 1
    wo = (w + 2 * pw - (dw * (kw - 1) + 1)) // sw + 1
    dg = params.get("num_deformable_group", 1)
    g = params.get("num_group", 1)
    ins = [_rand(n, c, h, w), _rand(n, dg * 2 * kh * kw, ho, wo, seed=1,
                                    scale=0.7),
           _rand(params["num_filter"], c // g, kh, kw, seed=2, scale=0.3)]
    if not params.get("no_bias"):
        ins.append(_rand(params["num_filter"], seed=3))
    _check_grad("_contrib_DeformableConvolution", params, ins,
                list(range(len(ins))))


@pytest.mark.parametrize("no_trans", [False, True])
def test_deformable_psroi_pooling_and_its_gradient(no_trans):
    """Held to the JAX op's sampling grid (samples at hstart + i *
    sub_bin, bounds inclusive), and its top_count equal."""
    od, gs, ps = 2, 3, 3
    params = {"spatial_scale": 0.5, "output_dim": od, "group_size": gs,
              "pooled_size": ps, "sample_per_part": 2, "trans_std": 0.1,
              "no_trans": no_trans}
    data = _rand(2, od * gs * gs, 10, 12)
    rois = _rois(4, 2, 20, 24, scale=1.0)
    ins = [data, rois]
    if not no_trans:
        ins.append(_rand(4, 2 * 2, ps, ps, seed=4))
    grad = [0] if no_trans else [0, 2]
    _check_grad("_contrib_DeformablePSROIPooling", params, ins, grad)
    (tout, tcount), (jout, jcount) = _fwd_both(
        "_contrib_DeformablePSROIPooling", params, ins)
    np.testing.assert_array_equal(tcount, jcount)


# ---------------------------------------------------------------------------
# the registries
# ---------------------------------------------------------------------------

NEW_OPS = [
    "_contrib_MultiBoxPrior", "_contrib_MultiBoxTarget",
    "_contrib_MultiBoxDetection", "_contrib_box_iou", "_contrib_box_nms",
    "ROIPooling", "_contrib_ROIAlign", "_contrib_bipartite_matching",
    "BilinearSampler", "GridGenerator", "SpatialTransformer", "Correlation",
    "Crop", "_contrib_DeformableConvolution",
    "_contrib_DeformablePSROIPooling", "MakeLoss", "LinearRegressionOutput",
    "LogisticRegressionOutput", "MAERegressionOutput", "SVMOutput",
    "IdentityAttachKLSparseReg", "smooth_l1", "cbrt", "rcbrt", "degrees",
    "radians", "erfinv", "gamma", "gammaln", "_hypot_scalar",
    "_logical_xor_scalar"]


@pytest.mark.parametrize("name", NEW_OPS)
def test_op_tables_match_jax(name):
    """Each new op: the JAX op's aliases, param table, arity and input
    names; reachable as mx.sym.X / mx.nd.X, and the _contrib_ ones as
    mx.sym.contrib.X / mx.nd.contrib.X."""
    j, t = jreg.get(name), treg.get(name)
    assert t.name == j.name
    assert set(t.aliases) == set(j.aliases)
    def table(op, req):
        return {k: "REQUIRED" if v is req else v
                for k, v in op.params.items()}
    assert table(t, treg.REQUIRED) == table(j, jreg.REQUIRED)
    assert (t.nin, t.nout) == (j.nin, j.nout)
    sample = {k: (1 if v is jreg.REQUIRED else v)
              for k, v in j.params.items()}
    assert t.list_input_names(sample) == j.list_input_names(sample)
    for alias in (name,) + tuple(j.aliases):
        if not alias.startswith("_"):
            assert callable(getattr(tmx.sym, alias))
            assert callable(getattr(tmx.nd, alias))
    if name.startswith("_contrib_"):
        short = name[len("_contrib_"):]
        assert callable(getattr(tmx.sym.contrib, short))
        assert callable(getattr(tmx.nd.contrib, short))
        assert callable(getattr(jmx.sym.contrib, short))
