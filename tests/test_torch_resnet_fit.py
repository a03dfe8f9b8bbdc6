"""ResNet training through the port's `Module.fit` against the JAX
package's on the CPU, and the pieces of the port's fused train step:
the multi-tensor SGD update, the metrics that count on the device and
the ``MXNET_FUSED_TRAIN_STEP`` knob.

The network is a thumbnail ResNet v1 (`ResNetV1(BottleneckV1, [1, 1, 1,
1], [16, 16, 32, 64, 128], classes=10, thumbnail=True)`: 16 convolutions,
15 BatchNorms, 4 residual adds) composed on a Symbol, 3 steps at batch
4 of 3x32x32 images, SGD lr 0.05 momentum 0.9, the parameters from one
numpy seed.  The JAX side runs per batch (``MXNET_FUSED_TRAIN_STEP=0``)
and with its defaults (its fused K-step program).

Tolerances.  float32: the same sums in other orders through 3 momentum
steps, rtol 1e-4 + 1e-5 * max|ref| (parameters, momenta, BatchNorm's
moving statistics, the per-step loss).  A convolution's bias that feeds
a BatchNorm has a zero gradient in exact arithmetic (the normalisation
removes any constant shift), so its momentum is rounding noise in both
packages (~1e-8): those 8 momenta are held to |x| < 1e-6 instead.

bf16 with multi_precision: each package rounds every layer's output
and gradient to bf16 (2**-8 relative) after float32 sums in its own
order, and at this size the backward through BatchNorm cancels much of
each gradient, so two bf16 runs part by as much as each parts from the
float32 run (the momenta by ~0.5 in relative L2 norm, in both packages).
No elementwise bound between the two bf16 runs says anything there.  The
test holds the port's bf16 run as close to the JAX package's float32 run
as the JAX package's own bf16 run is, within a factor of 1.5, in
relative L2 norm over each kind of array (losses, bf16 weights, fp32
masters, momenta, moving statistics), and the bf16 weights to be their
masters rounded, exactly.
"""
import functools
import os
import threading

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch.ops.optimizer_ops import (
    mp_sgd_mom_update_, mp_sgd_update_, multi_sgd_update_, sgd_mom_update_,
    sgd_update_)

TOL = (1e-4, 1e-5)
BF16_FACTOR = 1.5
BATCH, STEPS, IMAGE = 4, 3, (3, 32, 32)
OPT = {"learning_rate": 0.05, "momentum": 0.9}
NOISE = 1e-6


def _close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    rtol, atol = tol
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _thumbnail_symbol(pkg):
    """The thumbnail ResNet + SoftmaxOutput, composed in a fresh thread
    (fresh name counters, so both packages give the same names)."""
    out = {}

    def build():
        v = pkg.gluon.model_zoo.vision
        net = v.ResNetV1(v.BottleneckV1, [1, 1, 1, 1], [16, 16, 32, 64, 128],
                         classes=10, thumbnail=True)
        out["sym"] = pkg.sym.SoftmaxOutput(net(pkg.sym.Variable("data")),
                                           name="softmax")
    t = threading.Thread(target=build)
    t.start()
    t.join(60)
    return out["sym"]


def _data(seed=0):
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1, 1, (BATCH * STEPS,) + IMAGE).astype(np.float32)
    y = rng.randint(0, 10, BATCH * STEPS).astype(np.float32)
    return x, y


def _params(sym, seed=1):
    """Gaussian weights (fan-in scaled), ones/zeros for gamma/beta and
    the moving statistics, from one numpy seed."""
    args, _, aux = sym.infer_shape(data=(BATCH,) + IMAGE)
    rng = np.random.RandomState(seed)
    arg = {}
    for n, s in zip(sym.list_arguments(), args):
        if n in ("data", "softmax_label"):
            continue
        if n.endswith("weight"):
            arg[n] = (rng.normal(0, 1, s) *
                      np.sqrt(2.0 / np.prod(s[1:]))).astype(np.float32)
        elif n.endswith("gamma"):
            arg[n] = rng.uniform(0.8, 1.2, s).astype(np.float32)
        else:
            arg[n] = rng.normal(0, 0.1, s).astype(np.float32)
    auxv = {n: (np.zeros if n.endswith("mean") else np.ones)(s, np.float32)
            for n, s in zip(sym.list_auxiliary_states(), aux)}
    return arg, auxv


def _iter(pkg, x, y, dtype):
    """One pass over STEPS batches, the data in `dtype`, declared so in
    provide_data (the bench lane's low-precision iterator)."""
    ctx = pkg.cpu()
    batches = []
    for k in range(STEPS):
        data = pkg.nd.array(x[k * BATCH:(k + 1) * BATCH], ctx=ctx)
        if dtype != "float32":
            data = data.astype(dtype)
        batches.append(pkg.io.DataBatch(
            data=[data], label=[pkg.nd.array(y[k * BATCH:(k + 1) * BATCH],
                                             ctx=ctx)], pad=0))
    ddt = dtype if pkg is tmx else np.dtype(dtype)
    desc = pkg.io.DataDesc("data", (BATCH,) + IMAGE, dtype=ddt)
    ldesc = pkg.io.DataDesc("softmax_label", (BATCH,), dtype=np.float32)

    class It(pkg.io.DataIter):
        def __init__(self):
            super().__init__(batch_size=BATCH)
            self._i = 0

        @property
        def provide_data(self):
            return [desc]

        @property
        def provide_label(self):
            return [ldesc]

        def reset(self):
            self._i = 0

        def next(self):
            if self._i >= len(batches):
                raise StopIteration
            self._i += 1
            return batches[self._i - 1]

    return It()


def _fit(pkg, sym, dtype, params):
    """fit 3 steps; returns (per-step losses, {name: array} of
    parameters, momenta (keyed by parameter), moving statistics, and the
    module)."""
    ctx = pkg.cpu()
    mod = pkg.mod.Module(sym, context=ctx)
    sums = []

    def record(p):
        sums.append(p.eval_metric.get()[1] * (p.nbatch + 1) * BATCH)

    arg, aux = params
    mod.fit(_iter(pkg, *_data(), dtype), eval_metric="ce",
            batch_end_callback=record, optimizer="sgd",
            optimizer_params=dict(OPT, multi_precision=dtype != "float32"),
            arg_params={k: pkg.nd.array(v, ctx=ctx) for k, v in arg.items()},
            aux_params={k: pkg.nd.array(v, ctx=ctx) for k, v in aux.items()},
            num_epoch=1)
    losses = np.diff([0.0] + sums) / BATCH
    args, auxs = mod.get_params()
    names = mod._exec_group.param_names
    out = {k: _f32(v) for k, v in args.items()}
    out.update({k: _f32(v) for k, v in auxs.items()})
    for i, n in enumerate(names):
        state = mod._updater.states[i]
        if isinstance(state, tuple):       # (momentum, fp32 master)
            out[f"{n}:momentum"] = _f32(state[0])
            out[f"{n}:master"] = _f32(state[1])
        else:
            out[f"{n}:momentum"] = _f32(state)
    return losses, out, mod


def _f32(v):
    return np.asarray(v.astype("float32").asnumpy(), np.float32)


@functools.lru_cache(maxsize=None)
def _cached_fit(pkg_name, dtype, fused):
    """`_fit` of the thumbnail ResNet in the port ("port") or the JAX
    package ("jax") under MXNET_FUSED_TRAIN_STEP=`fused`, from the
    parameters the port's symbol gives (the names are the same)."""
    pkg = tmx if pkg_name == "port" else jmx
    old = os.environ.get("MXNET_FUSED_TRAIN_STEP")
    os.environ["MXNET_FUSED_TRAIN_STEP"] = "1" if fused else "0"
    try:
        sym = _thumbnail_symbol(pkg)
        return _fit(pkg, sym, dtype, _params(_thumbnail_symbol(tmx)))
    finally:
        if old is None:
            os.environ.pop("MXNET_FUSED_TRAIN_STEP")
        else:
            os.environ["MXNET_FUSED_TRAIN_STEP"] = old


@pytest.mark.parametrize("jax_path", ["per_batch", "fused_defaults"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_resnet_fit_matches_jax(dtype, jax_path):
    """The port's fit (fused step) against the JAX package's per-batch
    path and its fused K-step program: the loss of each step, every
    parameter, momentum (and fp32 master) and BatchNorm's moving
    statistics after 3 steps."""
    losses, got, mod = _cached_fit("port", dtype, True)
    assert mod._fused_step is not None and mod._fused_step.steps == STEPS
    fused = jax_path == "fused_defaults"
    jlosses, want, jmod = _cached_fit("jax", dtype, fused)
    assert (jmod._fused_step is None) == (not fused)
    assert got.keys() == want.keys()
    assert sum(k.endswith("running_var") for k in got) == 15
    if dtype == "float32":
        _close(losses, jlosses, TOL, "per-step loss")
        zero = _bn_fed_biases(_thumbnail_symbol(tmx))
        assert len(zero) == 8
        for k, v in want.items():
            if k.endswith(":momentum") and k.split(":")[0] in zero:
                assert np.abs(got[k]).max() < NOISE and \
                    np.abs(v).max() < NOISE, k
                continue
            _close(got[k], v, TOL, k)
        return
    ref_losses, ref, _ = _cached_fit("jax", "float32", fused)
    for kind in ("weight", "master", "momentum", "moving"):
        keys = [k for k in got if _kind(k) == kind]
        assert keys, kind
        port, jax_ = _dist(got, ref, keys), _dist(want, ref, keys)
        assert port <= BF16_FACTOR * jax_, (kind, port, jax_)
    assert np.linalg.norm(losses - ref_losses) <= \
        BF16_FACTOR * np.linalg.norm(jlosses - ref_losses)
    args = mod.get_params()[0]
    for k, v in args.items():
        assert v.data.dtype == torch.bfloat16
        master = torch.from_numpy(got[f"{k}:master"]).bfloat16()
        assert torch.equal(v.data, master), k


def _bn_fed_biases(sym):
    """Biases of convolutions that feed a BatchNorm (zero gradient in
    exact arithmetic)."""
    out = set()
    for node in sym._topo():
        if not node.is_variable and node.op.name == "BatchNorm":
            src = node.inputs[0][0]
            if not src.is_variable and src.op.name == "Convolution" and \
                    not src.attrs["no_bias"]:
                out.add(src.inputs[2][0].name)
    return out


def _kind(key):
    if key.endswith((":momentum", ":master")):
        return key.split(":")[1]
    return "moving" if "_running_" in key else "weight"


def _dist(got, ref, keys):
    """Relative L2 distance of `got` from `ref` over `keys` together (a
    master is held to the float32 run's parameter)."""
    a = np.concatenate([got[k].ravel() for k in keys])
    b = np.concatenate([ref[k.replace(":master", "")].ravel()
                        for k in keys])
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_step_equals_the_per_batch_path(dtype):
    """The port's fused step against its own per-batch path: bitwise in
    float32 (the same ops, the multi-tensor update doing the
    per-parameter arithmetic), equal in bf16 too."""
    fl, fused, fmod = _cached_fit("port", dtype, True)
    pl, plain, pmod = _cached_fit("port", dtype, False)
    assert fmod._fused_step.steps == STEPS and pmod._fused_step is None
    np.testing.assert_array_equal(fl, pl)
    for k, v in plain.items():
        np.testing.assert_array_equal(fused[k], v, err_msg=k)


def test_fused_step_knob_and_fallbacks(monkeypatch):
    """MXNET_FUSED_TRAIN_STEP=0 builds no fused step; with it on, a
    metric without `device_update` or a batch of another shape runs the
    per-batch path, and get_outputs follows whichever ran last."""
    sym = _thumbnail_symbol(tmx)
    arg, aux = _params(sym)
    x, y = _data()

    def module():
        mod = tmx.mod.Module(sym, context=tmx.cpu())
        mod.bind([("data", (BATCH,) + IMAGE)], [("softmax_label", (BATCH,))])
        mod.init_params(arg_params=arg, aux_params=aux)
        mod.init_optimizer(optimizer_params=OPT)
        return mod

    monkeypatch.setenv("MXNET_FUSED_TRAIN_STEP", "0")
    assert module()._fused_step is None
    monkeypatch.setenv("MXNET_FUSED_TRAIN_STEP", "1")
    mod = module()
    batch = next(_iter(tmx, x, y, "float32"))
    mod.fit_step(batch, tmx.metric.create("acc"))
    assert mod._fused_step.steps == 1
    assert mod.get_outputs()[0].shape == (BATCH, 10)

    class HostOnly(tmx.metric.EvalMetric):
        def update(self, labels, preds):
            self.sum_metric += 1.0
            self.num_inst += 1

    host = HostOnly("host")
    mod.fit_step(batch, host)
    assert mod._fused_step.steps == 1 and host.get()[1] == 1.0
    small = tmx.io.DataBatch([tmx.nd.array(x[:2], ctx=tmx.cpu())],
                             [tmx.nd.array(y[:2], ctx=tmx.cpu())])
    mod.fit_step(small, tmx.metric.create("acc"))
    assert mod._fused_step.steps == 1
    assert mod.get_outputs()[0].shape == (2, 10)


def _update_case(dtype, n=5, seed=0):
    rng = np.random.RandomState(seed)
    shapes = [(3, 4), (7,), (2, 3, 3, 3), (5, 1), (11,)][:n]
    w = [torch.from_numpy(rng.normal(0, 1, s).astype(np.float32)).to(dtype)
         for s in shapes]
    g = [torch.from_numpy(rng.normal(0, 3, s).astype(np.float32)).to(dtype)
         for s in shapes]
    m = [torch.from_numpy(rng.normal(0, 0.1, s).astype(np.float32))
         for s in shapes]
    lrs = [0.05, 0.1, 0.05, 0.02, 0.07][:n]
    wds = [1e-4, 0.0, 5e-4, 1e-4, 0.0][:n]
    return w, g, m, lrs, wds


@pytest.mark.parametrize("clip", [-1.0, 0.5])
@pytest.mark.parametrize("momentum", [0.0, 0.9])
@pytest.mark.parametrize("mp", [False, True])
def test_multi_tensor_sgd_equals_the_per_parameter_ops(mp, momentum, clip):
    """multi_sgd_update_ over 5 tensors, each with its own lr and wd,
    against sgd_update_ / sgd_mom_update_ (float32: bitwise) and
    mp_sgd_update_ / mp_sgd_mom_update_ (bf16 weights, fp32 masters and
    momenta: masters and momenta bitwise, weights the rounded masters),
    with rescale_grad and clip_gradient."""
    low = torch.bfloat16 if mp else torch.float32
    w, g, m, lrs, wds = _update_case(low)
    ref_w, ref_m = [t.clone() for t in w], [t.clone() for t in m]
    ref_32 = [t.float() for t in w]
    kw = dict(rescale_grad=0.25, clip_gradient=clip)
    for i in range(len(w)):
        if mp and momentum:
            mp_sgd_mom_update_(ref_w[i], g[i], ref_m[i], ref_32[i], lrs[i],
                               momentum, wds[i], **kw)
        elif mp:
            mp_sgd_update_(ref_w[i], g[i], ref_32[i], lrs[i], wds[i], **kw)
        elif momentum:
            sgd_mom_update_(ref_w[i], g[i], ref_m[i], lrs[i], momentum,
                            wds[i], **kw)
        else:
            sgd_update_(ref_w[i], g[i], lrs[i], wds[i], **kw)
    got_w, got_m = [t.clone() for t in w], [t.clone() for t in m]
    got_32 = [t.float() for t in w]
    multi_sgd_update_(got_w, g, lrs, wds, moms=got_m if momentum else None,
                      weights32=got_32 if mp else None, momentum=momentum,
                      **kw)
    for a, b in zip(got_w + got_m + (got_32 if mp else []),
                    ref_w + ref_m + (ref_32 if mp else [])):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)
    assert not torch.equal(got_w[0], w[0])


def test_optimizer_update_multi_counts_like_update():
    """SGD.update_multi with lr_mult / wd_mult and a scheduler: the same
    update counts, lr, wd and results as update_multi_precision per
    index, in float32 and with bf16 masters."""
    def run(multi, dtype):
        opt = tmx.optimizer.SGD(learning_rate=0.1, momentum=0.9, wd=1e-3,
                                rescale_grad=0.5, multi_precision=True,
                                param_idx2name={0: "a_weight", 1: "b_bias",
                                                2: "c_weight"},
                                lr_scheduler=tmx.lr_scheduler.FactorScheduler(
                                    2, 0.5))
        opt.set_lr_mult({"c_weight": 0.1})
        upd = tmx.optimizer.get_updater(opt)
        w, g, _, _, _ = _update_case(dtype, n=3, seed=4)
        ws = [tmx.nd.NDArray(t) for t in w]
        gs = [tmx.nd.NDArray(t) for t in g]
        for _ in range(4):
            if multi:
                upd.update_multi([0, 1, 2], gs, ws)
            else:
                for i in range(3):
                    upd(i, gs[i], ws[i])
        return [t.data for t in ws], opt.num_update, \
            opt._index_update_count
    for dtype in (torch.float32, torch.bfloat16):
        a, na, ca = run(True, dtype)
        b, nb, cb = run(False, dtype)
        assert na == nb == 4 and ca == cb
        assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_device_metrics_match_the_host_computation(dtype):
    """Accuracy and CrossEntropy count on the predictions' device and
    copy to the host only at get(): against numpy over 3 batches and
    against the JAX package's metrics; no host copy before get()."""
    rng = np.random.RandomState(9)
    batches = []
    for _ in range(3):
        p = rng.uniform(0.01, 1, (6, 5)).astype(np.float32)
        p /= p.sum(1, keepdims=True)
        batches.append((rng.randint(0, 5, 6).astype(np.float32), p))
    for name in ("acc", "ce"):
        m, jm = tmx.metric.create(name), jmx.metric.create(name)
        hits = total = ce = 0.0
        for y, p in batches:
            pt = torch.from_numpy(p).to(dtype)
            m.update([tmx.nd.NDArray(torch.from_numpy(y))],
                     [tmx.nd.NDArray(pt)])
            assert m.num_inst == 0 and m._device_totals is not None
            pf = pt.float().numpy()
            jm.update([jmx.nd.array(y)], [jmx.nd.array(pf)])
            hits += (pf.argmax(1) == y).sum()
            ce += -np.log(pf[np.arange(6), y.astype(int)] + 1e-12).sum()
            total += 6
        want = hits / total if name == "acc" else ce / total
        _close(m.get()[1], want, (1e-6, 0), name)
        _close(m.get()[1], jm.get()[1], (1e-6, 0), f"{name} vs jax")
        m.reset()
        assert m.get()[1] != m.get()[1]       # nan after reset
