"""BASELINE config #5 (`examples/ssd/train_ssd.py`, SSD-VGG16) in the
PyTorch port against the JAX package, on the CPU: the slice as a whole.

- The JAX example's `ssd_symbol(...).tojson()` loads into the port and
  infers the same shapes; `chip_smoke.py`'s copy of the example
  (`ssd_symbol`, `vgg16_reduced`, `SyntheticDetIter`'s arrays), built on
  the port's `mx.sym`, writes the same JSON and the same data, so the
  copy the card runs cannot drift from the example.
- Three `Module.fit` steps of `ssd_symbol(small=True)` at 64x64, batch
  4, with the example's optimizer and metric, in both packages from the
  same Xavier parameters (drawn by the JAX package, carried across as
  numpy by `compat.weights.params_from_numpy`: the SSD has no aux
  states) and the same shuffled batches: the readouts (CrossEntropy,
  SmoothL1) after every step, and every parameter and momentum after
  the third, within rtol 1e-3 + 1e-4 * max|array| (float32 convolutions
  summed in other orders over three steps).
- The example's closing decode on the JAX module's trained parameters
  in both packages: the kept detections (class, score) equal in every
  image without a near tie (two scores, or an IoU and the NMS
  threshold, within 1e-6), the boxes within rtol 1e-5 + 1e-6 * max.
"""
import importlib.util
import json
import os
import threading

import numpy as np
import pytest

import incubator_mxnet_tpu as jmx

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch.compat import weights

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = (1e-3, 1e-4)
NEAR = 1e-6


def _load(name, *parts):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, *parts))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


EX = _load("_train_ssd", "examples", "ssd", "train_ssd.py")
CS = _load("_chip_smoke", "chip_smoke.py")


def _in_thread(fn):
    """fn() in a fresh thread: the symbol name counters are per thread,
    so two builds there name their nodes alike."""
    out = []
    t = threading.Thread(target=lambda: out.append(fn()))
    t.start()
    t.join()
    return out[0]


def _nodes(js):
    return json.loads(js)["nodes"]


@pytest.mark.parametrize("small", [False, True])
def test_example_symbol_loads_into_the_port(small):
    jsym = _in_thread(lambda: EX.ssd_symbol(3, small=small))
    tsym = tmx.sym.load_json(jsym.tojson())
    shapes = dict(data=(2, 3, 128, 128), label=(2, 3, 5))
    assert tsym.list_arguments() == jsym.list_arguments()
    assert tsym.list_outputs() == jsym.list_outputs()
    targs, touts, _ = tsym.infer_shape(**shapes)
    jargs, jouts, _ = jsym.infer_shape(**shapes)
    assert [tuple(s) for s in touts] == [tuple(s) for s in jouts] == [
        (2, 4, 1108), (2, 4432), (2, 1108), (2, 1108, 6)]
    assert [tuple(s) for s in targs] == [tuple(s) for s in jargs]


@pytest.mark.parametrize("small", [False, True])
def test_chip_smoke_copy_writes_the_example_json(small):
    want = _in_thread(lambda: EX.ssd_symbol(3, small=small).tojson())
    got = _in_thread(lambda: CS.ssd_symbol(tmx, 3, small=small).tojson())
    assert _nodes(got) == _nodes(want)
    assert json.loads(got)["heads"] == json.loads(want)["heads"]


def test_chip_smoke_copy_draws_the_example_data():
    """`ssd_iter` = `SyntheticDetIter`: the same images, labels and
    shuffled batch order."""
    got = CS.ssd_iter(tmx, 12, 4, image=32)
    np.random.seed(CS.SEED)
    want = EX.SyntheticDetIter(12, 4, 32, 3)
    n = 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.data[0].asnumpy(),
                                      b.data[0].asnumpy())
        np.testing.assert_array_equal(a.label[0].asnumpy(),
                                      b.label[0].asnumpy())
        n += 1
    assert n == 3


def _metric(pkg):
    """The example's MultiBoxMetric on `pkg` (chip_smoke's copy; its
    `update` is the example's, line for line)."""
    return CS.ssd_metric(pkg)


def _fit(pkg, sym, params, steps=3, batch=4, image=64):
    """The example's fit at a small size: 1 epoch of `steps` batches of
    SyntheticDetIter, SGD lr 0.01 momentum 0.9 wd 5e-4 rescale 1/batch,
    from `params`; returns (readouts after each step, {name: array} of
    parameters and momenta, the module)."""
    np.random.seed(0)
    it = EX.SyntheticDetIter(steps * batch, batch, image, 3) if pkg is jmx \
        else CS.ssd_iter(tmx, steps * batch, batch, image)
    mod = pkg.mod.Module(sym, context=pkg.cpu(), data_names=("data",),
                         label_names=("label",))
    reads = []
    metric = _metric(pkg)
    mod.fit(it, num_epoch=1, optimizer="sgd",
            optimizer_params={"learning_rate": 0.01, "momentum": 0.9,
                              "wd": 5e-4, "rescale_grad": 1.0 / batch},
            arg_params={k: pkg.nd.array(v, ctx=pkg.cpu())
                        for k, v in params.items()},
            eval_metric=metric,
            batch_end_callback=lambda p: reads.append(
                list(p.eval_metric.get()[1])))
    args, _ = mod.get_params()
    out = {k: v.asnumpy() for k, v in args.items()}
    names = mod._exec_group.param_names
    for i, s in weights.module_states_to_numpy(mod).items():
        out[f"{names[i]}:momentum"] = s
    return np.asarray(reads), out, mod


@pytest.fixture(scope="module")
def fitted():
    jsym = _in_thread(lambda: EX.ssd_symbol(3, small=True))
    tsym = tmx.sym.load_json(jsym.tojson())
    init = jmx.mod.Module(jsym, context=jmx.cpu(), data_names=("data",),
                          label_names=("label",))
    init.bind([("data", (4, 3, 64, 64))], [("label", (4, 3, 5))])
    jmx.random.seed(0)
    init.init_params(jmx.initializer.Xavier())
    targ, taux = weights.params_from_numpy(*init.get_params(),
                                           ctx=tmx.cpu())
    assert not taux
    params = {k: v.asnumpy() for k, v in targ.items()}
    old = os.environ.get("MXNET_FUSED_TRAIN_STEP")
    os.environ["MXNET_FUSED_TRAIN_STEP"] = "0"     # the JAX per-batch path
    try:
        jres = _fit(jmx, jsym, params)
    finally:
        if old is None:
            del os.environ["MXNET_FUSED_TRAIN_STEP"]
        else:
            os.environ["MXNET_FUSED_TRAIN_STEP"] = old
    tres = _fit(tmx, tsym, params)
    return tres, jres, params


def _close(got, want, what, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=tol[0],
                               atol=tol[1] * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def test_three_fit_steps_match_jax(fitted):
    (treads, tstate, tmod), (jreads, jstate, _), params = fitted
    assert treads.shape == jreads.shape == (3, 2)
    assert np.isfinite(treads).all()
    _close(treads, jreads, "readouts")
    assert tmod._fused_step is not None and tmod._fused_step.steps == 0
    assert set(tstate) == set(jstate)
    assert any(k.endswith(":momentum") for k in tstate)
    for k in sorted(jstate):
        _close(tstate[k], jstate[k], k)
    moved = [k for k in params if not np.array_equal(tstate[k], params[k])]
    assert len(moved) == len(params)


def _near(det):
    """Whether an image's decode has two positive scores apart by less
    than NEAR (an exact tie sorts alike in both packages: the sort is
    stable)."""
    gap = np.diff(np.sort(det[:, 1][det[:, 1] > 0]))
    return bool(((gap > 0) & (gap < NEAR)).any())


def _kept(det):
    """An image's kept detections, ordered by (class, score, box): the
    rows the decode outputs in score order, whatever the order of near
    ties."""
    k = det[det[:, 0] >= 0]
    return k[np.lexsort(k.T[::-1])]


def test_decode_matches_jax(fitted):
    """The example's decode (first batch after a reset, inference
    forward) on the JAX module's trained parameters in both packages:
    cls_prob and loc_loss within rtol 1e-5 + 1e-6 * max, the class
    targets equal; per image the kept detections, as a set, equal
    (classes) and within the same tolerance (scores, boxes).  Scores
    that differ between the packages by float32 sums can swap places
    with a near-equal one, which moves rows but keeps the set; an image
    whose set differs must hold such a near tie (counted)."""
    _, (_, jstate, jmod), _ = fitted
    tsym = tmx.sym.load_json(jmod.symbol.tojson())
    tmod = tmx.mod.Module(tsym, context=tmx.cpu(), data_names=("data",),
                          label_names=("label",))
    tmod.bind([("data", (4, 3, 64, 64))], [("label", (4, 3, 5))],
              for_training=False)
    tmod.set_params({k: tmx.nd.array(v, ctx=tmx.cpu()) for k, v in
                     jstate.items() if ":" not in k}, {})
    outs = []
    for pkg, mod in ((tmx, tmod), (jmx, jmod)):
        np.random.seed(0)
        it = CS.ssd_iter(tmx, 12, 4, 64) if pkg is tmx else \
            EX.SyntheticDetIter(12, 4, 64, 3)
        it.reset()
        batch = next(iter(it))
        mod.forward(batch, is_train=False)
        outs.append([o.asnumpy() for o in mod.get_outputs()])
    (tp, tl, tc, tdet), (jp, jl, jc, jdet) = outs
    _close(tp, jp, "cls_prob", (1e-5, 1e-6))
    _close(tl, jl, "loc_loss", (1e-5, 1e-6))
    np.testing.assert_array_equal(tc, jc)
    equal = 0
    for t, j in zip(tdet, jdet):
        a, b = _kept(t), _kept(j)
        same = a.shape == b.shape and np.array_equal(a[:, 0], b[:, 0]) \
            and np.allclose(a[:, 1:], b[:, 1:], rtol=1e-5,
                            atol=1e-6 * np.abs(b[:, 1:]).max())
        assert same or _near(j)
        equal += same
    assert equal >= 2
    assert (tdet[..., 0] >= 0).sum() >= 1
