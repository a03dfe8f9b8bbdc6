"""INT8 quantization in the port (`ops/quantization.py`,
`contrib/quantization.py`) against the JAX package on the CPU: each of
the 9 op names on the same inputs; `quantize_model` on a small
convnet + mlp in the three calibration modes (the graph JSON, the
calibrated ranges and the int8 parameters); the KL threshold and the
device histogram it is cut from, at numpy's bin edges; an excluded
FC -> ReLU under `TPU_PALLAS` running K1 inside a quantized graph; the
quantized forward against the JAX package's and against fp32 (the JAX
package's own test of it, ported); the int8 parameters through a
`.params` file and `compat.weights`.

The JAX `quantize_model` never rewrites a Convolution (its
`_supported` reads an unset layout as another one; ROADMAP Queue 3): one
test shows that, and the comparisons hold the port to the JAX function
with that check repaired (`repaired_jax`).  The graphs' parameters and
inputs are dyadic (multiples of 1/8 and 1/4), so every float32 sum of
their fp32 layers is exact in both packages and the calibrated ranges
can be held bit for bit.

Tolerances: every op output bit for bit (integers, scales and
dequantized values: the same float32 operations in the same order, a
division by a constant as the CPU rounds it); graph JSON, ranges,
thresholds, histograms and int8 parameters equal.  A whole quantized
forward rtol 1e-5 + 1e-5 * max|ref|; against fp32, the JAX test's 0.1
of the output's range and argmax agreement >= 0.75.
"""
import json
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu.contrib import quantization as jq
from incubator_mxnet_tpu.ops import registry as jreg

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch.contrib import quantization as tq
from incubator_mxnet_tpu_torch.ops import registry as treg

CPU = tmx.cpu()
FWD_TOL = (1e-5, 1e-5)


def _fresh(fn):
    """Run `fn` in a new thread: the symbol name counters start at 0."""
    out = []
    t = threading.Thread(target=lambda: out.append(fn()))
    t.start()
    t.join()
    return out[0]


def _run_op(name, params, ins):
    j, t = jreg.get(name), treg.get(name)
    jout = j.fn(j.canonicalize_params(dict(params)),
                *[jnp.asarray(a) for a in ins])
    tout = t.fn(t.canonicalize_params(dict(params)),
                *[torch.from_numpy(np.asarray(a)) for a in ins])
    if not isinstance(jout, (tuple, list)):
        jout, tout = (jout,), (tout,)
    return [np.asarray(a) for a in jout], [b.numpy() for b in tout]


def _op_cases():
    rng = np.random.RandomState(0)
    x = rng.randn(4, 3, 6, 6).astype(np.float32)
    # values at .5 steps of the scale: round-half-even decides them
    ties = (np.arange(-20, 21, dtype=np.float32) + 0.5) / 127.0 * 1.5
    mn, mx = np.array([-1.5], np.float32), np.array([1.5], np.float32)
    q = rng.randint(-127, 128, (4, 3, 6, 6)).astype(np.int8)
    acc = rng.randint(-200000, 200000, (4, 5)).astype(np.int32)
    w = rng.randint(-127, 128, (5, 108)).astype(np.int8)
    wc = rng.randint(-127, 128, (5, 3, 3, 3)).astype(np.int8)
    b = rng.randint(-127, 128, (5,)).astype(np.int8)
    wr = (mn * 0.5, mx * 0.5)
    br = (mn * 2, mx * 3)
    return [
        ("quantize", {}, [x, mn, mx * 0.9]),
        ("_contrib_quantize", {}, [ties, mn, mx]),
        ("_contrib_quantize_v2", {}, [x]),
        ("_contrib_quantize_v2", {"min_calib_range": -1.3,
                                  "max_calib_range": 1.7}, [x]),
        ("_contrib_quantize_v2", {"min_calib_range": -1.5,
                                  "max_calib_range": 1.5}, [ties]),
        ("dequantize", {}, [q, mn, mx]),
        ("_contrib_dequantize", {}, [acc, mn, mx]),
        ("_contrib_requantize", {}, [acc, mn, mx]),
        ("_contrib_requantize", {"min_calib_range": -0.5,
                                 "max_calib_range": 0.7}, [acc, mn, mx]),
        ("_contrib_quantized_fully_connected", {"num_hidden": 5},
         [q, w, b, mn, mx, *wr, *br]),
        ("_contrib_quantized_fully_connected",
         {"num_hidden": 5, "no_bias": True}, [q, w, mn, mx, *wr]),
        ("_contrib_quantized_conv", {"kernel": (3, 3), "num_filter": 5,
                                     "pad": (1, 1)},
         [q, wc, b, mn, mx, *wr, *br]),
        ("_contrib_quantized_conv", {"kernel": (3, 3), "num_filter": 5,
                                     "stride": (2, 2), "no_bias": True},
         [q, wc, mn, mx, *wr]),
        ("_contrib_quantized_pooling", {"kernel": (3, 3), "stride": (2, 2),
                                        "pad": (1, 1)}, [q, mn, mx]),
        ("_contrib_quantized_pooling", {"kernel": (2, 2), "stride": (2, 2),
                                        "pool_type": "avg"}, [q, mn, mx]),
        ("_contrib_quantized_pooling", {"kernel": (1, 1), "pool_type": "avg",
                                        "global_pool": True}, [q, mn, mx]),
    ]


_CASES = _op_cases()


@pytest.mark.parametrize("case", range(len(_CASES)),
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(_CASES)])
def test_quantization_op_matches_jax(case):
    """Every output of each of the 9 names (the aliases included) equals
    the JAX op's: dtypes, shapes and values."""
    name, params, ins = _CASES[case]
    jout, tout = _run_op(name, params, ins)
    assert len(jout) == len(tout)
    for i, (j, t) in enumerate(zip(jout, tout)):
        assert t.dtype == j.dtype and t.shape == j.shape, (name, i)
        np.testing.assert_array_equal(t, j, err_msg=f"{name} output {i}")


def test_every_quantization_name_is_registered():
    names = {c[0] for c in _CASES} | {"_contrib_quantize",
                                      "_contrib_dequantize"}
    assert len(names) == 9
    for name in names:
        assert treg.get(name).nin == jreg.get(name).nin


def test_quantized_fc_is_exact_past_fp32s_window():
    """K = 4096 int8 products: sums far past 2^24, where an fp32 GEMM
    would round; the float64 route gives the int32 sums exactly."""
    rng = np.random.RandomState(1)
    x = np.full((3, 4096), 127, np.int8)
    x[1] = rng.randint(-127, 128, 4096)
    w = np.full((7, 4096), 127, np.int8)
    w[2:] = rng.randint(-127, 128, (5, 4096))
    r = np.array([1.0], np.float32)
    jout, tout = _run_op("_contrib_quantized_fully_connected",
                         {"num_hidden": 7, "no_bias": True},
                         [x, w, -r, r, -r, r])
    np.testing.assert_array_equal(tout[0], jout[0])
    assert tout[0][0, 0] == 4096 * 127 * 127 > 2 ** 24
    np.testing.assert_array_equal(
        tout[0], x.astype(np.int64) @ w.astype(np.int64).T)


# -- quantize_model ---------------------------------------------------------------

def _net(mx):
    data = mx.sym.Variable("data")
    c = mx.sym.Convolution(data, kernel=(3, 3), num_filter=8, pad=(1, 1),
                           name="conv0")
    c = mx.sym.Activation(c, act_type="relu", name="relu0")
    p = mx.sym.Pooling(c, kernel=(2, 2), stride=(2, 2), pool_type="max",
                       name="pool0")
    p = mx.sym.Pooling(p, kernel=(2, 2), stride=(1, 1), pool_type="avg",
                       name="pool1")
    f = mx.sym.Flatten(p, name="flat0")
    h = mx.sym.FullyConnected(f, num_hidden=16, name="fc0")
    h = mx.sym.Activation(h, act_type="relu", name="relu1")
    return mx.sym.FullyConnected(h, num_hidden=10, name="fc1")


def _data(seed=0):
    """Parameters, calibration batches and an input of dyadic values
    (multiples of 1/8 and 1/4): every float32 sum of the fp32 layers is
    exact, so the two packages' calibrations see the same numbers."""
    rng = np.random.RandomState(seed)
    js = _fresh(lambda: _net(jmx))
    shapes, _, _ = js.infer_shape(data=(4, 3, 8, 8))
    args = {n: (rng.randint(-4, 5, s) / 8).astype(np.float32)
            for n, s in zip(js.list_arguments(), shapes) if n != "data"}
    calib = (rng.randint(-8, 9, (16, 3, 8, 8)) / 4).astype(np.float32)
    x = (rng.randint(-8, 9, (4, 3, 8, 8)) / 4).astype(np.float32)
    return args, calib, x


@pytest.fixture
def repaired_jax(monkeypatch):
    """The JAX package's `quantize_model` with its `_supported` repaired
    to read an unset Convolution layout as NCHW, as the port does."""
    orig = jq._supported

    def supported(node):
        if node.op.name == "Convolution" and \
                node.attrs.get("layout") is None:
            return len(tuple(node.attrs.get("kernel") or ())) == 2
        return orig(node)
    monkeypatch.setattr(jq, "_supported", supported)


def _quantize(mx, q, args, calib, mode, excluded):
    def run():
        sym = _net(mx)
        it = mx.io.NDArrayIter(calib, batch_size=4)
        kw = {"ctx": CPU} if mx is tmx else {}
        params = {k: mx.nd.array(v, **kw) for k, v in args.items()}
        return q.quantize_model(sym, params, {}, calib_mode=mode,
                                calib_data=it, num_calib_examples=16,
                                excluded_sym_names=excluded, **kw)
    return _fresh(run)


def _forward(mx, sym, params, x):
    kw = {"ctx": CPU} if mx is tmx else {}
    exe = sym.simple_bind(ctx=CPU if mx is tmx else mx.cpu(),
                          grad_req="null", data=x.shape)
    exe.copy_params_from(params, {}, allow_extra_params=True)
    return exe.forward(is_train=False, data=mx.nd.array(x, **kw))[0] \
        .asnumpy()


@pytest.mark.parametrize("mode", ["none", "naive", "entropy"])
def test_quantize_model_matches_jax(mode, repaired_jax):
    """The same quantized graph (every node: op, name, attrs with the
    calibrated ranges, inputs), the same int8 weights with their
    ``_min``/``_max``, and the same forward, against the JAX package with
    its Convolution fault repaired (the next test)."""
    args, calib, x = _data()
    jsym, jargs, _ = _quantize(jmx, jq, args, calib, mode, ["fc0"])
    tsym, targs, _ = _quantize(tmx, tq, args, calib, mode, ["fc0"])
    assert json.loads(tsym.tojson())["nodes"] == \
        json.loads(jsym.tojson())["nodes"]
    if mode != "none":
        assert "min_calib_range" in tsym.tojson()
    assert sorted(targs) == sorted(jargs)
    for k, v in jargs.items():
        got, want = targs[k].asnumpy(), v.asnumpy()
        assert got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want, err_msg=k)
    assert targs["conv0_weight"].asnumpy().dtype == np.int8
    want = _forward(jmx, jsym, jargs, x)
    got = _forward(tmx, tsym, targs, x)
    np.testing.assert_allclose(got, want, rtol=FWD_TOL[0],
                               atol=FWD_TOL[1] * np.abs(want).max())


def test_jax_quantize_model_never_quantizes_a_convolution():
    """The JAX `_supported` reads ``p.get("layout", "NCHW")``, but an
    unset layout is present as None, so every Convolution stays fp32
    (ROADMAP Queue 3); the port rewrites it."""
    args, calib, _ = _data(6)
    jsym, jargs, _ = _quantize(jmx, jq, args, calib, "naive", [])
    tsym, targs, _ = _quantize(tmx, tq, args, calib, "naive", [])
    jops = [n["op"] for n in json.loads(jsym.tojson())["nodes"]]
    tops = [n["op"] for n in json.loads(tsym.tojson())["nodes"]]
    assert "Convolution" in jops and "_contrib_quantized_conv" not in jops
    assert "Convolution" not in tops and "_contrib_quantized_conv" in tops
    assert jargs["conv0_weight"].asnumpy().dtype == np.float32
    assert targs["conv0_weight"].asnumpy().dtype == np.int8


@pytest.mark.parametrize("mode", ["naive", "entropy"])
def test_calibration_ranges_match_jax(mode):
    """`_collect_calib_ranges`: every internal output's range (naive) or
    minimum-KL threshold (entropy) equals the JAX package's."""
    args, calib, _ = _data(1)

    def run(mx, q):
        sym = _net(mx)
        kw = {"ctx": CPU} if mx is tmx else {}
        params = {k: mx.nd.array(v, **kw) for k, v in args.items()}
        it = mx.io.NDArrayIter(calib, batch_size=4)
        return q._collect_calib_ranges(sym, params, {}, it, 4,
                                       CPU if mx is tmx else mx.cpu(),
                                       mode=mode)
    got, want = _fresh(lambda: run(tmx, tq)), _fresh(lambda: run(jmx, jq))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == want[k], k


def test_kl_threshold_matches_jax():
    """The JAX test's outlier case, and a skewed histogram, give the JAX
    package's threshold."""
    rng = np.random.RandomState(3)
    arr = rng.normal(0, 1, 20000)
    arr[0] = 100.0
    thr = tq._kl_optimal_threshold(arr)
    assert thr == jq._kl_optimal_threshold(arr)
    assert 1.0 < thr < 50.0
    skew = np.abs(rng.standard_cauchy(5000)).astype(np.float32)
    assert tq._kl_optimal_threshold(skew) == jq._kl_optimal_threshold(skew)
    hist = rng.randint(0, 50, 8001)
    assert tq._kl_threshold_from_hist(hist, 3.5) == \
        jq._kl_threshold_from_hist(hist, 3.5)
    parts = [(rng.randint(0, 9, 8001), a) for a in (1.0, 2.5, 0.3)]
    for got, want in zip(tq._merge_histograms(parts),
                         jq._merge_histograms(parts)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_device_histogram_is_numpys(dtype):
    """`_histogram` counts as `np.histogram(a, 8001, (-m, m))` does: on
    random values, on every bin edge itself, one ulp either side of
    each, and at -m and m (the last bin closed)."""
    rng = np.random.RandomState(4)
    absmax = 2.75
    edges = np.histogram_bin_edges(np.empty(0, dtype), bins=8001,
                                   range=(-absmax, absmax))
    vals = np.concatenate([
        rng.uniform(-absmax, absmax, 50000).astype(dtype), edges,
        np.nextafter(edges, np.inf), np.nextafter(edges, -np.inf),
        np.array([-absmax, absmax] * 3, dtype)]).astype(dtype)
    vals = np.clip(vals, -absmax, absmax)
    want, _ = np.histogram(vals, bins=8001, range=(-absmax, absmax))
    got = tq._histogram(torch.from_numpy(vals), absmax).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.sum() == vals.size


def test_excluded_fc_relu_runs_k1_in_the_quantized_graph(monkeypatch,
                                                         repaired_jax):
    """fc0 excluded stays FullyConnected -> ReLU; bound under TPU_PALLAS
    the partitioner fuses it and K1 (here its plain version) runs once a
    forward, while conv0, both poolings and fc1 run int8; the output
    equals the unpartitioned quantized graph's."""
    from incubator_mxnet_tpu_torch.subgraph import fused_ops
    args, calib, x = _data(2)
    tsym, targs, _ = _quantize(tmx, tq, args, calib, "naive", ["fc0"])
    ops = [n["op"] for n in json.loads(tsym.tojson())["nodes"]]
    assert ops.count("_contrib_quantized_conv") == 1
    assert ops.count("_contrib_quantized_pooling") == 2
    assert ops.count("_contrib_quantized_fully_connected") == 1
    assert ops.count("FullyConnected") == 1
    plain = _forward(tmx, tsym, targs, x)
    calls = []
    ref = fused_ops.fc_relu_ref

    def counting(xx, w, b):
        if xx.device.type != "meta":
            calls.append((tuple(xx.shape), tuple(w.shape)))
        return ref(xx, w, b)
    monkeypatch.setattr(fused_ops, "fc_relu_ref", counting)
    monkeypatch.setenv("MXNET_SUBGRAPH_BACKEND", "TPU_PALLAS")
    fused = _forward(tmx, tsym, targs, x)
    assert calls == [((4, 72), (16, 72))]
    np.testing.assert_array_equal(fused, plain)
    monkeypatch.delenv("MXNET_SUBGRAPH_BACKEND")
    jsym, jargs, _ = _quantize(jmx, jq, args, calib, "naive", ["fc0"])
    want = _forward(jmx, jsym, jargs, x)
    np.testing.assert_allclose(fused, want, rtol=FWD_TOL[0],
                               atol=FWD_TOL[1] * np.abs(want).max())


def test_quantized_convnet_close_to_fp32():
    """The JAX package's test (`tests/test_quantization.py`) in the port,
    on its normal draws: the dynamic-range int8 graph within 0.1 of the
    fp32 output's range, argmax kept on >= 0.75 of the samples."""
    rng = np.random.RandomState(3)
    args = {k: rng.normal(0, 0.5, v.shape).astype(np.float32)
            for k, v in _data(3)[0].items()}
    x = rng.normal(0, 1, (4, 3, 8, 8)).astype(np.float32)
    sym = _fresh(lambda: _net(tmx))
    params = {k: tmx.nd.array(v, ctx=CPU) for k, v in args.items()}
    ref = _forward(tmx, sym, params, x)
    qsym, qargs, _ = _fresh(lambda: tq.quantize_model(
        sym, params, {}, ctx=CPU, calib_mode="none"))
    out = _forward(tmx, qsym, qargs, x)
    assert np.abs(out - ref).max() / np.abs(ref).max() < 0.1
    assert (out.argmax(1) == ref.argmax(1)).mean() >= 0.75


def test_quantize_model_ctx_defaults_to_the_current_context():
    """Where the JAX package quantizes onto the CPU by default, the port
    quantizes onto `current_context()`: the card, unless a `with ctx:`
    block says otherwise."""
    args, _, _ = _data(4)
    sym = _fresh(lambda: _net(tmx))
    params = {k: tmx.nd.array(v, ctx=CPU) for k, v in args.items()}
    with tmx.cpu(1):
        _, qargs, _ = tq.quantize_model(sym, params, {})
    assert qargs["fc1_weight"].context == tmx.cpu(1)
    assert qargs["fc1_weight_min"].context == tmx.cpu(1)
    if not torch.cuda.is_available():
        with pytest.raises(tmx.MXNetError, match="no such CUDA device"):
            tq.quantize_model(sym, params, {})


def test_int8_params_cross_files_and_weights(tmp_path):
    """The quantized parameters through a checkpoint pair (int8, flag 5)
    and `compat.weights.params_from_numpy` keep their dtypes and values,
    and the JAX package loads the same file."""
    from incubator_mxnet_tpu_torch.compat.weights import params_from_numpy
    args, calib, _ = _data(5)
    tsym, targs, _ = _quantize(tmx, tq, args, calib, "naive", ["fc0"])
    prefix = str(tmp_path / "q")
    tmx.model.save_checkpoint(prefix, 0, tsym, targs, {})
    _, loaded, _ = tmx.model.load_checkpoint(prefix, 0)
    _, jloaded, _ = jmx.model.load_checkpoint(prefix, 0)
    carried, _ = params_from_numpy(jloaded, ctx=CPU)
    for k, v in targs.items():
        for got in (loaded[k], jloaded[k], carried[k]):
            assert got.asnumpy().dtype == v.asnumpy().dtype, k
            np.testing.assert_array_equal(got.asnumpy(), v.asnumpy())
    assert loaded["conv0_weight_min"].asnumpy().dtype == np.float32
