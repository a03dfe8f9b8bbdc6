"""The serving path's edges in the PyTorch port against the JAX package,
on the CPU: `ServedModel.from_checkpoint_dir` and
`ModelServer.load_model(symbol_file=, checkpoint_dir=)` (a torn newer
checkpoint is never taken), the batcher's circuit breaker and execution
retries under `resilience.faults`, a `Monitor` on the request path, the
fault spec grammar, `c_predict` in Python and the C predict ABI through
the port's shim compiled with g++.

Tolerance: float32 sums in other orders through two FCs and a softmax,
rtol 1e-5, atol 1e-6 (as the JAX package's own serving tests); the
breaker's and the retries' counters are discrete and held equal.
"""
import os
import shutil
import subprocess
import time

import numpy as np
import pytest

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import resilience as jres

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import resilience as tres

RTOL, ATOL = 1e-5, 1e-6
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_faults():
    jres.clear()
    tres.clear()
    yield
    jres.clear()
    tres.clear()


def _net(pkg):
    """`tests/test_resilience.py:426`'s serving model, with a hidden
    nonlinearity."""
    s = pkg.sym
    net = s.FullyConnected(s.Variable("data"), num_hidden=8, name="fc0")
    net = s.Activation(net, act_type="tanh", name="act0")
    net = s.FullyConnected(net, num_hidden=3, name="head")
    return s.SoftmaxOutput(net, name="softmax")


def _params(seed=0):
    rng = np.random.RandomState(seed)
    return {"fc0_weight": rng.normal(0, 0.5, (8, 6)).astype("f4"),
            "fc0_bias": rng.normal(0, 0.1, 8).astype("f4"),
            "head_weight": rng.normal(0, 0.5, (3, 8)).astype("f4"),
            "head_bias": rng.normal(0, 0.1, 3).astype("f4")}


def _nd(pkg, params):
    return {k: pkg.nd.array(v, ctx=pkg.cpu()) for k, v in params.items()}


def _reference(params, x):
    h = np.tanh(x @ params["fc0_weight"].T + params["fc0_bias"])
    z = h @ params["head_weight"].T + params["head_bias"]
    e = np.exp(z - z.max(1, keepdims=True))
    return e / e.sum(1, keepdims=True)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


# -- checkpoint-directory serving --------------------------------------------

def _checkpoint_root(tmp_path):
    """A root with a valid snapshot at step 1 (`_params(0)`) and a torn,
    newer one at step 2 (`_params(1)`, its arrays shard damaged)."""
    from incubator_mxnet_tpu_torch import checkpoint as ckpt
    root = str(tmp_path / "ckpts")
    mgr = ckpt.CheckpointManager(root, async_snapshots=False)
    for step, seed in ((1, 0), (2, 1)):
        mgr.snapshot(arrays={f"arg:{k}": v for k, v in
                             _params(seed).items()}, step=step)
    mgr.close()
    newest = os.path.join(root, ckpt.manifest.checkpoint_dirname(2))
    shard = os.path.join(newest, ckpt.snapshot.ARRAYS_SHARD)
    with open(shard, "r+b") as f:
        f.seek(64)
        f.write(b"\xff" * 16)
    symbol_file = str(tmp_path / "net-symbol.json")
    _net(tmx).save(symbol_file)
    return symbol_file, root


def test_served_model_from_checkpoint_dir_skips_torn_like_jax(tmp_path):
    """`tests/test_serving.py:288` with a torn newer snapshot: both
    packages take step 1's parameters and answer alike."""
    symbol_file, root = _checkpoint_root(tmp_path)
    x = np.random.RandomState(5).randn(4, 6).astype("f4")
    got = {}
    for name, pkg in (("port", tmx), ("jax", jmx)):
        m = pkg.serving.ServedModel.from_checkpoint_dir(
            symbol_file, root, data_shapes=[("data", (1, 6))],
            buckets=(4,), ctx=pkg.cpu(), name="ckpt")
        got[name] = m.infer({"data": x})[0].asnumpy()
    _close(got["port"], _reference(_params(0), x))
    _close(got["port"], got["jax"])
    with pytest.raises(tmx.MXNetError, match="no valid checkpoint"):
        tmx.serving.ServedModel.from_checkpoint_dir(
            symbol_file, str(tmp_path / "empty"),
            data_shapes=[("data", (1, 6))], ctx=tmx.cpu())


def test_server_loads_checkpoint_dir_like_jax(tmp_path):
    """`ModelServer.load_model(name, symbol_file=, checkpoint_dir=)`
    answers requests of 1-4 rows as the JAX server does."""
    symbol_file, root = _checkpoint_root(tmp_path)
    rng = np.random.RandomState(6)
    reqs = [rng.randn(n, 6).astype("f4") for n in (1, 3, 4, 2)]
    answers = {}
    for name, pkg in (("port", tmx), ("jax", jmx)):
        with pkg.serving.ModelServer(max_queue_latency_ms=1.0,
                                     ctx=pkg.cpu()) as srv:
            srv.load_model("m", symbol_file=symbol_file,
                           checkpoint_dir=root,
                           data_shapes=[("data", (1, 6))],
                           buckets=(1, 2, 4))
            answers[name] = [srv.predict("m", {"data": x})[0].asnumpy()
                             for x in reqs]
    for x, got, want in zip(reqs, answers["port"], answers["jax"]):
        _close(got, want)
        _close(got, _reference(_params(0), x))
    with pytest.raises(tmx.MXNetError, match="needs symbol_file"):
        tmx.serving.ModelServer(ctx=tmx.cpu()).load_model(
            "m", checkpoint_dir=root, data_shapes=[("data", (1, 6))])


# -- breaker and retries -----------------------------------------------------

def _server(pkg, **knobs):
    srv = pkg.serving.ModelServer(max_queue_latency_ms=0.0, ctx=pkg.cpu())
    srv.load_model("m", symbol=_net(pkg), arg_params=_nd(pkg, _params()),
                   aux_params={}, data_shapes=[("data", (1, 6))],
                   buckets=(1, 2), **knobs)
    return srv


def _breaker_script(pkg, res):
    """`tests/test_resilience.py:467`: two failed batches open the
    breaker, submit fails fast while it is open, the probe after the
    reset window closes it.  Returns what the script observed."""
    seen = {}
    x = np.zeros((1, 6), np.float32)
    with _server(pkg, breaker_threshold=2, breaker_reset_s=0.25) as srv:
        res.inject("serving.execute", "error", n=2)
        for _ in range(2):
            with pytest.raises(pkg.MXNetError, match="fault-injected"):
                srv.predict("m", {"data": x})
        with pytest.raises(pkg.MXNetError, match="circuit breaker is open"):
            srv.submit("m", {"data": x})
        snap = srv.stats()["m"]
        seen["open"] = (snap["breaker_state"], snap["breaker_rejects"])
        time.sleep(0.3)
        seen["answer"] = srv.predict("m", {"data": x})[0].asnumpy()
        snap = srv.stats()["m"]
        seen["closed"] = (snap["breaker_state"], snap["breaker_rejects"],
                          snap["responses"])
        seen["trace"] = [(e["site"], e["kind"], e["hit"])
                         for e in res.trace()]
    return seen


def test_serving_breaker_opens_half_opens_closes_like_jax():
    port = _breaker_script(tmx, tres)
    jax = _breaker_script(jmx, jres)
    assert port["open"] == jax["open"] == ("open", 1)
    assert port["closed"] == jax["closed"] == ("closed", 1, 1)
    assert port["trace"] == jax["trace"] == [
        ("serving.execute", "error", 1), ("serving.execute", "error", 2)]
    _close(port["answer"], jax["answer"])


def _retry_script(pkg, res):
    """`tests/test_resilience.py:489`: two failed attempts, the third
    answers; the retry histogram is {1: 1, 2: 1}."""
    policy = res.RetryPolicy(max_attempts=3, base_delay=0.01, jitter=0.0)
    with _server(pkg, retry_policy=policy) as srv:
        res.inject("serving.execute", "error", n=2)
        out = srv.predict("m", {"data": np.ones((1, 6), np.float32)})
        snap = srv.stats()["m"]
        events = [e.get("event") for e in res.trace()]
    return (out[0].asnumpy(), snap["retry_histogram"], snap["breaker_state"],
            snap["responses"], events)


def test_serving_retries_land_in_histogram_like_jax():
    port = _retry_script(tmx, tres)
    jax = _retry_script(jmx, jres)
    assert port[1:] == jax[1:]
    assert port[1] == {1: 1, 2: 1} and port[2] == "closed" and port[3] == 1
    assert port[4] == ["fault", "retry", "fault", "retry"]
    _close(port[0], jax[0])
    _close(port[0], _reference(_params(), np.ones((1, 6), "f4")))


def _probe_released_script(pkg, res):
    """A half-open probe whose whole batch dies in the queue (deadline)
    before it executes hands its token back (`tests/test_resilience.py:
    335` on the batcher, JAX `serving/batcher.py:378-383`): the next
    request is the probe and closes the breaker."""
    x = np.zeros((1, 6), np.float32)
    with _server(pkg, breaker_threshold=1, breaker_reset_s=0.2) as srv:
        res.inject("serving.execute", "error", n=1)
        with pytest.raises(pkg.MXNetError, match="fault-injected"):
            srv.predict("m", {"data": x})
        time.sleep(0.25)
        batcher = srv.batcher("m")
        batcher.pause()
        doomed = srv.submit("m", {"data": x}, timeout_ms=50)   # the probe
        time.sleep(0.15)
        batcher.resume()
        with pytest.raises(pkg.MXNetError, match="deadline"):
            doomed.result(30)
        answer = srv.predict("m", {"data": x})[0].asnumpy()
        snap = srv.stats()["m"]
    return answer, snap["breaker_state"], snap["timeouts"], \
        snap["breaker_rejects"]


def test_breaker_probe_released_when_batch_dies_before_execution():
    port = _probe_released_script(tmx, tres)
    jax = _probe_released_script(jmx, jres)
    assert port[1:] == jax[1:] == ("closed", 1, 0)
    _close(port[0], jax[0])


def test_breaker_knobs_default_from_config():
    srv = _server(tmx)
    try:
        br = srv.batcher("m")._breaker
        assert (br.failure_threshold, br.reset_timeout) == (5, 30.0)
    finally:
        srv.shutdown()


# -- monitor on the request path --------------------------------------------

def _monitor_script(pkg):
    """`tests/test_serving.py:428`: the statistic sees the batched
    bucket-4 outputs."""
    seen = []

    def stat(arr):
        seen.append(tuple(arr.shape))
        return float(np.abs(arr.asnumpy()).sum())

    mon = pkg.monitor.Monitor(interval=1, stat_func=stat, pattern="softmax")
    with pkg.serving.ModelServer(max_queue_latency_ms=1.0,
                                 ctx=pkg.cpu()) as srv:
        srv.load_model("mon", symbol=_net(pkg),
                       arg_params=_nd(pkg, _params()), aux_params={},
                       data_shapes=[("data", (1, 6))], buckets=(1, 2, 4))
        srv.install_monitor("mon", mon)
        x = np.random.RandomState(2).randn(4, 6).astype("f4")
        out = srv.predict("mon", {"data": x})[0].asnumpy()
    return seen, out


def test_monitor_installs_on_request_path_like_jax():
    seen, out = _monitor_script(tmx)
    jseen, jout = _monitor_script(jmx)
    assert seen and seen[0] == (4, 3) and seen == jseen
    _close(out, jout)


# -- the fault registry ------------------------------------------------------

SPECS = (
    "serving.execute:error",
    "seed=7; transport.send:drop(at=2,cmd=push); server.dispatch:slow(ms=5)",
    "checkpoint.commit:torn(at=1-3);serving.execute:error(p=0.5,n=4)",
    "io.corrupt_record:corrupt(bytes=4,offset=2,record=3)",
)
BAD_SPECS = ("serving.execute", "serving.execute:explode",
             "serving.execute:error(n)")


@pytest.mark.parametrize("spec", SPECS)
def test_fault_spec_parses_like_jax(spec):
    assert tres.faults.parse_spec(spec) == jres.faults.parse_spec(spec)


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_bad_fault_spec_rejected_like_jax(spec):
    with pytest.raises(jmx.MXNetError):
        jres.configure(spec)
    with pytest.raises(tmx.MXNetError):
        tres.configure(spec)


def _schedule(res, spec):
    res.configure(spec, seed=3)
    fired = []
    for i in range(40):
        try:
            res.fire("serving.execute", attempt=i)
        except Exception as exc:   # the injected error
            fired.append((i, type(exc).__name__))
    return fired, [(e["site"], e["kind"], e["hit"], e["seq"])
                   for e in res.trace()]


@pytest.mark.parametrize("spec", [
    "serving.execute:error(p=0.3)",
    "serving.execute:error(at=3-5);serving.execute:error(n=2)",
    "serving.execute:corrupt(bytes=4);serving.execute:crash(at=7)",
])
def test_fault_schedule_replays_like_jax(spec):
    """The same spec and seed fire on the same hits and leave the same
    trace in both registries (a ``corrupt`` clause never fires at a
    `fire` site)."""
    port = _schedule(tres, spec)
    assert port == _schedule(jres, spec)
    assert port == _schedule(tres, spec)   # a rerun replays it


def test_fault_log_lines(tmp_path, monkeypatch):
    import json
    log = tmp_path / "faults.jsonl"
    monkeypatch.setenv("MXNET_FAULTS", "serving.execute:error(n=1)")
    monkeypatch.setenv("MXNET_FAULTS_LOG", str(log))
    monkeypatch.setattr(tres.faults, "ACTIVE", None)
    monkeypatch.setattr(tres.faults, "_clauses", [])
    monkeypatch.setattr(tres.faults, "_log_path", None)
    with pytest.raises(tmx.MXNetError, match="fault-injected"):
        tres.fire("serving.execute", model="m")
    tres.fire("serving.execute", model="m")
    lines = [json.loads(l) for l in log.read_text().splitlines()]
    assert len(lines) == 1 and lines[0]["site"] == "serving.execute"
    assert lines[0]["pid"] == os.getpid() and lines[0]["ctx"] == {
        "model": "m"}


# -- c_predict ---------------------------------------------------------------

def _export(tmp_path, pkg=tmx):
    """The serving net's checkpoint pair: (symbol JSON, params bytes)."""
    prefix = str(tmp_path / "model")
    tmx.model.save_checkpoint(prefix, 0, _net(tmx), _nd(tmx, _params()), {})
    with open(prefix + "-symbol.json") as f:
        symbol_json = f.read()
    with open(prefix + "-0000.params", "rb") as f:
        param_bytes = f.read()
    return prefix, symbol_json, param_bytes


def test_c_predict_matches_jax_predictor(tmp_path):
    """`tests/test_serving.py:264`: create, set_input, forward, output."""
    from incubator_mxnet_tpu import c_predict as jcp
    from incubator_mxnet_tpu_torch import c_predict as tcp
    _, symbol_json, param_bytes = _export(tmp_path)
    x = np.random.RandomState(3).randn(4, 6).astype("f4")
    outs = []
    for cp in (tcp, jcp):
        pred = cp.create(symbol_json, param_bytes, 1, 0, ["data"], [(4, 6)],
                         programs_dir=str(tmp_path / "unused"))
        pred.set_input("data", x.ravel())
        pred.forward()
        assert pred.output_shape(0) == (4, 3) and pred.output_count() == 1
        outs.append(np.frombuffer(pred.output(0), np.float32).reshape(4, 3))
    _close(outs[0], outs[1])
    _close(outs[0], _reference(_params(), x))


def test_c_predict_inputs_without_shared_batch_axis(tmp_path):
    """`tests/test_serving.py:398`: the inputs need not agree on a batch
    axis; the JAX Predictor answers the same."""
    from incubator_mxnet_tpu import c_predict as jcp
    from incubator_mxnet_tpu_torch import c_predict as tcp
    net = tmx.sym.broadcast_mul(tmx.sym.Variable("data"),
                                tmx.sym.Variable("scale"))
    tmx.nd.save(str(tmp_path / "none.params"), {})
    params = (tmp_path / "none.params").read_bytes()
    rng = np.random.RandomState(4)
    x, s = rng.randn(4, 6).astype("f4"), rng.randn(1, 6).astype("f4")
    outs = []
    for cp in (tcp, jcp):
        pred = cp.create(net.tojson(), params, 1, 0, ["data", "scale"],
                         [(4, 6), (1, 6)])
        pred.set_input("data", x.ravel())
        pred.set_input("scale", s.ravel())
        pred.forward()
        outs.append(np.frombuffer(pred.output(0), np.float32).reshape(4, 6))
    _close(outs[0], x * s)
    _close(outs[0], outs[1])


def test_c_predict_dev_types(tmp_path):
    """1 is the CPU, 2 the card (raises here: no card, no fallback), any
    other value raises."""
    from incubator_mxnet_tpu_torch import c_predict as tcp
    _, symbol_json, param_bytes = _export(tmp_path)
    with pytest.raises(tmx.MXNetError, match="dev_type 7"):
        tcp.create(symbol_json, param_bytes, 7, 0, ["data"], [(4, 6)])
    with pytest.raises(tmx.MXNetError, match="no such CUDA device"):
        tcp.create(symbol_json, param_bytes, 2, 0, ["data"], [(4, 6)])


# -- the C shim --------------------------------------------------------------



def _c_input(shape):
    n = int(np.prod(shape))
    i = np.arange(n, dtype=np.uint64)
    return ((i * 7919) % 1000).astype(np.float32).reshape(shape) * \
        np.float32(0.001)


def _libpython_missing():
    from incubator_mxnet_tpu_torch import native
    try:
        native._libpython()
    except RuntimeError as e:
        return str(e)
    return None


@pytest.mark.skipif(shutil.which("g++") is None, reason="no g++")
@pytest.mark.skipif(_libpython_missing() is not None,
                    reason="no shared libpython to embed")
def test_c_shim_program_matches_jax_predictor(tmp_path):
    """The shim built at first use, a C program compiled against it with
    g++: its outputs equal the JAX `Predictor`'s in process; dev_type 7
    returns -1 with the error message; the embedded interpreter imports
    neither jax nor the JAX package."""
    from incubator_mxnet_tpu import c_predict as jcp
    from incubator_mxnet_tpu_torch import native
    prefix, symbol_json, param_bytes = _export(tmp_path)
    lib = native.build_predict()
    assert str(lib).startswith(os.path.join(ROOT, "build", "predict"))
    exe = tmp_path / "main"
    subprocess.run(["g++", "-x", "c++", str(native.PREDICT_EXAMPLE),
                    "-o", str(exe),
                    *native.predict_flags(lib)], check=True, timeout=120)
    env = dict(os.environ, PYTHONPATH=ROOT, PYTHONPROFILEIMPORTTIME="1")
    env.pop("PYTHONHOME", None)

    def run(dev_type):
        return subprocess.run(
            [str(exe), prefix + "-symbol.json", prefix + "-0000.params",
             str(dev_type), "4", "6"], capture_output=True, text=True,
            timeout=300, env=env, cwd=str(tmp_path))

    res = run(1)
    assert res.returncode == 0, res.stdout + res.stderr[-3000:]
    lines = res.stdout.strip().splitlines()
    assert lines[0] == "shape 4x3", lines
    got = np.array([float(v) for v in lines[1].split()]).reshape(4, 3)
    x = _c_input((4, 6))
    pred = jcp.create(symbol_json, param_bytes, 1, 0, ["data"], [(4, 6)])
    pred.set_input("data", x.ravel())
    pred.forward()
    want = np.frombuffer(pred.output(0), np.float32).reshape(4, 3)
    _close(got, want)
    imported = {line.rsplit("|", 1)[-1].strip().split(".")[0]
                for line in res.stderr.splitlines()
                if line.startswith("import time:") and "|" in line}
    assert "incubator_mxnet_tpu_torch" in imported
    assert not imported & {"jax", "jaxlib", "incubator_mxnet_tpu"}
    bad = run(7)
    assert bad.returncode == 3 and "dev_type 7" in bad.stdout, bad.stdout
