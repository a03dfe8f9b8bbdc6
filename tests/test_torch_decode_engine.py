"""The port's continuous-batching decode engine (`serving/decode.py`)
against the JAX package's on the CPU: continuations on one trace,
admission and eviction, priority order, the signature counts after
warmup, kill semantics, weight swaps and the load signals; and the
serving pieces it rests on, the per-class `ServingMetrics` counters and
the ``MXNET_DECODE_*`` knobs.  (The router's failover over
`DecodeReplica`s waits for the port's router.)

Continuations are token ids: held equal, no tolerance.
"""
import time

import numpy as np
import pytest

from concurrent.futures import wait as _wait

from incubator_mxnet_tpu import config as jconfig
from incubator_mxnet_tpu import llm as jllm
from incubator_mxnet_tpu import serving as jserving
from incubator_mxnet_tpu.serving.metrics import ServingMetrics as JMetrics

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import config as tconfig
from incubator_mxnet_tpu_torch import llm as tllm
from incubator_mxnet_tpu_torch.serving import (DecodeEngine, DecodeReplica,
                                               ReplicaLostError)
from incubator_mxnet_tpu_torch.serving.metrics import ServingMetrics

BUCKETS = (4, 8)
CPU = tmx.cpu()


def _cfg(pkg_llm=tllm, **kw):
    base = dict(vocab_size=32, num_layers=2, num_heads=2, hidden=8,
                ffn_mult=2, max_len=24, eos_id=0)
    base.update(kw)
    return pkg_llm.LMConfig(**base)


def _params(cfg, seed=0):
    """Random parameters under the llm.model naming scheme (the decode
    plane only needs names + shapes, not trained weights)."""
    rng = np.random.default_rng(seed)
    c, f = cfg.hidden, cfg.hidden * cfg.ffn_mult
    mk = lambda *s: rng.standard_normal(s).astype(np.float32) * 0.5  # noqa: E731
    p = {"lm_embed_weight": mk(cfg.vocab_size, c),
         "lm_final_ln_gamma": np.ones((c,), np.float32),
         "lm_final_ln_beta": np.zeros((c,), np.float32)}
    for i in range(cfg.num_layers):
        pre = "lm_block%d_" % i
        p[pre + "ln1_gamma"] = np.ones((c,), np.float32)
        p[pre + "ln1_beta"] = np.zeros((c,), np.float32)
        p[pre + "qkv_weight"] = mk(3 * c, c)
        p[pre + "qkv_bias"] = np.zeros((3 * c,), np.float32)
        p[pre + "out_proj_weight"] = mk(c, c)
        p[pre + "out_proj_bias"] = np.zeros((c,), np.float32)
        p[pre + "ln2_gamma"] = np.ones((c,), np.float32)
        p[pre + "ln2_beta"] = np.zeros((c,), np.float32)
        p[pre + "fc1_weight"] = mk(f, c)
        p[pre + "fc1_bias"] = np.zeros((f,), np.float32)
        p[pre + "fc2_weight"] = mk(c, f)
        p[pre + "fc2_bias"] = np.zeros((c,), np.float32)
    return p


def _engine(**kw):
    cfg = _cfg()
    kw.setdefault("slots", 4)
    kw.setdefault("buckets", BUCKETS)
    return cfg, DecodeEngine(cfg, _params(cfg), ctx=CPU, **kw)


def _trace():
    """Prompts of 1-8 tokens (both buckets), budgets of 1-9 tokens."""
    rng = np.random.default_rng(11)
    return [([int(t) for t in rng.integers(1, 32, 1 + (i * 5) % 8)],
             1 + (i * 7) % 9) for i in range(14)]


def _run(engine, trace):
    futs = [engine.submit(toks, max_new_tokens=new, rid="t%d" % i,
                          priority=("interactive", "batch",
                                    "best_effort")[i % 3])
            for i, (toks, new) in enumerate(trace)]
    done, not_done = _wait(futs, timeout=120.0)
    assert not not_done
    return {f.result(0)["rid"]: f.result(0)["tokens"] for f in futs}


def test_continuations_equal_the_jax_engine():
    """One trace through both engines (slots 3, two buckets, EOS id 0
    live): every sequence's continuation is the JAX package's."""
    trace = _trace()
    cfg = _cfg()
    params = _params(cfg, seed=3)
    eng = DecodeEngine(cfg, params, slots=3, buckets=BUCKETS, ctx=CPU)
    ref = jserving.DecodeEngine(_cfg(jllm), params, slots=3,
                                buckets=BUCKETS, name="t-port-ref")
    try:
        got, want = _run(eng, trace), _run(ref, trace)
    finally:
        eng.close(drain=False)
        ref.close(drain=False)
    assert got == want
    lengths = [len(v) for v in got.values()]
    assert min(lengths) < max(lengths)   # budgets and EOS both evict
    assert eng.stats()["admitted"] == eng.stats()["evicted"] == len(trace)


def test_submit_resolves_generated_continuations():
    cfg, eng = _engine()
    try:
        futs = [eng.submit([1 + (i % 5), 2, 3], max_new_tokens=4,
                           rid="r%d" % i) for i in range(6)]
        done, not_done = _wait(futs, timeout=60.0)
        assert not not_done
        for i, f in enumerate(futs):
            out = f.result(0)
            assert out["rid"] == "r%d" % i
            assert 1 <= len(out["tokens"]) <= 4
            assert all(0 <= t < cfg.vocab_size for t in out["tokens"])
        st = eng.stats()
        assert st["admitted"] == st["evicted"] == 6
        assert sorted(st["executed_rids"]) == sorted(
            "r%d" % i for i in range(6))
    finally:
        eng.close(drain=False)


def test_ladder_reject_is_failed_future_not_engine_death():
    cfg, eng = _engine()
    try:
        too_long = eng.submit(list(range(1, 12)))   # > largest bucket
        with pytest.raises(tmx.MXNetError):
            too_long.result(5.0)
        no_room = eng.submit([1, 2], max_new_tokens=cfg.max_len)
        with pytest.raises(tmx.MXNetError):
            no_room.result(5.0)
        assert eng.stats()["rejected"] == 2
        assert eng.metrics.snapshot()["rejected"] == 2
        ok = eng.submit([1, 2, 3], max_new_tokens=2)
        assert len(ok.result(30.0)["tokens"]) <= 2
    finally:
        eng.close(drain=False)


def test_priority_classes_order_the_queue():
    _, eng = _engine(start=False)   # no worker: inspect raw queue order
    eng.submit([1], 2, priority="best_effort", rid="be")
    eng.submit([1], 2, priority="batch", rid="b1")
    eng.submit([1], 2, priority="interactive", rid="i1")
    eng.submit([1], 2, priority="batch", rid="b2")
    eng.submit([1], 2, priority=0, rid="i2")   # router-style rank int
    assert [p.rid for p in eng._queue] == ["i1", "i2", "b1", "b2", "be"]
    with pytest.raises(tmx.MXNetError, match="priority"):
        eng.submit([1], 2, priority="urgent")


def test_signature_counts_unchanged_after_warmup():
    """Warmup calls one prefill per bucket + one step; an arbitrary
    interleaving of prompt lengths afterwards adds no signature, and a
    call off the ladder adds one to both counts."""
    cfg, eng = _engine()
    try:
        after_warmup = eng.programs.compile_count()
        assert eng.programs.program_count() == len(BUCKETS) + 1 \
            == after_warmup
        futs = [eng.submit([1 + (i % 7)] * (1 + (i * 3) % 8),
                           max_new_tokens=1 + (i % 6))
                for i in range(10)]
        done, not_done = _wait(futs, timeout=60.0)
        assert not not_done
        assert eng.programs.compile_count() == after_warmup
        assert eng.programs.program_count() == len(BUCKETS) + 1
        assert eng.stats()["programs"] == len(BUCKETS) + 1
    finally:
        eng.close(drain=False)
    ck, cv = tllm.init_kv_cache(cfg, eng.slots, CPU)
    eng.programs.prefill(eng.programs.params, ck, cv,
                         np.zeros((1, 5), np.int32), 0, 3)
    assert eng.programs.program_count() == len(BUCKETS) + 2
    assert eng.programs.compile_count() == after_warmup + 1


def test_kill_fails_queued_and_inflight_with_replica_lost():
    _, eng = _engine(slots=2, admit_per_tick=1)
    futs = [eng.submit([1, 2], max_new_tokens=20, rid="k%d" % i)
            for i in range(6)]
    deadline = time.monotonic() + 30.0
    while eng.stats()["slots_active"] == 0:   # wait until decode started
        assert time.monotonic() < deadline
        time.sleep(0.005)
    eng.kill()
    lost = 0
    for f in futs:
        try:
            f.result(10.0)
        except ReplicaLostError as exc:
            assert exc.replica_id == eng.name
            lost += 1
    assert lost >= 1          # at least the in-flight slots died loudly
    assert eng.stats()["dead"]
    with pytest.raises(ReplicaLostError):
        eng.submit([1], max_new_tokens=2)


def test_close_drains_then_refuses():
    _, eng = _engine()
    futs = [eng.submit([1, 2, 3], max_new_tokens=3) for _ in range(5)]
    eng.close(drain=True)
    assert all(f.done() and len(f.result(0)["tokens"]) == 3 for f in futs)
    with pytest.raises(ReplicaLostError):
        eng.submit([1], max_new_tokens=2)


def test_replica_swap_adds_no_signature_and_bumps_version(tmp_path):
    cfg = _cfg()
    rep = DecodeReplica(cfg, _params(cfg), replica_id="swap0",
                        slots=2, buckets=BUCKETS, ctx=CPU)
    try:
        before = rep.engine.programs.compile_count()
        assert rep.ready_info == {"compiles": before, "programs": before}
        assert rep.heartbeat()
        first = rep.probe()["tokens"]
        assert rep.swap(arg_params=_params(cfg, seed=7)) == 1
        assert rep.probe()["tokens"]   # serves on the new weights
        assert rep.engine.programs.compile_count() == before
        assert rep.stats()["version"] == 1
        with pytest.raises(tmx.MXNetError, match="no valid checkpoint"):
            rep.swap(checkpoint_dir="/nonexistent")
        assert first and rep.version == 1
        # an elastic checkpoint directory: its newest valid arg: arrays
        from incubator_mxnet_tpu_torch import checkpoint
        arrays = {"arg:" + k: v for k, v in _params(cfg, seed=7).items()}
        mgr = checkpoint.CheckpointManager(str(tmp_path))
        mgr.snapshot(arrays=arrays, step=3, sync=True)
        mgr.close()
        assert rep.swap(checkpoint_dir=str(tmp_path)) == 2
        assert rep.probe()["tokens"]
        assert rep.engine.programs.compile_count() == before
    finally:
        rep.close(drain=False)
    with pytest.raises(ReplicaLostError):
        rep.heartbeat()


def test_load_signals_match_jax():
    _, eng = _engine(start=False, slots=2)
    cfg = _cfg(jllm)
    ref = jserving.DecodeEngine(cfg, _params(cfg), slots=2, buckets=BUCKETS,
                                start=False, name="t-port-load")
    for e in (eng, ref):
        assert e.outstanding() == 0
        assert e.estimated_wait_s() == 0.0
        for i in range(3):
            e.submit([1, 2], 2, rid="w%d" % i)
        assert e.outstanding() == 3
        e._tick_s_ewma = 0.01    # pretend we have a measured tick rate
    assert eng.estimated_wait_s() == pytest.approx(ref.estimated_wait_s())
    assert eng.estimated_wait_s() > 0.0


def test_serving_metrics_per_class_counters_match_jax():
    """The same responses into both packages' ServingMetrics, some with
    a class: the same per-class counts and latency percentiles (the
    per-class reservoirs are seeded alike, so past their capacity they
    keep the same samples)."""
    rng = np.random.default_rng(5)
    # window 512: each class keeps a reservoir of 256 samples
    got, want = ServingMetrics("m", window=512), \
        JMetrics("t-port-metrics", window=512)
    classes = ("interactive", "batch", "best_effort")
    for i in range(1500):
        cls = classes[int(rng.integers(0, 3))] if i % 5 else None
        lat = float(rng.exponential(0.02))
        for m in (got, want):
            m.record_response(lat, cls=cls)
    a, b = got.snapshot(), want.snapshot()
    assert sorted(a["classes"]) == sorted(b["classes"]) == sorted(classes)
    for cls, rec in a["classes"].items():
        assert rec == {k: b["classes"][cls][k] for k in rec}
        assert rec["responses"] > 256    # past the reservoir's capacity
    for key in ("responses", "p50_ms", "p99_ms"):
        assert a[key] == pytest.approx(b[key])
    assert "classes" not in ServingMetrics("empty").snapshot()


@pytest.mark.parametrize("name,raw", [
    ("MXNET_DECODE_SLOTS", "5"), ("MXNET_DECODE_BUCKETS", "4,16"),
    ("MXNET_DECODE_ADMIT_PER_TICK", "3"), ("MXNET_DECODE_MAX_NEW", "7"),
    ("MXNET_DECODE_SLOTS", "x")])
def test_decode_knobs_match_jax(monkeypatch, name, raw):
    monkeypatch.delenv(name, raising=False)
    assert tconfig.get(name) == jconfig.get(name)
    monkeypatch.setenv(name, raw)
    assert tconfig.get(name) == jconfig.get(name)
    cfg = _cfg(max_len=64)    # the default ladder reaches 32
    eng = DecodeEngine(cfg, _params(cfg), start=False, ctx=CPU)
    ref = jserving.DecodeEngine(_cfg(jllm, max_len=64), _params(cfg),
                                start=False, name="t-port-knob")
    assert (eng.slots, eng.buckets, eng.admit_per_tick,
            eng.max_new_default) == (ref.slots, ref.buckets,
                                     ref.admit_per_tick, ref.max_new_default)


def test_engine_defaults_to_the_card():
    """Without ctx the engine's parameters go to the card: on a machine
    without one that is an error, never a quiet CPU run."""
    if tmx.num_gpus():
        pytest.skip("a card is present; the CPU-only behaviour is moot")
    cfg = _cfg()
    with pytest.raises(tmx.MXNetError, match="CUDA"):
        DecodeEngine(cfg, _params(cfg), buckets=BUCKETS, start=False)
