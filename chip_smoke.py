#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`incubator_mxnet_tpu_torch`).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and the script
exits non-zero:

1. device — the card's name and power limit (nvidia-smi); TF32 off for
   matmuls and cuDNN, so every fp32 comparison below is fp32.
2. build — every CUDA source of the port, with nvcc, one process each.
3. kernel K1 (`fc_relu`) against its plain PyTorch version on the card,
   at the VGG-16 classifier shapes for every serving bucket and a ragged
   MLP shape, fp32 and bf16;
   times of the kernel, the plain version and one library call beside the
   bound, with L2 flushed before every timed launch.
4. serve VGG-16 at full width (3x224x224, 1000 classes, fp32, random
   weights from a seed) through `serving.ModelServer`: partition with
   TPU_PALLAS, save a checkpoint pair, load it, answer a closed-loop load
   of mixed-size requests from concurrent clients, then one request at a
   time of sizes that reach every bucket; check each answer against the
   unpartitioned graph on the card, and check that K1 ran twice per
   dispatched batch; then print the device time by kernel of one
   bucket-32 dispatch and the device's busy share (torch.profiler).

The last two lines are a JSON object of per-kernel measurements and the
result line ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
without the port's package beside it, the script exits non-zero and
prints no result.  It takes no arguments.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

SEED = 0
VGG_FC_SHAPES = ((25088, 4096), (4096, 4096))   # (K, N) of fc6, fc7
BUCKETS = (1, 2, 4, 8, 16, 32)
IMAGE = (3, 224, 224)
CLASSES = 1000
# the load: CLIENTS threads, each sending REQUESTS_PER_CLIENT requests of
# 1-8 rows one after another (a closed loop); then one request at a time
# of SOLO_ROWS rows, each dispatched alone into its own bucket
CLIENTS = 32
REQUESTS_PER_CLIENT = 24
SOLO_ROWS = (1, 2, 3, 5, 12, 27)        # buckets 1, 2, 4, 8, 16, 32
# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s; FLOP/s by type
# (fp32 on the CUDA cores, bf16 on the tensor cores)
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
# fp32: the kernel and the plain version add the same fp32 products in
# different orders; with unit-scale outputs over K <= 25088 terms the
# rounding difference is ~1e-5.  bf16: both round an fp32 sum to bf16,
# which may land one bf16 ulp (2**-8 relative) apart.
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2.0 ** -6, 1e-4)}
# serving vs the unpartitioned graph: the padded bucket and the exact
# request batch let cuDNN pick different fp32 conv algorithms, whose
# rounding compounds over 16 layers
SERVE_TOL = (1e-3, 1e-3)
# the JSON line's shape: fc6 at bucket 32, the bucket of the served load
REP = (32, 25088, 4096, torch.float32)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def within(got, ref, rtol, atol_scale):
    """max |got - ref| and whether |got - ref| <= rtol*|ref| +
    atol_scale*max|ref| everywhere (compared in got's dtype)."""
    diff = (got.float() - ref.float()).abs()
    bound = rtol * ref.float().abs() + atol_scale * ref.float().abs().max()
    return diff.max().item(), bool((diff <= bound).all())


def time_ms(fn, flush, iters=20):
    """Mean device time of fn() over `iters` launches, each timed with its
    own CUDA events after the L2 cache is overwritten."""
    for _ in range(3):
        fn()
    events = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


def bound(m, k, n, dtype):
    """(least ms the card needs for relu(x @ w.T + b), "bytes" or
    "operations"): each input read once and the output written once at
    the HBM rate, against 2*M*N*K operations at the type's peak."""
    item = torch.tensor([], dtype=dtype).element_size()
    t_bytes = (m * k + n * k + n + m * n) * item / HBM_BYTES_S * 1e3
    t_ops = 2 * m * n * k / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_phase(card):
    from incubator_mxnet_tpu_torch.subgraph.fused_ops import fc_relu, \
        fc_relu_ref
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    cases = [(m, k, n) for k, n in VGG_FC_SHAPES for m in BUCKETS]
    cases.append((5, 784, 128))
    rep = None
    for dtype in (torch.float32, torch.bfloat16):
        rtol, atol = TOL[dtype]
        for m, k, n in cases:
            x = torch.randn(m, k, generator=gen, device=dev).to(dtype)
            w = (torch.randn(n, k, generator=gen, device=dev)
                 / math.sqrt(k)).to(dtype)
            b = (0.1 * torch.randn(n, generator=gen, device=dev)).to(dtype)
            before = fc_relu.launches
            got = fc_relu(x, w, b)
            torch.cuda.synchronize()
            check(fc_relu.launches == before + 1,
                  f"fc_relu launch counter did not move at {(m, k, n)}")
            ref = fc_relu_ref(x, w, b)
            check(got.dtype == dtype and got.shape == (m, n),
                  f"fc_relu output {got.dtype} {tuple(got.shape)}")
            err, ok = within(got, ref, rtol, atol)
            print(f"K1 parity {str(dtype)[6:]:8s} M={m:<3d} K={k:<6d} "
                  f"N={n:<5d} max_abs_err={err:.3e} "
                  f"(rtol {rtol:g}, atol {atol:g}*max|plain|) "
                  f"{'ok' if ok else 'FAIL'}")
            check(ok, f"fc_relu disagrees with its plain version at "
                      f"{(m, k, n)} {dtype}")
            if (m, k) == (5, 784):
                continue
            t_bound, bound_by = bound(m, k, n, dtype)
            t = {
                "ms": time_ms(lambda: fc_relu(x, w, b), flush),
                "plain_ms": time_ms(lambda: fc_relu_ref(x, w, b), flush),
                "library_ms": time_ms(
                    lambda: torch.relu(torch.addmm(b, x, w.T)), flush),
                "bound_ms": t_bound,
            }
            print(f"K1 time   {str(dtype)[6:]:8s} M={m:<3d} K={k:<6d} "
                  f"N={n:<5d} kernel_ms={t['ms']:.4f} "
                  f"plain_ms={t['plain_ms']:.4f} "
                  f"library_ms={t['library_ms']:.4f} "
                  f"bound_ms={t['bound_ms']:.4f} ({bound_by}) [{card}]")
            if (m, k, n, dtype) == REP:
                rep = dict(t, bound_by=bound_by, max_abs_err=err)
    del flush
    return rep


def vgg_params(sym, rng):
    """He-scaled random weights for every argument but ``data``."""
    shapes, _, _ = sym.infer_shape(data=(1,) + IMAGE)
    params = {}
    for name, shape in zip(sym.list_arguments(), shapes):
        if name == "data":
            continue
        if name.endswith("_bias"):
            params[name] = np.zeros(shape, np.float32)
        else:
            fan_in = int(np.prod(shape[1:]))
            params[name] = (rng.standard_normal(shape)
                            * math.sqrt(2.0 / fan_in)).astype(np.float32)
    return params


def profile_dispatch(model, card, bucket=32, reps=3):
    """Device time by kernel over `reps` warm dispatches of one full
    bucket (torch.profiler), and the device's busy share of that window."""
    from torch.profiler import ProfilerActivity, profile
    arrs = [np.zeros((bucket,) + IMAGE, np.float32)]
    model.run_bucket(arrs, bucket)
    model.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            model.run_bucket(arrs, bucket)
        model.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    check(spans, "the profiler saw no device activity")
    by_name = {}
    busy = 0.0
    edge = -math.inf
    for start, end, name in spans:
        by_name[name] = by_name.get(name, 0.0) + (end - start)
        busy += max(0.0, end - max(start, edge))
        edge = max(edge, end)
    total = sum(by_name.values())
    print(f"profile: bucket {bucket}, {reps} dispatches, "
          f"{wall_us / reps / 1e3:.2f} ms each on the host clock, device "
          f"busy {busy / wall_us:.3f} of the window [{card}]")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        print(f"profile: {us / reps / 1e3:9.3f} ms/dispatch "
              f"{us / total:6.3f} {name[:100]}")
    k1 = sum(us for name, us in by_name.items()
             if "fc_relu_kernel" in name or "splitk_epilogue" in name)
    print(f"profile: K1 (fc_relu_kernel + splitk_epilogue) "
          f"{k1 / reps / 1e3:.3f} ms/dispatch, {k1 / total:.3f} of device "
          "time")


def serve_phase(card, workdir):
    """Serve VGG-16 through ModelServer on gpu(0); returns the K1
    launches of the run (warm-up included)."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch.subgraph.fused_ops import fc_relu

    rng = np.random.RandomState(SEED)
    sym = mx.model_zoo.vgg_symbol(16, classes=CLASSES)
    part = mx.subgraph.partition_graph(sym, "TPU_PALLAS")
    fused = [n["op"] for n in json.loads(part.tojson())["nodes"]
             ].count("_sg_pallas_fc_relu")
    check(fused == 2, f"TPU_PALLAS fused {fused} FC+ReLU chains, want 2")
    t0 = time.perf_counter()
    params = vgg_params(sym, rng)
    print(f"serve: VGG-16 {sum(p.size for p in params.values())} "
          f"parameters from RandomState({SEED}) in "
          f"{time.perf_counter() - t0:.1f} s")
    load = [[rng.rand(rng.randint(1, 9), *IMAGE).astype(np.float32)
             for _ in range(REQUESTS_PER_CLIENT)] for _ in range(CLIENTS)]
    solo = [rng.rand(r, *IMAGE).astype(np.float32) for r in SOLO_ROWS]
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        prefix = os.path.join(tmp, "vgg")
        mx.save_checkpoint(prefix, 0, part, params, {})
        srv = mx.serving.ModelServer(max_queue_latency_ms=5.0, ctx=mx.gpu(0))
        fc_relu.launches = 0
        t0 = time.perf_counter()
        srv.load_model("vgg", prefix=prefix,
                       data_shapes=[("data", (1,) + IMAGE)], buckets=BUCKETS)
        print(f"serve: load + warmup of {len(BUCKETS)} buckets "
              f"{time.perf_counter() - t0:.1f} s")

        def ask(x):
            return srv.predict("vgg", {"data": x},
                               timeout_ms=600_000)[0].asnumpy()

        answers = [[None] * REQUESTS_PER_CLIENT for _ in range(CLIENTS)]
        errors = []
        gate = threading.Barrier(CLIENTS + 1)

        def client(c):
            gate.wait()
            try:
                for i, x in enumerate(load[c]):
                    answers[c][i] = ask(x)
            except Exception as exc:   # reported below, fails the run
                errors.append(repr(exc))

        threads = [threading.Thread(target=client, args=(c,),
                                    name=f"chip-smoke-client-{c}")
                   for c in range(CLIENTS)]
        for th in threads:
            th.start()
        gate.wait()
        t0 = time.perf_counter()
        for th in threads:
            th.join(600)
        wall = time.perf_counter() - t0
        check(not errors, f"requests failed: {errors[:3]}")
        check(not any(th.is_alive() for th in threads), "a client hung")
        stats = srv.stats()["vgg"]
        solo_answers = [ask(x) for x in solo]
        solo_batches = srv.stats()["vgg"]["batches"] - stats["batches"]
        launches = fc_relu.launches
        profile_dispatch(srv.model("vgg"), card)
        srv.shutdown(drain=True)
    check(solo_batches == len(solo),
          f"{len(solo)} lone requests ran as {solo_batches} batches")
    batches = stats["batches"] + solo_batches
    expect = 2 * (len(BUCKETS) + batches)
    print(f"serve: {stats['batches']} batches for {CLIENTS * REQUESTS_PER_CLIENT}"
          f" requests, then {solo_batches} lone requests of "
          f"{', '.join(map(str, SOLO_ROWS))} rows (buckets "
          f"{', '.join(str(min(b for b in BUCKETS if b >= r)) for r in SOLO_ROWS)}"
          f"); K1 launches {launches}, expected 2 x ({len(BUCKETS)} warmup "
          f"+ {batches}) = {expect}")
    check(launches == expect, "K1 did not run twice per dispatched batch")

    # every answer against the unpartitioned graph (plain FC path)
    device = torch.device("cuda", 0)
    gfn, arg_nodes, _ = mx.sym.graph_eval_fn(sym, False)
    weights = {k: torch.from_numpy(v).to(device) for k, v in params.items()}
    worst = 0.0
    rtol, atol = SERVE_TOL
    pairs = [(x, got) for xs, gots in zip(load, answers)
             for x, got in zip(xs, gots)] + list(zip(solo, solo_answers))
    with torch.inference_mode():
        for x, got in pairs:
            feed = dict(weights, data=torch.from_numpy(x).to(device))
            ref = gfn([feed[n.name] for n in arg_nodes], [])[0][0]
            check(got.shape == (x.shape[0], CLASSES)
                  and np.isfinite(got).all(),
                  f"answer shape {got.shape} or non-finite values")
            err, ok = within(torch.from_numpy(got), ref.cpu(), rtol, atol)
            worst = max(worst, err)
            check(ok, f"served answer disagrees with the unpartitioned "
                      f"graph (max abs err {err:.3e})")
    rows = sum(len(x) for xs in load for x in xs)
    print(f"serve: {len(pairs)} answers match the unpartitioned graph, "
          f"max_abs_err {worst:.3e} (rtol {rtol:g}, atol {atol:g}*max|ref|)")
    print(f"serve: load of {CLIENTS} closed-loop clients: {rows} images in "
          f"{stats['responses']} requests over {wall:.3f} s = "
          f"{rows / wall:.1f} images/s, p50 {stats['p50_ms']:.1f} ms, "
          f"p99 {stats['p99_ms']:.1f} ms, batch occupancy "
          f"{stats['batch_occupancy']:.3f} [{card}]")
    return launches


def main():
    if sys.argv[1:]:
        print(f"usage: python3 chip_smoke.py (takes no arguments; got "
              f"{' '.join(sys.argv[1:])})", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from incubator_mxnet_tpu_torch.kernels import _build

    card = card_line()
    print(f"device: {card}")
    print(f"device: torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("device: TF32 off for matmul and cuDNN (fp32 comparisons are fp32)")

    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {', '.join(_build.SOURCES)} in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, log in _build.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"build: {name}: {line.strip()}")

    rep = kernel_phase(card)
    launches = serve_phase(card, str(_build.BUILD_DIR.parent))

    print(f"card: {card}")
    m, k, n, _ = REP
    print(json.dumps({"kernels": [{
        "name": "fc_relu", "route": "cuda",
        "source": "incubator_mxnet_tpu_torch/csrc/fc_relu.cu",
        "replaces": "incubator_mxnet_tpu/subgraph/fused_ops.py:29",
        "launches": launches, "max_abs_err": rep["max_abs_err"],
        "ms": rep["ms"], "plain_ms": rep["plain_ms"],
        "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
        "library_ms": rep["library_ms"],
        "shape": f"float32 M={m} K={k} N={n}"}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
