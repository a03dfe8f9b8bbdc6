"""Serving a partitioned VGG-shaped graph: the PyTorch port's ModelServer
against the JAX package's, on the CPU, on the same weights and requests;
plus the port's import and device contracts."""
import concurrent.futures
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch.compat.weights import params_from_numpy

IMAGE = (3, 16, 16)
BUCKETS = (1, 2, 4, 8)
SIZES = (1, 3, 2, 5, 1, 4, 8, 2, 6, 1)
# float32 through two convolutions and three FCs summed in different
# orders by XLA and torch: ~1e-6 relative to the output scale
RTOL, ATOL = 1e-5, 1e-5


def _vgg_like(mod):
    """conv-relu-pool x2, then FC-relu-dropout x2, then FC."""
    s = mod.sym
    x = s.var("data")
    for i, nf in enumerate((8, 16)):
        x = s.Convolution(x, kernel=(3, 3), pad=(1, 1), num_filter=nf,
                          name=f"conv{i}")
        x = s.Activation(x, act_type="relu", name=f"crelu{i}")
        x = s.Pooling(x, kernel=(2, 2), stride=(2, 2), pool_type="max",
                      name=f"pool{i}")
    for i in range(2):
        x = s.FullyConnected(x, num_hidden=32, name=f"fc{i}")
        x = s.Activation(x, act_type="relu", name=f"frelu{i}")
        x = s.Dropout(x, p=0.5, name=f"drop{i}")
    return s.FullyConnected(x, num_hidden=10, name="out")


def _setup():
    sym = tmx.subgraph.partition_graph(_vgg_like(tmx), "TPU_PALLAS")
    assert sym.tojson().count('"_sg_pallas_fc_relu"') == 2
    rng = np.random.RandomState(0)
    shapes, _, _ = sym.infer_shape(data=(1,) + IMAGE)
    args = {n: rng.normal(0, 0.3, s).astype(np.float32)
            for n, s in zip(sym.list_arguments(), shapes) if n != "data"}
    reqs = [rng.normal(0, 1, (n,) + IMAGE).astype(np.float32) for n in SIZES]
    return sym, args, reqs


def _serve(srv, name, reqs):
    futs = [srv.submit(name, {"data": x}) for x in reqs]
    return [f.result(120)[0].asnumpy() for f in futs]


def test_port_server_matches_jax_server(tmp_path):
    sym, args, reqs = _setup()
    # the JAX server loads the port's checkpoint pair
    targs, _ = params_from_numpy(args, None, ctx=tmx.cpu())
    tmx.save_checkpoint(str(tmp_path / "vgg"), 0, sym, targs, {})
    jsrv = jmx.serving.ModelServer(max_queue_latency_ms=20)
    jsrv.load_model("vgg", prefix=str(tmp_path / "vgg"),
                    data_shapes=[("data", (1,) + IMAGE)], buckets=BUCKETS)
    try:
        want = _serve(jsrv, "vgg", reqs)
    finally:
        jsrv.shutdown()
    srv = tmx.serving.ModelServer(max_queue_latency_ms=20, ctx=tmx.cpu())
    srv.load_model("vgg", prefix=str(tmp_path / "vgg"),
                   data_shapes=[("data", (1,) + IMAGE)], buckets=BUCKETS)
    try:
        got = _serve(srv, "vgg", reqs)
        stats = srv.stats()["vgg"]
    finally:
        srv.shutdown()
    assert stats["responses"] == len(reqs)
    assert stats["batches"] < len(reqs)          # requests were coalesced
    for x, g, w in zip(reqs, got, want):
        assert g.shape == (len(x), 10)
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


def test_served_model_infer_matches_unpartitioned_graph():
    sym, args, reqs = _setup()
    model = tmx.serving.ServedModel(sym, args, data_shapes=[
        ("data", (1,) + IMAGE)], buckets=BUCKETS, ctx=tmx.cpu())
    model.warmup()
    gfn, arg_nodes, _ = tmx.sym.graph_eval_fn(_vgg_like(tmx), False)
    feed = {k: torch.from_numpy(v) for k, v in args.items()}
    for x in reqs[:4]:
        got = model.infer({"data": x})[0]
        assert got.context == tmx.cpu() and got.shape == (len(x), 10)
        feed["data"] = torch.from_numpy(x)
        ref = gfn([feed[n.name] for n in arg_nodes], [])[0][0]
        np.testing.assert_allclose(got.asnumpy(), ref.numpy(), rtol=RTOL,
                                   atol=ATOL)


def test_served_model_requires_every_parameter():
    sym, args, _ = _setup()
    del args["fc1_weight"]
    with pytest.raises(tmx.MXNetError, match="fc1_weight"):
        tmx.serving.ServedModel(sym, args, data_shapes=[
            ("data", (1,) + IMAGE)], ctx=tmx.cpu())


def test_batcher_rejects_oversize_and_drains_on_shutdown():
    sym, args, reqs = _setup()
    srv = tmx.serving.ModelServer(max_queue_latency_ms=50, ctx=tmx.cpu())
    srv.load_model("vgg", symbol=sym, arg_params=args,
                   data_shapes=[("data", (1,) + IMAGE)], buckets=(1, 2))
    with pytest.raises(tmx.MXNetError, match="exceeds max_batch_size"):
        srv.submit("vgg", {"data": reqs[3]})          # 5 rows > 2
    futs = [srv.submit("vgg", {"data": x[:1]}) for x in reqs]
    srv.shutdown(drain=True)
    done, _ = concurrent.futures.wait(futs, timeout=60)
    assert len(done) == len(futs)
    assert all(f.result()[0].shape == (1, 10) for f in futs)
    with pytest.raises(tmx.MXNetError, match="shut down"):
        srv.load_model("again", symbol=sym, arg_params=args,
                       data_shapes=[("data", (1,) + IMAGE)])


def test_entry_points_without_ctx_need_the_card(monkeypatch, tmp_path):
    """With no GPU and no ctx=cpu(), serving raises instead of running on
    the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sym, args, _ = _setup()
    assert tmx.current_context() == tmx.gpu(0)
    with pytest.raises(tmx.MXNetError, match="no such CUDA device"):
        tmx.serving.ServedModel(sym, args,
                                data_shapes=[("data", (1,) + IMAGE)])
    targs, _ = params_from_numpy(args, None, ctx=tmx.cpu())
    tmx.save_checkpoint(str(tmp_path / "m"), 0, sym, targs, {})
    srv = tmx.serving.ModelServer()
    with pytest.raises(tmx.MXNetError, match="no such CUDA device"):
        srv.load_model("m", prefix=str(tmp_path / "m"),
                       data_shapes=[("data", (1,) + IMAGE)])
    with pytest.raises(tmx.MXNetError, match="no such CUDA device"):
        tmx.nd.array(np.zeros(3))
    assert srv.models() == []


def test_port_imports_no_jax():
    """In a fresh interpreter, importing the port (and driving a graph)
    loads neither jax nor the JAX package."""
    code = textwrap.dedent("""
        import sys
        import incubator_mxnet_tpu_torch as mx
        sym = mx.model_zoo.vgg_symbol(11)
        mx.subgraph.partition_graph(sym, "TPU_PALLAS").infer_shape(
            data=(1, 3, 32, 32))
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib",
                                            "incubator_mxnet_tpu"))
        print(bad)
        sys.exit(1 if bad else 0)
    """)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_port_sources_never_import_jax():
    root = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "incubator_mxnet_tpu_torch")
    offenders = []
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(dirpath, f)
                for line in open(path):
                    words = line.split()
                    if words[:1] in (["import"], ["from"]) and \
                            words[1].split(".")[0] in (
                                "jax", "jaxlib", "incubator_mxnet_tpu"):
                        offenders.append(f"{path}: {line.strip()}")
    assert not offenders, offenders
