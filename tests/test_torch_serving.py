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
    """In a fresh interpreter, importing the port (every module, through
    the package) and driving a graph, a gluon network (the model zoo's
    ResNet, imperatively and composed), a Module.fit through the fused
    train step, an Estimator.fit through the gluon fused step, a
    Module.fit from a .rec through ImageRecordIter, ImageNormalize and
    the h2d ring, a bucketed LSTM's BucketingModule.fit, a gluon LSTM,
    and the SSD's graph (detection ops, MakeLoss, smooth_l1) bound and
    stepped, with ImageDetIter over a .rec, and a one-worker dist_sync
    round trip and a sharded embedding table's lookup and push on the
    port's parameter servers (kvstore, dist, embedding, kvstore_server),
    and the C predict ABI's Python side, fault injection and the test
    utilities, and slice 15's gluon (AlexNet through Module.fit with K1
    nodes, SqueezeNet exported and imported as a SymbolBlock, CTCLoss, a
    contrib conv-LSTM cell), and slice 18's serving fleet (router,
    replicas, worker, hostd, fleet, the embedding serving path), and
    slice 19's telemetry plane (obs: a span, a counter, a scrape reply;
    a profiler trace dumped), and slice 20's guardian and loop (a
    Module.fit that skips an injected non-finite step, its checkpoint
    published through a CheckpointPublisher into a ModelRegistry), and
    slice 22's modules (a CustomOp through nd.Custom under record, a
    bulk initialisation, a summary printed, libinfo's features, every
    module of parallel/ with a mesh over contexts), loads
    neither jax nor the JAX package (the
    C shim's embedded interpreter is checked in
    tests/test_torch_serving_edges.py)."""
    code = textwrap.dedent("""
        import os
        import sys
        import numpy as np
        import incubator_mxnet_tpu_torch as mx
        import incubator_mxnet_tpu_torch.autograd
        import incubator_mxnet_tpu_torch.fused
        import incubator_mxnet_tpu_torch.gluon.contrib.estimator
        import incubator_mxnet_tpu_torch.gluon.data
        import incubator_mxnet_tpu_torch.gluon.fused_step
        import incubator_mxnet_tpu_torch.gluon.loss
        import incubator_mxnet_tpu_torch.gluon.trainer
        import incubator_mxnet_tpu_torch.gluon.utils
        import incubator_mxnet_tpu_torch.ndarray.register
        import incubator_mxnet_tpu_torch.gluon.model_zoo.vision.resnet
        import incubator_mxnet_tpu_torch.gluon.model_zoo.vision.vgg
        import incubator_mxnet_tpu_torch.gluon.rnn
        import incubator_mxnet_tpu_torch.module.bucketing_module
        import incubator_mxnet_tpu_torch.ndarray.contrib
        import incubator_mxnet_tpu_torch.ops.control_flow
        import incubator_mxnet_tpu_torch.rnn
        import incubator_mxnet_tpu_torch.symbol.contrib
        import incubator_mxnet_tpu_torch.recordio
        import incubator_mxnet_tpu_torch.native
        import incubator_mxnet_tpu_torch.image
        import incubator_mxnet_tpu_torch.io_plane
        import incubator_mxnet_tpu_torch.ndarray.sparse
        import incubator_mxnet_tpu_torch.ops.image_ops
        import incubator_mxnet_tpu_torch.ops.detection
        import incubator_mxnet_tpu_torch.ops.spatial
        import incubator_mxnet_tpu_torch.ops.contrib_tail
        import incubator_mxnet_tpu_torch.image_detection
        import incubator_mxnet_tpu_torch.kvstore
        import incubator_mxnet_tpu_torch.kvstore_server
        import incubator_mxnet_tpu_torch.dist
        import incubator_mxnet_tpu_torch.dist.compression
        import incubator_mxnet_tpu_torch.dist.transport
        import incubator_mxnet_tpu_torch.dist.membership
        import incubator_mxnet_tpu_torch.dist.server
        import incubator_mxnet_tpu_torch.dist.kvstore_dist
        import incubator_mxnet_tpu_torch.dist.launch
        import incubator_mxnet_tpu_torch.embedding
        import incubator_mxnet_tpu_torch.embedding.cache
        import incubator_mxnet_tpu_torch.embedding.sharded
        import incubator_mxnet_tpu_torch.embedding.fit
        import incubator_mxnet_tpu_torch.embedding.serving
        import incubator_mxnet_tpu_torch.serving.router
        import incubator_mxnet_tpu_torch.serving.replica
        import incubator_mxnet_tpu_torch.serving.worker
        import incubator_mxnet_tpu_torch.serving.hostd
        import incubator_mxnet_tpu_torch.serving.fleet
        import incubator_mxnet_tpu_torch.obs
        import incubator_mxnet_tpu_torch.obs.jsonl_sink
        import incubator_mxnet_tpu_torch.obs.metrics
        import incubator_mxnet_tpu_torch.obs.trace
        import incubator_mxnet_tpu_torch.obs.scrape
        import incubator_mxnet_tpu_torch.profiler
        import incubator_mxnet_tpu_torch.resilience
        import incubator_mxnet_tpu_torch.resilience.faults
        import incubator_mxnet_tpu_torch.c_predict
        import incubator_mxnet_tpu_torch.test_utils
        import incubator_mxnet_tpu_torch.gluon.nn.sparse
        import incubator_mxnet_tpu_torch.gluon.contrib.nn
        import incubator_mxnet_tpu_torch.gluon.contrib.rnn
        import incubator_mxnet_tpu_torch.gluon.contrib.data
        import incubator_mxnet_tpu_torch.gluon.model_zoo.model_store
        import incubator_mxnet_tpu_torch.gluon.model_zoo.vision.alexnet
        import incubator_mxnet_tpu_torch.gluon.model_zoo.vision.densenet
        import incubator_mxnet_tpu_torch.gluon.model_zoo.vision.inception
        import incubator_mxnet_tpu_torch.gluon.model_zoo.vision.mobilenet
        import incubator_mxnet_tpu_torch.gluon.model_zoo.vision.squeezenet
        import incubator_mxnet_tpu_torch.engine
        import incubator_mxnet_tpu_torch.operator
        import incubator_mxnet_tpu_torch.visualization
        import incubator_mxnet_tpu_torch.libinfo
        import incubator_mxnet_tpu_torch.parallel.mesh
        import incubator_mxnet_tpu_torch.parallel.collectives
        import incubator_mxnet_tpu_torch.parallel.verbs
        import incubator_mxnet_tpu_torch.parallel.tensor_parallel
        import incubator_mxnet_tpu_torch.parallel.gluon_bridge
        import incubator_mxnet_tpu_torch.parallel.data_parallel
        import incubator_mxnet_tpu_torch.parallel.zero
        import incubator_mxnet_tpu_torch.parallel.pipeline

        @mx.operator.register("sq22")
        class _SqProp(mx.operator.CustomOpProp):
            def create_operator(self, ctx, shapes, dtypes):
                class _Sq(mx.operator.CustomOp):
                    def forward(self, is_train, req, in_data, out_data,
                                aux):
                        self.assign(out_data[0], req[0],
                                    in_data[0] * in_data[0])

                    def backward(self, req, out_grad, in_data, out_data,
                                 in_grad, aux):
                        self.assign(in_grad[0], req[0],
                                    2 * in_data[0] * out_grad[0])
                return _Sq()
        xc = mx.nd.array(np.arange(3.0), ctx=mx.cpu())
        xc.attach_grad()
        with mx.autograd.record():
            yc = mx.nd.Custom(xc, op_type="sq22")
        yc.backward()
        assert xc.grad.asnumpy().tolist() == [0.0, 2.0, 4.0]
        with mx.engine.bulk(16):
            staged = mx.nd.ones((2, 2), ctx=mx.cpu())
        assert mx.engine.h2d_copies == 1
        mx.viz.print_summary(mx.sym.FullyConnected(
            mx.sym.Variable("data"), num_hidden=2), shape={"data": (1, 3)})
        assert "BACKENDS" in mx.libinfo.features()
        assert mx.parallel.mesh_from_spec("dp=1", devices=[mx.cpu()]) \
            .shape == {"dp": 1}
        import chip_smoke
        import tempfile
        rec = os.path.join(tempfile.mkdtemp(), "a.rec")
        w = mx.recordio.MXRecordIO(rec, "w")
        for i in range(4):
            w.write(mx.recordio.pack_img(
                mx.recordio.IRHeader(0, float(i), i, 0),
                np.full((10, 10, 3), i, np.uint8), img_fmt=".ppm"))
        w.close()
        it = mx.io.ImageRecordIter(path_imgrec=rec, data_shape=(3, 8, 8),
                                   batch_size=2, rand_crop=True,
                                   device_augment=True)
        data = it.normalize_symbol(mx.sym.Variable("data"))
        net = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(
            data, num_hidden=4), name="softmax")
        mod = mx.mod.Module(net, context=mx.cpu())
        mod.fit(it, num_epoch=1, eval_metric=["acc",
                mx.metric.TopKAccuracy(top_k=2)])
        assert mod._fused_step.steps == 2
        sym = mx.model_zoo.vgg_symbol(11)
        mx.subgraph.partition_graph(sym, "TPU_PALLAS").infer_shape(
            data=(1, 3, 32, 32))
        res = mx.gluon.model_zoo.vision.get_model(
            "resnet18_v1", classes=3, thumbnail=True)
        res.initialize(ctx=mx.cpu())
        res(mx.nd.array(np.ones((1, 3, 8, 8)), ctx=mx.cpu()))
        net = mx.sym.SoftmaxOutput(res(mx.sym.Variable("data")),
                                   name="softmax")
        it = mx.io.NDArrayIter(np.ones((8, 3, 8, 8), "f4"),
                               np.zeros(8, "f4"), 4)
        mod = mx.mod.Module(net, context=mx.cpu())
        mod.fit(it, num_epoch=1, initializer=mx.initializer.Xavier(),
                batch_end_callback=mx.callback.Speedometer(4, 1))
        assert mod._fused_step.steps == 2
        res.hybridize()
        est = mx.gluon.contrib.estimator.Estimator(
            res, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
            trainer=mx.gluon.Trainer(res.collect_params(), "sgd"))
        data = mx.gluon.data.DataLoader(mx.gluon.data.ArrayDataset(
            np.ones((8, 3, 8, 8), "f4"), np.zeros(8, "f4")), batch_size=4)
        est.fit(data, event_handlers=[])
        assert est._fused.steps == 2
        cell = mx.rnn.LSTMCell(4, prefix="l_")
        def sym_gen(t):
            out, _ = cell.unroll(t, mx.sym.Embedding(
                mx.sym.Variable("data"), input_dim=5, output_dim=3,
                name="e"), merge_outputs=True)
            return mx.sym.SoftmaxOutput(
                mx.sym.FullyConnected(mx.sym.Reshape(out, shape=(-1, 4)),
                                      num_hidden=5, name="p"),
                mx.sym.Reshape(mx.sym.Variable("softmax_label"),
                               shape=(-1,))), ("data",), ("softmax_label",)
        it = mx.rnn.BucketSentenceIter([[1, 2, 3]] * 4 + [[1, 2]] * 4, 4,
                                       buckets=[2, 3], invalid_label=0)
        bm = mx.mod.BucketingModule(sym_gen, 3, context=mx.cpu())
        bm.fit(it, num_epoch=1, eval_metric=mx.metric.Perplexity(0))
        lstm = mx.gluon.rnn.LSTM(4, input_size=3)
        lstm.initialize(ctx=mx.cpu())
        lstm(mx.nd.array(np.ones((2, 1, 3)), ctx=mx.cpu()))
        ssd = chip_smoke.ssd_symbol(mx, 3, small=True)
        det = os.path.join(tempfile.mkdtemp(), "d.rec")
        w = mx.recordio.MXRecordIO(det, "w")
        for i in range(4):
            w.write(mx.recordio.pack_img(mx.recordio.IRHeader(
                0, [2.0, 5.0, i % 3, 0.1, 0.2, 0.6, 0.7], i, 0),
                np.full((64, 64, 3), 40 * i, np.uint8), img_fmt=".ppm"))
        w.close()
        it = mx.image.ImageDetIter(2, (3, 64, 64), path_imgrec=det,
                                   max_objects=3, rand_mirror=True)
        mod = mx.mod.Module(ssd, context=mx.cpu(), data_names=("data",),
                            label_names=("label",))
        mod.fit(it, num_epoch=1, eval_metric=chip_smoke.ssd_metric(mx),
                initializer=mx.initializer.Xavier())
        assert mod.get_outputs()[3].shape == (2, 280, 6)
        from incubator_mxnet_tpu_torch.dist.server import ParameterServer
        servers = [ParameterServer(num_workers=1).start() for _ in range(2)]
        os.environ.update(DMLC_PS_ROOT_URI="127.0.0.1",
                          DMLC_PS_ROOT_PORT=str(servers[0].port),
                          DMLC_RANK="0", MXNET_PS_REQUEST_TIMEOUT="30")
        kv = mx.kv.create("dist_sync")
        kv.init("w", mx.nd.ones((3,), ctx=mx.cpu()))
        kv.set_optimizer(mx.optimizer.SGD(learning_rate=0.5))
        kv.push("w", [mx.nd.ones((3,), ctx=mx.cpu(i)) for i in range(2)])
        w = mx.nd.zeros((3,), ctx=mx.cpu())
        kv.pull("w", out=w)
        assert np.allclose(w.asnumpy(), 0.0), w.asnumpy()
        kv.close()
        table = mx.embedding.ShardedEmbedding(
            "t", 10, 2, [("127.0.0.1", s.port) for s in servers], seed=1,
            cache_rows=4, optimizer=mx.optimizer.SGD(learning_rate=1.0),
            ctx=mx.cpu())
        before = table.lookup(np.array([1, 8]), out_np=True)
        table.push_grad(np.array([1, 8]), np.ones((2, 2), np.float32))
        after = table.lookup(np.array([1, 8]), out_np=True)
        assert np.allclose(after, before - 1.0)
        table.close()
        for srv in servers:
            srv.shutdown()
        alex = mx.gluon.model_zoo.vision.get_model("alexnet", classes=4)
        for b in (alex.features[10], alex.features[12]):
            b._rate = 0.0
        net = mx.sym.SoftmaxOutput(alex(mx.sym.Variable("data")),
                                   name="softmax")
        os.environ["MXNET_SUBGRAPH_BACKEND"] = "TPU_PALLAS"
        mod = mx.mod.Module(net, context=mx.cpu())
        mod.fit(mx.io.NDArrayIter(np.ones((4, 3, 63, 63), "f4"),
                                  np.zeros(4, "f4"), 2), num_epoch=1)
        os.environ.pop("MXNET_SUBGRAPH_BACKEND")
        assert mod._exec_group.execs[0]._symbol.tojson().count(
            '"_sg_pallas_fc_relu"') == 2
        sq = mx.gluon.model_zoo.vision.get_model("squeezenet1.1", classes=3)
        sq.initialize(ctx=mx.cpu())
        sq.hybridize()
        sq(mx.nd.array(np.ones((1, 3, 64, 64)), ctx=mx.cpu()))
        prefix = os.path.join(tempfile.mkdtemp(), "sq")
        sq.export(prefix)
        sb = mx.gluon.SymbolBlock.imports(prefix + "-symbol.json", "data",
                                          prefix + "-0000.params",
                                          ctx=mx.cpu())
        sb(mx.nd.array(np.ones((1, 3, 64, 64)), ctx=mx.cpu()))
        ctc = mx.gluon.loss.CTCLoss()(
            mx.nd.array(np.ones((2, 5, 4)), ctx=mx.cpu()),
            mx.nd.array(np.ones((2, 2)), ctx=mx.cpu()))
        cell = mx.gluon.contrib.rnn.Conv2DLSTMCell((2, 4, 4), 3, 3, 3,
                                                   i2h_pad=1)
        cell.initialize(ctx=mx.cpu())
        cell.unroll(2, mx.nd.array(np.ones((1, 2, 2, 4, 4)), ctx=mx.cpu()))
        mx.obs.trace.enable()
        with mx.obs.trace.span("probe"):
            mx.obs.registry().counter("probe.hits").inc()
        mx.obs.parse_prometheus(mx.obs.scrape.metrics_reply()["prom"])
        mx.profiler.set_config(filename=os.path.join(tempfile.mkdtemp(),
                                                     "p.json"))
        mx.profiler.set_state("run")
        mx.profiler.Marker("m").mark()
        mx.profiler.set_state("stop")
        mx.profiler.dump()
        import incubator_mxnet_tpu_torch.resilience.guardian
        import incubator_mxnet_tpu_torch.loop.controller
        ck = os.path.join(tempfile.mkdtemp(), "ck")
        mx.resilience.faults.configure("grad.nonfinite:error(at=2)")
        pub = mx.loop.CheckpointPublisher(
            os.path.join(tempfile.mkdtemp(), "reg"), ck, publish_steps=1)
        mod = mx.mod.Module(mx.sym.SoftmaxOutput(mx.sym.FullyConnected(
            mx.sym.Variable("data"), num_hidden=2), name="softmax"),
            context=mx.cpu())
        pub.fit(mod, mx.io.NDArrayIter(np.ones((8, 3), "f4"),
                                       np.zeros(8, "f4"), 2),
                num_epoch=1, checkpoint_period=2)
        mx.resilience.faults.clear()
        assert mod._guardian.stats()["skips"] == 1
        pub.poll(99)     # fit has flushed its last snapshot
        assert pub.registry.latest()["version"] == 4
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


# modules of the port the scan must reach (slices 15, 18, 19, 20 and 22
# among them)
PORT_MODULES = (
    "gluon/block.py", "gluon/loss.py", "gluon/nn/activations.py",
    "gluon/nn/basic_layers.py", "gluon/nn/conv_layers.py",
    "gluon/nn/sparse.py", "gluon/contrib/nn/basic_layers.py",
    "gluon/contrib/rnn/rnn_cell.py", "gluon/contrib/rnn/conv_rnn_cell.py",
    "gluon/contrib/data/sampler.py", "gluon/model_zoo/model_store.py",
    "gluon/model_zoo/vision/alexnet.py", "gluon/model_zoo/vision/densenet.py",
    "gluon/model_zoo/vision/inception.py",
    "gluon/model_zoo/vision/mobilenet.py",
    "gluon/model_zoo/vision/squeezenet.py", "autograd.py",
    "serving/router.py", "serving/replica.py", "serving/worker.py",
    "serving/hostd.py", "serving/fleet.py", "embedding/serving.py",
    "obs/__init__.py", "obs/jsonl_sink.py", "obs/metrics.py",
    "obs/trace.py", "obs/scrape.py", "profiler.py",
    "resilience/guardian.py", "loop/__init__.py", "loop/registry.py",
    "loop/publisher.py", "loop/controller.py", "engine.py", "operator.py",
    "visualization.py", "libinfo.py", "parallel/__init__.py",
    "parallel/mesh.py", "parallel/collectives.py", "parallel/verbs.py",
    "parallel/tensor_parallel.py", "parallel/gluon_bridge.py",
    "parallel/data_parallel.py", "parallel/zero.py", "parallel/pipeline.py")


def test_port_sources_never_import_jax():
    root = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "incubator_mxnet_tpu_torch")
    offenders, scanned = [], set()
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(dirpath, f)
                scanned.add(os.path.relpath(path, root))
                for line in open(path):
                    words = line.split()
                    if words[:1] in (["import"], ["from"]) and \
                            words[1].split(".")[0] in (
                                "jax", "jaxlib", "incubator_mxnet_tpu"):
                        offenders.append(f"{path}: {line.strip()}")
    assert not offenders, offenders
    assert set(PORT_MODULES) <= scanned, set(PORT_MODULES) - scanned


# -- serving what Module.fit saves, and serving in bfloat16 -----------------

MNIST = (1, 28, 28)
MNIST_SIZES = (1, 3, 8, 2, 5)


def _mlp(mod):
    s = mod.sym
    x = s.Flatten(s.Variable("data"))
    for i, n in enumerate((128, 64)):
        x = s.Activation(s.FullyConnected(x, num_hidden=n, name=f"fc{i}"),
                         act_type="relu", name=f"relu{i}")
    return s.SoftmaxOutput(s.FullyConnected(x, num_hidden=10, name="fc2"),
                           name="softmax")


def _mnist_requests(seed=0):
    x, _ = tmx.test_utils.get_mnist_like(sum(MNIST_SIZES), seed=seed)
    cuts = np.cumsum((0,) + MNIST_SIZES)
    return [x[a:b] for a, b in zip(cuts, cuts[1:])]


def test_fit_checkpoint_with_softmax_head_serves_like_jax(tmp_path):
    """A checkpoint the port's Module.fit saves carries the SoftmaxOutput
    head's label slot, which no parameter fills: both servers feed it
    zeros and give Module.predict's answers."""
    x, y = tmx.test_utils.get_mnist_like(128, seed=1)
    np.random.seed(1)
    train = tmx.io.NDArrayIter(x, y, 32, shuffle=True)
    mod = tmx.mod.Module(_mlp(tmx), context=tmx.cpu())
    mod.fit(train, optimizer_params={"learning_rate": 0.05,
                                     "momentum": 0.9},
            initializer=tmx.initializer.Xavier(), num_epoch=1)
    prefix = str(tmp_path / "mlp")
    mod.save_checkpoint(prefix, 1)
    assert "softmax_label" in tmx.sym.load(
        prefix + "-symbol.json").list_arguments()
    reqs = _mnist_requests()
    want = [mod.predict(tmx.nd.array(r, ctx=tmx.cpu())).asnumpy()
            for r in reqs]
    answers = {}
    for name, srv in (("jax", jmx.serving.ModelServer(
            max_queue_latency_ms=20)), ("port", tmx.serving.ModelServer(
                max_queue_latency_ms=20, ctx=tmx.cpu()))):
        srv.load_model("mlp", prefix=prefix, epoch=1,
                       data_shapes=[("data", (1,) + MNIST)],
                       buckets=(1, 2, 4, 8))
        try:
            answers[name] = _serve(srv, "mlp", reqs)
        finally:
            srv.shutdown()
    for r, got, jgot, w in zip(reqs, answers["port"], answers["jax"], want):
        assert got.shape == (len(r), 10)
        np.testing.assert_allclose(got, w, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got, jgot, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dtype", ["bfloat16", torch.bfloat16])
def test_bfloat16_serving_matches_jax(tmp_path, dtype):
    """ServedModel(dtype=bfloat16) on a TPU_PALLAS checkpoint with a
    label head: requests are cast to bf16, the fp32 parameters stay as
    loaded, K1 runs on bf16 activations against fp32 weights (promoted, as
    in the JAX kernel) and the outputs are bf16 in both packages.  The
    packages differ by roundings to bf16 (the JAX FullyConnected rounds
    fc2's weights to bf16 first; each layer's output is rounded once in
    both): rtol 2**-5, atol 2**-6*max, and the same argmax."""
    sym = tmx.subgraph.partition_graph(_mlp(tmx), "TPU_PALLAS")
    shapes, _, _ = sym.infer_shape(data=(1,) + MNIST)
    rng = np.random.RandomState(2)
    args = {n: (rng.normal(0, 1, s) / np.sqrt(np.prod(s[1:]))
                ).astype(np.float32)
            for n, s in zip(sym.list_arguments(), shapes)
            if n not in ("data", "softmax_label")}
    targs, _ = params_from_numpy(args, None, ctx=tmx.cpu())
    prefix = str(tmp_path / "mlp")
    tmx.save_checkpoint(prefix, 0, sym, targs, {})
    kw = dict(data_shapes=[("data", (1,) + MNIST)], buckets=(1, 4, 8))
    jmodel = jmx.serving.ServedModel.load(prefix, dtype="bfloat16", **kw)
    model = tmx.serving.ServedModel.load(prefix, dtype=dtype, ctx=tmx.cpu(),
                                         **kw)
    model.warmup()
    for r in _mnist_requests(seed=3):
        got = model.infer({"data": r})[0]
        want = jmodel.infer({"data": r})[0].asnumpy().astype(np.float32)
        assert got.data.dtype == torch.bfloat16 and got.shape == want.shape
        g = got.asnumpy()
        np.testing.assert_allclose(g, want, rtol=2.0 ** -5,
                                   atol=2.0 ** -6 * np.abs(want).max())
        assert (g.argmax(1) == want.argmax(1)).all()
