"""Symbolic training in the PyTorch port (`Executor`, `Module`,
`Module.fit`) against the JAX package on the CPU.

Symbols are built in the port and loaded into the JAX package from their
JSON, so both bind the same graph under the same names.  Inputs and
parameters come from numpy seeds as float32.  The JAX side runs as its
own tests do: `TPU_PALLAS` K1 through its interpreted Pallas kernel.

Tolerances: one op or one step, float32 sums in different orders,
rtol 1e-5 + 1e-6 * max|ref|; a fit, where those differences go through
momentum SGD for 16 steps, rtol 1e-4 + 1e-5 * max|ref|.
"""
import functools

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx

import incubator_mxnet_tpu_torch as tmx

STEP_TOL = (1e-5, 1e-6)
FIT_TOL = (1e-4, 1e-5)


def _close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    rtol, atol = tol
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def mlp():
    s = tmx.sym
    x = s.Flatten(s.Variable("data"))
    x = s.Activation(s.FullyConnected(x, name="fc1", num_hidden=128),
                     name="relu1", act_type="relu")
    x = s.Activation(s.FullyConnected(x, name="fc2", num_hidden=64),
                     name="relu2", act_type="relu")
    return s.SoftmaxOutput(s.FullyConnected(x, name="fc3", num_hidden=10),
                           name="softmax")


def lenet():
    s = tmx.sym
    x = s.Variable("data")
    for i, nf in enumerate((20, 50)):
        x = s.Convolution(x, kernel=(5, 5), num_filter=nf, name=f"conv{i}")
        x = s.Activation(x, act_type="tanh", name=f"tanh{i}")
        x = s.Pooling(x, pool_type="max", kernel=(2, 2), stride=(2, 2),
                      name=f"pool{i}")
    x = s.Activation(s.FullyConnected(s.Flatten(x), num_hidden=500,
                                      name="fc1"), act_type="tanh",
                     name="tanh2")
    return s.SoftmaxOutput(s.FullyConnected(x, num_hidden=10, name="fc2"),
                           name="softmax")


NETS = {"mlp": mlp, "lenet": lenet}


def _both(net):
    sym = NETS[net]()
    return sym, jmx.sym.load_json(sym.tojson())


def _random_params(sym, data_shape, seed=0):
    shapes, _, _ = sym.infer_shape(data=data_shape)
    rng = np.random.RandomState(seed)
    return {n: (rng.normal(0, 1, s) / np.sqrt(np.prod(s[1:]) or 1)
                ).astype(np.float32) * (0.1 if n.endswith("bias") else 1)
            for n, s in zip(sym.list_arguments(), shapes)
            if n not in ("data", "softmax_label")}


# -- Executor ----------------------------------------------------------------

@pytest.mark.parametrize("req", ["write", "add", "null"])
def test_executor_forward_backward_matches_jax(req):
    """simple_bind, forward(is_train=True), backward with a ones
    cotangent (SoftmaxOutput ignores it), twice, so ``add`` sums two
    gradients; the data input takes no gradient."""
    sym, jsym = _both("mlp")
    rng = np.random.RandomState(1)
    x = rng.rand(6, 1, 28, 28).astype(np.float32)
    y = rng.randint(0, 10, 6).astype(np.float32)
    params = _random_params(sym, x.shape)
    reqs = {n: (req if n in params else "null")
            for n in sym.list_arguments()}
    exe = sym.simple_bind(ctx=tmx.cpu(), grad_req=reqs, data=x.shape,
                          softmax_label=y.shape)
    jexe = jsym.simple_bind(ctx=jmx.cpu(), grad_req=reqs, data=x.shape,
                            softmax_label=y.shape)
    exe.copy_params_from(params)
    jexe.copy_params_from({k: jmx.nd.array(v) for k, v in params.items()})
    for _ in range(2):
        out = exe.forward(is_train=True, data=x, softmax_label=y)[0]
        jout = jexe.forward(is_train=True, data=jmx.nd.array(x),
                            softmax_label=jmx.nd.array(y))[0]
        _close(out.asnumpy(), jout.asnumpy(), STEP_TOL, "output")
        exe.backward()
        jexe.backward()
    for name in params:
        if req == "null":
            assert exe.grad_dict[name] is None
            continue
        _close(exe.grad_dict[name].asnumpy(),
               jexe.grad_dict[name].asnumpy(), STEP_TOL, name)
    assert exe.grad_dict["data"] is None


def test_executor_bind_and_out_grads_match_jax():
    """bind with caller arrays; backward with an explicit cotangent
    through a head without an implicit gradient."""
    s = tmx.sym
    sym = s.Activation(s.FullyConnected(s.Variable("data"), num_hidden=5,
                                        name="fc"), act_type="tanh",
                       name="act")
    jsym = jmx.sym.load_json(sym.tojson())
    rng = np.random.RandomState(2)
    vals = {"data": rng.rand(4, 3), "fc_weight": rng.rand(5, 3) - 0.5,
            "fc_bias": rng.rand(5) - 0.5}
    vals = {k: v.astype(np.float32) for k, v in vals.items()}
    og = rng.rand(4, 5).astype(np.float32)
    args = {k: tmx.nd.array(v, ctx=tmx.cpu()) for k, v in vals.items()}
    grads = {k: tmx.nd.zeros(v.shape, ctx=tmx.cpu())
             for k, v in vals.items()}
    exe = sym.bind(tmx.cpu(), args, args_grad=grads)
    jexe = jsym.bind(jmx.cpu(), {k: jmx.nd.array(v) for k, v in vals.items()},
                     args_grad={k: jmx.nd.zeros(v.shape)
                                for k, v in vals.items()})
    _close(exe.forward(is_train=True)[0].asnumpy(),
           jexe.forward(is_train=True)[0].asnumpy(), STEP_TOL)
    exe.backward(tmx.nd.array(og, ctx=tmx.cpu()))
    jexe.backward(jmx.nd.array(og))
    for k in vals:
        _close(grads[k].asnumpy(), jexe.grad_dict[k].asnumpy(), STEP_TOL, k)
    # inference forward records nothing
    exe.forward(is_train=False)
    assert exe._recorded is None


def test_simple_bind_partitions_by_backend(monkeypatch):
    sym = mlp()
    monkeypatch.setenv("MXNET_SUBGRAPH_BACKEND", "TPU_PALLAS")
    exe = sym.simple_bind(ctx=tmx.cpu(), data=(2, 784), softmax_label=(2,))
    assert exe._symbol.tojson().count('"_sg_pallas_fc_relu"') == 2
    assert exe._symbol.list_arguments() == sym.list_arguments()
    monkeypatch.delenv("MXNET_SUBGRAPH_BACKEND")
    exe = sym.simple_bind(ctx=tmx.cpu(), data=(2, 784), softmax_label=(2,))
    assert "_sg_pallas_fc_relu" not in exe._symbol.tojson()


def test_symbol_attr_dict_and_infer_type_match_jax():
    sym = tmx.sym.FullyConnected(
        tmx.sym.Variable("data", lr_mult=0.5), num_hidden=3, name="fc")
    jsym = jmx.sym.load_json(sym.tojson())
    assert sym.attr_dict()["fc"] == jsym.attr_dict()["fc"]
    assert sym.attr_dict()["data"]["__lr_mult__"] == "0.5"
    assert sym.infer_type(data=np.float16) == jsym.infer_type(
        data=np.float16)


# -- Module API ----------------------------------------------------------------

def _iters(mod, n=256, batch=32, seed=0, shuffle=True):
    x, y = mod.test_utils.get_mnist_like(n + 64, seed=seed)
    np.random.seed(seed)
    train = mod.io.NDArrayIter(x[:n], y[:n], batch, shuffle=shuffle)
    val = mod.io.NDArrayIter(x[n:], y[n:], batch)
    return train, val


def test_module_basic_api_and_checkpoint_round_trip(tmp_path):
    """The JAX `test_module_basic_api` shapes: bind, init_params,
    init_optimizer, one step, get/set_params, save and load, predict."""
    mod = tmx.mod.Module(mlp(), context=tmx.cpu())
    assert mod.data_names == ["data"]
    assert mod.label_names == ["softmax_label"]
    assert mod.output_names == ["softmax_output"]
    train, val = _iters(tmx, n=64)
    mod.bind(train.provide_data, train.provide_label)
    assert mod.binded and mod.data_shapes[0].shape == (32, 1, 28, 28)
    mod.init_params(tmx.initializer.Xavier())
    mod.init_optimizer(optimizer_params={"learning_rate": 0.1})
    assert mod._optimizer.rescale_grad == 1 / 32
    batch = next(iter(train))
    before = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    mod.forward_backward(batch)
    mod.update()
    assert mod.output_shapes == [("softmax_output", (32, 10))]
    args, auxs = mod.get_params()
    assert sorted(args) == ["fc1_bias", "fc1_weight", "fc2_bias",
                            "fc2_weight", "fc3_bias", "fc3_weight"]
    assert all(not np.array_equal(before[k], args[k].asnumpy())
               for k in args if k.endswith("weight"))
    mod.save_checkpoint(str(tmp_path / "m"), 1)
    loaded = tmx.mod.Module.load(str(tmp_path / "m"), 1,
                                 context=tmx.cpu())
    loaded.bind(val.provide_data, val.provide_label, for_training=False)
    for k, v in loaded.get_params()[0].items():
        assert np.array_equal(v.asnumpy(), args[k].asnumpy()), k
    want = mod.predict(val).asnumpy()
    got = loaded.predict(val).asnumpy()
    assert got.shape == (64, 10) and np.array_equal(got, want)
    # the JAX package loads the port's checkpoint and predicts the same
    jmod = jmx.mod.Module.load(str(tmp_path / "m"), 1, context=jmx.cpu())
    _, jval = _iters(jmx, n=64)
    jmod.bind(jval.provide_data, jval.provide_label, for_training=False)
    _close(got, jmod.predict(jval).asnumpy(), STEP_TOL, "JAX predict")


def test_predict_at_other_batch_sizes_then_train():
    """predict runs a batch of another size than the bound one at its own
    size (a padded tail drops its pad rows), and training then goes on at
    the bound size."""
    mod = tmx.mod.Module(mlp(), context=tmx.cpu())
    mod.bind([("data", (32, 1, 28, 28))], [("softmax_label", (32,))])
    mod.init_params(tmx.initializer.Xavier())
    x, y = tmx.test_utils.get_mnist_like(70)
    want = mod.predict(tmx.io.NDArrayIter(x, y, 70)).asnumpy()
    for batch in (32, 20):
        got = mod.predict(tmx.io.NDArrayIter(x, y, batch)).asnumpy()
        assert got.shape == (70, 10)
        _close(got, want, STEP_TOL, f"batch {batch}")
    mod.init_optimizer()
    mod.forward_backward(next(iter(tmx.io.NDArrayIter(x[:32], y[:32], 32))))
    mod.update()
    assert mod.output_shapes == [("softmax_output", (32, 10))]


def test_module_bf16_data_binds_bf16_and_trains_like_jax():
    """A bf16 data descriptor binds every argument but the label in bf16
    (the low-precision lane), and SGD with ``multi_precision`` keeps fp32
    master weights: two steps against the JAX package, within two bf16
    roundings (2**-6 relative plus 2**-6 of the largest value)."""
    sym, jsym = _both("mlp")
    rng = np.random.RandomState(3)
    x = rng.rand(8, 1, 28, 28).astype(np.float32)
    y = rng.randint(0, 10, 8).astype(np.float32)
    params = _random_params(sym, x.shape)
    got = {}
    for pkg, s in ((tmx, sym), (jmx, jsym)):
        mod = pkg.mod.Module(s, context=pkg.cpu())
        mod.bind([pkg.io.DataDesc("data", x.shape, dtype="bfloat16")],
                 [pkg.io.DataDesc("softmax_label", y.shape)])
        mod.init_params(arg_params={k: pkg.nd.array(v, ctx=pkg.cpu())
                                    for k, v in params.items()})
        mod.init_optimizer(optimizer_params={
            "learning_rate": 0.1, "momentum": 0.9, "multi_precision": True})
        batch = pkg.io.DataBatch([pkg.nd.array(x, ctx=pkg.cpu())],
                                 [pkg.nd.array(y, ctx=pkg.cpu())])
        for _ in range(2):
            mod.forward_backward(batch)
            mod.update()
        args = mod.get_params()[0]
        assert "bfloat16" in str(mod.get_outputs()[0].dtype)
        assert all("bfloat16" in str(v.dtype) for v in args.values())
        got[pkg] = [mod.get_outputs()[0].asnumpy().astype(np.float32)] + \
            [args[k].asnumpy().astype(np.float32) for k in sorted(params)]
    for name, a, b in zip(["output"] + sorted(params), got[tmx], got[jmx]):
        _close(a, b, (2.0 ** -6, 2.0 ** -6), name)


def test_module_without_context_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(tmx.MXNetError, match="no such CUDA device"):
        tmx.mod.Module(mlp())
    tmx.mod.Module(mlp(), context=tmx.cpu())
    # several contexts are data parallelism through the kvstore; each
    # context must exist
    assert len(tmx.mod.Module(mlp(), context=[tmx.cpu(), tmx.cpu(1)])
               ._context) == 2
    with pytest.raises(tmx.MXNetError, match="no such CUDA device"):
        tmx.mod.Module(mlp(), context=[tmx.cpu(), tmx.gpu(0)])


def test_fit_rejects_what_is_not_ported(monkeypatch):
    """``mesh=`` (14-parallel) raises.  A dist_sync kvstore asked for the
    collective data plane, which raised before it was ported, now trains
    (one worker: the plane needs two, so the server's plane carries the
    gradients; tests/test_torch_dist.py holds the plane itself).
    Monitors, which raised before they were ported, run: fit takes the
    per-batch path and the monitor sees every batch's outputs
    (tests/test_torch_sequential.py holds their values to the JAX
    package's)."""
    from incubator_mxnet_tpu_torch.dist.server import ParameterServer
    mod = tmx.mod.Module(mlp(), context=tmx.cpu())
    train, _ = _iters(tmx, n=32)
    mon = tmx.Monitor(1, pattern=".*output")
    seen = []
    mon.toc_print = lambda: seen.extend(mon.toc())
    mod.fit(train, num_epoch=1, monitor=mon)
    assert mon.step == len(seen) > 0
    assert mod._fused_step.steps == 0
    with pytest.raises(tmx.MXNetError, match="14-parallel"):
        tmx.mod.Module(mlp(), context=tmx.cpu()).fit(
            train, num_epoch=1, mesh=object())
    server = ParameterServer(num_workers=1).start()
    try:
        for k, v in {"DMLC_PS_ROOT_URI": "127.0.0.1",
                     "DMLC_PS_ROOT_PORT": str(server.port),
                     "DMLC_RANK": "0", "MXNET_KVSTORE_COLLECTIVE": "1",
                     "MXNET_PS_REQUEST_TIMEOUT": "30"}.items():
            monkeypatch.setenv(k, v)
        dist = tmx.mod.Module(mlp(), context=tmx.cpu())
        fresh, _ = _iters(tmx, n=32)
        dist.fit(fresh, num_epoch=1, kvstore="dist_sync")
        assert dist._kvstore._collective is None and dist._update_on_kvstore
        assert server.stats()["pushes"] > 0
        dist._kvstore.close()
    finally:
        server.shutdown()


@pytest.mark.parametrize("net", ["mlp", "lenet"])
def test_init_params_bitwise_equal_under_one_seed(net):
    """Xavier under one `random.seed` draws bitwise the same parameters
    in both packages (the same host stream, in the same sorted order)."""
    sym, jsym = _both(net)
    got = {}
    for pkg, s, ctx in ((tmx, sym, tmx.cpu()), (jmx, jsym, jmx.cpu())):
        mod = pkg.mod.Module(s, context=ctx)
        mod.bind([("data", (32, 1, 28, 28))], [("softmax_label", (32,))])
        pkg.random.seed(11)
        mod.init_params(pkg.initializer.Xavier())
        got[pkg] = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    assert sorted(got[tmx]) == sorted(got[jmx])
    for k, v in got[tmx].items():
        assert v.dtype == got[jmx][k].dtype and \
            v.tobytes() == got[jmx][k].tobytes(), k


# -- Module.fit against the JAX package -----------------------------------------

EPOCHS = 2


def _fit(pkg, sym, net, params):
    """fit 2 epochs of 256 samples at batch 32 (SGD lr 0.05, momentum
    0.9, the train_mnist defaults); returns the per-step cross-entropy,
    the final parameters and the validation accuracy."""
    ctx = pkg.cpu()
    mod = pkg.mod.Module(sym, context=ctx)
    train, val = _iters(pkg)
    steps = []

    def record(p):
        name, value = p.eval_metric.get()
        steps.append(value * (p.nbatch + 1) * 32)   # summed CE so far

    mod.fit(train, eval_metric="ce", batch_end_callback=record,
            optimizer="sgd",
            optimizer_params={"learning_rate": 0.05, "momentum": 0.9},
            arg_params={k: pkg.nd.array(v, ctx=ctx) for k, v in
                        params.items()},
            num_epoch=EPOCHS)
    per_epoch = len(steps) // EPOCHS
    losses = []
    for e in range(EPOCHS):
        sums = [0.0] + steps[e * per_epoch:(e + 1) * per_epoch]
        losses += [(b - a) / 32 for a, b in zip(sums, sums[1:])]
    acc = mod.score(val, "acc")[0][1]
    args = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    return np.array(losses), args, acc, mod


@functools.lru_cache(maxsize=None)
def _port_fit(net):
    sym, _ = _both(net)
    params = _random_params(sym, (32, 1, 28, 28), seed=5)
    import os
    os.environ["MXNET_SUBGRAPH_BACKEND"] = "TPU_PALLAS" if net == "mlp" \
        else ""
    try:
        losses, args, acc, mod = _fit(tmx, sym, net, params)
    finally:
        os.environ.pop("MXNET_SUBGRAPH_BACKEND", None)
    fused = mod._exec_group.execs[0]._symbol.tojson().count(
        '"_sg_pallas_fc_relu"')
    return sym.tojson(), params, losses, args, acc, fused


@pytest.mark.parametrize("jax_path", ["per_batch", "fused_defaults"])
@pytest.mark.parametrize("net", ["mlp", "lenet"])
def test_fit_matches_jax(monkeypatch, net, jax_path):
    """The port's Module.fit (the mlp under TPU_PALLAS, so K1 runs in
    every train and eval forward) against the JAX package's from the same
    parameters and batch order: the JAX per-batch path
    (MXNET_FUSED_TRAIN_STEP=0), and its defaults, where the fused K-step
    program runs the same steps."""
    js, params, losses, args, acc, fused = _port_fit(net)
    assert fused == (2 if net == "mlp" else 0)
    if net == "mlp":
        monkeypatch.setenv("MXNET_SUBGRAPH_BACKEND", "TPU_PALLAS")
    if jax_path == "per_batch":
        monkeypatch.setenv("MXNET_FUSED_TRAIN_STEP", "0")
    jlosses, jargs, jacc, jmod = _fit(jmx, jmx.sym.load_json(js), net,
                                      params)
    assert (jmod._fused_step is None) == (jax_path == "per_batch")
    assert len(losses) == len(jlosses) == EPOCHS * 8
    _close(losses, jlosses, FIT_TOL, "per-step loss")
    assert losses[-1] < losses[0]
    for k, v in args.items():
        _close(v, jargs[k], FIT_TOL, k)
    assert acc == jacc
