"""One rank of the port's mesh parallelism over a gloo group of 4 CPU
ranks, for tests/test_torch_parallel.py.  Imports torch, numpy and the
port only.

`run(rank, world, store_path, inputs_path, out_dir)` joins the group
through a `FileStore` (torch's default group, which a DeviceMesh needs),
runs every multi-rank case of the test file in turn and saves what each
rank saw as ``r<rank>.npz`` (``ok`` last, so a rank that died leaves no
``ok``).  The parent holds the values against numpy and the JAX package.
"""
import os

import numpy as np
import torch
import torch.distributed as dist



class _Case:
    """Named numpy results of one rank."""

    def __init__(self):
        self.out = {}

    def __setitem__(self, key, value):
        if isinstance(value, torch.Tensor):
            value = (value.full_tensor() if hasattr(value, "full_tensor")
                     else value).detach().numpy()
        self.out[key] = np.array(value)


_MESHES = {}


def mesh(mx, **shape):
    """The rank's mesh of `shape` over the CPU, made once: every mesh
    forms its process subgroups, so the cases share four of them."""
    key = tuple(shape.items())
    if key not in _MESHES:
        _MESHES[key] = mx.parallel.make_mesh(dict(shape), devices="cpu")
    return _MESHES[key]


def mesh_cases(mx, res):
    par = mx.parallel
    try:
        par.make_mesh({"dp": 5})
        res["mesh_dp5_error"] = ""
    except mx.MXNetError as e:
        res["mesh_dp5_error"] = str(e)
    grid = mesh(mx, dp=2, tp=2)
    res["mesh_shape"] = [grid.shape["dp"], grid.shape["tp"]]
    res["mesh_coord"] = [grid.axis_index("dp"), grid.axis_index("tp")]
    default = par.make_mesh(devices="cpu")
    _MESHES[(("dp", 4),)] = default
    res["mesh_default"] = default.shape["dp"]


def collective_cases(mx, res, rank):
    par = mx.parallel
    dp4 = mesh(mx, dp=4)
    x = torch.arange(8.0).reshape(4, 2) + 10 * rank
    with dp4:
        for op in ("sum", "mean", "max", "min"):
            res[f"all_reduce_{op}"] = par.all_reduce(x, "dp", op=op)
        res["all_gather"] = par.all_gather(x, "dp")
        res["all_gather_axis1"] = par.all_gather(x, "dp", axis=1)
        res["all_gather_stacked"] = par.all_gather(x, "dp", tiled=False)
        res["reduce_scatter"] = par.reduce_scatter(x, "dp")
        res["ppermute"] = par.ppermute(x, "dp",
                                       [(i, (i + 1) % 4) for i in range(4)])
        res["ppermute_partial"] = par.ppermute(x, "dp", [(0, 2), (1, 3)])
        res["broadcast"] = par.broadcast(x, "dp", src=2)
        res["axis_index"] = par.collectives.axis_index("dp")
        res["axis_size"] = par.collectives.axis_size("dp")
        nd = mx.nd.array(x.numpy(), ctx=mx.cpu())
        res["all_reduce_nd"] = par.all_reduce(nd, "dp").asnumpy()
    grid = mesh(mx, dp=2, tp=2)
    res["all_reduce_tp"] = par.all_reduce(x, "tp", mesh=grid)
    res["all_reduce_dp2"] = par.all_reduce(x, "dp", mesh=grid)


def dp_zero_cases(mx, inp, res):
    from incubator_mxnet_tpu_torch.parallel.data_parallel import (
        sgd_tree_update)
    from incubator_mxnet_tpu_torch.parallel.zero import (
        zero_train_step, zero_init_state, adam_shard_update)
    par = mx.parallel
    mesh_ = mesh(mx, dp=4)
    params = {"w": torch.from_numpy(inp["dp_w"]),
              "b": torch.zeros(3)}
    batch = (torch.from_numpy(inp["dp_x"]), torch.from_numpy(inp["dp_y"]))

    def loss_fn(p, b):
        x, y = b
        return torch.mean((x @ p["w"] + p["b"] - y) ** 2)

    step = par.data_parallel_step(loss_fn, sgd_tree_update(momentum=0.0),
                                  mesh_, donate=False)
    opt = {k: torch.zeros_like(v) for k, v in params.items()}
    p1, _, loss = step(params, opt, batch, 0.1)
    res["dp_w"], res["dp_b"], res["dp_loss"] = p1["w"], p1["b"], loss

    zparams = {"w": torch.from_numpy(inp["z_w"]), "b": torch.zeros(3)}
    zbatch = (torch.from_numpy(inp["z_x"]), torch.from_numpy(inp["z_y"]))
    n = 4
    state = zero_init_state(zparams, n, lambda s, d: (
        torch.zeros(s, dtype=d), torch.zeros(s, dtype=d),
        torch.zeros(n, dtype=d)))
    zstep = zero_train_step(loss_fn, adam_shard_update(lr=0.05), mesh_)
    p, s = zparams, state
    for t in range(3):
        p, s, loss = zstep(p, s, zbatch)
        res[f"zero_w_{t}"], res[f"zero_b_{t}"] = p["w"], p["b"]
    res["zero_m_w_global"] = list(s["w"][0].shape)
    res["zero_m_w_local"] = list(s["w"][0].to_local().shape)
    res["zero_t_local"] = list(s["w"][2].to_local().shape)

    from incubator_mxnet_tpu_torch.parallel.zero import sgd_shard_update
    state = zero_init_state(zparams, n, lambda s, d: torch.zeros(s, dtype=d))
    sstep = zero_train_step(loss_fn, sgd_shard_update(momentum=0.9,
                                                      lr=0.1), mesh_)
    p, s = zparams, state
    for t in range(2):
        p, s, _ = sstep(p, s, zbatch)
    res["zsgd_w"], res["zsgd_b"] = p["w"], p["b"]
    res["replicate"] = par.replicate(
        {"a": torch.full((2,), float(dist.get_rank()))}, mesh_)["a"]
    whole = par.unreplicate(par.shard_params(
        {"v": torch.arange(8.0)}, mesh_, par.ShardingRules(
            [("v", par.P("dp"))])))["v"]
    res["unreplicate"] = whole


def pipeline_cases(mx, inp, res):
    par = mx.parallel
    fwd = par.pipeline_step(lambda p, x: x + p, 8, "pp",
                            mesh=mesh(mx, pp=4))
    out = fwd(torch.tensor(1.0), torch.arange(8.0).reshape(8, 1, 1))
    res["pipe4"] = out
    grid = mesh(mx, dp=2, pp=2)
    stage = grid.axis_index("pp")
    W, B = torch.from_numpy(inp["pp_w"]), torch.from_numpy(inp["pp_b"])
    X, T = torch.from_numpy(inp["pp_x"]), torch.from_numpy(inp["pp_t"])
    mine = {"w": W[stage:stage + 1], "b": B[stage:stage + 1]}

    def stage_fn(p, x):
        return torch.tanh(x @ p["w"][0] + p["b"][0])

    def loss_fn(out, tgt):
        return torch.mean((out - tgt) ** 2)

    with grid:
        res["pipe2_fwd"] = par.pipeline_step(stage_fn, 4, "pp")(mine, X)
        grads, _ = par.pipeline_train_step(
            stage_fn, loss_fn, 4, lambda p, g: g, "pp")(mine, X, T)
        res["pipe2_grad_w"], res["pipe2_grad_b"] = grads["w"], grads["b"]
        train = par.pipeline_train_step(stage_fn, loss_fn, 4,
                                         lambda p, g: p - 0.5 * g, "pp",
                                         remat=False)
        losses, p = [], mine
        for _ in range(12):
            p, loss = train(p, X, T)
            losses.append(float(loss))
        res["pipe2_losses"] = losses


def shard_params_cases(mx, res):
    par = mx.parallel
    mesh_ = mesh(mx, dp=2, tp=2)
    params = {"layer0.qkv_weight": torch.zeros(64, 32),
              "layer0.out_proj_weight": torch.zeros(32, 64),
              "layer0.bias": torch.zeros(64),
              "odd.qkv_weight": torch.zeros(5, 4)}
    out = par.shard_params(params, mesh_, par.ShardingRules.megatron("tp"))
    for k, v in out.items():
        res[f"sp_{k}_local"] = list(v.to_local().shape)
        res[f"sp_{k}_placements"] = str(tuple(v.placements))


def _mini(mx):
    gluon = mx.gluon

    class MiniTransformer(gluon.HybridBlock):
        def __init__(self, vocab=32, dim=16, heads=2, **kw):
            super().__init__(**kw)
            self.dim = dim
            with self.name_scope():
                self.embed = gluon.nn.Embedding(vocab, dim, prefix="embed_")
                self.qkv = gluon.nn.Dense(3 * dim, use_bias=False,
                                          flatten=False, prefix="qkv_")
                self.proj = gluon.nn.Dense(dim, use_bias=False,
                                           flatten=False, prefix="proj_")
                self.fc1 = gluon.nn.Dense(4 * dim, use_bias=False,
                                          flatten=False, prefix="fc1_")
                self.fc2 = gluon.nn.Dense(dim, use_bias=False,
                                          flatten=False, prefix="fc2_")
                self.norm = gluon.nn.LayerNorm(prefix="ln_")
                self.head = gluon.nn.Dense(vocab, use_bias=False,
                                           flatten=False, prefix="head_")

        def hybrid_forward(self, F, x):
            h = self.embed(x)
            qkv = self.qkv(h)
            q, k, v = (F.slice_axis(qkv, axis=2, begin=i * self.dim,
                                    end=(i + 1) * self.dim)
                       for i in range(3))
            att = F.batch_dot(q, k, transpose_b=True) / float(
                np.sqrt(self.dim))
            att = F.softmax(att, axis=-1)
            h = h + self.proj(F.batch_dot(att, v))
            h = self.norm(h)
            h = h + self.fc2(F.relu(self.fc1(h)))
            return self.head(h)

    return MiniTransformer()


def gluon_cases(mx, inp, res):
    from incubator_mxnet_tpu_torch.compat.weights import (
        local_params_from_numpy, local_params_to_numpy)
    par = mx.parallel
    mesh_ = mesh(mx, dp=2, tp=2)
    values = {k[len("mtp_"):]: inp[k] for k in inp
              if k.startswith("mtp_")}
    for tag, hyb in (("eager", False), ("hyb", True)):
        net = _mini(mx)
        net.initialize(ctx=mx.cpu())
        local_params_from_numpy(net, values, ctx=mx.cpu())
        x = mx.nd.array(inp["mt_x"], ctx=mx.cpu())
        y = mx.nd.array(inp["mt_y"], ctx=mx.cpu())
        if hyb:
            net.hybridize()
        par.shard_block(net, mesh_, par.ShardingRules.megatron("tp"))
        par.put(x, mesh_, par.P("dp"))
        par.put(y, mesh_, par.P("dp"))
        # eager with ZeRO, hybridized with each state in its weight's
        # layout: the same updates
        trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                                   {"learning_rate": 0.05},
                                   zero=None if hyb else mesh_)
        loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        losses = []
        for _ in range(4):
            with mx.autograd.record():
                out = net(x)
                loss = loss_fn(out.reshape((-1, 32)), y.reshape((-1,)))
            loss.backward()
            trainer.step(x.shape[0])
            losses.append(float(loss.mean().asnumpy()))
        res[f"mt_{tag}_losses"] = losses
        for k, v in local_params_to_numpy(net).items():
            res[f"mt_{tag}_p_{k}"] = v
        qkv = [p for p in net.collect_params().values()
               if "qkv" in p.name][0].data().data
        res[f"mt_{tag}_qkv_local"] = list(qkv.to_local().shape)
        res[f"mt_{tag}_qkv_placements"] = str(tuple(qkv.placements))
        states = trainer._updaters[0].states
        fc1 = [i for i, p in enumerate(trainer._params) if "fc1" in p.name][0]
        m = states[fc1][0].data
        res[f"mt_{tag}_fc1_state_local"] = list(m.to_local().shape)
        res[f"mt_{tag}_fc1_state_placements"] = str(tuple(m.placements))


def k1_cases(mx, inp, res):
    """A 3-layer classifier partitioned under TPU_PALLAS (two K1 nodes),
    fc6/fc7 column-parallel over tp, the batch over dp, Adam with ZeRO:
    3 steps, and the K1 shard shapes each rank ran."""
    from incubator_mxnet_tpu_torch.subgraph import fused_ops
    par = mx.parallel
    mesh_ = mesh(mx, dp=2, tp=2)
    net = k1_block(mx, inp)
    rules = par.ShardingRules([(r"fc[67]_(weight|bias)", par.P("tp"))])
    par.shard_block(net, mesh_, rules)
    x = par.put(mx.nd.array(inp["k1_x"], ctx=mx.cpu()), mesh_, par.P("dp"))
    y = par.put(mx.nd.array(inp["k1_y"], ctx=mx.cpu()), mesh_, par.P("dp"))
    shapes = []
    real = fused_ops.FCRelu.apply

    def counted(a, w, b):
        shapes.append(tuple(a.shape) + tuple(w.shape))
        return real(a, w, b)

    fused_ops.FCRelu.apply = counted
    try:
        losses = k1_train(mx, net, x, y, zero=mesh_)
    finally:
        fused_ops.FCRelu.apply = real
    res["k1_losses"] = losses
    res["k1_shapes"] = np.array(shapes)
    for name, p in net.collect_params().items():
        res[f"k1_p_{name}"] = p.data().asnumpy()


def k1_block(mx, inp):
    data = mx.sym.Variable("data")
    h = mx.sym.Activation(mx.sym.FullyConnected(data, num_hidden=16,
                                                name="fc6"), act_type="relu")
    h = mx.sym.Activation(mx.sym.FullyConnected(h, num_hidden=16,
                                                name="fc7"), act_type="relu")
    out = mx.sym.FullyConnected(h, num_hidden=10, name="fc8")
    graph = mx.subgraph.partition_graph(out, "TPU_PALLAS")
    net = mx.gluon.SymbolBlock(graph, data)
    for name, p in net.collect_params().items():
        p.shape = inp[f"k1_{name}"].shape
        p.initialize(ctx=mx.cpu())
        p.set_data(inp[f"k1_{name}"])
    return net


def k1_train(mx, net, x, y, zero=None, steps=3):
    trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                               {"learning_rate": 0.01}, zero=zero)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    losses = []
    for _ in range(steps):
        with mx.autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        trainer.step(x.shape[0])
        losses.append(float(loss.mean().asnumpy()))
    return losses


def conv_net(mx, inp):
    """Conv2D(8, 3, stride 2, pad 1) -> relu -> MaxPool2D(2) -> Flatten
    -> Dense(10) from the inputs' parameters."""
    from incubator_mxnet_tpu_torch.compat.weights import (
        local_params_from_numpy)
    nn = mx.gluon.nn
    net = nn.HybridSequential(prefix="cv_")
    with net.name_scope():
        net.add(nn.Conv2D(8, 3, strides=2, padding=1, prefix="conv0_"),
                nn.Activation("relu"), nn.MaxPool2D(2), nn.Flatten(),
                nn.Dense(10, prefix="dense0_"))
    net.initialize(ctx=mx.cpu())
    local_params_from_numpy(net, {k[len("cvp_"):]: inp[k] for k in inp
                                  if k.startswith("cvp_")}, ctx=mx.cpu())
    return net


def conv_cases(mx, inp, res):
    """The conv net at dp=2 x tp=2, its convolution data-parallel
    (``dp``) or split by output channels over tp (``tp``), Adam with
    ZeRO, 2 steps: the convolution and the pooling run on each rank's
    local shards."""
    par = mx.parallel
    mesh_ = mesh(mx, dp=2, tp=2)
    for tag, rules in (("dp", None), ("tp", par.ShardingRules(
            [(r"conv0_(weight|bias)", par.P("tp"))]))):
        net = conv_net(mx, inp)
        par.shard_block(net, mesh_, rules)
        x = par.put(mx.nd.array(inp["cv_x"], ctx=mx.cpu()), mesh_,
                    par.P("dp"))
        y = par.put(mx.nd.array(inp["cv_y"], ctx=mx.cpu()), mesh_,
                    par.P("dp"))
        res[f"cv_{tag}_losses"] = k1_train(mx, net, x, y, zero=mesh_,
                                           steps=2)
        for name, p in net.collect_params().items():
            res[f"cv_{tag}_p_{name}"] = p.data().asnumpy()


def syncbn_cases(mx, inp, res, rank):
    """A Dense -> SyncBatchNorm -> Dense net, each rank on its quarter of
    the batch under the bound dp=4 mesh, gradients summed over dp, SGD
    over the whole batch; rank 0 also runs the whole batch alone."""
    par = mx.parallel
    mesh_ = mesh(mx, dp=4)
    x, y = inp["bn_x"], inp["bn_y"]
    q = x.shape[0] // 4
    net = bn_net(mx, inp)
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1})
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    xs = mx.nd.array(x[rank * q:(rank + 1) * q], ctx=mx.cpu())
    ys = mx.nd.array(y[rank * q:(rank + 1) * q], ctx=mx.cpu())
    for _ in range(2):
        with mesh_, mx.autograd.record():
            loss = loss_fn(net(xs), ys)
        loss.backward()
        for p in net.collect_params().values():
            if p.grad_req != "null":
                g = p.grad()
                g._set_data(par.all_reduce(g.data, "dp", mesh=mesh_))
        trainer.step(x.shape[0])
    for name, p in net.collect_params().items():
        res[f"bn_dp_{name}"] = p.data().asnumpy()
    if rank == 0:
        one = bn_net(mx, inp)
        trainer = mx.gluon.Trainer(one.collect_params(), "sgd",
                                   {"learning_rate": 0.1})
        xw, yw = mx.nd.array(x, ctx=mx.cpu()), mx.nd.array(y, ctx=mx.cpu())
        for _ in range(2):
            with mx.autograd.record():
                loss = loss_fn(one(xw), yw)
            loss.backward()
            trainer.step(x.shape[0])
        for name, p in one.collect_params().items():
            res[f"bn_one_{name}"] = p.data().asnumpy()


def bn_net(mx, inp):
    nn = mx.gluon.nn
    net = nn.HybridSequential(prefix="bn_")
    with net.name_scope():
        net.add(nn.Dense(8, prefix="d0_"), nn.SyncBatchNorm(prefix="sbn_"),
                nn.Activation("relu"), nn.Dense(3, prefix="d1_"))
    net.initialize(ctx=mx.cpu())
    net(mx.nd.zeros((2, inp["bn_x"].shape[1]), ctx=mx.cpu()))
    from incubator_mxnet_tpu_torch.compat.weights import (
        local_params_from_numpy)
    local_params_from_numpy(net, {k[len("bnp_"):]: inp[k] for k in inp
                                  if k.startswith("bnp_")}, ctx=mx.cpu())
    return net


def run(rank, world, store_path, inputs_path, out_dir):
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)
    import incubator_mxnet_tpu_torch as mx
    res = _Case()
    try:
        inp = np.load(inputs_path)
        mesh_cases(mx, res)
        collective_cases(mx, res, rank)
        dp_zero_cases(mx, inp, res)
        pipeline_cases(mx, inp, res)
        shard_params_cases(mx, res)
        gluon_cases(mx, inp, res)
        k1_cases(mx, inp, res)
        conv_cases(mx, inp, res)
        syncbn_cases(mx, inp, res, rank)
        res["ok"] = 1
    finally:
        np.savez(os.path.join(out_dir, f"r{rank}.npz"), **res.out)
        dist.destroy_process_group()
