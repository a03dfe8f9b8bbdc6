"""The port's mesh parallelism (`parallel/`, `Trainer(zero=, mesh=)`,
`Module.fit(mesh=)`, ``SyncBatchNorm`` across ranks) on the CPU.

The multi-rank cases run in ONE spawned group of 4 gloo CPU ranks
(`_torch_parallel_worker.py`, a FileStore, no TCP ports), each rank
saving what it saw; the tests below hold those values against numpy and
against the JAX package's single-device runs (its multi-device lanes fail
on the CPU, ROADMAP Queue 3, so the oracle is one device at the whole
batch):

* the spec grammar, `mesh_from_spec` and `dp_axis_of` against the JAX
  functions on the same strings, errors included; ``make_mesh({'dp':
  5})`` raising in a world of 4; the collective verbs against numpy;
* `data_parallel_step` at dp=4 against JAX's single-device step (rtol
  1e-5, atol 1e-6); `zero_train_step` with Adam at dp=4 against
  replicated Adam over 3 steps (rtol 1e-4, atol 1e-5), each rank holding
  1/4 of the padded state; `pipeline_step` at pp=4 and
  `pipeline_train_step` at pp=2 against the sequential composition;
  `shard_params` with the megatron rules;
* tests/test_parallel_gluon.py's MiniTransformer at dp=2 x tp=2 with
  ``Trainer(zero=mesh)`` from the JAX package's initial parameters,
  against the JAX package's single-device ``_train(mesh=None)`` (losses
  rtol 2e-4, atol 1e-5; parameters rtol 1e-3, atol 5e-5), and
  hybridized against eager (its tolerances);
* K1 (`_sg_pallas_fc_relu`) on each rank's column shards of a
  partitioned classifier, against one process at the whole batch;
* ``SyncBatchNorm`` at dp=4 against one rank at the whole batch
  (parameters and moving statistics rtol 1e-4, atol 1e-5);
* ``Trainer(zero=...)``'s flags and ``Module.fit(mesh=)`` / ``MXNET_MESH``
  over CPU contexts (in this process: no ranks needed).
"""
import os
import re
import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx

WORLD = 4
DEADLINE_S = 240.0


def _inputs():
    """The group's inputs: seeded data, the JAX MiniTransformer's initial
    parameters (as tests/test_parallel_gluon.py's ``_train`` draws
    them), the classifier's and the BatchNorm net's parameters."""
    from test_parallel_gluon import MiniTransformer
    rng = np.random.RandomState(0)
    d = dict(dp_w=rng.rand(5, 3).astype("f4"),
             dp_x=rng.rand(16, 5).astype("f4"),
             dp_y=(rng.rand(16, 3) > 0.5).astype("f4"),
             z_w=rng.rand(5, 3).astype("f4"),
             z_x=rng.rand(16, 5).astype("f4"),
             z_y=rng.rand(16, 3).astype("f4"),
             k1_x=rng.rand(8, 36).astype("f4"),
             k1_y=rng.randint(0, 10, 8).astype("f4"),
             k1_fc6_weight=(rng.randn(16, 36) * 0.2).astype("f4"),
             k1_fc6_bias=(rng.rand(16) * 0.1).astype("f4"),
             k1_fc7_weight=(rng.randn(16, 16) * 0.2).astype("f4"),
             k1_fc7_bias=(rng.rand(16) * 0.1).astype("f4"),
             k1_fc8_weight=(rng.randn(10, 16) * 0.2).astype("f4"),
             k1_fc8_bias=np.zeros(10, "f4"),
             bn_x=rng.randn(16, 5).astype("f4"),
             bn_y=rng.randint(0, 3, 16).astype("f4"))
    for k, s in dict(d0_weight=(8, 5), d0_bias=(8,), sbn_gamma=(8,),
                     sbn_beta=(8,), sbn_running_mean=(8,),
                     d1_weight=(3, 8), d1_bias=(3,)).items():
        d["bnp_" + k] = (rng.randn(*s) * 0.3).astype("f4")
    d["bnp_sbn_running_var"] = (1 + rng.rand(8)).astype("f4")
    d["cv_x"] = rng.rand(8, 3, 12, 12).astype("f4")
    d["cv_y"] = rng.randint(0, 10, 8).astype("f4")
    for k, s in dict(conv0_weight=(8, 3, 3, 3), conv0_bias=(8,),
                     dense0_weight=(10, 72), dense0_bias=(10,)).items():
        d["cvp_" + k] = (rng.randn(*s) * 0.3).astype("f4")
    # tests/test_parallel.py's pipeline data, drawn as it draws them
    pp = np.random.RandomState(3)
    d["pp_w"] = (pp.randn(2, 6, 6) * 0.5).astype("f4")
    d["pp_b"] = np.zeros((2, 1, 6), "f4")
    d["pp_x"] = pp.randn(4, 8, 6).astype("f4")
    d["pp_t"] = (pp.randn(4, 8, 6) * 0.1).astype("f4")
    # the JAX _train's draws, in its order
    np.random.seed(11)
    jmx.random.seed(11)
    net = MiniTransformer()
    net.initialize(jmx.initializer.Xavier(), ctx=jmx.cpu())
    x = jmx.nd.array(np.random.randint(0, 32, (8, 6)).astype("f4"))
    y = np.random.randint(0, 32, (8, 6)).astype("f4")
    net(x)
    d["mt_x"], d["mt_y"] = x.asnumpy(), y
    for p in net.collect_params().values():
        d["mtp_" + p.name[len(net.prefix):]] = p.data().asnumpy()
    return d


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """Spawn the 4 ranks once; {rank: {name: array}} and the inputs."""
    import torch.multiprocessing as tmp_mp
    import _torch_parallel_worker as worker
    tmp = tmp_path_factory.mktemp("parallel")
    inp = _inputs()
    np.savez(tmp / "in.npz", **inp)
    ctx = tmp_mp.get_context("spawn")
    procs = [ctx.Process(target=worker.run,
                         args=(r, WORLD, str(tmp / "store"),
                               str(tmp / "in.npz"), str(tmp)),
                         name=f"mesh-rank-{r}") for r in range(WORLD)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + DEADLINE_S
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        hung = [p.name for p in procs if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    assert not hung, f"ranks past the {DEADLINE_S:.0f} s deadline: {hung}"
    assert [p.exitcode for p in procs] == [0] * WORLD
    out = {r: dict(np.load(tmp / f"r{r}.npz")) for r in range(WORLD)}
    assert all("ok" in out[r] for r in out)
    return out, inp


# -- meshes --------------------------------------------------------------------

SPECS = ["dp=4,tp=2", " dp=8 ", "dp:4", "dp=four", "=2", "dp=0",
         "dp=2,dp=2", "tp=2,x=4", "", "dp=2,,tp=1"]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_spec_matches_jax(spec):
    from incubator_mxnet_tpu.parallel.mesh import parse_spec as jparse
    from incubator_mxnet_tpu_torch.parallel.mesh import parse_spec

    def run(fn, err):
        try:
            return fn(spec)
        except err as e:
            return f"error: {e}"
    assert run(parse_spec, tmx.MXNetError) == run(jparse, jmx.MXNetError)


@pytest.mark.parametrize("spec", ["dp=4,tp=2", {"tp": 2, "x": 4}, "dp=8",
                                  "pp=2,dp=2,tp=2"])
def test_mesh_from_spec_and_dp_axis_match_jax(spec):
    from incubator_mxnet_tpu.parallel import mesh as jm
    from incubator_mxnet_tpu_torch.parallel import mesh as tm
    want = jm.mesh_from_spec(spec, devices=jax.devices()[:8])
    got = tm.mesh_from_spec(spec, devices=[tmx.cpu(i) for i in range(8)])
    assert tuple(got.axis_names) == tuple(want.axis_names)
    assert dict(got.shape) == dict(want.shape)
    assert tm.dp_axis_of(got) == jm.dp_axis_of(want)
    assert got.devices.shape == tuple(want.shape.values())
    assert tm.mesh_from_spec("") is None and jm.mesh_from_spec("") is None
    with pytest.raises(tmx.MXNetError, match="needs 16 devices, have 8"):
        tm.mesh_from_spec("dp=16", devices=[tmx.cpu(i) for i in range(8)])


def test_local_mesh_rebuild_axes_and_group2ctx_match_jax():
    """Without a process group: `local_mesh`, `rebuild` and `mesh_axes`
    give one-axis meshes over this process (the JAX ones over its
    devices); `group2ctx_shardings` picks the ``ctx_group`` variables and
    their specs as the JAX function does."""
    from incubator_mxnet_tpu import parallel as jpar
    from incubator_mxnet_tpu.parallel import tensor_parallel as jtp
    from incubator_mxnet_tpu_torch import parallel as tpar
    from incubator_mxnet_tpu_torch.parallel import tensor_parallel as ttp
    for mesh in (tpar.local_mesh(), tpar.rebuild(), tpar.make_mesh()):
        assert tpar.mesh_axes(mesh) == ("dp",) and mesh.shape == {"dp": 1}
        assert not mesh.is_ranks
    assert tpar.mesh_axes(jpar.local_mesh()) == ("dp",)
    with pytest.raises(tmx.MXNetError, match="a rank is one process"):
        tpar.rebuild(per_host=2)
    with pytest.raises(tmx.MXNetError, match="needs a mesh of ranks"):
        tpar.local_mesh().device_mesh

    def graph(m):
        with m.AttrScope(ctx_group="embed"):
            e = m.sym.Variable("e_weight")
        with m.AttrScope(ctx_group="head"):
            h = m.sym.Variable("h_weight")
        x = m.sym.FullyConnected(m.sym.Variable("data"), weight=e,
                                 num_hidden=8, no_bias=True, name="fc0")
        return m.sym.FullyConnected(x, weight=h, num_hidden=4,
                                    no_bias=True, name="fc1")
    group2axis = {"embed": "tp", "head": tpar.P(None, "tp")}
    jgroup2axis = {"embed": "tp",
                   "head": jax.sharding.PartitionSpec(None, "tp")}
    got = ttp.group2ctx_shardings(graph(tmx), group2axis,
                                  tpar.mesh_from_spec(
                                      "tp=2", devices=[tmx.cpu(0),
                                                       tmx.cpu(1)]))
    want = jtp.group2ctx_shardings(graph(jmx), jgroup2axis,
                                   jpar.make_mesh({"tp": 2},
                                                  devices=jax.devices()[:2]))
    assert set(got) == set(want) == {"e_weight", "h_weight"}
    for k in got:
        assert tuple(got[k].spec) == tuple(want[k].spec), k


def test_mesh_over_ranks(group):
    """make_mesh({'dp': 5}) raises the JAX text in a world of 4; a dp=2 x
    tp=2 mesh lays the ranks out row-major; the default is all ranks on
    one dp axis."""
    out, _ = group
    for r in range(WORLD):
        assert str(out[r]["mesh_dp5_error"]) == \
            "mesh shape (5,) needs 5 devices, have 4"
        assert out[r]["mesh_shape"].tolist() == [2, 2]
        assert out[r]["mesh_coord"].tolist() == [r // 2, r % 2]
        assert int(out[r]["mesh_default"]) == WORLD


def test_collective_verbs_against_numpy(group):
    out, _ = group
    xs = [np.arange(8.0).reshape(4, 2) + 10 * r for r in range(WORLD)]
    stacked = np.stack(xs)
    for r in range(WORLD):
        o = out[r]
        np.testing.assert_array_equal(o["all_reduce_sum"], stacked.sum(0))
        np.testing.assert_array_equal(o["all_reduce_mean"], stacked.mean(0))
        np.testing.assert_array_equal(o["all_reduce_max"], stacked.max(0))
        np.testing.assert_array_equal(o["all_reduce_min"], stacked.min(0))
        np.testing.assert_array_equal(o["all_reduce_nd"], stacked.sum(0))
        np.testing.assert_array_equal(o["all_gather"],
                                      np.concatenate(xs, 0))
        np.testing.assert_array_equal(o["all_gather_axis1"],
                                      np.concatenate(xs, 1))
        np.testing.assert_array_equal(o["all_gather_stacked"], stacked)
        np.testing.assert_array_equal(o["reduce_scatter"],
                                      stacked.sum(0)[r:r + 1])
        np.testing.assert_array_equal(o["ppermute"], xs[(r - 1) % WORLD])
        np.testing.assert_array_equal(
            o["ppermute_partial"],
            xs[r - 2] if r in (2, 3) else np.zeros_like(xs[0]))
        np.testing.assert_array_equal(o["broadcast"], xs[2])
        assert int(o["axis_index"]) == r and int(o["axis_size"]) == WORLD
        # the dp x tp grid: tp pairs (0,1), (2,3); dp pairs (0,2), (1,3)
        tp_peer, dp_peer = r ^ 1, r ^ 2
        np.testing.assert_array_equal(o["all_reduce_tp"],
                                      xs[r] + xs[tp_peer])
        np.testing.assert_array_equal(o["all_reduce_dp2"],
                                      xs[r] + xs[dp_peer])


# -- the functional SPMD steps ------------------------------------------------

def _mse(p, batch):
    x, y = batch
    return jnp.mean((x @ p["w"] + p["b"] - y) ** 2)


def test_data_parallel_step_matches_jax_single_device(group):
    out, inp = group
    params = {"w": jnp.asarray(inp["dp_w"]), "b": jnp.zeros(3, "f4")}
    batch = (jnp.asarray(inp["dp_x"]), jnp.asarray(inp["dp_y"]))
    loss, g = jax.value_and_grad(_mse)(params, batch)
    for r in range(WORLD):
        for k in ("w", "b"):
            np.testing.assert_allclose(
                out[r][f"dp_{k}"], np.asarray(params[k] - 0.1 * g[k]),
                rtol=1e-5, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(out[r]["dp_loss"], float(loss),
                                   rtol=1e-5, atol=1e-6)


def test_zero_adam_matches_replicated_adam(group):
    """ZeRO dp=4 Adam == replicated Adam over 3 steps; the state lives
    sharded: w's m is padded to ceil(15/4)*4 = 16, each rank holding 4."""
    out, inp = group
    ref = {"w": inp["z_w"].astype("f4"), "b": np.zeros(3, "f4")}
    m = {k: np.zeros_like(v) for k, v in ref.items()}
    v = {k: np.zeros_like(x) for k, x in ref.items()}
    batch = (jnp.asarray(inp["z_x"]), jnp.asarray(inp["z_y"]))
    for t in range(1, 4):
        g = jax.grad(_mse)({k: jnp.asarray(a) for k, a in ref.items()},
                           batch)
        for k in ref:
            gk = np.asarray(g[k], "f4")
            m[k] = 0.9 * m[k] + 0.1 * gk
            v[k] = 0.999 * v[k] + 0.001 * gk * gk
            mhat = m[k] / (1 - 0.9 ** t)
            vhat = v[k] / (1 - 0.999 ** t)
            ref[k] = ref[k] - 0.05 * mhat / (np.sqrt(vhat) + 1e-8)
        for r in range(WORLD):
            for k in ref:
                np.testing.assert_allclose(out[r][f"zero_{k}_{t - 1}"],
                                           ref[k], rtol=1e-4, atol=1e-5,
                                           err_msg=f"{k} step {t}")
    for r in range(WORLD):
        assert out[r]["zero_m_w_global"].tolist() == [16]
        assert out[r]["zero_m_w_local"].tolist() == [4]
        assert out[r]["zero_t_local"].tolist() == [1]


def test_zero_sgd_and_replicate(group):
    """zero_train_step with sgd_shard_update (momentum 0.9) at dp=4
    against replicated SGD; `replicate` takes rank 0's values, and
    `unreplicate` gives a sharded tensor's whole tensor."""
    out, inp = group
    ref = {"w": inp["z_w"].astype("f4"), "b": np.zeros(3, "f4")}
    mom = {k: np.zeros_like(v) for k, v in ref.items()}
    batch = (jnp.asarray(inp["z_x"]), jnp.asarray(inp["z_y"]))
    for _ in range(2):
        g = jax.grad(_mse)({k: jnp.asarray(a) for k, a in ref.items()},
                           batch)
        for k in ref:
            mom[k] = 0.9 * mom[k] - 0.1 * np.asarray(g[k], "f4")
            ref[k] = ref[k] + mom[k]
    for r in range(WORLD):
        for k in ref:
            np.testing.assert_allclose(out[r][f"zsgd_{k}"], ref[k],
                                       rtol=1e-5, atol=1e-6, err_msg=k)
        np.testing.assert_array_equal(out[r]["replicate"], [0.0, 0.0])
        np.testing.assert_array_equal(out[r]["unreplicate"],
                                      np.arange(8.0))


def test_pipeline_step_pp4(group):
    """Every one of 4 stages adds its parameter, 1.0."""
    out, _ = group
    for r in range(WORLD):
        np.testing.assert_array_equal(out[r]["pipe4"].reshape(-1),
                                      np.arange(8) + 4.0)


def test_pipeline_train_step_pp2_matches_sequential(group):
    """GPipe over pp=2 (two pipelines, one a dp row): the forward equals
    the sequential composition, the gradients equal autodiff of the
    composed function (normalised by n_stages as the JAX step does), and
    12 steps halve the loss."""
    out, inp = group
    W, B, X, T = (inp[k] for k in ("pp_w", "pp_b", "pp_x", "pp_t"))
    seq = np.tanh(np.tanh(X @ W[0] + B[0]) @ W[1] + B[1])

    def composed(p):
        a1 = jnp.tanh(jnp.asarray(X) @ p["w"][0] + p["b"][0])
        a2 = jnp.tanh(a1 @ p["w"][1] + p["b"][1])
        return jnp.mean((a2 - jnp.asarray(T)) ** 2)

    g = jax.grad(composed)({"w": jnp.asarray(W), "b": jnp.asarray(B)})
    for r in range(WORLD):
        stage = r % 2
        np.testing.assert_allclose(out[r]["pipe2_fwd"], seq, rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(out[r]["pipe2_grad_w"][0],
                                   np.asarray(g["w"][stage]), rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(out[r]["pipe2_grad_b"][0],
                                   np.asarray(g["b"][stage]), rtol=1e-4,
                                   atol=1e-5)
        losses = out[r]["pipe2_losses"]
        assert losses[-1] < 0.5 * losses[0], losses


def test_shard_params_megatron(group):
    """tests/test_parallel.py:153 on dp=2 x tp=2: qkv column-parallel,
    out_proj row-parallel, a bias and an axis that does not divide
    replicated."""
    out, _ = group
    for r in range(WORLD):
        o = out[r]
        assert o["sp_layer0.qkv_weight_local"].tolist() == [32, 32]
        assert str(o["sp_layer0.qkv_weight_placements"]) == \
            "(Replicate(), Shard(dim=0))"
        assert o["sp_layer0.out_proj_weight_local"].tolist() == [32, 32]
        assert str(o["sp_layer0.out_proj_weight_placements"]) == \
            "(Replicate(), Shard(dim=1))"
        assert o["sp_layer0.bias_local"].tolist() == [64]
        assert o["sp_odd.qkv_weight_local"].tolist() == [5, 4]


# -- gluon on the mesh ---------------------------------------------------------

def _jax_reference():
    from test_parallel_gluon import _train
    _, losses, net, _, _ = _train(mesh=None)
    return ({p.name[len(net.prefix):]: p.data().asnumpy()
             for p in net.collect_params().values()}, losses)


def _port_single_device(inp):
    """The port's run of the same net from the same parameters, batch and
    steps on one device, no mesh: (params by local name, losses)."""
    import _torch_parallel_worker as worker
    from incubator_mxnet_tpu_torch.compat.weights import (
        local_params_from_numpy, local_params_to_numpy)
    net = worker._mini(tmx)
    net.initialize(ctx=tmx.cpu())
    local_params_from_numpy(net, {k[len("mtp_"):]: v for k, v in
                                  inp.items() if k.startswith("mtp_")},
                            ctx=tmx.cpu())
    x = tmx.nd.array(inp["mt_x"], ctx=tmx.cpu())
    y = tmx.nd.array(inp["mt_y"], ctx=tmx.cpu())
    trainer = tmx.gluon.Trainer(net.collect_params(), "adam",
                                {"learning_rate": 0.05})
    loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    losses = []
    for _ in range(4):
        with tmx.autograd.record():
            loss = loss_fn(net(x).reshape((-1, 32)), y.reshape((-1,)))
        loss.backward()
        trainer.step(x.shape[0])
        losses.append(float(loss.mean().asnumpy()))
    return local_params_to_numpy(net), losses


def test_gluon_tp_zero_matches_jax_single_device(group):
    """MiniTransformer at dp=2 x tp=2, megatron rules, Adam with ZeRO,
    from the JAX package's initial parameters: losses and parameters
    against the JAX package's single-device run; qkv is split over tp
    and fc1's Adam state over dp.

    Adam divides each step by the root of its second moment, so an
    element whose gradient is near zero moves by about the learning rate
    whatever its size, and fp32 rounding in the two packages' backward
    passes sets its size (fc1_weight[56, 14]: 7.95e-6 in the port,
    7.51e-6 in the JAX package, at step 1).  The port's own
    single-device run already differs from the JAX run beyond the
    tolerance at such elements (3 of 12 176, at most 1 per 1 000 of a
    tensor); those are excused here, counted, and the mesh run is held
    to the port's single-device run at every element."""
    out, inp = group
    ref_params, ref_losses = _jax_reference()
    single, single_losses = _port_single_device(inp)
    np.testing.assert_allclose(single_losses, ref_losses, rtol=2e-4,
                               atol=1e-5)
    excused = {k: ~np.isclose(single[k], want, rtol=1e-3, atol=5e-5)
               for k, want in ref_params.items()}
    for k, far in excused.items():
        assert far.sum() <= max(1, far.size // 1000), \
            (k, np.argwhere(far).tolist())
    for r in range(WORLD):
        o = out[r]
        np.testing.assert_allclose(o["mt_eager_losses"], ref_losses,
                                   rtol=2e-4, atol=1e-5)
        for k, want in ref_params.items():
            keep = ~excused[k]
            np.testing.assert_allclose(o[f"mt_eager_p_{k}"][keep],
                                       want[keep], rtol=1e-3, atol=5e-5,
                                       err_msg=k)
            np.testing.assert_allclose(o[f"mt_eager_p_{k}"], single[k],
                                       rtol=1e-3, atol=5e-5, err_msg=k)
        assert o["mt_eager_qkv_local"].tolist() == [24, 16]
        assert str(o["mt_eager_qkv_placements"]) == \
            "(Replicate(), Shard(dim=0))"
        # fc1 (64, 16): its state is half over dp, whole over tp
        assert o["mt_eager_fc1_state_local"].tolist() == [32, 16]
        assert str(o["mt_eager_fc1_state_placements"]) == \
            "(Shard(dim=0), Replicate())"


def test_gluon_tp_hybridized_matches_eager(group):
    """The hybridized MiniTransformer (each Adam state in its weight's
    layout) against the eager one (ZeRO): tests/test_parallel_gluon.py's
    tolerances."""
    out, _ = group
    for r in range(WORLD):
        o = out[r]
        np.testing.assert_allclose(o["mt_hyb_losses"], o["mt_eager_losses"],
                                   rtol=2e-4, atol=1e-5)
        for k in (n[len("mt_eager_p_"):] for n in o
                  if n.startswith("mt_eager_p_")):
            np.testing.assert_allclose(o[f"mt_hyb_p_{k}"],
                                       o[f"mt_eager_p_{k}"], rtol=2e-4,
                                       atol=2e-5, err_msg=k)


def test_k1_on_column_shards_matches_one_process(group):
    """The partitioned classifier's two K1 nodes run on each rank's
    shards (x: the dp half of the batch, w: the tp half of the rows)
    and 3 Adam steps with ZeRO equal one process at the whole batch."""
    import _torch_parallel_worker as worker
    out, inp = group
    net = worker.k1_block(tmx, inp)
    x = tmx.nd.array(inp["k1_x"], ctx=tmx.cpu())
    y = tmx.nd.array(inp["k1_y"], ctx=tmx.cpu())
    losses = worker.k1_train(tmx, net, x, y)
    want = {n: p.data().asnumpy() for n, p in net.collect_params().items()}
    for r in range(WORLD):
        o = out[r]
        np.testing.assert_allclose(o["k1_losses"], losses, rtol=1e-5,
                                   atol=1e-6)
        for n, w in want.items():
            np.testing.assert_allclose(o[f"k1_p_{n}"], w, rtol=1e-4,
                                       atol=1e-6, err_msg=n)
        assert [tuple(s) for s in o["k1_shapes"]] == \
            [(4, 36, 8, 36), (4, 16, 8, 16)] * 3


@pytest.mark.parametrize("tag", ["dp", "tp"])
def test_conv_and_pool_on_local_shards_match_one_process(group, tag):
    """A convolution and a max pooling on the mesh run on each rank's
    local shards (data-parallel, or the convolution split by output
    channels over tp and the pooling on the channel shards): 2 Adam steps
    with ZeRO equal one process at the whole batch."""
    import _torch_parallel_worker as worker
    out, inp = group
    net = worker.conv_net(tmx, inp)
    x = tmx.nd.array(inp["cv_x"], ctx=tmx.cpu())
    y = tmx.nd.array(inp["cv_y"], ctx=tmx.cpu())
    losses = worker.k1_train(tmx, net, x, y, steps=2)
    want = {n: p.data().asnumpy() for n, p in net.collect_params().items()}
    for r in range(WORLD):
        o = out[r]
        np.testing.assert_allclose(o[f"cv_{tag}_losses"], losses,
                                   rtol=1e-5, atol=1e-6)
        for n, w in want.items():
            np.testing.assert_allclose(o[f"cv_{tag}_p_{n}"], w, rtol=1e-4,
                                       atol=1e-6, err_msg=n)


def test_sync_batchnorm_dp4_matches_whole_batch(group):
    out, _ = group
    one = {k[len("bn_one_"):]: v for k, v in out[0].items()
           if k.startswith("bn_one_")}
    assert any(k.endswith("running_var") for k in one)
    for r in range(WORLD):
        for k, want in one.items():
            np.testing.assert_allclose(out[r][f"bn_dp_{k}"], want,
                                       rtol=1e-4, atol=1e-5, err_msg=k)


# -- the public API's flags, in this process -----------------------------------

def test_trainer_zero_flags():
    """tests/test_scaling.py::test_trainer_zero_flags on the port: False
    is a no-op, True without a mesh names "mesh", and on a composed mesh
    the state shards over the axis named dp."""
    from incubator_mxnet_tpu_torch.parallel.mesh import mesh_from_spec

    def make(**kw):
        net = tmx.gluon.nn.Dense(4)
        net.initialize(ctx=tmx.cpu())
        net(tmx.nd.zeros((2, 8), ctx=tmx.cpu()))
        return tmx.gluon.Trainer(net.collect_params(), "sgd", **kw)

    assert make(zero=False)._zero is None
    with pytest.raises(tmx.MXNetError, match="mesh"):
        make(zero=True)
    mesh = mesh_from_spec("tp=2,dp=4", devices=[tmx.cpu(i) for i in range(8)])
    assert make(zero=True, mesh=mesh)._zero == (mesh, "dp")
    assert make(zero=mesh)._zero == (mesh, "dp")


def test_trainer_builds_a_mesh_only_for_zero_true(monkeypatch):
    """A Trainer without zero=True builds no mesh (over ranks that is a
    collective), even with MXNET_MESH set; zero=True reads MXNET_MESH,
    and a malformed spec raises with the grammar instead of being
    dropped."""
    from incubator_mxnet_tpu_torch.parallel import mesh as pmesh
    built = []
    real = pmesh.make_mesh
    monkeypatch.setattr(pmesh, "make_mesh",
                        lambda *a, **k: built.append(a) or real(*a, **k))

    def make(**kw):
        net = tmx.gluon.nn.Dense(4)
        net.initialize(ctx=tmx.cpu())
        net(tmx.nd.zeros((2, 8), ctx=tmx.cpu()))
        return tmx.gluon.Trainer(net.collect_params(), "sgd", **kw)

    monkeypatch.setenv("MXNET_MESH", "dp=1")
    assert make()._zero is None and make(zero=False)._zero is None
    assert make(mesh="dp=1")._zero is None
    assert built == []
    zero = make(zero=True)._zero
    assert zero[1] == "dp" and zero[0].shape == {"dp": 1} and len(built) == 1
    with pytest.raises(tmx.MXNetError, match="grammar"):
        make(mesh="dp:2")
    assert len(built) == 1
    monkeypatch.setenv("MXNET_MESH", "dp:2")
    assert make()._zero is None
    with pytest.raises(tmx.MXNetError, match="grammar"):
        make(zero=True)


def _module_fit(ctxs, **fit_kw):
    from test_torch_module import mlp, _iters
    mod = tmx.mod.Module(mlp(), context=ctxs)
    train, _ = _iters(tmx, n=64)
    tmx.random.seed(5)
    mod.fit(train, num_epoch=1, optimizer_params={"learning_rate": 0.05},
            initializer=tmx.init.Xavier(), kvstore="device", **fit_kw)
    return mod, {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def test_module_fit_mesh_over_contexts(monkeypatch):
    """fit(mesh='dp=2') over two contexts splits the batch in two, as the
    two contexts do without a mesh (bit for bit); a composed dp=2,tp=2
    over four contexts trains on the dp axis's two; MXNET_MESH drives the
    same lever."""
    ctx2 = [tmx.cpu(0), tmx.cpu(1)]
    mod, got = _module_fit(ctx2, mesh="dp=2")
    assert mod._dp_size == 2 and mod._mesh.shape == {"dp": 2}
    _, plain = _module_fit(ctx2)
    for k in plain:
        np.testing.assert_array_equal(got[k], plain[k], err_msg=k)
    ctx4 = [tmx.cpu(i) for i in range(4)]
    composed, cgot = _module_fit(ctx4, mesh="dp=2,tp=2")
    assert composed._dp_size == 2
    assert tuple(composed._mesh.axis_names) == ("dp", "tp")
    assert composed._context == [tmx.cpu(0), tmx.cpu(2)]
    for k in plain:
        np.testing.assert_array_equal(cgot[k], plain[k], err_msg=k)
    monkeypatch.setenv("MXNET_MESH", "dp=2")
    env, _ = _module_fit(ctx2)
    assert env._dp_size == 2


def test_jax_print_summary_counts_are_zero():
    """The JAX package's print_summary prints 0 in "Param #" for every
    layer (ROADMAP Queue 3); the port's counts are in
    tests/test_torch_api.py."""
    import contextlib
    import io
    s = jmx.sym.FullyConnected(jmx.sym.Variable("data"), num_hidden=4,
                               name="fc")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jmx.viz.print_summary(s, shape={"data": (2, 3)})
    row = [ln for ln in buf.getvalue().splitlines()
           if ln.startswith("fc(")][0]
    assert re.split(r"\s{2,}", row.strip())[2] == "0"
