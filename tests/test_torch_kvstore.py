"""The PyTorch port's kvstore and data-parallel `Module` against the JAX
package on the CPU.

Every case of `tests/test_kvstore.py` runs through both packages with the
same inputs; the port's contexts are `mx.cpu(i)`, the JAX package's its
virtual CPU devices.  A reduction over two values is one addition in
both, so equal; one over more values sums in another order (the JAX
all-reduce's against the port's push order): rtol 1e-6.  2-bit
compression is elementwise, so its codes and residuals are held bit for
bit.  `Module` over two contexts is held against the JAX package's
one-context step on the whole batch (the JAX multi-context `Module`
fails on the CPU; ROADMAP Queue 3): with `SoftmaxOutput`'s summed
gradient the shards' gradients add up to the batch's, fp32 sums in
another order, rtol 1e-5 + 1e-6 * max|array|.
"""
import numpy as np
import pytest

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch.compat.weights import params_from_numpy

SHAPE = (4, 4)
KEYS = [5, 7, 11]
STEP_TOL = (1e-5, 1e-6)
NDEV = 4


def _close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    rtol, atol = tol
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


class Pkg:
    """One package's spelling of the test_kvstore cases: `ctx(i)` is the
    i-th device context, `arr` an array on a context."""

    def __init__(self, mx, dev):
        self.mx, self.nd, self._dev = mx, mx.nd, dev

    def ctx(self, i=0):
        return self._dev(i)

    def arr(self, x, i=0):
        return self.nd.array(np.asarray(x, np.float32), ctx=self.ctx(i))

    def zeros(self, shape, i=0):
        return self.nd.zeros(shape, ctx=self.ctx(i))


JAX = Pkg(jmx, jmx.cpu)
PORT = Pkg(tmx, tmx.cpu)
BOTH = pytest.mark.parametrize("pkg", [JAX, PORT], ids=["jax", "port"])


def _pair(case, *args):
    """The case's outputs from both packages, which must agree."""
    return case(JAX, *args), case(PORT, *args)


# -- the cases of tests/test_kvstore.py ----------------------------------------

def case_single(p, kind):
    kv = p.mx.kv.create(kind)
    kv.init(3, p.arr(np.ones(SHAPE)))
    out = p.zeros(SHAPE)
    kv.pull(3, out=out)
    first = out.asnumpy()
    kv.push(3, p.arr(np.full(SHAPE, 4.0)))
    kv.pull(3, out=out)
    return first, out.asnumpy()


def case_list(p):
    kv = p.mx.kv.create("local")
    kv.init(KEYS, [p.arr(np.ones(SHAPE))] * len(KEYS))
    kv.push(KEYS, [p.arr(np.full(SHAPE, 4.0))] * len(KEYS))
    outs = [p.zeros(SHAPE) for _ in KEYS]
    kv.pull(KEYS, out=outs)
    return [o.asnumpy() for o in outs]


def case_aggregate(p, kind, values):
    kv = p.mx.kv.create(kind)
    kv.init(9, p.zeros(SHAPE))
    kv.push(9, [p.arr(v, i) for i, v in enumerate(values)])
    out = p.zeros(SHAPE)
    kv.pull(9, out=out)
    outs = [p.zeros(SHAPE, i) for i in range(len(values))]
    kv.pull(9, out=outs)
    return [out.asnumpy()] + [o.asnumpy() for o in outs]


def case_training_step(p, w0, grads, lr):
    kv = p.mx.kv.create("device")
    kv.init("w", p.arr(w0))
    kv.set_optimizer(p.mx.optimizer.SGD(learning_rate=lr, rescale_grad=1.0))
    kv.push("w", [p.arr(g, i) for i, g in enumerate(grads)])
    outs = [p.zeros(SHAPE, i) for i in range(len(grads))]
    kv.pull("w", out=outs)
    return [o.asnumpy() for o in outs]


def case_updater(p):
    kv = p.mx.kv.create("local")
    kv.init(3, p.arr(np.ones(SHAPE)))

    def updater(key, recv, stored):
        stored += recv * 2

    kv.set_updater(updater)
    kv.push(3, p.arr(np.ones(SHAPE)))
    out = p.zeros(SHAPE)
    kv.pull(3, out=out)
    return out.asnumpy()


def case_set_optimizer(p):
    kv = p.mx.kv.create("local")
    kv.init("w", p.arr(np.ones(SHAPE)))
    kv.set_optimizer(p.mx.optimizer.SGD(learning_rate=0.1))
    kv.push("w", p.arr(np.ones(SHAPE)))
    out = p.zeros(SHAPE)
    kv.pull("w", out=out)
    return out.asnumpy()


def case_compression(p):
    kv = p.mx.kv.create("device")
    kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
    kv.init(0, p.zeros((4,)))
    kv.push(0, p.arr([1.0, -1.0, 0.2, 0.0]))
    out = p.zeros((4,))
    kv.pull(0, out=out)
    first = out.asnumpy()
    kv.push(0, p.arr([0.0, 0.0, 0.4, 0.0]))
    kv.pull(0, out=out)
    return first, out.asnumpy()


def case_bucketed(p, keys, shapes, vals):
    kv = p.mx.kv.create("device")
    for k, s in zip(keys, shapes):
        kv.init(k, p.zeros(s))
    kv.push(keys, [[p.arr(v, i) for i, v in enumerate(vals[k])]
                   for k in keys])
    kv2 = p.mx.kv.create("device")
    out = []
    for k, s in zip(keys, shapes):
        kv2.init(k, p.zeros(s))
        kv2.push(k, [p.arr(v, i) for i, v in enumerate(vals[k])])
        o1, o2 = p.zeros(s), p.zeros(s)
        kv.pull(k, out=o1)
        kv2.pull(k, out=o2)
        out.append((o1.asnumpy(), o2.asnumpy()))
    return out, kv.stats()


@pytest.mark.parametrize("kind", ["local", "device", "tpu"])
def test_single_kv_pair(kind):
    (j1, j2), (t1, t2) = _pair(case_single, kind)
    np.testing.assert_array_equal(t1, j1)
    np.testing.assert_array_equal(t2, j2)
    np.testing.assert_array_equal(t2, 4.0)


def test_list_kv_pair():
    j, t = _pair(case_list)
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, 4.0)


@pytest.mark.parametrize("kind", ["local", "device", "tpu"])
def test_aggregate_multi_device(kind):
    """Values on several contexts sum (reference comm.h Reduce): two
    values add bit for bit; four sum in another order than the JAX
    all-reduce, rtol 1e-6."""
    for n in (2, NDEV):
        values = [np.random.RandomState(i).randn(*SHAPE).astype("f4")
                  for i in range(n)]
        j, t = _pair(case_aggregate, kind, values)
        for a, b in zip(t, j):
            if n == 2:
                np.testing.assert_array_equal(a, b)
            else:
                np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


def test_reduce_is_push_order_sum_on_one_device():
    """Several values of a key on ONE device (two contexts on one card)
    take the plain sum in push order, as the JAX store does when the
    devices repeat: bitwise equal to numpy's left-to-right sum."""
    values = [np.random.RandomState(i).randn(*SHAPE).astype("f4")
              for i in range(5)]
    kv = tmx.kv.create("device")
    kv.init(1, PORT.zeros(SHAPE))
    kv.push(1, [PORT.arr(v, 0) for v in values])
    out = PORT.zeros(SHAPE)
    kv.pull(1, out=out)
    want = values[0]
    for v in values[1:]:
        want = want + v
    np.testing.assert_array_equal(out.asnumpy(), want)


def test_training_step_matches_single_device():
    lr = 0.1
    w0 = np.random.RandomState(0).randn(*SHAPE).astype(np.float32)
    grads = [np.random.RandomState(i + 1).randn(*SHAPE).astype(np.float32)
             for i in range(NDEV)]
    j, t = _pair(case_training_step, w0, grads, lr)
    expect = w0 - lr * np.sum(grads, axis=0)
    for a, b in zip(t, j):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(a, expect, rtol=1e-5, atol=1e-5)


def test_updater():
    j, t = _pair(case_updater)
    np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(t, 3.0)


def test_set_optimizer_updates_weights():
    j, t = _pair(case_set_optimizer)
    np.testing.assert_array_equal(t, j)
    np.testing.assert_allclose(t, 0.9, rtol=1e-6)


def test_gradient_compression():
    (j1, j2), (t1, t2) = _pair(case_compression)
    np.testing.assert_array_equal(t1, j1)
    np.testing.assert_array_equal(t2, j2)
    np.testing.assert_array_equal(t2, [0.5, -0.5, 0.5, 0.0])


def test_type_and_rank():
    for p in (JAX, PORT):
        kv = p.mx.kv.create("local")
        assert (kv.type, kv.rank, kv.num_workers) == ("local", 0, 1)
        assert "dist" in p.mx.kv.create("dist_sync").type


@BOTH
def test_errors(pkg):
    kv = pkg.mx.kv.create("local")
    with pytest.raises(pkg.mx.MXNetError):
        kv.push(42, pkg.arr(np.ones(SHAPE)))
    kv.init(1, pkg.arr(np.ones(SHAPE)))
    with pytest.raises(pkg.mx.MXNetError):
        kv.init(1, pkg.arr(np.ones(SHAPE)))


def test_multikey_push():
    """A multi-key push of per-context values: the same sums as per-key
    pushes and as the JAX store's bucketed push, through one bucket, as
    the JAX store counts it (one batched push, one reduction)."""
    keys = ["a", "b", "c"]
    shapes = [(3,), (2, 2), (5, 1)]
    rng = np.random.RandomState(0)
    vals = {k: [rng.randn(*s).astype("f4") for _ in range(NDEV)]
            for k, s in zip(keys, shapes)}
    (j, jstats), (t, tstats) = _pair(case_bucketed, keys, shapes, vals)
    for (t1, t2), (j1, _), k in zip(t, j, keys):
        np.testing.assert_array_equal(t1, t2)
        np.testing.assert_allclose(t1, j1, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(t1, np.sum(vals[k], axis=0), rtol=1e-6,
                                   atol=1e-6)
    assert jstats["batched_pushes"] == tstats["batched_pushes"] == 1
    assert tstats["allreduce_dispatches"] == \
        jstats["allreduce_dispatches"] == 1
    assert tstats["fallback_reduces"] == 0 and tstats["pushes"] == 1


@BOTH
def test_row_sparse_pull(pkg):
    """Only the asked rows come back: into a dense array at their places,
    zeros elsewhere."""
    w = np.arange(24, dtype=np.float32).reshape(6, 4)
    kv = pkg.mx.kv.create("local")
    kv.init("e", pkg.arr(w))
    out = pkg.zeros((6, 4))
    kv.row_sparse_pull("e", out=out, row_ids=pkg.arr([1, 4]))
    want = np.zeros_like(w)
    want[[1, 4]] = w[[1, 4]]
    np.testing.assert_array_equal(out.asnumpy(), want)


def test_row_sparse_pull_into_row_sparse():
    from incubator_mxnet_tpu_torch.ndarray import sparse
    w = np.arange(24, dtype=np.float32).reshape(6, 4)
    kv = tmx.kv.create("local")
    kv.init("e", PORT.arr(w))
    out = sparse.zeros("row_sparse", (6, 4))
    kv.row_sparse_pull("e", out=out, row_ids=PORT.arr([5, 0]))
    np.testing.assert_array_equal(out._np_indices, [5, 0])
    np.testing.assert_array_equal(out._np_data, w[[5, 0]])


@BOTH
def test_pushpull(pkg):
    kv = pkg.mx.kv.create("device")
    kv.init(2, pkg.zeros(SHAPE))
    out = pkg.zeros(SHAPE)
    kv.pushpull(2, [pkg.arr(np.ones(SHAPE), i) for i in range(2)], out=out)
    np.testing.assert_array_equal(out.asnumpy(), 2.0)


# -- 2-bit compression, bucket plan, optimizer states ---------------------------

def _host(residual):
    """A stored 2-bit residual as numpy: a jax array in the JAX package,
    a torch tensor in the port."""
    if hasattr(residual, "cpu"):
        residual = residual.cpu()
    return np.asarray(residual)


def _compress_sequence(p, kind, grads, thr):
    kv = p.mx.kv.create(kind)
    kv.set_gradient_compression({"type": "2bit", "threshold": thr})
    kv.init("g", p.zeros(grads[0].shape))
    out, codes, resid = p.zeros(grads[0].shape), [], []
    for g in grads:
        kv.push("g", [p.arr(g / 2, 0), p.arr(g / 2, 1)])
        kv.pull("g", out=out)
        codes.append(out.asnumpy())
        resid.append(_host(kv._residuals["g"]))
    return codes, resid


@pytest.mark.parametrize("kind", ["local", "device"])
def test_2bit_residual_sequence_bitwise(kind):
    """20 random pushes of two halves through 2-bit compression with error
    feedback: the pulled codes and the residual after every push are the
    JAX package's, bit for bit."""
    rng = np.random.RandomState(7)
    grads = [rng.randn(37).astype("f4") * 0.6 for _ in range(20)]
    (jc, jr), (tc, tr) = _pair(_compress_sequence, kind, grads, 0.5)
    for step, (a, b, c, d) in enumerate(zip(tc, jc, tr, jr)):
        np.testing.assert_array_equal(a, b, err_msg=f"codes, push {step}")
        np.testing.assert_array_equal(c, d, err_msg=f"residual, push {step}")
    assert set(np.unique(np.concatenate(tc))) <= {-0.5, 0.0, 0.5}


def case_bucketed_cap(p, keys, shapes, vals, two_bit):
    """A batched push over every context under the cap in force, then a
    batched pull into every context: the sums, the stats, the residuals
    (2-bit) and every context's pulled copy."""
    kv = p.mx.kv.create("device")
    if two_bit:
        kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
    for k, s in zip(keys, shapes):
        kv.init(k, p.zeros(s))
    pushes = []
    for step in range(3 if two_bit else 1):
        kv.push(keys, [[p.arr(v * (step + 1), i)
                        for i, v in enumerate(vals[k])] for k in keys])
        outs = [[p.zeros(s, i) for i in range(len(vals[k]))]
                for k, s in zip(keys, shapes)]
        kv.pull(keys, out=outs)
        pushes.append([[o.asnumpy() for o in row] for row in outs])
    resid = {k: _host(kv._residuals[k]) for k in
             kv._residuals} if two_bit else {}
    return pushes, kv.stats(), resid


@pytest.mark.parametrize("two_bit", [False, True], ids=["fp32", "2bit"])
def test_bucketed_multikey_push_matches_jax(monkeypatch, two_bit):
    """JAX `test_tpu_kvstore_bucketed_multikey_push` on 2 CPU contexts,
    under a KB-sized ``MXNET_KVSTORE_BUCKET_MB`` that cuts several
    buckets: the same bucket plan as the JAX store's (`plan_buckets`,
    reversed key order), one reduction a bucket, the sums and 2-bit
    codes and residuals bit for bit (two contexts add once), and every
    context's pulled copy equal."""
    monkeypatch.setenv("MXNET_KVSTORE_BUCKET_MB", str(40 / (1 << 20)))
    keys = ["a", "b", "c", "d", "e"]
    shapes = [(3,), (2, 2), (5, 1), (9,), (2,)]
    rng = np.random.RandomState(0)
    vals = {k: [rng.randn(*s).astype("f4") for _ in range(2)]
            for k, s in zip(keys, shapes)}
    (jp, jst, jres), (tp, tst, tres) = _pair(case_bucketed_cap, keys,
                                            shapes, vals, two_bit)
    from incubator_mxnet_tpu.kvstore import plan_buckets as jplan
    sizes = [int(np.prod(s)) * 4 for s in shapes]
    plan = jplan(list(reversed(range(5))), sizes, ["float32"] * 5, 40)
    assert len(plan) > 1
    assert tst["buckets"] == jst["buckets"] == len(plan) * len(tp)
    assert tst["allreduce_dispatches"] == jst["allreduce_dispatches"]
    assert tst["batched_pushes"] == jst["batched_pushes"] == len(tp)
    assert tst["bytes_reduced"] == jst["bytes_reduced"]
    assert tst["pull_broadcasts"] > 0
    for step, (trow, jrow) in enumerate(zip(tp, jp)):
        for k, t_ctx, j_ctx in zip(keys, trow, jrow):
            for t, j in zip(t_ctx, j_ctx):
                np.testing.assert_array_equal(t, j, err_msg=f"{k} {step}")
            np.testing.assert_array_equal(t_ctx[0], t_ctx[1])
    for k in jres:
        np.testing.assert_array_equal(tres[k], jres[k], err_msg=k)


def test_streaming_push_buckets_as_the_cap_fills(monkeypatch):
    """`begin_push` / `push_part` / `end_push`: a bucket reduces as soon
    as the pending keys reach the cap, the tail at `end_push`; the sums
    equal the batched push's bit for bit."""
    monkeypatch.setenv("MXNET_KVSTORE_BUCKET_MB", str(32 / (1 << 20)))
    rng = np.random.RandomState(1)
    vals = [[rng.randn(4).astype("f4") for _ in range(2)] for _ in range(5)]
    kv = tmx.kv.create("device")
    for i in range(5):
        kv.init(i, PORT.zeros((4,)))
    kv.begin_push()
    seen = []
    for i in range(5):
        kv.push_part(i, [PORT.arr(v, c) for c, v in enumerate(vals[i])])
        seen.append(kv.stats()["buckets"])
    kv.end_push()
    assert seen == [0, 1, 1, 2, 2] and kv.stats()["buckets"] == 3
    with pytest.raises(tmx.MXNetError, match="without begin_push"):
        kv.end_push()
    for i in range(5):
        out = PORT.zeros((4,))
        kv.pull(i, out=out)
        np.testing.assert_array_equal(out.asnumpy(),
                                      vals[i][0] + vals[i][1])
    assert [st for st in tmx.kv.live_stats() if st["buckets"] == 3]
    assert any("batched pushes" in f["message"]
               for f in tmx.kv.findings())


def test_plan_buckets_matches_jax():
    from incubator_mxnet_tpu.kvstore import plan_buckets as jplan
    from incubator_mxnet_tpu_torch.kvstore import plan_buckets as tplan
    rng = np.random.RandomState(0)
    for trial in range(50):
        n = rng.randint(1, 30)
        sizes = [int(s) for s in rng.randint(1, 5000, size=n)]
        dtypes = [("float32", "float16", "bfloat16")[rng.randint(3)]
                  for _ in range(n)]
        order = list(rng.permutation(n))
        cap = int(rng.choice([1, 100, 4096, 1 << 20]))
        assert tplan(order, sizes, dtypes, cap) == \
            jplan(order, sizes, dtypes, cap), trial


@pytest.mark.parametrize("make_opt", [
    lambda mx: mx.optimizer.SGD(learning_rate=0.1, momentum=0.9),
    lambda mx: mx.optimizer.Adam(learning_rate=0.01),
], ids=["sgd_momentum", "adam"])
def test_optimizer_states_round_trip(tmp_path, make_opt):
    """Save a store's optimizer states mid-run, load them into a fresh
    store: it continues bit for bit as the uninterrupted one, and both
    match the JAX store's run."""
    rng = np.random.RandomState(3)
    w0 = rng.randn(*SHAPE).astype("f4")
    grads = [rng.randn(*SHAPE).astype("f4") for _ in range(6)]

    def run(p, split=None):
        kv = p.mx.kv.create("local")
        kv.init("w", p.arr(w0))
        kv.set_optimizer(make_opt(p.mx))
        out = p.zeros(SHAPE)
        for i, g in enumerate(grads):
            if i == split:
                fname = str(tmp_path / "states")
                kv.save_optimizer_states(fname, dump_optimizer=True)
                kv.pull("w", out=out)
                kv = p.mx.kv.create("local")
                kv.init("w", out)
                kv.set_optimizer(make_opt(p.mx))
                kv.load_optimizer_states(fname)
            kv.push("w", p.arr(g))
        kv.pull("w", out=out)
        return out.asnumpy()

    whole = run(PORT)
    np.testing.assert_array_equal(run(PORT, split=3), whole)
    _close(whole, run(JAX), STEP_TOL)


# -- Module over several contexts ----------------------------------------------

def mlp():
    s = tmx.sym
    x = s.Flatten(s.Variable("data"))
    x = s.Activation(s.FullyConnected(x, name="fc1", num_hidden=32),
                     name="relu1", act_type="relu")
    x = s.Activation(s.FullyConnected(x, name="fc2", num_hidden=16),
                     name="relu2", act_type="relu")
    return s.SoftmaxOutput(s.FullyConnected(x, name="fc3", num_hidden=10),
                           name="softmax", normalization="null")


def _batches(n, batch, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(batch, 1, 8, 8).astype("f4"),
             rng.randint(0, 10, batch).astype("f4")) for _ in range(n)]


def _jax_xavier(sym, batch):
    jmod = jmx.mod.Module(jmx.sym.load_json(sym.tojson()),
                          context=jmx.cpu())
    jmod.bind(data_shapes=[("data", (batch, 1, 8, 8))],
              label_shapes=[("softmax_label", (batch,))])
    jmod.init_params(jmx.initializer.Xavier(magnitude=2.0))
    args, _ = jmod.get_params()
    return {k: v.asnumpy() for k, v in args.items()}


def _step_module(mx, mod, x, y):
    mod.forward_backward(mx.io.DataBatch(
        data=[mx.nd.array(x, ctx=mx.cpu())],
        label=[mx.nd.array(y, ctx=mx.cpu())]))
    mod.update()
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


OPT = {"learning_rate": 0.05, "momentum": 0.9}


@pytest.mark.parametrize("contexts", [[0, 1], [0, 0]],
                         ids=["cpu0_cpu1", "cpu0_twice"])
def test_module_two_contexts_device_kvstore(contexts):
    """`Module` over two contexts (distinct, and one context twice) with
    kvstore='device': the update runs on the store (the JAX rule without
    a fused step), each step from JAX Xavier parameters held against the
    JAX package's one-context step on the whole batch."""
    batch, steps = 16, 4
    sym = mlp()
    values = _jax_xavier(sym, batch)
    batches = _batches(steps, batch)

    jmod = jmx.mod.Module(jmx.sym.load_json(sym.tojson()), context=jmx.cpu())
    jmod.bind(data_shapes=[("data", (batch, 1, 8, 8))],
              label_shapes=[("softmax_label", (batch,))])
    jmod.init_params(arg_params={k: jmx.nd.array(v)
                                 for k, v in values.items()})
    jmod.init_optimizer(optimizer="sgd", optimizer_params=dict(OPT))

    tmod = tmx.mod.Module(sym, context=[tmx.cpu(i) for i in contexts])
    tmod.bind(data_shapes=[("data", (batch, 1, 8, 8))],
              label_shapes=[("softmax_label", (batch,))])
    tmod.init_params(arg_params=params_from_numpy(values, ctx=tmx.cpu())[0])
    tmod.init_optimizer(kvstore="device", optimizer="sgd",
                        optimizer_params=dict(OPT))
    assert tmod._update_on_kvstore and tmod._fused_step is None
    assert len(tmod._exec_group.execs) == 2
    a0 = tmod._exec_group.param_arrays[0]
    assert a0[0].data.data_ptr() != a0[1].data.data_ptr()
    for step, (x, y) in enumerate(batches):
        want = _step_module(jmx, jmod, x, y)
        got = _step_module(tmx, tmod, x, y)
        for k in want:
            _close(got[k], want[k], STEP_TOL, f"{k} after step {step + 1}")
        outs = tmod.get_outputs()[0]
        assert outs.shape == (batch, 10)
    # the store's momenta are the JAX updater's
    jstates = jmod._updater.states
    for i, name in enumerate(jmod._exec_group.param_names):
        _close(tmod._kvstore._updater.states[name].asnumpy(),
               jstates[i].asnumpy(), STEP_TOL, f"momentum of {name}")


def test_update_params_per_device_layout():
    """`model._update_params` (the update on each device's copy, the
    gradients summed through a local store first) against the JAX
    package's, with per-device updater indices ``i * ndev + k``."""
    from incubator_mxnet_tpu import model as jmodel
    from incubator_mxnet_tpu_torch import model as tmodel
    rng = np.random.RandomState(5)
    ws = [rng.randn(3, 4).astype("f4"), rng.randn(4).astype("f4")]
    gs = [[rng.randn(*w.shape).astype("f4") for _ in range(2)] for w in ws]

    def run(p, model):
        params = [[p.arr(w, k) for k in range(2)] for w in ws]
        grads = [[p.arr(g, k) for k, g in enumerate(gl)] for gl in gs]
        kv = p.mx.kv.create("local")
        for i, w in enumerate(ws):
            kv.init(f"p{i}", p.arr(w))
        opt = p.mx.optimizer.SGD(learning_rate=0.1, momentum=0.9)
        upd = p.mx.optimizer.get_updater(opt)
        for _ in range(2):
            model._update_params(params, grads, upd, 2, kvstore=kv,
                                 param_names=["p0", "p1"])
        return [[a.asnumpy() for a in pl] for pl in params], \
            sorted(upd.states)

    (jp, jidx), (tp, tidx) = run(JAX, jmodel), run(PORT, tmodel)
    assert tidx == jidx == [0, 1, 2, 3]
    for a, b in zip(tp, jp):
        for x, y in zip(a, b):
            _close(x, y, STEP_TOL)


def _near_ties(g, thr, eps=1e-5):
    return np.abs(np.abs(g) - thr) <= eps * thr


def test_module_kvstore_instance_2bit_compression():
    """`Module` given a `KVStore` instance and 2-bit
    ``compression_params``: no fused step, the update on the store, one
    residual per key — as the JAX `Module` does.  Held against the JAX
    package step by step: the codes pushed equal outside counted near
    ties (an element within 1e-5 of the threshold may quantize the other
    way after fp32 sums in another order), the parameters rtol 1e-5 +
    1e-6 * max|array| where no code differed."""
    batch, steps, thr = 16, 4, 0.5
    sym = mlp()
    values = _jax_xavier(sym, batch)
    batches = _batches(steps, batch, seed=1)
    comp = {"type": "2bit", "threshold": thr}

    def module(mx, ctx, init):
        mod = mx.mod.Module(mx.sym.load_json(sym.tojson()), context=ctx,
                            compression_params=comp)
        mod.bind(data_shapes=[("data", (batch, 1, 8, 8))],
                 label_shapes=[("softmax_label", (batch,))])
        mod.init_params(arg_params=init)
        kv = mx.kv.create("local")
        mod.init_optimizer(kvstore=kv, optimizer="sgd",
                           optimizer_params=dict(OPT))
        assert mod._update_on_kvstore and mod._fused_step is None
        codes = {}
        orig = kv._compress

        def spy(sk, merged):
            resid = kv._residuals.get(sk)
            g = merged.asnumpy() + (0 if resid is None else _host(resid))
            q = orig(sk, merged)
            codes[sk] = (g, q.asnumpy())
            return q
        kv._compress = spy
        return mod, codes

    jmod, jcodes = module(jmx, jmx.cpu(), {k: jmx.nd.array(v)
                                           for k, v in values.items()})
    tmod, tcodes = module(tmx, tmx.cpu(),
                          params_from_numpy(values, ctx=tmx.cpu())[0])
    flipped = {k: np.zeros(v.shape, bool) for k, v in values.items()}
    ties = 0
    for step, (x, y) in enumerate(batches):
        want = _step_module(jmx, jmod, x, y)
        got = _step_module(tmx, tmod, x, y)
        for k in values:
            (tg, tq), (jg, jq) = tcodes[k], jcodes[k]
            near = _near_ties(jg, thr)
            ties += int(near.sum())
            differ = (tq != jq).reshape(flipped[k].shape)
            assert not (differ & ~near.reshape(differ.shape)).any(), \
                f"{k}: codes differ away from a near tie at step {step}"
            flipped[k] |= differ
            keep = ~flipped[k]
            _close(got[k][keep], want[k][keep], STEP_TOL,
                   f"{k} after step {step + 1}")
    print(f"near ties {ties}, codes flipped "
          f"{sum(int(f.sum()) for f in flipped.values())}")
    assert sorted(tmod._kvstore._residuals) == sorted(jmod._kvstore.
                                                      _residuals)


def test_trainer_dist_store_on_one_context():
    """`gluon.Trainer(kvstore='dist_sync')` on one context creates the
    store at the first step and initializes a key per trained parameter;
    with one context no gradient is pushed (the JAX Trainer pushes only
    gradients held on several contexts), so its steps equal the
    store-less trainer's bit for bit."""
    from incubator_mxnet_tpu_torch import autograd, gluon
    rng = np.random.RandomState(0)
    x = tmx.nd.array(rng.randn(8, 5), ctx=tmx.cpu())
    out = {}
    for kind in ("device", "dist_sync"):
        net = gluon.nn.Dense(3, in_units=5)
        net.initialize(tmx.init.Constant(0.1), ctx=tmx.cpu())
        trainer = gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.1, "momentum": 0.9},
                                kvstore=kind)
        for _ in range(3):
            with autograd.record():
                loss = (net(x) ** 2).sum()
            loss.backward()
            trainer.step(8)
        out[kind] = [p.data().asnumpy()
                     for p in net.collect_params().values()]
        if kind == "dist_sync":
            kv = trainer._kvstore
            assert kv is not None and kv.type == "dist_sync"
            assert sorted(kv._store) == ["0", "1"]
        else:
            assert trainer._kvstore is None
    for a, b in zip(out["dist_sync"], out["device"]):
        np.testing.assert_array_equal(a, b)


def _fit_two_contexts(kvstore, ckpt_dir=None, resume=False, crash_at=None):
    tmx.random.seed(7)
    np.random.seed(7)
    rng = np.random.RandomState(1)
    x = rng.randn(64, 1, 8, 8).astype("f4")
    y = rng.randint(0, 10, 64).astype("f4")
    it = tmx.io.NDArrayIter(x, y, batch_size=8, shuffle=True)
    mod = tmx.mod.Module(mlp(), context=[tmx.cpu(0), tmx.cpu(1)])

    class _Crash(Exception):
        pass

    def crash(param):
        crash.hits += 1
        if crash.hits == crash_at:
            raise _Crash()
    crash.hits = 0
    try:
        mod.fit(it, kvstore=kvstore, optimizer="sgd",
                optimizer_params=dict(OPT), num_epoch=2,
                initializer=tmx.init.Xavier(magnitude=2.0),
                checkpoint_dir=ckpt_dir, checkpoint_period=1, resume=resume,
                batch_end_callback=crash if crash_at else None)
    except _Crash:
        pass
    return mod


@pytest.mark.parametrize("kvstore", ["device", "local"])
def test_module_fit_checkpoint_resume_on_kvstore(tmp_path, kvstore):
    """`Module.fit(checkpoint_dir=...)` over two contexts with the update
    on the kvstore: the snapshot takes the store's optimizer states, and
    a run stopped mid-epoch and resumed ends bit for bit where an
    uninterrupted run does (parameters, the store's momenta, the update
    count)."""
    from incubator_mxnet_tpu_torch import checkpoint as ckpt
    full = _fit_two_contexts(kvstore)
    assert full._update_on_kvstore and full._updater is None
    _fit_two_contexts(kvstore, str(tmp_path), crash_at=11)
    assert ckpt.latest(str(tmp_path)) is not None
    resumed = _fit_two_contexts(kvstore, str(tmp_path), resume=True)
    fa, ra = full.get_params()[0], resumed.get_params()[0]
    for k in fa:
        np.testing.assert_array_equal(ra[k].asnumpy(), fa[k].asnumpy(),
                                      err_msg=k)
    fu, ru = full._kvstore._updater, resumed._kvstore._updater
    assert sorted(fu.states) == sorted(ru.states)
    for k in fu.states:
        np.testing.assert_array_equal(ru.states[k].asnumpy(),
                                      fu.states[k].asnumpy(),
                                      err_msg=f"momentum of {k}")
    assert ru.optimizer.num_update == fu.optimizer.num_update == 16
