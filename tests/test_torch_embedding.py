"""The port's sharded embedding tier (`embedding/`) against the JAX
package on the CPU.

The cases of `tests/test_embedding.py` that need neither the serving
fleet's `ReplicaRouter` nor fault injection, each run through both
packages on the same inputs: the partition rule, seeded shard init, the
hot-row cache (hits, misses, evictions, LRU order, rows returned),
lookups, the shard-side lazy SGD and Adam on pushed rows (rtol 1e-6),
failure diagnosis, `replace_shard`, the chunked checkpoint round trip,
and `Module.fit` through the `EmbeddingFitAdapter`; the
`EmbeddingServingPath` in front of a tower served by a `ReplicaRouter`,
through a shard's death.  Then
`examples/recommender/wide_deep.py`'s copy on the port (`chip_smoke`'s
`wide_deep`): its tower is the example's, and one epoch at 2 000 rows
from the same tower parameters and table seed ends with the table and
the tower within rtol 1e-5 + 1e-6 * max|array| of the JAX package's run.
"""
import importlib.util
import os
import threading
import time

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu import embedding as jemb
from incubator_mxnet_tpu_torch import embedding as temb
from incubator_mxnet_tpu_torch.compat.weights import (
    params_from_numpy, table_rows_from_numpy, table_rows_to_numpy)
from incubator_mxnet_tpu_torch.resilience import ServerLostError

import chip_smoke as cs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = (1e-6, 1e-6)
FIT_TOL = (1e-5, 1e-6)


@pytest.fixture(autouse=True)
def fast_failover(monkeypatch):
    monkeypatch.setenv("MXNET_PS_RECONNECT_WAIT", "0.05")
    monkeypatch.setenv("MXNET_PS_MAX_RETRIES", "2")
    monkeypatch.setenv("MXNET_EMBED_BREAKER_THRESHOLD", "2")
    monkeypatch.setenv("MXNET_PS_REQUEST_TIMEOUT", "60")


def _close(got, want, tol=TOL, what=""):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want,
                               rtol=tol[0],
                               atol=tol[1] * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _spawn(n, jax=False):
    if jax:
        from incubator_mxnet_tpu.dist.server import ParameterServer
    else:
        from incubator_mxnet_tpu_torch.dist.server import ParameterServer
    return [ParameterServer(num_workers=1).start() for _ in range(n)]


def _addrs(servers):
    return [("127.0.0.1", s.port) for s in servers]


def _table(jax, name, rows, dim, servers, **kw):
    if jax:
        return jemb.ShardedEmbedding(name, rows, dim, _addrs(servers), **kw)
    return temb.ShardedEmbedding(name, rows, dim, _addrs(servers),
                                 ctx=tmx.cpu(), **kw)


class Both:
    """One table per package, each on its own package's servers."""

    def __init__(self, n_servers, *args, make_opt=None, **kw):
        self.servers = {j: _spawn(n_servers, jax=j) for j in (True, False)}
        self.t = {}
        for j, mx in ((True, jmx), (False, tmx)):
            extra = dict(kw)
            if make_opt is not None:
                extra["optimizer"] = make_opt(mx)
            self.t[j] = _table(j, *args, self.servers[j], **extra)

    def close(self):
        for t in self.t.values():
            t.close()
        for ss in self.servers.values():
            for s in ss:
                s.shutdown()


def test_shard_of_ids_equal_jax():
    ids = np.arange(10_000)
    for n in (1, 3, 4):
        for part in ("range", "hash"):
            np.testing.assert_array_equal(
                temb.shard_of_ids(ids, 10_000, n, part),
                jemb.shard_of_ids(ids, 10_000, n, part))
    with pytest.raises(tmx.MXNetError, match="unknown partition"):
        temb.ShardedEmbedding("t", 10, 2, [("127.0.0.1", 1)],
                              partition="modulo", ctx=tmx.cpu())


@pytest.mark.parametrize("partition", ["range", "hash"])
def test_seeded_init_equal_jax(partition):
    both = Both(2, "det", 10, 4, seed=11, partition=partition, cache_rows=0)
    try:
        a = both.t[False].pull_rows(np.arange(10))
        np.testing.assert_array_equal(a, both.t[True].pull_rows(
            np.arange(10)))
        init = np.arange(40, dtype=np.float32).reshape(10, 4)
        t4 = _table(False, "explicit", 10, 4, both.servers[False],
                    partition=partition, cache_rows=0, init_values=init)
        np.testing.assert_array_equal(t4.pull_rows(np.arange(10)), init)
        t4.close()
    finally:
        both.close()


def test_lookup_shape_and_cache_hotness():
    both = Both(2, "shape", 64, 8, seed=3, cache_rows=32)
    try:
        ids = np.array([[1, 40], [5, 1]])
        outs = {j: t.lookup(ids, out_np=True) for j, t in both.t.items()}
        np.testing.assert_array_equal(outs[False], outs[True])
        t = both.t[False]
        assert outs[False].shape == (2, 2, 8)
        pulled = sum(t._pulled)
        for tj in both.t.values():
            again = tj.lookup(ids)
            np.testing.assert_array_equal(np.asarray(again), outs[False])
        assert again.shape == (2, 2, 8) and again.device.type == "cpu"
        assert sum(t._pulled) == pulled     # fully cache-hot
        assert t.stats()["cache"] == both.t[True].stats()["cache"]
        assert t.stats()["cache"]["hit_rate"] > 0
    finally:
        both.close()


def test_push_grad_sgd_with_duplicate_id_aggregation():
    both = Both(1, "sgd", 8, 2, cache_rows=0,
                init_values=np.zeros((8, 2), np.float32),
                make_opt=lambda mx: mx.optimizer.SGD(learning_rate=0.5))
    try:
        for t in both.t.values():
            t.push_grad(np.array([3, 5, 3]), np.ones((3, 2), np.float32))
        out = both.t[False].pull_rows(np.arange(8))
        np.testing.assert_array_equal(out, both.t[True].pull_rows(
            np.arange(8)))
        assert np.allclose(out[3], -1.0) and np.allclose(out[5], -0.5)
        both.t[False].assign_rows([3], np.full((1, 2), 7.0, np.float32))
        assert np.allclose(both.t[False].pull_rows([3]), 7.0)
    finally:
        both.close()


@pytest.mark.parametrize("make_opt", [
    lambda mx: mx.optimizer.SGD(learning_rate=0.1, momentum=0.9),
    lambda mx: mx.optimizer.Adam(learning_rate=0.01),
], ids=["sgd_momentum", "adam"])
def test_shard_side_lazy_update_matches_jax(make_opt):
    """The port's server applies the lazy row-sparse step on its shard:
    bit for bit the port's own local update of the same rows, within
    rtol 1e-6 of the JAX server's; the cached copies refresh from the
    push replies."""
    from incubator_mxnet_tpu_torch.ndarray.sparse import RowSparseNDArray
    rng = np.random.RandomState(5)
    init = rng.randn(12, 3).astype(np.float32)
    both = Both(1, "parity", 12, 3, cache_rows=4, init_values=init,
                make_opt=make_opt)
    try:
        ref_w = tmx.nd.array(init, ctx=tmx.cpu())
        ref_upd = tmx.optimizer.get_updater(make_opt(tmx))
        for step in range(3):
            ids = np.array([1, 7, 4, 7])
            vals = rng.randn(4, 3).astype(np.float32)
            for t in both.t.values():
                t.lookup(ids[:2])
                t.push_grad(ids, vals)
            ref_upd("embed:parity", RowSparseNDArray(vals, ids, (12, 3)),
                    ref_w)
        got = both.t[False].pull_rows(np.arange(12))
        np.testing.assert_array_equal(got, ref_w.asnumpy())
        _close(got, both.t[True].pull_rows(np.arange(12)))
        np.testing.assert_array_equal(both.t[False].lookup(
            np.array([1, 7]), out_np=True), got[[1, 7]])
    finally:
        both.close()


def test_push_without_optimizer_is_structured_error():
    servers = _spawn(1)
    t = _table(False, "noopt", 4, 2, servers, cache_rows=0)
    try:
        with pytest.raises(tmx.MXNetError, match="set_optimizer"):
            t.push_grad([1], np.ones((1, 2), np.float32))
        t.assign_rows([1], np.full((1, 2), 9.0, np.float32))
        assert np.allclose(t.pull_rows([1]), 9.0)
    finally:
        t.close()
        servers[0].shutdown()


def test_partition_disagreement_is_structured_error():
    servers = _spawn(2)
    t = _table(False, "oob", 10, 2, servers, cache_rows=0)
    try:
        with pytest.raises(tmx.MXNetError, match="partition rules disagree"):
            t._request(0, {"cmd": "embed_pull", "table": "oob",
                           "ids": np.array([9])})
    finally:
        t.close()
        for s in servers:
            s.shutdown()


# -- the hot-row cache ----------------------------------------------------------

def _caches(capacity, dim=2):
    return {True: jemb.HotRowCache(dim=dim, capacity=capacity, name="t"),
            False: temb.HotRowCache(dim=dim, capacity=capacity, name="t",
                                    ctx=tmx.cpu())}


def _id_rows(ids):
    return np.repeat(np.asarray(ids, np.float32)[:, None], 2, axis=1)


def test_cache_hits_misses_evictions_and_lru_order():
    caches = _caches(3)
    seq = [[1, 2, 1], [3], [1], [4], [3, 1, 4], [2]]
    for j, c in caches.items():
        pulls, got = [], []

        def pull(ids):
            pulls.append(list(ids))
            return _id_rows(ids)
        for ids in seq:
            rows, h, m = c.lookup(np.array(ids), pull)
            got.append((np.asarray(rows).tolist(), h, m))
        caches[j] = (c.stats(), pulls, got)
    assert caches[False] == caches[True]
    stats, pulls, got = caches[False]
    assert got[0][1:] == (0, 3) and pulls[0] == [1, 2]
    assert stats["evictions"] == 2 and stats["rows"] == 3
    assert got[4][2] == 0 and got[5][2] == 1


def test_cache_refresh_updates_resident_rows_only():
    for j, c in _caches(4).items():
        c.insert([1, 2], np.zeros((2, 2), np.float32))
        c.refresh(np.array([2, 9]), np.ones((2, 2), np.float32))
        rows, _, m = c.lookup(np.array([1, 2]), None)
        assert m == 0
        assert np.allclose(np.asarray(rows), [[0, 0], [1, 1]])
        assert c.stats()["rows"] == 2


def test_cache_insert_duplicate_ids_keeps_last_row():
    """One row per slot: an id inserted twice in one call keeps its last
    row (CUDA's index_copy_ is undefined under duplicate slots)."""
    c = temb.HotRowCache(dim=2, capacity=4, ctx=tmx.cpu())
    c.insert([5, 6, 5], np.array([[1, 1], [2, 2], [3, 3]], np.float32))
    rows, h, m = c.lookup(np.array([5, 6]), None)
    assert (h, m) == (2, 0) and c.stats()["rows"] == 2
    np.testing.assert_array_equal(rows.numpy(), [[3, 3], [2, 2]])


def test_cache_capacity_overflow_is_explicit():
    for c in _caches(2).values():
        with pytest.raises(ValueError, match="MXNET_EMBED_CACHE_ROWS"):
            c.lookup(np.array([1, 2, 3]),
                     lambda ids: np.zeros((len(ids), 2), np.float32))


def test_cache_overflow_with_resident_rows_raises_instead_of_looping():
    for c in _caches(4).values():
        pulls = []

        def pull(ids):
            pulls.append(list(ids))
            return _id_rows(ids)
        c.lookup(np.array([0, 1, 2]), pull)
        pulls.clear()
        with pytest.raises(ValueError, match="MXNET_EMBED_CACHE_ROWS"):
            c.lookup(np.arange(6), pull)
        assert pulls == []


def test_cache_concurrent_lookups_return_correct_rows():
    c = temb.HotRowCache(dim=1, capacity=8, name="t", ctx=tmx.cpu())
    errs = []

    def worker(base):
        try:
            rng = np.random.RandomState(base)
            for _ in range(60):
                ids = rng.randint(base, base + 100, size=6)
                rows, _, _ = c.lookup(
                    ids, lambda i: np.asarray(i, np.float32)[:, None])
                got = np.asarray(rows)[:, 0]
                assert np.array_equal(got, ids.astype(np.float32)), \
                    f"lookup({ids}) returned rows for {got}"
        except Exception as e:            # pragma: no cover - failure
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(b,))
               for b in (0, 1000, 2000)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs, errs[:1]


# -- failure semantics ------------------------------------------------------------


def test_cache_first_lookups_share_one_buffer(monkeypatch):
    """Two first lookups racing to allocate the device buffer: the one
    whose allocation is slow must not replace the buffer the other has
    already written rows into."""
    from incubator_mxnet_tpu_torch.embedding import cache as cmod
    zeros = torch.zeros

    class SlowZeros:
        def __getattr__(self, name):
            return getattr(torch, name)

        def zeros(self, *args, **kwargs):
            if threading.current_thread().name == "slow":
                time.sleep(0.3)
            return zeros(*args, **kwargs)
    monkeypatch.setattr(cmod, "torch", SlowZeros())
    c = temb.HotRowCache(dim=1, capacity=8, name="t", ctx=tmx.cpu())
    pull = lambda i: np.asarray(i, np.float32)[:, None]
    wrong = []

    def fast():
        ids = np.array([1, 2, 3])
        for _ in range(40):
            rows, _, _ = c.lookup(ids, pull)
            if not np.array_equal(np.asarray(rows)[:, 0], ids):
                wrong.append(np.asarray(rows)[:, 0])
            time.sleep(0.01)
    slow = threading.Thread(target=c.lookup, args=(np.array([100]), pull),
                            name="slow")
    slow.start()
    time.sleep(0.01)
    other = threading.Thread(target=fast)
    other.start()
    slow.join()
    other.join()
    assert not wrong, wrong[:1]


def test_dead_shard_raises_server_lost_naming_shard_and_rows():
    servers = _spawn(2)
    t = _table(False, "loss", 100, 2, servers, cache_rows=0)
    try:
        servers[1]._simulate_crash()
        with pytest.raises(ServerLostError) as ei:
            t.pull_rows(np.array([80]))
        assert ei.value.server == 1
        assert "loss[50:100]" in str(ei.value.keys)
        assert t.pull_rows(np.array([10])).shape == (1, 2)
        assert t.stats()["shards"]["1"]["breaker"] == "open"
    finally:
        t.close()
        for s in servers:
            s.shutdown()


def test_restarted_empty_shard_is_diagnosed():
    from incubator_mxnet_tpu_torch.dist.transport import Channel
    servers = _spawn(1)
    fresh = _spawn(1)
    t = _table(False, "amnesia", 10, 2, servers, cache_rows=0)
    try:
        old = t._chans[0]
        t._chans[0] = Channel("127.0.0.1", fresh[0].port)
        with pytest.raises(ServerLostError, match="restarted without state"):
            t.pull_rows(np.array([1]))
        old.close()
    finally:
        t.close()
        for s in servers + fresh:
            s.shutdown()


def test_replace_shard_restores_rows():
    servers = _spawn(2)
    respawn = []
    t = _table(False, "heal", 20, 2, servers, seed=4, cache_rows=8,
               optimizer=tmx.optimizer.SGD(learning_rate=0.1))
    try:
        t.push_grad(np.array([3, 15]), np.ones((2, 2), np.float32))
        ckpt = t.checkpoint_rows()
        servers[1]._simulate_crash()
        with pytest.raises(ServerLostError):
            t.pull_rows(np.array([15]))
        respawn = _spawn(1)
        t.replace_shard(1, "127.0.0.1", respawn[0].port, restore=ckpt)
        np.testing.assert_array_equal(t.checkpoint_rows(), ckpt)
        st = t.stats()
        assert st["failovers"] == 1 and st["shards"]["1"]["breaker"] == \
            "closed"
        t.push_grad(np.array([15]), np.ones((1, 2), np.float32))
        assert np.allclose(t.pull_rows([15]), ckpt[15] - 0.1)
    finally:
        t.close()
        for s in servers + respawn:
            s.shutdown()


def test_checkpoint_restore_chunked_and_across_packages(monkeypatch):
    """`checkpoint_rows` / `restore_rows` in chunks, and a table's rows
    carried both ways between the packages through `compat.weights`."""
    monkeypatch.setenv("MXNET_EMBED_PULL_CHUNK", "7")
    both = Both(2, "ck1", 23, 3, seed=1, cache_rows=0)
    other = _table(False, "ck2", 23, 3, both.servers[False], seed=2,
                   cache_rows=0)
    try:
        ckpt = table_rows_to_numpy(both.t[False])
        np.testing.assert_array_equal(ckpt, table_rows_to_numpy(
            both.t[True]))
        assert not np.array_equal(other.checkpoint_rows(), ckpt)
        table_rows_from_numpy(other, ckpt)
        np.testing.assert_array_equal(other.checkpoint_rows(), ckpt)
        moved = ckpt * 2 + 1
        table_rows_from_numpy(both.t[True], moved)
        table_rows_from_numpy(other, both.t[True].checkpoint_rows())
        np.testing.assert_array_equal(other.checkpoint_rows(), moved)
        with pytest.raises(tmx.MXNetError, match="checkpoint shape"):
            other.restore_rows(np.zeros((5, 3), np.float32))
    finally:
        other.close()
        both.close()


def test_local_kvstore_has_no_embedding_plane():
    with pytest.raises(tmx.MXNetError, match="parameter-server plane"):
        tmx.kv.create("local").embedding("t", 10, 2)


def test_dist_kvstore_embedding_factory(monkeypatch):
    servers = _spawn(1)
    for k, v in {"DMLC_PS_ROOT_URI": "127.0.0.1",
                 "DMLC_PS_ROOT_PORT": str(servers[0].port),
                 "DMLC_RANK": "0", "DMLC_NUM_WORKER": "1"}.items():
        monkeypatch.setenv(k, v)
    kv = tmx.kv.create("dist_async")
    try:
        assert kv.server_addresses() == [("127.0.0.1", servers[0].port)]
        init = np.arange(12, dtype=np.float32).reshape(6, 2)
        t = kv.embedding("kvfac", 6, 2, cache_rows=0, init_values=init,
                         ctx=tmx.cpu())
        np.testing.assert_array_equal(t.pull_rows(np.arange(6)), init)
        kv.init(1, tmx.nd.ones((3,), ctx=tmx.cpu()))
        t.close()
    finally:
        kv.close()
        servers[0].shutdown()


# -- wide_deep.py -------------------------------------------------------------------

def _example():
    spec = importlib.util.spec_from_file_location(
        "_wide_deep", os.path.join(REPO, "examples", "recommender",
                                   "wide_deep.py"))
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    return ex


def _in_thread(fn):
    """fn() in a fresh thread: the symbol name counters are per thread,
    so two builds there name their unnamed nodes alike."""
    out = []
    t = threading.Thread(target=lambda: out.append(fn()))
    t.start()
    t.join(timeout=60)
    assert not t.is_alive()
    return out[0]


def test_wide_deep_copy_is_the_example():
    """chip_smoke's copy of the example writes the example's tower JSON
    and draws the example's click stream."""
    import json
    ex = _example()
    want = json.loads(_in_thread(lambda: ex.tower(ex.SLOTS * 16, 4)
                                 .tojson()))
    got = json.loads(_in_thread(lambda: cs.wd_tower(
        tmx, cs.WD_SLOTS * 16, 4).tojson()))
    # the graphs, not the writer's name in the file's attrs
    assert got.pop("attrs")["framework"] != want.pop("attrs")["framework"]
    assert got == want
    a = ex.synthetic_clicks(256, 1000, np.random.RandomState(0))
    b = cs.wd_clicks(256, 1000, np.random.RandomState(0))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def _jax_wide_deep(cfg, arg_params):
    """The example's `main` on the JAX package (its own functions), from
    the given tower parameters, collecting the per-batch loss."""
    ex = _example()
    servers = _spawn(cfg["shards"], jax=True)
    table = jemb.ShardedEmbedding(
        "user_item", cfg["rows"], cfg["dim"], _addrs(servers), seed=7,
        cache_rows=cfg["cache_rows"],
        optimizer=jmx.optimizer.SGD(learning_rate=cfg["lr"],
                                    rescale_grad=1.0 / cfg["batch"]))
    try:
        ids, dense, label = ex.synthetic_clicks(cfg["samples"], cfg["rows"],
                                                np.random.RandomState(0))
        base = jmx.io.NDArrayIter({"emb": ids.astype(np.float32),
                                   "dense": dense}, {"softmax_label": label},
                                  batch_size=cfg["batch"])
        adapter = jemb.EmbeddingFitAdapter(table, base, id_field=0)
        mod = jmx.mod.Module(ex.tower(ex.SLOTS * cfg["dim"], 4),
                             data_names=("emb", "dense"),
                             label_names=("softmax_label",),
                             context=jmx.cpu())
        mod.bind(data_shapes=adapter.provide_data,
                 label_shapes=adapter.provide_label, for_training=True,
                 inputs_need_grad=True)
        mod.fit(adapter, num_epoch=cfg["epochs"], optimizer="sgd",
                optimizer_params={"learning_rate": cfg["lr"],
                                  "rescale_grad": 1.0 / cfg["batch"]},
                arg_params={k: jmx.nd.array(v) for k, v in
                            arg_params.items()},
                batch_end_callback=adapter.make_callback(mod),
                eval_metric="acc")
        return ({k: v.asnumpy() for k, v in mod.get_params()[0].items()},
                table.checkpoint_rows(), adapter.pushes)
    finally:
        table.close()
        for s in servers:
            s.shutdown()


def test_wide_deep_one_epoch_matches_jax(monkeypatch):
    """One epoch of the example at 2 000 rows (its other defaults), port
    against JAX from the same tower parameters (the JAX package's draw,
    carried by `compat.weights`) and the same seeded table."""
    monkeypatch.setenv("MXNET_SUBGRAPH_BACKEND", "TPU_PALLAS")
    cfg = dict(cs.WD_CFG, rows=2000, samples=1024, epochs=1)
    sym = cs.wd_tower(tmx, cs.WD_SLOTS * cfg["dim"], 4)
    shapes, _, _ = sym.infer_shape(emb=(cfg["batch"], 32),
                                   dense=(cfg["batch"], 4))
    rng = np.random.RandomState(1)
    init = {n: rng.uniform(-0.3, 0.3, s).astype(np.float32)
            for n, s in zip(sym.list_arguments(), shapes)
            if n not in ("emb", "dense", "softmax_label")}
    monkeypatch.delenv("MXNET_SUBGRAPH_BACKEND")
    want, want_table, want_pushes = _jax_wide_deep(cfg, init)
    monkeypatch.setenv("MXNET_SUBGRAPH_BACKEND", "TPU_PALLAS")
    run = cs.wide_deep(tmx, cfg, tmx.cpu(),
                       arg_params={k: v for k, v in params_from_numpy(
                           init, ctx=tmx.cpu())[0].items()})
    try:
        got = {k: v.asnumpy() for k, v in run["mod"].get_params()[0].items()}
        got_table = run["table"].checkpoint_rows()
        assert run["adapter"].pushes == want_pushes == 1024 // 64
        assert run["mod"]._exec_group.execs[0]._symbol.tojson().count(
            '"_sg_pallas_fc_relu"') == 1
    finally:
        cs.wide_deep_close(run)
    for k in want:
        _close(got[k], want[k], FIT_TOL, k)
    _close(got_table, want_table, FIT_TOL, "table")


# -- the serving path ---------------------------------------------------------

def _tower_prefix(tmp_path, dim):
    """wide_deep's tower under TPU_PALLAS (deep1 is K1's node), seeded,
    as a checkpoint pair written by the port."""
    sym = tmx.subgraph.partition_graph(
        _in_thread(lambda: cs.wd_tower(tmx, cs.WD_SLOTS * dim, 4,
                                       hidden=8)), "TPU_PALLAS")
    assert sym.tojson().count('"_sg_pallas_fc_relu"') == 1
    shapes, _, _ = sym.infer_shape(emb=(1, cs.WD_SLOTS * dim),
                                   dense=(1, 4))
    rng = np.random.RandomState(3)
    params = {n: rng.normal(0, 0.5, s).astype(np.float32)
              for n, s in zip(sym.list_arguments(), shapes)
              if n not in ("emb", "dense", "softmax_label")}
    prefix = str(tmp_path / "tower")
    tmx.save_checkpoint(prefix, 0, sym, params_from_numpy(
        params, None, ctx=tmx.cpu())[0], {})
    return prefix


def test_serving_path_equals_jax_and_survives_shard_kill(tmp_path):
    """Both packages' paths on their own shard servers (the same seeded
    rows) and the same tower behind a router of two `LocalReplica`s:
    answers equal within 1e-5 + 1e-6; a shard killed mid-traffic is
    respawned by ``on_shard_lost`` (`replace_shard` from the checkpoint
    rows) and no admitted request is lost."""
    from incubator_mxnet_tpu.serving import LocalReplica as JLocal
    from incubator_mxnet_tpu.serving import ReplicaRouter as JRouter
    from incubator_mxnet_tpu_torch.serving import LocalReplica, ReplicaRouter
    rows, dim = 40, 4
    prefix = _tower_prefix(tmp_path, dim)
    rng = np.random.RandomState(4)
    reqs = [(rng.randint(0, rows, (n, cs.WD_SLOTS)),
             rng.randn(n, 4).astype(np.float32)) for n in (1, 3, 2, 4)]
    answers, stats = {}, {}
    for jax, mx, local, router_cls in ((True, jmx, JLocal, JRouter),
                                       (False, tmx, LocalReplica,
                                        ReplicaRouter)):
        emb = jemb if jax else temb
        servers = _spawn(2, jax=jax)
        spawned = []
        table = _table(jax, "serve", rows, dim, servers, seed=9,
                       cache_rows=8)
        ckpt = table.checkpoint_rows()

        def on_shard_lost(err, table=table, ckpt=ckpt, jax=jax,
                          spawned=spawned):
            spawned.append(_spawn(1, jax=jax)[0])
            table.replace_shard(err.server, "127.0.0.1", spawned[-1].port,
                                restore=ckpt)
            return True

        reps = [local(mx.serving.ServedModel.load(
            prefix, 0, data_shapes=[("emb", (1, cs.WD_SLOTS * dim)),
                                    ("dense", (1, 4))],
            buckets=(1, 2, 4), ctx=mx.cpu(), name="tower"),
            replica_id=f"r{i}") for i in range(2)]
        try:
            with router_cls(reps, health_interval_s=0.2) as router:
                path = emb.EmbeddingServingPath(
                    table, router, embed_input="emb",
                    on_shard_lost=on_shard_lost)
                got = [path.predict(ids, dense={"dense": d},
                                    timeout_ms=10000)[0].asnumpy()
                       for ids, d in reqs]
                servers[0]._simulate_crash()   # shard 0 dies mid-traffic
                got += [path.predict(ids, dense={"dense": d},
                                     timeout_ms=10000)[0].asnumpy()
                        for ids, d in reqs]
                stats[jax] = path.stats()
            answers[jax] = got
        finally:
            table.close()
            for srv in servers + spawned:
                try:
                    srv.shutdown()
                except Exception:
                    pass
    for g, w in zip(answers[False], answers[True]):
        _close(g, w, (1e-5, 1e-6))
    for g, w in zip(answers[False][4:], answers[False][:4]):
        np.testing.assert_array_equal(g, w)   # the same rows after heal
    st = stats[False]
    assert st["shard_failovers"] >= 1
    assert st["completed"] == st["requests"] == 8   # zero lost
    assert st["table"]["failovers"] == 1
    assert stats[True]["completed"] == 8


def test_serving_path_without_hook_propagates():
    from incubator_mxnet_tpu_torch.serving import LocalReplica, ReplicaRouter
    servers = _spawn(1)
    table = _table(False, "nohook", 8, 4, servers, cache_rows=0)
    sym = tmx.sym.SoftmaxOutput(tmx.sym.FullyConnected(
        tmx.sym.Variable("emb"), num_hidden=3, name="head"), name="softmax")
    model = tmx.serving.ServedModel(
        sym, {"head_weight": np.ones((3, 4), np.float32),
              "head_bias": np.zeros(3, np.float32)},
        data_shapes=[("emb", (1, 4))], buckets=(1, 2), ctx=tmx.cpu())
    try:
        with ReplicaRouter([LocalReplica(model, replica_id="r0")],
                           health_interval_s=0.2) as router:
            path = temb.EmbeddingServingPath(table, router)
            servers[0]._simulate_crash()
            with pytest.raises(ServerLostError):
                path.predict(np.array([[1], [2]]), timeout_ms=2000)
    finally:
        table.close()
        servers[0].shutdown()


class _HeldChannel:
    """Wraps a shard's channel: `request` holds until released, and a
    `close` that arrives while a request is inside is recorded."""

    def __init__(self, chan):
        self.chan, self.host, self.port = chan, chan.host, chan.port
        self.inside = threading.Event()
        self.release = threading.Event()
        self.closed_inside = False

    def request(self, msg):
        self.inside.set()
        try:
            self.release.wait(30)
            return self.chan.request(msg)
        finally:
            self.inside.clear()

    def resend_last(self):
        return self.chan.resend_last()

    def close(self):
        self.closed_inside = self.closed_inside or self.inside.is_set()
        self.chan.close()


@pytest.mark.parametrize("jax", [True, False])
def test_replace_shard_waits_for_a_request_in_flight(jax):
    """A lookup is mid-request on shard 1 when `replace_shard` re-attaches
    it: the port's swap takes the shard's request lock and waits, so the
    request ends on the channel it started on; the JAX method closes that
    channel under it (ROADMAP Queue 3), which a serving path's concurrent
    lookups hit as a dead socket."""
    servers = _spawn(2, jax=jax)
    fresh = []
    t = _table(jax, "inflight", 20, 2, servers, seed=2, cache_rows=0)
    try:
        rows = t.checkpoint_rows()
        held = t._chans[1] = _HeldChannel(t._chans[1])
        got, errors = [], []

        def lookup():
            try:
                got.append(t.pull_rows(np.array([15])))
            except Exception as exc:
                errors.append(exc)

        reader = threading.Thread(target=lookup)
        reader.start()
        assert held.inside.wait(10)
        fresh = _spawn(1, jax=jax)
        swap = threading.Thread(target=t.replace_shard, args=(
            1, "127.0.0.1", fresh[0].port), kwargs={"restore": rows})
        swap.start()
        swap.join(0.5)
        held.release.set()
        reader.join(30)
        swap.join(30)
        assert not reader.is_alive() and not swap.is_alive()
        assert held.closed_inside is jax
        if not jax:
            assert not errors
            np.testing.assert_array_equal(got[0], rows[[15]])
        np.testing.assert_array_equal(t.pull_rows(np.array([15])),
                                      rows[[15]])
    finally:
        t.close()
        for s in servers + fresh:
            s.shutdown()


def test_serving_path_counts_every_request_across_threads():
    """16 threads submit through one path with the interpreter switching
    threads every microsecond: the request and completion counts are
    exact (the port counts under a lock)."""
    import sys
    from concurrent.futures import Future

    class _Table:
        def lookup(self, ids, out_np=False):
            return np.zeros(ids.shape + (2,), np.float32)

    class _Router:
        def submit(self, inputs, **kw):
            f = Future()
            f.set_result([inputs["emb"]])
            return f

    path = temb.EmbeddingServingPath(_Table(), _Router())
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            path.submit(np.array([[1, 2]])) for _ in range(200)])
            for _ in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    assert path.requests == path.completed == 16 * 200
