"""The h2d staging ring of the PyTorch port (`io_plane`) on the CPU.

`DevicePrefetchIter` yields the inner iterator's batches in order, epoch
after epoch; `seek`, `checkpoint_state`, `set_checkpoint_state`,
`set_quarantine`, `apply_quarantine` and `record_range` reach the inner
iterator; a consumer that waits on an empty queue counts a stall; an
error in the inner iterator or the copy surfaces on the consumer's
thread; a staging buffer goes back to its pool only once its copy is
done; a stale feeder cannot deliver into a restarted epoch.
`Module.fit` wraps its training iterator in the ring with the fused
step's placement (``MXNET_IO_RING``), and the batches it trains on are
the same with and without it.  The ordering on the card (the copy
stream, the event the compute stream waits on, pinned buffers) is held
by the card tests in `tests/test_torch_kernels_cuda.py`.
"""
import threading
import time

import numpy as np
import pytest
import torch

from incubator_mxnet_tpu import io_plane as jio_plane

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import io_plane, storage


def _nd_iter(n=10, batch=3, shuffle=False):
    data = np.arange(n * 4, dtype=np.float32).reshape(n, 4)
    return tmx.io.NDArrayIter(data, np.arange(n, dtype=np.float32), batch,
                              shuffle=shuffle)


def _as_lists(it):
    return [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad) for b in it]


def test_yields_the_inner_batches_in_order():
    want = _as_lists(_nd_iter())
    ring = io_plane.DevicePrefetchIter(_nd_iter(), placement=io_plane.
                                       RingPlacement(ctx=tmx.cpu()))
    for _ in range(3):
        got = _as_lists(ring)
        assert len(got) == len(want) == 4
        for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
            np.testing.assert_array_equal(gd, wd)
            np.testing.assert_array_equal(gl, wl)
            assert gp == wp
        ring.reset()
    assert ring.provide_data[0].shape == (3, 4)
    with pytest.raises(StopIteration):
        for _ in range(10):
            ring.next()
    with pytest.raises(StopIteration):      # and stays exhausted
        ring.next()
    ring.close()


def test_iter_next_buffers_the_batch():
    ring = io_plane.DevicePrefetchIter(_nd_iter(6, 3), placement=io_plane.
                                       RingPlacement(ctx=tmx.cpu()))
    assert ring.iter_next() and ring.iter_next()
    first = ring.next()
    np.testing.assert_array_equal(first.data[0].asnumpy()[:, 0],
                                  [0, 4, 8])
    assert ring.next().data[0].asnumpy()[0, 0] == 12
    assert not ring.iter_next()
    ring.close()


class _Recorder(tmx.io.DataIter):
    """An inner iterator that records the calls that reach it."""

    def __init__(self, n=6, delay=0.0, fail_at=None):
        super().__init__(2)
        self.calls = []
        self.i = 0
        self.n = n
        self.delay = delay
        self.fail_at = fail_at

    @property
    def provide_data(self):
        return [tmx.io.DataDesc("data", (2, 3))]

    @property
    def provide_label(self):
        return [tmx.io.DataDesc("softmax_label", (2,))]

    def reset(self):
        self.calls.append("reset")
        self.i = 0

    def next(self):
        if self.i >= self.n:
            raise StopIteration
        if self.i == self.fail_at:
            raise ValueError("bad record in the inner iterator")
        time.sleep(self.delay)
        self.i += 1
        return tmx.io.DataBatch(
            [tmx.nd.array(np.full((2, 3), self.i, np.float32),
                          ctx=tmx.cpu())],
            [tmx.nd.array(np.zeros(2, np.float32), ctx=tmx.cpu())], pad=0)

    def seek(self, nbatch):
        self.calls.append(("seek", nbatch))
        self.i = nbatch

    def checkpoint_state(self):
        self.calls.append("checkpoint_state")
        return {"order": [1, 2]}

    def set_checkpoint_state(self, state, nbatch=0):
        self.calls.append(("set_checkpoint_state", state, nbatch))
        self.i = nbatch

    def set_quarantine(self, log):
        self.calls.append(("set_quarantine", log))

    def apply_quarantine(self, entries):
        self.calls.append(("apply_quarantine", entries))

    def record_range(self, nbatch):
        return ("x.rec", 2 * nbatch, 2 * nbatch + 2)


def _cpu_ring(inner, **kw):
    return io_plane.DevicePrefetchIter(
        inner, placement=io_plane.RingPlacement(ctx=tmx.cpu()), **kw)


def test_delegates_to_the_inner_iterator():
    inner = _Recorder()
    ring = _cpu_ring(inner)
    assert ring.next().data[0].asnumpy()[0, 0] == 1
    assert ring.checkpoint_state() == {"order": [1, 2]}
    ring.seek(4)
    assert ring.next().data[0].asnumpy()[0, 0] == 5
    ring.set_checkpoint_state({"order": [2, 1]}, nbatch=2)
    assert ring.next().data[0].asnumpy()[0, 0] == 3
    log = object()
    ring.set_quarantine(log)
    ring.apply_quarantine([{"record": 3}])
    assert ring.record_range(2) == ("x.rec", 4, 6)
    ring.reset()
    assert ring.next().data[0].asnumpy()[0, 0] == 1
    assert inner.calls == ["checkpoint_state", ("seek", 4),
                           ("set_checkpoint_state", {"order": [2, 1]}, 2),
                           ("set_quarantine", log),
                           ("apply_quarantine", [{"record": 3}]), "reset"]
    ring.close()


def test_counts_stalls_when_the_source_is_slow():
    before = io_plane.stats()["stalls"]
    ring = _cpu_ring(_Recorder(n=4, delay=0.05))
    got = [b.data[0].asnumpy()[0, 0] for b in ring]
    assert got == [1, 2, 3, 4]
    stats = ring.ring_stats()
    assert stats["stalls"] >= 2 and stats["stall_s"] > 0.05
    assert stats["batches"] == 4 and stats["depth"] == 3
    assert io_plane.stats()["stalls"] - before >= 2
    ring.close()


def test_no_stall_when_the_queue_is_full():
    ring = _cpu_ring(_Recorder(n=4))
    assert ring.iter_next()            # the first batch may wait: a stall
    deadline = time.time() + 10
    while ring.ring_stats()["occupancy"] < 3:
        assert time.time() < deadline
        time.sleep(0.01)
    stalls = ring.ring_stats()["stalls"]
    assert stalls <= 1 and ring.ring_stats()["depth"] == 3
    assert len(list(ring)) == 4        # the buffered one and 3 queued
    assert ring.ring_stats()["stalls"] == stalls
    ring.close()


def test_an_inner_error_surfaces_on_the_consumer():
    ring = _cpu_ring(_Recorder(n=6, fail_at=2))
    assert len([ring.next(), ring.next()]) == 2
    with pytest.raises(ValueError, match="bad record"):
        ring.next()
    with pytest.raises(ValueError, match="bad record"):   # and again
        ring.next()
    ring.close()


class _CountingPool(storage.HostStagingPool):
    """A staging pool that logs acquire/release and checks that no
    buffer is handed out twice at once."""

    def __init__(self):
        super().__init__(pin=False)
        self.log = []
        self.out = set()
        self.lock = threading.Lock()

    def acquire(self, shape, dtype=torch.float32):
        view, raw = super().acquire(shape, dtype)
        with self.lock:
            assert raw.data_ptr() not in self.out
            self.out.add(raw.data_ptr())
            self.log.append(("acquire", raw.data_ptr()))
        return view, raw

    def release(self, raw):
        with self.lock:
            self.out.discard(raw.data_ptr())
            self.log.append(("release", raw.data_ptr()))
        return super().release(raw)


def test_staging_buffers_return_to_the_pool_after_their_copy():
    """A cast (here to float64) stages the batch in a pooled buffer; the
    buffer goes back once the batch was copied out of it, the next batch
    reuses it, and no delivered batch aliases it."""
    pool = _CountingPool()
    ring = io_plane.H2DRing(io_plane.RingPlacement(
        ctx=tmx.cpu(), dtypes=[torch.float64, None]), depth=2, pool=pool)
    token = ring.reopen()
    outs = []
    for k in range(3):
        x = torch.full((4, 5), float(k))
        assert ring.put([x, torch.arange(4.0)], meta=k, token=token)
        tensors, meta = ring.get()
        assert meta == k and tensors[0].dtype == torch.float64
        outs.append(tensors[0])
        assert not pool.out            # released once copied
    assert [e[0] for e in pool.log] == ["acquire", "release"] * 3
    assert len({p for _, p in pool.log}) == 1      # one buffer, reused
    assert pool.hits == 2
    for k, t in enumerate(outs):       # never overwritten by reuse
        assert torch.equal(t, torch.full((4, 5), float(k),
                                         dtype=torch.float64))
    stats = ring.ring_stats()
    assert stats["staging_copies"] == 3 and stats["resident"] == 3
    assert stats["bytes"] == 3 * 4 * 5 * 8


def test_without_staging_the_cast_still_happens():
    ring = io_plane.H2DRing(io_plane.RingPlacement(
        ctx=tmx.cpu(), dtypes=[torch.float64]), staging=False)
    token = ring.reopen()
    ring.put([np.ones((2, 2), np.float32)], token=token)
    (t,), _ = ring.get()
    assert t.dtype == torch.float64 and ring.ring_stats()[
        "staging_copies"] == 0


def test_a_stale_feeder_cannot_deliver():
    ring = io_plane.H2DRing(io_plane.RingPlacement(ctx=tmx.cpu()))
    old = ring.reopen()
    new = ring.reopen()
    assert not ring.put([torch.zeros(2)], token=old)
    ring.put_end(token=old)            # a dead token's EOF is ignored
    assert ring.put([torch.ones(2)], meta="fresh", token=new)
    (t,), meta = ring.get()
    assert meta == "fresh" and torch.equal(t, torch.ones(2))
    ring.close()
    with pytest.raises(StopIteration):
        ring.get()


def test_auto_shard(monkeypatch):
    monkeypatch.delenv("DMLC_NUM_WORKER", raising=False)
    assert io_plane.auto_shard() == (0, 1)
    assert io_plane.auto_shard(2, 5) == (2, 5)
    monkeypatch.setenv("DMLC_NUM_WORKER", "4")
    monkeypatch.setenv("DMLC_RANK", "3")
    assert io_plane.auto_shard() == (3, 4)
    assert io_plane.auto_shard(None, "auto") == (3, 4)
    assert io_plane.auto_shard() == jio_plane.auto_shard()


def test_auto_shard_reaches_the_record_iterator(tmp_path, monkeypatch):
    from incubator_mxnet_tpu_torch import recordio
    rec = str(tmp_path / "a.rec")
    w = recordio.MXRecordIO(rec, "w")
    img = np.zeros((8, 8, 3), np.uint8)
    for i in range(9):
        w.write(recordio.pack_img(recordio.IRHeader(0, float(i), i, 0), img,
                                  img_fmt=".ppm"))
    w.close()
    monkeypatch.setenv("DMLC_NUM_WORKER", "3")
    monkeypatch.setenv("DMLC_RANK", "1")
    kw = dict(path_imgrec=rec, data_shape=(3, 8, 8), batch_size=3)
    it = tmx.io.ImageRecordIter(num_parts="auto", **kw)
    assert [b.label[0].asnumpy().tolist() for b in it] == [[3, 4, 5]]
    monkeypatch.setenv("MXNET_IO_AUTO_SHARD", "0")
    it = tmx.io.ImageRecordIter(num_parts="auto", **kw)
    assert len(list(it)) == 3
    it = tmx.io.ImageRecordIter(**kw)      # unset: never sharded
    assert len(list(it)) == 3


def _mlp():
    s = tmx.sym
    return s.SoftmaxOutput(s.FullyConnected(s.Variable("data"),
                                            num_hidden=3, name="fc"),
                           name="softmax")


def _fit(monkeypatch, ring_on):
    monkeypatch.setenv("MXNET_IO_RING", "1" if ring_on else "0")
    np.random.seed(0)
    it = _nd_iter(12, 4, shuffle=True)
    mod = tmx.mod.Module(_mlp(), context=tmx.cpu())
    seen, labels = [], []

    def record(p):
        seen.append(p.locals["train_data"])
        labels.append(mod._exec_group.execs[0].arg_dict[
            "softmax_label"].asnumpy())

    tmx.random.seed(1)
    mod.fit(it, num_epoch=2, batch_end_callback=record,
            initializer=tmx.initializer.Xavier(),
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9})
    return mod, seen, labels


def test_module_fit_wraps_its_iterator_in_the_ring(monkeypatch):
    mod, seen, labels = _fit(monkeypatch, True)
    ring = seen[0]
    assert isinstance(ring, io_plane.DevicePrefetchIter)
    assert ring._thread is None            # paused when fit returned
    assert ring._ring._placement.dtypes == [torch.float32, None]
    assert ring.ring_stats()["batches"] >= 6
    assert mod._fused_step.steps == 6
    plain, pseen, plabels = _fit(monkeypatch, False)
    assert isinstance(pseen[0], tmx.io.NDArrayIter)
    for a, b in zip(labels, plabels):
        np.testing.assert_array_equal(a, b)
    for (k, v), (k2, v2) in zip(sorted(mod.get_params()[0].items()),
                                sorted(plain.get_params()[0].items())):
        assert k == k2 and np.array_equal(v.asnumpy(), v2.asnumpy())


def test_fit_without_a_fused_step_keeps_the_iterator(monkeypatch):
    monkeypatch.setenv("MXNET_FUSED_TRAIN_STEP", "0")
    mod, seen, _ = _fit(monkeypatch, True)
    assert mod._fused_step is None
    assert isinstance(seen[0], tmx.io.NDArrayIter)


def test_the_placement_follows_the_bound_dtypes():
    mod = tmx.mod.Module(_mlp(), context=tmx.cpu())
    mod.bind([tmx.io.DataDesc("data", (4, 5), dtype="bfloat16")],
             [("softmax_label", (4,))])
    mod.init_params(tmx.initializer.Xavier())
    mod.init_optimizer(optimizer_params={"multi_precision": True})
    placement = mod._fused_step.ring_placement()
    assert placement.dtypes == [torch.bfloat16, None]
    assert placement.device == torch.device("cpu")
