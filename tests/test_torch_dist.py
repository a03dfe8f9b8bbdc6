"""The port's parameter-server tier (`dist/`) on the CPU.

Wire compatibility with the JAX package: the 2-bit codec's bytes are
equal, a port client drives a JAX `ParameterServer` and a JAX client the
port's, through the commands whose payloads are numpy and plain types
(``init``, ``push``, ``pull``, ``barrier``, ``embed_init``,
``embed_pull``, ``embed_push`` with ``op="assign"``).  Then the port on
its own: ``dist_sync`` with 2 and 4 worker processes, three servers over
uneven key ranges with the server-side optimizer's states pulled back,
an async push applied at once, a killed server surfacing
`ServerLostError`, the launcher's exit codes, the packed wire under
compression, and `Module.fit(kvstore='dist_sync')` in two workers
against one process on the global batch (rtol 1e-5 + 1e-6 * max|array|;
the workers' parameters equal bit for bit); every test of the server's
data plane pins ``MXNET_KVSTORE_COLLECTIVE=0``, as the JAX tests do.
The collective plane (the default): 2 gloo ranks on the CPU through the
JAX multiprocess worker's expected numbers and batched keys, one
collective a step in `Module.fit`, no gradient byte on the server, and
2-bit's wire dtype as the JAX rule picks it.  Failover: the transport's
and the server's fault sites (a torn send and a lost reply change
nothing, a refused connect retries, a crashed server is lost), `fit`
resuming bit for bit after its server was killed and replaced empty,
and `fit` without a checkpoint directory raising `ServerLostError`; a
one-worker ``dist_sync`` fit of the same mlp on the same data in both
packages, each against its own server, within rtol 1e-5 + 1e-6 *
max|array| (the JAX package's server updates in another order of fp32
operations).

Every server binds port 0 and is shut down in a ``finally``; every
request times out in 60 s and every child process in 120 s.
"""
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_TIMEOUT = 120
TOL = (1e-5, 1e-6)
FIT_TOL = (1e-3, 1e-4)      # phase 6's gate on parameters after a fit

_ENV_KEYS = ("DMLC_PS_ROOT_URI", "DMLC_PS_ROOT_PORT", "DMLC_RANK",
             "DMLC_NUM_WORKER", "DMLC_NUM_SERVER", "DMLC_ROLE",
             "MXNET_KVSTORE_COLLECTIVE", "MXNET_KVSTORE_BIGARRAY_BOUND",
             "MXNET_PS_REQUEST_TIMEOUT", "MXNET_PS_RECONNECT_WAIT",
             "MXNET_PS_MAX_RETRIES", "MXNET_PS_CONNECT_WAIT")


@pytest.fixture(autouse=True)
def short_timeouts(monkeypatch):
    monkeypatch.setenv("MXNET_PS_REQUEST_TIMEOUT", "60")
    monkeypatch.setenv("MXNET_PS_CONNECT_WAIT", "30")


def _tracker_env(monkeypatch, port, rank=0, workers=1, servers=1, **extra):
    env = {"DMLC_PS_ROOT_URI": "127.0.0.1", "DMLC_PS_ROOT_PORT": str(port),
           "DMLC_RANK": str(rank), "DMLC_NUM_WORKER": str(workers),
           "DMLC_NUM_SERVER": str(servers),
           "MXNET_KVSTORE_COLLECTIVE": "0", **extra}
    for k, v in env.items():
        monkeypatch.setenv(k, v)


def _child_env(**extra):
    env = {k: v for k, v in os.environ.items() if k not in _ENV_KEYS}
    env.update(PYTHONPATH=REPO + os.pathsep + os.environ.get(
        "PYTHONPATH", ""), MXNET_PS_REQUEST_TIMEOUT="60",
        MXNET_PS_CONNECT_WAIT="30", **extra)
    return env


def _run_workers(script, n, port, **extra):
    env = _child_env(DMLC_PS_ROOT_URI="127.0.0.1",
                     DMLC_PS_ROOT_PORT=str(port), DMLC_NUM_WORKER=str(n),
                     DMLC_ROLE="worker", **extra)
    procs = [subprocess.Popen([sys.executable, str(script)],
                              env=dict(env, DMLC_RANK=str(r)),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, cwd=REPO)
             for r in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=CHILD_TIMEOUT)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {r} failed:\n{out}"
        assert f"worker {r} OK" in out, out


# -- the wire ----------------------------------------------------------------

def test_2bit_wire_codec_bytes_equal_jax():
    from incubator_mxnet_tpu.dist import compression as jc
    from incubator_mxnet_tpu_torch.dist import compression as tc
    rng = np.random.RandomState(0)
    for shape in [(7,), (16,), (5, 9), (128, 3), (1,)]:
        thr = 0.5
        g = rng.randn(*shape).astype("f4")
        q = np.where(g >= thr, thr,
                     np.where(g <= -thr, -thr, 0.0)).astype("f4")
        jm, tm = jc.pack_2bit(q, thr), tc.pack_2bit(q, thr)
        assert tm["packed2bit"].tobytes() == jm["packed2bit"].tobytes()
        assert {k: v for k, v in tm.items() if k != "packed2bit"} == \
            {k: v for k, v in jm.items() if k != "packed2bit"}
        assert tm["packed2bit"].nbytes == (q.size + 3) // 4
        np.testing.assert_array_equal(tc.unpack_2bit(jm), q)
        np.testing.assert_array_equal(jc.unpack_2bit(tm), q)
        assert tc.is_packed(tm) and jc.is_packed(tm)


def test_frames_equal_jax(monkeypatch):
    """The same message frames to the same bytes (with and without the
    HMAC tag), and each package reads the other's frame."""
    import socket
    from incubator_mxnet_tpu.dist import transport as jt
    from incubator_mxnet_tpu_torch.dist import transport as tt
    msg = {"cmd": "push", "key": "w", "value": np.arange(10, dtype="f4"),
           "sync": True, "rank": 1, "seq": 3, "client": "c"}
    for key in ("", "secret"):
        monkeypatch.setenv("MXNET_PS_HMAC_KEY", key)
        frames = []
        for send, recv in ((jt.send_msg, tt.recv_msg),
                           (tt.send_msg, jt.recv_msg)):
            a, b = socket.socketpair()
            try:
                send(a, msg)
                a.shutdown(socket.SHUT_WR)
                raw = b"".join(iter(lambda: b.recv(1 << 16), b""))
                frames.append(raw)
                c, d = socket.socketpair()
                c.sendall(raw)
                got = recv(d)
                c.close()
                d.close()
            finally:
                a.close()
                b.close()
            np.testing.assert_array_equal(got["value"], msg["value"])
            assert {k: v for k, v in got.items() if k != "value"} == \
                {k: v for k, v in msg.items() if k != "value"}
        assert frames[0] == frames[1]


class _Shell:
    """Pickles as a call of os.system."""

    def __reduce__(self):
        return os.system, ("true",)


def test_unpicklers_are_allowlists():
    """A frame or an optimizer blob naming a callable outside the
    allowlist is refused before it runs; the port's optimizer with its
    schedule and its states (bfloat16 among them) load."""
    import pickle
    import socket
    from incubator_mxnet_tpu_torch.dist import transport as tt
    a, b = socket.socketpair()
    try:
        tt.send_msg(a, {"cmd": "push", "value": _Shell()})
        with pytest.raises(pickle.UnpicklingError, match="system is not allowed"):
            tt.recv_msg(b)
    finally:
        a.close()
        b.close()
    with pytest.raises(pickle.UnpicklingError, match="system is not allowed"):
        tt.loads_port_blob(pickle.dumps(_Shell()))
    opt = tmx.optimizer.SGD(learning_rate=0.1, momentum=0.9,
                            lr_scheduler=tmx.lr_scheduler.FactorScheduler(2))
    back = tt.loads_port_blob(pickle.dumps(opt, protocol=4))
    assert type(back) is tmx.optimizer.SGD and back.momentum == 0.9
    assert type(back.lr_scheduler) is tmx.lr_scheduler.FactorScheduler
    states = {0: tmx.nd.array([1, 2, 3], ctx=tmx.cpu()),
              1: tmx.nd.array([4, 5], ctx=tmx.cpu(), dtype="bfloat16")}
    got = tt.loads_port_blob(pickle.dumps(states, protocol=5))
    for k, v in states.items():
        assert got[k].dtype == v.dtype
        np.testing.assert_array_equal(got[k].asnumpy().astype("f4"),
                                      v.asnumpy().astype("f4"))


def _dense_round_trip(kv, nd, ctx):
    kv.init("3", nd.zeros((4, 2), ctx=ctx))
    kv.push("3", nd.ones((4, 2), ctx=ctx) * 2)
    out = nd.zeros((4, 2), ctx=ctx)
    kv.pull("3", out=out)
    kv._barrier()
    return out.asnumpy()


@pytest.mark.parametrize("client,server", [("port", "jax"),
                                           ("jax", "port")])
def test_cross_package_kvstore(monkeypatch, client, server):
    """A worker of one package pushes to and pulls from a server of the
    other: init, push (plain and 2-bit packed), pull and barrier.  The
    port's server refuses a JAX package's pickled optimizer."""
    from incubator_mxnet_tpu.dist.server import ParameterServer as JPS
    from incubator_mxnet_tpu_torch.dist.server import ParameterServer as TPS
    srv = (JPS if server == "jax" else TPS)(num_workers=1).start()
    try:
        _tracker_env(monkeypatch, srv.port)
        if client == "port":
            from incubator_mxnet_tpu_torch.dist.kvstore_dist import \
                KVStoreDist
            mx = tmx
        else:
            from incubator_mxnet_tpu.dist.kvstore_dist import KVStoreDist
            mx = jmx
        kv = KVStoreDist("dist_sync")
        np.testing.assert_array_equal(
            _dense_round_trip(kv, mx.nd, mx.cpu()), 2.0)
        kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
        kv.init("g", mx.nd.zeros((9,), ctx=mx.cpu()))
        g = np.linspace(-1, 1, 9).astype("f4")
        kv.push("g", mx.nd.array(g, ctx=mx.cpu()))
        out = mx.nd.zeros((9,), ctx=mx.cpu())
        kv.pull("g", out=out)
        np.testing.assert_array_equal(
            out.asnumpy(), np.where(g >= .5, .5, np.where(g <= -.5, -.5, 0.)))
        if server == "port":
            # a JAX optimizer is never unpickled into the port's server
            with pytest.raises(jmx.MXNetError, match="another package"):
                kv.set_optimizer(jmx.optimizer.SGD(learning_rate=0.1))
        kv.close()
    finally:
        srv.shutdown()


@pytest.mark.parametrize("client,server", [("port", "jax"),
                                           ("jax", "port")])
def test_cross_package_embedding(client, server):
    """A sharded table of one package on the other's servers: the seeded
    shards are the same rows, ``assign`` writes them, pulls read them."""
    from incubator_mxnet_tpu.dist.server import ParameterServer as JPS
    from incubator_mxnet_tpu_torch.dist.server import ParameterServer as TPS
    from incubator_mxnet_tpu.embedding import ShardedEmbedding as JSE
    from incubator_mxnet_tpu_torch.embedding import ShardedEmbedding as TSE
    S = JPS if server == "jax" else TPS
    servers = [S(num_workers=1).start() for _ in range(2)]
    ref = [S(num_workers=1).start() for _ in range(2)]
    tables = []
    try:
        addrs = [("127.0.0.1", s.port) for s in servers]
        kw = dict(seed=5, cache_rows=0)
        if client == "port":
            t = TSE("x", 30, 4, addrs, ctx=tmx.cpu(), **kw)
        else:
            t = JSE("x", 30, 4, addrs, **kw)
        tables.append(t)
        own = (JSE if server == "jax" else TSE)(
            "x", 30, 4, [("127.0.0.1", s.port) for s in ref],
            **(kw if server == "jax" else dict(kw, ctx=tmx.cpu())))
        tables.append(own)
        np.testing.assert_array_equal(t.checkpoint_rows(),
                                      own.checkpoint_rows())
        new = np.arange(8, dtype="f4").reshape(2, 4)
        t.assign_rows([3, 20], new)
        np.testing.assert_array_equal(t.pull_rows([20, 3]), new[::-1])
        assert t.stats()["shards"]["1"]["rows_pushed"] == 1
    finally:
        for t in tables:
            t.close()
        for s in servers + ref:
            s.shutdown()


# -- dist_sync with worker processes -------------------------------------------

WORKER = r"""
import os
import numpy as np
import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import nd

c = mx.cpu()
kv = mx.kv.create("dist_sync")
rank, nw = kv.rank, kv.num_workers
assert nw == int(os.environ["DMLC_NUM_WORKER"]), (rank, nw)
tot = sum(r + 1 for r in range(nw))
kv.init("3", nd.zeros((4, 2), ctx=c))
kv.push("3", nd.ones((4, 2), ctx=c) * (rank + 1))
out = nd.zeros((4, 2), ctx=c)
kv.pull("3", out=out)
np.testing.assert_array_equal(out.asnumpy(), tot)
# a second round must not mix with the first
kv.push("3", nd.ones((4, 2), ctx=c) * 10 * (rank + 1))
kv.pull("3", out=out)
np.testing.assert_array_equal(out.asnumpy(), 10 * tot)
# two pushes before a pull: each joins its own round
kv.push("3", nd.ones((4, 2), ctx=c) * 100 * (rank + 1))
kv.push("3", nd.ones((4, 2), ctx=c) * 1000 * (rank + 1))
kv.pull("3", out=out)
np.testing.assert_array_equal(out.asnumpy(), 1000 * tot)
# several contexts: summed on the worker before the wire
kv.init("md", nd.zeros((2, 2), ctx=c))
kv.push("md", [nd.ones((2, 2), ctx=mx.cpu(i)) for i in range(3)])
md = nd.zeros((2, 2), ctx=c)
kv.pull("md", out=md)
np.testing.assert_array_equal(md.asnumpy(), 3 * nw)
# the server's optimizer: w = w0 - lr * mean gradient, each round
kv.init("w", nd.ones((3,), ctx=c))
kv.set_optimizer(mx.optimizer.SGD(learning_rate=0.1, rescale_grad=1.0 / nw))
for step in range(3):
    kv.push("w", nd.ones((3,), ctx=c) * (rank + 1))
    w = nd.zeros((3,), ctx=c)
    kv.pull("w", out=w)
    np.testing.assert_allclose(w.asnumpy(), 1.0 - 0.1 * tot / nw * (step + 1),
                               rtol=1e-5)
kv._barrier()
kv.close()
print("worker %d OK" % rank)
"""


@pytest.mark.parametrize("n_workers", [2, 4])
def test_dist_sync_multiprocess(tmp_path, n_workers):
    from incubator_mxnet_tpu_torch.dist.server import ParameterServer
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    server = ParameterServer(num_workers=n_workers).start()
    try:
        _run_workers(script, n_workers, server.port,
                     MXNET_KVSTORE_COLLECTIVE="0")
    finally:
        server.shutdown()


THREE_SERVER_WORKER = r"""
import pickle
import numpy as np
import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import nd

c = mx.cpu()
kv = mx.kv.create("dist_sync")
rank, nw = kv.rank, kv.num_workers
assert kv._num_servers == 3 and len(kv._chans) == 3
big = np.arange(40, dtype="f4").reshape(8, 5)
shards = kv._shards("big", 40)
assert [sl.stop - sl.start for _, sl in shards] == [13, 13, 14], shards
assert [srv for srv, _ in shards] == [0, 1, 2]
kv.init("big", nd.array(big * 0, ctx=c))
kv.push("big", nd.array(big * (rank + 1), ctx=c))
out = nd.zeros((8, 5), ctx=c)
kv.pull("big", out=out)
tot = sum(r + 1 for r in range(nw))
np.testing.assert_array_equal(out.asnumpy(), big * tot)
for i, shape in enumerate([(3,), (2, 2), (7,), (5,)]):
    k = "k%d" % i
    kv.init(k, nd.zeros(shape, ctx=c))
    kv.push(k, nd.ones(shape, ctx=c) * (rank + 1) * (i + 1))
    o = nd.zeros(shape, ctx=c)
    kv.pull(k, out=o)
    np.testing.assert_array_equal(o.asnumpy(), tot * (i + 1))
kv.init("w", nd.ones((40,), ctx=c))
kv.set_optimizer(mx.optimizer.SGD(learning_rate=0.1, momentum=0.9,
                                  rescale_grad=1.0 / nw))
kv.push("w", nd.ones((40,), ctx=c) * (rank + 1))
w = nd.zeros((40,), ctx=c)
kv.pull("w", out=w)
np.testing.assert_allclose(w.asnumpy(), 1.0 - 0.1 * tot / nw, rtol=1e-5)
blob = kv.get_optimizer_states(dump_optimizer=True)
per_server = pickle.loads(blob)["dist_server_states"]
assert set(per_server) == {0, 1, 2}
sizes = sorted(int(pickle.loads(s)[0]["w"].size)
               for s in per_server.values())
assert sizes == [13, 13, 14], sizes
kv.set_optimizer_states(blob)
kv._barrier()
kv.close()
print("worker %d OK" % rank)
"""


def test_dist_sync_three_servers_uneven_ranges(tmp_path):
    from incubator_mxnet_tpu_torch.dist.server import (ParameterServer,
                                                       register_with_root)
    n_workers = 2
    script = tmp_path / "worker3.py"
    script.write_text(THREE_SERVER_WORKER)
    root = ParameterServer(num_workers=n_workers, num_servers=3).start()
    secondaries = []
    try:
        for sid in (1, 2):
            srv = ParameterServer(num_workers=n_workers, num_servers=3,
                                  port=0).start()
            secondaries.append(srv)
            register_with_root("127.0.0.1", root.port, sid, "127.0.0.1",
                               srv.port)
        _run_workers(script, n_workers, root.port, DMLC_NUM_SERVER="3",
                     MXNET_KVSTORE_COLLECTIVE="0",
                     MXNET_KVSTORE_BIGARRAY_BOUND="16")
        for key in ("big", "w"):
            sizes = sorted(s._state.store[key].size
                           for s in [root] + secondaries)
            assert sizes == [13, 13, 14], (key, sizes)
    finally:
        for s in [root] + secondaries:
            s.shutdown()


def test_async_push_applies_immediately(monkeypatch):
    from incubator_mxnet_tpu_torch.dist.server import ParameterServer
    from incubator_mxnet_tpu_torch.dist.kvstore_dist import KVStoreDist
    nd, c = tmx.nd, tmx.cpu()
    server = ParameterServer(num_workers=2).start()
    try:
        _tracker_env(monkeypatch, server.port, rank=0, workers=2)
        kv0 = KVStoreDist("dist_async")
        monkeypatch.setenv("DMLC_RANK", "1")
        kv1 = KVStoreDist("dist_async")
        t = threading.Thread(target=kv1.init,
                             args=("k", nd.zeros((2,), ctx=c)))
        t.start()
        kv0.init("k", nd.zeros((2,), ctx=c))
        t.join(timeout=60)
        assert not t.is_alive()
        kv0.push("k", nd.ones((2,), ctx=c))     # rank 1 never pushes
        out = nd.zeros((2,), ctx=c)
        kv0.pull("k", out=out)
        np.testing.assert_array_equal(out.asnumpy(), 1.0)
        kv0.close()
        kv1.close()
    finally:
        server.shutdown()


def test_killed_server_surfaces_server_lost(monkeypatch):
    """A secondary server killed mid-training: the next push or pull
    raises `ServerLostError` naming the server and the keys it owned."""
    from incubator_mxnet_tpu_torch.dist.server import ParameterServer
    from incubator_mxnet_tpu_torch.dist.kvstore_dist import KVStoreDist
    from incubator_mxnet_tpu_torch.resilience import ServerLostError
    nd, c = tmx.nd, tmx.cpu()
    root = ParameterServer(num_workers=1, num_servers=2).start()
    proc = subprocess.Popen(
        [sys.executable, "-m", "incubator_mxnet_tpu_torch.dist.server"],
        env=_child_env(DMLC_SERVER_ID="1", DMLC_PS_ROOT_URI="127.0.0.1",
                       DMLC_PS_ROOT_PORT=str(root.port)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, cwd=REPO)
    try:
        _tracker_env(monkeypatch, root.port, servers=2,
                     MXNET_KVSTORE_BIGARRAY_BOUND="16",
                     MXNET_PS_RECONNECT_WAIT="0.2",
                     MXNET_PS_MAX_RETRIES="2")
        kv = KVStoreDist("dist_sync")
        kv.init("w", nd.ones((30,), ctx=c))
        kv.push("w", nd.ones((30,), ctx=c))
        out = nd.zeros((30,), ctx=c)
        kv.pull("w", out=out)
        np.testing.assert_array_equal(out.asnumpy(), 1.0)
        proc.kill()
        proc.wait(timeout=30)
        with pytest.raises(ServerLostError,
                           match=r"parameter server 1 .* is lost") as err:
            kv.push("w", nd.ones((30,), ctx=c))
            kv.pull("w", out=out)
        assert err.value.server == 1 and "w" in err.value.keys
        kv.close(send_stop=False)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        root.shutdown()


PLANE_WORKER = r"""
import os
import numpy as np
import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import nd
c = mx.cpu()
kv = mx.kv.create("dist_sync")
rank = kv.rank
want = os.environ["WANT_PLANE"]
assert (kv._collective is not None) == (want == "collective"), want
kv.init("w", nd.zeros((6,), ctx=c))
kv.push("w", nd.ones((6,), ctx=c) * (rank + 1))
out = nd.zeros((6,), ctx=c)
kv.pull("w", out=out)
np.testing.assert_array_equal(out.asnumpy(), 3.0)
st = kv.stats()
if want == "collective":
    assert kv.prefers_batched_push and st["wire_bytes"] == 0
    assert st["collective_dispatches"] == 2       # init + one push
else:
    assert not kv.prefers_batched_push and st["wire_bytes"] == 24
    assert st["collective_dispatches"] is None
kv._barrier()
if rank == 0:
    print("SERVER_PUSHES %d" % kv.server_metrics()[0]["pushes"])
kv._barrier()
kv.close()
print("worker %d OK" % rank)
"""


@pytest.mark.parametrize("plane", ["collective", "socket"])
def test_collective_plane_is_the_default(tmp_path, plane):
    """With ``MXNET_KVSTORE_COLLECTIVE`` unset a 2-worker ``dist_sync``
    store all-reduces its gradients over a gloo group and the server
    sees no push; ``MXNET_KVSTORE_COLLECTIVE=0`` keeps the gradients on
    the server's socket plane."""
    from incubator_mxnet_tpu_torch.dist.server import ParameterServer
    script = tmp_path / "plane.py"
    script.write_text(PLANE_WORKER)
    server = ParameterServer(num_workers=2).start()
    try:
        extra = {"WANT_PLANE": plane}
        if plane == "socket":
            extra["MXNET_KVSTORE_COLLECTIVE"] = "0"
        _run_workers(script, 2, server.port, **extra)
        assert server.stats()["pushes"] == (0 if plane == "collective"
                                            else 2)
    finally:
        server.shutdown()


COLLECTIVE_WORKER = WORKER.replace(
    'kv._barrier()\nkv.close()\nprint("worker %d OK" % rank)', r"""
# batched keys: one all-reduce per dtype bucket, split back, and the
# optimizer set above applied to each: b = 0 - lr * sum / nw
keys = ["b0", "b1", "b2", "b3"]
shapes = [(3,), (2, 2), (5,), (4,)]
for k, sh in zip(keys, shapes):
    kv.init(k, nd.zeros(sh, ctx=c))
before = kv._collective.dispatch_count
kv.push(keys, [nd.array(np.arange(np.prod(sh), dtype="f4").reshape(sh)
                        * (rank + 1), ctx=c) for sh in shapes])
assert kv._collective.dispatch_count == before + 1
for k, sh in zip(keys, shapes):
    o = nd.zeros(sh, ctx=c)
    kv.pull(k, out=o)
    np.testing.assert_allclose(
        o.asnumpy(),
        -0.1 * np.arange(np.prod(sh), dtype="f4").reshape(sh) * tot / nw,
        rtol=1e-6)
st = kv.stats()
assert st["wire_bytes"] == 0 and kv._collective.backend == "gloo"
kv._barrier()
kv.close()
print("worker %d OK" % rank)""")


def test_collective_plane_multiprocess(tmp_path):
    """The JAX `test_dist_sync_multiprocess` worker's expected numbers
    (rounds that do not mix, several contexts summed first, the
    optimizer's w = w0 - lr * mean gradient, which runs on every worker)
    on the collective plane over 2 gloo ranks, then a batched push of 4
    keys in one all-reduce; the server receives no gradient."""
    from incubator_mxnet_tpu_torch.dist.server import ParameterServer
    assert COLLECTIVE_WORKER != WORKER
    script = tmp_path / "worker_coll.py"
    script.write_text(COLLECTIVE_WORKER)
    server = ParameterServer(num_workers=2).start()
    try:
        _run_workers(script, 2, server.port)
        assert server.stats()["pushes"] == 0
    finally:
        server.shutdown()


@pytest.mark.parametrize("thr,workers,wire", [
    (0.5, 2, "bfloat16"), (0.25, 256, "bfloat16"), (0.3, 2, "float32"),
    (0.5, 257, "float32")])
def test_wire_dtype_under_2bit_matches_jax(thr, workers, wire):
    """The collective plane sends 2-bit codes as bfloat16 only where
    every partial sum k * t is exact there (t a power of two, k <= 256),
    as the JAX rule decides."""
    import types
    import torch
    from incubator_mxnet_tpu.dist.kvstore_dist import KVStoreDist as J
    from incubator_mxnet_tpu_torch.dist.kvstore_dist import KVStoreDist as T
    kv = types.SimpleNamespace(_compression={"threshold": thr},
                               _num_workers=workers)
    got = T._wire_dtype(kv, torch.float32)
    want = J._wire_dtype(kv, np.float32)
    assert str(got).replace("torch.", "") == wire == np.dtype(want).name


@pytest.mark.parametrize("code", [0, 3])
def test_launcher_propagates_exit_codes(tmp_path, code):
    """The port's launcher starts its server and the workers; they train
    a round through it and exit; the job's code is the failing worker's
    (the server is stopped either way)."""
    script = tmp_path / "job.py"
    script.write_text(
        "import os, sys\n"
        "import incubator_mxnet_tpu_torch as mx\n"
        "kv = mx.kv.create('dist_sync')\n"
        "kv.init('0', mx.nd.zeros((2,), ctx=mx.cpu()))\n"
        "kv.push('0', mx.nd.ones((2,), ctx=mx.cpu()))\n"
        "o = mx.nd.zeros((2,), ctx=mx.cpu())\n"
        "kv.pull('0', out=o)\n"
        "assert o.asnumpy()[0] == kv.num_workers\n"
        "kv.close()\n"
        f"sys.exit({code} if kv.rank == 1 else 0)\n")
    rc = subprocess.call(
        [sys.executable, "-m", "incubator_mxnet_tpu_torch.dist.launch",
         "-n", "2", sys.executable, str(script)],
        env=_child_env(), cwd=REPO, timeout=CHILD_TIMEOUT)
    assert rc == code


WORKER_COMPRESS = r"""
import numpy as np
import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import nd
from incubator_mxnet_tpu_torch.dist import transport
from incubator_mxnet_tpu_torch.dist.compression import is_packed

sent = []
orig = transport.send_msg
def spy(sock, obj):
    if isinstance(obj, dict) and obj.get("cmd") == "push":
        sent.append(obj["value"])
    return orig(sock, obj)
transport.send_msg = spy
c = mx.cpu()
kv = mx.kv.create("dist_sync")
rank, nw = kv.rank, kv.num_workers
kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
n = 64
kv.init("g", nd.zeros((n,), ctx=c))
kv.push("g", nd.array(np.linspace(-1, 1, n) * (rank + 1), ctx=c))
out = nd.zeros((n,), ctx=c)
kv.pull("g", out=out)
expect = np.zeros(n, "f4")
for r in range(nw):
    g = (np.linspace(-1, 1, n) * (r + 1)).astype("f4")
    expect += np.where(g >= .5, .5, np.where(g <= -.5, -.5, 0.)).astype("f4")
np.testing.assert_array_equal(out.asnumpy(), expect)
assert sent and all(is_packed(v) for v in sent)
assert all(v["packed2bit"].nbytes == (n + 3) // 4 for v in sent)
assert kv.stats()["wire_bytes"] == (n + 3) // 4
kv._barrier()
kv.close()
print("worker %d OK" % rank)
"""


def test_compression_packs_the_wire(tmp_path):
    from incubator_mxnet_tpu_torch.dist.server import ParameterServer
    script = tmp_path / "worker_c.py"
    script.write_text(WORKER_COMPRESS)
    server = ParameterServer(num_workers=2).start()
    try:
        _run_workers(script, 2, server.port, MXNET_KVSTORE_COLLECTIVE="0")
    finally:
        server.shutdown()


# -- Module.fit over dist_sync ---------------------------------------------------

FIT_COMMON = r"""
import numpy as np
import incubator_mxnet_tpu_torch as mx

DIST_BATCH = 16
DIST_OPT = {"learning_rate": 0.05, "momentum": 0.9}


def dist_mlp():
    s = mx.sym
    x = s.Activation(s.FullyConnected(s.Variable("data"), name="fc1",
                                      num_hidden=16), act_type="relu")
    return s.SoftmaxOutput(s.FullyConnected(x, name="fc2", num_hidden=4),
                           name="softmax")


def dist_data(steps=4):
    rng = np.random.RandomState(0)
    X = rng.randn(steps * DIST_BATCH, 8).astype("f4")
    Y = rng.randint(0, 4, steps * DIST_BATCH).astype("f4")
    init = {"fc1_weight": rng.randn(16, 8).astype("f4") * 0.3,
            "fc1_bias": np.zeros(16, "f4"),
            "fc2_weight": rng.randn(4, 16).astype("f4") * 0.3,
            "fc2_bias": np.zeros(4, "f4")}
    return X, Y, init
"""

FIT_WORKER = FIT_COMMON + r"""
import os
X, Y, init = dist_data()
rank = int(os.environ["DMLC_RANK"])
nw = int(os.environ["DMLC_NUM_WORKER"])
per = DIST_BATCH // nw
rows = np.concatenate([np.arange(j * DIST_BATCH + rank * per,
                                 j * DIST_BATCH + (rank + 1) * per)
                       for j in range(len(X) // DIST_BATCH)])
it = mx.io.NDArrayIter(X[rows], Y[rows], per)
mod = mx.mod.Module(dist_mlp(), context=mx.cpu())
mod.fit(it, num_epoch=1, kvstore="dist_sync", optimizer="sgd",
        optimizer_params=dict(DIST_OPT),
        arg_params={k: mx.nd.array(v, ctx=mx.cpu()) for k, v in init.items()})
assert mod._update_on_kvstore and mod._kvstore.num_workers == nw
assert mod._optimizer.rescale_grad == 1.0 / DIST_BATCH
args, _ = mod.get_params()
np.savez(os.path.join(os.environ["OUT_DIR"], "w%d.npz" % rank),
         **{k: v.asnumpy() for k, v in args.items()})
mod._kvstore.close()
print("worker %d OK" % rank)
"""


def test_module_fit_dist_sync_two_workers(tmp_path):
    """Two workers each fit their half of every global batch through the
    server's SGD: their parameters are equal bit for bit, and match one
    process fitting the global batch."""
    from incubator_mxnet_tpu_torch.dist.server import ParameterServer
    script = tmp_path / "fit_worker.py"
    script.write_text(FIT_WORKER)
    server = ParameterServer(num_workers=2).start()
    try:
        _run_workers(script, 2, server.port, OUT_DIR=str(tmp_path),
                     MXNET_KVSTORE_COLLECTIVE="0")
        assert server.stats()["updates"] == 4 * 4
    finally:
        server.shutdown()
    w0, w1 = (np.load(tmp_path / f"w{r}.npz") for r in range(2))
    ns = {}
    exec(FIT_COMMON, ns)
    X, Y, init = ns["dist_data"]()
    mod = tmx.mod.Module(ns["dist_mlp"](), context=tmx.cpu())
    mod.fit(tmx.io.NDArrayIter(X, Y, ns["DIST_BATCH"]), num_epoch=1,
            optimizer="sgd", optimizer_params=dict(ns["DIST_OPT"]),
            arg_params={k: tmx.nd.array(v, ctx=tmx.cpu())
                        for k, v in init.items()})
    want = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    for k in want:
        np.testing.assert_array_equal(w0[k], w1[k])
        np.testing.assert_allclose(
            w0[k], want[k], rtol=TOL[0],
            atol=TOL[1] * np.abs(want[k]).max(), err_msg=k)
        assert not np.array_equal(w0[k], init[k])


def test_module_fit_dist_async_one_worker(monkeypatch):
    """`Module.fit(kvstore='dist_async')`: every push applies on the
    server at once, ``rescale_grad`` is 1 / batch (no worker factor),
    and one worker's fit equals a local fit's within rtol 1e-5 + 1e-6 *
    max|array| (the server's SGD on the host against the fused step)."""
    from incubator_mxnet_tpu_torch.dist.server import ParameterServer
    ns = {}
    exec(FIT_COMMON, ns)
    X, Y, init = ns["dist_data"]()
    batch = ns["DIST_BATCH"]

    def fit(kvstore):
        mod = tmx.mod.Module(ns["dist_mlp"](), context=tmx.cpu())
        mod.fit(tmx.io.NDArrayIter(X, Y, batch), num_epoch=1,
                kvstore=kvstore, optimizer="sgd",
                optimizer_params=dict(ns["DIST_OPT"]),
                arg_params={k: tmx.nd.array(v, ctx=tmx.cpu())
                            for k, v in init.items()})
        return mod, {k: v.asnumpy() for k, v in mod.get_params()[0].items()}

    server = ParameterServer(num_workers=1).start()
    try:
        _tracker_env(monkeypatch, server.port)
        mod, got = fit("dist_async")
        assert mod._update_on_kvstore and not mod._kvstore._sync
        assert mod._optimizer.rescale_grad == 1.0 / batch
        assert server.stats()["updates"] == 4 * len(X) // batch
        mod._kvstore.close()
    finally:
        server.shutdown()
    _, want = fit("local")
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=TOL[0],
                                   atol=TOL[1] * np.abs(want[k]).max(),
                                   err_msg=k)


FIT_COLLECTIVE_WORKER = FIT_WORKER.replace(
    "mod._kvstore.close()", """kv = mod._kvstore
assert kv._collective is not None and kv.wire_bytes == 0
# 4 keys' init, then one bucket a step
assert kv._collective.dispatch_count == 4 + len(X) // DIST_BATCH, \\
    kv._collective.dispatch_count
assert kv.server_metrics()[0]["pushes"] == 0
kv.close()""")


def test_module_fit_collective_plane_two_workers(tmp_path):
    """`Module.fit(kvstore='dist_sync')` in two workers on the collective
    plane (the default): one all-reduce a step, no gradient byte on the
    server, the workers' parameters equal bit for bit and within rtol
    1e-5 + 1e-6 * max|array| of one process on the global batch."""
    from incubator_mxnet_tpu_torch.dist.server import ParameterServer
    assert FIT_COLLECTIVE_WORKER != FIT_WORKER
    script = tmp_path / "fit_coll.py"
    script.write_text(FIT_COLLECTIVE_WORKER)
    server = ParameterServer(num_workers=2).start()
    try:
        _run_workers(script, 2, server.port, OUT_DIR=str(tmp_path))
        assert server.stats()["updates"] == 0
    finally:
        server.shutdown()
    w0, w1 = (np.load(tmp_path / f"w{r}.npz") for r in range(2))
    ns = {}
    exec(FIT_COMMON, ns)
    X, Y, init = ns["dist_data"]()
    mod = tmx.mod.Module(ns["dist_mlp"](), context=tmx.cpu())
    mod.fit(tmx.io.NDArrayIter(X, Y, ns["DIST_BATCH"]), num_epoch=1,
            optimizer="sgd", optimizer_params=dict(ns["DIST_OPT"]),
            arg_params={k: tmx.nd.array(v, ctx=tmx.cpu())
                        for k, v in init.items()})
    want = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    for k in want:
        np.testing.assert_array_equal(w0[k], w1[k])
        np.testing.assert_allclose(
            w0[k], want[k], rtol=TOL[0],
            atol=TOL[1] * np.abs(want[k]).max(), err_msg=k)


# -- failover: the fault sites, fit's restart ------------------------------------

@pytest.fixture()
def fast_failover(monkeypatch):
    """Failover diagnosed in well under a second."""
    monkeypatch.setenv("MXNET_PS_RECONNECT_WAIT", "0.2")
    monkeypatch.setenv("MXNET_PS_MAX_RETRIES", "2")
    monkeypatch.setenv("MXNET_PS_BREAKER_THRESHOLD", "2")


@pytest.fixture()
def faults():
    from incubator_mxnet_tpu_torch.resilience import faults as f
    f.clear()
    yield f
    f.clear()


def _push_pull_run(monkeypatch, faults, fault=None):
    """3 pushes then a pull of one worker: the pulled values, the
    server's version, the channel's resends and the faults fired."""
    from incubator_mxnet_tpu_torch.dist.server import ParameterServer
    from incubator_mxnet_tpu_torch.dist.kvstore_dist import KVStoreDist
    nd, c = tmx.nd, tmx.cpu()
    server = ParameterServer(num_workers=1).start()
    _tracker_env(monkeypatch, server.port)
    kv = KVStoreDist("dist_sync")
    try:
        kv.init("w", nd.zeros((4,), ctx=c))
        if fault is not None:
            faults.inject(*fault[0], **fault[1])
        for i in range(3):
            kv.push("w", nd.ones((4,), ctx=c) * (i + 1))
        out = nd.zeros((4,), ctx=c)
        kv.pull("w", out=out)
        fired = [(e["site"], e["ctx"].get("cmd")) for e in faults.trace()
                 if e["event"] == "fault"]
        return (out.asnumpy(), server._state.version["w"],
                kv._chan.resends, fired)
    finally:
        faults.clear()
        kv.close()
        server.shutdown()


@pytest.mark.parametrize("site,args", [
    ("transport.send", {"cmd": "push", "at": 2}),
    ("transport.recv", {"at": 2}),
    ("transport.connect", {"n": 1})], ids=["send", "recv", "connect"])
def test_transport_fault_sites_change_nothing(monkeypatch, fast_failover,
                                              faults, site, args):
    """A frame torn mid-send, a reply lost after the server applied the
    push (the resend hits the (client, seq) cache, no double apply) and
    a refused connect (the reconnect retries): the values and the round
    count equal the fault-free run's, as in the JAX package's tests."""
    clean, clean_ver, _, _ = _push_pull_run(monkeypatch, faults)
    kind = "refuse" if site == "transport.connect" else "drop"
    if site == "transport.connect":
        # a refused reconnect: drop the live socket first so the next
        # request must connect again
        from incubator_mxnet_tpu_torch.dist import transport

        orig = transport.Channel._send_framed

        def dropping(self, msg, timeout=None):
            if msg.get("cmd") == "push" and not getattr(self, "_dropped",
                                                        False):
                self._dropped = True
                self._drop_sock()
            return orig(self, msg, timeout)
        monkeypatch.setattr(transport.Channel, "_send_framed", dropping)
    vals, ver, resends, fired = _push_pull_run(
        monkeypatch, faults, fault=((site, kind), args))
    np.testing.assert_array_equal(vals, clean)
    assert ver == clean_ver
    assert [f[0] for f in fired] == [site]
    if site != "transport.connect":
        assert resends >= 1


def test_server_dispatch_fault_site(monkeypatch, fast_failover, faults):
    """``server.dispatch``: a slow dispatch times a request out and
    leaves the channel usable; a crash kills the server in place and the
    next request raises `ServerLostError`."""
    from incubator_mxnet_tpu_torch.dist.server import ParameterServer
    from incubator_mxnet_tpu_torch.dist.kvstore_dist import KVStoreDist
    from incubator_mxnet_tpu_torch.dist.transport import Channel
    from incubator_mxnet_tpu_torch.resilience import ServerLostError
    server = ParameterServer(num_workers=1).start()
    try:
        faults.inject("server.dispatch", "slow", ms=400, at=2)
        chan = Channel("127.0.0.1", server.port, timeout=0.15)
        assert chan.request({"cmd": "init", "keys": ["a"],
                             "values": [np.ones(2, "f4")]}).get("ok")
        with pytest.raises(TimeoutError, match="slow or wedged"):
            chan.request({"cmd": "pull", "key": "a"})
        time.sleep(0.5)
        r = chan.request({"cmd": "pull", "key": "a"})
        np.testing.assert_array_equal(np.asarray(r["value"]), 1.0)
        chan.close()
        faults.clear()
        _tracker_env(monkeypatch, server.port)
        kv = KVStoreDist("dist_sync")
        kv.init("w", tmx.nd.ones((6,), ctx=tmx.cpu()))
        faults.inject("server.dispatch", "crash", cmd="push", at=1)
        with pytest.raises(ServerLostError) as err:
            kv.push("w", tmx.nd.ones((6,), ctx=tmx.cpu()))
        assert err.value.server == 0 and "w" in err.value.keys
        assert [e["kind"] for e in faults.trace()
                if e["event"] == "fault"] == ["crash"]
        kv.close(send_stop=False)
    finally:
        server.shutdown()


def _mlp(pkg):
    s = pkg.sym
    d = s.Variable("data")
    f1 = s.FullyConnected(d, num_hidden=8, name="fc1")
    a1 = s.Activation(f1, act_type="relu")
    f2 = s.FullyConnected(a1, num_hidden=4, name="fc2")
    return s.SoftmaxOutput(f2, name="softmax")


def _fit_dist(pkg, server, port, ckpt_dir=None, kill_at=None, num_epoch=2,
              ctx=None):
    """One single-worker dist_sync fit of `_mlp` against `server` (the
    JAX package's `tests/test_resilience.py` run).  With `kill_at` the
    server is crashed at that batch end and an empty replacement starts
    on the same port; fit must diagnose the loss and resume."""
    srv_cls = type(server)
    pkg.random.seed(11)
    np.random.seed(11)
    X = np.random.RandomState(2).randn(48, 10).astype("f4")
    y = (np.arange(48) % 4).astype("f4")
    it = pkg.io.NDArrayIter(X, y, batch_size=8, shuffle=False)
    mod = pkg.mod.Module(_mlp(pkg), context=ctx or pkg.cpu())
    replacement, cb = [], None
    if kill_at is not None:
        hits = {"n": 0}

        def cb(param):
            hits["n"] += 1
            if hits["n"] == kill_at:
                server._simulate_crash()
                for _ in range(200):
                    try:
                        srv = srv_cls(host="127.0.0.1", port=port,
                                      num_workers=1)
                        break
                    except OSError:
                        time.sleep(0.05)
                replacement.append(srv.start())
    mod.fit(it, kvstore="dist_sync", optimizer="sgd",
            optimizer_params={"learning_rate": 0.1}, num_epoch=num_epoch,
            checkpoint_dir=ckpt_dir, checkpoint_period=1,
            batch_end_callback=cb)
    params = {k: v.asnumpy().copy() for k, v in mod.get_params()[0].items()}
    if getattr(mod, "_kvstore", None) is not None:
        mod._kvstore.close()
    return params, replacement


def test_killed_server_fit_auto_resumes_bit_identical(monkeypatch, tmp_path,
                                                      fast_failover):
    """The server crashes mid-epoch and comes back empty on the same
    address: `Module.fit(checkpoint_dir=...)` raises `ServerLostError`
    inside, restarts from the last checkpoint and ends bit for bit where
    an uninterrupted run ends."""
    from incubator_mxnet_tpu_torch.dist.server import ParameterServer
    clean_server = ParameterServer(num_workers=1).start()
    _tracker_env(monkeypatch, clean_server.port)
    clean, _ = _fit_dist(tmx, clean_server, clean_server.port)
    clean_server.shutdown()
    server = ParameterServer(num_workers=1).start()
    _tracker_env(monkeypatch, server.port)
    try:
        got, replacement = _fit_dist(tmx, server, server.port,
                                     ckpt_dir=str(tmp_path / "ck"),
                                     kill_at=7)
    finally:
        server.shutdown()
    assert replacement, "the kill callback never ran"
    try:
        assert sorted(got) == sorted(clean)
        for k in clean:
            np.testing.assert_array_equal(got[k], clean[k], err_msg=k)
    finally:
        for srv in replacement:
            srv.shutdown()


def test_fit_without_checkpoint_dir_still_dies_on_server_loss(
        monkeypatch, fast_failover):
    """No checkpoint, no silent restart: `ServerLostError` propagates,
    and ``max_restarts=0`` refuses a restart even with a directory."""
    from incubator_mxnet_tpu_torch.dist.server import ParameterServer
    from incubator_mxnet_tpu_torch.resilience import ServerLostError
    X = np.random.RandomState(3).randn(16, 10).astype("f4")
    y = (np.arange(16) % 4).astype("f4")
    for kw in ({}, {"max_restarts": 0, "checkpoint_dir": None}):
        server = ParameterServer(num_workers=1).start()
        _tracker_env(monkeypatch, server.port)
        mod = tmx.mod.Module(_mlp(tmx), context=tmx.cpu())
        try:
            with pytest.raises(ServerLostError):
                mod.fit(tmx.io.NDArrayIter(X, y, 8, shuffle=False),
                        kvstore="dist_sync", optimizer="sgd", num_epoch=2,
                        batch_end_callback=lambda p: server._simulate_crash(),
                        **kw)
        finally:
            if getattr(mod, "_kvstore", None) is not None:
                mod._kvstore.close(send_stop=False)
            server.shutdown()


def test_one_worker_dist_fit_matches_jax(monkeypatch):
    """The same one-worker ``dist_sync`` fit of `_mlp` (seeded data and
    initializer) in both packages, each against its own server: the
    parameters after 2 epochs of 6 steps within phase 6's gate on
    parameters after a fit, rtol 1e-3 + 1e-4 * max|array| (fp32 sums in
    other orders through forward, backward and the server's SGD; a bias
    near zero moves by ~1e-4 of itself)."""
    import incubator_mxnet_tpu.dist.server as jserver
    from incubator_mxnet_tpu_torch.dist.server import ParameterServer
    out = {}
    for pkg, cls in ((tmx, ParameterServer), (jmx, jserver.ParameterServer)):
        server = cls(num_workers=1).start()
        _tracker_env(monkeypatch, server.port)
        try:
            out[pkg], _ = _fit_dist(pkg, server, server.port)
        finally:
            server.shutdown()
    assert sorted(out[tmx]) == sorted(out[jmx])
    for k, want in out[jmx].items():
        np.testing.assert_allclose(out[tmx][k], want, rtol=FIT_TOL[0],
                                   atol=FIT_TOL[1] * np.abs(want).max(),
                                   err_msg=k)
