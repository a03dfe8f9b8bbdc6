"""One elastic pod worker: a supervised `Module.fit(kvstore='dist_sync')`
against the coordinator the dmlc environment names, with elastic
checkpoints, printing a protocol its launcher parses.

The port's counterpart of the repo's `tools/pod_worker.py` (one copy
shared by the CPU tests and `chip_smoke.py`'s phase 23c):

    python -m incubator_mxnet_tpu_torch.dist.pod_worker

prints, after the fit,

    SUPSTATS {json}      JobSupervisor.stats() of the final attempt
    SHRINK {json}        the committed shrink's epoch, world, barrier
                         seconds and wall-clock end (only after one)
    FINDINGS [json]      the supervisor's findings (host losses with
                         the wall clock they were seen at)
    K1 N                 fc_relu launches in this process
    PARAMS_SHA hex       sha256 over the sorted final parameters
    worker OK rank=R

and, at each batch end, ``STEP epoch nbatch world wall-clock`` (flushed,
so a killed worker's last step is on record).  There is no ``COMPILES``
line: the port has no program cache.

Env: ``POD_CKPT_DIR`` (the shared checkpoint directory, required),
``POD_RESUME=1`` (resume the directory's run: the control lane of the
bit-identical gate), ``POD_MODEL`` (``tiny``, the JAX pod worker's
10-8-4 mlp on 48 rows, the default; or ``mlp``, train_mnist's
784-128-64-10 mlp at batch ``POD_BATCH`` (32) over ``POD_BATCHES`` (12)
batches a epoch of `test_utils.get_mnist_like` images), ``POD_DEVICE``
(``gpu``, the default, or ``cpu``), and the usual ``DMLC_*`` /
``MXNET_*`` knobs (fault schedules ride ``MXNET_FAULTS``).
"""
import hashlib
import json
import logging
import os
import time

import numpy as np


def _model(mx):
    """(symbol, data, labels, batch) of ``POD_MODEL``."""
    sym = mx.sym
    if os.environ.get("POD_MODEL", "tiny") == "mlp":
        d = sym.Variable("data")
        x = sym.Activation(sym.FullyConnected(d, name="fc1", num_hidden=128),
                           name="relu1", act_type="relu")
        x = sym.Activation(sym.FullyConnected(x, name="fc2", num_hidden=64),
                           name="relu2", act_type="relu")
        net = sym.SoftmaxOutput(sym.FullyConnected(x, name="fc3",
                                                   num_hidden=10),
                                name="softmax")
        batch = int(os.environ.get("POD_BATCH", 32))
        n = batch * int(os.environ.get("POD_BATCHES", 12))
        x, y = mx.test_utils.get_mnist_like(n)
        return net, np.asarray(x, "f4"), np.asarray(y, "f4"), batch
    d = sym.Variable("data")
    f1 = sym.FullyConnected(d, num_hidden=8, name="fc1")
    a1 = sym.Activation(f1, act_type="relu")
    f2 = sym.FullyConnected(a1, num_hidden=4, name="fc2")
    net = sym.SoftmaxOutput(f2, name="softmax")
    x = np.random.RandomState(2).randn(48, 10).astype("f4")
    y = (np.arange(48) % 4).astype("f4")
    return net, x, y, 8


def main():
    logging.basicConfig(level=logging.INFO)
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch.resilience import supervisor as supmod
    from incubator_mxnet_tpu_torch.subgraph.fused_ops import fc_relu

    ctx = mx.cpu() if os.environ.get("POD_DEVICE", "gpu") == "cpu" \
        else mx.gpu(0)
    mx.random.seed(11)
    np.random.seed(11)
    net, x, y, batch = _model(mx)
    it = mx.io.NDArrayIter(x, y, batch_size=batch, shuffle=False)
    mod = mx.mod.Module(net, context=ctx)

    def on_step(param):
        sup = mod._supervisor
        world = sup.num_workers if sup is not None else \
            int(os.environ.get("DMLC_NUM_WORKER", 1))
        print("STEP %d %d %d %.6f" % (param.epoch, param.nbatch, world,
                                      time.time()), flush=True)

    fc_relu.launches = 0
    mod.fit(it, kvstore="dist_sync", optimizer="sgd",
            optimizer_params={"learning_rate": 0.1}, num_epoch=2,
            checkpoint_dir=os.environ["POD_CKPT_DIR"],
            checkpoint_period=1, checkpoint_keep_last=100,
            resume=os.environ.get("POD_RESUME") == "1",
            batch_end_callback=on_step)
    sup = mod._supervisor
    if sup is not None:
        print("SUPSTATS " + json.dumps(sup.stats()))
    shrink = getattr(mod, "_last_shrink", None)
    if shrink is not None:
        print("SHRINK " + json.dumps({
            "epoch": shrink.epoch, "world_size": shrink.world_size,
            "rank": shrink.rank, "seconds": shrink.seconds,
            "ended": shrink.ended}))
    print("FINDINGS " + json.dumps([f.as_dict()
                                    for f in supmod.findings()]))
    print("K1 %d" % fc_relu.launches)
    args, _ = mod.get_params()
    blob = b"".join(args[k].asnumpy().tobytes() for k in sorted(args))
    print("PARAMS_SHA " + hashlib.sha256(blob).hexdigest())
    kv = getattr(mod, "_kvstore", None)
    if kv is not None:
        # the protocol 'stop' lets the coordinator reach its shutdown
        # quorum once every (post-shrink) worker finished
        kv.close()
    print("worker OK rank=%s" % os.environ.get("DMLC_RANK"), flush=True)


if __name__ == "__main__":
    main()
