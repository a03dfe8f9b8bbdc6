"""Local job launcher for the port (reference `tools/launch.py:71`).

A copy of the repo's `tools/launch.py` whose servers are the port's:

    python -m incubator_mxnet_tpu_torch.dist.launch -n 2 [-s 1] \\
        python train.py ...

starts ``-s`` parameter servers (``python -m
incubator_mxnet_tpu_torch.dist.server``) and ``-n`` worker processes of
the command with the dmlc tracker's environment (``DMLC_ROLE``,
``DMLC_PS_ROOT_URI``, ``DMLC_PS_ROOT_PORT``, ``DMLC_NUM_WORKER``,
``DMLC_NUM_SERVER``, ``DMLC_RANK``), waits for the workers, then for the
servers (which stop once every worker sent ``stop``; after a failed
worker they are terminated), and exits with the first failing worker's
code, else 0.  Only the ``local`` launcher exists.
"""
from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Launch a distributed job on the port's parameter "
                    "server (reference tools/launch.py)")
    parser.add_argument("-n", "--num-workers", type=int, required=True)
    parser.add_argument("-s", "--num-servers", type=int, default=1,
                        help="parameter servers; keys range-shard over "
                             "them (MXNET_KVSTORE_BIGARRAY_BOUND)")
    parser.add_argument("--launcher", default="local", choices=["local"],
                        help="cluster launchers: set the DMLC_* environment "
                             "with your own tracker instead")
    parser.add_argument("command", nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)
    if not args.command:
        parser.error("no command given")

    port = _free_port()
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    pypath = repo_root + os.pathsep + os.environ.get("PYTHONPATH", "")
    base_env = dict(os.environ,
                    PYTHONPATH=pypath.rstrip(os.pathsep),
                    DMLC_PS_ROOT_URI="127.0.0.1",
                    DMLC_PS_ROOT_PORT=str(port),
                    DMLC_NUM_WORKER=str(args.num_workers),
                    DMLC_NUM_SERVER=str(args.num_servers))
    servers = [subprocess.Popen(
        [sys.executable, "-m", "incubator_mxnet_tpu_torch.dist.server"],
        env=dict(base_env, DMLC_ROLE="server", DMLC_SERVER_ID=str(i)))
        for i in range(args.num_servers)]
    workers = [subprocess.Popen(
        args.command,
        env=dict(base_env, DMLC_ROLE="worker", DMLC_RANK=str(rank)))
        for rank in range(args.num_workers)]
    rc = 0
    try:
        for w in workers:
            rc = w.wait() or rc
    finally:
        for w in workers:
            if w.poll() is None:
                w.kill()
                w.wait()
        for server in servers:
            try:
                # a clean run ends when every worker sent its stop; after
                # a failure a server never hears them all
                server.wait(timeout=15 if rc else 60)
            except subprocess.TimeoutExpired:
                server.terminate()
                server.wait()
    return rc


if __name__ == "__main__":
    sys.exit(main())
