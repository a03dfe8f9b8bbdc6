"""Server-process bootstrap (reference `python/mxnet/kvstore_server.py`).

PyTorch port of `incubator_mxnet_tpu/kvstore_server.py`: with
``DMLC_ROLE=server`` a process serves the port's `dist.server.
ParameterServer` until every worker has sent its stop.  Normal use never
touches this module: `kvstore.create('dist_*')` already becomes the
server in a server-role process.
"""
from __future__ import annotations

import os

from .base import MXNetError

__all__ = ["KVStoreServer"]


class KVStoreServer:
    """Reference `kvstore_server.py:KVStoreServer`."""

    def __init__(self, kvstore=None):
        self.kvstore = kvstore
        self.init_logging = False

    def run(self):
        """Serve until every worker has sent its stop command."""
        if os.environ.get("DMLC_ROLE") not in ("server", None):
            raise MXNetError("KVStoreServer.run: DMLC_ROLE is not 'server'")
        from .dist.server import ParameterServer
        ParameterServer(
            host=os.environ.get("DMLC_PS_ROOT_URI", "127.0.0.1"),
            port=int(os.environ.get("DMLC_PS_ROOT_PORT", 9091)),
        ).serve_forever()


def _init_kvstore_server_module():
    """Server-role processes never return."""
    if os.environ.get("DMLC_ROLE") == "server":
        import sys
        KVStoreServer().run()
        sys.exit(0)
