"""One rank of the port's ring attention over a gloo process group, for
tests/test_torch_flash_attention.py.  Imports torch and the port only.

`run(rank, world, store_path, inputs_path, out_dir)` joins a gloo group
through a `FileStore`, runs `ring_attention` on its sequence shard for
causal and not, with and without the flash kernels' path
(``use_pallas``), and saves each output as ``r<rank>_c<causal>_p<use>.npy``.
The ``use_pallas`` runs pass an explicit group, so that group ranks are
mapped to global ranks.
"""
import os

import numpy as np
import torch
import torch.distributed as dist


def run(rank, world, store_path, inputs_path, out_dir):
    torch.set_num_threads(1)
    from incubator_mxnet_tpu_torch.parallel import ring_attention
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)
    try:
        group = dist.new_group(list(range(world)))
        data = np.load(inputs_path)
        shard = data["q"].shape[1] // world
        sl = slice(rank * shard, (rank + 1) * shard)
        q, k, v = (torch.from_numpy(np.ascontiguousarray(data[n][:, sl]))
                   for n in ("q", "k", "v"))
        for causal in (False, True):
            for use_pallas in (False, True):
                out = ring_attention(q, k, v,
                                     group=group if use_pallas else None,
                                     causal=causal, use_pallas=use_pallas)
                np.save(os.path.join(
                    out_dir, f"r{rank}_c{int(causal)}_p{int(use_pallas)}.npy"),
                    out.numpy())
    finally:
        dist.destroy_process_group()
