"""torch's functional collectives (what DTensor's redistributions call)
on CUDA tensors over a 2-rank gloo group on one card, one pair of
processes per verb, all pairs at once: which verb kills a rank (its exit
code) and whether each result is exact.

    python3 tools/probe_gloo_funcol.py
"""
import socket
import subprocess
import sys

VERBS = ("all_reduce", "all_gather_tensor", "reduce_scatter_tensor",
         "all_to_all_single", "broadcast")


def rank_main(verb, rank, port):
    import torch
    import torch.distributed as dist
    import torch.distributed._functional_collectives as fc
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=2)
    torch.cuda.set_device(0)
    g = dist.group.WORLD
    x = torch.arange(4.0, device="cuda").reshape(2, 2) + 10 * rank
    xs = [torch.arange(4.0, device="cuda").reshape(2, 2) + 10 * r
          for r in range(2)]
    if verb == "all_reduce":
        y, want = fc.all_reduce(x, "sum", g), xs[0] + xs[1]
    elif verb == "all_gather_tensor":
        y, want = fc.all_gather_tensor(x, 0, g), torch.cat(xs)
    elif verb == "reduce_scatter_tensor":
        y, want = fc.reduce_scatter_tensor(x, "sum", 0, g), \
            (xs[0] + xs[1])[rank:rank + 1]
    elif verb == "all_to_all_single":
        y, want = fc.all_to_all_single(x, [1, 1], [1, 1], g), \
            torch.cat([xs[r][rank:rank + 1] for r in range(2)])
    else:
        y, want = fc.broadcast(x, 1, g), xs[1]
    y = fc.wait_tensor(y) if hasattr(fc, "wait_tensor") else y
    torch.cuda.synchronize()
    print(f"{verb} rank {rank} exact {bool(torch.equal(y, want))}", flush=True)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    if len(sys.argv) > 1:
        rank_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
        sys.exit(0)
    procs = []
    for verb in VERBS:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        for r in range(2):
            procs.append((verb, r, subprocess.Popen(
                [sys.executable, __file__, verb, str(r), str(port)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for verb, r, p in procs:
        try:
            out, _ = p.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        last = [ln for ln in out.splitlines() if ln.strip()][-1:] or [""]
        print(f"funcol probe: {verb} rank {r} exit {p.returncode}: "
              f"{last[0][:300]}", flush=True)
