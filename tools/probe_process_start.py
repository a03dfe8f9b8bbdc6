"""Where a process start goes on the card: python, ``import torch``, the
CUDA context, cuBLAS, cuDNN, ``import incubator_mxnet_tpu_torch``,
``import chip_smoke`` and K1's first launch (which builds its library if
it is missing), each printed as seconds after the previous mark, for one
child alone and then for three started at once.

    python3 tools/probe_process_start.py
"""
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def child(t_spawn):
    marks = [("exec", time.time())]
    import torch
    marks.append(("import torch", time.time()))
    torch.ones(1, device="cuda")
    torch.cuda.synchronize()
    marks.append(("cuda context", time.time()))
    torch.mm(torch.ones(64, 64, device="cuda"),
             torch.ones(64, 64, device="cuda"))
    torch.cuda.synchronize()
    marks.append(("cublas", time.time()))
    torch.nn.functional.conv2d(torch.ones(1, 3, 8, 8, device="cuda"),
                               torch.ones(4, 3, 3, 3, device="cuda"))
    torch.cuda.synchronize()
    marks.append(("cudnn", time.time()))
    sys.path.insert(0, ROOT)
    import incubator_mxnet_tpu_torch  # noqa: F401
    marks.append(("import port", time.time()))
    import chip_smoke  # noqa: F401
    marks.append(("import chip_smoke", time.time()))
    from incubator_mxnet_tpu_torch.subgraph.fused_ops import fc_relu
    fc_relu(torch.ones(8, 64, device="cuda"),
            torch.ones(32, 64, device="cuda"), torch.ones(32, device="cuda"))
    torch.cuda.synchronize()
    marks.append(("K1 loaded + launched", time.time()))
    out, prev = [], t_spawn
    for k, v in marks:
        out.append(f"{k} +{v - prev:.2f}")
        prev = v
    print("start probe: " + ", ".join(out)
          + f"; total {marks[-1][1] - t_spawn:.2f} s", flush=True)


def probe(n):
    t = time.time()
    procs = [subprocess.Popen([sys.executable, __file__, repr(t)],
                              stdout=subprocess.PIPE, text=True)
             for _ in range(n)]
    for p in procs:
        out, _ = p.communicate(300)
        print(f"{n} at once: {(out.strip().splitlines() or [''])[-1]}",
              flush=True)


if __name__ == "__main__":
    if len(sys.argv) > 1:
        child(float(sys.argv[1]))
    else:
        probe(1)
        probe(3)
