"""Kernel K1 (`fc_relu`, csrc/fc_relu.cu) on a CUDA card against its plain
PyTorch version, and the kernel library's launch plan.

Every test here needs a card and skips without one.  The module imports
no JAX, so on a machine with a card and no JAX it runs alone:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernels_cuda.py

`chip_smoke.py` covers the full VGG-16 shapes.
"""
import numpy as np
import pytest
import torch

from incubator_mxnet_tpu_torch.subgraph.fused_ops import (fc_relu,
                                                          fc_relu_ref,
                                                          launch_plan)


def _inputs(m, k, n, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.normal(0, 1, (m, k)).astype(np.float32)
    w = (rng.normal(0, 1, (n, k)) / np.sqrt(k)).astype(np.float32)
    b = rng.normal(0, 0.1, (n,)).astype(np.float32)
    return x, w, b


@pytest.mark.cuda
def test_launch_plan_covers_k_and_fills_the_card():
    """The kernel library's own launch plan (it lives beside the tile
    constants in csrc/fc_relu.cu)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for m, k, n, dt in [(1, 25088, 4096, torch.float32),
                        (8, 4096, 4096, torch.bfloat16),
                        (32, 25088, 4096, torch.float32),
                        (5, 784, 128, torch.float32),
                        (8, 10, 16, torch.float32)]:
        x = torch.zeros(m, k, dtype=dt, device="cuda")
        w = torch.zeros(n, k, dtype=dt, device="cuda")
        plan = launch_plan(x, w)
        vec = plan["vec"]
        assert vec == (16 // x.element_size() if k % (16 // x.element_size())
                       == 0 else 1)
        assert plan["rows"] >= min(m, 8) and plan["rows"] in (1, 2, 4, 8)
        assert plan["k_chunk"] % (32 * vec) == 0
        splits, k_chunk = plan["splits"], plan["k_chunk"]
        assert splits * k_chunk >= k > (splits - 1) * k_chunk
        assert plan["workspace"] == (splits * m * n if splits > 1 else 0)
        if k == 25088:
            # the VGG-16 classifier at small buckets: a block per SM
            assert -(-n // 32) * splits >= sms
    x = torch.zeros(2, 64, device="cuda")
    too_wide = torch.zeros(1, 64, device="cuda").expand(2 ** 21 + 1, 64)
    assert launch_plan(x, too_wide) is None


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fc_relu_kernel_on_card(dtype):
    """K1 on the card against its plain version (the chip smoke covers
    the full VGG-16 shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card")
    dt = getattr(torch, dtype)
    for m, k, n in [(5, 784, 128), (8, 10, 16), (3, 4096, 100)]:
        x, w, b = (torch.from_numpy(a).to("cuda", dt)
                   for a in _inputs(m, k, n))
        before = fc_relu.launches
        got = fc_relu(x, w, b)
        torch.cuda.synchronize()
        assert fc_relu.launches == before + 1
        tol = 1e-4 if dt == torch.float32 else 2.0 ** -6
        torch.testing.assert_close(got.float(), fc_relu_ref(x, w, b).float(),
                                   rtol=tol, atol=tol)
