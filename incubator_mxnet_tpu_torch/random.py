"""Framework RNG state (`mx.random`).

PyTorch port of `incubator_mxnet_tpu/random.py`.  Two streams, both reset
by `seed`:

* `host_rng()`: a numpy Generator over a (seed, counter) `SeedSequence`,
  the stream the initializers draw from.  It is a copy of the JAX
  package's, so under one `seed(n)` both packages initialise parameters
  bitwise alike.
* `generator(device)`: a `torch.Generator` on `device` for the ops that
  draw on the device (Dropout in training), seeded from its own
  (seed, counter) chain.  The JAX package draws those from a threefry
  key chain, so they never match it bitwise.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

__all__ = ["seed", "host_rng", "generator"]

_state = threading.local()


def seed(seed_state, ctx="all"):
    """Reset both streams (reference `python/mxnet/random.py:seed`);
    ``ctx`` is accepted for API parity."""
    _state.host_seq = [int(seed_state), 0]
    _state.device_seq = [int(seed_state), 0]


def _entropy_seq():
    # never seeded: a base from OS entropy, as the reference's mt19937
    # resource seeds itself; np.random.seed() does not touch these streams
    return [int(np.random.SeedSequence().entropy % (2 ** 63)), 0]


def host_rng():
    """numpy Generator for host-side draws (initializers), reproducible
    under `seed(n)`."""
    seq = getattr(_state, "host_seq", None)
    if seq is None:
        seq = _state.host_seq = _entropy_seq()
    seq[1] += 1
    return np.random.default_rng(np.random.SeedSequence(tuple(seq)))


def generator(device):
    """A fresh `torch.Generator` on `device`, the next of the device
    chain under `seed(n)`."""
    seq = getattr(_state, "device_seq", None)
    if seq is None:
        seq = _state.device_seq = _entropy_seq()
    seq[1] += 1
    state = np.random.SeedSequence((seq[0], 1, seq[1])).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state >> 1))
