"""Data helpers for tests and examples (a copy of the JAX-free part of
`incubator_mxnet_tpu/test_utils.py` the port needs)."""
from __future__ import annotations

import numpy as np

__all__ = ["get_mnist_like"]


def get_mnist_like(num=1000, seed=0):
    """Synthetic MNIST-like dataset (deterministic) for training tests and
    the MNIST example without the downloaded files: 10 class prototypes
    plus noise, (num, 1, 28, 28) float32 images and float32 labels."""
    rng = np.random.RandomState(seed)
    protos = rng.rand(10, 1, 28, 28).astype("f4")
    labels = rng.randint(0, 10, num)
    imgs = protos[labels] + 0.1 * rng.rand(num, 1, 28, 28).astype("f4")
    return imgs.astype("f4"), labels.astype("f4")
