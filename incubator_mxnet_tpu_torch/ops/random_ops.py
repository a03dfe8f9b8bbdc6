"""Random sampling ops (reference `src/operator/random/sample_op.cc`,
`sample_multinomial_op.cc`, `shuffle_op.cc`).

PyTorch port of `incubator_mxnet_tpu/ops/random_ops.py`.  Each op draws
from the `torch.Generator` the frontend appends (`random.generator` of
the output's device, the device stream that Dropout uses; never the
host stream the initializers share), or from a fresh one of that
stream when it is given None (a graph run for inference).  The JAX ops
draw from a threefry key chain, so the two packages agree in
distribution only: the same ``seed`` gives the same draws within the
port on one device, not across packages or devices.
"""
from __future__ import annotations

import torch

from ..base import torch_dtype
from .registry import register


def _shape(params):
    s = params.get("shape", ())
    if s is None:
        s = ()
    if isinstance(s, int):
        s = (s,)
    return tuple(s)


def _dt(params, default="float32"):
    d = params.get("dtype") or default
    return torch_dtype(default if d in (None, "None") else d)


def _gen(generator, device):
    if generator is not None:
        return generator
    from .. import random as _random
    return _random.generator(torch.device("cpu") if device is None
                             else device)


def _device(generator, device):
    if device is not None:
        return torch.device(device)
    return generator.device if generator is not None else torch.device("cpu")


def _draw(params, generator, device, sample):
    """``sample(shape, generator, device)`` at the op's shape, dtype and
    device; an empty tensor for shape inference."""
    shape, dt = _shape(params), _dt(params)
    device = _device(generator, device)
    if device.type == "meta":
        return torch.empty(shape, dtype=dt, device="meta")
    gen = _gen(generator, device)
    return sample(shape, gen, device).to(dt)


def _uniform(shape, gen, device, dtype=torch.float32):
    return torch.rand(shape, generator=gen, device=device, dtype=dtype)


def _normal(shape, gen, device, dtype=torch.float32):
    return torch.randn(shape, generator=gen, device=device, dtype=dtype)


def _gamma(alpha, gen):
    """Gamma(alpha, 1) draws of the shape of the tensor `alpha`."""
    return torch._standard_gamma(alpha, generator=gen)


def _full(shape, value, device):
    return torch.full(shape, float(value), dtype=torch.float32,
                      device=device)


@register("_random_uniform", nin=0, needs_rng=True, aliases=("uniform",),
          params={"low": 0.0, "high": 1.0, "shape": (), "dtype": "float32",
                  "ctx": None})
def _random_uniform(params, generator=None, device=None):
    low, high = params["low"], params["high"]
    return _draw(params, generator, device, lambda s, g, d: low + (
        high - low) * _uniform(s, g, d, torch.float64))


@register("_random_normal", nin=0, needs_rng=True, aliases=("normal",),
          params={"loc": 0.0, "scale": 1.0, "shape": (), "dtype": "float32",
                  "ctx": None})
def _random_normal(params, generator=None, device=None):
    loc, scale = params["loc"], params["scale"]
    return _draw(params, generator, device, lambda s, g, d: loc + scale *
                 _normal(s, g, d, _dt(params)))


@register("_random_gamma", nin=0, needs_rng=True, aliases=("gamma_sample",),
          params={"alpha": 1.0, "beta": 1.0, "shape": (), "dtype": "float32",
                  "ctx": None})
def _random_gamma(params, generator=None, device=None):
    return _draw(params, generator, device, lambda s, g, d: params["beta"] *
                 _gamma(_full(s, params["alpha"], d), g))


@register("_random_exponential", nin=0, needs_rng=True,
          params={"lam": 1.0, "shape": (), "dtype": "float32", "ctx": None})
def _random_exponential(params, generator=None, device=None):
    return _draw(params, generator, device, lambda s, g, d: torch.empty(
        s, device=d).exponential_(1.0, generator=g) / params["lam"])


@register("_random_poisson", nin=0, needs_rng=True,
          params={"lam": 1.0, "shape": (), "dtype": "float32", "ctx": None})
def _random_poisson(params, generator=None, device=None):
    return _draw(params, generator, device, lambda s, g, d: torch.poisson(
        _full(s, params["lam"], d), generator=g))


@register("_random_negative_binomial", nin=0, needs_rng=True,
          params={"k": 1, "p": 1.0, "shape": (), "dtype": "float32",
                  "ctx": None})
def _random_negative_binomial(params, generator=None, device=None):
    """Poisson(Gamma(k) * (1 - p) / p): failures before the k-th success."""
    p = params["p"]
    return _draw(params, generator, device, lambda s, g, d: torch.poisson(
        _gamma(_full(s, float(params["k"]), d), g) * ((1 - p) / p),
        generator=g))


@register("_random_generalized_negative_binomial", nin=0, needs_rng=True,
          params={"mu": 1.0, "alpha": 1.0, "shape": (), "dtype": "float32",
                  "ctx": None})
def _random_generalized_negative_binomial(params, generator=None,
                                          device=None):
    """Poisson(Gamma(1 / alpha) * alpha * mu): mean mu, variance mu +
    alpha mu^2."""
    mu, alpha = params["mu"], params["alpha"]
    return _draw(params, generator, device, lambda s, g, d: torch.poisson(
        _gamma(_full(s, 1.0 / alpha, d), g) * (alpha * mu), generator=g))


@register("_random_randint", nin=0, needs_rng=True,
          params={"low": 0, "high": 1, "shape": (), "dtype": "int32",
                  "ctx": None})
def _random_randint(params, generator=None, device=None):
    shape, dt = _shape(params), _dt(params, "int32")
    device = _device(generator, device)
    if device.type == "meta":
        return torch.empty(shape, dtype=dt, device="meta")
    return torch.randint(int(params["low"]), int(params["high"]), shape,
                         generator=_gen(generator, device), device=device,
                         dtype=dt)


# -- parameter-tensor variants (_sample_*): `shape` draws per element of
# the parameter tensors, output (param shape) + shape

def _per_param(params, p, draw, generator):
    """`draw(full_shape, gen)` for parameters `p` of shape P, reshaped to
    broadcast: returns (draws, view) with view(t) = t reshaped to P +
    (1,) * len(shape)."""
    s = _shape(params)
    full = tuple(p.shape) + s
    if p.device.type == "meta":
        return torch.empty(full, dtype=_dt(params), device="meta"), None
    gen = _gen(generator, p.device)
    return draw(full, gen), lambda t: t.reshape(tuple(t.shape) +
                                                (1,) * len(s))


@register("_sample_uniform", nin=2, needs_rng=True,
          params={"shape": (), "dtype": "float32"})
def _sample_uniform(params, low, high, generator=None):
    u, view = _per_param(params, low, lambda f, g: _uniform(
        f, g, low.device, _dt(params)), generator)
    return u if view is None else view(low) + u * view(high - low)


@register("_sample_normal", nin=2, needs_rng=True,
          params={"shape": (), "dtype": "float32"})
def _sample_normal(params, mu, sigma, generator=None):
    z, view = _per_param(params, mu, lambda f, g: _normal(
        f, g, mu.device, _dt(params)), generator)
    return z if view is None else view(mu) + z * view(sigma)


@register("_sample_gamma", nin=2, needs_rng=True,
          params={"shape": (), "dtype": "float32"})
def _sample_gamma(params, alpha, beta, generator=None):
    def draw(full, g):
        a = alpha.reshape(tuple(alpha.shape) + (1,) * (len(full) -
                                                       alpha.dim()))
        return _gamma(a.expand(full).to(_dt(params)).contiguous(), g)
    out, view = _per_param(params, alpha, draw, generator)
    return out if view is None else out * view(beta)


def _multinomial_nout(params):
    return 2 if params.get("get_prob") else 1


@register("_sample_multinomial", nout=_multinomial_nout, needs_rng=True,
          params={"shape": (), "get_prob": False, "dtype": "int32"})
def _sample_multinomial(params, data, generator=None):
    """data (..., K) of probabilities; prod(shape) categorical draws per
    distribution row, output data.shape[:-1] + shape; with ``get_prob``
    also the log-probability of each draw."""
    s = _shape(params)
    n = 1
    for d in s:
        n *= d
    out_shape = tuple(data.shape[:-1]) + s
    dt = _dt(params, "int32")
    if data.device.type == "meta":
        samples = torch.empty(out_shape, dtype=dt, device="meta")
        return (samples, torch.empty(out_shape, dtype=data.dtype,
                                     device="meta")) \
            if params.get("get_prob") else samples
    logits = torch.log(torch.clamp(data, min=1e-37))
    flat = data.reshape(-1, data.shape[-1]).clamp(min=0)
    idx = torch.multinomial(flat, n, replacement=True,
                            generator=_gen(generator, data.device))
    samples = idx.reshape(out_shape).to(dt)
    if params.get("get_prob"):
        lp = torch.gather(logits.reshape(-1, data.shape[-1]), 1, idx)
        return samples, lp.reshape(out_shape)
    return samples


@register("_shuffle", needs_rng=True, aliases=("shuffle",))
def _shuffle(params, x, generator=None):
    """x with its first axis in a random order."""
    if x.device.type == "meta":
        return torch.empty_like(x)
    perm = torch.randperm(x.shape[0], generator=_gen(generator, x.device),
                          device=x.device)
    return x.index_select(0, perm)
