"""ServedModel: a loaded model served over a fixed ladder of batch buckets.

PyTorch port of `incubator_mxnet_tpu/serving/model.py`.  The parameters
are pinned on the device (`fused.FusedInference`); a request that does
not fill a bucket is padded up to the nearest one by replicating its
final row (inference is row-independent, and every read path slices the
pad rows off).  The JAX package fixes the ladder so that every XLA
compile happens at `warmup()`; here `warmup()` runs each bucket once so
the first request does not pay the library's first-call set-up.
"""
from __future__ import annotations

import numpy as _np
import torch

from ..base import MXNetError
from ..context import current_context
from ..ndarray.ndarray import NDArray

__all__ = ["ServedModel", "DEFAULT_BUCKETS"]

DEFAULT_BUCKETS = (1, 2, 4, 8, 16, 32)


def _as_desc_list(data_shapes):
    """Normalize [(name, shape)] / [DataDesc] -> [(name, tuple(shape))]."""
    out = []
    for d in data_shapes:
        name, shape = (d.name, d.shape) if hasattr(d, "name") else \
            (d[0], d[1])
        out.append((str(name), tuple(int(s) for s in shape)))
    return out


class ServedModel:
    """One model over a bucket ladder, ready to serve.

    symbol : the inference graph.
    arg_params / aux_params : parameter values (NDArray, tensor or numpy)
        for every argument but the data inputs, and every aux state.
    data_shapes : [(name, shape)]; ``shape[0]`` is the batch axis and is
        replaced by each bucket size.
    buckets : batch-size ladder; ``max(buckets)`` is the largest batch.
    ctx : the device context; default `current_context()`, the card.
    """

    def __init__(self, symbol, arg_params, aux_params=None, data_shapes=None,
                 buckets=DEFAULT_BUCKETS, ctx=None, name="model",
                 dtype=_np.float32):
        if not data_shapes:
            raise MXNetError(f"ServedModel('{name}'): data_shapes required")
        self.name = str(name)
        self.ctx = ctx if ctx is not None else current_context()
        self.buckets = tuple(sorted({int(b) for b in buckets}))
        if not self.buckets or self.buckets[0] < 1:
            raise MXNetError(f"ServedModel('{name}'): buckets must be "
                             "positive ints")
        descs = _as_desc_list(data_shapes)
        self.data_names = [n for n, _ in descs]
        self._sample_shapes = {n: s[1:] for n, s in descs}
        self._dtype = _np.dtype(dtype)
        self.output_names = symbol.list_outputs()

        from .. import fused as _fused
        # resolving the device raises when the card is missing and the
        # caller did not ask for the CPU
        self._infer = _fused.FusedInference(symbol, self.ctx,
                                            self.data_names)
        self.set_params(arg_params, aux_params)
        self.warmed = False

    @classmethod
    def load(cls, prefix, epoch=0, **kwargs):
        """From the checkpoint pair ``prefix-symbol.json`` +
        ``prefix-%04d.params`` (`model.load_checkpoint`)."""
        from ..model import load_checkpoint
        sym, args, auxs = load_checkpoint(prefix, epoch)
        return cls(sym, args, auxs, **kwargs)

    # -- buckets -------------------------------------------------------------
    @property
    def max_batch_size(self):
        return self.buckets[-1]

    def bucket_for(self, n):
        """Smallest bucket >= n, or None when n exceeds the ladder."""
        return next((b for b in self.buckets if n <= b), None)

    # -- execution -----------------------------------------------------------
    def warmup(self):
        """Run every bucket once, so no request pays first-call set-up."""
        for b in self.buckets:
            self.run_bucket([_np.zeros((b,) + self._sample_shapes[n],
                                       self._dtype)
                             for n in self.data_names], b)
        self.synchronize()
        self.warmed = True

    def run_bucket(self, arrs, bucket):
        """Dispatch one bucket-shaped (already padded) batch; returns the
        output tensors, possibly still being computed."""
        return self._infer(arrs)

    def synchronize(self):
        """Wait for the work this model queued on its device."""
        if self._infer.device.type == "cuda":
            torch.cuda.synchronize(self._infer.device)

    def prepare_rows(self, inputs):
        """Normalize a request's inputs to ``(rows, [np arrays])`` in
        `data_names` order.  Accepts a dict or a positional list; a bare
        sample (ndim == sample ndim) is promoted to a batch of one."""
        if isinstance(inputs, dict):
            missing = [n for n in self.data_names if n not in inputs]
            if missing:
                raise MXNetError(f"serving: model '{self.name}' request "
                                 f"missing inputs {missing}")
            vals = [inputs[n] for n in self.data_names]
        else:
            vals = list(inputs)
            if len(vals) != len(self.data_names):
                raise MXNetError(
                    f"serving: model '{self.name}' expects "
                    f"{len(self.data_names)} inputs, got {len(vals)}")
        rows = None
        arrs = []
        for name, v in zip(self.data_names, vals):
            a = v.asnumpy() if isinstance(v, NDArray) else _np.asarray(v)
            sample = self._sample_shapes[name]
            if a.ndim == len(sample):
                a = a[None]
            if tuple(a.shape[1:]) != sample:
                raise MXNetError(
                    f"serving: model '{self.name}' input '{name}' has "
                    f"sample shape {tuple(a.shape[1:])}, expected {sample}")
            a = a.astype(self._dtype, copy=False)
            if rows is None:
                rows = a.shape[0]
            elif a.shape[0] != rows:
                raise MXNetError(
                    f"serving: model '{self.name}' inputs disagree on the "
                    f"batch axis ({a.shape[0]} vs {rows})")
            arrs.append(a)
        if not rows:
            raise MXNetError(
                f"serving: model '{self.name}' request has no rows")
        return rows, arrs

    def pad_rows(self, arrs, rows, bucket):
        """Pad each array from `rows` up to `bucket` by replicating the
        final row (the pad rows are never returned)."""
        if rows == bucket:
            return arrs
        return [_np.concatenate([a, _np.repeat(a[-1:], bucket - rows, 0)])
                for a in arrs]

    def infer(self, inputs):
        """The single-request path: pad to the nearest bucket, run, return
        per-output NDArrays with the pad rows sliced off.  Safe from any
        thread."""
        rows, arrs = self.prepare_rows(inputs)
        bucket = self.bucket_for(rows)
        if bucket is None:
            raise MXNetError(
                f"serving: model '{self.name}' request batch {rows} exceeds "
                f"max bucket {self.max_batch_size}")
        outs = self.run_bucket(self.pad_rows(arrs, rows, bucket), bucket)
        self.synchronize()
        return [NDArray(o[:rows], ctx=self.ctx) for o in outs]

    def set_params(self, arg_params, aux_params=None):
        """(Hot-)swap the parameter set; in-flight dispatches finish against
        the snapshot they captured."""
        self._infer.set_params(arg_params or {}, aux_params)
