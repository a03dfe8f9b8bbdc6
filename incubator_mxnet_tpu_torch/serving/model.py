"""ServedModel: a loaded model served over a fixed ladder of batch buckets.

PyTorch port of `incubator_mxnet_tpu/serving/model.py`.  The parameters
are pinned on the device (`fused.FusedInference`); a request that does
not fill a bucket is padded up to the nearest one by replicating its
final row (inference is row-independent, and every read path slices the
pad rows off).  The JAX package fixes the ladder so that every XLA
compile happens at `warmup()`; here `warmup()` runs each bucket once so
the first request does not pay the library's first-call set-up.

``dtype`` is the dtype requests are cast to (float32 by default):
anything `np.dtype` takes, ``"bfloat16"`` or ``torch.bfloat16``.  numpy
has no bfloat16 without ml_dtypes, so requests are normalised in float32
on the host and cast once on the way to the device (the JAX package
casts on the host with ml_dtypes; both round to nearest even).  The
parameters stay as loaded, as in the JAX package: the ops promote.
Argument slots the checkpoint does not fill (a loss head's label, see
`fused.FusedInference`) are fed zeros of the shape each bucket gives
them.  `from_checkpoint_dir` loads the newest valid elastic checkpoint
under a root (`checkpoint.latest` validates the manifest and every
shard's CRC, so a torn checkpoint is never taken); the JAX method also
registers the checkpoint's compiled-program payload, which the port,
compiling nothing, has no use for.  `infer_exact` runs at exactly the
declared shapes (the C predict ABI's path), and a `monitor.Monitor`
installed on the model sees the batched outputs of every dispatch.
`program_count` is the number of input signatures the model has run
(its ladder after `warmup`, unchanged by a weight swap).
"""
from __future__ import annotations

import numpy as _np
import torch

from ..base import MXNetError, torch_dtype
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
        self._declared_shapes = dict(descs)      # as given (the C ABI's)
        self._sample_shapes = {n: s[1:] for n, s in descs}
        self._dtype = torch_dtype(dtype)
        # the host dtype requests are normalised in
        self._host_dtype = _np.float32 if self._dtype == torch.bfloat16 \
            else _np.dtype(str(self._dtype).replace("torch.", ""))
        self.output_names = symbol.list_outputs()
        self._symbol = symbol
        self._extra_cache = {}    # input shapes -> zeros for the unfilled
        self._monitor = None      # callback(name, NDArray) per output
        self._signatures = set()  # input shapes this model has run

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

    @classmethod
    def from_checkpoint_dir(cls, symbol_file, checkpoint_path, **kwargs):
        """From a symbol JSON file and an elastic `checkpoint/` directory,
        or a root of them: the newest valid one, never a torn one."""
        from .. import symbol as _sym
        from .replica import _load_checkpoint_params
        args, auxs = _load_checkpoint_params(checkpoint_path)
        return cls(_sym.load(symbol_file), args, auxs, **kwargs)

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
                                       self._host_dtype)
                             for n in self.data_names], b)
        self.synchronize()
        self.warmed = True

    def run_bucket(self, arrs, bucket):
        """Dispatch one bucket-shaped (already padded) batch; returns the
        output tensors, possibly still being computed."""
        return self._run(arrs, {n: (bucket,) + self._sample_shapes[n]
                                for n in self.data_names})

    def _run(self, arrs, shapes):
        self._signatures.add(tuple(shapes[n] for n in self.data_names))
        dev = self._infer.device
        inputs = [torch.from_numpy(_np.ascontiguousarray(a)).to(
            dev, self._dtype) for a in arrs]
        outs = self._infer(inputs, self._extras(shapes))
        mon = self._monitor
        if mon is not None:
            for name, out in zip(self.output_names, outs):
                mon(name, NDArray(out, ctx=self.ctx))
        return outs

    def _extras(self, shapes):
        """float32 zeros for the unfilled argument slots, shaped by
        inference at these input shapes (a label's follows the batch)."""
        key = tuple(shapes[n] for n in self.data_names)
        got = self._extra_cache.get(key)
        if got is None:
            names = self._infer.extra_names
            got = ()
            if names:
                arg_shapes, _, _ = self._symbol.infer_shape(**shapes)
                by_name = dict(zip(self._symbol.list_arguments(),
                                   arg_shapes))
                got = tuple(torch.zeros(by_name[n], device=self._infer.device)
                            for n in names)
            self._extra_cache[key] = got
        return got

    def program_count(self):
        """The number of input signatures this model has run: its bucket
        ladder after `warmup`.  A weight swap keeps it (same shapes); the
        JAX package counts its compiled XLA programs."""
        return len(self._signatures)

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
            a = a.astype(self._host_dtype, copy=False)
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

    def infer_exact(self, inputs):
        """Run at exactly the declared `data_shapes`: no batch axis, no
        padding, outputs whole (the C predict ABI's path; its inputs need
        not share a leading dimension)."""
        arrs = []
        for i, n in enumerate(self.data_names):
            v = inputs[n] if isinstance(inputs, dict) else inputs[i]
            arrs.append(_np.asarray(v, self._host_dtype).reshape(
                self._declared_shapes[n]))
        outs = self._run(arrs, dict(self._declared_shapes))
        self.synchronize()
        return [NDArray(o, ctx=self.ctx) for o in outs]

    def set_params(self, arg_params, aux_params=None):
        """(Hot-)swap the parameter set; in-flight dispatches finish against
        the snapshot they captured."""
        self._infer.set_params(arg_params or {}, aux_params)
        self._extra_cache = {}

    # -- monitoring ----------------------------------------------------------
    def set_monitor_callback(self, callback, monitor_all=False):
        """``callback(name, NDArray)`` fires on each output of every
        dispatched batch, over the whole batch."""
        self._monitor = callback

    def install_monitor(self, mon):
        """Feed a `monitor.Monitor`'s statistics from the request path;
        whoever dispatches drives its tic/toc (the batcher: once a
        batch)."""
        self.set_monitor_callback(mon.stat_helper)
        return mon
