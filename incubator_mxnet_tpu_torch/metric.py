"""Evaluation metrics (reference `python/mxnet/metric.py`).

PyTorch port of `EvalMetric`, `CompositeEvalMetric`, `Accuracy`,
`TopKAccuracy`, `CrossEntropy`, `Perplexity`, `create` and the registry
from `incubator_mxnet_tpu/metric.py`.  The metrics count on
the device of the predictions: `device_update` gives a batch's (sum,
count) as tensors there (the JAX package's in-graph `device_update`),
`update` adds them to running totals on that device, and only `get`
copies the totals to the host, once.  A training step therefore never
waits for the device to update a metric; the fused train step
(`fused.FusedTrainStep`) calls `device_update` for each leaf metric.
"""
from __future__ import annotations

import math

import numpy
import torch

from .base import MXNetError
from .ndarray.ndarray import NDArray

__all__ = ["EvalMetric", "CompositeEvalMetric", "Accuracy", "TopKAccuracy",
           "CrossEntropy", "Perplexity", "create", "register",
           "check_label_shapes"]

_METRIC_REGISTRY = {}


def register(klass):
    _METRIC_REGISTRY[klass.__name__.lower()] = klass
    return klass


def alias(*aliases):
    def deco(klass):
        for a in aliases:
            _METRIC_REGISTRY[a.lower()] = klass
        return klass
    return deco


def create(metric, *args, **kwargs):
    """A metric from an instance, a name or a list of them (reference
    `metric.py create`)."""
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        composite = CompositeEvalMetric()
        for child in metric:
            composite.add(create(child, *args, **kwargs))
        return composite
    if isinstance(metric, str) and metric.lower() in _METRIC_REGISTRY:
        return _METRIC_REGISTRY[metric.lower()](*args, **kwargs)
    raise MXNetError(f"Metric must be an EvalMetric, a registered name or "
                     f"a list, got {metric!r}")


def _as_tensor(x, device=None):
    """An NDArray's tensor, a tensor, or a numpy array as a tensor, on
    `device` when given, outside the autograd graph."""
    if isinstance(x, NDArray):
        x = x.data.detach()
    elif not isinstance(x, torch.Tensor):
        x = torch.from_numpy(numpy.ascontiguousarray(x))
    return x if device is None else x.to(device, non_blocking=True)


def check_label_shapes(labels, preds):
    if isinstance(labels, NDArray):
        labels = [labels]
    if isinstance(preds, NDArray):
        preds = [preds]
    if len(labels) != len(preds):
        raise ValueError(f"Shape of labels {len(labels)} does not match "
                         f"shape of predictions {len(preds)}")
    return labels, preds


class EvalMetric:
    """Base metric: a running ``sum_metric`` over ``num_inst`` (reference
    `metric.py:EvalMetric`)."""

    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = str(name)
        self.output_names = output_names
        self.label_names = label_names
        self._kwargs = kwargs
        self.reset()

    def __str__(self):
        return f"EvalMetric: {dict(self.get_name_value())}"

    def update(self, labels, preds):
        raise NotImplementedError()

    # -- totals on the device ------------------------------------------------
    # Metrics with `device_update(labels, preds) -> (sum, count)` (tensors
    # on the predictions' device) keep their running totals there; `get`
    # adds them to sum_metric / num_inst with one copy to the host.
    _device_totals = None

    def _accumulate(self, dsum, dnum):
        dsum, dnum = dsum.double(), dnum.double()
        if self._device_totals is not None:
            tsum, tnum = self._device_totals
            dsum, dnum = tsum + dsum, tnum + dnum
        self._device_totals = (dsum, dnum)

    def _materialize(self):
        if self._device_totals is not None:
            hsum, hnum = torch.stack(self._device_totals).tolist()
            self.sum_metric += hsum
            self.num_inst += int(round(hnum))
            self._device_totals = None

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0
        self._device_totals = None

    def get(self):
        self._materialize()
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, self.sum_metric / self.num_inst)

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))


@register
@alias("composite")
class CompositeEvalMetric(EvalMetric):
    def __init__(self, metrics=None, name="composite", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)
        self.metrics = [create(m) for m in metrics] if metrics else []

    def add(self, metric):
        self.metrics.append(create(metric))

    def get_metric(self, index):
        return self.metrics[index]

    def update(self, labels, preds):
        for metric in self.metrics:
            metric.update(labels, preds)

    def reset(self):
        for metric in getattr(self, "metrics", ()):
            metric.reset()

    def get(self):
        names, values = [], []
        for metric in self.metrics:
            name, value = metric.get()
            names.extend(name if isinstance(name, list) else [name])
            values.extend(value if isinstance(value, list) else [value])
        return names, values


@register
@alias("acc")
class Accuracy(EvalMetric):
    """Share of rows whose argmax along `axis` equals the label
    (reference `metric.py:Accuracy`)."""

    def __init__(self, axis=1, name="accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, axis=axis)
        self.axis = axis

    def update(self, labels, preds):
        self._accumulate(*self.device_update(labels, preds))

    def device_update(self, labels, preds):
        """(rows whose argmax equals the label, rows) of one batch, as
        tensors on the predictions' device."""
        labels, preds = check_label_shapes(labels, preds)
        dsum = dnum = 0
        for label, pred_label in zip(labels, preds):
            pred = _as_tensor(pred_label)
            lab = _as_tensor(label, pred.device)
            if pred.ndim > 1 and pred.shape != lab.shape:
                pred = pred.argmax(dim=self.axis)
            lab = lab.to(torch.int32).reshape(-1)
            pred = pred.to(torch.int32).reshape(-1)
            dsum = dsum + (pred == lab).sum()
            dnum = dnum + pred.numel()
        return _pair(dsum, dnum)


@register
@alias("top_k_accuracy", "top_k_acc")
class TopKAccuracy(EvalMetric):
    """Share of rows whose label is among the `top_k` largest predictions
    (reference `metric.py:TopKAccuracy`)."""

    def __init__(self, top_k=1, name="top_k_accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, top_k=top_k)
        self.top_k = top_k
        assert self.top_k > 1, "Please use Accuracy if top_k is no more than 1"
        self.name += f"_{self.top_k}"

    def update(self, labels, preds):
        """The batch's counts added to the totals on the device; a 1-D
        prediction compares its argsort with the labels, as the
        reference's host update does."""
        labels, preds = check_label_shapes(labels, preds)
        dsum = dnum = 0
        for label, pred_label in zip(labels, preds):
            pred = _as_tensor(pred_label)
            if pred.ndim == 1:
                lab = _as_tensor(label, pred.device).to(torch.int32)
                order = torch.argsort(pred.float(), stable=True)
                s, n = (order.to(torch.int32) == lab.reshape(-1)).sum(), \
                    pred.shape[0]
            else:
                s, n = self.device_update([label], [pred_label])
            dsum, dnum = dsum + s, dnum + n
        self._accumulate(*_pair(dsum, dnum))

    def device_update(self, labels, preds):
        """(rows whose label is in the top k, rows) of one batch, as
        tensors on the predictions' device: a stable argsort in float32,
        as the JAX package's in-graph update sorts, so ties rank alike."""
        labels, preds = check_label_shapes(labels, preds)
        dsum = dnum = 0
        for label, pred_label in zip(labels, preds):
            pred = _as_tensor(pred_label)
            if pred.ndim != 2:
                raise ValueError(f"TopKAccuracy expects 2-D predictions, "
                                 f"got {tuple(pred.shape)}")
            top_k = min(pred.shape[1], self.top_k)
            top = torch.argsort(pred.float(), dim=1, stable=True)[:, -top_k:]
            lab = _as_tensor(label, pred.device).reshape(-1).to(torch.int64)
            dsum = dsum + (top == lab[:, None]).sum()
            dnum = dnum + pred.shape[0]
        return _pair(dsum, dnum)


@register
@alias("ce")
class CrossEntropy(EvalMetric):
    """Mean of -log(p[label] + eps) (reference `metric.py:CrossEntropy`)."""

    def __init__(self, eps=1e-12, name="cross-entropy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, eps=eps)
        self.eps = eps

    def update(self, labels, preds):
        self._accumulate(*self.device_update(labels, preds))

    def device_update(self, labels, preds):
        """(sum of -log(p[label] + eps), rows) of one batch, as tensors on
        the predictions' device; p in float32."""
        labels, preds = check_label_shapes(labels, preds)
        dsum = dnum = 0
        for label, pred in zip(labels, preds):
            pred = _as_tensor(pred)
            label = _as_tensor(label, pred.device).reshape(-1)
            if label.shape[0] != pred.shape[0]:
                raise MXNetError(f"CrossEntropy: {label.shape[0]} labels "
                                 f"for {pred.shape[0]} predictions")
            prob = pred.float()[torch.arange(label.shape[0],
                                             device=pred.device),
                                label.long()]
            dsum = dsum + (-torch.log(prob + self.eps)).sum(
                dtype=torch.float64)
            dnum = dnum + label.shape[0]
        return _pair(dsum, dnum)


@register
class Perplexity(EvalMetric):
    """exp of the mean of -log(max(p[label], 1e-10)) over the labels
    that are not `ignore_label` (reference `metric.py:Perplexity`)."""

    def __init__(self, ignore_label=None, axis=-1, name="perplexity",
                 output_names=None, label_names=None):
        super().__init__(name, output_names, label_names,
                         ignore_label=ignore_label, axis=axis)
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        self._accumulate(*self.device_update(labels, preds))

    def device_update(self, labels, preds):
        """(sum of -log(max(p[label], 1e-10)), labels counted) of one
        batch, as tensors on the predictions' device; p in float32, a
        prediction of more than 2 dims flattened to (-1, classes)."""
        labels, preds = check_label_shapes(labels, preds)
        dsum = dnum = 0
        for label, pred in zip(labels, preds):
            pred = _as_tensor(pred).float()
            if pred.ndim > 2:
                pred = pred.reshape(-1, pred.shape[-1])
            lab = _as_tensor(label, pred.device).reshape(-1).to(torch.int32)
            probs = pred.gather(1, lab.long()[:, None])[:, 0]
            if self.ignore_label is not None:
                ignore = lab == int(self.ignore_label)
                probs = torch.where(ignore, torch.ones_like(probs), probs)
                dnum = dnum - ignore.sum()
            dsum = dsum - torch.log(torch.clamp(probs, min=1e-10)).sum(
                dtype=torch.float64)
            dnum = dnum + lab.shape[0]
        return _pair(dsum, dnum)

    def get(self):
        self._materialize()
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, math.exp(self.sum_metric / self.num_inst))


def _pair(dsum, dnum):
    """(sum, count) as float64 tensors on the sum's device; a Python
    count is filled in there (no copy from the host)."""
    device = dsum.device if isinstance(dsum, torch.Tensor) else None

    def f64(v):
        if isinstance(v, torch.Tensor):
            return v.to(torch.float64)
        return torch.full((), float(v), dtype=torch.float64, device=device)
    return f64(dsum), f64(dnum)
