"""Evaluation metrics (reference `python/mxnet/metric.py`).

PyTorch port of `EvalMetric`, `CompositeEvalMetric`, `Accuracy`,
`CrossEntropy`, `create` and the registry from
`incubator_mxnet_tpu/metric.py`.  Metrics accumulate on the host from
numpy copies of the labels and outputs; the JAX package's in-graph
`device_update` belongs to its fused train step, which the port does not
have.
"""
from __future__ import annotations

import numpy

from .base import MXNetError
from .ndarray.ndarray import NDArray

__all__ = ["EvalMetric", "CompositeEvalMetric", "Accuracy", "CrossEntropy",
           "create", "register", "check_label_shapes"]

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


def _as_numpy(x):
    return x.asnumpy() if isinstance(x, NDArray) else numpy.asarray(x)


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

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def get(self):
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
        labels, preds = check_label_shapes(labels, preds)
        for label, pred_label in zip(labels, preds):
            pred = _as_numpy(pred_label)
            lab = _as_numpy(label)
            if pred.ndim > 1 and pred.shape != lab.shape:
                pred = pred.argmax(axis=self.axis)
            lab = lab.astype("int32").reshape(-1)
            pred = pred.astype("int32").reshape(-1)
            self.sum_metric += (pred == lab).sum()
            self.num_inst += len(pred)


@register
@alias("ce")
class CrossEntropy(EvalMetric):
    """Mean of -log(p[label] + eps) (reference `metric.py:CrossEntropy`)."""

    def __init__(self, eps=1e-12, name="cross-entropy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, eps=eps)
        self.eps = eps

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label = _as_numpy(label).ravel()
            pred = _as_numpy(pred)
            assert label.shape[0] == pred.shape[0]
            prob = pred[numpy.arange(label.shape[0]), numpy.int64(label)]
            self.sum_metric += (-numpy.log(prob + self.eps)).sum()
            self.num_inst += label.shape[0]
