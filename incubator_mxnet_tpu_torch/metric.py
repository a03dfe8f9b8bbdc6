"""Evaluation metrics (reference `python/mxnet/metric.py`).

PyTorch port of `incubator_mxnet_tpu/metric.py`: `EvalMetric`,
`CompositeEvalMetric`, `Accuracy`, `TopKAccuracy`, `F1`, `MCC`,
`Perplexity`, `MAE`, `MSE`, `RMSE`, `CrossEntropy`,
`NegativeLogLikelihood`, `PearsonCorrelation`, `Loss`, `Torch`,
`Caffe`, `CustomMetric`, `np`, `create` and the registry.

A metric that is a running (sum, count) has a `device_update(labels,
preds)` that gives one batch's (sum, count) as tensors on the
predictions' device; `_accumulate` adds them to totals that stay there,
and only `get` copies them to the host, once.  The fused train step
(`fused.FusedTrainStep`) calls it for each leaf metric, so a step never
waits for the device; a metric without one makes the step decline the
batch, which then takes the per-batch path.  Which path each takes:

* on the device, `update` too (``update`` is ``device_update`` added to
  the totals): Accuracy, TopKAccuracy, CrossEntropy, Perplexity, MAE,
  MSE, RMSE, NegativeLogLikelihood, PearsonCorrelation, Loss (Torch,
  Caffe).
* a host `update` and a `device_update` the fused step uses: F1 and MCC
  with ``average="macro"`` (one batch's confusion counts make its score;
  the host update also checks that the labels are binary, which the
  device path skips so as not to wait for the device).
* the host only: F1 and MCC with another average (their score comes
  from the counts of every batch so far, not a sum), CustomMetric and
  `np` (a Python function of numpy arrays).
"""
from __future__ import annotations

import math

import numpy
import torch

from .base import MXNetError
from .ndarray import sparse as _sparse
from .ndarray.ndarray import NDArray

__all__ = ["EvalMetric", "CompositeEvalMetric", "Accuracy", "TopKAccuracy",
           "F1", "MCC", "Perplexity", "MAE", "MSE", "RMSE", "CrossEntropy",
           "NegativeLogLikelihood", "PearsonCorrelation", "Loss", "Torch",
           "Caffe", "CustomMetric", "np", "create", "register",
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
    """A metric from an instance, a name, a function (a `CustomMetric`)
    or a list of them (reference `metric.py create`)."""
    if callable(metric) and not isinstance(metric, EvalMetric):
        return CustomMetric(metric, *args, **kwargs)
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
    `device` when given, outside the autograd graph (a sparse array
    densified there)."""
    if isinstance(x, _sparse.BaseSparseNDArray):
        return _sparse.dense_tensor(
            x, device if device is not None else x.context.torch_device)
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


def np(numpy_feval, name=None, allow_extra_outputs=False):
    """A `CustomMetric` over ``numpy_feval(label, pred)``."""
    def feval(label, pred):
        return numpy_feval(label, pred)
    feval.__name__ = name if name else numpy_feval.__name__
    return CustomMetric(feval, name, allow_extra_outputs)


def _as_numpy(x):
    if isinstance(x, NDArray):
        return x.asnumpy()
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return numpy.asarray(x)


def _rows(x, device):
    """A label or prediction as float32 (rows, -1) on `device`."""
    t = _as_tensor(x, device).float()
    return t.reshape(t.shape[0], -1)


# -- binary classification: F1 and MCC ----------------------------------------

class _BinaryClassificationMetrics:
    """Confusion counts of binary predictions (argmax of 2-D scores, or
    a 1-D probability above 0.5)."""

    def __init__(self):
        self.reset_stats()

    def reset_stats(self):
        self.true_positives = 0
        self.false_positives = 0
        self.true_negatives = 0
        self.false_negatives = 0

    def update_binary_stats(self, label, pred):
        pred = _as_numpy(pred)
        label = _as_numpy(label).astype("int32")
        pred_label = numpy.argmax(pred, axis=1) if pred.ndim > 1 else \
            (pred > 0.5).astype("int32")
        if len(numpy.unique(label)) > 2:
            raise ValueError("F1 currently only supports binary "
                             "classification.")
        lab = label.reshape(-1)
        self.true_positives += ((pred_label == 1) & (lab == 1)).sum()
        self.false_positives += ((pred_label == 1) & (lab == 0)).sum()
        self.false_negatives += ((pred_label == 0) & (lab == 1)).sum()
        self.true_negatives += ((pred_label == 0) & (lab == 0)).sum()

    @property
    def precision(self):
        tp_fp = self.true_positives + self.false_positives
        return self.true_positives / tp_fp if tp_fp else 0.0

    @property
    def recall(self):
        tp_fn = self.true_positives + self.false_negatives
        return self.true_positives / tp_fn if tp_fn else 0.0

    @property
    def fscore(self):
        if self.precision + self.recall > 0:
            return 2 * self.precision * self.recall / (self.precision +
                                                       self.recall)
        return 0.0

    @property
    def total_examples(self):
        return (self.false_negatives + self.false_positives +
                self.true_negatives + self.true_positives)


def _device_counts(labels, preds):
    """(tp, fp, fn, tn) of a batch as float64 tensors on the
    predictions' device."""
    tp = fp = fn = tn = 0
    for label, pred in zip(labels, preds):
        pred = _as_tensor(pred)
        lab = _as_tensor(label, pred.device).to(torch.int32).reshape(-1)
        p = pred.argmax(dim=1) if pred.ndim > 1 else (pred > 0.5)
        p = p.to(torch.int32).reshape(-1)
        tp = tp + ((p == 1) & (lab == 1)).sum(dtype=torch.float64)
        fp = fp + ((p == 1) & (lab == 0)).sum(dtype=torch.float64)
        fn = fn + ((p == 0) & (lab == 1)).sum(dtype=torch.float64)
        tn = tn + ((p == 0) & (lab == 0)).sum(dtype=torch.float64)
    return tp, fp, fn, tn


def _ratio(num, den):
    """num / den, 0 where den is 0."""
    return torch.where(den > 0, num / torch.where(den > 0, den, 1.0),
                       torch.zeros_like(den))


@register
class F1(EvalMetric):
    """Binary F1 (reference `metric.py:F1`): with ``average="macro"``
    the mean of the batches' scores, else the score of every batch's
    counts together."""

    def __init__(self, name="f1", output_names=None, label_names=None,
                 average="macro"):
        self.average = average
        self.metrics = _BinaryClassificationMetrics()
        super().__init__(name, output_names, label_names)
        if average != "macro":
            self.device_update = None

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            self.metrics.update_binary_stats(label, pred)
        if self.average == "macro":
            self.sum_metric += self.metrics.fscore
            self.num_inst += 1
            self.metrics.reset_stats()
        else:
            self.sum_metric = self.metrics.fscore * \
                self.metrics.total_examples
            self.num_inst = self.metrics.total_examples

    def device_update(self, labels, preds):
        """(the batch's F1, 1) on the predictions' device."""
        labels, preds = check_label_shapes(labels, preds)
        tp, fp, fn, _ = _device_counts(labels, preds)
        precision, recall = _ratio(tp, tp + fp), _ratio(tp, tp + fn)
        return _pair(_ratio(2 * precision * recall, precision + recall), 1)

    def reset(self):
        super().reset()
        if hasattr(self, "metrics"):
            self.metrics.reset_stats()


@register
class MCC(EvalMetric):
    """Matthews correlation coefficient (reference `metric.py:MCC`), the
    averages of `F1`."""

    def __init__(self, name="mcc", output_names=None, label_names=None,
                 average="macro"):
        self._average = average
        self._metrics = _BinaryClassificationMetrics()
        super().__init__(name, output_names, label_names)
        if average != "macro":
            self.device_update = None

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            self._metrics.update_binary_stats(label, pred)
        m = self._metrics
        terms = ((m.true_positives + m.false_positives) *
                 (m.true_positives + m.false_negatives) *
                 (m.true_negatives + m.false_positives) *
                 (m.true_negatives + m.false_negatives))
        denom = math.sqrt(terms) if terms else 1.0
        mcc = (m.true_positives * m.true_negatives -
               m.false_positives * m.false_negatives) / (denom or 1.0)
        if self._average == "macro":
            self.sum_metric += mcc
            self.num_inst += 1
            self._metrics.reset_stats()
        else:
            self.sum_metric = mcc * m.total_examples
            self.num_inst = m.total_examples

    def device_update(self, labels, preds):
        """(the batch's MCC, 1) on the predictions' device."""
        labels, preds = check_label_shapes(labels, preds)
        tp, fp, fn, tn = _device_counts(labels, preds)
        terms = (tp + fp) * (tp + fn) * (tn + fp) * (tn + fn)
        denom = torch.where(terms > 0, torch.sqrt(terms),
                            torch.ones_like(terms))
        return _pair((tp * tn - fp * fn) / denom, 1)

    def reset(self):
        super().reset()
        if hasattr(self, "_metrics"):
            self._metrics.reset_stats()


# -- regression ----------------------------------------------------------------

def _device_batches(labels, preds, per_pair):
    """(sum of ``per_pair(label, pred)``, pairs) over float32 (rows, -1)
    tensors on the predictions' device."""
    labels, preds = check_label_shapes(labels, preds)
    dsum = dnum = 0
    for label, pred in zip(labels, preds):
        p = _rows(pred, None)
        dsum = dsum + per_pair(_rows(label, p.device), p).double()
        dnum = dnum + 1
    return _pair(dsum, dnum)


@register
class MAE(EvalMetric):
    """Mean absolute error, averaged over batches."""

    def __init__(self, name="mae", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        self._accumulate(*self.device_update(labels, preds))

    def device_update(self, labels, preds):
        return _device_batches(labels, preds,
                               lambda y, p: (y - p).abs().mean())


@register
class MSE(EvalMetric):
    """Mean squared error, averaged over batches."""

    def __init__(self, name="mse", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        self._accumulate(*self.device_update(labels, preds))

    def device_update(self, labels, preds):
        return _device_batches(labels, preds,
                               lambda y, p: ((y - p) ** 2.0).mean())


@register
class RMSE(EvalMetric):
    """Root mean squared error, averaged over batches."""

    def __init__(self, name="rmse", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        self._accumulate(*self.device_update(labels, preds))

    def device_update(self, labels, preds):
        return _device_batches(
            labels, preds, lambda y, p: torch.sqrt(((y - p) ** 2.0).mean()))


@register
@alias("nll_loss")
class NegativeLogLikelihood(EvalMetric):
    """Mean of -log(p[label] + eps) over the rows."""

    def __init__(self, eps=1e-12, name="nll-loss", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, eps=eps)
        self.eps = eps

    def update(self, labels, preds):
        self._accumulate(*self.device_update(labels, preds))

    def device_update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds)
        dsum = dnum = 0
        for label, pred in zip(labels, preds):
            pred = _as_tensor(pred).float()
            lab = _as_tensor(label, pred.device).reshape(-1).long()
            if lab.shape[0] != pred.shape[0]:
                raise MXNetError(f"NegativeLogLikelihood: {lab.shape[0]} "
                                 f"labels for {pred.shape[0]} predictions")
            prob = pred.gather(1, lab[:, None])[:, 0]
            dsum = dsum + (-torch.log(prob + self.eps)).sum(
                dtype=torch.float64)
            dnum = dnum + pred.shape[0]
        return _pair(dsum, dnum)


@register
@alias("pearsonr")
class PearsonCorrelation(EvalMetric):
    """Pearson's r of predictions and labels, averaged over batches."""

    def __init__(self, name="pearsonr", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        self._accumulate(*self.device_update(labels, preds))

    def device_update(self, labels, preds):
        """r in float64 on the predictions' device."""
        def r(y, p):
            y, p = y.reshape(-1).double(), p.reshape(-1).double()
            y, p = y - y.mean(), p - p.mean()
            return (p * y).sum() / torch.sqrt((p * p).sum() * (y * y).sum())
        return _device_batches(labels, preds, r)


@register
class Loss(EvalMetric):
    """Mean of a loss output's elements (reference `metric.py:Loss`)."""

    def __init__(self, name="loss", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        self._accumulate(*self.device_update(labels, preds))

    def device_update(self, labels, preds):
        if isinstance(preds, NDArray):
            preds = [preds]
        dsum = dnum = 0
        for pred in preds:
            pred = _as_tensor(pred)
            dsum = dsum + pred.float().sum(dtype=torch.float64)
            dnum = dnum + pred.numel()
        return _pair(dsum, dnum)


@register
class Torch(Loss):
    def __init__(self, name="torch", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)


@register
class Caffe(Loss):
    def __init__(self, name="caffe", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)


@register
class CustomMetric(EvalMetric):
    """``feval(label, pred)`` on numpy arrays, a value or a (sum, count)
    per pair (reference `metric.py:CustomMetric`); host only."""

    def __init__(self, feval, name=None, allow_extra_outputs=False,
                 output_names=None, label_names=None):
        if name is None:
            name = feval.__name__
            if name.find("<") != -1:
                name = f"custom({name})"
        super().__init__(name, output_names, label_names, feval=feval,
                         allow_extra_outputs=allow_extra_outputs)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        if not self._allow_extra_outputs:
            labels, preds = check_label_shapes(labels, preds)
        for pred, label in zip(preds, labels):
            reval = self._feval(_as_numpy(label), _as_numpy(pred))
            if isinstance(reval, tuple):
                sum_metric, num_inst = reval
                self.sum_metric += sum_metric
                self.num_inst += num_inst
            else:
                self.sum_metric += reval
                self.num_inst += 1
