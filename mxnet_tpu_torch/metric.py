"""Evaluation metrics.

Counterpart of `mxnet_tpu/metric.py` (reference `python/mxnet/metric.py`),
cut to what the training slice uses: ``EvalMetric``,
``CompositeEvalMetric``, ``Accuracy``, ``Perplexity``, ``CrossEntropy``,
``Loss`` and ``create``. Metrics read labels and predictions back to the
host with ``asnumpy`` and sum in numpy, as in the JAX package.
"""
from __future__ import annotations

import math

import numpy as _np

from .ndarray.ndarray import NDArray

__all__ = ["EvalMetric", "CompositeEvalMetric", "Accuracy", "Perplexity",
           "CrossEntropy", "Loss", "create"]

_METRIC_REGISTRY = {}


def register(klass, *names):
    for n in (names or (klass.__name__.lower(),)):
        _METRIC_REGISTRY[n.lower()] = klass
    return klass


def check_label_shapes(labels, preds):
    if isinstance(labels, NDArray):
        labels = [labels]
    if isinstance(preds, NDArray):
        preds = [preds]
    if len(labels) != len(preds):
        raise ValueError("Shape of labels {} does not match shape of "
                         "predictions {}".format(len(labels), len(preds)))
    return labels, preds


class EvalMetric:
    def __init__(self, name, output_names=None, label_names=None):
        self.name = str(name)
        self.output_names = output_names
        self.label_names = label_names
        self.reset()

    def __str__(self):
        return "EvalMetric: {}".format(dict(self.get_name_value()))

    def update_dict(self, label, pred):
        if self.output_names is not None:
            pred = [pred[name] for name in self.output_names if name in pred]
        else:
            pred = list(pred.values())
        if self.label_names is not None:
            label = [label[name] for name in self.label_names
                     if name in label]
        else:
            label = list(label.values())
        self.update(label, pred)

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
class CompositeEvalMetric(EvalMetric):
    def __init__(self, metrics=None, name="composite", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)
        self.metrics = [create(i) for i in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric))

    def update_dict(self, labels, preds):
        for metric in self.metrics:
            metric.update_dict(labels, preds)

    def update(self, labels, preds):
        for metric in self.metrics:
            metric.update(labels, preds)

    def reset(self):
        for metric in getattr(self, "metrics", []):
            metric.reset()

    def get(self):
        names, values = [], []
        for metric in self.metrics:
            name, value = metric.get()
            names.extend(name if isinstance(name, list) else [name])
            values.extend(value if isinstance(value, list) else [value])
        return (names, values)


@register
class Accuracy(EvalMetric):
    def __init__(self, axis=1, name="accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)
        self.axis = axis

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds)
        for label, pred_label in zip(labels, preds):
            pred_np = pred_label.asnumpy()
            label_np = label.asnumpy()
            if pred_np.ndim > 1 and pred_np.shape[self.axis] > 1 \
                    and pred_np.ndim != label_np.ndim:
                pred_np = _np.argmax(pred_np, axis=self.axis)
            label_np = label_np.astype("int32")
            pred_np = pred_np.astype("int32")
            if pred_np.shape != label_np.shape:
                pred_np = pred_np.reshape(label_np.shape)
            self.sum_metric += (pred_np.flat == label_np.flat).sum()
            self.num_inst += len(pred_np.flat)


@register
class Perplexity(EvalMetric):
    def __init__(self, ignore_label=None, axis=-1, name="perplexity",
                 output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        if len(labels) != len(preds):
            raise ValueError("%d labels for %d predictions"
                             % (len(labels), len(preds)))
        loss = 0.0
        num = 0
        for label, pred in zip(labels, preds):
            label_np = label.asnumpy().astype("int32").reshape(-1)
            pred_np = pred.asnumpy()
            pred_np = pred_np.reshape(-1, pred_np.shape[-1])
            probs = pred_np[_np.arange(label_np.shape[0]), label_np]
            if self.ignore_label is not None:
                ignore = (label_np == self.ignore_label)
                probs = _np.where(ignore, 1.0, probs)
                num -= ignore.sum()
            loss -= _np.sum(_np.log(_np.maximum(1e-10, probs)))
            num += label_np.shape[0]
        self.sum_metric += loss
        self.num_inst += num

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, math.exp(self.sum_metric / self.num_inst))


@register
class CrossEntropy(EvalMetric):
    def __init__(self, eps=1e-12, name="cross-entropy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)
        self.eps = eps

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label_np = label.asnumpy().ravel()
            pred_np = pred.asnumpy()
            if label_np.shape[0] != pred_np.shape[0]:
                raise ValueError("%d labels for %d predictions"
                                 % (label_np.shape[0], pred_np.shape[0]))
            prob = pred_np[_np.arange(label_np.shape[0]),
                           _np.int64(label_np)]
            self.sum_metric += (-_np.log(prob + self.eps)).sum()
            self.num_inst += label_np.shape[0]


@register
class Loss(EvalMetric):
    """The mean of the outputs (for graphs whose head is a loss)."""

    def __init__(self, name="loss", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, _, preds):
        if isinstance(preds, NDArray):
            preds = [preds]
        for pred in preds:
            self.sum_metric += pred.asnumpy().sum()
            self.num_inst += pred.size


def create(metric, *args, **kwargs):
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        composite_metric = CompositeEvalMetric()
        for child_metric in metric:
            composite_metric.add(create(child_metric, *args, **kwargs))
        return composite_metric
    if isinstance(metric, str):
        try:
            return _METRIC_REGISTRY[metric.lower()](*args, **kwargs)
        except KeyError:
            raise ValueError("Metric must be in the registry: %s"
                             % metric) from None
    raise TypeError("metric should be a string, a list or an EvalMetric")


# the reference's aliases
_METRIC_REGISTRY["acc"] = Accuracy
_METRIC_REGISTRY["ce"] = CrossEntropy
