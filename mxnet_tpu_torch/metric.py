"""Evaluation metrics.

Counterpart of `mxnet_tpu/metric.py` (reference `python/mxnet/metric.py`):
``EvalMetric``, ``CompositeEvalMetric``, ``Accuracy``, ``TopKAccuracy``,
``F1``, ``Perplexity``, ``MAE``, ``MSE``, ``RMSE``, ``CrossEntropy``,
``NegativeLogLikelihood``, ``PearsonCorrelation``, ``Loss``,
``CustomMetric``, ``np`` and ``create`` (which takes a name, a list, a
metric or a callable ``feval(label, pred)``). Metrics read labels and
predictions back to the host with ``asnumpy`` and sum in numpy, as in
the JAX package.
"""
from __future__ import annotations

import math

import numpy as _np

from .ndarray.ndarray import NDArray

__all__ = ["EvalMetric", "CompositeEvalMetric", "Accuracy", "TopKAccuracy",
           "F1", "Perplexity", "MAE", "MSE", "RMSE", "CrossEntropy",
           "NegativeLogLikelihood", "PearsonCorrelation", "Loss",
           "CustomMetric", "np", "create"]

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
    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = str(name)
        self.output_names = output_names
        self.label_names = label_names
        self._kwargs = kwargs
        self.reset()

    def get_config(self):
        """The metric's constructor arguments with its class, name and
        output and label names (reference ``EvalMetric.get_config``)."""
        config = self._kwargs.copy()
        config.update({"metric": self.__class__.__name__, "name": self.name,
                       "output_names": self.output_names,
                       "label_names": self.label_names})
        return config

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

    def get_metric(self, index):
        return self.metrics[index]

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
        super().__init__(name, output_names, label_names, axis=axis)
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
class TopKAccuracy(EvalMetric):
    """The share of samples whose label is among the ``top_k`` largest
    predictions (ties ordered as numpy's ``argsort`` orders them)."""

    def __init__(self, top_k=1, name="top_k_accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, top_k=top_k)
        self.top_k = top_k
        if self.top_k <= 1:
            raise ValueError("Please use Accuracy if top_k is no more "
                             "than 1")
        self.name += "_%d" % self.top_k

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds)
        for label, pred_label in zip(labels, preds):
            if len(pred_label.shape) > 2:
                raise ValueError("Predictions should be no more than 2 dims")
            pred_np = _np.argsort(pred_label.asnumpy().astype("float32"),
                                  axis=1)
            label_np = label.asnumpy().astype("int32")
            if pred_np.ndim == 1:
                self.sum_metric += (pred_np.flat == label_np.flat).sum()
            else:
                num_classes = pred_np.shape[1]
                for j in range(min(num_classes, self.top_k)):
                    self.sum_metric += (pred_np[:, num_classes - 1 - j].flat
                                        == label_np.flat).sum()
            self.num_inst += pred_np.shape[0]


def _f1(tp, fp, fn):
    prec = tp / max(tp + fp, 1e-12)
    rec = tp / max(tp + fn, 1e-12)
    return 2 * prec * rec / max(prec + rec, 1e-12)


@register
class F1(EvalMetric):
    """Binary F1 of the arg-max predictions against 0/1 labels:
    ``macro`` averages each update's F1, ``micro`` pools the counts."""

    def __init__(self, name="f1", output_names=None, label_names=None,
                 average="macro"):
        self.average = average
        super().__init__(name, output_names, label_names)

    def reset(self):
        self.tp = self.fp = self.fn = 0.0
        super().reset()

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            pred_np = pred.asnumpy()
            if pred_np.ndim > 1:
                pred_np = _np.argmax(pred_np, axis=1)
            pred_np = pred_np.astype("int32").reshape(-1)
            label_np = label.asnumpy().astype("int32").reshape(-1)
            tp = ((pred_np == 1) & (label_np == 1)).sum()
            fp = ((pred_np == 1) & (label_np == 0)).sum()
            fn = ((pred_np == 0) & (label_np == 1)).sum()
            self.tp += tp
            self.fp += fp
            self.fn += fn
            self.sum_metric += _f1(tp, fp, fn)
            self.num_inst += 1

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        if self.average == "macro":
            return (self.name, self.sum_metric / self.num_inst)
        return (self.name, _f1(self.tp, self.fp, self.fn))


@register
class Perplexity(EvalMetric):
    def __init__(self, ignore_label=None, axis=-1, name="perplexity",
                 output_names=None, label_names=None):
        super().__init__(name, output_names, label_names,
                         ignore_label=ignore_label)
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


def _columns(label, pred):
    """Label and prediction as numpy, a 1-D one as a column."""
    label_np, pred_np = label.asnumpy(), pred.asnumpy()
    if label_np.ndim == 1:
        label_np = label_np.reshape(label_np.shape[0], 1)
    if pred_np.ndim == 1:
        pred_np = pred_np.reshape(pred_np.shape[0], 1)
    return label_np, pred_np


class _Regression(EvalMetric):
    """A mean of ``_value(label, pred)`` over updates."""

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            self.sum_metric += self._value(*_columns(label, pred))
            self.num_inst += 1


@register
class MAE(_Regression):
    def __init__(self, name="mae", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    @staticmethod
    def _value(label, pred):
        return _np.abs(label - pred).mean()


@register
class MSE(_Regression):
    def __init__(self, name="mse", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    @staticmethod
    def _value(label, pred):
        return ((label - pred) ** 2.0).mean()


@register
class RMSE(_Regression):
    def __init__(self, name="rmse", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    @staticmethod
    def _value(label, pred):
        return _np.sqrt(((label - pred) ** 2.0).mean())


@register
class CrossEntropy(EvalMetric):
    def __init__(self, eps=1e-12, name="cross-entropy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, eps=eps)
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
class NegativeLogLikelihood(CrossEntropy):
    """``CrossEntropy`` under its own name."""

    def __init__(self, eps=1e-12, name="nll-loss", output_names=None,
                 label_names=None):
        super().__init__(eps, name, output_names, label_names)


@register
class PearsonCorrelation(EvalMetric):
    """The mean over updates of the Pearson correlation of predictions
    and labels."""

    def __init__(self, name="pearsonr", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            self.sum_metric += _np.corrcoef(pred.asnumpy().ravel(),
                                            label.asnumpy().ravel())[0, 1]
            self.num_inst += 1


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


@register
class CustomMetric(EvalMetric):
    """``feval(label, pred)`` on numpy arrays: a value added per update,
    or a (sum, count) pair. ``allow_extra_outputs`` pairs the lists
    without checking their lengths."""

    def __init__(self, feval, name=None, allow_extra_outputs=False,
                 output_names=None, label_names=None):
        if name is None:
            name = feval.__name__
            if "<" in name:
                name = "custom(%s)" % name
        super().__init__(name, output_names, label_names, feval=feval,
                         allow_extra_outputs=allow_extra_outputs)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        if not self._allow_extra_outputs:
            labels, preds = check_label_shapes(labels, preds)
        for pred, label in zip(preds, labels):
            reval = self._feval(label.asnumpy(), pred.asnumpy())
            if isinstance(reval, tuple):
                sum_metric, num_inst = reval
                self.sum_metric += sum_metric
                self.num_inst += num_inst
            else:
                self.sum_metric += reval
                self.num_inst += 1


def np(numpy_feval, name=None, allow_extra_outputs=False):
    """A ``CustomMetric`` over a function of numpy arrays, named after
    it."""
    def feval(label, pred):
        return numpy_feval(label, pred)
    feval.__name__ = numpy_feval.__name__
    return CustomMetric(feval, name, allow_extra_outputs)


def create(metric, *args, **kwargs):
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
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
            raise ValueError("Metric must be either callable or in the "
                             "registry: %s" % metric) from None
    raise TypeError("metric should be a string, a callable, a list or an "
                    "EvalMetric")


# the reference's aliases
_METRIC_REGISTRY["acc"] = Accuracy
_METRIC_REGISTRY["ce"] = CrossEntropy
_METRIC_REGISTRY["nll_loss"] = NegativeLogLikelihood
_METRIC_REGISTRY["top_k_accuracy"] = TopKAccuracy
_METRIC_REGISTRY["top_k_acc"] = TopKAccuracy
_METRIC_REGISTRY["pearsonr"] = PearsonCorrelation
