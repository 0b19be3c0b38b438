"""Gluon losses.

Counterpart of `mxnet_tpu/gluon/loss.py` (reference
`python/mxnet/gluon/loss.py`): ``L2Loss``, ``L1Loss``,
``SigmoidBinaryCrossEntropyLoss``, ``SoftmaxCrossEntropyLoss``,
``KLDivLoss``, ``CTCLoss``, ``HuberLoss``, ``HingeLoss``,
``SquaredHingeLoss``, ``LogisticLoss`` and ``TripletLoss``, each a
``HybridBlock`` with ``weight``, ``sample_weight`` and ``batch_axis``,
computed in the data dtype by the registered ops (so a call under
``autograd.record()`` is on the tape). Each returns one loss per
sample: the mean over every axis but the batch axis (``CTCLoss``: the
sequence's loss).
"""
from __future__ import annotations

from ..base import MXNetError
from .block import HybridBlock

__all__ = ["Loss", "L2Loss", "L1Loss", "SigmoidBinaryCrossEntropyLoss",
           "SigmoidBCELoss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss",
           "KLDivLoss", "CTCLoss", "HuberLoss", "HingeLoss",
           "SquaredHingeLoss", "LogisticLoss", "TripletLoss"]


def _apply_weighting(F, loss, weight=None, sample_weight=None):
    if sample_weight is not None:
        loss = F.broadcast_mul(loss, sample_weight)
    if weight is not None:
        if not isinstance(weight, (float, int)):
            raise MXNetError("weight must be a number")
        loss = loss * weight
    return loss


class Loss(HybridBlock):
    def __init__(self, weight, batch_axis, **kwargs):
        super().__init__(**kwargs)
        self._weight = weight
        self._batch_axis = batch_axis

    def __repr__(self):
        return "%s(batch_axis=%s, w=%s)" % (type(self).__name__,
                                            self._batch_axis, self._weight)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError

    def _per_sample(self, F, loss, sample_weight, weight=None):
        loss = _apply_weighting(F, loss, self._weight if weight is None
                                else weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class L2Loss(Loss):
    """``weight / 2 * (pred - label)^2``."""

    def __init__(self, weight=1.0, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = F.reshape_like(label, pred)
        return self._per_sample(F, F.square(pred - label), sample_weight,
                                self._weight / 2)


class L1Loss(Loss):
    """``|pred - label|``."""

    def __init__(self, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = F.reshape_like(label, pred)
        return self._per_sample(F, F.abs(pred - label), sample_weight)


class SigmoidBinaryCrossEntropyLoss(Loss):
    """Binary cross-entropy of ``sigmoid(pred)`` (the stable log-sum-exp
    form), or of ``pred`` itself with ``from_sigmoid``."""

    def __init__(self, from_sigmoid=False, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_sigmoid = from_sigmoid

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = F.reshape_like(label, pred)
        if not self._from_sigmoid:
            loss = F.relu(pred) - pred * label + \
                F.Activation(-F.abs(pred), act_type="softrelu")
        else:
            loss = -(F.log(pred + 1e-12) * label +
                     F.log(1. - pred + 1e-12) * (1. - label))
        return self._per_sample(F, loss, sample_weight)


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


class SoftmaxCrossEntropyLoss(Loss):
    """``-log_softmax(pred)`` at the label (``sparse_label``) or summed
    against a label distribution; ``from_logits``: ``pred`` already
    holds log-probabilities."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = F.log_softmax(pred, axis=self._axis)
        if self._sparse_label:
            loss = -F.pick(pred, label, axis=self._axis, keepdims=True)
        else:
            label = F.reshape_like(label, pred)
            loss = -F.sum(pred * label, axis=self._axis, keepdims=True)
        return self._per_sample(F, loss, sample_weight)


SoftmaxCELoss = SoftmaxCrossEntropyLoss


class KLDivLoss(Loss):
    """``label * (log(label) - pred)``, ``pred`` log-probabilities
    (``from_logits``) or logits."""

    def __init__(self, from_logits=True, axis=-1, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._axis = axis

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = F.log_softmax(pred, axis=self._axis)
        loss = label * (F.log(label + 1e-12) - pred)
        return self._per_sample(F, loss, sample_weight)


class CTCLoss(Loss):
    """Connectionist temporal classification loss over ``pred`` in
    ``layout`` (``NTC`` or ``TNC``; scores before the softmax) and
    ``label`` in ``label_layout`` (``NT`` or ``TN``), padded with -1: the
    blank is the last class. ``pred_lengths`` and ``label_lengths`` are
    optional per-sample lengths."""

    def __init__(self, layout="NTC", label_layout="NT", weight=None,
                 **kwargs):
        if layout not in ("NTC", "TNC"):
            raise ValueError("Only 'NTC' and 'TNC' layouts for pred are "
                             "supported. Got: %s" % layout)
        if label_layout not in ("NT", "TN"):
            raise ValueError("Only 'NT' and 'TN' layouts for label are "
                             "supported. Got: %s" % label_layout)
        self._layout = layout
        self._label_layout = label_layout
        super().__init__(weight, label_layout.find("N"), **kwargs)

    def hybrid_forward(self, F, pred, label, pred_lengths=None,
                       label_lengths=None, sample_weight=None):
        if self._layout == "NTC":
            pred = F.swapaxes(pred, dim1=0, dim2=1)
        if self._batch_axis == 1:
            label = F.swapaxes(label, dim1=0, dim2=1)
        extra = []
        kwargs = {"blank_label": "last"}
        if pred_lengths is not None:
            extra.append(pred_lengths)
            kwargs["use_data_lengths"] = True
        if label_lengths is not None:
            extra.append(label_lengths)
            kwargs["use_label_lengths"] = True
        loss = F.CTCLoss(pred, label, *extra, **kwargs)
        return _apply_weighting(F, loss, self._weight, sample_weight)


class HuberLoss(Loss):
    """``|d| - rho/2`` where ``|d| > rho``, else ``d^2 / (2 rho)``, for
    ``d = pred - label``."""

    def __init__(self, rho=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._rho = rho

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = F.reshape_like(label, pred)
        loss = F.abs(pred - label)
        loss = F.where(loss > self._rho, loss - 0.5 * self._rho,
                       (0.5 / self._rho) * F.square(loss))
        return self._per_sample(F, loss, sample_weight)


class HingeLoss(Loss):
    """``relu(margin - pred * label)``."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = F.reshape_like(label, pred)
        loss = F.relu(self._margin - pred * label)
        return self._per_sample(F, loss, sample_weight)


class SquaredHingeLoss(Loss):
    """``relu(margin - pred * label)^2``."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = F.reshape_like(label, pred)
        loss = F.square(F.relu(self._margin - pred * label))
        return self._per_sample(F, loss, sample_weight)


class LogisticLoss(Loss):
    """Logistic loss of ``pred`` against labels in {-1, 1} (``signed``)
    or {0, 1} (``binary``)."""

    def __init__(self, weight=None, batch_axis=0, label_format="signed",
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._label_format = label_format
        if self._label_format not in ["signed", "binary"]:
            raise ValueError("label_format can only be signed or binary, "
                             "recieved %s." % label_format)

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = F.reshape_like(label, pred)
        if self._label_format == "signed":
            label = (label + 1.0) / 2.0
        loss = F.relu(pred) - pred * label + \
            F.Activation(-F.abs(pred), act_type="softrelu")
        return self._per_sample(F, loss, sample_weight)


class TripletLoss(Loss):
    """``relu(sum(|pred - positive|^2 - |pred - negative|^2) + margin)``
    over every axis but the batch axis."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, positive, negative,
                       sample_weight=None):
        positive = F.reshape_like(positive, pred)
        negative = F.reshape_like(negative, pred)
        loss = F.sum(F.square(pred - positive) - F.square(pred - negative),
                     axis=self._batch_axis, exclude=True)
        loss = F.relu(loss + self._margin)
        return _apply_weighting(F, loss, self._weight, sample_weight)
