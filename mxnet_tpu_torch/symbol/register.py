"""Generate the ``sym.<Op>`` functions from the op registry
(counterpart of `mxnet_tpu/symbol/register.py`)."""
from __future__ import annotations

from ..ops.registry import _OPS
from .symbol import Symbol, create

__all__ = ["populate"]

# scalar attributes that may be passed positionally, per op (the JAX
# package's `ndarray/register.py` table)
_POS_PARAMS = {
    "one_hot": ("depth", "on_value", "off_value"),
    "clip": ("a_min", "a_max"),
    "expand_dims": ("axis",),
    "repeat": ("repeats", "axis"),
    "tile": ("reps",),
    "flip": ("axis",),
    "reverse": ("axis",),
    "smooth_l1": ("scalar",),
    "diag": ("k",),
    "swapaxes": ("dim1", "dim2"), "SwapAxis": ("dim1", "dim2"),
    "slice_axis": ("axis", "begin", "end"),
    "pick": ("axis",),
    "take": ("axis",),
    "reshape": ("shape",), "Reshape": ("shape",),
    "transpose": ("axes",),
    "squeeze": ("axis",),
    "stack": ("axis",),
    "softmax": ("axis",), "log_softmax": ("axis",),
    "broadcast_axis": ("axis", "size"),
    "argmax": ("axis",), "argmin": ("axis",),
    "_plus_scalar": ("scalar",), "_minus_scalar": ("scalar",),
    "_mul_scalar": ("scalar",), "_div_scalar": ("scalar",),
    "_power_scalar": ("scalar",),
}


def _make_fn(name):
    pos_params = _POS_PARAMS.get(name, ())

    def fn(*args, **kwargs):
        sym_name = kwargs.pop("name", None)
        inputs = []
        extra_pos = []
        for a in args:
            if isinstance(a, Symbol):
                inputs.append(a)
            elif isinstance(a, (list, tuple)) and a and \
                    isinstance(a[0], Symbol):
                inputs.extend(a)
            else:
                extra_pos.append(a)
        if len(extra_pos) > len(pos_params):
            raise TypeError("%s: too many positional attribute args (%d)"
                            % (name, len(extra_pos)))
        for pname, pval in zip(pos_params, extra_pos):
            kwargs.setdefault(pname, pval)
        attrs = {}
        for k, v in kwargs.items():
            if isinstance(v, Symbol):
                inputs.append(v)
            elif k == "attr" and isinstance(v, dict):
                attrs.setdefault("__attrs__", {}).update(v)
            else:
                attrs[k] = v
        return create(name, inputs, attrs, name=sym_name)

    fn.__name__ = name
    return fn


def populate(namespace):
    for name in list(_OPS):
        namespace.setdefault(name, _make_fn(name))
