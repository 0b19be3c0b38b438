"""Every op of the ``nd`` core, as one table of cases.

The table is the one list of op cases: ``chip_smoke.py`` (phase 20) and
``tests/test_torch_cuda.py`` run each case on ``gpu(0)`` and on
``cpu()`` and hold the two to the case's family's limit, and the CPU
parity tests (``tests/test_torch_{elemwise,shape_ops,init_reduce_nn}.py``)
run each case through the JAX package's op beside the port's. The cases
cover every op of `ops/elemwise.py`, `ops/init_ops.py`,
`ops/shape_ops.py` and `ops/reduce.py` (aliases included; those that
were ported before this module too) and ``Dropout`` (outside training),
``LeakyReLU`` (its five act types, outside training),
``SoftmaxActivation`` and ``softmax_cross_entropy``. Inputs are made
with numpy, seeded from the op's name, inside each op's domain, with
distinct values where an op orders or compares. A case's family says
how the two devices are held: ``exact`` ops (shape, index, sort,
compare, rounding, copies, max/min) must agree bit for bit; the others
(``arith``, ``transcendental``, ``reduction``, ``product``) by the
largest absolute difference over the largest magnitude of the
reference, at most the family's entry in ``LIMITS`` (f32; products with
TF32 off). Float cases also run in bf16, held to ``BF16_LIMIT``.
``control`` feeds a family's cases inputs rounded to bf16 on the card
only, a kernel that lost f32 precision, and must exceed the family's
limit.
"""
from __future__ import annotations

import zlib

import numpy as np
import torch

from ..context import cpu
from ..ops.registry import get_op

__all__ = ["CASES", "LIMITS", "BF16_LIMIT", "Case", "limit", "run_case",
           "reading", "compare", "sweep", "control"]

# the largest difference over the reference's largest magnitude, per
# family. On an H100 against the CPU (PERF.md, section 2) the f32 families
# read at most 8.9e-8 (arith), 1.7e-7 (transcendental), 1.9e-7
# (reduction) and 7.9e-8 (product, TF32 off), their controls 2.9e-3 to
# 1.0e-2; bf16 at most 2.4e-3
LIMITS = {"exact": 0.0, "arith": 1e-6, "transcendental": 1e-6,
          "reduction": 1e-6, "product": 1e-6}
BF16_LIMIT = 2.0 ** -7


class Case:
    """One op call: ``name``, ``params``, numpy ``arrays``, ``family``,
    and whether it also runs in bf16 (its float inputs cast)."""

    def __init__(self, name, params, arrays, family, bf16=False):
        self.name, self.params, self.arrays = name, params, arrays
        self.family, self.bf16 = family, bf16

    def __repr__(self):
        return "Case(%s, %s)" % (self.name, self.params)


def _rng(tag):
    """A generator seeded from ``tag`` (the same in every process)."""
    return np.random.RandomState(zlib.crc32(tag.encode()))


def _domain(kind, tag, shape=(4, 6)):
    """f32 values inside an op's domain."""
    rng = _rng(kind + tag)
    u = rng.uniform(0.0, 1.0, shape)
    return {
        "any": rng.randn(*shape) * 2.0,
        "pos": u * 3.0 + 0.2,
        "unit": u * 1.8 - 0.9,
        "ge1": u * 3.0 + 1.05,
        "nonzero": np.sign(rng.randn(*shape)) * (u * 2.0 + 0.3),
        "gamma": u * 4.0 + 0.3,
        "small": rng.randn(*shape) * 0.5,
    }[kind].astype(np.float32)


def _distinct(*shape, seed=0):
    """Distinct f32 values (a shuffled range, scaled), so that orderings
    have no ties, in bf16 too."""
    n = int(np.prod(shape))
    return (np.random.RandomState(seed).permutation(n).reshape(shape)
            * 0.37 - n * 0.1).astype(np.float32)


def _ints(values):
    return np.asarray(values, dtype=np.float32)


_EXACT_UNARY = ("abs", "sign", "rint", "round", "ceil", "floor", "trunc",
                "fix", "relu", "negative", "_np_negative", "logical_not",
                "_copy", "identity", "zeros_like", "ones_like", "BlockGrad",
                "stop_gradient", "make_loss", "MakeLoss")
_ARITH_UNARY = {"square": "any", "reciprocal": "nonzero",
                "degrees": "any", "radians": "any"}
_TRANSCENDENTAL_UNARY = {
    "sqrt": "pos", "rsqrt": "pos", "cbrt": "nonzero", "rcbrt": "nonzero",
    "exp": "any", "log": "pos", "log10": "pos", "log2": "pos",
    "log1p": "pos", "expm1": "any", "sin": "any", "cos": "any",
    "tan": "small", "arcsin": "unit", "arccos": "unit", "arctan": "any",
    "sinh": "any", "cosh": "any", "tanh": "any", "arcsinh": "any",
    "arccosh": "ge1", "arctanh": "unit", "sigmoid": "any",
    "softsign": "any", "erf": "any", "erfinv": "unit", "gamma": "gamma",
    "gammaln": "gamma"}
_COMPARE = ("equal", "not_equal", "greater", "greater_equal", "lesser",
            "lesser_equal")
_ARITH_BINARY = {
    "broadcast_add": "any", "broadcast_plus": "any", "elemwise_add": "any",
    "_add": "any", "_plus": "any", "broadcast_sub": "any",
    "broadcast_minus": "any", "elemwise_sub": "any", "_sub": "any",
    "_minus": "any", "broadcast_mul": "any", "elemwise_mul": "any",
    "_mul": "any", "broadcast_div": "nonzero", "elemwise_div": "nonzero",
    "_div": "nonzero", "broadcast_mod": "nonzero", "_mod": "nonzero",
    "broadcast_hypot": "any", "_hypot": "any", "ldexp": "small",
    "_ldexp": "small"}
_EXACT_BINARY = ("broadcast_maximum", "_maximum", "maximum",
                 "broadcast_minimum", "_minimum", "minimum",
                 "broadcast_logical_and", "broadcast_logical_or",
                 "broadcast_logical_xor")
_TRANSCENDENTAL_BINARY = {"broadcast_power": "pos", "_power": "pos",
                          "pow": "pos", "arctan2": "any", "_arctan2": "any"}
# name -> (family, domain of the array, the scalar); the array holds the
# scalar once, a tie
_SCALARS = {
    "_plus_scalar": ("arith", "any", 1.5),
    "_scatter_plus_scalar": ("arith", "any", 2.0),
    "_minus_scalar": ("arith", "any", 1.5),
    "_rminus_scalar": ("arith", "any", 1.5),
    "_mul_scalar": ("arith", "any", -2.5),
    "_div_scalar": ("arith", "any", 3.0),
    "_rdiv_scalar": ("arith", "nonzero", 3.0),
    "_mod_scalar": ("arith", "any", 1.25),
    "_rmod_scalar": ("arith", "nonzero", 2.5),
    "_hypot_scalar": ("arith", "any", 1.5),
    "_power_scalar": ("transcendental", "pos", 1.7),
    "_rpower_scalar": ("transcendental", "any", 1.3),
    "_maximum_scalar": ("exact", "any", 0.2),
    "_minimum_scalar": ("exact", "any", 0.2),
    "_logical_and_scalar": ("exact", "any", 1.0),
    "_logical_or_scalar": ("exact", "any", 0.0)}


def _with_tie(a, scalar):
    a = a.copy()
    a[0, 0] = scalar
    return a


def _elemwise_cases():
    cases = [Case(n, {}, [_domain("any", n)], "exact", True)
             for n in _EXACT_UNARY]
    for table, family in ((_ARITH_UNARY, "arith"),
                          (_TRANSCENDENTAL_UNARY, "transcendental")):
        cases += [Case(n, {}, [_domain(k, n)], family, True)
                  for n, k in table.items()]
    for n in _COMPARE:
        a, b = _domain("any", n), _domain("any", n + "b")
        b[0] = a[0]
        cases += [Case("broadcast_" + n, {}, [a, b], "exact", True),
                  Case("_" + n, {}, [a, b], "exact", True),
                  Case("_%s_scalar" % n, {"scalar": float(a[1, 2])}, [a],
                       "exact", True)]
    for table, family in ((_ARITH_BINARY, "arith"),
                          (_TRANSCENDENTAL_BINARY, "transcendental")):
        cases += [Case(n, {}, [_domain("pos" if family == "transcendental"
                                       else "any", n), _domain(k, n + "b")],
                       family, True) for n, k in table.items()]
    cases += [Case(n, {}, [_domain("any", n), _domain("any", n + "b")],
                   "exact", True) for n in _EXACT_BINARY]
    cases += [Case(n, {"scalar": s}, [_with_tie(_domain(k, n), s)], fam,
                   True) for n, (fam, k, s) in _SCALARS.items()]
    x = _domain("any", "other")
    cases += [
        Case("broadcast_add", {}, [_domain("any", "bc", (3, 1, 4)),
                                   _domain("any", "bcb", (1, 5, 4))],
             "arith", True),
        Case("broadcast_power", {}, [_domain("pos", "bp", (2, 3)),
                                     _domain("any", "bpb", (1, 3))],
             "transcendental", True),
        Case("Cast", {"dtype": "int32"}, [x], "exact"),
        Case("cast", {"dtype": "float16"}, [x], "exact"),
        Case("clip", {"a_min": -0.5, "a_max": 0.7}, [x], "exact", True),
        Case("smooth_l1", {"scalar": 1.5}, [x], "arith", True),
        Case("where", {}, [(x > 0).astype(np.float32), x, -x], "exact",
             True),
        Case("where", {}, [(x[:, 0] > 0).astype(np.float32), x, -x],
             "exact", True)]
    cases += [Case(n, {}, [x, _domain("any", n), x * 0.5], "arith", True)
              for n in ("add_n", "ElementWiseSum", "_sum")]
    return cases


def _init_cases():
    return [Case(n, p, [], "arith" if "linspace" in n else "exact")
            for n, p in (
                ("_zeros", {"shape": (2, 3)}),
                ("zeros", {"shape": 4, "dtype": "int32"}),
                ("_ones", {"shape": (2, 3)}),
                ("ones", {"shape": (3,), "dtype": "int32"}),
                ("_full", {"shape": (2, 2), "value": 2.5}),
                ("full", {"shape": (3,), "value": 7, "dtype": "int32"}),
                ("_arange", {"start": 1, "stop": 9, "step": 2.0}),
                ("arange", {"start": 0, "stop": 2, "step": 0.25,
                            "repeat": 3}),
                ("arange", {"start": -3, "stop": 4, "step": 1,
                            "dtype": "int32"}),
                ("_eye", {"N": 3}),
                ("eye", {"N": 3, "M": 5, "k": 1}),
                ("eye", {"N": 4, "M": 3, "k": -2, "dtype": "int32"}),
                ("_linspace", {"start": 0.0, "stop": 1.0, "num": 5}),
                ("linspace", {"start": -2.0, "stop": 3.0, "num": 4,
                              "endpoint": False}))]


def _shape_cases():
    d = _distinct
    pad = (0, 0, 0, 0, 1, 2, 2, 1)
    nd_idx = _ints([[0, 2, 1, 2, 0, 1], [3, 0, 1, 2, 2, 0]])
    exact = [
        ("Reshape", {"shape": (-1, 4)}, [d(2, 3, 4)]),
        ("reshape", {"shape": (0, -3)}, [d(2, 3, 4)]),
        ("reshape_like", {}, [d(2, 3, 4), d(6, 4)]),
        ("Flatten", {}, [d(2, 3, 4)]),
        ("flatten", {}, [d(2, 3, 4)]),
        ("transpose", {"axes": (1, 0, 2)}, [d(2, 3, 4)]),
        ("SwapAxis", {"dim1": 0, "dim2": 2}, [d(2, 3, 4)]),
        ("swapaxes", {"dim1": 1, "dim2": 2}, [d(2, 3, 4)]),
        ("expand_dims", {"axis": 1}, [d(2, 3)]),
        ("expand_dims", {"axis": -1}, [d(2, 3)]),
        ("squeeze", {"axis": None}, [d(2, 1, 3, 1)]),
        ("squeeze", {"axis": 1}, [d(2, 1, 3, 1)]),
        ("broadcast_to", {"shape": (2, 0, 4)}, [d(1, 3, 1)]),
        ("broadcast_like", {}, [d(1, 3, 1), d(2, 3, 4)]),
        ("broadcast_axis", {"axis": (0, 2), "size": (2, 4)}, [d(1, 3, 1)]),
        ("broadcast_axes", {"axis": 0, "size": 3}, [d(1, 4)]),
        ("tile", {"reps": (2, 1, 3)}, [d(2, 3)]),
        ("repeat", {"repeats": 2, "axis": 1}, [d(2, 3)]),
        ("repeat", {"repeats": 3, "axis": None}, [d(2, 3)]),
        ("Pad", {"mode": "constant", "pad_width": pad,
                 "constant_value": 0.5}, [d(2, 3, 4, 5)]),
        ("pad", {"mode": "edge", "pad_width": pad}, [d(2, 3, 4, 5)]),
        ("pad", {"mode": "reflect", "pad_width": (0, 0, 0, 0, 2, 1, 1, 3)},
         [d(2, 3, 4, 5)]),
        ("slice", {"begin": (0, 1, None), "end": (2, 3, None)},
         [d(3, 4, 5)]),
        ("slice", {"begin": (1, None, 3), "end": (None, None, 0),
                   "step": (None, 2, -1)}, [d(3, 4, 5)]),
        ("crop", {"begin": (0, 1), "end": (2, 4)}, [d(3, 5)]),
        ("slice_axis", {"axis": 1, "begin": 1, "end": 3}, [d(2, 4, 3)]),
        ("slice_axis", {"axis": -1, "begin": -3, "end": None}, [d(2, 5)]),
        ("slice_like", {"axes": (0, 1)}, [d(4, 5, 6), d(2, 3, 6)]),
        ("slice_like", {}, [d(4, 5), d(2, 3)]),
        ("SliceChannel", {"num_outputs": 3, "axis": 1}, [d(2, 6, 4)]),
        ("split", {"num_outputs": 3, "axis": 1, "squeeze_axis": True},
         [d(2, 3, 4)]),
        ("Concat", {"dim": 1}, [d(2, 3), d(2, 1, seed=1), d(2, 4, seed=2)]),
        ("concat", {"dim": 0}, [d(2, 3), d(1, 3, seed=1)]),
        ("stack", {"axis": 1}, [d(2, 3), d(2, 3, seed=1)]),
        ("flip", {"axis": 1}, [d(2, 3, 4)]),
        ("reverse", {"axis": (0, 2)}, [d(2, 3, 4)]),
        ("depth_to_space", {"block_size": 2}, [d(1, 8, 2, 3)]),
        ("space_to_depth", {"block_size": 2}, [d(1, 2, 4, 6)]),
        ("diag", {"k": 1}, [d(4)]),
        ("diag", {"k": -1}, [d(4, 5)]),
        ("diag", {"k": 0, "axis1": 1, "axis2": 2}, [d(2, 3, 4)]),
        ("shape_array", {}, [d(2, 3, 4)]),
        ("size_array", {}, [d(2, 3, 4)]),
        ("take", {}, [d(5, 4), _ints([[0, 4], [2, 7]])]),
        ("take", {"axis": 1, "mode": "wrap"}, [d(3, 4), _ints([1, 5, -1])]),
        ("batch_take", {}, [d(4, 5), _ints([0, 3, 4, 1])]),
        ("pick", {"axis": 1}, [d(4, 5), _ints([0, 3, 4, 1])]),
        ("Embedding", {"input_dim": 6, "output_dim": 3},
         [_ints([[0, 5], [2, 3]]), d(6, 3)]),
        ("one_hot", {"depth": 4, "on_value": 2.0, "off_value": -1.0},
         [_ints([1, 0, 3, 5])]),
        ("gather_nd", {}, [d(3, 4, 5), nd_idx]),
        ("scatter_nd", {"shape": (3, 4)}, [d(6), nd_idx]),
        ("_scatter_set_nd", {}, [d(3, 4), d(4, seed=1),
                                 _ints([[0, 2, 1, 2], [3, 0, 1, 2]])]),
        ("sort", {}, [d(3, 5)]),
        ("sort", {"axis": 0, "is_ascend": False}, [d(3, 5)]),
        ("argsort", {}, [d(3, 5)]),
        ("argsort", {"axis": 0, "is_ascend": False, "dtype": "int32"},
         [d(3, 5)]),
        ("topk", {"k": 2}, [d(3, 5)]),
        ("topk", {"k": 3, "ret_typ": "value", "is_ascend": True},
         [d(3, 5)]),
        ("topk", {"k": 2, "ret_typ": "both", "axis": 0}, [d(3, 5)]),
        ("topk", {"k": 2, "ret_typ": "mask"}, [d(3, 5)]),
        ("argmax", {}, [d(3, 5)]),
        ("argmax", {"axis": 1, "keepdims": True}, [d(3, 5)]),
        ("argmin", {"axis": 0}, [d(3, 5)]),
        ("argmax_channel", {}, [d(3, 5, 2)]),
    ]
    for name in ("SequenceMask", "SequenceLast", "SequenceReverse"):
        extra = {"value": -1.0} if name == "SequenceMask" else {}
        exact += [
            (name, dict(extra, use_sequence_length=True),
             [d(5, 3, 2), _ints([2, 5, 3])]),
            (name, {}, [d(5, 3, 2)])]
        if name != "SequenceReverse":
            exact.append((name, {"use_sequence_length": True, "axis": 1},
                          [d(3, 5, 2), _ints([2, 5, 3])]))
    products = [
        ("dot", {}, [d(3, 4), d(4, 5, seed=1)]),
        ("dot", {"transpose_a": True}, [d(4, 3), d(4, 5)]),
        ("dot", {"transpose_b": True}, [d(3, 4), d(5, 4)]),
        ("dot", {}, [d(4), d(4, seed=1)]),
        ("dot", {}, [d(2, 3, 4), d(4, 5)]),
        ("batch_dot", {}, [d(2, 3, 4), d(2, 4, 5)]),
        ("batch_dot", {"transpose_a": True, "transpose_b": True},
         [d(2, 4, 3), d(2, 5, 4)]),
        ("khatri_rao", {}, [d(3, 4), d(2, 4, seed=1), d(5, 4, seed=2)])]
    return [Case(n, p, a, "exact", True) for n, p, a in exact] + \
        [Case(n, p, a, "product", True) for n, p, a in products]


def _reduce_nn_cases():
    x = _domain("any", "reduce", (2, 3, 4)) * 0.8
    xn = x.copy()
    xn[0, 1, 2] = xn[1, 2, 0] = np.nan
    label = _ints([0, 3, 1, 2, 3])
    cases = [Case(n, p, [x], fam, True) for n, p, fam in (
        ("max", {"axis": 2}, "exact"), ("max_axis", {"axis": 0}, "exact"),
        ("min", {"axis": -1, "keepdims": True}, "exact"),
        ("min_axis", {}, "exact"),
        ("sum", {"axis": 1}, "reduction"),
        ("sum_axis", {"axis": (0, 2), "keepdims": True}, "reduction"),
        ("mean", {}, "reduction"),
        ("mean", {"axis": 0, "exclude": True}, "reduction"),
        ("prod", {}, "reduction"), ("prod", {"axis": (0, 2)}, "reduction"),
        ("prod", {"axis": 1, "keepdims": True}, "reduction"),
        ("norm", {}, "reduction"), ("norm", {"ord": 1, "axis": 1},
                                    "reduction"),
        ("square_sum", {"axis": 1}, "reduction"),
        ("square_sum", {"axis": (1, 2), "keepdims": True}, "reduction"),
        ("L2Normalization", {}, "reduction"),
        ("L2Normalization", {"mode": "channel"}, "reduction"),
        ("L2Normalization", {"mode": "spatial", "eps": 1e-4}, "reduction"),
        ("SoftmaxActivation", {}, "transcendental"),
        ("SoftmaxActivation", {"mode": "channel"}, "transcendental"),
        ("LeakyReLU", {"act_type": "leaky", "slope": 0.1}, "exact"),
        ("LeakyReLU", {"act_type": "elu", "slope": 0.7}, "transcendental"),
        ("LeakyReLU", {"act_type": "selu"}, "transcendental"),
        ("LeakyReLU", {"act_type": "rrelu", "lower_bound": 0.1,
                       "upper_bound": 0.3}, "exact"),
        ("Dropout", {"p": 0.5}, "exact"),
        ("Dropout", {"p": 0.0, "mode": "always"}, "exact"),
        ("Dropout", {"p": 0.3, "axes": (1,)}, "exact"))]
    cases += [Case(n, p, [xn], "reduction", True) for n, p in (
        ("nansum", {"axis": 1}), ("nansum", {}), ("nanprod", {"axis": 2}),
        ("nanprod", {"axis": 0, "keepdims": True}))]
    cases += [
        Case("LeakyReLU", {"act_type": "prelu"},
             [x, _ints([0.1, -0.2, 0.3])], "exact", True),
        Case("softmax_cross_entropy", {},
             [_domain("any", "sce", (5, 4)), label], "reduction", True)]
    return cases


CASES = _elemwise_cases() + _init_cases() + _shape_cases() + \
    _reduce_nn_cases()


def limit(case, dtype="float32"):
    """The largest reading the case may give in ``dtype``."""
    if dtype == "float32" or case.family == "exact":
        return LIMITS[case.family]
    return BF16_LIMIT


def run_case(case, ctx, dtype="float32"):
    """The case's outputs on ``ctx`` (every input in ``dtype``; bf16
    holds the tables' small integer indices exactly), as CPU tensors."""
    dev = ctx.torch_device()
    dt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    ins = [torch.from_numpy(a).to(dev, dt) for a in case.arrays]
    params = dict(case.params, _ctx=ctx, _is_train=False)
    outs = get_op(case.name).fcompute(params, *ins)
    return [o.detach().cpu() for o in outs]


def reading(got, want, family):
    """0 for equal results; else the largest difference over the
    reference's largest magnitude (inf for an exact family)."""
    worst = 0.0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            return float("inf")
        if torch.equal(g, w) or (g.is_floating_point() and torch.equal(
                torch.isnan(g), torch.isnan(w)) and torch.equal(
                    g.nan_to_num(), w.nan_to_num())):
            continue
        if family == "exact":
            return float("inf")
        g64, w64 = g.double().nan_to_num(), w.double().nan_to_num()
        scale = float(w64.abs().max()) or 1.0
        worst = max(worst, float((g64 - w64).abs().max()) / scale)
    return worst


def compare(case, ctx, dtype="float32", ref=None, inputs_of=None):
    """The case's reading on ``ctx`` against ``ref`` (cpu() by default);
    ``inputs_of`` may change the inputs on ``ctx`` only (a control)."""
    want = run_case(case, ref or cpu(), dtype)
    probe = case if inputs_of is None else Case(
        case.name, case.params, [inputs_of(a) for a in case.arrays],
        case.family, case.bf16)
    return reading(run_case(probe, ctx, dtype), want, case.family)


def sweep(ctx, ref=None):
    """Every case on ``ctx`` against ``ref``, f32 and (where it runs)
    bf16. Returns {(family, dtype): [cases, worst reading]} and the list
    of cases over their limit."""
    families, fails = {}, []
    for case in CASES:
        for dtype in ("float32", "bfloat16") if case.bf16 else ("float32",):
            err = compare(case, ctx, dtype, ref)
            row = families.setdefault((case.family, dtype), [0, 0.0])
            row[0] += 1
            row[1] = max(row[1], err)
            if err > limit(case, dtype):
                fails.append((case.name, case.params, dtype, err,
                              limit(case, dtype)))
    return families, fails


def _bf16_rounded(a):
    return torch.from_numpy(a).bfloat16().float().numpy()


def control(ctx, family, ref=None):
    """The family's largest f32 reading with the card's inputs rounded to
    bf16: what a kernel that lost f32 precision would read."""
    return max(compare(c, ctx, "float32", ref, _bf16_rounded)
               for c in CASES if c.family == family and c.arrays
               and c.bf16)

