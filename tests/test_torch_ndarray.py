"""The port's NDArray and ``nd`` core against the JAX package's, on the
CPU: queue C's faults (ROADMAP §C: C.1 ``==``/``!=``, C.2 scalar
arithmetic on integer arrays, C.3 ``mean`` of integers, C.4 the dtypes
``nd.array`` keeps, C.5 a ctx-less ``initialize`` under ``with ctx:``),
the NDArray methods and operators of the JAX package, the ``nd``
constructors, ``stype``, and every new op reachable as ``nd.<op>`` and
``sym.<op>``. Inputs are made with numpy from seed 0. Tolerances: exact
for integer, shape, index and sort results; f32 rtol 1e-5, atol 1e-6;
dtypes compared under the x64 rule of ROADMAP's facts (the JAX package's
int64 and f64 reductions are the port's int32 and f32 with the same
values).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.base import MXNetError
from torch_parity import jax_ops_of

RTOL, ATOL = 1e-5, 1e-6
CPU = mxt.cpu()


@pytest.fixture(autouse=True)
def _no_xla_stats(monkeypatch):
    monkeypatch.setenv("MXNET_XLA_STATS", "0")


def _distinct(*shape, seed=0):
    n = int(np.prod(shape))
    rng = np.random.RandomState(seed)
    return (rng.permutation(n).reshape(shape) * 0.21 - n * 0.1
            ).astype(np.float32)


def _both(*values):
    """The same numpy values as JAX and port NDArrays (dtypes kept)."""
    return ([mx.nd.array(v, dtype=v.dtype) for v in values],
            [mxt.nd.array(v, ctx=CPU, dtype=v.dtype) for v in values])


def _np(v):
    if isinstance(v, (list, tuple)):
        return [_np(x) for x in v]
    if hasattr(v, "asnumpy"):
        return v.asnumpy()
    return np.asarray(v)


def _same(got, want, exact=False):
    got, want = _np(got), _np(want)
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w, exact)
        return
    assert got.shape == want.shape
    if exact:
        np.testing.assert_array_equal(got, want.astype(got.dtype))
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


# -- queue C ----------------------------------------------------------------
def test_c1_eq_and_ne_are_elementwise():
    rng = np.random.RandomState(0)
    a = rng.randn(3, 4).astype(np.float32)
    b = a.copy()
    b[1] = rng.randn(4)
    (ja, jb), (ta, tb) = _both(a, b)
    for got, want in ((ta == tb, ja == jb), (ta != tb, ja != jb),
                      (ta == float(a[0, 1]), ja == float(a[0, 1])),
                      (ta != 0.5, ja != 0.5), (ta == b, ja == b)):
        assert isinstance(got, mxt.nd.NDArray)
        assert got.dtype == want.dtype == np.float32
        _same(got, want, exact=True)
    assert {ta: 1}[ta] == 1 and len({ta, tb}) == 2   # still hashable


def test_c1_accuracy_line():
    """``(out.argmax(1) == label).mean()``, the Gluon accuracy line."""
    out = _distinct(6, 5)
    label = np.array([0, 3, 1, 4, 4, 2], np.float32)
    (jo, jl), (to, tl) = _both(out, label)
    _same((to.argmax(1) == tl).mean(), (jo.argmax(1) == jl).mean())


@pytest.mark.parametrize("expr", ["a + 1", "1 + a", "a - 1", "1 - a",
                                  "a * 2", "a + 1.5", "a - 2.7", "a > 1.5",
                                  "a == 1", "a / 2"])
def test_c2_scalar_arithmetic_keeps_the_integer_dtype(expr):
    x = np.array([[-3, 1, 4], [2, -5, 6]], dtype=np.int32)
    (ja,), (ta,) = _both(x)
    got, want = eval(expr, {"a": ta}), eval(expr, {"a": ja})
    _same(got, want, exact=True)
    if "/" in expr:
        assert got.dtype == np.float32
    else:
        assert got.dtype == want.dtype == np.int32


@pytest.mark.parametrize("kw", [{}, {"axis": 1},
                                {"axis": 0, "exclude": True}])
def test_c3_mean_of_an_integer_array(kw):
    x = np.arange(12, dtype=np.int32).reshape(3, 4)
    (ja,), (ta,) = _both(x)
    got = ta.mean(**kw)
    assert got.dtype == np.float32
    _same(got, ja.mean(**kw), exact=True)


def _torch_dtype_name(arr):
    return str(arr.data.dtype).replace("torch.", "")


@pytest.mark.parametrize("source,dtype_name", [
    ("nd_int32", "int32"), ("nd_bf16", "bfloat16"), ("np_int32", "int32"),
    ("np_int64", "int64"), ("np_float64", "float32"), ("np_bool", "bool"),
    ("list_int", "int32"), ("list_float", "float32"), ("np_float16",
                                                       "float16")])
def test_c4_array_keeps_the_dtype(source, dtype_name):
    values = np.array([[1, -2, 3], [4, 5, -6]])
    kind, dt = source.split("_", 1)
    if kind == "nd":
        dt = "bfloat16" if dt == "bf16" else dt
        src_j = mx.nd.array(values, dtype=dt)
        src_t = mxt.nd.array(values, ctx=CPU, dtype=dt)
    elif kind == "np":
        src_j = src_t = values.astype(dt)
    else:
        src_j = src_t = values.tolist() if dt == "int" \
            else (values * 0.5).tolist()
    got, want = mxt.nd.array(src_t), mx.nd.array(src_j)
    assert _torch_dtype_name(got) == dtype_name == np.dtype(want.dtype).name
    assert got.context == CPU
    _same(got.astype("float32"), want.astype("float32"), exact=True)


def test_c4_array_of_an_ndarray_copies_onto_its_context():
    a = mxt.nd.array(np.ones((2, 2), np.int32), ctx=CPU)
    b = mxt.nd.array(a)
    b[:] = 3
    assert b.context == CPU and int(a.sum().asscalar()) == 4


def test_c5_initialize_takes_the_scope_context():
    for pkg in (mx, mxt):
        net = pkg.gluon.nn.Dense(3, in_units=4)
        with pkg.cpu():
            net.initialize()
        assert net.weight.data().context == pkg.cpu()
        p = pkg.gluon.Parameter("weight", shape=(2, 2))
        with pkg.cpu():
            p.initialize()
        assert p.data().context == pkg.cpu()


def test_c5_scopes_nest_and_outside_stays_gpu():
    from mxnet_tpu_torch.context import scope_context
    assert scope_context() is None
    with mxt.cpu(0):
        with mxt.cpu_pinned(0):
            assert scope_context() == mxt.cpu_pinned(0)
        assert scope_context() == mxt.cpu(0)
    assert scope_context() is None
    if mxt.num_gpus() == 0:
        net = mxt.gluon.nn.Dense(3, in_units=4)
        with pytest.raises(MXNetError, match="needs CUDA device"):
            net.initialize()
        with pytest.raises(MXNetError, match="needs CUDA device"), \
                mxt.gpu(0):
            net.initialize()


# -- contexts ----------------------------------------------------------------
def test_tpu_and_cpu_pinned_contexts():
    assert mxt.num_tpus() == mxt.context.num_tpus() == mxt.num_gpus()
    assert str(mxt.tpu(0)) == str(mx.tpu(0)) == "tpu(0)"
    assert str(mxt.cpu_pinned(0)) == "cpu_pinned(0)"
    assert mxt.cpu_pinned(0).torch_device() == torch.device("cpu")
    a = mxt.nd.array([1.0, 2.0], ctx=mxt.cpu_pinned(0))
    assert a.data.device.type == "cpu"
    if mxt.num_gpus() == 0:
        with pytest.raises(MXNetError, match="needs CUDA device"):
            mxt.tpu(0).torch_device()
    else:
        assert mxt.tpu(0).torch_device() == torch.device("cuda", 0)


# -- methods -----------------------------------------------------------------
X = _distinct(3, 4)
POS = np.abs(X) + 0.5
IDX = np.array([1, 0, 3], np.float32)
B = _distinct(4, 2, seed=1)

# method -> (call on (x, pos, idx, b), exact?)
METHODS = {
    "T": (lambda x, p, i, b: x.T, True),
    "abs": (lambda x, p, i, b: x.abs(), True),
    "argmax": (lambda x, p, i, b: x.argmax(axis=1), True),
    "argmin": (lambda x, p, i, b: x.argmin(), True),
    "argsort": (lambda x, p, i, b: x.argsort(axis=0, is_ascend=False), True),
    "as_np": (lambda x, p, i, b: np.asarray(x.as_np()), True),
    "asscalar": (lambda x, p, i, b: x[1, 2].asscalar(), True),
    "item": (lambda x, p, i, b: x.sum().item(), False),
    "broadcast_like": (lambda x, p, i, b: x[0:1].broadcast_like(x), True),
    "broadcast_to": (lambda x, p, i, b: x[:, 1:2].broadcast_to((3, 5)),
                     True),
    "clip": (lambda x, p, i, b: x.clip(-0.5, 0.5), True),
    "copy": (lambda x, p, i, b: x.copy(), True),
    "diag": (lambda x, p, i, b: x.diag(1), True),
    "dot": (lambda x, p, i, b: x.dot(b), False),
    "exp": (lambda x, p, i, b: (x * 0.1).exp(), False),
    "expand_dims": (lambda x, p, i, b: x.expand_dims(1), True),
    "flatten": (lambda x, p, i, b: x.reshape(3, 2, 2).flatten(), True),
    "flip": (lambda x, p, i, b: x.flip(1), True),
    "log": (lambda x, p, i, b: p.log(), False),
    "log_softmax": (lambda x, p, i, b: x.log_softmax(), False),
    "max": (lambda x, p, i, b: x.max(axis=1, keepdims=True), True),
    "min": (lambda x, p, i, b: x.min(), True),
    "nansum": (lambda x, p, i, b: x.nansum(axis=0), False),
    "norm": (lambda x, p, i, b: x.norm(), False),
    "one_hot": (lambda x, p, i, b: i.one_hot(5, 2.0, -1.0), True),
    "pad": (lambda x, p, i, b: x.reshape(1, 1, 3, 4).pad(
        "constant", (0, 0, 0, 0, 1, 1, 2, 0), 0.5), True),
    "pick": (lambda x, p, i, b: x.pick(i, axis=1), True),
    "prod": (lambda x, p, i, b: p.prod(axis=1), False),
    "relu": (lambda x, p, i, b: x.relu(), True),
    "repeat": (lambda x, p, i, b: x.repeat(2, axis=0), True),
    "reshape": (lambda x, p, i, b: [x.reshape((2, 6)), x.reshape(6, -1),
                                    x.reshape(shape=(4, 3))], True),
    "reshape_like": (lambda x, p, i, b: x.reshape_like(p.reshape(6, 2)),
                     True),
    "sigmoid": (lambda x, p, i, b: x.sigmoid(), False),
    "sign": (lambda x, p, i, b: x.sign(), True),
    "slice": (lambda x, p, i, b: x.slice((0, 1), (2, 4)), True),
    "slice_assign": (lambda x, p, i, b: x.copy().slice_assign(
        x[0:1, 0:2] * 0 + 7, (0, 0), (1, 2)), True),
    "slice_axis": (lambda x, p, i, b: x.slice_axis(1, 1, 3), True),
    "softmax": (lambda x, p, i, b: x.softmax(axis=0), False),
    "sort": (lambda x, p, i, b: x.sort(is_ascend=False), True),
    "split": (lambda x, p, i, b: x.split(2, axis=1), True),
    "sqrt": (lambda x, p, i, b: p.sqrt(), False),
    "square": (lambda x, p, i, b: x.square(), False),
    "squeeze": (lambda x, p, i, b: x.reshape(3, 1, 4).squeeze(), True),
    "swapaxes": (lambda x, p, i, b: x.swapaxes(0, 1), True),
    "take": (lambda x, p, i, b: x.take(i, axis=1), True),
    "tanh": (lambda x, p, i, b: x.tanh(), False),
    "tile": (lambda x, p, i, b: x.tile((2, 1)), True),
    "topk": (lambda x, p, i, b: [x.topk(k=2), x.topk(axis=0, k=2,
                                                      ret_typ="value")],
             True),
    "transpose": (lambda x, p, i, b: [x.transpose(), x.transpose((1, 0))],
                  True),
    "wait_to_read": (lambda x, p, i, b: [x.wait_to_read(), x][1], True),
    "wait_to_write": (lambda x, p, i, b: [x.wait_to_write(), x][1], True),
    "stype": (lambda x, p, i, b: np.array(x.stype == "default"), True),
    "tostype": (lambda x, p, i, b: x.tostype("default"), True),
}


def test_every_listed_method_exists_on_both():
    jax_methods = {k for k in dir(mx.nd.NDArray) if not k.startswith("_")}
    port_methods = {k for k in dir(mxt.nd.NDArray) if not k.startswith("_")}
    assert jax_methods <= port_methods
    assert set(METHODS) <= jax_methods


@pytest.mark.parametrize("name", sorted(METHODS))
def test_method(name):
    call, exact = METHODS[name]
    want = call(*_both(X, POS, IDX, B)[0])
    got = call(*_both(X, POS, IDX, B)[1])
    _same(got, want, exact)


def test_tostype_refuses_sparse_storage():
    """``tostype`` converts to the sparse storage types
    (`ndarray/sparse.py`, where they are held against the JAX package)
    and refuses only a storage type that does not exist."""
    a = mxt.nd.array(X, ctx=CPU)
    rs = a.tostype("row_sparse")
    assert rs.stype == "row_sparse" and rs.has_compact()
    np.testing.assert_array_equal(rs.asnumpy(), X)
    assert a.tostype("default") is a
    with pytest.raises(MXNetError, match="unknown storage type"):
        a.tostype("no_such_storage")


# -- operators ---------------------------------------------------------------
OPERATORS = {
    "pow": lambda x, p, b: p ** 1.5, "pow_array": lambda x, p, b: p ** p,
    "rpow": lambda x, p, b: 2.0 ** x, "mod": lambda x, p, b: x % 1.3,
    "mod_array": lambda x, p, b: x % p, "rmod": lambda x, p, b: 3.0 % p,
    "matmul": lambda x, p, b: x @ b, "abs": lambda x, p, b: abs(x),
    "neg_rsub": lambda x, p, b: 1.0 - (-x), "rdiv": lambda x, p, b: 2.0 / p,
    "numpy_rhs": lambda x, p, b: x - X.T.T,
    "numpy_lhs": lambda x, p, b: X.T.T * 2.0 - x,
}


@pytest.mark.parametrize("name", sorted(OPERATORS))
def test_operator(name):
    (jx, jp, jb), (tx, tp, tb) = _both(X, POS, B)
    _same(OPERATORS[name](tx, tp, tb), OPERATORS[name](jx, jp, jb))


def test_scalar_conversions_and_iteration():
    (ja,), (ta,) = _both(X)
    assert float(ta[1, 1]) == float(ja[1, 1])
    assert int(ta[2, 3] * 0 + 3) == 3
    assert bool(ta[0, 0] == ja[0, 0].asscalar())
    rows = list(ta)
    assert len(rows) == 3
    _same(rows, list(ja), exact=True)


def test_module_functions():
    (ja,), (ta,) = _both(X)
    _same(mxt.nd.concatenate([ta, ta * 2], axis=1),
          mx.nd.concatenate([ja, ja * 2], axis=1), exact=True)
    _same(mxt.nd.moveaxis(ta.reshape(3, 2, 2), 0, 2),
          mx.nd.moveaxis(ja.reshape(3, 2, 2), 0, 2), exact=True)
    _same(mxt.nd.onehot_encode(mxt.nd.array(IDX, ctx=CPU), depth=4),
          mx.nd.onehot_encode(mx.nd.array(IDX), depth=4), exact=True)


# -- nd.<op> and sym.<op> ----------------------------------------------------
NEW_NN_OPS = ("Dropout", "LeakyReLU", "SoftmaxActivation",
              "softmax_cross_entropy")


@pytest.mark.parametrize("name", sorted(jax_ops_of(
    "elemwise.py", "init_ops.py", "shape_ops.py", "reduce.py"))
    + list(NEW_NN_OPS))
def test_op_reachable_as_nd_and_sym(name):
    from mxnet_tpu_torch.ops.registry import get_op
    get_op(name)
    assert callable(getattr(mxt.nd, name))
    assert callable(getattr(mxt.sym, name))


def test_nd_op_with_positional_attributes():
    (ja,), (ta,) = _both(X)
    _same(mxt.nd.clip(ta, -0.3, 0.3), mx.nd.clip(ja, -0.3, 0.3), True)
    _same(mxt.nd.slice_axis(ta, 1, 0, 2), mx.nd.slice_axis(ja, 1, 0, 2),
          True)
    _same(mxt.nd.one_hot(mxt.nd.array(IDX, ctx=CPU), 4),
          mx.nd.one_hot(mx.nd.array(IDX), 4), True)


def test_ndarray_index_gathers_and_scatters():
    (ja, ji), (ta, ti) = _both(X, np.array([2, 0], np.int32))
    _same(ta[ti], ja[ji], exact=True)
    _same(ta[1, ti], ja[1, ji], exact=True)
    ja[ji] = 0.0
    ta[ti] = 0.0
    _same(ta, ja, exact=True)
