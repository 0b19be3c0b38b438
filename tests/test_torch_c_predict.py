"""The port's ``MXPred*`` C ABI (`mxnet_tpu_torch/csrc/c_predict_api.cc`,
built by `mxnet_tpu_torch/native.py`) on the CPU.

The C client (`csrc/predict_client.c`) runs on device type 1 against the
port's and the JAX package's ``Predictor`` (the JAX one with its
compile-tracking layer off, ``MXNET_XLA_STATS=0``, ROADMAP C), as the JAX
package's ``tests/test_native_cpp.py`` runs its own client; its bad
arguments and failing calls end in an exit code and ``MXGetLastError``'s
message, never a crash. The library is also loaded into this process with
``ctypes`` (its interpreter is then this one) for the calls the client
does not make: ``MXPredReshape``, ``MXPredPartialForward``,
``MXPredCreatePartialOut`` and null handles.
"""
import ctypes
import subprocess

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import native

from test_torch_symbol import T, V, lm

STATES = ("data", "lstm_state", "lstm_state_cell")


@pytest.fixture(scope="module")
def built():
    return native.predict_library(), native.predict_client()


def _mlp(pkg):
    data = pkg.sym.var("data")
    net = pkg.sym.FullyConnected(data, num_hidden=8, name="fc1")
    net = pkg.sym.Activation(net, act_type="relu")
    net = pkg.sym.FullyConnected(net, num_hidden=3, name="fc2")
    return pkg.sym.SoftmaxOutput(net, name="softmax")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Two exported models: the MLP of the JAX test and the small LM."""
    d = tmp_path_factory.mktemp("cpredict")
    rng = np.random.RandomState(0)
    out = {}
    mlp_params = {"fc1_weight": rng.randn(8, 5), "fc1_bias": rng.randn(8),
                  "fc2_weight": rng.randn(3, 8), "fc2_bias": rng.randn(3)}
    sym = lm(mxt)
    shapes, _, _ = sym.infer_shape(data=(1, T))
    lm_params = {n: rng.uniform(-0.3, 0.3, s)
                 for n, s in zip(sym.list_arguments(), shapes)
                 if n not in STATES}
    for name, net, params in (("mlp", _mlp(mxt), mlp_params),
                              ("lm", sym, lm_params)):
        sym_path, par_path = d / (name + ".json"), d / (name + ".params")
        sym_path.write_text(net.tojson())
        mxt.nd.save(str(par_path), {
            "arg:" + k: mxt.nd.array(v.astype(np.float32), ctx=mxt.cpu())
            for k, v in params.items()})
        out[name] = (str(sym_path), str(par_path))
    return out


def _inputs(name, rows):
    rng = np.random.RandomState(rows)
    if name == "mlp":
        return rng.randn(rows, 5).astype(np.float32)
    return rng.randint(0, V, (rows, T)).astype(np.float32)


def _run_client(client, sym_path, par_path, key, dev_type, dims, x):
    return subprocess.run(
        [str(client), sym_path, par_path, key, str(dev_type)]
        + [str(d) for d in dims], input=x.tobytes(), capture_output=True,
        env=native.client_env(), timeout=300)


@pytest.mark.parametrize("name,rows", [("mlp", 4), ("mlp", 1), ("lm", 4),
                                       ("lm", 2)])
def test_client_on_the_cpu_matches_both_predictors(built, files, name,
                                                   rows, monkeypatch):
    monkeypatch.setenv("MXNET_XLA_STATS", "0")
    sym_path, par_path = files[name]
    x = _inputs(name, rows)
    with open(sym_path) as fh:
        js = fh.read()
    tp = mxt.Predictor(js, par_path, ctx=mxt.cpu(),
                       input_shapes={"data": x.shape})
    tp.forward(data=x)
    want = tp.get_output(0)
    jp = mx.Predictor(js, par_path, ctx=mx.cpu(),
                      input_shapes={"data": x.shape})
    jp.forward(data=x)
    run = _run_client(built[1], sym_path, par_path, "data", 1, x.shape, x)
    assert run.returncode == 0, run.stderr.decode()[-2000:]
    shape = tuple(int(d) for d in
                  run.stderr.decode().split("shape", 1)[1].split())
    got = np.frombuffer(run.stdout, dtype=np.float32).reshape(shape)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, jp.get_output(0), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("args,code,message", [
    (["data", "0", "4", "5"], 2, "bad device type"),
    (["data", "3", "4", "5"], 2, "bad device type"),
    (["data", "1", "4", "xyz"], 2, "bad dimension"),
    (["data", "1", "0", "5"], 2, "bad dimension"),
    (["data", "1"], 2, "usage"),
    (["fc1_weight", "1", "4", "5"], 1, "FAILED MXPred"),
    (["data", "1", "4", "6"], 1, "FAILED MXPredCreate"),
    (["data", "2", "4", "5"], 1, "CUDA device"),
])
def test_client_bad_arguments_exit_cleanly(built, files, args, code,
                                           message):
    sym_path, par_path = files["mlp"]
    run = subprocess.run(
        [str(built[1]), sym_path, par_path] + args,
        input=np.zeros(64, np.float32).tobytes(), capture_output=True,
        env=native.client_env(), timeout=300)
    assert run.returncode == code, run.stderr.decode()[-2000:]
    assert message in run.stderr.decode()


def test_builds_are_reused(built):
    assert native.predict_library() == built[0]
    assert native.predict_client() == built[1]
    assert built[0].parent.name == "build"


# ---------------------------------------------------------------------------
# the library in this process
# ---------------------------------------------------------------------------

U = ctypes.c_uint


def _lib(path):
    lib = ctypes.CDLL(str(path))
    lib.MXGetLastError.restype = ctypes.c_char_p
    return lib


def _csr(shapes):
    keys = (ctypes.c_char_p * len(shapes))(*[k.encode() for k, _ in shapes])
    indptr, data = [0], []
    for _, s in shapes:
        data += list(s)
        indptr.append(len(data))
    return keys, (U * len(indptr))(*indptr), (U * max(1, len(data)))(*data)


def _create(lib, files, name, rows, outputs=()):
    sym_path, par_path = files[name]
    with open(sym_path, "rb") as fh:
        js = fh.read()
    with open(par_path, "rb") as fh:
        blob = fh.read()
    dims = (rows, 5) if name == "mlp" else (rows, T)
    keys, indptr, data = _csr([("data", dims)])
    handle = ctypes.c_void_p()
    if outputs:
        okeys = (ctypes.c_char_p * len(outputs))(
            *[o.encode() for o in outputs])
        rc = lib.MXPredCreatePartialOut(js, blob, len(blob), 1, 0, 1, keys,
                                        indptr, data, len(outputs), okeys,
                                        ctypes.byref(handle))
    else:
        rc = lib.MXPredCreate(js, blob, len(blob), 1, 0, 1, keys, indptr,
                              data, ctypes.byref(handle))
    assert rc == 0, lib.MXGetLastError()
    return handle


def _output(lib, handle, index=0):
    shp, ndim = ctypes.POINTER(U)(), U()
    assert lib.MXPredGetOutputShape(handle, index, ctypes.byref(shp),
                                    ctypes.byref(ndim)) == 0
    shape = tuple(shp[i] for i in range(ndim.value))
    buf = np.zeros(shape, np.float32)
    assert lib.MXPredGetOutput(
        handle, index, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        buf.size) == 0, lib.MXGetLastError()
    return buf


def _set(lib, handle, x):
    return lib.MXPredSetInput(handle, b"data", x.ctypes.data_as(
        ctypes.POINTER(ctypes.c_float)), x.size)


def test_reshape_and_partial_forward_in_process(built, files):
    lib = _lib(built[0])
    handle = _create(lib, files, "lm", 2)
    x2, x3 = _inputs("lm", 2), _inputs("lm", 3)
    assert _set(lib, handle, x2) == 0
    left = ctypes.c_int(7)
    assert lib.MXPredPartialForward(handle, 0, ctypes.byref(left)) == 0
    assert left.value == 0
    out2 = _output(lib, handle)
    keys, indptr, data = _csr([("data", (3, T))])
    bigger = ctypes.c_void_p()
    assert lib.MXPredReshape(1, keys, indptr, data, handle,
                             ctypes.byref(bigger)) == 0
    assert _set(lib, bigger, x3) == 0
    assert lib.MXPredForward(bigger) == 0
    out3 = _output(lib, bigger)
    with open(files["lm"][0]) as fh:
        js = fh.read()
    ref = mxt.Predictor(js, files["lm"][1], ctx=mxt.cpu(),
                        input_shapes={"data": (2, T)})
    for x, got in ((x2, out2), (x3, out3)):
        ref.reshape({"data": x.shape})
        ref.forward(data=x)
        np.testing.assert_allclose(got, ref.get_output(0), rtol=1e-6,
                                   atol=1e-7)
    # the original handle keeps its shape
    assert _output(lib, handle).shape == (2, T, V)
    assert lib.MXPredFree(bigger) == 0 and lib.MXPredFree(handle) == 0


def test_partial_out_and_errors_in_process(built, files):
    lib = _lib(built[0])
    handle = _create(lib, files, "mlp", 4, outputs=("fc2",))
    x = _inputs("mlp", 4)
    assert _set(lib, handle, x) == 0
    assert lib.MXPredForward(handle) == 0
    assert _output(lib, handle).shape == (4, 3)
    # a wrong input size, a weight as input, an output out of range
    assert _set(lib, handle, x[:2]) == -1
    assert b"size" in lib.MXGetLastError()
    assert lib.MXPredSetInput(handle, b"fc1_weight", x.ctypes.data_as(
        ctypes.POINTER(ctypes.c_float)), x.size) == -1
    assert b"no input named" in lib.MXGetLastError()
    shp, ndim = ctypes.POINTER(U)(), U()
    assert lib.MXPredGetOutputShape(handle, 3, ctypes.byref(shp),
                                    ctypes.byref(ndim)) == -1
    assert b"out of range" in lib.MXGetLastError()
    small = np.zeros(2, np.float32)
    assert lib.MXPredGetOutput(handle, 0, small.ctypes.data_as(
        ctypes.POINTER(ctypes.c_float)), 2) == -1
    assert b"size mismatch" in lib.MXGetLastError()
    assert lib.MXPredForward(None) == -1
    assert b"null" in lib.MXGetLastError()
    assert lib.MXPredFree(handle) == 0
    assert lib.MXPredFree(None) == 0
