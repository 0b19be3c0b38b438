/*!
 * MXPred* C predict surface over the PyTorch port (reference
 * include/mxnet/c_predict_api.h, impl src/c_api/c_predict_api.cc): create
 * a predictor from (symbol JSON, .params blob), set inputs, forward, read
 * outputs. Counterpart of the JAX package's src/c_predict_api.cc.
 *
 * This library embeds CPython and delegates each C call to the `_c_*`
 * helpers of mxnet_tpu_torch/predict.py, so a C host runs the Python
 * Predictor's path: on dev_type 2 (CUDA) one captured CUDA graph per
 * input shape, on dev_type 1 the CPU. The embedded interpreter finds
 * mxnet_tpu_torch and torch through the host process's PYTHONPATH.
 * Built by mxnet_tpu_torch/native.py.
 *
 * Thread model: calls may come from any thread; every entry point takes
 * the GIL. The first MXPredCreate initializes the interpreter. Every
 * failure returns -1 with its message in MXGetLastError().
 */
#include <Python.h>

#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

#include "error.h"
#include "py_embed.h"

typedef void *PredictorHandle;

namespace {

using mxtorch::py::Check;
using mxtorch::py::EnsurePython;
using mxtorch::py::Gil;
using mxtorch::py::PyRef;
using mxtorch::py::ShapesFromCsr;

struct Pred {
  PyObject *obj = nullptr;            // mxnet_tpu_torch.predict.Predictor
  std::vector<mx_uint> shape_buf;     // MXPredGetOutputShape storage
};

PyObject *Helper(const char *name) {
  return mxtorch::py::Helper("mxnet_tpu_torch.predict", name);
}

Pred *Handle(PredictorHandle handle) {
  if (handle == nullptr) throw std::runtime_error("null PredictorHandle");
  return static_cast<Pred *>(handle);
}

}  // namespace

MXTORCH_DLL const char *MXGetLastError(void) {
  return mxtorch::GetLastError();
}

MXTORCH_DLL int MXPredCreatePartialOut(
    const char *symbol_json_str, const void *param_bytes, int param_size,
    int dev_type, int dev_id, mx_uint num_input_nodes,
    const char **input_keys, const mx_uint *input_shape_indptr,
    const mx_uint *input_shape_data, mx_uint num_output_nodes,
    const char **output_keys, PredictorHandle *out) {
  MXT_API_BEGIN();
  if (symbol_json_str == nullptr || param_bytes == nullptr || param_size < 0
      || out == nullptr)
    throw std::runtime_error("MXPredCreate: null or negative argument");
  EnsurePython();
  Gil gil;
  PyObject *k = nullptr, *s = nullptr;
  ShapesFromCsr(num_input_nodes, input_keys, input_shape_indptr,
                input_shape_data, &k, &s);
  PyRef keys(k), shapes(s);
  PyRef outs(Check(PyList_New(num_output_nodes)));
  for (mx_uint i = 0; i < num_output_nodes; ++i)
    PyList_SET_ITEM(outs.get(), i,
                    Check(PyUnicode_FromString(output_keys[i])));
  PyRef params(Check(PyBytes_FromStringAndSize(
      static_cast<const char *>(param_bytes), param_size)));
  PyRef fn(Helper("_c_create"));
  PyRef pred(Check(PyObject_CallFunction(
      fn.get(), "sOiiOOO", symbol_json_str, params.get(), dev_type, dev_id,
      keys.get(), shapes.get(), outs.get())));
  Pred *p = new Pred();
  p->obj = pred.release();
  *out = p;
  MXT_API_END();
}

MXTORCH_DLL int MXPredCreate(const char *symbol_json_str,
                             const void *param_bytes, int param_size,
                             int dev_type, int dev_id,
                             mx_uint num_input_nodes,
                             const char **input_keys,
                             const mx_uint *input_shape_indptr,
                             const mx_uint *input_shape_data,
                             PredictorHandle *out) {
  return MXPredCreatePartialOut(symbol_json_str, param_bytes, param_size,
                                dev_type, dev_id, num_input_nodes,
                                input_keys, input_shape_indptr,
                                input_shape_data, 0, nullptr, out);
}

MXTORCH_DLL int MXPredSetInput(PredictorHandle handle, const char *key,
                               const mx_float *data, mx_uint size) {
  MXT_API_BEGIN();
  Pred *p = Handle(handle);
  if (key == nullptr || (data == nullptr && size != 0))
    throw std::runtime_error("MXPredSetInput: null key or data");
  Gil gil;
  PyRef mv(Check(PyMemoryView_FromMemory(
      reinterpret_cast<char *>(const_cast<mx_float *>(data)),
      static_cast<Py_ssize_t>(size) * sizeof(mx_float), PyBUF_READ)));
  PyRef fn(Helper("_c_set_input"));
  PyRef r(Check(PyObject_CallFunction(fn.get(), "OsOI", p->obj, key,
                                      mv.get(), size)));
  MXT_API_END();
}

MXTORCH_DLL int MXPredForward(PredictorHandle handle) {
  MXT_API_BEGIN();
  Pred *p = Handle(handle);
  Gil gil;
  PyRef r(Check(PyObject_CallMethod(p->obj, "forward", nullptr)));
  MXT_API_END();
}

MXTORCH_DLL int MXPredPartialForward(PredictorHandle handle, int step,
                                     int *step_left) {
  /* the forward is one compiled program (a CUDA graph on the card), so
   * the partial schedule is a single step, as in the JAX package */
  MXT_API_BEGIN();
  if (step_left == nullptr)
    throw std::runtime_error("MXPredPartialForward: null step_left");
  if (step <= 0) {
    int rc = MXPredForward(handle);
    if (rc != 0) return rc;
  }
  *step_left = 0;
  MXT_API_END();
}

MXTORCH_DLL int MXPredGetOutputShape(PredictorHandle handle, mx_uint index,
                                     mx_uint **shape_data,
                                     mx_uint *shape_ndim) {
  MXT_API_BEGIN();
  Pred *p = Handle(handle);
  if (shape_data == nullptr || shape_ndim == nullptr)
    throw std::runtime_error("MXPredGetOutputShape: null output pointer");
  Gil gil;
  PyRef fn(Helper("_c_output_shape"));
  PyRef shp(Check(PyObject_CallFunction(fn.get(), "OI", p->obj, index)));
  Py_ssize_t n = PyTuple_Size(shp.get());
  if (n < 0) throw std::runtime_error(mxtorch::py::PyErrString());
  p->shape_buf.resize(n);
  for (Py_ssize_t i = 0; i < n; ++i) {
    unsigned long v = PyLong_AsUnsignedLong(PyTuple_GET_ITEM(shp.get(), i));
    if (v == static_cast<unsigned long>(-1) && PyErr_Occurred()) {
      PyErr_Clear();
      throw std::runtime_error("output shape dim " + std::to_string(i) +
                               " is not an unsigned integer");
    }
    p->shape_buf[i] = static_cast<mx_uint>(v);
  }
  *shape_data = p->shape_buf.data();
  *shape_ndim = static_cast<mx_uint>(n);
  MXT_API_END();
}

MXTORCH_DLL int MXPredGetOutput(PredictorHandle handle, mx_uint index,
                                mx_float *data, mx_uint size) {
  MXT_API_BEGIN();
  Pred *p = Handle(handle);
  if (data == nullptr && size != 0)
    throw std::runtime_error("MXPredGetOutput: null data");
  Gil gil;
  PyRef fn(Helper("_c_get_output_bytes"));
  PyRef b(Check(PyObject_CallFunction(fn.get(), "OI", p->obj, index)));
  Py_ssize_t nbytes = PyBytes_Size(b.get());
  if (nbytes != static_cast<Py_ssize_t>(size) *
                    static_cast<Py_ssize_t>(sizeof(mx_float))) {
    throw std::runtime_error("output size mismatch: have " +
                             std::to_string(nbytes / sizeof(mx_float)) +
                             " floats, caller asked " + std::to_string(size));
  }
  std::memcpy(data, PyBytes_AsString(b.get()), nbytes);
  MXT_API_END();
}

MXTORCH_DLL int MXPredReshape(mx_uint num_input_nodes,
                              const char **input_keys,
                              const mx_uint *input_shape_indptr,
                              const mx_uint *input_shape_data,
                              PredictorHandle handle, PredictorHandle *out) {
  MXT_API_BEGIN();
  Pred *p = Handle(handle);
  if (out == nullptr) throw std::runtime_error("MXPredReshape: null out");
  Gil gil;
  PyObject *k = nullptr, *s = nullptr;
  ShapesFromCsr(num_input_nodes, input_keys, input_shape_indptr,
                input_shape_data, &k, &s);
  PyRef keys(k), shapes(s);
  PyRef fn(Helper("_c_reshape"));
  /* a NEW predictor sharing the loaded parameter arrays; the original
   * handle keeps its shapes (reference semantics) */
  PyRef r(Check(PyObject_CallFunction(fn.get(), "OOO", p->obj, keys.get(),
                                      shapes.get())));
  Pred *np_ = new Pred();
  np_->obj = r.release();
  *out = np_;
  MXT_API_END();
}

MXTORCH_DLL int MXPredFree(PredictorHandle handle) {
  MXT_API_BEGIN();
  Pred *p = static_cast<Pred *>(handle);
  if (p != nullptr) {
    if (Py_IsInitialized()) {
      Gil gil;
      Py_XDECREF(p->obj);
    }
    delete p;
  }
  MXT_API_END();
}
