/*!
 * Embedded-CPython scaffolding of the port's MXPred* predict ABI
 * (c_predict_api.cc); the port's copy of the JAX package's
 * src/py_embed.h.
 *
 * The C surface embeds one CPython interpreter and delegates every call
 * to the `_c_*` helpers of mxnet_tpu_torch.predict, so C and Python
 * hosts run the same path: on the card one captured CUDA graph per input
 * shape.
 */
#ifndef MXTORCH_PY_EMBED_H_
#define MXTORCH_PY_EMBED_H_

#include <Python.h>

#include <mutex>
#include <stdexcept>
#include <string>

typedef unsigned int mx_uint;
typedef float mx_float;

#define MXTORCH_DLL extern "C" __attribute__((visibility("default")))

namespace mxtorch {
namespace py {

inline std::mutex &InitMutex() {
  static std::mutex mu;
  return mu;
}

inline void EnsurePython() {
  // serialized: Py_InitializeEx is not thread-safe, and a second thread
  // must not PyGILState_Ensure on a half-initialized interpreter
  std::lock_guard<std::mutex> lock(InitMutex());
  if (!Py_IsInitialized()) {
    Py_InitializeEx(0);
    // drop the init-acquired GIL; every entry point re-takes it via
    // PyGILState_Ensure so calls work from any thread
    PyEval_SaveThread();
  }
}

struct Gil {
  PyGILState_STATE st;
  Gil() { st = PyGILState_Ensure(); }
  ~Gil() { PyGILState_Release(st); }
};

inline std::string PyErrString() {
  PyObject *t = nullptr, *v = nullptr, *tb = nullptr;
  PyErr_Fetch(&t, &v, &tb);
  PyErr_NormalizeException(&t, &v, &tb);
  std::string out = "python error";
  if (v != nullptr) {
    PyObject *s = PyObject_Str(v);
    if (s != nullptr) {
      const char *c = PyUnicode_AsUTF8(s);
      if (c != nullptr) out = c;
      Py_DECREF(s);
    }
  }
  Py_XDECREF(t);
  Py_XDECREF(v);
  Py_XDECREF(tb);
  return out;
}

inline PyObject *Check(PyObject *o) {
  if (o == nullptr) throw std::runtime_error(PyErrString());
  return o;
}

/*! \brief owned reference: decrefs on every exit path (Check throws) */
struct PyRef {
  PyObject *p;
  explicit PyRef(PyObject *o = nullptr) : p(o) {}
  ~PyRef() { Py_XDECREF(p); }
  PyObject *get() const { return p; }
  PyObject *release() {
    PyObject *r = p;
    p = nullptr;
    return r;
  }
  PyRef(const PyRef &) = delete;
  PyRef &operator=(const PyRef &) = delete;
};

/*! \brief fetch helper `name` from python module `module` */
inline PyObject *Helper(const char *module, const char *name) {
  PyObject *mod = Check(PyImport_ImportModule(module));
  PyObject *fn = PyObject_GetAttrString(mod, name);
  Py_DECREF(mod);
  return Check(fn);
}

/* (keys, indptr, shape_data) CSR triple -> ([keys...], [shape tuples...]) */
inline void ShapesFromCsr(mx_uint n, const char **keys,
                          const mx_uint *indptr, const mx_uint *shape_data,
                          PyObject **out_keys, PyObject **out_shapes) {
  PyRef k(Check(PyList_New(n)));
  PyRef s(Check(PyList_New(n)));
  for (mx_uint i = 0; i < n; ++i) {
    PyList_SET_ITEM(k.get(), i, Check(PyUnicode_FromString(keys[i])));
    mx_uint lo = indptr[i], hi = indptr[i + 1];
    if (hi < lo) throw std::runtime_error("input_shape_indptr decreases");
    PyObject *shp = Check(PyTuple_New(hi - lo));
    PyList_SET_ITEM(s.get(), i, shp);
    for (mx_uint j = lo; j < hi; ++j)
      PyTuple_SET_ITEM(shp, j - lo,
                       Check(PyLong_FromUnsignedLong(shape_data[j])));
  }
  *out_keys = k.release();
  *out_shapes = s.release();
}

}  // namespace py
}  // namespace mxtorch

#endif  // MXTORCH_PY_EMBED_H_
