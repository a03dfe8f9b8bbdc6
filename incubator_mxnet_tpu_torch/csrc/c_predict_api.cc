// The C predict ABI of the PyTorch port: the functions of
// src/c_predict_api.h (included read-only), over an embedded CPython
// that drives incubator_mxnet_tpu_torch.c_predict.
//
// The interpreter starts at the first MXTPUPredCreate, with the program
// name of the Python that built this library (MXTPU_PYTHON, set by
// incubator_mxnet_tpu_torch/native.py), so it finds that installation's
// packages; PYTHONPATH from the environment must name the checkout's
// root, where incubator_mxnet_tpu_torch lives.  Every entry point holds
// the GIL only for its own duration (PyGILState_Ensure), so the calling
// thread need not be Python's: the first forward on dev_type 2
// initialises CUDA under the GIL from the caller's thread.
#include "c_predict_api.h"

#include <Python.h>

#include <cstring>
#include <string>
#include <vector>

#ifndef MXTPU_PYTHON
#define MXTPU_PYTHON "python3"
#endif

namespace {

thread_local std::string g_last_error;

struct Predictor {
  PyObject *obj;                    // incubator_mxnet_tpu_torch.c_predict.Predictor
  std::vector<uint32_t> shape_buf;  // backs MXTPUPredGetOutputShape
};

void set_error_from_python() {
  PyObject *type = nullptr, *value = nullptr, *tb = nullptr;
  PyErr_Fetch(&type, &value, &tb);
  PyErr_NormalizeException(&type, &value, &tb);
  g_last_error = "unknown python error";
  if (value != nullptr) {
    PyObject *s = PyObject_Str(value);
    if (s != nullptr) {
      const char *msg = PyUnicode_AsUTF8(s);
      if (msg != nullptr) g_last_error = msg;
      Py_DECREF(s);
    }
  }
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(tb);
}

bool ensure_interpreter() {
  if (Py_IsInitialized()) return true;
  PyConfig config;
  PyConfig_InitPythonConfig(&config);
  config.install_signal_handlers = 0;
  PyStatus status = PyConfig_SetBytesString(&config, &config.program_name,
                                            MXTPU_PYTHON);
  if (!PyStatus_Exception(status)) status = Py_InitializeFromConfig(&config);
  PyConfig_Clear(&config);
  if (PyStatus_Exception(status) || !Py_IsInitialized()) {
    g_last_error = std::string("failed to initialize embedded Python: ") +
                   (status.err_msg ? status.err_msg : "unknown");
    return false;
  }
  // release the GIL initialization took, so entry points can take it
  PyEval_SaveThread();
  return true;
}

class GilGuard {
 public:
  GilGuard() : state_(PyGILState_Ensure()) {}
  ~GilGuard() { PyGILState_Release(state_); }

 private:
  PyGILState_STATE state_;
};

PyObject *call_method(PyObject *obj, const char *name, PyObject *args) {
  PyObject *fn = PyObject_GetAttrString(obj, name);
  if (fn == nullptr) return nullptr;
  PyObject *ret = PyObject_CallObject(fn, args);
  Py_DECREF(fn);
  return ret;
}

}  // namespace

extern "C" {

const char *MXTPUGetLastError(void) { return g_last_error.c_str(); }

int MXTPUPredCreate(const char *symbol_json, const void *param_bytes,
                    size_t param_size, int dev_type, int dev_id,
                    uint32_t num_input_nodes, const char **input_keys,
                    const uint32_t *input_shape_indptr,
                    const uint32_t *input_shape_data,
                    PredictorHandle *out) {
  if (!ensure_interpreter()) return -1;
  GilGuard gil;
  PyObject *mod = PyImport_ImportModule("incubator_mxnet_tpu_torch.c_predict");
  if (mod == nullptr) {
    set_error_from_python();
    return -1;
  }
  PyObject *names = PyList_New(num_input_nodes);
  PyObject *shapes = PyList_New(num_input_nodes);
  for (uint32_t i = 0; i < num_input_nodes; ++i) {
    PyList_SetItem(names, i, PyUnicode_FromString(input_keys[i]));
    uint32_t lo = input_shape_indptr[i], hi = input_shape_indptr[i + 1];
    PyObject *shp = PyTuple_New(hi - lo);
    for (uint32_t j = lo; j < hi; ++j)
      PyTuple_SetItem(shp, j - lo,
                      PyLong_FromUnsignedLong(input_shape_data[j]));
    PyList_SetItem(shapes, i, shp);
  }
  PyObject *params = PyBytes_FromStringAndSize(
      static_cast<const char *>(param_bytes),
      static_cast<Py_ssize_t>(param_size));
  PyObject *args = Py_BuildValue("(sOiiOO)", symbol_json, params, dev_type,
                                 dev_id, names, shapes);
  Py_DECREF(params);
  Py_DECREF(names);
  Py_DECREF(shapes);
  PyObject *pred = call_method(mod, "create", args);
  Py_DECREF(args);
  Py_DECREF(mod);
  if (pred == nullptr) {
    set_error_from_python();
    return -1;
  }
  *out = new Predictor{pred, {}};
  return 0;
}

int MXTPUPredSetInput(PredictorHandle handle, const char *key,
                      const float *data, uint32_t size) {
  auto *h = static_cast<Predictor *>(handle);
  GilGuard gil;
  PyObject *view = PyMemoryView_FromMemory(
      reinterpret_cast<char *>(const_cast<float *>(data)),
      static_cast<Py_ssize_t>(size) * 4, PyBUF_READ);
  PyObject *args = Py_BuildValue("(sO)", key, view);
  Py_DECREF(view);
  PyObject *ret = call_method(h->obj, "set_input_bytes", args);
  Py_DECREF(args);
  if (ret == nullptr) {
    set_error_from_python();
    return -1;
  }
  Py_DECREF(ret);
  return 0;
}

int MXTPUPredForward(PredictorHandle handle) {
  auto *h = static_cast<Predictor *>(handle);
  GilGuard gil;
  PyObject *ret = call_method(h->obj, "forward", nullptr);
  if (ret == nullptr) {
    set_error_from_python();
    return -1;
  }
  Py_DECREF(ret);
  return 0;
}

int MXTPUPredGetOutputShape(PredictorHandle handle, uint32_t index,
                            uint32_t **shape_data, uint32_t *shape_ndim) {
  auto *h = static_cast<Predictor *>(handle);
  GilGuard gil;
  PyObject *args = Py_BuildValue("(I)", index);
  PyObject *shp = call_method(h->obj, "output_shape", args);
  Py_DECREF(args);
  if (shp == nullptr) {
    set_error_from_python();
    return -1;
  }
  Py_ssize_t n = PyTuple_Size(shp);
  h->shape_buf.resize(static_cast<size_t>(n));
  for (Py_ssize_t i = 0; i < n; ++i)
    h->shape_buf[static_cast<size_t>(i)] = static_cast<uint32_t>(
        PyLong_AsUnsignedLong(PyTuple_GetItem(shp, i)));
  Py_DECREF(shp);
  *shape_data = h->shape_buf.data();
  *shape_ndim = static_cast<uint32_t>(n);
  return 0;
}

int MXTPUPredGetOutput(PredictorHandle handle, uint32_t index, float *data,
                       uint32_t size) {
  auto *h = static_cast<Predictor *>(handle);
  GilGuard gil;
  PyObject *args = Py_BuildValue("(I)", index);
  PyObject *bytes = call_method(h->obj, "output", args);
  Py_DECREF(args);
  if (bytes == nullptr) {
    set_error_from_python();
    return -1;
  }
  char *buf = nullptr;
  Py_ssize_t blen = 0;
  if (PyBytes_AsStringAndSize(bytes, &buf, &blen) != 0) {
    Py_DECREF(bytes);
    set_error_from_python();
    return -1;
  }
  if (static_cast<size_t>(blen) != static_cast<size_t>(size) * 4) {
    g_last_error = "output size mismatch";
    Py_DECREF(bytes);
    return -1;
  }
  std::memcpy(data, buf, static_cast<size_t>(blen));
  Py_DECREF(bytes);
  return 0;
}

int MXTPUPredFree(PredictorHandle handle) {
  auto *h = static_cast<Predictor *>(handle);
  if (h != nullptr) {
    GilGuard gil;
    Py_XDECREF(h->obj);
    delete h;
  }
  return 0;
}

}  // extern "C"
