/* C ABI implementation: embeds CPython and drives the PyTorch port's
 * xflow_tpu_torch.c_api.embed. See xflow_c_api.h for the contract and
 * build line. */

#include "xflow_c_api.h"

#include <Python.h>
#include <math.h>
#include <stdint.h>

static PyObject* g_embed = NULL;

static int ensure_interp(void) {
  if (g_embed != NULL) return 0;
  if (!Py_IsInitialized()) {
    Py_InitializeEx(0);
  }
  g_embed = PyImport_ImportModule("xflow_tpu_torch.c_api.embed");
  if (g_embed == NULL) {
    PyErr_Print();
    return -1;
  }
  return 0;
}

/* Call embed.<fn>(*args); steals the `args` reference on every path
 * (including lookup failure and args==NULL from a failed Py_BuildValue). */
static PyObject* call(const char* fn, PyObject* args) {
  if (args == NULL) return NULL;
  PyObject* f = PyObject_GetAttrString(g_embed, fn);
  if (f == NULL) {
    Py_DECREF(args);
    return NULL;
  }
  PyObject* r = PyObject_CallObject(f, args);
  Py_DECREF(f);
  Py_DECREF(args);
  return r;
}

int XFCreate(void** out_handle, const char* train_prefix, const char* test_prefix) {
  if (ensure_interp() != 0) return -1;
  PyObject* r = call("create", Py_BuildValue("(ss)", train_prefix, test_prefix));
  if (r == NULL) {
    PyErr_Print();
    return -1;
  }
  long h = PyLong_AsLong(r);
  Py_DECREF(r);
  if (h == -1 && PyErr_Occurred()) {
    PyErr_Print();
    return -1;
  }
  *out_handle = (void*)(intptr_t)h;
  return 0;
}

int XFSetConfig(void* handle, const char* dotted_key, const char* value) {
  if (ensure_interp() != 0) return -1;
  PyObject* r = call("set_config",
                     Py_BuildValue("(lss)", (long)(intptr_t)handle, dotted_key, value));
  if (r == NULL) {
    PyErr_Print();
    return -1;
  }
  Py_DECREF(r);
  return 0;
}

int XFStartTrain(void* handle) {
  if (ensure_interp() != 0) return -1;
  PyObject* r = call("start_train", Py_BuildValue("(l)", (long)(intptr_t)handle));
  if (r == NULL) {
    PyErr_Print();
    return -1;
  }
  long rc = PyLong_AsLong(r);
  Py_DECREF(r);
  if (rc == -1 && PyErr_Occurred()) {
    PyErr_Print();
    return -1;
  }
  return (int)rc;
}

double XFGetAUC(void* handle) {
  if (ensure_interp() != 0) return NAN;
  PyObject* r = call("get_auc", Py_BuildValue("(l)", (long)(intptr_t)handle));
  if (r == NULL) {
    PyErr_Print();
    return NAN;
  }
  double auc = PyFloat_AsDouble(r);
  Py_DECREF(r);
  if (auc == -1.0 && PyErr_Occurred()) {
    PyErr_Print();
    return NAN;
  }
  return auc;
}

int XFLoadCheckpoint(void* handle, const char* checkpoint_dir) {
  if (ensure_interp() != 0) return -1;
  PyObject* r = call("load_checkpoint",
                     Py_BuildValue("(ls)", (long)(intptr_t)handle, checkpoint_dir));
  if (r == NULL) {
    PyErr_Print();
    return -1;
  }
  long rc = PyLong_AsLong(r);
  Py_DECREF(r);
  if (rc == -1 && PyErr_Occurred()) {
    PyErr_Print();
    return -1;
  }
  return (int)rc;
}

int XFPredict(void* handle, const char* rows, double* out_pctr, int capacity) {
  if (ensure_interp() != 0) return -1;
  PyObject* r = call("predict",
                     Py_BuildValue("(ls)", (long)(intptr_t)handle, rows));
  if (r == NULL) {
    PyErr_Print();
    return -1;
  }
  PyObject* seq = PySequence_Fast(r, "predict() did not return a sequence");
  Py_DECREF(r);
  if (seq == NULL) {
    PyErr_Print();
    return -1;
  }
  Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
  int wrote = 0;
  for (Py_ssize_t i = 0; i < n && wrote < capacity; ++i) {
    double v = PyFloat_AsDouble(PySequence_Fast_GET_ITEM(seq, i));
    if (v == -1.0 && PyErr_Occurred()) {
      Py_DECREF(seq);
      PyErr_Print();
      return -1;
    }
    out_pctr[wrote++] = v;
  }
  Py_DECREF(seq);
  return wrote;
}

int XFDestroy(void* handle) {
  if (ensure_interp() != 0) return -1;
  PyObject* r = call("destroy", Py_BuildValue("(l)", (long)(intptr_t)handle));
  if (r == NULL) {
    PyErr_Print();
    return -1;
  }
  Py_DECREF(r);
  return 0;
}
