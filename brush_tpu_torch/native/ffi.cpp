// brush_tpu_torch C ABI: embeds CPython and drives
// brush_tpu_torch.ffi_entry (brush_tpu's C ABI, for the PyTorch port).
//
// Counterpart of the reference's C FFI (apps/brush-c/src/lib.rs): blocking
// train_and_save with a progress callback and exception-catching at the
// boundary. Design notes:
//
//  * Works both from a plain C/C++ host (we initialise the interpreter)
//    and when loaded into an existing Python process via ctypes/dlopen
//    (we only take the GIL).
//  * The raw callback pointer crosses into Python as an integer; the
//    Python side re-materialises it with ctypes.CFUNCTYPE. This keeps the
//    embedding layer free of any custom extension-module registration.
//  * Errors never propagate as C++ exceptions across the C boundary; they
//    are stored in a thread-local buffer served by brush_last_error().

#include "include/brush_tpu_torch_ffi.h"

#include <Python.h>

#include <cstdlib>
#include <cstring>
#include <string>

namespace {

thread_local std::string g_last_error;

void set_error(const std::string &msg) { g_last_error = msg; }

// Fetch and clear the current Python exception into g_last_error.
void capture_py_error(const char *context) {
  PyObject *type = nullptr, *value = nullptr, *tb = nullptr;
  PyErr_Fetch(&type, &value, &tb);
  PyErr_NormalizeException(&type, &value, &tb);
  std::string msg = context;
  if (value != nullptr) {
    PyObject *s = PyObject_Str(value);
    if (s != nullptr) {
      const char *c = PyUnicode_AsUTF8(s);
      if (c != nullptr) {
        msg += ": ";
        msg += c;
      }
      Py_DECREF(s);
    }
  }
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(tb);
  set_error(msg);
}

// Initialise the interpreter if this process doesn't have one yet.
// Returns false on failure. When we own the init, honour
// BRUSH_TPU_TORCH_PYTHONPATH so `import brush_tpu_torch` resolves.
bool ensure_python() {
  if (Py_IsInitialized()) return true;
  Py_InitializeEx(/*install_signal_handlers=*/0);
  if (!Py_IsInitialized()) {
    set_error("Py_InitializeEx failed");
    return false;
  }
  const char *extra = std::getenv("BRUSH_TPU_TORCH_PYTHONPATH");
  if (extra != nullptr && extra[0] != '\0') {
    PyObject *sys_path = PySys_GetObject("path");  // borrowed
    PyObject *entry = PyUnicode_FromString(extra);
    if (sys_path != nullptr && entry != nullptr) {
      PyList_Insert(sys_path, 0, entry);
    }
    Py_XDECREF(entry);
  }
  // Release the GIL acquired by Py_Initialize so PyGILState_Ensure below
  // works uniformly for both the owning and the embedded-into case.
  PyEval_SaveThread();
  return true;
}

}  // namespace

extern "C" {

int32_t brush_abi_version(void) { return BRUSH_TPU_TORCH_ABI_VERSION; }

const char *brush_last_error(void) { return g_last_error.c_str(); }

int32_t brush_train_and_save(const char *dataset_path,
                             const char *options_json,
                             brush_progress_cb progress_cb, void *user_data) {
  g_last_error.clear();
  if (dataset_path == nullptr) {
    set_error("dataset_path is NULL");
    return BRUSH_ERR_BAD_ARG;
  }
  if (!ensure_python()) return BRUSH_ERR_PYTHON_INIT;

  PyGILState_STATE gil = PyGILState_Ensure();
  int32_t status = BRUSH_OK;

  PyObject *mod = PyImport_ImportModule("brush_tpu_torch.ffi_entry");
  if (mod == nullptr) {
    capture_py_error("import brush_tpu_torch.ffi_entry failed");
    status = BRUSH_ERR_IMPORT;
  } else {
    PyObject *fn = PyObject_GetAttrString(mod, "train_and_save");
    if (fn == nullptr) {
      capture_py_error("brush_tpu_torch.ffi_entry.train_and_save missing");
      status = BRUSH_ERR_IMPORT;
    } else {
      PyObject *res = PyObject_CallFunction(
          fn, "ssKK", dataset_path,
          options_json != nullptr ? options_json : "",
          (unsigned long long)(uintptr_t)progress_cb,
          (unsigned long long)(uintptr_t)user_data);
      if (res == nullptr) {
        capture_py_error("training failed");
        status = BRUSH_ERR_TRAIN;
      } else {
        Py_DECREF(res);
      }
      Py_DECREF(fn);
    }
    Py_DECREF(mod);
  }

  PyGILState_Release(gil);
  return status;
}

}  // extern "C"
