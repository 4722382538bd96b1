// Linkable C ABI for lightgbm_tpu_torch — an embedded-CPython shim (the
// JAX package's native/c_api_embed.cpp, pointed at the port).
//
// The reference exposes its engine as `extern "C"` entry points in
// src/c_api.cpp (1568 LoC, include/LightGBM/c_api.h) that foreign
// runtimes (the fork's src/test.cpp, SWIG, mmlspark) link against.
// Here the engine is the PyTorch/CUDA port, so this library hosts a
// CPython interpreter and forwards each export to
// lightgbm_tpu_torch/c_embed.py, which wraps the caller's raw buffers
// zero-copy with numpy and calls the same capi.py shim the Python
// package uses. Signatures mirror the fork's c_api.h exactly —
// including its C++ `std::unordered_map` parameter forms — so
// src/test.cpp-style drivers compile and link unchanged. The device
// comes from LGBM_TPU_PLATFORM (c_embed.py): cuda:0 unless it says cpu.
//
// Built by g++ into lightgbm_tpu_torch/_build/ on first use
// (utils/cuda_build.py capi_library), as liblightgbm_tpu_torch.so:
//   g++ -O2 -shared -fPIC -std=c++14 c_api_embed.cpp \
//       -o liblightgbm_tpu_torch.so -I<Python include> \
//       -L<Python LIBDIR> -lpython3.X -ldl -lm -Wl,-rpath,<LIBDIR>
//
// The embedding process must be able to `import lightgbm_tpu_torch`
// (PYTHONPATH or installed package).

#include <Python.h>

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <mutex>
#include <string>
#include <unordered_map>

#define LIGHTGBM_C_EXPORT extern "C" __attribute__((visibility("default")))

typedef void* DatasetHandle;
typedef void* BoosterHandle;

namespace {

std::mutex g_init_mutex;
// lightgbm_tpu_torch.c_embed module; atomic so the lock-free fast path is a
// well-defined acquire read against the GIL-held publishing store
std::atomic<PyObject*> g_glue{nullptr};
thread_local std::string g_last_error = "everything is fine";

bool ensure_python() {
  // fast path: a stale null just takes the slow path
  if (g_glue.load(std::memory_order_acquire) != nullptr) return true;
  {
    // interpreter bootstrap only — do NOT hold this mutex while
    // acquiring the GIL, or a GIL-holding caller racing first-time
    // init deadlocks (lock-order inversion)
    std::lock_guard<std::mutex> lock(g_init_mutex);
    if (!Py_IsInitialized()) {
      Py_InitializeEx(0);
      // release the init-time GIL or every later PyGILState_Ensure
      // from another thread (thread-pool consumers) deadlocks
      PyEval_SaveThread();
    }
  }
  PyGILState_STATE st = PyGILState_Ensure();
  if (g_glue.load(std::memory_order_relaxed) == nullptr) {
    // re-check under the GIL (it serializes importers)
    PyObject* mod = PyImport_ImportModule("lightgbm_tpu_torch.c_embed");
    if (mod == nullptr) {
      PyObject *t, *v, *tb;
      PyErr_Fetch(&t, &v, &tb);
      PyObject* s = v ? PyObject_Str(v) : nullptr;
      const char* msg = s ? PyUnicode_AsUTF8(s) : nullptr;
      if (msg == nullptr) {
        PyErr_Clear();           // AsUTF8 can fail on odd messages
        msg = "unknown";
      }
      g_last_error =
          std::string("cannot import lightgbm_tpu_torch.c_embed: ") + msg;
      Py_XDECREF(s); Py_XDECREF(t); Py_XDECREF(v); Py_XDECREF(tb);
    } else {
      g_glue.store(mod, std::memory_order_release);
    }
  }
  PyGILState_Release(st);
  return g_glue.load(std::memory_order_acquire) != nullptr;
}

void capture_error() {
  PyObject *t, *v, *tb;
  PyErr_Fetch(&t, &v, &tb);
  PyObject* s = v ? PyObject_Str(v) : nullptr;
  const char* msg = s ? PyUnicode_AsUTF8(s) : nullptr;
  if (msg == nullptr) {
    PyErr_Clear();               // AsUTF8 can fail on odd messages
    msg = "unknown python error";
  }
  g_last_error = msg;
  Py_XDECREF(s); Py_XDECREF(t); Py_XDECREF(v); Py_XDECREF(tb);
}

std::string join_params(
    const std::unordered_map<std::string, std::string>& m) {
  std::string out;
  for (const auto& kv : m) {
    if (!out.empty()) out += ' ';
    out += kv.first + "=" + kv.second;
  }
  return out;
}

// Call glue.<fn>(args...) with a Py_BuildValue format; returns the
// result object (new ref) or nullptr (error captured).
PyObject* call(const char* fn, const char* fmt, ...) {
  if (!ensure_python()) return nullptr;
  PyGILState_STATE st = PyGILState_Ensure();
  va_list ap;
  va_start(ap, fmt);
  PyObject* args = Py_VaBuildValue(fmt, ap);
  va_end(ap);
  PyObject* out = nullptr;
  if (args != nullptr) {
    PyObject* f = PyObject_GetAttrString(
        g_glue.load(std::memory_order_acquire), fn);
    if (f != nullptr) {
      out = PyObject_CallObject(f, args);
      Py_DECREF(f);
    }
    Py_DECREF(args);
  }
  if (out == nullptr) capture_error();
  PyGILState_Release(st);
  return out;
}

int call_void(const char* fn, const char* fmt, ...) {
  if (!ensure_python()) return -1;
  PyGILState_STATE st = PyGILState_Ensure();
  va_list ap;
  va_start(ap, fmt);
  PyObject* args = Py_VaBuildValue(fmt, ap);
  va_end(ap);
  PyObject* out = nullptr;
  if (args != nullptr) {
    PyObject* f = PyObject_GetAttrString(
        g_glue.load(std::memory_order_acquire), fn);
    if (f != nullptr) {
      out = PyObject_CallObject(f, args);
      Py_DECREF(f);
    }
    Py_DECREF(args);
  }
  int rc = 0;
  if (out == nullptr) {
    capture_error();
    rc = -1;
  }
  Py_XDECREF(out);
  PyGILState_Release(st);
  return rc;
}

// Result -> C long (handles, lengths); -1 + error on failure.
long long as_ll(PyObject* obj) {
  if (obj == nullptr) return -1;
  PyGILState_STATE st = PyGILState_Ensure();
  long long v = PyLong_AsLongLong(obj);
  if (PyErr_Occurred()) { capture_error(); v = -1; }
  Py_DECREF(obj);
  PyGILState_Release(st);
  return v;
}

}  // namespace

LIGHTGBM_C_EXPORT const char* LGBM_GetLastError() {
  return g_last_error.c_str();
}

// --- Dataset ---------------------------------------------------------------

LIGHTGBM_C_EXPORT int LGBM_DatasetCreateFromCSR(
    const void* indptr, int indptr_type, const int32_t* indices,
    const void* data, int data_type, int64_t nindptr, int64_t nelem,
    int64_t num_col,
    const std::unordered_map<std::string, std::string> parameters,
    const DatasetHandle reference, DatasetHandle* out) {
  long long h = as_ll(call(
      "dataset_from_csr", "(KiKKiLLLsK)",
      (unsigned long long)(uintptr_t)indptr, indptr_type,
      (unsigned long long)(uintptr_t)indices,
      (unsigned long long)(uintptr_t)data, data_type,
      (long long)nindptr, (long long)nelem, (long long)num_col,
      join_params(parameters).c_str(),
      (unsigned long long)(uintptr_t)reference));
  if (h < 0) return -1;
  *out = (DatasetHandle)(uintptr_t)h;
  return 0;
}

LIGHTGBM_C_EXPORT int LGBM_DatasetCreateFromMat(
    const void* data, int data_type, int32_t nrow, int32_t ncol,
    int is_row_major,
    const std::unordered_map<std::string, std::string> parameters,
    const DatasetHandle reference, DatasetHandle* out) {
  long long h = as_ll(call(
      "dataset_from_mat", "(KiiiisK)",
      (unsigned long long)(uintptr_t)data, data_type, (int)nrow,
      (int)ncol, is_row_major, join_params(parameters).c_str(),
      (unsigned long long)(uintptr_t)reference));
  if (h < 0) return -1;
  *out = (DatasetHandle)(uintptr_t)h;
  return 0;
}

LIGHTGBM_C_EXPORT int LGBM_DatasetCreateFromFile(
    const char* filename, const char* parameters,
    const DatasetHandle reference, DatasetHandle* out) {
  long long h = as_ll(call(
      "dataset_from_file", "(ssK)", filename, parameters,
      (unsigned long long)(uintptr_t)reference));
  if (h < 0) return -1;
  *out = (DatasetHandle)(uintptr_t)h;
  return 0;
}

LIGHTGBM_C_EXPORT int LGBM_DatasetSetField(
    DatasetHandle handle, const char* field_name, const void* field_data,
    int num_element, int type) {
  return call_void("dataset_set_field", "(KsKii)",
                   (unsigned long long)(uintptr_t)handle, field_name,
                   (unsigned long long)(uintptr_t)field_data,
                   num_element, type);
}

LIGHTGBM_C_EXPORT int LGBM_DatasetGetNumData(DatasetHandle handle,
                                             int* out) {
  long long v = as_ll(call("dataset_num_data", "(K)",
                           (unsigned long long)(uintptr_t)handle));
  if (v < 0) return -1;
  *out = (int)v;
  return 0;
}

LIGHTGBM_C_EXPORT int LGBM_DatasetGetNumFeature(DatasetHandle handle,
                                                int* out) {
  long long v = as_ll(call("dataset_num_feature", "(K)",
                           (unsigned long long)(uintptr_t)handle));
  if (v < 0) return -1;
  *out = (int)v;
  return 0;
}

LIGHTGBM_C_EXPORT int LGBM_DatasetFree(DatasetHandle handle) {
  return call_void("free_handle", "(K)",
                   (unsigned long long)(uintptr_t)handle);
}

// --- Booster ---------------------------------------------------------------

LIGHTGBM_C_EXPORT int LGBM_BoosterCreate(
    const DatasetHandle train_data,
    std::unordered_map<std::string, std::string> parameters,
    BoosterHandle* out) {
  long long h = as_ll(call(
      "booster_create", "(Ks)",
      (unsigned long long)(uintptr_t)train_data,
      join_params(parameters).c_str()));
  if (h < 0) return -1;
  *out = (BoosterHandle)(uintptr_t)h;
  return 0;
}

LIGHTGBM_C_EXPORT int LGBM_BoosterCreateFromModelfile(
    const char* filename, int* out_num_iterations, BoosterHandle* out) {
  long long h = as_ll(call(
      "booster_from_modelfile", "(sK)", filename,
      (unsigned long long)(uintptr_t)out_num_iterations));
  if (h < 0) return -1;
  *out = (BoosterHandle)(uintptr_t)h;
  return 0;
}

LIGHTGBM_C_EXPORT int LGBM_BoosterFree(BoosterHandle handle) {
  return call_void("free_handle", "(K)",
                   (unsigned long long)(uintptr_t)handle);
}

LIGHTGBM_C_EXPORT int LGBM_BoosterMerge(BoosterHandle handle,
                                        BoosterHandle other_handle) {
  return call_void("booster_merge", "(KK)",
                   (unsigned long long)(uintptr_t)handle,
                   (unsigned long long)(uintptr_t)other_handle);
}

LIGHTGBM_C_EXPORT int LGBM_BoosterAddValidData(
    BoosterHandle handle, const DatasetHandle valid_data) {
  return call_void("booster_add_valid", "(KK)",
                   (unsigned long long)(uintptr_t)handle,
                   (unsigned long long)(uintptr_t)valid_data);
}

LIGHTGBM_C_EXPORT int LGBM_BoosterUpdateOneIter(BoosterHandle handle,
                                                int* is_finished) {
  return call_void("booster_update", "(KK)",
                   (unsigned long long)(uintptr_t)handle,
                   (unsigned long long)(uintptr_t)is_finished);
}

LIGHTGBM_C_EXPORT int LGBM_BoosterRefit(BoosterHandle handle,
                                        const int32_t* leaf_preds,
                                        int32_t nrow, int32_t ncol) {
  return call_void("booster_refit", "(KKii)",
                   (unsigned long long)(uintptr_t)handle,
                   (unsigned long long)(uintptr_t)leaf_preds,
                   (int)nrow, (int)ncol);
}

LIGHTGBM_C_EXPORT int LGBM_BoosterCalcNumPredict(
    BoosterHandle handle, int num_row, int predict_type,
    int num_iteration, int64_t* out_len) {
  long long v = as_ll(call("booster_calc_num_predict", "(Kiii)",
                           (unsigned long long)(uintptr_t)handle,
                           num_row, predict_type, num_iteration));
  if (v < 0) return -1;
  *out_len = (int64_t)v;
  return 0;
}

LIGHTGBM_C_EXPORT int LGBM_BoosterGetEval(BoosterHandle handle,
                                          int data_idx, int* out_len,
                                          double* out_results) {
  long long v = as_ll(call("booster_get_eval", "(KiK)",
                           (unsigned long long)(uintptr_t)handle,
                           data_idx,
                           (unsigned long long)(uintptr_t)out_results));
  if (v < 0) return -1;
  *out_len = (int)v;
  return 0;
}

LIGHTGBM_C_EXPORT int LGBM_BoosterPredictForCSR(
    BoosterHandle handle, const void* indptr, int indptr_type,
    const int32_t* indices, const void* data, int data_type,
    int64_t nindptr, int64_t nelem, int64_t num_col, int predict_type,
    int num_iteration,
    std::unordered_map<std::string, std::string> parameter,
    int64_t* out_len, double* out_result) {
  long long v = as_ll(call(
      "booster_predict_csr", "(KKiKKiLLLiisK)",
      (unsigned long long)(uintptr_t)handle,
      (unsigned long long)(uintptr_t)indptr, indptr_type,
      (unsigned long long)(uintptr_t)indices,
      (unsigned long long)(uintptr_t)data, data_type,
      (long long)nindptr, (long long)nelem, (long long)num_col,
      predict_type, num_iteration, join_params(parameter).c_str(),
      (unsigned long long)(uintptr_t)out_result));
  if (v < 0) return -1;
  *out_len = (int64_t)v;
  return 0;
}

LIGHTGBM_C_EXPORT int LGBM_BoosterPredictForMat(
    BoosterHandle handle, const void* data, int data_type, int32_t nrow,
    int32_t ncol, int is_row_major, int predict_type, int num_iteration,
    std::unordered_map<std::string, std::string> parameter,
    int64_t* out_len, double* out_result) {
  long long v = as_ll(call(
      "booster_predict_mat", "(KKiiiiiisK)",
      (unsigned long long)(uintptr_t)handle,
      (unsigned long long)(uintptr_t)data, data_type, (int)nrow,
      (int)ncol, is_row_major, predict_type, num_iteration,
      join_params(parameter).c_str(),
      (unsigned long long)(uintptr_t)out_result));
  if (v < 0) return -1;
  *out_len = (int64_t)v;
  return 0;
}

LIGHTGBM_C_EXPORT int LGBM_BoosterSaveModel(BoosterHandle handle,
                                            int start_iteration,
                                            int num_iteration,
                                            const char* filename) {
  return call_void("booster_save_model", "(Kiis)",
                   (unsigned long long)(uintptr_t)handle,
                   start_iteration, num_iteration, filename);
}

// ---------------------------------------------------------------------------
// Plain-C parameter forms.
//
// The fork's c_api.h passes parameters as C++ std::unordered_map BY
// VALUE in four entry points — fine for a C++ translation unit that
// includes the header, but uncallable through a pure-C FFI (JNI
// RegisterNatives, Java's Panama FFM, ctypes, dlsym users). These
// variants take the upstream LightGBM convention instead — a single
// "key=value key2=value2" C string. Same handles, same glue.
// ---------------------------------------------------------------------------

LIGHTGBM_C_EXPORT int LGBM_DatasetCreateFromMatC(
    const void* data, int data_type, int32_t nrow, int32_t ncol,
    int is_row_major, const char* parameters,
    const DatasetHandle reference, DatasetHandle* out) {
  long long h = as_ll(call(
      "dataset_from_mat", "(KiiiisK)",
      (unsigned long long)(uintptr_t)data, data_type, (int)nrow,
      (int)ncol, is_row_major, parameters ? parameters : "",
      (unsigned long long)(uintptr_t)reference));
  if (h < 0) return -1;
  *out = (DatasetHandle)(uintptr_t)h;
  return 0;
}

LIGHTGBM_C_EXPORT int LGBM_BoosterCreateC(
    const DatasetHandle train_data, const char* parameters,
    BoosterHandle* out) {
  long long h = as_ll(call(
      "booster_create", "(Ks)",
      (unsigned long long)(uintptr_t)train_data,
      parameters ? parameters : ""));
  if (h < 0) return -1;
  *out = (BoosterHandle)(uintptr_t)h;
  return 0;
}

LIGHTGBM_C_EXPORT int LGBM_BoosterPredictForMatC(
    BoosterHandle handle, const void* data, int data_type, int32_t nrow,
    int32_t ncol, int is_row_major, int predict_type, int num_iteration,
    const char* parameter, int64_t* out_len, double* out_result) {
  long long v = as_ll(call(
      "booster_predict_mat", "(KKiiiiiisK)",
      (unsigned long long)(uintptr_t)handle,
      (unsigned long long)(uintptr_t)data, data_type, (int)nrow,
      (int)ncol, is_row_major, predict_type, num_iteration,
      parameter ? parameter : "",
      (unsigned long long)(uintptr_t)out_result));
  if (v < 0) return -1;
  *out_len = (int64_t)v;
  return 0;
}

LIGHTGBM_C_EXPORT int LGBM_BoosterPredictForCSRC(
    BoosterHandle handle, const void* indptr, int indptr_type,
    const int32_t* indices, const void* data, int data_type,
    int64_t nindptr, int64_t nelem, int64_t num_col, int predict_type,
    int num_iteration, const char* parameter,
    int64_t* out_len, double* out_result) {
  long long v = as_ll(call(
      "booster_predict_csr", "(KKiKKiLLLiisK)",
      (unsigned long long)(uintptr_t)handle,
      (unsigned long long)(uintptr_t)indptr, indptr_type,
      (unsigned long long)(uintptr_t)indices,
      (unsigned long long)(uintptr_t)data, data_type,
      (long long)nindptr, (long long)nelem, (long long)num_col,
      predict_type, num_iteration, parameter ? parameter : "",
      (unsigned long long)(uintptr_t)out_result));
  if (v < 0) return -1;
  *out_len = (int64_t)v;
  return 0;
}
