// dali_tpu_torch C API (dali_tpu.h; the surface of dali_tpu's capi.cc, DALI's
// c_api_2).
//
// Embeds CPython: each pipeline handle owns a dali_tpu_torch Pipeline built by
// Pipeline.deserialize, on the card unless the document's params name the
// CPU. daliTpuRun copies every output to host numpy once (a device output in
// one device-to-host copy of its padded tensor); the sample calls read those
// arrays. Every entry point takes the GIL, so it may be called from any
// thread, and from a Python process through ctypes (the interpreter that is
// running is used; otherwise daliTpuInit starts one).
//
// Built by build.py with two definitions: DALI_TPU_TORCH_PYTHON, the Python
// executable that built the library (an interpreter the library starts takes
// its environment, a virtualenv's packages included), and DALI_TPU_TORCH_ROOT,
// the checkout holding dali_tpu_torch (put first on sys.path).

#include <Python.h>  // first, as the Python headers require

#include <atomic>
#include <cstring>
#include <mutex>
#include <string>

#include "dali_tpu.h"

namespace {

thread_local std::string g_last_error;

struct PipelineHandle {
  PyObject* pipeline = nullptr;      // dali_tpu_torch.Pipeline
  PyObject* last_outputs = nullptr;  // list (per output) of lists of numpy arrays
};

void set_error_from_python() {
  PyObject *type, *value, *tb;
  PyErr_Fetch(&type, &value, &tb);
  g_last_error = "unknown python error";
  if (value) {
    PyObject* s = PyObject_Str(value);
    const char* u = s ? PyUnicode_AsUTF8(s) : nullptr;
    if (u) g_last_error = u;
    Py_XDECREF(s);
  }
  PyErr_Clear();
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(tb);
}

class Gil {
 public:
  Gil() : state_(PyGILState_Ensure()) {}
  ~Gil() { PyGILState_Release(state_); }

 private:
  PyGILState_STATE state_;
};

std::atomic<bool> g_initialized{false};
std::mutex g_init_mutex;  // serializes the first bring-up of the interpreter

constexpr int kMaxDims = 16;  // daliTpuTensorInfo.shape

// Compile a Python helper once, into a private globals dict; the function
// keeps its globals alive through __globals__ and is cached for the process.
PyObject* cached_helper(const char* src, const char* fname, PyObject** cache) {
  if (*cache) return *cache;
  PyObject* g = PyDict_New();
  if (!g) return nullptr;
  PyDict_SetItemString(g, "__builtins__", PyEval_GetBuiltins());
  PyObject* code = PyRun_String(src, Py_file_input, g, g);
  if (!code) {
    Py_DECREF(g);
    return nullptr;
  }
  Py_DECREF(code);
  PyObject* fn = PyDict_GetItemString(g, fname);  // borrowed
  Py_XINCREF(fn);
  Py_DECREF(g);
  *cache = fn;
  return fn;
}

bool start_interpreter() {
  PyConfig config;
  PyConfig_InitPythonConfig(&config);
  config.install_signal_handlers = 0;
  PyStatus st = PyConfig_SetBytesString(&config, &config.program_name, DALI_TPU_TORCH_PYTHON);
  if (!PyStatus_Exception(st)) st = Py_InitializeFromConfig(&config);
  PyConfig_Clear(&config);
  if (PyStatus_Exception(st)) {
    g_last_error = std::string("starting Python failed: ") + (st.err_msg ? st.err_msg : "");
    return false;
  }
  return true;
}

// import dali_tpu_torch, with the checkout first on sys.path
bool import_port() {
  PyObject* sys_path = PySys_GetObject("path");  // borrowed
  PyObject* root = PyUnicode_FromString(DALI_TPU_TORCH_ROOT);
  if (!sys_path || !root) {
    Py_XDECREF(root);
    set_error_from_python();
    return false;
  }
  const int present = PySequence_Contains(sys_path, root);
  const bool ok = present > 0 || (present == 0 && PyList_Insert(sys_path, 0, root) == 0);
  Py_DECREF(root);
  PyObject* mod = ok ? PyImport_ImportModule("dali_tpu_torch") : nullptr;
  if (!mod) {
    set_error_from_python();
    return false;
  }
  Py_DECREF(mod);
  return true;
}

PipelineHandle* handle_of(daliTpuPipeline handle) {
  auto* h = static_cast<PipelineHandle*>(handle);
  return h && h->pipeline ? h : nullptr;
}

// borrowed; nullptr (no Python error set) when out of range or before a run
PyObject* get_sample(PipelineHandle* h, int output, int sample) {
  if (!h->last_outputs || output < 0 || output >= PyList_GET_SIZE(h->last_outputs))
    return nullptr;
  PyObject* out = PyList_GET_ITEM(h->last_outputs, output);
  if (sample < 0 || sample >= PyList_GET_SIZE(out)) return nullptr;
  return PyList_GET_ITEM(out, sample);
}

}  // namespace

extern "C" {

daliTpuResult daliTpuInit(void) {
  if (g_initialized.load(std::memory_order_acquire)) return DALI_TPU_OK;
  std::lock_guard<std::mutex> lock(g_init_mutex);
  if (g_initialized.load(std::memory_order_acquire)) return DALI_TPU_OK;
  const bool we_started = !Py_IsInitialized();
  if (we_started && !start_interpreter()) return DALI_TPU_ERROR;
  bool ok;
  {
    Gil gil;
    ok = import_port();
  }
  // Py_InitializeFromConfig leaves the GIL held by this thread: release it
  // so that other threads' PyGILState_Ensure calls can take it
  if (we_started) PyEval_SaveThread();
  if (!ok) return DALI_TPU_ERROR;
  g_initialized.store(true, std::memory_order_release);
  return DALI_TPU_OK;
}

const char* daliTpuGetLastError(void) { return g_last_error.c_str(); }

daliTpuResult daliTpuCreatePipeline(daliTpuPipeline* handle, const char* serialized_json,
                                    size_t len) {
  if (daliTpuInit() != DALI_TPU_OK) return DALI_TPU_ERROR;
  Gil gil;
  PyObject* mod = PyImport_ImportModule("dali_tpu_torch");
  PyObject* cls = mod ? PyObject_GetAttrString(mod, "Pipeline") : nullptr;
  PyObject* payload = cls ? PyUnicode_FromStringAndSize(serialized_json, len) : nullptr;
  PyObject* pipe = payload ? PyObject_CallMethod(cls, "deserialize", "O", payload) : nullptr;
  Py_XDECREF(payload);
  Py_XDECREF(cls);
  Py_XDECREF(mod);
  if (!pipe) {
    set_error_from_python();
    return DALI_TPU_ERROR;
  }
  PyObject* built = PyObject_CallMethod(pipe, "build", nullptr);
  if (!built) {
    set_error_from_python();
    Py_DECREF(pipe);
    return DALI_TPU_ERROR;
  }
  Py_DECREF(built);
  auto* h = new PipelineHandle();
  h->pipeline = pipe;
  *handle = h;
  return DALI_TPU_OK;
}

daliTpuResult daliTpuRun(daliTpuPipeline handle) {
  PipelineHandle* h = handle_of(handle);
  if (!h) return DALI_TPU_INVALID_HANDLE;
  Gil gil;
  static PyObject* collect_fn = nullptr;
  PyObject* fn = cached_helper(
      "import numpy as _np\n"
      "def _collect(pipe):\n"
      "    res = []\n"
      "    for tl in pipe.run():\n"
      "        tl = tl.as_cpu() if hasattr(tl, 'as_cpu') else tl\n"
      "        res.append([_np.ascontiguousarray(tl.at(i)) for i in range(len(tl))])\n"
      "    return res\n",
      "_collect", &collect_fn);
  PyObject* result = fn ? PyObject_CallFunctionObjArgs(fn, h->pipeline, nullptr) : nullptr;
  if (!result) {
    set_error_from_python();
    return DALI_TPU_ERROR;
  }
  Py_XDECREF(h->last_outputs);
  h->last_outputs = result;
  return DALI_TPU_OK;
}

daliTpuResult daliTpuOutputCount(daliTpuPipeline handle, int* count) {
  PipelineHandle* h = handle_of(handle);
  if (!h) return DALI_TPU_INVALID_HANDLE;
  Gil gil;
  if (!h->last_outputs) {
    g_last_error = "no outputs: call daliTpuRun first";
    return DALI_TPU_ERROR;
  }
  *count = static_cast<int>(PyList_GET_SIZE(h->last_outputs));
  return DALI_TPU_OK;
}

daliTpuResult daliTpuBatchSize(daliTpuPipeline handle, int* batch_size) {
  PipelineHandle* h = handle_of(handle);
  if (!h) return DALI_TPU_INVALID_HANDLE;
  Gil gil;
  PyObject* bs = PyObject_GetAttrString(h->pipeline, "max_batch_size");
  if (!bs) {
    set_error_from_python();
    return DALI_TPU_ERROR;
  }
  *batch_size = static_cast<int>(PyLong_AsLong(bs));
  Py_DECREF(bs);
  return DALI_TPU_OK;
}

daliTpuResult daliTpuOutputInfo(daliTpuPipeline handle, int output, int sample,
                                daliTpuTensorInfo* info) {
  PipelineHandle* h = handle_of(handle);
  if (!h) return DALI_TPU_INVALID_HANDLE;
  Gil gil;
  PyObject* arr = get_sample(h, output, sample);
  if (!arr) {
    g_last_error = "invalid output/sample index (or run not called)";
    return DALI_TPU_ERROR;
  }
  Py_buffer view;
  if (PyObject_GetBuffer(arr, &view, PyBUF_ND) != 0) {
    set_error_from_python();
    return DALI_TPU_ERROR;
  }
  if (view.ndim > kMaxDims) {
    // never report a rank the 16-slot shape array cannot carry
    PyBuffer_Release(&view);
    g_last_error = "sample rank exceeds daliTpuTensorInfo's 16 dims";
    return DALI_TPU_ERROR;
  }
  info->ndim = view.ndim;
  for (int i = 0; i < view.ndim; i++) info->shape[i] = view.shape[i];
  info->nbytes = view.len;
  PyBuffer_Release(&view);
  // the DALIDataType of the sample (types.from_numpy_type); -1 where it has none
  info->dtype = -1;
  PyObject* types_mod = PyImport_ImportModule("dali_tpu_torch.types");
  PyObject* dt = PyObject_GetAttrString(arr, "dtype");
  PyObject* v = types_mod && dt ? PyObject_CallMethod(types_mod, "from_numpy_type", "O", dt)
                                : nullptr;
  if (v) {
    const long code = PyLong_AsLong(v);
    if (!(code == -1 && PyErr_Occurred())) info->dtype = static_cast<int32_t>(code);
  }
  PyErr_Clear();  // no pending exception may reach the next call into Python
  Py_XDECREF(v);
  Py_XDECREF(dt);
  Py_XDECREF(types_mod);
  return DALI_TPU_OK;
}

daliTpuResult daliTpuCopyOutputSample(daliTpuPipeline handle, int output, int sample, void* dst,
                                      size_t dst_bytes) {
  PipelineHandle* h = handle_of(handle);
  if (!h) return DALI_TPU_INVALID_HANDLE;
  Gil gil;
  PyObject* arr = get_sample(h, output, sample);
  if (!arr) {
    g_last_error = "invalid output/sample index (or run not called)";
    return DALI_TPU_ERROR;
  }
  Py_buffer view;
  if (PyObject_GetBuffer(arr, &view, PyBUF_C_CONTIGUOUS) != 0) {
    set_error_from_python();
    return DALI_TPU_ERROR;
  }
  if (static_cast<size_t>(view.len) > dst_bytes) {
    PyBuffer_Release(&view);
    g_last_error = "destination buffer too small";
    return DALI_TPU_BUFFER_TOO_SMALL;
  }
  std::memcpy(dst, view.buf, view.len);
  PyBuffer_Release(&view);
  return DALI_TPU_OK;
}

daliTpuResult daliTpuOutputSampleData(daliTpuPipeline handle, int output, int sample,
                                      const void** data, daliTpuTensorInfo* info) {
  PipelineHandle* h = handle_of(handle);
  if (!h) return DALI_TPU_INVALID_HANDLE;
  {
    Gil gil;
    PyObject* arr = get_sample(h, output, sample);
    if (!arr) {
      g_last_error = "invalid output/sample index (or run not called)";
      return DALI_TPU_ERROR;
    }
    // the array is C-contiguous and owned by last_outputs until the next
    // run or destroy, so its buffer outlives the released view
    Py_buffer view;
    if (PyObject_GetBuffer(arr, &view, PyBUF_C_CONTIGUOUS) != 0) {
      set_error_from_python();
      return DALI_TPU_ERROR;
    }
    *data = view.buf;
    PyBuffer_Release(&view);
  }
  return info ? daliTpuOutputInfo(handle, output, sample, info) : DALI_TPU_OK;
}

daliTpuResult daliTpuFeedInput(daliTpuPipeline handle, const char* name, const void* data,
                               const daliTpuTensorInfo* infos, int n_samples, const char* layout) {
  PipelineHandle* h = handle_of(handle);
  if (!h) return DALI_TPU_INVALID_HANDLE;
  if (!name || (n_samples > 0 && (!data || !infos)) || n_samples < 0) {
    g_last_error = "daliTpuFeedInput: null name, data or infos";
    return DALI_TPU_ERROR;
  }
  size_t total = 0;
  for (int i = 0; i < n_samples; i++) {
    if (infos[i].ndim < 0 || infos[i].ndim > kMaxDims || infos[i].nbytes < 0) {
      g_last_error = "daliTpuFeedInput: sample ndim outside [0, 16] or negative nbytes";
      return DALI_TPU_ERROR;
    }
    total += static_cast<size_t>(infos[i].nbytes);
  }
  Gil gil;
  // per-sample numpy arrays copied out of the caller's buffer, each of the
  // size its shape and dtype give (numpy raises past the buffer's end)
  static PyObject* feed_fn = nullptr;
  PyObject* fn = cached_helper(
      "import numpy as _np\n"
      "import dali_tpu_torch.types as _dt\n"
      "def _feed(pipe, name, blob, shapes, dtypes, layout):\n"
      "    pos = 0\n"
      "    samples = []\n"
      "    for shape, dt in zip(shapes, dtypes):\n"
      "        npdt = _np.dtype(_dt.to_numpy_type(_dt.DALIDataType(dt))) \\\n"
      "            if dt >= 0 else _np.dtype(_np.uint8)\n"
      "        count = int(_np.prod(shape))\n"
      "        a = _np.frombuffer(blob, npdt, count, pos).reshape(shape).copy()\n"
      "        pos += count * npdt.itemsize\n"
      "        samples.append(a)\n"
      "    pipe.feed_input(name, samples, layout=layout or None)\n",
      "_feed", &feed_fn);
  if (!fn) {
    set_error_from_python();
    return DALI_TPU_ERROR;
  }
  PyObject* shapes = PyList_New(n_samples);
  PyObject* dtypes = PyList_New(n_samples);
  for (int i = 0; shapes && dtypes && i < n_samples; i++) {
    const daliTpuTensorInfo& ti = infos[i];
    PyObject* shp = PyTuple_New(ti.ndim);
    for (int d = 0; shp && d < ti.ndim; d++)
      PyTuple_SET_ITEM(shp, d, PyLong_FromLongLong(ti.shape[d]));
    PyList_SET_ITEM(shapes, i, shp);
    PyList_SET_ITEM(dtypes, i, PyLong_FromLong(ti.dtype));
  }
  PyObject* blob = PyMemoryView_FromMemory(
      const_cast<char*>(static_cast<const char*>(data ? data : "")), total, PyBUF_READ);
  PyObject* pyname = PyUnicode_FromString(name);
  PyObject* pylayout = PyUnicode_FromString(layout ? layout : "");
  PyObject* result = shapes && dtypes && blob && pyname && pylayout
                         ? PyObject_CallFunctionObjArgs(fn, h->pipeline, pyname, blob, shapes,
                                                        dtypes, pylayout, nullptr)
                         : nullptr;
  Py_XDECREF(pyname);
  Py_XDECREF(pylayout);
  Py_XDECREF(blob);
  Py_XDECREF(shapes);
  Py_XDECREF(dtypes);
  if (!result) {
    set_error_from_python();
    return DALI_TPU_ERROR;
  }
  Py_DECREF(result);
  return DALI_TPU_OK;
}

daliTpuResult daliTpuCheckpoint(daliTpuPipeline handle, char* dst, size_t dst_bytes,
                                size_t* required) {
  PipelineHandle* h = handle_of(handle);
  if (!h) return DALI_TPU_INVALID_HANDLE;
  Gil gil;
  PyObject* payload = PyObject_CallMethod(h->pipeline, "checkpoint", nullptr);
  Py_ssize_t n = 0;
  const char* s = payload ? PyUnicode_AsUTF8AndSize(payload, &n) : nullptr;
  if (!s) {
    Py_XDECREF(payload);
    set_error_from_python();
    return DALI_TPU_ERROR;
  }
  if (required) *required = static_cast<size_t>(n) + 1;
  if (!dst || dst_bytes < static_cast<size_t>(n) + 1) {
    Py_DECREF(payload);
    if (!dst) return DALI_TPU_OK;
    g_last_error = "destination buffer too small";
    return DALI_TPU_BUFFER_TOO_SMALL;
  }
  std::memcpy(dst, s, n + 1);
  Py_DECREF(payload);
  return DALI_TPU_OK;
}

daliTpuResult daliTpuRestoreCheckpoint(daliTpuPipeline handle, const char* payload, size_t len) {
  PipelineHandle* h = handle_of(handle);
  if (!h) return DALI_TPU_INVALID_HANDLE;
  Gil gil;
  PyObject* py = PyUnicode_FromStringAndSize(payload, len);
  PyObject* r = py ? PyObject_CallMethod(h->pipeline, "restore_checkpoint", "O", py) : nullptr;
  Py_XDECREF(py);
  if (!r) {
    set_error_from_python();
    return DALI_TPU_ERROR;
  }
  Py_DECREF(r);
  return DALI_TPU_OK;
}

daliTpuResult daliTpuReaderSize(daliTpuPipeline handle, const char* reader_name, int64_t* size) {
  PipelineHandle* h = handle_of(handle);
  if (!h) return DALI_TPU_INVALID_HANDLE;
  Gil gil;
  PyObject* meta = PyObject_CallMethod(h->pipeline, "reader_meta", "s", reader_name);
  if (!meta) {
    set_error_from_python();
    return DALI_TPU_ERROR;
  }
  PyObject* sz = PyDict_Check(meta) ? PyDict_GetItemString(meta, "epoch_size") : nullptr;
  *size = sz ? PyLong_AsLongLong(sz) : -1;
  PyErr_Clear();
  Py_DECREF(meta);
  return DALI_TPU_OK;
}

daliTpuResult daliTpuDestroyPipeline(daliTpuPipeline handle) {
  PipelineHandle* h = handle_of(handle);
  if (!h) return DALI_TPU_INVALID_HANDLE;
  {
    Gil gil;
    Py_XDECREF(h->last_outputs);
    PyObject* r = PyObject_CallMethod(h->pipeline, "shutdown", nullptr);
    if (!r) PyErr_Clear();
    Py_XDECREF(r);
    Py_DECREF(h->pipeline);
  }
  delete h;
  return DALI_TPU_OK;
}

}  // extern "C"
