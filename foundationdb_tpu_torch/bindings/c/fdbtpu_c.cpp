// fdbtpu_c.cpp — C ABI over the embedded client runtime.
//
// Reference shape: REF:bindings/c/fdb_c.cpp.  The implementation hosts
// the client in an embedded CPython interpreter (the project's client is
// the Python/asyncio native client; pybind11 is not available in this
// image, so this speaks the raw CPython API).  When loaded INSIDE an
// already-running Python process (e.g. the ctypes binding layered over
// this ABI), the existing interpreter is reused instead of initializing
// a second one.
//
// Build: foundationdb_tpu_torch/native/build.py, target fdbtpu_c (links
// libpython), into foundationdb_tpu_torch/_build/libfdbtpu_c.so.  The
// host module is the port's client (foundationdb_tpu_torch.capi_host),
// which never touches the CUDA card.

#include "fdbtpu_c.h"

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>

struct FDBTPUTransaction {
    long long tid;
};

namespace {

PyObject* g_mod = nullptr;          // foundationdb_tpu_torch.capi_host
bool g_we_initialized = false;
std::mutex g_init_mutex;
PyThreadState* g_main_tstate = nullptr;

struct Gil {
    PyGILState_STATE st;
    Gil() : st(PyGILState_Ensure()) {}
    ~Gil() { PyGILState_Release(st); }
};

// Call host().<method>(args...) returning the PyObject* result (new ref)
PyObject* call_host(const char* method, PyObject* args) {
    PyObject* host_fn = PyObject_GetAttrString(g_mod, "host");
    if (!host_fn) return nullptr;
    PyObject* host = PyObject_CallNoArgs(host_fn);
    Py_DECREF(host_fn);
    if (!host) return nullptr;
    PyObject* bound = PyObject_GetAttrString(host, method);
    Py_DECREF(host);
    if (!bound) return nullptr;
    PyObject* out = PyObject_CallObject(bound, args);
    Py_DECREF(bound);
    return out;
}

fdbtpu_error_t err_from_python() {
    PyErr_Clear();
    return 4100;  // internal_error: the host returns codes, not raises
}

// Py_BuildValue "y#" turns a NULL pointer into None; zero-length keys
// (e.g. a scan from begin="") are legal, so give NULL/0 a real address.
inline const char* nz(const uint8_t* p) {
    static const char empty[1] = {0};
    return p ? (const char*)p : empty;
}

}  // namespace

extern "C" {

fdbtpu_error_t fdbtpu_init(const char* cluster_file_path) {
    std::lock_guard<std::mutex> lock(g_init_mutex);
    if (!Py_IsInitialized()) {
        Py_InitializeEx(0);
        g_we_initialized = true;
        // release the GIL acquired by initialization so worker threads
        // (and our PyGILState_Ensure calls) can take it
        g_main_tstate = PyEval_SaveThread();
    }
    Gil gil;
    if (!g_mod) {
        g_mod = PyImport_ImportModule("foundationdb_tpu_torch.capi_host");
        if (!g_mod) {
            PyErr_Print();
            return 4100;
        }
    }
    PyObject* r = PyObject_CallMethod(g_mod, "init", "s", cluster_file_path);
    if (!r) return err_from_python();
    long code = PyLong_AsLong(r);
    Py_DECREF(r);
    return (fdbtpu_error_t)code;
}

fdbtpu_error_t fdbtpu_stop(void) {
    if (!g_mod) return 0;
    Gil gil;
    PyObject* r = PyObject_CallMethod(g_mod, "stop", nullptr);
    if (!r) return err_from_python();
    Py_DECREF(r);
    return 0;
}

fdbtpu_error_t fdbtpu_create_transaction(FDBTPUTransaction** out) {
    Gil gil;
    PyObject* r = call_host("create_transaction", nullptr);
    if (!r) return err_from_python();
    long long tid = PyLong_AsLongLong(r);
    Py_DECREF(r);
    *out = new FDBTPUTransaction{tid};
    return 0;
}

void fdbtpu_transaction_destroy(FDBTPUTransaction* tr) {
    if (!tr) return;
    {
        Gil gil;
        PyObject* args = Py_BuildValue("(L)", tr->tid);
        PyObject* r = call_host("destroy_transaction", args);
        Py_XDECREF(args);
        Py_XDECREF(r);
        PyErr_Clear();
    }
    delete tr;
}

fdbtpu_error_t fdbtpu_transaction_get(FDBTPUTransaction* tr,
                                      const uint8_t* key, int key_length,
                                      int* out_present,
                                      uint8_t** out_value, int* out_length) {
    Gil gil;
    PyObject* args = Py_BuildValue("(Ly#)", tr->tid,
                                   nz(key), (Py_ssize_t)key_length);
    PyObject* r = call_host("txn_get", args);
    Py_XDECREF(args);
    if (!r) return err_from_python();
    long code;
    int present;
    const char* buf = nullptr;
    Py_ssize_t blen = 0;
    if (!PyArg_ParseTuple(r, "lpy#", &code, &present, &buf, &blen)) {
        Py_DECREF(r);
        return err_from_python();
    }
    *out_present = present;
    if (code == 0 && present) {
        *out_value = (uint8_t*)std::malloc(blen ? blen : 1);
        if (!*out_value) {
            *out_length = 0;
            Py_DECREF(r);
            return 1500;  /* platform_error: allocation failed */
        }
        std::memcpy(*out_value, buf, blen);
        *out_length = (int)blen;
    } else {
        *out_value = nullptr;
        *out_length = 0;
    }
    Py_DECREF(r);
    return (fdbtpu_error_t)code;
}

fdbtpu_error_t fdbtpu_transaction_set(FDBTPUTransaction* tr,
                                      const uint8_t* key, int key_length,
                                      const uint8_t* value, int value_length) {
    Gil gil;
    PyObject* args = Py_BuildValue("(Ly#y#)", tr->tid,
                                   nz(key), (Py_ssize_t)key_length,
                                   nz(value), (Py_ssize_t)value_length);
    PyObject* r = call_host("txn_set", args);
    Py_XDECREF(args);
    if (!r) return err_from_python();
    long code = PyLong_AsLong(r);
    Py_DECREF(r);
    return (fdbtpu_error_t)code;
}

fdbtpu_error_t fdbtpu_transaction_clear(FDBTPUTransaction* tr,
                                        const uint8_t* key, int key_length) {
    Gil gil;
    PyObject* args = Py_BuildValue("(Ly#)", tr->tid,
                                   nz(key), (Py_ssize_t)key_length);
    PyObject* r = call_host("txn_clear", args);
    Py_XDECREF(args);
    if (!r) return err_from_python();
    long code = PyLong_AsLong(r);
    Py_DECREF(r);
    return (fdbtpu_error_t)code;
}

fdbtpu_error_t fdbtpu_transaction_get_range(FDBTPUTransaction* tr,
                                            const uint8_t* begin,
                                            int begin_length,
                                            const uint8_t* end,
                                            int end_length,
                                            int limit, int reverse,
                                            uint8_t** out_buf,
                                            int* out_length,
                                            int* out_count) {
    Gil gil;
    PyObject* args = Py_BuildValue(
        "(Ly#y#ii)", tr->tid, nz(begin), (Py_ssize_t)begin_length,
        nz(end), (Py_ssize_t)end_length, limit, reverse);
    PyObject* r = call_host("txn_get_range", args);
    Py_XDECREF(args);
    if (!r) return err_from_python();
    long code;
    const char* buf = nullptr;
    Py_ssize_t blen = 0;
    int count = 0;
    if (!PyArg_ParseTuple(r, "ly#i", &code, &buf, &blen, &count)) {
        Py_DECREF(r);
        return err_from_python();
    }
    if (code == 0) {
        *out_buf = (uint8_t*)std::malloc(blen ? blen : 1);
        if (!*out_buf) {
            *out_length = 0;
            *out_count = 0;
            Py_DECREF(r);
            return 1500;  /* platform_error: allocation failed */
        }
        std::memcpy(*out_buf, buf, blen);
        *out_length = (int)blen;
        *out_count = count;
    } else {
        *out_buf = nullptr;
        *out_length = 0;
        *out_count = 0;
    }
    Py_DECREF(r);
    return (fdbtpu_error_t)code;
}

fdbtpu_error_t fdbtpu_transaction_atomic_op(FDBTPUTransaction* tr, int op,
                                            const uint8_t* key,
                                            int key_length,
                                            const uint8_t* operand,
                                            int operand_length) {
    Gil gil;
    PyObject* args = Py_BuildValue(
        "(Liy#y#)", tr->tid, op, nz(key), (Py_ssize_t)key_length,
        nz(operand), (Py_ssize_t)operand_length);
    PyObject* r = call_host("txn_atomic_op", args);
    Py_XDECREF(args);
    if (!r) return err_from_python();
    long code = PyLong_AsLong(r);
    Py_DECREF(r);
    return (fdbtpu_error_t)code;
}

fdbtpu_error_t fdbtpu_transaction_get_read_version(FDBTPUTransaction* tr,
                                                   int64_t* out_version) {
    Gil gil;
    PyObject* args = Py_BuildValue("(L)", tr->tid);
    PyObject* r = call_host("txn_get_read_version", args);
    Py_XDECREF(args);
    if (!r) return err_from_python();
    long code;
    long long ver;
    if (!PyArg_ParseTuple(r, "lL", &code, &ver)) {
        Py_DECREF(r);
        return err_from_python();
    }
    Py_DECREF(r);
    if (out_version) *out_version = ver;
    return (fdbtpu_error_t)code;
}

fdbtpu_error_t fdbtpu_transaction_set_option(FDBTPUTransaction* tr,
                                             const char* option) {
    Gil gil;
    PyObject* args = Py_BuildValue("(Ls)", tr->tid, option);
    PyObject* r = call_host("txn_set_option", args);
    Py_XDECREF(args);
    if (!r) return err_from_python();
    long code = PyLong_AsLong(r);
    Py_DECREF(r);
    return (fdbtpu_error_t)code;
}

fdbtpu_error_t fdbtpu_transaction_commit(FDBTPUTransaction* tr,
                                         int64_t* out_committed_version) {
    Gil gil;
    PyObject* args = Py_BuildValue("(L)", tr->tid);
    PyObject* r = call_host("txn_commit", args);
    Py_XDECREF(args);
    if (!r) return err_from_python();
    long code;
    long long ver;
    if (!PyArg_ParseTuple(r, "lL", &code, &ver)) {
        Py_DECREF(r);
        return err_from_python();
    }
    Py_DECREF(r);
    if (out_committed_version) *out_committed_version = ver;
    return (fdbtpu_error_t)code;
}

fdbtpu_error_t fdbtpu_transaction_on_error(FDBTPUTransaction* tr,
                                           fdbtpu_error_t code) {
    Gil gil;
    PyObject* args = Py_BuildValue("(Li)", tr->tid, (int)code);
    PyObject* r = call_host("txn_on_error", args);
    Py_XDECREF(args);
    if (!r) return err_from_python();
    long rc = PyLong_AsLong(r);
    Py_DECREF(r);
    return (fdbtpu_error_t)rc;
}

fdbtpu_error_t fdbtpu_transaction_reset(FDBTPUTransaction* tr) {
    Gil gil;
    PyObject* args = Py_BuildValue("(L)", tr->tid);
    PyObject* r = call_host("txn_reset", args);
    Py_XDECREF(args);
    if (!r) return err_from_python();
    Py_DECREF(r);
    return 0;
}

void fdbtpu_free(uint8_t* ptr) { std::free(ptr); }

const char* fdbtpu_get_error(fdbtpu_error_t code) {
    static thread_local std::string msg;
    if (code == 0) return "success";
    if (!g_mod) return "unknown_error";
    Gil gil;
    PyObject* r = PyObject_CallMethod(g_mod, "error_message", "i", (int)code);
    if (!r) {
        PyErr_Clear();
        return "unknown_error";
    }
    const char* s = PyUnicode_AsUTF8(r);
    msg = s ? s : "unknown_error";
    Py_DECREF(r);
    return msg.c_str();
}

}  // extern "C"
