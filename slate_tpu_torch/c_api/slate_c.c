/* slate_tpu_torch C API implementation: CPython embedding shim
 * (counterpart of slate_tpu/c_api/slate_c.c).
 *
 * Reference analogue: src/c_api/wrappers.cc. All real work happens in
 * slate_tpu_torch/c_api/bridge.py; this file only (1) boots an
 * interpreter, (2) marshals scalar arguments and raw buffer addresses
 * into a bridge call, (3) converts the bridge's integer return into
 * the info code. Buffers never cross the boundary as Python objects:
 * the bridge maps the addresses with ctypes, so there is no numpy
 * C-API coupling. The platform (the device) travels to the bridge as
 * an argument of bridge.set_platform; no environment variable is set.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <pthread.h>
#include <stdint.h>

#include "slate_c.h"

static PyObject* g_bridge = NULL;
static pthread_mutex_t g_init_lock = PTHREAD_MUTEX_INITIALIZER;

static int ensure_init(const char* platform) {
    /* serialize first-time initialization: concurrent first calls from
     * multiple threads must not double-run Py_InitializeEx /
     * PyEval_SaveThread (undefined behavior in CPython). The g_bridge
     * read happens only under the mutex: an unlocked fast-path read
     * would be a C11 data race against the write below. */
    pthread_mutex_lock(&g_init_lock);
    if (g_bridge != NULL) {
        pthread_mutex_unlock(&g_init_lock);
        return 0;
    }
    int py_was_up = Py_IsInitialized();
    if (!py_was_up) {
        Py_InitializeEx(0);
        /* release the GIL acquired by initialization so slate_* can be
         * called from ANY thread (each call re-acquires via
         * PyGILState_Ensure; without this, a second thread deadlocks) */
        (void)PyEval_SaveThread();
    }
    /* when Python predates us (a host process that loaded this
     * library), its threads and its GIL are its own: we only take the
     * GIL for the import below */
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject* mod = PyImport_ImportModule("slate_tpu_torch.c_api.bridge");
    int rc = 0;
    if (mod == NULL) {
        PyErr_Print();
        PyErr_Clear();
        rc = -100;
    } else {
        g_bridge = mod;  /* hold the reference forever */
        if (platform != NULL) {
            /* the bridge applies the device at first driver use */
            PyObject* res = PyObject_CallMethod(mod, "set_platform",
                                                "s", platform);
            if (res == NULL) {
                PyErr_Print();
                PyErr_Clear();
                rc = -102;  /* distinct: platform could not be applied */
            }
            Py_XDECREF(res);
        }
    }
    PyGILState_Release(st);
    pthread_mutex_unlock(&g_init_lock);
    return rc;
}

int slate_tpu_init(const char* platform) {
    return ensure_init(platform);
}

/* Call bridge.<name>(args...) -> int info. fmt describes the argument
 * tuple; buffer addresses travel as unsigned long long ("K"). */
static int bridge_call(const char* name, const char* fmt, ...) {
    int rc = ensure_init(NULL);
    if (rc != 0) return rc;
    PyGILState_STATE st = PyGILState_Ensure();
    va_list ap;
    va_start(ap, fmt);
    PyObject* args = Py_VaBuildValue(fmt, ap);
    va_end(ap);
    int info = -101;
    if (args != NULL) {
        PyObject* fn = PyObject_GetAttrString(g_bridge, name);
        if (fn != NULL) {
            PyObject* res = PyObject_CallObject(fn, args);
            Py_DECREF(fn);
            if (res != NULL) {
                info = (int)PyLong_AsLong(res);
                Py_DECREF(res);
            } else {
                PyErr_Print();
                info = -102;
            }
        }
        Py_DECREF(args);
    }
    /* never leave a pending exception behind: the next bridge_call
     * would otherwise violate the CPython calling contract */
    if (PyErr_Occurred()) {
        PyErr_Print();
        PyErr_Clear();
    }
    PyGILState_Release(st);
    return info;
}

int slate_potrf(char dtype, int64_t n, void* a, int64_t lda) {
    return bridge_call("potrf", "(CLKL)", dtype, (long long)n,
                       (unsigned long long)(uintptr_t)a, (long long)lda);
}

int slate_gesv(char dtype, int64_t n, int64_t nrhs, void* a,
               int64_t lda, int32_t* ipiv, void* b, int64_t ldb) {
    return bridge_call("gesv", "(CLLKLKKL)", dtype, (long long)n,
                       (long long)nrhs,
                       (unsigned long long)(uintptr_t)a, (long long)lda,
                       (unsigned long long)(uintptr_t)ipiv,
                       (unsigned long long)(uintptr_t)b, (long long)ldb);
}

int slate_posv(char dtype, int64_t n, int64_t nrhs, void* a,
               int64_t lda, void* b, int64_t ldb) {
    return bridge_call("posv", "(CLLKLKL)", dtype, (long long)n,
                       (long long)nrhs,
                       (unsigned long long)(uintptr_t)a, (long long)lda,
                       (unsigned long long)(uintptr_t)b, (long long)ldb);
}

int slate_gemm(char dtype, int64_t m, int64_t n, int64_t k,
               double alpha, const void* a, int64_t lda,
               const void* b, int64_t ldb,
               double beta, void* c, int64_t ldc) {
    return bridge_call("gemm", "(CLLLdKLKLdKL)", dtype, (long long)m,
                       (long long)n, (long long)k, alpha,
                       (unsigned long long)(uintptr_t)a, (long long)lda,
                       (unsigned long long)(uintptr_t)b, (long long)ldb,
                       beta,
                       (unsigned long long)(uintptr_t)c, (long long)ldc);
}

int slate_gels(char dtype, int64_t m, int64_t n, int64_t nrhs,
               void* a, int64_t lda, void* b, int64_t ldb) {
    return bridge_call("gels", "(CLLLKLKL)", dtype, (long long)m,
                       (long long)n, (long long)nrhs,
                       (unsigned long long)(uintptr_t)a, (long long)lda,
                       (unsigned long long)(uintptr_t)b, (long long)ldb);
}

int slate_heev(char dtype, int64_t n, void* a, int64_t lda, void* w) {
    return bridge_call("heev", "(CLKLK)", dtype, (long long)n,
                       (unsigned long long)(uintptr_t)a, (long long)lda,
                       (unsigned long long)(uintptr_t)w);
}

int slate_svd_vals(char dtype, int64_t m, int64_t n, void* a,
                   int64_t lda, void* s) {
    return bridge_call("svd_vals", "(CLLKLK)", dtype, (long long)m,
                       (long long)n,
                       (unsigned long long)(uintptr_t)a, (long long)lda,
                       (unsigned long long)(uintptr_t)s);
}
