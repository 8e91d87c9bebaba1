/* fastmutate: one-crossing per-op mutate for the roaring write path.
 *
 * Copy of the JAX package's native/fastmutate.c for pilosa_tpu_torch
 * (the module is renamed so both packages can load theirs in one
 * process). The per-op SetBit serving shape runs container mutate + WAL
 * record build through a single CPython-extension call instead of
 * ~15-25 us of interpreted numpy per op; a ctypes boundary's per-call
 * overhead loses at container sizes.
 *
 * This is NOT a parallel data structure: the functions operate on the
 * live pilosa_tpu_torch.storage.roaring.Bitmap object graph (keys list,
 * Container slots, numpy buffers) under the GIL, preserving every
 * invariant the Python implementation maintains — version counter,
 * serialization-table dirty set, copy-on-write guards, the n<=4096
 * array rule, run-buffer non-adjacency. Anything unusual (new
 * container, mapped/COW-stale bitmap words, odd dtypes) BAILS by
 * returning None and the caller re-runs the op through the pure-Python
 * path, so behavior is bit-for-bit identical by construction.
 *
 * Entry points (module pilosa_torch_fastmutate):
 *   setbit(bitmap, pos)   -> None (bail) | False (no change)
 *                            | bytes (13-byte WAL add record)
 *   clearbit(bitmap, pos) -> None | False | bytes (remove record)
 *
 * The returned bytes are the marshaled op record (type, u64 LE value,
 * FNV-1a32 of the first 9 bytes — roaring.Op.marshal), so Python only
 * appends them to the group-commit WAL. All three container kinds are
 * handled: sorted-u32 array (copy-insert/delete into a fresh buffer),
 * u64[1024] bitmap (in-place word set/clear when the COW epoch allows),
 * and wire-form u16 run buffers (interval extend/merge/split/trim,
 * always a fresh buffer — run buffers are never mutated in place).
 * Representation conversions at the 4096/2047 thresholds call back
 * into Container._maybe_convert (rare, and the Python logic is the
 * single source of truth for them).
 */

#define NPY_NO_DEPRECATED_API NPY_1_7_API_VERSION
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <numpy/arrayobject.h>
#include <stdint.h>
#include <string.h>

#define ARRAY_MAX_SIZE 4096
#define RUN_MAX_SIZE 2047
#define OP_ADD 0
#define OP_REMOVE 1

static PyObject *s_keys, *s_containers, *s_version, *s_table,
    *s_table_dirty, *s_cow_epoch, *s_array, *s_bitmap, *s_runs, *s_n,
    *s_mapped, *s_cow, *s_maybe_convert;

/* ---- small helpers -------------------------------------------------------- */

static PyObject* wal_record(int typ, uint64_t pos) {
    PyObject* b = PyBytes_FromStringAndSize(NULL, 13);
    if (!b) return NULL;
    uint8_t* rec = (uint8_t*)PyBytes_AS_STRING(b);
    rec[0] = (uint8_t)typ;
    memcpy(rec + 1, &pos, 8); /* little-endian host (loader-gated) */
    uint32_t h = 2166136261u;
    for (int i = 0; i < 9; i++) h = (h ^ rec[i]) * 16777619u;
    memcpy(rec + 9, &h, 4);
    return b;
}

/* attr as int64; -1 with error set on failure */
static int get_i64(PyObject* o, PyObject* name, int64_t* out) {
    PyObject* v = PyObject_GetAttr(o, name);
    if (!v) return -1;
    *out = PyLong_AsLongLong(v);
    Py_DECREF(v);
    if (*out == -1 && PyErr_Occurred()) return -1;
    return 0;
}

static int set_i64(PyObject* o, PyObject* name, int64_t v) {
    PyObject* pv = PyLong_FromLongLong(v);
    if (!pv) return -1;
    int rc = PyObject_SetAttr(o, name, pv);
    Py_DECREF(pv);
    return rc;
}

static int bump_version(PyObject* bm) {
    int64_t v;
    if (get_i64(bm, s_version, &v) < 0) return -1;
    return set_i64(bm, s_version, v + 1);
}

/* Mirror of Bitmap._add/_remove's table upkeep: point mutations park
 * their container key in _table_dirty for bulk patching. */
static int note_dirty(PyObject* bm, uint64_t key) {
    PyObject* table = PyObject_GetAttr(bm, s_table);
    if (!table) return -1;
    int is_none = (table == Py_None);
    Py_DECREF(table);
    if (is_none) return 0;
    PyObject* dirty = PyObject_GetAttr(bm, s_table_dirty);
    if (!dirty) return -1;
    PyObject* k = PyLong_FromUnsignedLongLong(key);
    if (!k) { Py_DECREF(dirty); return -1; }
    int rc = PySet_Add(dirty, k);
    Py_DECREF(k);
    Py_DECREF(dirty);
    return rc;
}

static int call_maybe_convert(PyObject* c) {
    PyObject* r = PyObject_CallMethodNoArgs(c, s_maybe_convert);
    if (!r) return -1;
    Py_DECREF(r);
    return 0;
}

/* usable 1-d C-contiguous aligned numpy array of the given type, or
 * NULL (no error set) when the buffer is anything else — caller bails */
static PyArrayObject* usable(PyObject* o, int typenum) {
    if (!PyArray_Check(o)) return NULL;
    PyArrayObject* a = (PyArrayObject*)o;
    if (PyArray_TYPE(a) != typenum || PyArray_NDIM(a) != 1
        || !PyArray_ISCARRAY_RO(a))
        return NULL;
    return a;
}

/* ---- per-kind mutate ------------------------------------------------------ */
/* Each returns: 0 = no change, 1 = changed, 2 = bail, -1 = error.  */

static int mutate_array(PyObject* c, PyArrayObject* arr, uint16_t v,
                        int is_set) {
    int64_t n = PyArray_DIM(arr, 0);
    const uint32_t* data = (const uint32_t*)PyArray_DATA(arr);
    int64_t lo = 0, hi = n;
    while (lo < hi) {
        int64_t mid = (lo + hi) >> 1;
        if (data[mid] < v) lo = mid + 1; else hi = mid;
    }
    int present = lo < n && data[lo] == v;
    if (is_set ? present : !present) return 0;
    npy_intp dims[1] = { is_set ? n + 1 : n - 1 };
    PyObject* grown = PyArray_SimpleNew(1, dims, NPY_UINT32);
    if (!grown) return -1;
    uint32_t* out = (uint32_t*)PyArray_DATA((PyArrayObject*)grown);
    if (is_set) {
        memcpy(out, data, lo * 4);
        out[lo] = v;
        memcpy(out + lo + 1, data + lo, (n - lo) * 4);
    } else {
        memcpy(out, data, lo * 4);
        memcpy(out + lo, data + lo + 1, (n - lo - 1) * 4);
    }
    int rc = PyObject_SetAttr(c, s_array, grown);
    Py_DECREF(grown);
    if (rc < 0) return -1;
    if (PyObject_SetAttr(c, s_mapped, Py_False) < 0) return -1;
    int64_t new_n = is_set ? n + 1 : n - 1;
    if (set_i64(c, s_n, new_n) < 0) return -1;
    if (is_set && new_n > ARRAY_MAX_SIZE && call_maybe_convert(c) < 0)
        return -1;
    return 1;
}

static int mutate_bitmap(PyObject* bm, PyObject* c, PyArrayObject* words,
                         uint16_t v, int is_set) {
    /* In-place word mutation is only safe when the buffer is neither
     * mmap-backed nor captured by a frozen snapshot — otherwise bail
     * and let Python's _guard_inplace copy first. */
    PyObject* mapped = PyObject_GetAttr(c, s_mapped);
    if (!mapped) return -1;
    int is_mapped = PyObject_IsTrue(mapped);
    Py_DECREF(mapped);
    if (is_mapped) return 2;
    int64_t cow, epoch;
    if (get_i64(c, s_cow, &cow) < 0
        || get_i64(bm, s_cow_epoch, &epoch) < 0) return -1;
    if (cow != epoch) return 2;
    if (PyArray_DIM(words, 0) != 1024) return 2;
    uint64_t* w = (uint64_t*)PyArray_DATA(words);
    uint64_t bit = 1ULL << (v & 63);
    int64_t n;
    if (is_set) {
        if (w[v >> 6] & bit) return 0;
        w[v >> 6] |= bit;
        if (get_i64(c, s_n, &n) < 0 || set_i64(c, s_n, n + 1) < 0)
            return -1;
        return 1;
    }
    if (!(w[v >> 6] & bit)) return 0;
    w[v >> 6] &= ~bit;
    if (get_i64(c, s_n, &n) < 0 || set_i64(c, s_n, n - 1) < 0) return -1;
    if (n - 1 <= ARRAY_MAX_SIZE && call_maybe_convert(c) < 0) return -1;
    return 1;
}

/* Build a fresh run buffer (run buffers are never mutated in place —
 * that keeps mmap'd and frozen captures safe with no COW tokens). */
static int store_runs(PyObject* c, const uint16_t* runs, int64_t n_runs,
                      int64_t delta_n) {
    npy_intp dims[1] = { 1 + 2 * n_runs };
    PyObject* buf = PyArray_SimpleNew(1, dims, NPY_UINT16);
    if (!buf) return -1;
    uint16_t* out = (uint16_t*)PyArray_DATA((PyArrayObject*)buf);
    out[0] = (uint16_t)n_runs;
    memcpy(out + 1, runs, n_runs * 4);
    int rc = PyObject_SetAttr(c, s_runs, buf);
    Py_DECREF(buf);
    if (rc < 0) return -1;
    if (PyObject_SetAttr(c, s_mapped, Py_False) < 0) return -1;
    int64_t n;
    if (get_i64(c, s_n, &n) < 0 || set_i64(c, s_n, n + delta_n) < 0)
        return -1;
    if (n_runs > RUN_MAX_SIZE && call_maybe_convert(c) < 0) return -1;
    return 1;
}

static int mutate_runs(PyObject* c, PyArrayObject* rbuf, uint16_t v,
                       int is_set) {
    int64_t len = PyArray_DIM(rbuf, 0);
    const uint16_t* b = (const uint16_t*)PyArray_DATA(rbuf);
    if (len < 1) return 2;
    int64_t R = b[0];
    if (len != 1 + 2 * R) return 2; /* malformed: let Python raise */
    /* i = last run whose start <= v (searchsorted right - 1) */
    int64_t lo = 0, hi = R;
    while (lo < hi) {
        int64_t mid = (lo + hi) >> 1;
        if (b[1 + 2 * mid] <= v) lo = mid + 1; else hi = mid;
    }
    int64_t i = lo - 1;
    uint32_t start_i = 0, end_i = 0; /* end exclusive */
    if (i >= 0) {
        start_i = b[1 + 2 * i];
        end_i = start_i + b[2 + 2 * i] + 1;
    }
    /* scratch: worst case R+1 runs of (start, len-1) pairs */
    uint16_t stack[2 * 64 + 2];
    uint16_t* scratch = stack;
    PyObject* heap = NULL;
    if (2 * (R + 1) > (int64_t)(sizeof(stack) / sizeof(stack[0]))) {
        heap = PyBytes_FromStringAndSize(NULL, (R + 1) * 4);
        if (!heap) return -1;
        scratch = (uint16_t*)PyBytes_AS_STRING(heap);
    }
    int rc;
    if (is_set) {
        if (i >= 0 && v < end_i) { Py_XDECREF(heap); return 0; }
        int join_prev = i >= 0 && (uint32_t)v == end_i;
        int join_next = i + 1 < R && (uint32_t)v + 1 == b[1 + 2 * (i + 1)];
        int64_t out_R;
        memcpy(scratch, b + 1, R * 4);
        if (join_prev && join_next) {
            /* merge runs i and i+1 across v */
            uint32_t next_start = b[1 + 2 * (i + 1)];
            uint32_t next_len1 = b[2 + 2 * (i + 1)];
            /* merged covers start_i .. next_start+next_len1, so its
             * len-1 is (next_start - start_i) + next_len1 */
            scratch[2 * i + 1] =
                (uint16_t)((next_start - start_i) + next_len1);
            memmove(scratch + 2 * (i + 1), scratch + 2 * (i + 2),
                    (R - i - 2) * 4);
            out_R = R - 1;
        } else if (join_prev) {
            scratch[2 * i + 1] = (uint16_t)(b[2 + 2 * i] + 1);
            out_R = R;
        } else if (join_next) {
            scratch[2 * (i + 1)] = (uint16_t)(v);
            scratch[2 * (i + 1) + 1] = (uint16_t)(b[2 + 2 * (i + 1)] + 1);
            out_R = R;
        } else {
            memmove(scratch + 2 * (i + 2), scratch + 2 * (i + 1),
                    (R - i - 1) * 4);
            scratch[2 * (i + 1)] = v;
            scratch[2 * (i + 1) + 1] = 0;
            out_R = R + 1;
        }
        rc = store_runs(c, scratch, out_R, +1);
    } else {
        if (i < 0 || v >= end_i) { Py_XDECREF(heap); return 0; }
        int64_t out_R;
        memcpy(scratch, b + 1, R * 4);
        if (end_i - start_i == 1) {
            memmove(scratch + 2 * i, scratch + 2 * (i + 1),
                    (R - i - 1) * 4);
            out_R = R - 1;
        } else if (v == start_i) {
            scratch[2 * i] = (uint16_t)(start_i + 1);
            scratch[2 * i + 1] = (uint16_t)(b[2 + 2 * i] - 1);
            out_R = R;
        } else if ((uint32_t)v == end_i - 1) {
            scratch[2 * i + 1] = (uint16_t)(b[2 + 2 * i] - 1);
            out_R = R;
        } else {
            memmove(scratch + 2 * (i + 2), scratch + 2 * (i + 1),
                    (R - i - 1) * 4);
            scratch[2 * i + 1] = (uint16_t)(v - start_i - 1);
            scratch[2 * (i + 1)] = (uint16_t)(v + 1);
            scratch[2 * (i + 1) + 1] = (uint16_t)(end_i - v - 2);
            out_R = R + 1;
        }
        rc = store_runs(c, scratch, out_R, -1);
    }
    Py_XDECREF(heap);
    return rc;
}

/* ---- the one crossing ----------------------------------------------------- */

static PyObject* mutate(PyObject* bm, uint64_t pos, int is_set) {
    uint64_t key = pos >> 16;
    uint16_t v = (uint16_t)(pos & 0xFFFF);

    PyObject* keys = PyObject_GetAttr(bm, s_keys);
    if (!keys) return NULL;
    if (!PyList_CheckExact(keys)) { Py_DECREF(keys); Py_RETURN_NONE; }
    Py_ssize_t nk = PyList_GET_SIZE(keys);
    Py_ssize_t lo = 0, hi = nk;
    while (lo < hi) {
        Py_ssize_t mid = (lo + hi) >> 1;
        uint64_t kv = PyLong_AsUnsignedLongLong(PyList_GET_ITEM(keys, mid));
        if (kv == (uint64_t)-1 && PyErr_Occurred()) {
            Py_DECREF(keys);
            return NULL;
        }
        if (kv < key) lo = mid + 1; else hi = mid;
    }
    int found = 0;
    if (lo < nk) {
        uint64_t kv = PyLong_AsUnsignedLongLong(PyList_GET_ITEM(keys, lo));
        if (kv == (uint64_t)-1 && PyErr_Occurred()) {
            Py_DECREF(keys);
            return NULL;
        }
        found = kv == key;
    }
    Py_DECREF(keys);
    if (!found) {
        if (is_set) Py_RETURN_NONE; /* new container: Python creates it */
        /* remove against an absent container: a no-op, but _remove
         * bumps the version before discovering that — mirror it */
        if (bump_version(bm) < 0) return NULL;
        Py_RETURN_FALSE;
    }

    PyObject* containers = PyObject_GetAttr(bm, s_containers);
    if (!containers) return NULL;
    if (!PyList_CheckExact(containers) || lo >= PyList_GET_SIZE(containers)) {
        Py_DECREF(containers);
        Py_RETURN_NONE;
    }
    PyObject* c = PyList_GET_ITEM(containers, lo);
    Py_INCREF(c);
    Py_DECREF(containers);

    /* classify the container kind; bail on any unusual buffer */
    PyObject* runs_o = PyObject_GetAttr(c, s_runs);
    if (!runs_o) { Py_DECREF(c); return NULL; }
    PyObject* bitmap_o = NULL;
    PyObject* array_o = NULL;
    int rc = 2;
    if (runs_o != Py_None) {
        PyArrayObject* rbuf = usable(runs_o, NPY_UINT16);
        if (rbuf) {
            if (bump_version(bm) < 0 || note_dirty(bm, key) < 0)
                rc = -1;
            else
                rc = mutate_runs(c, rbuf, v, is_set);
        }
    } else {
        bitmap_o = PyObject_GetAttr(c, s_bitmap);
        if (!bitmap_o) { Py_DECREF(runs_o); Py_DECREF(c); return NULL; }
        if (bitmap_o != Py_None) {
            PyArrayObject* words = usable(bitmap_o, NPY_UINT64);
            if (words) {
                /* safety pre-check happens inside (bails BEFORE any
                 * side effect so the Python fallback replays cleanly) */
                PyObject* mapped = PyObject_GetAttr(c, s_mapped);
                if (!mapped) rc = -1;
                else {
                    int m = PyObject_IsTrue(mapped);
                    Py_DECREF(mapped);
                    int64_t cow = 0, epoch = 0;
                    if (m < 0 || get_i64(c, s_cow, &cow) < 0
                        || get_i64(bm, s_cow_epoch, &epoch) < 0)
                        rc = -1;
                    else if (m || cow != epoch)
                        rc = 2; /* COW copy needed: Python path */
                    else if (bump_version(bm) < 0
                             || note_dirty(bm, key) < 0)
                        rc = -1;
                    else
                        rc = mutate_bitmap(bm, c, words, v, is_set);
                }
            }
        } else {
            array_o = PyObject_GetAttr(c, s_array);
            if (!array_o) {
                Py_DECREF(runs_o);
                Py_DECREF(c);
                return NULL;
            }
            PyArrayObject* arr = usable(array_o, NPY_UINT32);
            if (arr) {
                if (bump_version(bm) < 0 || note_dirty(bm, key) < 0)
                    rc = -1;
                else
                    rc = mutate_array(c, arr, v, is_set);
            }
        }
    }
    Py_DECREF(runs_o);
    Py_XDECREF(bitmap_o);
    Py_XDECREF(array_o);
    Py_DECREF(c);
    if (rc < 0) return NULL;
    if (rc == 2) Py_RETURN_NONE;
    if (rc == 0) Py_RETURN_FALSE;
    return wal_record(is_set ? OP_ADD : OP_REMOVE, pos);
}

static PyObject* py_setbit(PyObject* self, PyObject* const* args,
                           Py_ssize_t nargs) {
    (void)self;
    if (nargs != 2) {
        PyErr_SetString(PyExc_TypeError, "setbit(bitmap, pos)");
        return NULL;
    }
    uint64_t pos = PyLong_AsUnsignedLongLong(args[1]);
    if (pos == (uint64_t)-1 && PyErr_Occurred()) return NULL;
    return mutate(args[0], pos, 1);
}

static PyObject* py_clearbit(PyObject* self, PyObject* const* args,
                             Py_ssize_t nargs) {
    (void)self;
    if (nargs != 2) {
        PyErr_SetString(PyExc_TypeError, "clearbit(bitmap, pos)");
        return NULL;
    }
    uint64_t pos = PyLong_AsUnsignedLongLong(args[1]);
    if (pos == (uint64_t)-1 && PyErr_Occurred()) return NULL;
    return mutate(args[0], pos, 0);
}

/* Batch WAL-record build for the bulk-import lane: 13-byte checksummed
 * records for a whole position vector in one crossing, GIL RELEASED —
 * concurrent wire-import threads build their blobs in parallel while
 * another thread applies (the numpy _wal_blob fallback held the GIL
 * for its nine u32 vector passes). */
static PyObject* py_wal_records(PyObject* self, PyObject* const* args,
                                Py_ssize_t nargs) {
    (void)self;
    if (nargs != 2) {
        PyErr_SetString(PyExc_TypeError, "wal_records(values, typ)");
        return NULL;
    }
    PyArrayObject* a = usable(args[0], NPY_UINT64);
    if (!a) {
        PyErr_SetString(PyExc_TypeError,
                        "wal_records: need 1-d C-contiguous u64 array");
        return NULL;
    }
    long typ = PyLong_AsLong(args[1]);
    if (typ == -1 && PyErr_Occurred()) return NULL;
    npy_intp n = PyArray_DIM(a, 0);
    PyObject* b = PyBytes_FromStringAndSize(NULL, n * 13);
    if (!b) return NULL;
    uint8_t* out = (uint8_t*)PyBytes_AS_STRING(b);
    const uint64_t* vals = (const uint64_t*)PyArray_DATA(a);
    Py_BEGIN_ALLOW_THREADS
    for (npy_intp i = 0; i < n; i++) {
        uint8_t* rec = out + i * 13;
        rec[0] = (uint8_t)typ;
        uint64_t pos = vals[i];
        memcpy(rec + 1, &pos, 8); /* little-endian host (loader-gated) */
        uint32_t h = 2166136261u;
        for (int j = 0; j < 9; j++) h = (h ^ rec[j]) * 16777619u;
        memcpy(rec + 9, &h, 4);
    }
    Py_END_ALLOW_THREADS
    return b;
}

static PyMethodDef methods[] = {
    {"setbit", (PyCFunction)(void*)py_setbit, METH_FASTCALL,
     "setbit(bitmap, pos) -> None (bail) | False | 13-byte WAL record"},
    {"clearbit", (PyCFunction)(void*)py_clearbit, METH_FASTCALL,
     "clearbit(bitmap, pos) -> None (bail) | False | 13-byte WAL record"},
    {"wal_records", (PyCFunction)(void*)py_wal_records, METH_FASTCALL,
     "wal_records(u64 values, typ) -> marshaled 13-byte op records"},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "pilosa_torch_fastmutate",
    "One-crossing roaring point mutations (see fastmutate.c)", -1,
    methods, NULL, NULL, NULL, NULL,
};

PyMODINIT_FUNC PyInit_pilosa_torch_fastmutate(void) {
    import_array();
#define INTERN(var, name) \
    if (!(var = PyUnicode_InternFromString(name))) return NULL
    INTERN(s_keys, "keys");
    INTERN(s_containers, "containers");
    INTERN(s_version, "version");
    INTERN(s_table, "_table");
    INTERN(s_table_dirty, "_table_dirty");
    INTERN(s_cow_epoch, "_cow_epoch");
    INTERN(s_array, "array");
    INTERN(s_bitmap, "bitmap");
    INTERN(s_runs, "runs");
    INTERN(s_n, "n");
    INTERN(s_mapped, "mapped");
    INTERN(s_cow, "cow");
    INTERN(s_maybe_convert, "_maybe_convert");
#undef INTERN
    return PyModule_Create(&moduledef);
}
