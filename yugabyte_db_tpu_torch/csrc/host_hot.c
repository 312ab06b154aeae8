/* host_hot — CPython extension for the per-op host hot path.
 *
 * The port's own copy of native/ybtpu_hot.c, logic unchanged: the same
 * rows, keys, bytes and error classes.  Only the module name differs
 * (host_hot, PyInit_host_hot, type names host_hot.*), so both
 * extensions load in one process and each type only ever receives the
 * objects of its own module.
 *
 * Build: g++ -O3 -shared -fPIC -I<Python include> (docdb/hotpath.py,
 * at first use, into build/host_hot/).
 *
 * Reference analog: the row materialization inside the DocDB point-read
 * path (src/yb/dockv/pg_row.cc PgTableRow::SetValue and the packed-row
 * decoders in src/yb/dockv/packed_row.cc) — the per-row work that the
 * reference does in C++ and a Python loop cannot do at OLTP rates.
 *
 * Exposes one type: Extractor. Built once per (table codec, columnar
 * block), it captures raw pointers into the block's numpy arrays (refs
 * held, buffers pinned via the buffer protocol) plus a decode plan, and
 * materializes row dicts with a single C call per point read.
 *
 * Column kinds in the plan:
 *   0 fixed-width value column   (values array + nulls array)
 *   1 varlen str value column    (ends uint32 + heap bytes + nulls)
 *   2 varlen bytes value column  (ends uint32 + heap bytes + nulls)
 *   3 fixed-width pk column      (values array, never null)
 *   4 missing column             (always None — added after version)
 * Fixed dtypes are passed as a single char: q=i64 i=i32 h=i16 b=i8
 * d=f64 f=f32 ?=bool Q=u64 I=u32.
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <float.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

typedef struct {
    PyObject *name;      /* interned column name */
    int kind;
    char dtype;          /* fixed kinds only */
    Py_buffer vals;      /* fixed: values; varlen: ends (uint32) */
    Py_buffer nulls;     /* null mask (uint8/bool), may be absent */
    Py_buffer heap;      /* varlen heap bytes */
    int has_vals, has_nulls, has_heap;
} ColPlan;

typedef struct {
    PyObject_HEAD
    Py_ssize_t ncols;
    Py_ssize_t nrows;
    ColPlan *cols;
} Extractor;

static void
Extractor_dealloc(Extractor *self)
{
    for (Py_ssize_t i = 0; i < self->ncols; i++) {
        ColPlan *c = &self->cols[i];
        Py_XDECREF(c->name);
        if (c->has_vals) PyBuffer_Release(&c->vals);
        if (c->has_nulls) PyBuffer_Release(&c->nulls);
        if (c->has_heap) PyBuffer_Release(&c->heap);
    }
    PyMem_Free(self->cols);
    Py_TYPE(self)->tp_free((PyObject *)self);
}

/* new Extractor(plan, nrows) — plan: list of
 * (name:str, kind:int, dtype:str1, values_or_ends, nulls, heap) */
static PyObject *
Extractor_new(PyTypeObject *type, PyObject *args, PyObject *kwds)
{
    PyObject *plan;
    Py_ssize_t nrows;
    if (!PyArg_ParseTuple(args, "On", &plan, &nrows))
        return NULL;
    if (!PyList_Check(plan)) {
        PyErr_SetString(PyExc_TypeError, "plan must be a list");
        return NULL;
    }
    Py_ssize_t n = PyList_GET_SIZE(plan);
    Extractor *self = (Extractor *)type->tp_alloc(type, 0);
    if (!self) return NULL;
    self->nrows = nrows;
    self->ncols = 0;
    self->cols = (ColPlan *)PyMem_Calloc(n, sizeof(ColPlan));
    if (!self->cols) { Py_DECREF(self); return PyErr_NoMemory(); }
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *t = PyList_GET_ITEM(plan, i);
        PyObject *name, *vals, *nulls, *heap;
        int kind;
        const char *dt;
        if (!PyArg_ParseTuple(t, "OisOOO", &name, &kind, &dt,
                              &vals, &nulls, &heap)) {
            Py_DECREF(self);
            return NULL;
        }
        ColPlan *c = &self->cols[i];
        c->name = name; Py_INCREF(name);
        c->kind = kind;
        c->dtype = dt[0] ? dt[0] : 'q';
        if (vals != Py_None) {
            if (PyObject_GetBuffer(vals, &c->vals, PyBUF_SIMPLE) < 0) {
                self->ncols = i + 1; Py_DECREF(self); return NULL;
            }
            c->has_vals = 1;
        }
        if (nulls != Py_None) {
            if (PyObject_GetBuffer(nulls, &c->nulls, PyBUF_SIMPLE) < 0) {
                self->ncols = i + 1; Py_DECREF(self); return NULL;
            }
            c->has_nulls = 1;
        }
        if (heap != Py_None) {
            if (PyObject_GetBuffer(heap, &c->heap, PyBUF_SIMPLE) < 0) {
                self->ncols = i + 1; Py_DECREF(self); return NULL;
            }
            c->has_heap = 1;
        }
        self->ncols = i + 1;
    }
    return (PyObject *)self;
}

static inline PyObject *
fixed_value(const ColPlan *c, Py_ssize_t pos)
{
    const char *p = (const char *)c->vals.buf;
    switch (c->dtype) {
    case 'q': return PyLong_FromLongLong(((const int64_t *)p)[pos]);
    case 'i': return PyLong_FromLong(((const int32_t *)p)[pos]);
    case 'h': return PyLong_FromLong(((const int16_t *)p)[pos]);
    case 'b': return PyLong_FromLong(((const int8_t *)p)[pos]);
    case 'Q': return PyLong_FromUnsignedLongLong(
                  ((const uint64_t *)p)[pos]);
    case 'I': return PyLong_FromUnsignedLong(((const uint32_t *)p)[pos]);
    case 'd': return PyFloat_FromDouble(((const double *)p)[pos]);
    case 'f': return PyFloat_FromDouble(((const float *)p)[pos]);
    case '?': {
        PyObject *r = ((const uint8_t *)p)[pos] ? Py_True : Py_False;
        Py_INCREF(r);
        return r;
    }
    default:
        PyErr_Format(PyExc_ValueError, "bad dtype %c", c->dtype);
        return NULL;
    }
}

/* core row materialization shared by extract() and PointReader */
/* want == NULL extracts every column; otherwise only columns whose
 * name is in `want` (a small tuple — identity-compare fast path makes
 * the membership test ~ns for interned names).  Projection in C keeps
 * short range scans (YCSB-E shape) from paying 10 string decodes per
 * row that the caller immediately throws away. */
static PyObject *
extract_row(Extractor *self, Py_ssize_t pos, PyObject *want)
{
    PyObject *out = _PyDict_NewPresized(self->ncols);
    if (!out) return NULL;
    for (Py_ssize_t i = 0; i < self->ncols; i++) {
        const ColPlan *c = &self->cols[i];
        PyObject *v = NULL;
        if (want) {
            int has = PySequence_Contains(want, c->name);
            if (has < 0) { Py_DECREF(out); return NULL; }
            if (!has) continue;
        }
        if (c->kind == 4 ||
            (c->has_nulls && ((const uint8_t *)c->nulls.buf)[pos])) {
            v = Py_None; Py_INCREF(v);
        } else if (c->kind == 0 || c->kind == 3) {
            v = fixed_value(c, pos);
        } else {  /* varlen: vals buffer = uint32 end offsets */
            const uint32_t *ends = (const uint32_t *)c->vals.buf;
            uint32_t lo = pos ? ends[pos - 1] : 0;
            uint32_t hi = ends[pos];
            const char *base = (const char *)c->heap.buf;
            v = (c->kind == 1)
                ? PyUnicode_DecodeUTF8(base + lo, hi - lo, "strict")
                : PyBytes_FromStringAndSize(base + lo, hi - lo);
        }
        if (!v || PyDict_SetItem(out, c->name, v) < 0) {
            Py_XDECREF(v);
            Py_DECREF(out);
            return NULL;
        }
        Py_DECREF(v);
    }
    return out;
}

/* extract(pos) -> dict */
static PyObject *
Extractor_extract(Extractor *self, PyObject *arg)
{
    Py_ssize_t pos = PyLong_AsSsize_t(arg);
    if (pos == -1 && PyErr_Occurred())
        return NULL;
    if (pos < 0 || pos >= self->nrows) {
        PyErr_Format(PyExc_IndexError, "row %zd out of range", pos);
        return NULL;
    }
    return extract_row(self, pos, NULL);
}

static PyMethodDef Extractor_methods[] = {
    {"extract", (PyCFunction)Extractor_extract, METH_O,
     "extract(pos) -> row dict"},
    {NULL}
};

static PyTypeObject ExtractorType = {
    PyVarObject_HEAD_INIT(NULL, 0)
    .tp_name = "host_hot.Extractor",
    .tp_basicsize = sizeof(Extractor),
    .tp_dealloc = (destructor)Extractor_dealloc,
    .tp_flags = Py_TPFLAGS_DEFAULT,
    .tp_doc = "per-(codec, block) point-read row extractor",
    .tp_methods = Extractor_methods,
    .tp_new = Extractor_new,
};

/* ---------------------------------------------------------------------
 * encode_doc_key(spec, values) -> bytes
 *
 * The DocKey prefix encoder (reference: src/yb/dockv/doc_key.cc
 * DocKey::Encode) — byte-identical to the Python
 * TableCodec.doc_key_prefix for the supported kinds. spec is built once
 * per codec: (cotable_id:i64 (-1 = none), num_hash:int, kinds:bytes,
 * descs:bytes). Kind codes: 0 int64, 1 int32, 2 double, 3 string,
 * 4 timestamp, 5 bytes. values is a tuple of per-column Python values
 * (None encodes kNull).
 */
#define VT_GROUP_END 0x03
#define VT_U16_HASH 0x08
#define VT_COTABLE 0x0A
#define VT_NULL 0x20
#define VT_INT32 0x24
#define VT_INT64 0x26
#define VT_DOUBLE 0x28
#define VT_STRING 0x2A
#define VT_TIMESTAMP 0x2C
#define VT_BYTES 0x2E
#define DESC_OFF 0x20
#define VT_NULL_DESC 0x5E

typedef struct {
    uint8_t *buf;
    Py_ssize_t len, cap;
} KeyBuf;

static int kb_reserve(KeyBuf *kb, Py_ssize_t extra)
{
    if (kb->len + extra <= kb->cap) return 0;
    Py_ssize_t ncap = kb->cap * 2 + extra + 64;
    uint8_t *nb = (uint8_t *)PyMem_Realloc(kb->buf, ncap);
    if (!nb) { PyErr_NoMemory(); return -1; }
    kb->buf = nb; kb->cap = ncap;
    return 0;
}

static inline void kb_put(KeyBuf *kb, uint8_t b) { kb->buf[kb->len++] = b; }

/* encode one entry; returns bytes appended or -1 */
static int
encode_entry(KeyBuf *kb, int kind, int desc, PyObject *v)
{
    if (v == Py_None) {
        /* match the Python encoder: NULL pk components are unsupported
         * (it raises) — erroring here routes to the same Python error */
        PyErr_SetString(PyExc_TypeError, "NULL key component");
        return -1;
    }
    if (kind == 0 || kind == 1 || kind == 4) {          /* ints */
        int width = (kind == 1) ? 4 : 8;
        uint8_t marker = (kind == 1) ? VT_INT32
                       : (kind == 4) ? VT_TIMESTAMP : VT_INT64;
        long long x = PyLong_AsLongLong(v);
        if (x == -1 && PyErr_Occurred()) return -1;
        if (width == 4 && (x < INT32_MIN || x > INT32_MAX)) {
            /* the Python encoder raises OverflowError here; silent
             * truncation would key a DIFFERENT row */
            PyErr_SetString(PyExc_OverflowError,
                            "int32 key component out of range");
            return -1;
        }
        uint64_t biased = (width == 8)
            ? (uint64_t)x + 0x8000000000000000ULL
            : (uint64_t)(uint32_t)((int64_t)x + 0x80000000LL);
        if (kb_reserve(kb, 1 + width) < 0) return -1;
        kb_put(kb, desc ? marker + DESC_OFF : marker);
        for (int i = width - 1; i >= 0; i--) {
            uint8_t b = (uint8_t)(biased >> (8 * i));
            kb_put(kb, desc ? (uint8_t)~b : b);
        }
        return 0;
    }
    if (kind == 2) {                                     /* double */
        double dv = PyFloat_AsDouble(v);
        if (dv == -1.0 && PyErr_Occurred()) return -1;
        uint64_t bits;
        memcpy(&bits, &dv, 8);
        if (bits & 0x8000000000000000ULL) bits = ~bits;
        else bits |= 0x8000000000000000ULL;
        if (kb_reserve(kb, 9) < 0) return -1;
        kb_put(kb, desc ? VT_DOUBLE + DESC_OFF : VT_DOUBLE);
        for (int i = 7; i >= 0; i--) {
            uint8_t b = (uint8_t)(bits >> (8 * i));
            kb_put(kb, desc ? (uint8_t)~b : b);
        }
        return 0;
    }
    if (kind == 3 || kind == 5) {                        /* string/bytes */
        const char *raw;
        Py_ssize_t rn;
        if (kind == 3) {
            raw = PyUnicode_AsUTF8AndSize(v, &rn);
            if (!raw) return -1;
        } else {
            if (PyBytes_AsStringAndSize(v, (char **)&raw, &rn) < 0)
                return -1;
        }
        if (kb_reserve(kb, 1 + 2 * rn + 2) < 0) return -1;
        kb_put(kb, desc ? ((kind == 3 ? VT_STRING : VT_BYTES) + DESC_OFF)
                        : (kind == 3 ? VT_STRING : VT_BYTES));
        for (Py_ssize_t i = 0; i < rn; i++) {
            uint8_t b = (uint8_t)raw[i];
            if (b == 0) {
                kb_put(kb, desc ? 0xFF : 0x00);
                kb_put(kb, desc ? 0xFE : 0x01);
            } else {
                kb_put(kb, desc ? (uint8_t)~b : b);
            }
        }
        kb_put(kb, desc ? 0xFF : 0x00);   /* terminator \x00\x00 */
        kb_put(kb, desc ? 0xFF : 0x00);
        return 0;
    }
    PyErr_Format(PyExc_ValueError, "bad key kind %d", kind);
    return -1;
}

static int
build_doc_key(long long cotable, int num_hash, const uint8_t *kk,
              const uint8_t *dd, Py_ssize_t ncols, PyObject *values,
              KeyBuf *kb)
{
    kb->len = 0;
    if (kb_reserve(kb, 16) < 0) return -1;
    if (cotable >= 0) {
        kb_put(kb, VT_COTABLE);
        for (int i = 3; i >= 0; i--)
            kb_put(kb, (uint8_t)((uint64_t)cotable >> (8 * i)));
    }
    if (num_hash > 0) {
        /* FNV-1a over the encoded hash entries, folded to 16 bits
         * (must agree bit-for-bit with dockv/partition.py) */
        Py_ssize_t hash_at = kb->len;
        kb_put(kb, VT_U16_HASH);
        kb_put(kb, 0); kb_put(kb, 0);       /* patched below */
        Py_ssize_t h0 = kb->len;
        for (int i = 0; i < num_hash; i++) {
            if (encode_entry(kb, kk[i], dd[i],
                             PyTuple_GET_ITEM(values, i)) < 0)
                return -1;
        }
        uint64_t h = 0xCBF29CE484222325ULL;
        for (Py_ssize_t i = h0; i < kb->len; i++)
            h = (h ^ kb->buf[i]) * 0x100000001B3ULL;
        h ^= h >> 32;
        uint16_t h16 = (uint16_t)(h & 0xFFFF);
        kb->buf[hash_at + 1] = (uint8_t)(h16 >> 8);
        kb->buf[hash_at + 2] = (uint8_t)(h16 & 0xFF);
        if (kb_reserve(kb, 1) < 0) return -1;
        kb_put(kb, VT_GROUP_END);
    }
    for (Py_ssize_t i = num_hash; i < ncols; i++) {
        if (encode_entry(kb, kk[i], dd[i],
                         PyTuple_GET_ITEM(values, i)) < 0)
            return -1;
    }
    if (kb_reserve(kb, 1) < 0) return -1;
    kb_put(kb, VT_GROUP_END);
    return 0;
}

static PyObject *
py_encode_doc_key(PyObject *mod, PyObject *args)
{
    long long cotable;
    int num_hash;
    Py_buffer kinds, descs;
    PyObject *values;
    if (!PyArg_ParseTuple(args, "(Liy*y*)O", &cotable, &num_hash,
                          &kinds, &descs, &values))
        return NULL;
    PyObject *result = NULL;
    KeyBuf kb = {NULL, 0, 0};
    if (!PyTuple_Check(values)) {
        PyErr_SetString(PyExc_TypeError, "values must be a tuple");
        goto done;
    }
    if (PyTuple_GET_SIZE(values) != kinds.len ||
        PyTuple_GET_SIZE(values) != descs.len) {
        PyErr_SetString(PyExc_ValueError, "spec/values length mismatch");
        goto done;
    }
    if (build_doc_key(cotable, num_hash, (const uint8_t *)kinds.buf,
                      (const uint8_t *)descs.buf,
                      PyTuple_GET_SIZE(values), values, &kb) < 0)
        goto done;
    result = PyBytes_FromStringAndSize((const char *)kb.buf, kb.len);
done:
    PyMem_Free(kb.buf);
    PyBuffer_Release(&kinds);
    PyBuffer_Release(&descs);
    return result;
}

/* ---------------------------------------------------------------------
 * fnv64(bytes) -> int — FNV-1a 64-bit, byte-exact with
 * storage/columnar.fnv64_bytes (the doc-key hash for blooms/dedup).
 */
static PyObject *
py_fnv64(PyObject *mod, PyObject *arg)
{
    Py_buffer b;
    if (PyObject_GetBuffer(arg, &b, PyBUF_SIMPLE) < 0)
        return NULL;
    uint64_t h = 0xCBF29CE484222325ULL;
    const uint8_t *p = (const uint8_t *)b.buf;
    for (Py_ssize_t i = 0; i < b.len; i++)
        h = (h ^ p[i]) * 0x100000001B3ULL;
    PyBuffer_Release(&b);
    return PyLong_FromUnsignedLongLong(h);
}

/* ---------------------------------------------------------------------
 * bloom_may_contain(bits, k, hash) -> bool — double-hash probe scheme,
 * bit-exact with storage/sst.BloomFilter.may_contain.
 */
static PyObject *
py_bloom_may_contain(PyObject *mod, PyObject *args)
{
    Py_buffer bits;
    int k;
    unsigned long long hash;
    if (!PyArg_ParseTuple(args, "y*iK", &bits, &k, &hash))
        return NULL;
    uint64_t m = (uint64_t)bits.len * 8;
    const uint8_t *bb = (const uint8_t *)bits.buf;
    uint64_t h1 = hash, h2 = (h1 >> 33) | 1;
    int hit = 1;
    for (int i = 0; i < k; i++) {
        uint64_t idx = (h1 + (uint64_t)i * h2) % m;
        if (!((bb[idx >> 3] >> (idx & 7)) & 1)) { hit = 0; break; }
    }
    PyBuffer_Release(&bits);
    return PyBool_FromLong(hit);
}

/* ---------------------------------------------------------------------
 * BlockFinder — fused point-lookup over one columnar block: binary
 * search of the fixed-width key matrix + the MVCC newest-visible walk
 * that sst.point_find did row-at-a-time in Python (reference analog:
 * BlockBasedTable::Get + DocDB visibility seek,
 * src/yb/docdb/doc_rowwise_iterator.cc).
 *
 * find(prefix, read_ht, restart_hi) returns:
 *   (pos, ht, write_id, tomb) — newest visible version row
 *   ht_int                    — restart: version in (read_ht, restart_hi]
 *   None                      — no visible version in this block
 * restart_hi < 0 disables restart detection.
 */
typedef struct {
    PyObject_HEAD
    Py_buffer keys;      /* [n, width] uint8 rows, lexicographically sorted */
    Py_buffer ht;        /* [n] uint64 */
    Py_buffer wid;       /* [n] uint32 */
    Py_buffer tomb;      /* [n] uint8/bool */
    Py_ssize_t n, width;
    int has_bufs;
} BlockFinder;

static void
BlockFinder_dealloc(BlockFinder *self)
{
    if (self->has_bufs) {
        PyBuffer_Release(&self->keys);
        PyBuffer_Release(&self->ht);
        PyBuffer_Release(&self->wid);
        PyBuffer_Release(&self->tomb);
    }
    Py_TYPE(self)->tp_free((PyObject *)self);
}

static PyObject *
BlockFinder_new(PyTypeObject *type, PyObject *args, PyObject *kwds)
{
    PyObject *keys, *ht, *wid, *tomb;
    Py_ssize_t n, width;
    if (!PyArg_ParseTuple(args, "OOOOnn", &keys, &ht, &wid, &tomb,
                          &n, &width))
        return NULL;
    BlockFinder *self = (BlockFinder *)type->tp_alloc(type, 0);
    if (!self) return NULL;
    if (PyObject_GetBuffer(keys, &self->keys, PyBUF_SIMPLE) < 0 ||
        PyObject_GetBuffer(ht, &self->ht, PyBUF_SIMPLE) < 0 ||
        PyObject_GetBuffer(wid, &self->wid, PyBUF_SIMPLE) < 0 ||
        PyObject_GetBuffer(tomb, &self->tomb, PyBUF_SIMPLE) < 0) {
        /* release whichever succeeded */
        if (self->keys.obj) PyBuffer_Release(&self->keys);
        if (self->ht.obj) PyBuffer_Release(&self->ht);
        if (self->wid.obj) PyBuffer_Release(&self->wid);
        if (self->tomb.obj) PyBuffer_Release(&self->tomb);
        Py_TYPE(self)->tp_free((PyObject *)self);
        return NULL;
    }
    self->has_bufs = 1;
    self->n = n;
    self->width = width;
    if (self->keys.len < n * width || self->ht.len < n * 8 ||
        self->wid.len < n * 4 || self->tomb.len < n) {
        PyErr_SetString(PyExc_ValueError, "BlockFinder buffer too short");
        Py_DECREF(self);
        return NULL;
    }
    return (PyObject *)self;
}

/* in-block newest-visible walk shared by find() and PointReader.
 * Returns: 1 found (pos/ht/wid/tomb set), 2 restart (ht set),
 * 0 nothing visible here. */
static int
blockfinder_walk(BlockFinder *self, const uint8_t *pp, Py_ssize_t plen_real,
                 uint64_t read_ht, int64_t restart_hi,
                 Py_ssize_t *out_pos, uint64_t *out_ht, uint32_t *out_wid,
                 int *out_tomb)
{
    const uint8_t *keys = (const uint8_t *)self->keys.buf;
    const uint64_t *hts = (const uint64_t *)self->ht.buf;
    const uint32_t *wids = (const uint32_t *)self->wid.buf;
    const uint8_t *tombs = (const uint8_t *)self->tomb.buf;
    Py_ssize_t W = self->width, n = self->n;
    Py_ssize_t plen = plen_real < W ? plen_real : W;

    /* lower_bound over W-wide rows for the zero-padded probe: compare
     * the first plen bytes, then the probe's zero padding is <= any
     * remaining row byte, so rows equal on plen bytes are >= probe */
    Py_ssize_t lo = 0, hi = n;
    while (lo < hi) {
        Py_ssize_t mid = (lo + hi) >> 1;
        int c = memcmp(keys + mid * W, pp, plen);
        if (c < 0) lo = mid + 1;
        else hi = mid;
    }
    for (Py_ssize_t pos = lo; pos < n; pos++) {
        const uint8_t *row = keys + pos * W;
        /* rows are full keys (doc key + HT suffix), width >= prefix
         * when the block holds this doc key; a shorter matrix cannot
         * contain it */
        if (plen_real > W || memcmp(row, pp, plen_real) != 0)
            break;
        uint64_t ht = hts[pos];
        if (ht > read_ht) {
            if (restart_hi >= 0 && ht <= (uint64_t)restart_hi) {
                *out_ht = ht;
                return 2;
            }
            continue;
        }
        *out_pos = pos;
        *out_ht = ht;
        *out_wid = wids[pos];
        *out_tomb = tombs[pos] != 0;
        return 1;
    }
    return 0;
}

static PyObject *
BlockFinder_find(BlockFinder *self, PyObject *args)
{
    Py_buffer prefix;
    unsigned long long read_ht;
    long long restart_hi;
    if (!PyArg_ParseTuple(args, "y*KL", &prefix, &read_ht, &restart_hi))
        return NULL;
    Py_ssize_t pos = 0;
    uint64_t ht = 0;
    uint32_t wid = 0;
    int tomb = 0;
    int rc = blockfinder_walk(self, (const uint8_t *)prefix.buf,
                              prefix.len, read_ht, restart_hi,
                              &pos, &ht, &wid, &tomb);
    PyBuffer_Release(&prefix);
    if (rc == 2)
        return PyLong_FromUnsignedLongLong(ht);
    if (rc == 1)
        return Py_BuildValue("nKIi", pos, ht, (unsigned int)wid, tomb);
    Py_RETURN_NONE;
}

static PyMethodDef BlockFinder_methods[] = {
    {"find", (PyCFunction)BlockFinder_find, METH_VARARGS,
     "find(prefix, read_ht, restart_hi) -> (pos, ht, wid, tomb) | "
     "restart_ht | None"},
    {NULL}
};

static PyTypeObject BlockFinderType = {
    PyVarObject_HEAD_INIT(NULL, 0)
    .tp_name = "host_hot.BlockFinder",
    .tp_basicsize = sizeof(BlockFinder),
    .tp_dealloc = (destructor)BlockFinder_dealloc,
    .tp_flags = Py_TPFLAGS_DEFAULT,
    .tp_doc = "fused columnar-block point lookup (search + MVCC walk)",
    .tp_methods = BlockFinder_methods,
    .tp_new = BlockFinder_new,
};

/* ---------------------------------------------------------------------
 * Packer — packed-row V2 encoder (reference: dockv/packed_row.h
 * RowPackerV2), the per-row write hot path: null bitmap + fixed-width
 * region + varlen end-offsets + heap, assembled in one C pass from the
 * {col_id: value} dict. Built once per SchemaPacking.
 *
 * Packer(header, plan, bitmap_size, fixed_size, nvar) with plan =
 * [(id:int, kind:int, fmt:str1, off:int)] over all columns in bitmap
 * order; kind 0 = fixed (fmt one of q i h d f ?), 1 = varlen str,
 * 2 = varlen bytes.
 */
typedef struct {
    PyObject *id;        /* boxed column id for dict lookup */
    int kind;
    char fmt;
    int off;             /* fixed region offset */
} PackCol;

typedef struct {
    PyObject_HEAD
    Py_ssize_t ncols, nvar;
    Py_ssize_t bitmap_size, fixed_size;
    PyObject *header;    /* bytes */
    PackCol *cols;
} Packer;

static void
Packer_dealloc(Packer *self)
{
    for (Py_ssize_t i = 0; i < self->ncols; i++)
        Py_XDECREF(self->cols[i].id);
    PyMem_Free(self->cols);
    Py_XDECREF(self->header);
    Py_TYPE(self)->tp_free((PyObject *)self);
}

static PyObject *
Packer_new(PyTypeObject *type, PyObject *args, PyObject *kwds)
{
    PyObject *header, *plan;
    Py_ssize_t bitmap_size, fixed_size, nvar;
    if (!PyArg_ParseTuple(args, "SOnnn", &header, &plan, &bitmap_size,
                          &fixed_size, &nvar))
        return NULL;
    if (!PyList_Check(plan)) {
        PyErr_SetString(PyExc_TypeError, "plan must be a list");
        return NULL;
    }
    Packer *self = (Packer *)type->tp_alloc(type, 0);
    if (!self) return NULL;
    self->ncols = 0;          /* set only once cols is allocated —
                               * dealloc walks cols up to ncols */
    self->nvar = nvar;
    self->bitmap_size = bitmap_size;
    self->fixed_size = fixed_size;
    self->header = header; Py_INCREF(header);
    self->cols = (PackCol *)PyMem_Calloc(PyList_GET_SIZE(plan),
                                         sizeof(PackCol));
    if (!self->cols) { Py_DECREF(self); return PyErr_NoMemory(); }
    self->ncols = PyList_GET_SIZE(plan);
    for (Py_ssize_t i = 0; i < self->ncols; i++) {
        long id_, kind, off;
        const char *fmt;
        if (!PyArg_ParseTuple(PyList_GET_ITEM(plan, i), "llsl",
                              &id_, &kind, &fmt, &off)) {
            Py_DECREF(self);
            return NULL;
        }
        self->cols[i].id = PyLong_FromLong(id_);
        self->cols[i].kind = (int)kind;
        self->cols[i].fmt = fmt[0];
        self->cols[i].off = (int)off;
        if (!self->cols[i].id) { Py_DECREF(self); return NULL; }
    }
    return (PyObject *)self;
}

static int
pack_fixed(uint8_t *dst, char fmt, PyObject *v)
{
    if (fmt == 'd' || fmt == 'f') {
        double dv = PyFloat_AsDouble(v);
        if (dv == -1.0 && PyErr_Occurred()) return -1;
        if (fmt == 'd') memcpy(dst, &dv, 8);
        else {
            if (isfinite(dv) && (dv > FLT_MAX || dv < -FLT_MAX)) {
                /* struct.pack('<f') semantics: finite doubles past the
                 * f32 range fail loudly, never silently become inf */
                PyErr_SetString(PyExc_OverflowError,
                                "float too large for float32 column");
                return -1;
            }
            float fv = (float)dv;
            memcpy(dst, &fv, 4);
        }
        return 0;
    }
    if (fmt == '?') {
        int b = PyObject_IsTrue(v);
        if (b < 0) return -1;
        *dst = (uint8_t)b;
        return 0;
    }
    PyObject *ix = PyNumber_Index(v);   /* struct-module semantics */
    if (!ix) return -1;
    long long x = PyLong_AsLongLong(ix);
    Py_DECREF(ix);
    if (x == -1 && PyErr_Occurred()) return -1;
    switch (fmt) {
    case 'q': memcpy(dst, &x, 8); return 0;
    case 'i': {
        if (x < INT32_MIN || x > INT32_MAX) goto range;
        int32_t y = (int32_t)x; memcpy(dst, &y, 4); return 0;
    }
    case 'h': {
        if (x < INT16_MIN || x > INT16_MAX) goto range;
        int16_t y = (int16_t)x; memcpy(dst, &y, 2); return 0;
    }
    default:
        PyErr_Format(PyExc_ValueError, "bad pack fmt %c", fmt);
        return -1;
    }
range:
    PyErr_SetString(PyExc_OverflowError, "value out of column range");
    return -1;
}

static PyObject *
Packer_pack(Packer *self, PyObject *values)
{
    if (!PyDict_Check(values)) {
        PyErr_SetString(PyExc_TypeError, "values must be a dict");
        return NULL;
    }
    Py_ssize_t hlen = PyBytes_GET_SIZE(self->header);
    /* declarations up front: the error paths jump over them (g++
     * rejects a goto crossing initializations) */
    const char **vp = NULL;
    Py_ssize_t *vl = NULL;
    Py_buffer *vbufs = NULL;            /* held buffer-protocol views */
    uint8_t *fixed_scratch = NULL;
    Py_ssize_t heap_len = 0, vi = 0, total, heap_pos, nheld = 0;
    PyObject *out = NULL;
    uint8_t *buf, *bitmap, *fixed, *ends, *heap;
    uint8_t bitmap_scratch[64];
    if (self->bitmap_size > (Py_ssize_t)sizeof(bitmap_scratch)) {
        PyErr_SetString(PyExc_ValueError, "too many columns");
        return NULL;
    }
    memset(bitmap_scratch, 0, sizeof(bitmap_scratch));
    if (self->nvar) {
        vp = (const char **)PyMem_Malloc(self->nvar * sizeof(char *));
        vl = (Py_ssize_t *)PyMem_Malloc(
            self->nvar * sizeof(Py_ssize_t));
        vbufs = (Py_buffer *)PyMem_Calloc(self->nvar,
                                          sizeof(Py_buffer));
        if (!vp || !vl || !vbufs) {
            PyMem_Free(vp); PyMem_Free(vl); PyMem_Free(vbufs);
            return PyErr_NoMemory();
        }
    }
    if (self->fixed_size) {
        fixed_scratch = (uint8_t *)PyMem_Calloc(1, self->fixed_size);
        if (!fixed_scratch) {
            PyMem_Free(vp); PyMem_Free(vl); PyMem_Free(vbufs);
            return PyErr_NoMemory();
        }
    }
    /* pass 1 does ALL value conversion — including fixed columns,
     * whose __index__/__float__ may run arbitrary Python — so the
     * cached varlen pointers can't be invalidated afterwards; held
     * buffer views pin non-bytes sources (bytearray/memoryview) */
    for (Py_ssize_t i = 0; i < self->ncols; i++) {
        PackCol *c = &self->cols[i];
        PyObject *v = PyDict_GetItem(values, c->id);   /* borrowed */
        if (v == NULL || v == Py_None) {
            bitmap_scratch[i >> 3] |= (uint8_t)(1 << (i & 7));
            if (c->kind != 0) { vp[vi] = NULL; vl[vi] = 0; vi++; }
            continue;
        }
        if (c->kind == 0) {
            if (pack_fixed(fixed_scratch + c->off, c->fmt, v) < 0)
                goto fail;
            continue;
        }
        if (PyUnicode_Check(v)) {
            Py_ssize_t n = 0;
            const char *p = PyUnicode_AsUTF8AndSize(v, &n);
            if (!p) goto fail;
            vp[vi] = p; vl[vi] = n;
        } else if (PyBytes_Check(v)) {
            vp[vi] = PyBytes_AS_STRING(v);
            vl[vi] = PyBytes_GET_SIZE(v);
        } else if (PyObject_CheckBuffer(v)) {
            /* bytearray / memoryview / numpy bytes — pinned until the
             * copy completes (matches the Python packer's bytes(v)) */
            if (PyObject_GetBuffer(v, &vbufs[vi], PyBUF_SIMPLE) < 0)
                goto fail;
            nheld = vi + 1;
            vp[vi] = (const char *)vbufs[vi].buf;
            vl[vi] = vbufs[vi].len;
        } else {
            PyErr_SetString(PyExc_TypeError,
                            "varlen column value must be str or "
                            "bytes-like");
            goto fail;
        }
        heap_len += vl[vi];
        vi++;
    }
    if (heap_len > (Py_ssize_t)UINT32_MAX) {
        PyErr_SetString(PyExc_OverflowError,
                        "packed-row heap exceeds uint32 offsets");
        goto fail;
    }
    total = hlen + self->bitmap_size + self->fixed_size
        + 4 * self->nvar + heap_len;
    out = PyBytes_FromStringAndSize(NULL, total);
    if (!out) goto fail;
    /* pass 2: pure memcpy assembly — no Python re-entry */
    buf = (uint8_t *)PyBytes_AS_STRING(out);
    memcpy(buf, PyBytes_AS_STRING(self->header), hlen);
    bitmap = buf + hlen;
    memcpy(bitmap, bitmap_scratch, self->bitmap_size);
    fixed = bitmap + self->bitmap_size;
    if (self->fixed_size)
        memcpy(fixed, fixed_scratch, self->fixed_size);
    ends = fixed + self->fixed_size;
    heap = ends + 4 * self->nvar;
    heap_pos = 0;
    for (vi = 0; vi < self->nvar; vi++) {
        if (vl[vi]) {
            memcpy(heap + heap_pos, vp[vi], vl[vi]);
            heap_pos += vl[vi];
        }
        uint32_t e = (uint32_t)heap_pos;
        memcpy(ends + 4 * vi, &e, 4);
    }
    for (Py_ssize_t i = 0; i < nheld; i++)
        if (vbufs[i].obj) PyBuffer_Release(&vbufs[i]);
    PyMem_Free(vp); PyMem_Free(vl); PyMem_Free(vbufs);
    PyMem_Free(fixed_scratch);
    return out;
fail:
    for (Py_ssize_t i = 0; i < nheld; i++)
        if (vbufs[i].obj) PyBuffer_Release(&vbufs[i]);
    PyMem_Free(vp); PyMem_Free(vl); PyMem_Free(vbufs);
    PyMem_Free(fixed_scratch);
    Py_XDECREF(out);
    return NULL;
}

static PyMethodDef Packer_methods[] = {
    {"pack", (PyCFunction)Packer_pack, METH_O,
     "pack({col_id: value}) -> packed row bytes (header included)"},
    {NULL}
};

static PyTypeObject PackerType = {
    PyVarObject_HEAD_INIT(NULL, 0)
    .tp_name = "host_hot.Packer",
    .tp_basicsize = sizeof(Packer),
    .tp_dealloc = (destructor)Packer_dealloc,
    .tp_flags = Py_TPFLAGS_DEFAULT,
    .tp_doc = "packed-row V2 encoder",
    .tp_methods = Packer_methods,
    .tp_new = Packer_new,
};

/* ---------------------------------------------------------------------
 * PointReader — whole-SST batched point lookup: bloom probe + block
 * bisect + the BlockFinder walk + Extractor row materialization for a
 * LIST of encoded doc-key prefixes in ONE C call (reference analog:
 * MultiGet batching over BlockBasedTable::Get,
 * src/yb/rocksdb/db/db_impl.cc, driven by pggate operation buffering,
 * src/yb/yql/pggate/pg_operation_buffer.cc).
 *
 * find_many(prefixes, read_ht, restart_hi) returns a list, one entry
 * per prefix:
 *   (ht, wid, dict|None) — newest visible version in this SST (dict is
 *                          None for a tombstone: it must still win the
 *                          cross-SST merge)
 *   int                  — restart: a version in (read_ht, restart_hi]
 *   None                 — no visible version in this SST
 *   NotImplemented       — this key needs the Python path here (block
 *                          without a finder/extractor)
 */
typedef struct {
    PyObject_HEAD
    Py_ssize_t nblocks;
    PyObject *firsts;       /* tuple of bytes (owned) */
    PyObject *lasts;        /* tuple of bytes (owned) */
    PyObject *finders;      /* tuple of BlockFinder|None (owned) */
    PyObject *extractors;   /* tuple of Extractor|None (owned) */
    Py_buffer bloom;        /* bloom bit array; absent when bloom_k==0 */
    int bloom_k;
    int has_bloom;
} PointReader;

static void
PointReader_dealloc(PointReader *self)
{
    Py_XDECREF(self->firsts);
    Py_XDECREF(self->lasts);
    Py_XDECREF(self->finders);
    Py_XDECREF(self->extractors);
    if (self->has_bloom) PyBuffer_Release(&self->bloom);
    Py_TYPE(self)->tp_free((PyObject *)self);
}

/* PointReader(firsts, lasts, finders, extractors, bloom_bits|None, k) */
static PyObject *
PointReader_new(PyTypeObject *type, PyObject *args, PyObject *kwds)
{
    PyObject *firsts, *lasts, *finders, *extractors, *bloom;
    int k;
    if (!PyArg_ParseTuple(args, "OOOOOi", &firsts, &lasts, &finders,
                          &extractors, &bloom, &k))
        return NULL;
    if (!PyTuple_Check(firsts) || !PyTuple_Check(lasts) ||
        !PyTuple_Check(finders) || !PyTuple_Check(extractors)) {
        PyErr_SetString(PyExc_TypeError, "expected tuples");
        return NULL;
    }
    Py_ssize_t n = PyTuple_GET_SIZE(firsts);
    if (PyTuple_GET_SIZE(lasts) != n || PyTuple_GET_SIZE(finders) != n ||
        PyTuple_GET_SIZE(extractors) != n) {
        PyErr_SetString(PyExc_ValueError, "length mismatch");
        return NULL;
    }
    for (Py_ssize_t i = 0; i < n; i++) {
        if (!PyBytes_Check(PyTuple_GET_ITEM(firsts, i)) ||
            !PyBytes_Check(PyTuple_GET_ITEM(lasts, i))) {
            PyErr_SetString(PyExc_TypeError, "keys must be bytes");
            return NULL;
        }
        PyObject *f = PyTuple_GET_ITEM(finders, i);
        PyObject *e = PyTuple_GET_ITEM(extractors, i);
        if ((f != Py_None && !PyObject_TypeCheck(f, &BlockFinderType)) ||
            (e != Py_None && !PyObject_TypeCheck(e, &ExtractorType))) {
            PyErr_SetString(PyExc_TypeError,
                            "finders/extractors type mismatch");
            return NULL;
        }
    }
    PointReader *self = (PointReader *)type->tp_alloc(type, 0);
    if (!self) return NULL;
    self->nblocks = n;
    self->firsts = firsts; Py_INCREF(firsts);
    self->lasts = lasts; Py_INCREF(lasts);
    self->finders = finders; Py_INCREF(finders);
    self->extractors = extractors; Py_INCREF(extractors);
    self->bloom_k = k;
    self->has_bloom = 0;
    if (bloom != Py_None && k > 0) {
        if (PyObject_GetBuffer(bloom, &self->bloom, PyBUF_SIMPLE) < 0) {
            Py_DECREF(self);
            return NULL;
        }
        self->has_bloom = 1;
    }
    return (PyObject *)self;
}

/* bytes-vs-prefix lexicographic compare (memcmp + length tiebreak) */
static inline int
bytes_cmp(const uint8_t *a, Py_ssize_t an, const uint8_t *b, Py_ssize_t bn)
{
    Py_ssize_t m = an < bn ? an : bn;
    int c = memcmp(a, b, m);
    if (c) return c;
    return (an > bn) - (an < bn);
}

/* one key through this SST; returns new ref or NULL on error */
static PyObject *
pointreader_find_one(PointReader *self, const uint8_t *pp, Py_ssize_t plen,
                     uint64_t read_ht, int64_t restart_hi, PyObject *want)
{
    if (self->has_bloom) {
        uint64_t h = 0xCBF29CE484222325ULL;
        for (Py_ssize_t i = 0; i < plen; i++)
            h = (h ^ pp[i]) * 0x100000001B3ULL;
        uint64_t m = (uint64_t)self->bloom.len * 8;
        const uint8_t *bb = (const uint8_t *)self->bloom.buf;
        uint64_t h2 = (h >> 33) | 1;
        for (int i = 0; i < self->bloom_k; i++) {
            uint64_t idx = (h + (uint64_t)i * h2) % m;
            if (!((bb[idx >> 3] >> (idx & 7)) & 1))
                Py_RETURN_NONE;
        }
    }
    /* bisect_right(firsts, prefix) - 1, clamped to 0 */
    Py_ssize_t lo = 0, hi = self->nblocks;
    while (lo < hi) {
        Py_ssize_t mid = (lo + hi) >> 1;
        PyObject *fk = PyTuple_GET_ITEM(self->firsts, mid);
        if (bytes_cmp((const uint8_t *)PyBytes_AS_STRING(fk),
                      PyBytes_GET_SIZE(fk), pp, plen) <= 0)
            lo = mid + 1;
        else
            hi = mid;
    }
    Py_ssize_t b = lo > 0 ? lo - 1 : 0;
    for (; b < self->nblocks; b++) {
        PyObject *fko = PyTuple_GET_ITEM(self->firsts, b);
        const uint8_t *fk = (const uint8_t *)PyBytes_AS_STRING(fko);
        Py_ssize_t fkn = PyBytes_GET_SIZE(fko);
        if (bytes_cmp(fk, fkn, pp, plen) > 0 &&
            !(fkn >= plen && memcmp(fk, pp, plen) == 0))
            Py_RETURN_NONE;      /* block starts past the doc key */
        PyObject *lko = PyTuple_GET_ITEM(self->lasts, b);
        const uint8_t *lk = (const uint8_t *)PyBytes_AS_STRING(lko);
        Py_ssize_t lkn = PyBytes_GET_SIZE(lko);
        if (bytes_cmp(lk, lkn, pp, plen) < 0)
            continue;            /* block ends before the doc key */
        PyObject *fo = PyTuple_GET_ITEM(self->finders, b);
        PyObject *eo = PyTuple_GET_ITEM(self->extractors, b);
        if (fo == Py_None || eo == Py_None) {
            Py_INCREF(Py_NotImplemented);   /* python fallback */
            return Py_NotImplemented;
        }
        Py_ssize_t pos = 0;
        uint64_t ht = 0;
        uint32_t wid = 0;
        int tomb = 0;
        int rc = blockfinder_walk((BlockFinder *)fo, pp, plen, read_ht,
                                  restart_hi, &pos, &ht, &wid, &tomb);
        if (rc == 2)
            return PyLong_FromUnsignedLongLong(ht);
        if (rc == 1) {
            PyObject *row;
            if (tomb) {
                row = Py_None; Py_INCREF(row);
            } else {
                row = extract_row((Extractor *)eo, pos, want);
                if (!row) return NULL;
            }
            PyObject *r = Py_BuildValue("KIN", ht, (unsigned int)wid,
                                        row);
            return r;
        }
        /* nothing visible here; the doc key's versions continue into
         * the next block only when they run through this block's last
         * key */
        if (lkn >= plen && memcmp(lk, pp, plen) == 0)
            continue;
        Py_RETURN_NONE;
    }
    Py_RETURN_NONE;
}

static PyObject *
PointReader_find_many(PointReader *self, PyObject *args)
{
    PyObject *prefixes;
    unsigned long long read_ht;
    long long restart_hi;
    PyObject *want = Py_None;
    if (!PyArg_ParseTuple(args, "OKL|O", &prefixes, &read_ht, &restart_hi,
                          &want))
        return NULL;
    if (want != Py_None && !PyTuple_Check(want)) {
        PyErr_SetString(PyExc_TypeError,
                        "want_cols must be a tuple or None");
        return NULL;
    }
    if (!PyList_Check(prefixes)) {
        PyErr_SetString(PyExc_TypeError, "prefixes must be a list");
        return NULL;
    }
    Py_ssize_t n = PyList_GET_SIZE(prefixes);
    PyObject *out = PyList_New(n);
    if (!out) return NULL;
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *p = PyList_GET_ITEM(prefixes, i);
        if (!PyBytes_Check(p)) {
            PyErr_SetString(PyExc_TypeError, "prefix must be bytes");
            Py_DECREF(out);
            return NULL;
        }
        PyObject *r = pointreader_find_one(
            self, (const uint8_t *)PyBytes_AS_STRING(p),
            PyBytes_GET_SIZE(p), read_ht, restart_hi,
            want == Py_None ? NULL : want);
        if (!r) { Py_DECREF(out); return NULL; }
        PyList_SET_ITEM(out, i, r);
    }
    return out;
}

static PyMethodDef PointReader_methods[] = {
    {"find_many", (PyCFunction)PointReader_find_many, METH_VARARGS,
     "find_many(prefixes, read_ht, restart_hi[, want_cols]) -> list"},
    {NULL}
};

static PyTypeObject PointReaderType = {
    PyVarObject_HEAD_INIT(NULL, 0)
    .tp_name = "host_hot.PointReader",
    .tp_basicsize = sizeof(PointReader),
    .tp_dealloc = (destructor)PointReader_dealloc,
    .tp_flags = Py_TPFLAGS_DEFAULT,
    .tp_doc = "whole-SST batched point lookup",
    .tp_methods = PointReader_methods,
    .tp_new = PointReader_new,
};

/* ---------------------------------------------------------------------
 * range_read(spec, lo, hi, readers, read_ht, restart_hi, want_cols,
 *            mem_set) -> list
 *
 * Fused enumerated-range scan for a single-int-hash-PK table (the
 * YCSB-E shape; reference: point segments in
 * src/yb/docdb/hybrid_scan_choices.cc driving rocksdb MultiGet): for
 * every integer key in [lo, hi] this encodes the DocKey, runs the
 * bloom+bisect+MVCC point lookup against EVERY PointReader (one per
 * SST), and merges winners by (commit ht, write id) — all without
 * surfacing per-key intermediates to Python.
 *
 * Per-key results:
 *   dict  - final visible row (projected when want_cols given)
 *   None  - no visible row (absent or tombstone)
 *   (prefix, got) - the key needs Python attention:
 *       got NotImplemented -> non-columnar block, per-key slow path
 *       got int            -> read-restart hybrid time (raise)
 *       got tuple|None     -> native best; the key hit the memtable
 *                             guard set, caller merges _mem_best
 * mem_set is the single active memtable's row-prefix set (exact
 * membership, storage/memtable.py) or None when no memtable probe is
 * needed.
 */
static PyObject *
hot_range_read(PyObject *mod, PyObject *args)
{
    long long cotable, lo, hi;
    int num_hash;
    Py_buffer kinds, descs;
    PyObject *readers, *want, *mem_set;
    unsigned long long read_ht;
    long long restart_hi;
    if (!PyArg_ParseTuple(args, "(Liy*y*)LLOKLOO", &cotable, &num_hash,
                          &kinds, &descs, &lo, &hi, &readers, &read_ht,
                          &restart_hi, &want, &mem_set))
        return NULL;
    PyObject *out = NULL;
    KeyBuf kb = {NULL, 0, 0};
    Py_ssize_t nr = 0, n = 0;
    unsigned long long span = 0;
    PyObject *wc = NULL;
    if (want != Py_None && !PyTuple_Check(want)) {
        PyErr_SetString(PyExc_TypeError, "want_cols must be tuple|None");
        goto fail;
    }
    if (mem_set != Py_None && !PySet_Check(mem_set)) {
        PyErr_SetString(PyExc_TypeError, "mem_set must be a set|None");
        goto fail;
    }
    if (!PyTuple_Check(readers)) {
        PyErr_SetString(PyExc_TypeError, "readers must be a tuple");
        goto fail;
    }
    nr = PyTuple_GET_SIZE(readers);
    for (Py_ssize_t i = 0; i < nr; i++) {
        if (!PyObject_TypeCheck(PyTuple_GET_ITEM(readers, i),
                                &PointReaderType)) {
            PyErr_SetString(PyExc_TypeError, "readers[i]: PointReader");
            goto fail;
        }
    }
    if (kinds.len != 1 || descs.len != 1 || num_hash != 1) {
        PyErr_SetString(PyExc_ValueError,
                        "range_read needs a single hash key column");
        goto fail;
    }
    span = (unsigned long long)hi - (unsigned long long)lo;
    if (hi < lo || span >= 1000000ULL) {
        PyErr_SetString(PyExc_ValueError, "bad key range");
        goto fail;
    }
    n = (Py_ssize_t)(span + 1);
    out = PyList_New(n);
    if (!out) goto fail;
    wc = want == Py_None ? NULL : want;
    for (Py_ssize_t idx = 0; idx < n; idx++) {
        long long k = lo + (long long)idx;
        PyObject *kv = PyLong_FromLongLong(k);
        if (!kv) goto fail;
        PyObject *vals = PyTuple_Pack(1, kv);
        Py_DECREF(kv);
        if (!vals) goto fail;
        int erc = build_doc_key(cotable, num_hash,
                                (const uint8_t *)kinds.buf,
                                (const uint8_t *)descs.buf, 1, vals, &kb);
        Py_DECREF(vals);
        if (erc < 0) goto fail;
        const uint8_t *pp = kb.buf;
        Py_ssize_t plen = kb.len;
        PyObject *best = NULL;       /* (ht, wid, row) winner so far */
        PyObject *attention = NULL;  /* NotImplemented | restart int */
        for (Py_ssize_t r = 0; r < nr; r++) {
            PyObject *got = pointreader_find_one(
                (PointReader *)PyTuple_GET_ITEM(readers, r),
                pp, plen, read_ht, restart_hi, wc);
            if (!got) { Py_XDECREF(best); goto fail; }
            if (got == Py_None) { Py_DECREF(got); continue; }
            if (got == Py_NotImplemented || PyLong_Check(got)) {
                attention = got;
                break;
            }
            if (best == NULL) {
                best = got;
                continue;
            }
            /* compare (ht, wid) — unsigned, boxed by find_one */
            uint64_t bht = PyLong_AsUnsignedLongLong(
                PyTuple_GET_ITEM(best, 0));
            uint64_t ght = PyLong_AsUnsignedLongLong(
                PyTuple_GET_ITEM(got, 0));
            uint64_t bw = PyLong_AsUnsignedLongLong(
                PyTuple_GET_ITEM(best, 1));
            uint64_t gw = PyLong_AsUnsignedLongLong(
                PyTuple_GET_ITEM(got, 1));
            if (PyErr_Occurred()) {
                Py_DECREF(got); Py_DECREF(best); goto fail;
            }
            if (ght > bht || (ght == bht && gw > bw)) {
                Py_DECREF(best);
                best = got;
            } else {
                Py_DECREF(got);
            }
        }
        PyObject *slot;
        int mem_hit = 0;
        if (!attention && mem_set != Py_None) {
            PyObject *pb = PyBytes_FromStringAndSize((const char *)pp,
                                                     plen);
            if (!pb) { Py_XDECREF(best); goto fail; }
            mem_hit = PySet_Contains(mem_set, pb);
            if (mem_hit < 0) {
                Py_DECREF(pb); Py_XDECREF(best); goto fail;
            }
            if (mem_hit) {
                slot = PyTuple_Pack(2, pb, best ? best : Py_None);
                Py_DECREF(pb);
                Py_XDECREF(best);
                if (!slot) goto fail;
                PyList_SET_ITEM(out, idx, slot);
                continue;
            }
            Py_DECREF(pb);
        }
        if (attention) {
            Py_XDECREF(best);
            PyObject *pb = PyBytes_FromStringAndSize((const char *)pp,
                                                     plen);
            if (!pb) { Py_DECREF(attention); goto fail; }
            slot = PyTuple_Pack(2, pb, attention);
            Py_DECREF(pb);
            Py_DECREF(attention);
            if (!slot) goto fail;
        } else if (best) {
            slot = PyTuple_GET_ITEM(best, 2);   /* row dict | None */
            Py_INCREF(slot);
            Py_DECREF(best);
        } else {
            slot = Py_None;
            Py_INCREF(slot);
        }
        PyList_SET_ITEM(out, idx, slot);
    }
    PyMem_Free(kb.buf);
    PyBuffer_Release(&kinds);
    PyBuffer_Release(&descs);
    return out;
fail:
    Py_XDECREF(out);
    PyMem_Free(kb.buf);
    PyBuffer_Release(&kinds);
    PyBuffer_Release(&descs);
    return NULL;
}

static PyMethodDef hot_methods[] = {
    {"encode_doc_key", py_encode_doc_key, METH_VARARGS,
     "encode_doc_key(spec, values) -> encoded DocKey bytes"},
    {"range_read", hot_range_read, METH_VARARGS,
     "range_read(spec, lo, hi, readers, read_ht, restart_hi, want_cols,"
     " mem_set) -> per-key rows/attention list"},
    {"fnv64", py_fnv64, METH_O,
     "fnv64(bytes) -> FNV-1a 64-bit hash"},
    {"bloom_may_contain", py_bloom_may_contain, METH_VARARGS,
     "bloom_may_contain(bits, k, hash) -> bool"},
    {NULL}
};

static PyModuleDef hotmodule = {
    PyModuleDef_HEAD_INIT, "host_hot",
    "native host hot path (row extraction, key encode)", -1, hot_methods,
};

PyMODINIT_FUNC
PyInit_host_hot(void)
{
    if (PyType_Ready(&ExtractorType) < 0)
        return NULL;
    if (PyType_Ready(&BlockFinderType) < 0)
        return NULL;
    PyObject *m = PyModule_Create(&hotmodule);
    if (!m) return NULL;
    Py_INCREF(&ExtractorType);
    PyModule_AddObject(m, "Extractor", (PyObject *)&ExtractorType);
    Py_INCREF(&BlockFinderType);
    PyModule_AddObject(m, "BlockFinder", (PyObject *)&BlockFinderType);
    if (PyType_Ready(&PointReaderType) < 0)
        return NULL;
    Py_INCREF(&PointReaderType);
    PyModule_AddObject(m, "PointReader", (PyObject *)&PointReaderType);
    if (PyType_Ready(&PackerType) < 0)
        return NULL;
    Py_INCREF(&PackerType);
    PyModule_AddObject(m, "Packer", (PyObject *)&PackerType);
    return m;
}
