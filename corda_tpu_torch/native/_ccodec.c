/* Native decode core for the corda_tpu_torch canonical codec.
 *
 * The port's own copy of corda_tpu/native/_ccodec.c, with only its comments
 * changed. The wire format is defined by corda_tpu_torch/serialization/
 * codec.py (_decode); this is a semantics-identical C implementation of
 * its hot loop, built at first use by corda_tpu_torch/native/__init__.py
 * (load_ccodec). The pure-Python codec stays the semantic authority.
 *
 * Division of labour: every primitive / collection tag decodes natively;
 * the OBJECT tag decodes its wire name + field values natively, then calls
 * back into Python (codec._construct) for registry lookup, custom decoders
 * and dataclass construction — so the whitelist and construction semantics
 * live in exactly one place (codec.py). Canonicality rules (minimal
 * varints, strict dict/frozenset encoded-byte ordering, canonical -0.0,
 * depth and count gates) are enforced here bit-for-bit; the conformance
 * suite runs both decoders against the same corpus.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <string.h>
#include <math.h>

/* Tag values MUST match codec.py's _TAG_* constants bit-for-bit. */
#define TAG_NONE 0x00
#define TAG_FALSE 0x01
#define TAG_TRUE 0x02
#define TAG_INT 0x03
#define TAG_BYTES 0x04
#define TAG_STR 0x05
#define TAG_LIST 0x06
#define TAG_DICT 0x07
#define TAG_OBJECT 0x08
#define TAG_FROZENSET 0x09
#define TAG_FLOAT 0x0A

#define MAX_DEPTH 64

/* Set once by _init(): the codec's DeserializationError and the Python
 * construct callback for objects. */
static PyObject *DeserializationError = NULL;
static PyObject *construct_cb = NULL;

static void
raise_deser(const char *msg)
{
    if (DeserializationError != NULL) {
        PyErr_SetString(DeserializationError, msg);
    }
    else {
        PyErr_SetString(PyExc_ValueError, msg);
    }
}

/* Decode one varint. Fast path accumulates into a uint64; payloads wider
 * than 63 bits (e.g. zigzagged 256-bit crypto integers) fall back to
 * PyLong arithmetic. Returns new pos, or -1 on error. *out receives a NEW
 * reference to a PyLong. Enforces the minimal-encoding rule. */
static Py_ssize_t
read_varint(const unsigned char *data, Py_ssize_t len, Py_ssize_t pos,
            PyObject **out)
{
    unsigned long long acc = 0;
    int shift = 0;
    Py_ssize_t start = pos;

    while (1) {
        if (pos >= len) {
            raise_deser("truncated varint");
            return -1;
        }
        unsigned char b = data[pos++];
        if (shift <= 56) {
            acc |= ((unsigned long long)(b & 0x7F)) << shift;
        }
        if (!(b & 0x80)) {
            if (b == 0 && shift > 0) {
                raise_deser("non-minimal varint");
                return -1;
            }
            if (shift <= 56) {
                *out = PyLong_FromUnsignedLongLong(acc);
                return (*out == NULL) ? -1 : pos;
            }
            break; /* wide: redo with PyLong below */
        }
        shift += 7;
    }

    /* Slow path: rebuild from the bytes with PyLong arithmetic. The fast
     * loop only breaks here after SEEING the terminator in-bounds, so the
     * re-scan is bounded — the explicit check documents (and enforces)
     * that invariant. */
    {
        PyObject *result = PyLong_FromLong(0);
        if (result == NULL)
            return -1;
        int sh = 0;
        for (Py_ssize_t i = start;; i++) {
            if (i >= len) {
                Py_DECREF(result);
                raise_deser("truncated varint");
                return -1;
            }
            unsigned char b = data[i];
            PyObject *group = PyLong_FromUnsignedLong(b & 0x7F);
            PyObject *shn = PyLong_FromLong(sh);
            if (group == NULL || shn == NULL) {
                Py_XDECREF(group);
                Py_XDECREF(shn);
                Py_DECREF(result);
                return -1;
            }
            PyObject *shifted = PyNumber_Lshift(group, shn);
            Py_DECREF(group);
            Py_DECREF(shn);
            if (shifted == NULL) {
                Py_DECREF(result);
                return -1;
            }
            PyObject *summed = PyNumber_Or(result, shifted);
            Py_DECREF(shifted);
            Py_DECREF(result);
            if (summed == NULL)
                return -1;
            result = summed;
            if (!(b & 0x80)) {
                *out = result;
                return i + 1;
            }
            sh += 7;
        }
    }
}

/* Varint whose value is needed as a size: rejects values > SSIZE_MAX. */
static Py_ssize_t
read_size(const unsigned char *data, Py_ssize_t len, Py_ssize_t pos,
          Py_ssize_t *out)
{
    PyObject *n = NULL;
    pos = read_varint(data, len, pos, &n);
    if (pos < 0)
        return -1;
    Py_ssize_t v = PyLong_AsSsize_t(n);
    Py_DECREF(n);
    if (v < 0) {
        if (PyErr_Occurred())
            PyErr_Clear();
        raise_deser("collection count exceeds data");
        return -1;
    }
    *out = v;
    return pos;
}

static Py_ssize_t decode_value(const unsigned char *data, Py_ssize_t len,
                               Py_ssize_t pos, int depth, PyObject **out);

/* zigzag-decode a PyLong: (n >> 1) ^ -(n & 1). New reference. */
static PyObject *
unzigzag(PyObject *n)
{
    PyObject *one = PyLong_FromLong(1);
    if (one == NULL)
        return NULL;
    PyObject *half = PyNumber_Rshift(n, one);
    PyObject *low = PyNumber_And(n, one);
    Py_DECREF(one);
    if (half == NULL || low == NULL) {
        Py_XDECREF(half);
        Py_XDECREF(low);
        return NULL;
    }
    PyObject *neg = PyNumber_Negative(low);
    Py_DECREF(low);
    if (neg == NULL) {
        Py_DECREF(half);
        return NULL;
    }
    PyObject *result = PyNumber_Xor(half, neg);
    Py_DECREF(half);
    Py_DECREF(neg);
    return result;
}

static Py_ssize_t
decode_value(const unsigned char *data, Py_ssize_t len, Py_ssize_t pos,
             int depth, PyObject **out)
{
    if (depth > MAX_DEPTH) {
        raise_deser("nesting too deep");
        return -1;
    }
    if (pos >= len) {
        raise_deser("truncated data");
        return -1;
    }
    unsigned char tag = data[pos++];
    switch (tag) {
    case TAG_NONE:
        Py_INCREF(Py_None);
        *out = Py_None;
        return pos;
    case TAG_FALSE:
        Py_INCREF(Py_False);
        *out = Py_False;
        return pos;
    case TAG_TRUE:
        Py_INCREF(Py_True);
        *out = Py_True;
        return pos;
    case TAG_INT: {
        PyObject *n = NULL;
        pos = read_varint(data, len, pos, &n);
        if (pos < 0)
            return -1;
        /* Fast path: small zigzag values avoid PyNumber calls. */
        int overflow = 0;
        long long v = PyLong_AsLongLongAndOverflow(n, &overflow);
        if (!overflow && v >= 0) {
            Py_DECREF(n);
            long long dec = (long long)((unsigned long long)v >> 1);
            if (v & 1)
                dec = -dec - 1;
            *out = PyLong_FromLongLong(dec);
            return (*out == NULL) ? -1 : pos;
        }
        PyErr_Clear();
        *out = unzigzag(n);
        Py_DECREF(n);
        return (*out == NULL) ? -1 : pos;
    }
    case TAG_FLOAT: {
        if (pos + 8 > len) {
            raise_deser("truncated float");
            return -1;
        }
        unsigned long long bits = 0;
        for (int i = 0; i < 8; i++)
            bits = (bits << 8) | data[pos + i];
        double value;
        memcpy(&value, &bits, 8);
        if (!isfinite(value)) {
            raise_deser("non-finite float");
            return -1;
        }
        if (value == 0.0 && data[pos] != 0) {
            raise_deser("non-canonical negative zero");
            return -1;
        }
        *out = PyFloat_FromDouble(value);
        return (*out == NULL) ? -1 : pos + 8;
    }
    case TAG_BYTES: {
        Py_ssize_t n;
        pos = read_size(data, len, pos, &n);
        if (pos < 0)
            return -1;
        if (n > len - pos) {
            raise_deser("truncated bytes");
            return -1;
        }
        *out = PyBytes_FromStringAndSize((const char *)data + pos, n);
        return (*out == NULL) ? -1 : pos + n;
    }
    case TAG_STR: {
        Py_ssize_t n;
        pos = read_size(data, len, pos, &n);
        if (pos < 0)
            return -1;
        if (n > len - pos) {
            raise_deser("truncated string");
            return -1;
        }
        PyObject *s = PyUnicode_DecodeUTF8((const char *)data + pos, n, NULL);
        if (s == NULL) {
            PyObject *type, *value, *tb;
            PyErr_Fetch(&type, &value, &tb);
            PyObject *msg = PyUnicode_FromFormat("invalid utf-8 string: %S",
                                                 value ? value : Py_None);
            Py_XDECREF(type);
            Py_XDECREF(value);
            Py_XDECREF(tb);
            if (msg != NULL) {
                PyErr_SetObject(DeserializationError, msg);
                Py_DECREF(msg);
            }
            return -1;
        }
        *out = s;
        return pos + n;
    }
    case TAG_LIST: {
        Py_ssize_t n;
        pos = read_size(data, len, pos, &n);
        if (pos < 0)
            return -1;
        if (n > len - pos) {
            raise_deser("collection count exceeds data");
            return -1;
        }
        PyObject *tup = PyTuple_New(n);
        if (tup == NULL)
            return -1;
        for (Py_ssize_t i = 0; i < n; i++) {
            PyObject *item = NULL;
            pos = decode_value(data, len, pos, depth + 1, &item);
            if (pos < 0) {
                Py_DECREF(tup);
                return -1;
            }
            PyTuple_SET_ITEM(tup, i, item);
        }
        *out = tup;
        return pos;
    }
    case TAG_DICT: {
        Py_ssize_t n;
        pos = read_size(data, len, pos, &n);
        if (pos < 0)
            return -1;
        if (n > len - pos) {
            raise_deser("collection count exceeds data");
            return -1;
        }
        PyObject *d = PyDict_New();
        if (d == NULL)
            return -1;
        Py_ssize_t prev_start = -1, prev_end = -1;
        for (Py_ssize_t i = 0; i < n; i++) {
            Py_ssize_t kstart = pos;
            PyObject *k = NULL;
            pos = decode_value(data, len, pos, depth + 1, &k);
            if (pos < 0) {
                Py_DECREF(d);
                return -1;
            }
            Py_ssize_t kend = pos;
            PyObject *v = NULL;
            pos = decode_value(data, len, pos, depth + 1, &v);
            if (pos < 0) {
                Py_DECREF(k);
                Py_DECREF(d);
                return -1;
            }
            if (prev_start >= 0) {
                /* strict bytewise increase of key encodings */
                Py_ssize_t alen = prev_end - prev_start;
                Py_ssize_t blen = kend - kstart;
                Py_ssize_t m = alen < blen ? alen : blen;
                int cmp = memcmp(data + prev_start, data + kstart, m);
                int le = (cmp > 0) ? 0 : (cmp < 0) ? 1 : (alen < blen);
                if (!le) {
                    Py_DECREF(k);
                    Py_DECREF(v);
                    Py_DECREF(d);
                    raise_deser("non-canonical dict entry order");
                    return -1;
                }
            }
            prev_start = kstart;
            prev_end = kend;
            int rc = PyDict_SetItem(d, k, v);
            Py_DECREF(k);
            Py_DECREF(v);
            if (rc < 0) {
                if (PyErr_ExceptionMatches(PyExc_TypeError)) {
                    PyErr_Clear();
                    raise_deser("unhashable dict key");
                }
                Py_DECREF(d);
                return -1;
            }
        }
        *out = d;
        return pos;
    }
    case TAG_FROZENSET: {
        Py_ssize_t n;
        pos = read_size(data, len, pos, &n);
        if (pos < 0)
            return -1;
        if (n > len - pos) {
            raise_deser("collection count exceeds data");
            return -1;
        }
        PyObject *list = PyList_New(n);
        if (list == NULL)
            return -1;
        Py_ssize_t prev_start = -1, prev_end = -1;
        for (Py_ssize_t i = 0; i < n; i++) {
            Py_ssize_t start = pos;
            PyObject *item = NULL;
            pos = decode_value(data, len, pos, depth + 1, &item);
            if (pos < 0) {
                Py_DECREF(list);
                return -1;
            }
            if (prev_start >= 0) {
                Py_ssize_t alen = prev_end - prev_start;
                Py_ssize_t blen = pos - start;
                Py_ssize_t m = alen < blen ? alen : blen;
                int cmp = memcmp(data + prev_start, data + start, m);
                int le = (cmp > 0) ? 0 : (cmp < 0) ? 1 : (alen < blen);
                if (!le) {
                    Py_DECREF(item);
                    Py_DECREF(list);
                    raise_deser("non-canonical frozenset order");
                    return -1;
                }
            }
            prev_start = start;
            prev_end = pos;
            PyList_SET_ITEM(list, i, item);
        }
        PyObject *fs = PyFrozenSet_New(list);
        Py_DECREF(list);
        if (fs == NULL) {
            if (PyErr_ExceptionMatches(PyExc_TypeError)) {
                PyErr_Clear();
                raise_deser("unhashable set member");
            }
            return -1;
        }
        *out = fs;
        return pos;
    }
    case TAG_OBJECT: {
        Py_ssize_t n;
        pos = read_size(data, len, pos, &n);
        if (pos < 0)
            return -1;
        if (n > len - pos) {
            raise_deser("truncated wire name");
            return -1;
        }
        PyObject *name = PyUnicode_DecodeUTF8((const char *)data + pos, n,
                                              NULL);
        if (name == NULL) {
            PyErr_Clear();
            raise_deser("invalid wire name");
            return -1;
        }
        pos += n;
        Py_ssize_t nfields;
        pos = read_size(data, len, pos, &nfields);
        if (pos < 0) {
            Py_DECREF(name);
            return -1;
        }
        if (nfields > len - pos) {
            Py_DECREF(name);
            raise_deser("collection count exceeds data");
            return -1;
        }
        PyObject *values = PyTuple_New(nfields);
        if (values == NULL) {
            Py_DECREF(name);
            return -1;
        }
        for (Py_ssize_t i = 0; i < nfields; i++) {
            PyObject *v = NULL;
            pos = decode_value(data, len, pos, depth + 1, &v);
            if (pos < 0) {
                Py_DECREF(name);
                Py_DECREF(values);
                return -1;
            }
            PyTuple_SET_ITEM(values, i, v);
        }
        PyObject *obj = PyObject_CallFunctionObjArgs(construct_cb, name,
                                                     values, NULL);
        Py_DECREF(name);
        Py_DECREF(values);
        if (obj == NULL)
            return -1;
        *out = obj;
        return pos;
    }
    default: {
        char msg[48];
        snprintf(msg, sizeof(msg), "unknown tag 0x%02x", tag);
        raise_deser(msg);
        return -1;
    }
    }
}

/* ------------------------------------------------------------------ encode */

/* Python-side hooks for the object branch (set by init). */
static PyObject *object_parts_cb = NULL; /* value -> bytes | (name, fields, memo) */
static PyObject *memo_store_cb = NULL;   /* (value, enc_bytes) -> None */

typedef struct {
    unsigned char *buf;
    Py_ssize_t len;
    Py_ssize_t cap;
} Buf;

static int
buf_reserve(Buf *b, Py_ssize_t extra)
{
    if (b->len + extra <= b->cap)
        return 0;
    Py_ssize_t cap = b->cap ? b->cap : 256;
    while (cap < b->len + extra)
        cap *= 2;
    unsigned char *nb = PyMem_Realloc(b->buf, cap);
    if (nb == NULL) {
        PyErr_NoMemory();
        return -1;
    }
    b->buf = nb;
    b->cap = cap;
    return 0;
}

static int
buf_byte(Buf *b, unsigned char c)
{
    if (buf_reserve(b, 1) < 0)
        return -1;
    b->buf[b->len++] = c;
    return 0;
}

static int
buf_bytes(Buf *b, const unsigned char *p, Py_ssize_t n)
{
    if (buf_reserve(b, n) < 0)
        return -1;
    memcpy(b->buf + b->len, p, n);
    b->len += n;
    return 0;
}

static int
buf_varint(Buf *b, unsigned long long n)
{
    while (1) {
        unsigned char c = n & 0x7F;
        n >>= 7;
        if (n) {
            if (buf_byte(b, c | 0x80) < 0)
                return -1;
        }
        else {
            return buf_byte(b, c);
        }
    }
}

static int encode_value(Buf *b, PyObject *value, int depth);

/* Encode one value into a fresh bytes object (for dict/frozenset entry
 * sorting). */
static PyObject *
encode_to_bytes(PyObject *value, int depth)
{
    Buf sub = {NULL, 0, 0};
    if (encode_value(&sub, value, depth) < 0) {
        PyMem_Free(sub.buf);
        return NULL;
    }
    PyObject *out = PyBytes_FromStringAndSize((const char *)sub.buf, sub.len);
    PyMem_Free(sub.buf);
    return out;
}

/* Beyond the decoder's MAX_DEPTH (64) nothing is round-trippable anyway;
 * the headroom only exists so the limit can never bite legitimate data.
 * Raised as RecursionError for parity with the pure encoder, where a cycle
 * or pathological nesting exhausts the interpreter stack catchably —
 * without this guard the C recursion would SEGFAULT the node process. */
#define ENCODE_MAX_DEPTH 200

static int
encode_value(Buf *b, PyObject *value, int depth)
{
    if (depth > ENCODE_MAX_DEPTH) {
        PyErr_SetString(PyExc_RecursionError,
                        "maximum encoding depth exceeded");
        return -1;
    }
    if (value == Py_None)
        return buf_byte(b, TAG_NONE);
    if (value == Py_False)
        return buf_byte(b, TAG_FALSE);
    if (value == Py_True)
        return buf_byte(b, TAG_TRUE);
    if (PyLong_Check(value)) {
        int overflow = 0;
        long long v = PyLong_AsLongLongAndOverflow(value, &overflow);
        /* zigzag fits u64 iff |v| < 2^62-ish; be conservative. */
        if (!overflow && v > -(1LL << 62) && v < (1LL << 62)) {
            unsigned long long zz = (v < 0)
                ? (((unsigned long long)(-(v + 1))) << 1) | 1
                : ((unsigned long long)v) << 1;
            if (buf_byte(b, TAG_INT) < 0)
                return -1;
            return buf_varint(b, zz);
        }
        PyErr_Clear();
        /* Wide integers: delegate to the Python encoder (rare). */
        goto python_fallback;
    }
    if (PyFloat_Check(value)) {
        double d = PyFloat_AS_DOUBLE(value);
        if (!isfinite(d)) {
            PyErr_SetString(PyExc_TypeError,
                            "non-finite floats are not serializable");
            return -1;
        }
        if (d == 0.0)
            d = 0.0; /* normalize -0.0 */
        unsigned long long bits;
        memcpy(&bits, &d, 8);
        if (buf_byte(b, TAG_FLOAT) < 0 || buf_reserve(b, 8) < 0)
            return -1;
        for (int i = 7; i >= 0; i--)
            b->buf[b->len++] = (bits >> (8 * i)) & 0xFF;
        return 0;
    }
    if (PyBytes_Check(value)) {
        Py_ssize_t n = PyBytes_GET_SIZE(value);
        if (buf_byte(b, TAG_BYTES) < 0 || buf_varint(b, n) < 0)
            return -1;
        return buf_bytes(b, (unsigned char *)PyBytes_AS_STRING(value), n);
    }
    if (PyUnicode_Check(value)) {
        Py_ssize_t n;
        const char *utf8 = PyUnicode_AsUTF8AndSize(value, &n);
        if (utf8 == NULL)
            return -1;
        if (buf_byte(b, TAG_STR) < 0 || buf_varint(b, n) < 0)
            return -1;
        return buf_bytes(b, (const unsigned char *)utf8, n);
    }
    if (PyList_Check(value) || PyTuple_Check(value)) {
        Py_ssize_t n = PySequence_Size(value);
        if (n < 0)
            return -1;
        if (buf_byte(b, TAG_LIST) < 0 || buf_varint(b, n) < 0)
            return -1;
        for (Py_ssize_t i = 0; i < n; i++) {
            PyObject *item = PySequence_GetItem(value, i);
            if (item == NULL)
                return -1;
            int rc = encode_value(b, item, depth + 1);
            Py_DECREF(item);
            if (rc < 0)
                return -1;
        }
        return 0;
    }
    if (PyDict_Check(value)) {
        /* Canonical: entries sorted by (key-encoding, value-encoding). */
        PyObject *entries = PyList_New(0);
        if (entries == NULL)
            return -1;
        PyObject *k, *v;
        Py_ssize_t ppos = 0;
        while (PyDict_Next(value, &ppos, &k, &v)) {
            PyObject *kenc = encode_to_bytes(k, depth + 1);
            if (kenc == NULL)
                goto dict_fail;
            PyObject *venc = encode_to_bytes(v, depth + 1);
            if (venc == NULL) {
                Py_DECREF(kenc);
                goto dict_fail;
            }
            PyObject *pair = PyTuple_Pack(2, kenc, venc);
            Py_DECREF(kenc);
            Py_DECREF(venc);
            if (pair == NULL || PyList_Append(entries, pair) < 0) {
                Py_XDECREF(pair);
                goto dict_fail;
            }
            Py_DECREF(pair);
        }
        if (PyList_Sort(entries) < 0)
            goto dict_fail;
        Py_ssize_t n = PyList_GET_SIZE(entries);
        if (buf_byte(b, TAG_DICT) < 0 || buf_varint(b, n) < 0)
            goto dict_fail;
        for (Py_ssize_t i = 0; i < n; i++) {
            PyObject *pair = PyList_GET_ITEM(entries, i);
            PyObject *kenc = PyTuple_GET_ITEM(pair, 0);
            PyObject *venc = PyTuple_GET_ITEM(pair, 1);
            if (buf_bytes(b, (unsigned char *)PyBytes_AS_STRING(kenc),
                          PyBytes_GET_SIZE(kenc)) < 0
                || buf_bytes(b, (unsigned char *)PyBytes_AS_STRING(venc),
                             PyBytes_GET_SIZE(venc)) < 0)
                goto dict_fail;
        }
        Py_DECREF(entries);
        return 0;
    dict_fail:
        Py_DECREF(entries);
        return -1;
    }
    if (PyFrozenSet_Check(value)) {
        PyObject *encs = PyList_New(0);
        if (encs == NULL)
            return -1;
        PyObject *iter = PyObject_GetIter(value);
        if (iter == NULL)
            goto set_fail;
        PyObject *item;
        while ((item = PyIter_Next(iter)) != NULL) {
            PyObject *enc = encode_to_bytes(item, depth + 1);
            Py_DECREF(item);
            if (enc == NULL || PyList_Append(encs, enc) < 0) {
                Py_XDECREF(enc);
                Py_DECREF(iter);
                goto set_fail;
            }
            Py_DECREF(enc);
        }
        Py_DECREF(iter);
        if (PyErr_Occurred())
            goto set_fail;
        if (PyList_Sort(encs) < 0)
            goto set_fail;
        Py_ssize_t n = PyList_GET_SIZE(encs);
        if (buf_byte(b, TAG_FROZENSET) < 0 || buf_varint(b, n) < 0)
            goto set_fail;
        for (Py_ssize_t i = 0; i < n; i++) {
            PyObject *enc = PyList_GET_ITEM(encs, i);
            if (buf_bytes(b, (unsigned char *)PyBytes_AS_STRING(enc),
                          PyBytes_GET_SIZE(enc)) < 0)
                goto set_fail;
        }
        Py_DECREF(encs);
        return 0;
    set_fail:
        Py_DECREF(encs);
        return -1;
    }
    /* Object branch: ask Python for the parts (registry, custom encoders,
     * service tokens, memo reads all live in codec._object_parts). */
    {
        PyObject *parts = PyObject_CallFunctionObjArgs(object_parts_cb,
                                                       value, NULL);
        if (parts == NULL)
            return -1;
        if (PyBytes_Check(parts)) { /* memo hit or fully Python-encoded */
            int rc = buf_bytes(b, (unsigned char *)PyBytes_AS_STRING(parts),
                               PyBytes_GET_SIZE(parts));
            Py_DECREF(parts);
            return rc;
        }
        PyObject *name_raw = PyTuple_GET_ITEM(parts, 0);
        PyObject *fields = PyTuple_GET_ITEM(parts, 1);
        int memoize = PyObject_IsTrue(PyTuple_GET_ITEM(parts, 2));
        Py_ssize_t start = b->len;
        Py_ssize_t nname = PyBytes_GET_SIZE(name_raw);
        Py_ssize_t nfields = PyTuple_GET_SIZE(fields);
        if (buf_byte(b, TAG_OBJECT) < 0 || buf_varint(b, nname) < 0
            || buf_bytes(b, (unsigned char *)PyBytes_AS_STRING(name_raw),
                         nname) < 0
            || buf_varint(b, nfields) < 0) {
            Py_DECREF(parts);
            return -1;
        }
        for (Py_ssize_t i = 0; i < nfields; i++) {
            if (encode_value(b, PyTuple_GET_ITEM(fields, i), depth + 1) < 0) {
                Py_DECREF(parts);
                return -1;
            }
        }
        Py_DECREF(parts);
        if (memoize) {
            PyObject *enc = PyBytes_FromStringAndSize(
                (const char *)b->buf + start, b->len - start);
            if (enc == NULL)
                return -1;
            PyObject *rc = PyObject_CallFunctionObjArgs(memo_store_cb, value,
                                                        enc, NULL);
            Py_DECREF(enc);
            if (rc == NULL)
                return -1;
            Py_DECREF(rc);
        }
        return 0;
    }

python_fallback:
    {
        /* Values the C core does not handle natively (wide integers):
         * object_parts_cb returns their full Python encoding as bytes. */
        PyObject *enc = PyObject_CallFunctionObjArgs(object_parts_cb, value,
                                                     NULL);
        if (enc == NULL)
            return -1;
        if (!PyBytes_Check(enc)) {
            Py_DECREF(enc);
            PyErr_SetString(PyExc_TypeError,
                            "fallback encoding must return bytes");
            return -1;
        }
        int rc = buf_bytes(b, (unsigned char *)PyBytes_AS_STRING(enc),
                           PyBytes_GET_SIZE(enc));
        Py_DECREF(enc);
        return rc;
    }
}

static PyObject *
ccodec_encode(PyObject *self, PyObject *arg)
{
    Buf b = {NULL, 0, 0};
    if (encode_value(&b, arg, 0) < 0) {
        PyMem_Free(b.buf);
        return NULL;
    }
    PyObject *out = PyBytes_FromStringAndSize((const char *)b.buf, b.len);
    PyMem_Free(b.buf);
    return out;
}

static PyObject *
ccodec_decode(PyObject *self, PyObject *arg)
{
    Py_buffer view;
    if (PyObject_GetBuffer(arg, &view, PyBUF_SIMPLE) < 0)
        return NULL;
    PyObject *out = NULL;
    Py_ssize_t pos = decode_value((const unsigned char *)view.buf, view.len,
                                  0, 0, &out);
    if (pos < 0) {
        PyBuffer_Release(&view);
        return NULL;
    }
    if (pos != view.len) {
        Py_DECREF(out);
        char msg[64];
        snprintf(msg, sizeof(msg), "%zd trailing bytes",
                 (Py_ssize_t)(view.len - pos));
        raise_deser(msg);
        PyBuffer_Release(&view);
        return NULL;
    }
    PyBuffer_Release(&view);
    return out;
}

static PyObject *
ccodec_init(PyObject *self, PyObject *args)
{
    PyObject *err_cls, *cb, *parts = NULL, *memo = NULL;
    if (!PyArg_ParseTuple(args, "OO|OO", &err_cls, &cb, &parts, &memo))
        return NULL;
    Py_XDECREF(DeserializationError);
    Py_XDECREF(construct_cb);
    Py_INCREF(err_cls);
    Py_INCREF(cb);
    DeserializationError = err_cls;
    construct_cb = cb;
    if (parts != NULL && memo != NULL) {
        Py_XDECREF(object_parts_cb);
        Py_XDECREF(memo_store_cb);
        Py_INCREF(parts);
        Py_INCREF(memo);
        object_parts_cb = parts;
        memo_store_cb = memo;
    }
    Py_RETURN_NONE;
}

static PyMethodDef ccodec_methods[] = {
    {"decode", ccodec_decode, METH_O,
     "decode(data) -> value; the native form of codec._decode."},
    {"encode", ccodec_encode, METH_O,
     "encode(value) -> bytes; the native form of codec._encode."},
    {"init", ccodec_init, METH_VARARGS,
     "init(DeserializationError, construct_cb[, object_parts, memo_store])."},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef ccodec_module = {
    PyModuleDef_HEAD_INIT, "_ccodec",
    "Native decode core for the corda_tpu_torch canonical codec.", -1,
    ccodec_methods,
};

PyMODINIT_FUNC
PyInit__ccodec(void)
{
    return PyModule_Create(&ccodec_module);
}
