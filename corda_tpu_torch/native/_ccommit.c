/* CRC32C (Castagnoli) of the durable rows' integrity frames, in C.
 *
 * integrity.crc32c calls this core for every row frame the node writes or
 * verifies (checkpoints, raft log, committed and reserved states, vault
 * rows). The Python fallback is a per-byte table loop at ~0.25 us a byte:
 * a 16 KB flow checkpoint costs ~5 ms there and a few us here. The loop
 * is slicing-by-8 in portable C: bytes are assembled one by one, so any
 * alignment and either byte order give the same answer.
 *
 * committed_crc_many serves the pipelined commit plane's columnar PutAll
 * apply (node/services/raft.py make_apply_command -> _put_all_many), which
 * precomputes the committed_states frame for every (state_ref, consuming)
 * row of a sealed batch BEFORE taking db.lock: the whole batch runs
 * between Py_BEGIN/END_ALLOW_THREADS, same playbook as _cverify's
 * sign_many, so it never holds the GIL against the consensus thread's
 * socket pumping.
 *
 * Bit-identical contract: the polynomial (reflected Castagnoli,
 * 0x82F63B78), byte order, init/final XOR, and the committed_crc
 * composition crc32c(consuming, crc32c(state_ref)) all match
 * integrity.py exactly — tests assert equality on reference vectors and
 * random batches; a host that cannot build this core takes the Python
 * path.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stddef.h>
#include <stdint.h>

#define CRC32C_POLY 0x82F63B78u /* reflected 0x1EDC6F41 */

/* crc_table[0] is the byte-at-a-time table; crc_table[k][n] is the CRC of
 * byte n followed by k zero bytes, so eight lookups advance eight bytes. */
static uint32_t crc_table[8][256];

/* Bytes checksummed by this core since the process loaded it (updated
 * under the GIL): integrity.stats() reports it as crc_bytes_native. */
static unsigned long long bytes_done;

static void fill_table(void) {
    for (uint32_t n = 0; n < 256; n++) {
        uint32_t c = n;
        for (int k = 0; k < 8; k++)
            c = (c & 1) ? (c >> 1) ^ CRC32C_POLY : c >> 1;
        crc_table[0][n] = c;
    }
    for (uint32_t n = 0; n < 256; n++)
        for (int k = 1; k < 8; k++)
            crc_table[k][n] = (crc_table[k - 1][n] >> 8)
                              ^ crc_table[0][crc_table[k - 1][n] & 0xFF];
}

static uint32_t crc32c_raw(uint32_t crc, const unsigned char *buf,
                           Py_ssize_t len) {
    uint32_t c = crc ^ 0xFFFFFFFFu;
    while (len >= 8) {
        uint32_t lo = c ^ ((uint32_t)buf[0] | (uint32_t)buf[1] << 8
                           | (uint32_t)buf[2] << 16 | (uint32_t)buf[3] << 24);
        uint32_t hi = (uint32_t)buf[4] | (uint32_t)buf[5] << 8
                      | (uint32_t)buf[6] << 16 | (uint32_t)buf[7] << 24;
        c = crc_table[7][lo & 0xFF] ^ crc_table[6][(lo >> 8) & 0xFF]
            ^ crc_table[5][(lo >> 16) & 0xFF] ^ crc_table[4][lo >> 24]
            ^ crc_table[3][hi & 0xFF] ^ crc_table[2][(hi >> 8) & 0xFF]
            ^ crc_table[1][(hi >> 16) & 0xFF] ^ crc_table[0][hi >> 24];
        buf += 8;
        len -= 8;
    }
    while (len-- > 0)
        c = crc_table[0][(c ^ *buf++) & 0xFF] ^ (c >> 8);
    return c ^ 0xFFFFFFFFu;
}

static PyObject *crc32c_py(PyObject *self, PyObject *args) {
    Py_buffer data;
    unsigned long crc = 0;
    if (!PyArg_ParseTuple(args, "y*|k", &data, &crc))
        return NULL;
    uint32_t out = crc32c_raw((uint32_t)crc, data.buf, data.len);
    bytes_done += (unsigned long long)data.len;
    PyBuffer_Release(&data);
    return PyLong_FromUnsignedLong(out);
}

static PyObject *bytes_checksummed(PyObject *self, PyObject *unused) {
    return PyLong_FromUnsignedLongLong(bytes_done);
}

typedef struct {
    const unsigned char *ref;
    Py_ssize_t ref_len;
    const unsigned char *con;
    Py_ssize_t con_len;
} crc_job;

static PyObject *committed_crc_many(PyObject *self, PyObject *args) {
    PyObject *pairs;
    if (!PyArg_ParseTuple(args, "O", &pairs))
        return NULL;
    PyObject *seq = PySequence_Fast(pairs, "pairs must be a sequence");
    if (seq == NULL)
        return NULL;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
    crc_job *jobs = NULL;
    uint32_t *crcs = NULL;
    PyObject *out = NULL;
    if (n > 0) {
        jobs = PyMem_Malloc(n * sizeof(crc_job));
        crcs = PyMem_Malloc(n * sizeof(uint32_t));
        if (jobs == NULL || crcs == NULL) {
            PyErr_NoMemory();
            goto done;
        }
    }
    /* Collect raw pointers under the GIL; the tuples/bytes stay alive
     * through `seq` for the duration of the call. */
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *pair = PySequence_Fast_GET_ITEM(seq, i);
        PyObject *ref, *con;
        if (PyTuple_Check(pair) && PyTuple_GET_SIZE(pair) == 2) {
            ref = PyTuple_GET_ITEM(pair, 0);
            con = PyTuple_GET_ITEM(pair, 1);
        } else {
            PyErr_SetString(PyExc_TypeError,
                            "each pair must be a (ref, consuming) tuple");
            goto done;
        }
        if (!PyBytes_Check(ref) || !PyBytes_Check(con)) {
            PyErr_SetString(PyExc_TypeError, "pair members must be bytes");
            goto done;
        }
        jobs[i].ref = (const unsigned char *)PyBytes_AS_STRING(ref);
        jobs[i].ref_len = PyBytes_GET_SIZE(ref);
        jobs[i].con = (const unsigned char *)PyBytes_AS_STRING(con);
        jobs[i].con_len = PyBytes_GET_SIZE(con);
    }
    unsigned long long total = 0;
    Py_BEGIN_ALLOW_THREADS
    for (Py_ssize_t i = 0; i < n; i++) {
        uint32_t inner = crc32c_raw(0, jobs[i].ref, jobs[i].ref_len);
        crcs[i] = crc32c_raw(inner, jobs[i].con, jobs[i].con_len);
        total += (unsigned long long)(jobs[i].ref_len + jobs[i].con_len);
    }
    Py_END_ALLOW_THREADS
    bytes_done += total;
    out = PyList_New(n);
    if (out == NULL)
        goto done;
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *v = PyLong_FromUnsignedLong(crcs[i]);
        if (v == NULL) {
            Py_DECREF(out);
            out = NULL;
            goto done;
        }
        PyList_SET_ITEM(out, i, v);
    }
done:
    PyMem_Free(jobs);
    PyMem_Free(crcs);
    Py_DECREF(seq);
    return out;
}

static PyMethodDef methods[] = {
    {"crc32c", crc32c_py, METH_VARARGS,
     "crc32c(data, crc=0) -> int: CRC32C (Castagnoli), bit-identical to "
     "integrity.crc32c."},
    {"committed_crc_many", committed_crc_many, METH_VARARGS,
     "committed_crc_many([(state_ref, consuming), ...]) -> [int]: the "
     "committed_states integrity frame for a whole columnar batch, GIL "
     "released across the computation."},
    {"bytes_checksummed", bytes_checksummed, METH_NOARGS,
     "bytes_checksummed() -> int: bytes this core has checksummed since "
     "the process loaded it."},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef module = {
    PyModuleDef_HEAD_INIT, "_ccommit",
    "Batched CRC32C integrity frames (GIL-free hot loop).",
    -1, methods,
};

PyMODINIT_FUNC PyInit__ccommit(void) {
    fill_table();
    return PyModule_Create(&module);
}
