/* Batched Ed25519 verification and word packing over libcrypto, with the
 * GIL released.
 *
 * The port's own copy of corda_tpu/native/_cverify.c (verify_many,
 * pack_words and their thread fan-out; the port imports nothing of
 * corda_tpu). Built at first use by corda_tpu_torch/native/__init__.py.
 *
 * verify_many is an ACCEPT-FAST path only: libcrypto enforces S < L, which
 * the oracle (crypto/ref_ed25519.py) does not, so any signature it rejects
 * is re-checked by the caller on the authoritative oracle. Its accept set
 * is a subset of the oracle's.
 *
 * pack_words is the host packer of the device-hash verify path: it writes
 * the (8, bucket) uint32 word arrays that ops/ed25519.py's numpy packer
 * writes, byte for byte, with the same ValueErrors in the same order.
 *
 * libcrypto is declared extern (no OpenSSL headers needed) and the loader
 * links the installed libcrypto shared object directly. The symbols used
 * are in OpenSSL 1.1.1+'s stable ABI.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <pthread.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

typedef struct evp_pkey_st EVP_PKEY;
typedef struct evp_md_ctx_st EVP_MD_CTX;
typedef struct evp_md_st EVP_MD;
typedef struct engine_st ENGINE;
typedef struct evp_pkey_ctx_st EVP_PKEY_CTX;

extern EVP_PKEY *EVP_PKEY_new_raw_public_key(
    int type, ENGINE *e, const unsigned char *key, size_t keylen);
extern void EVP_PKEY_free(EVP_PKEY *pkey);
extern EVP_MD_CTX *EVP_MD_CTX_new(void);
extern void EVP_MD_CTX_free(EVP_MD_CTX *ctx);
extern int EVP_DigestVerifyInit(
    EVP_MD_CTX *ctx, EVP_PKEY_CTX **pctx, const EVP_MD *type, ENGINE *e,
    EVP_PKEY *pkey);
extern int EVP_DigestVerify(
    EVP_MD_CTX *ctx, const unsigned char *sig, size_t siglen,
    const unsigned char *tbs, size_t tbslen);

#define EVP_PKEY_ED25519 1087

typedef struct {
    const unsigned char *pk;
    const unsigned char *msg;
    Py_ssize_t msg_len;
    const unsigned char *sig;
    int ok;       /* result: 1 accept, 0 reject-or-skip */
    int eligible; /* well-formed enough to try (32B key, 64B sig) */
} job_t;

/* One verify. A fresh ctx per job: EVP_MD_CTX re-init across keys is
 * legal but buys nothing measurable for ed25519, and fresh state can
 * never leak a previous job's pkey on an error path. */
static int verify_one(const job_t *j) {
    EVP_PKEY *pkey = EVP_PKEY_new_raw_public_key(
        EVP_PKEY_ED25519, NULL, j->pk, 32);
    if (pkey == NULL)
        return 0;
    EVP_MD_CTX *ctx = EVP_MD_CTX_new();
    if (ctx == NULL) {
        EVP_PKEY_free(pkey);
        return 0;
    }
    int ok = 0;
    if (EVP_DigestVerifyInit(ctx, NULL, NULL, NULL, pkey) == 1
        && EVP_DigestVerify(ctx, j->sig, 64, j->msg,
                            (size_t)j->msg_len) == 1)
        ok = 1;
    EVP_MD_CTX_free(ctx);
    EVP_PKEY_free(pkey);
    return ok;
}

typedef struct {
    job_t *jobs;
    Py_ssize_t lo, hi;
} span_t;

static void *worker(void *arg) {
    span_t *s = (span_t *)arg;
    for (Py_ssize_t i = s->lo; i < s->hi; i++) {
        if (s->jobs[i].eligible)
            s->jobs[i].ok = verify_one(&s->jobs[i]);
    }
    return NULL;
}

/* Fan a big batch across a few pthreads (libcrypto's EVP verify is
 * thread-safe on independent ctx/pkey objects). Small batches stay
 * single-threaded — thread spawn costs more than they do. Capped at 4:
 * the deployment shape is several node processes sharing one small host,
 * and a verify flush must not starve its siblings. */
#define PAR_MIN 64
#define PAR_MAX_THREADS 4

#include <unistd.h>

static void run_jobs(job_t *jobs, Py_ssize_t n) {
    int nthreads = n >= PAR_MIN ? (int)(n / (PAR_MIN / 2)) : 1;
    if (nthreads > PAR_MAX_THREADS)
        nthreads = PAR_MAX_THREADS;
    long cores = sysconf(_SC_NPROCESSORS_ONLN);
    if (cores > 0 && nthreads > cores)
        nthreads = (int)cores; /* 1-core hosts: skip thread overhead */
    if (nthreads <= 1) {
        span_t all = {jobs, 0, n};
        worker(&all);
        return;
    }
    pthread_t tids[PAR_MAX_THREADS];
    span_t spans[PAR_MAX_THREADS];
    Py_ssize_t chunk = (n + nthreads - 1) / nthreads;
    int started = 0;
    for (int t = 0; t < nthreads; t++) {
        Py_ssize_t lo = (Py_ssize_t)t * chunk;
        Py_ssize_t hi = lo + chunk < n ? lo + chunk : n;
        if (lo >= hi)
            break;
        spans[t].jobs = jobs;
        spans[t].lo = lo;
        spans[t].hi = hi;
        if (t < nthreads - 1 && hi < n) {
            /* tids is compacted by success count, not span index: a failed
             * create must not leave a hole the join loop would read. */
            if (pthread_create(&tids[started], NULL, worker, &spans[t]) == 0) {
                started++;
                continue;
            }
        }
        /* last span (or a failed spawn) runs on this thread */
        worker(&spans[t]);
    }
    for (int t = 0; t < started; t++)
        pthread_join(tids[t], NULL);
}

/* verify_many(pubkeys, msgs, sigs) -> bytes (one 0/1 byte per job).
 *
 * Buffers are captured under the GIL; the verify loop runs without it. */
static PyObject *verify_many(PyObject *self, PyObject *args) {
    PyObject *pks, *msgs, *sigs;
    if (!PyArg_ParseTuple(args, "OOO", &pks, &msgs, &sigs))
        return NULL;
    PyObject *pk_seq = PySequence_Fast(pks, "pubkeys must be a sequence");
    if (pk_seq == NULL)
        return NULL;
    PyObject *msg_seq = PySequence_Fast(msgs, "msgs must be a sequence");
    if (msg_seq == NULL) {
        Py_DECREF(pk_seq);
        return NULL;
    }
    PyObject *sig_seq = PySequence_Fast(sigs, "sigs must be a sequence");
    if (sig_seq == NULL) {
        Py_DECREF(pk_seq);
        Py_DECREF(msg_seq);
        return NULL;
    }
    Py_ssize_t n = PySequence_Fast_GET_SIZE(pk_seq);
    if (PySequence_Fast_GET_SIZE(msg_seq) != n
        || PySequence_Fast_GET_SIZE(sig_seq) != n) {
        Py_DECREF(pk_seq);
        Py_DECREF(msg_seq);
        Py_DECREF(sig_seq);
        PyErr_SetString(PyExc_ValueError, "length mismatch");
        return NULL;
    }

    job_t *jobs = NULL;
    Py_buffer *views = NULL;
    Py_ssize_t n_views = 0;
    PyObject *out = NULL;
    if (n > 0) {
        jobs = PyMem_Calloc((size_t)n, sizeof(job_t));
        views = PyMem_Calloc((size_t)n * 3, sizeof(Py_buffer));
        if (jobs == NULL || views == NULL) {
            PyErr_NoMemory();
            goto done;
        }
    }
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *items[3] = {
            PySequence_Fast_GET_ITEM(pk_seq, i),
            PySequence_Fast_GET_ITEM(msg_seq, i),
            PySequence_Fast_GET_ITEM(sig_seq, i),
        };
        Py_buffer bufs[3];
        int got = 0;
        for (; got < 3; got++) {
            if (PyObject_GetBuffer(items[got], &bufs[got],
                                   PyBUF_SIMPLE) != 0)
                break;
        }
        if (got < 3) {
            /* Unbufferable input: ineligible (reject -> oracle re-check),
             * never an exception — malformed jobs must reject, not raise. */
            PyErr_Clear();
            for (int k = 0; k < got; k++)
                PyBuffer_Release(&bufs[k]);
            continue;
        }
        for (int k = 0; k < 3; k++)
            views[n_views++] = bufs[k];
        if (bufs[0].len == 32 && bufs[2].len == 64) {
            jobs[i].pk = bufs[0].buf;
            jobs[i].msg = bufs[1].buf;
            jobs[i].msg_len = bufs[1].len;
            jobs[i].sig = bufs[2].buf;
            jobs[i].eligible = 1;
        }
    }

    Py_BEGIN_ALLOW_THREADS
    run_jobs(jobs, n);
    Py_END_ALLOW_THREADS

    out = PyBytes_FromStringAndSize(NULL, n);
    if (out != NULL) {
        char *p = PyBytes_AS_STRING(out);
        for (Py_ssize_t i = 0; i < n; i++)
            p[i] = (char)(jobs ? jobs[i].ok : 0);
    }

done:
    for (Py_ssize_t k = 0; k < n_views; k++)
        PyBuffer_Release(&views[k]);
    PyMem_Free(views);
    PyMem_Free(jobs);
    Py_DECREF(pk_seq);
    Py_DECREF(msg_seq);
    Py_DECREF(sig_seq);
    return out;
}

/* pack_words(pubkeys, msgs, sigs, bucket) -> (a, r, s, m) bytes objects.
 *
 * Host packing for the device-hash verify path: each output is the raw
 * memory of an (8, bucket) uint32 word-major array — out[w*B + i] is the
 * little-endian 32-bit word at encoding[i][4w..4w+3]; lanes beyond n are
 * zero. It replaces the numpy packer (ops/ed25519.py: per-item bytes() +
 * b"".join + frombuffer + transpose-copy) where it builds. Semantics match
 * the numpy path exactly: every pk and msg must be 32 bytes and every sig
 * 64, else ValueError.
 *
 * The fill loops run with the GIL RELEASED (buffers captured first), so a
 * node's transport threads keep moving while a 64k-lane batch packs.
 */
static int fill_words(uint32_t *dst, Py_ssize_t B, Py_ssize_t n,
                      const unsigned char **src, Py_ssize_t off,
                      Py_ssize_t nwords) {
    for (Py_ssize_t i = 0; i < n; i++) {
        const unsigned char *e = src[i] + off;
        for (Py_ssize_t w = 0; w < nwords; w++) {
            dst[w * B + i] = (uint32_t)e[4 * w]
                             | ((uint32_t)e[4 * w + 1] << 8)
                             | ((uint32_t)e[4 * w + 2] << 16)
                             | ((uint32_t)e[4 * w + 3] << 24);
        }
    }
    return 0;
}

static PyObject *pack_words(PyObject *self, PyObject *args) {
    PyObject *pks, *msgs, *sigs;
    Py_ssize_t bucket;
    if (!PyArg_ParseTuple(args, "OOOn", &pks, &msgs, &sigs, &bucket))
        return NULL;
    PyObject *seqs[3] = {NULL, NULL, NULL};
    PyObject *result = NULL;
    Py_buffer *views = NULL;
    const unsigned char **ptrs = NULL;
    Py_ssize_t n_views = 0;
    PyObject *outs[4] = {NULL, NULL, NULL, NULL};

    seqs[0] = PySequence_Fast(pks, "pubkeys must be a sequence");
    seqs[1] = PySequence_Fast(msgs, "msgs must be a sequence");
    seqs[2] = PySequence_Fast(sigs, "sigs must be a sequence");
    if (seqs[0] == NULL || seqs[1] == NULL || seqs[2] == NULL)
        goto done;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(seqs[0]);
    if (PySequence_Fast_GET_SIZE(seqs[1]) != n
        || PySequence_Fast_GET_SIZE(seqs[2]) != n) {
        PyErr_SetString(PyExc_ValueError,
                        "pubkeys, msgs and sigs must have equal length");
        goto done;
    }
    if (bucket < n) {
        PyErr_SetString(PyExc_ValueError, "bucket smaller than batch");
        goto done;
    }
    if (n > 0) {
        views = PyMem_Calloc((size_t)n * 3, sizeof(Py_buffer));
        ptrs = PyMem_Calloc((size_t)n * 3, sizeof(unsigned char *));
        if (views == NULL || ptrs == NULL) {
            PyErr_NoMemory();
            goto done;
        }
    }
    static const Py_ssize_t want_len[3] = {32, 32, 64};
    static const char *len_err[3] = {
        "pubkeys must be 32 bytes",
        "device-hash path requires 32-byte messages",
        "sigs must be 64 bytes",
    };
    for (Py_ssize_t i = 0; i < n; i++) {
        for (int k = 0; k < 3; k++) {
            PyObject *item = PySequence_Fast_GET_ITEM(seqs[k], i);
            if (PyObject_GetBuffer(item, &views[n_views],
                                   PyBUF_SIMPLE) != 0)
                goto done; /* propagate (TypeError), matching bytes(m) */
            n_views++;
            if (views[n_views - 1].len != want_len[k]) {
                PyErr_SetString(PyExc_ValueError, len_err[k]);
                goto done;
            }
            ptrs[k * n + i] = views[n_views - 1].buf;
        }
    }
    /* 4 outputs: A (pk), R (sig[:32]), S (sig[32:]), M (msg) — each
     * 8 words x bucket lanes, zero-padded beyond n. */
    for (int k = 0; k < 4; k++) {
        outs[k] = PyBytes_FromStringAndSize(NULL, 8 * bucket * 4);
        if (outs[k] == NULL)
            goto done;
        memset(PyBytes_AS_STRING(outs[k]), 0, (size_t)(8 * bucket * 4));
    }
    {
        uint32_t *a_w = (uint32_t *)PyBytes_AS_STRING(outs[0]);
        uint32_t *r_w = (uint32_t *)PyBytes_AS_STRING(outs[1]);
        uint32_t *s_w = (uint32_t *)PyBytes_AS_STRING(outs[2]);
        uint32_t *m_w = (uint32_t *)PyBytes_AS_STRING(outs[3]);
        const unsigned char **pk_p = ptrs;
        const unsigned char **msg_p = ptrs + n;
        const unsigned char **sig_p = ptrs + 2 * n;
        Py_BEGIN_ALLOW_THREADS
        fill_words(a_w, bucket, n, pk_p, 0, 8);
        fill_words(r_w, bucket, n, sig_p, 0, 8);
        fill_words(s_w, bucket, n, sig_p, 32, 8);
        fill_words(m_w, bucket, n, msg_p, 0, 8);
        Py_END_ALLOW_THREADS
    }
    result = PyTuple_Pack(4, outs[0], outs[1], outs[2], outs[3]);

done:
    for (Py_ssize_t k = 0; k < n_views; k++)
        PyBuffer_Release(&views[k]);
    PyMem_Free(views);
    PyMem_Free(ptrs);
    for (int k = 0; k < 4; k++)
        Py_XDECREF(outs[k]);
    Py_XDECREF(seqs[0]);
    Py_XDECREF(seqs[1]);
    Py_XDECREF(seqs[2]);
    return result;
}

static PyMethodDef methods[] = {
    {"verify_many", verify_many, METH_VARARGS,
     "Batch Ed25519 verify via libcrypto, GIL released; returns one 0/1 "
     "byte per job. Accept-fast only: rejects need an oracle re-check."},
    {"pack_words", pack_words, METH_VARARGS,
     "pack_words(pks, msgs, sigs, bucket) -> (a, r, s, m) raw (8, bucket) "
     "uint32 word arrays for the device-hash verify path; GIL released "
     "during the fill."},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef module = {
    PyModuleDef_HEAD_INIT, "_cverify",
    "Batched libcrypto Ed25519 verification and word packing (GIL-free).",
    -1, methods,
};

PyMODINIT_FUNC PyInit__cverify(void) { return PyModule_Create(&module); }
