/* Batched Ed25519 verification and word packing over libcrypto, with the
 * GIL released.
 *
 * The port's own copy of corda_tpu/native/_cverify.c (verify_many,
 * pack_words, sign_many and their thread fan-out; the port imports nothing
 * of corda_tpu). Built at first use by corda_tpu_torch/native/__init__.py.
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
 * pack_jobs is the same packer fed from the job objects themselves: one
 * pass over a list of ed25519 VerifyJob reads each job's fields, applies
 * the `good` filter, and writes the well-formed jobs' words into a
 * caller's buffer (crypto/provider.py, TorchVerifier). It reads a slotted
 * VerifyJob's fields by offset, spread over the calling thread's cores.
 *
 * libcrypto is declared extern (no OpenSSL headers needed) and the loader
 * links the installed libcrypto shared object directly. The symbols used
 * are in OpenSSL 1.1.1+'s stable ABI.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <pthread.h>
#include <sched.h>
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
extern EVP_PKEY *EVP_PKEY_new_raw_private_key(
    int type, ENGINE *e, const unsigned char *key, size_t keylen);
extern int EVP_DigestSignInit(
    EVP_MD_CTX *ctx, EVP_PKEY_CTX **pctx, const EVP_MD *type, ENGINE *e,
    EVP_PKEY *pkey);
extern int EVP_DigestSign(
    EVP_MD_CTX *ctx, unsigned char *sigret, size_t *siglen,
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

/* pack_jobs(jobs, out, threads=0) -> (n_good, held, threads), or None.
 *
 * One pass over a sequence of ed25519 VerifyJob. A job is well formed when
 * its pubkey is 32 bytes and, then, its sig 64 (the provider's `good`
 * filter); the k-th well-formed one's A, R = sig[:32], S = sig[32:] and M
 * words go to lane k of the (4, 8, n_good) int32 block that the pass
 * leaves at the front of `out`, word-major as pack_words writes each
 * (8, n_good) array. `out` is any writable, 4-byte-aligned buffer of at
 * least 128 bytes a job; the pass writes at a stride of len(jobs) lanes
 * and closes the rows up once it knows n_good.
 *
 * held is None when every job was well formed; else the int64 positions
 * of the malformed ones (which reject), ascending. A malformed job's
 * fields past the one that rejected it are never read. threads is the
 * number of threads the pass ran on.
 *
 * None means the batch is not for this pass, and the caller packs it from
 * lists: a job's scheme is not "ed25519" (compared as ==, the interned
 * literal first), a field read is not exact bytes, a bytearray or a 1-D
 * memoryview of single bytes (or reading it raised), or a well-formed
 * job's message is not 32 bytes (the host-hash path).
 *
 * Two ways to read a job, one answer. The attribute pass reads each field
 * with PyObject_GetAttr on the calling thread. The offset pass takes a
 * batch whose first job's type keeps the generic attribute lookup and
 * holds its four fields in __slots__ (a slotted VerifyJob): each field of
 * a job of exactly that type is a borrowed pointer at a fixed offset, read
 * with no lookup, no reference taken and no Python code run. So the lanes
 * split into contiguous ranges over the calling thread's cores, each
 * range on a thread of its own, while the caller holds the GIL and joins
 * them all before it touches a Python object again. A job of another
 * type, a scheme that is not an exact str (its == may run code) or a
 * bytearray or memoryview field (a buffer export is not a read) sends the
 * whole batch to the attribute pass. `threads` 0 takes as many threads as
 * the calling thread's affinity mask holds cores, one a PASS_MIN_LANES
 * lanes; a positive count names it (tests). Either way at most
 * PASS_MAX_THREADS, and one on a build without the GIL. */
static PyObject *s_scheme, *s_pubkey, *s_message, *s_sig, *s_ed25519;

typedef struct {
    const unsigned char *p;
    Py_ssize_t len;
    Py_buffer view;
    int has_view;
} field_t;

/* A job's field as bytes, or -1 (no exception set) when it is not a type
 * whose len() is its byte count. A bytearray or memoryview is held by an
 * exported buffer, which no getter run later in the pass can resize. */
static int field_get(PyObject *o, field_t *f) {
    f->has_view = 0;
    if (PyBytes_CheckExact(o)) {
        f->p = (const unsigned char *)PyBytes_AS_STRING(o);
        f->len = PyBytes_GET_SIZE(o);
        return 0;
    }
    if (!PyByteArray_CheckExact(o) && !PyMemoryView_Check(o))
        return -1;
    if (PyObject_GetBuffer(o, &f->view, PyBUF_FULL_RO) != 0) {
        PyErr_Clear();
        return -1;
    }
    f->has_view = 1;
    if (f->view.ndim != 1 || f->view.itemsize != 1
        || !PyBuffer_IsContiguous(&f->view, 'C'))
        return -1;
    f->p = f->view.buf;
    f->len = f->view.len;
    return 0;
}

static void field_release(field_t *f) {
    if (f->has_view)
        PyBuffer_Release(&f->view);
    f->has_view = 0;
}

/* The job's attribute `name` read as a field: 0, or -1 (nothing set). */
static int job_field(PyObject *job, PyObject *name, PyObject **attr,
                     field_t *f) {
    *attr = PyObject_GetAttr(job, name);
    if (*attr == NULL) {
        PyErr_Clear();
        return -1;
    }
    return field_get(*attr, f);
}

/* 1 when the job's scheme is "ed25519", 0 when not or reading it raised
 * (nothing set). */
static int is_ed25519(PyObject *job) {
    PyObject *scheme = PyObject_GetAttr(job, s_scheme);
    if (scheme == NULL) {
        PyErr_Clear();
        return 0;
    }
    int eq = scheme == s_ed25519
                 ? 1 : PyObject_RichCompareBool(scheme, s_ed25519, Py_EQ);
    Py_DECREF(scheme);
    if (eq < 0)
        PyErr_Clear();
    return eq == 1;
}

/* The little-endian 32-bit word at p: one load on a little-endian host,
 * where assembling it from four bytes took the pass ~400 instructions a
 * lane. */
static inline uint32_t le32(const unsigned char *p) {
#if defined(__BYTE_ORDER__) && __BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__
    uint32_t v;
    memcpy(&v, p, sizeof v);
    return v;
#else
    return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16)
           | ((uint32_t)p[3] << 24);
#endif
}

static inline void put_words(uint32_t *dst, Py_ssize_t stride,
                             const unsigned char *e) {
    for (int w = 0; w < 8; w++)
        dst[w * stride] = le32(e + 4 * w);
}

/* What a pass makes of a lane. BY_ATTR (the offset pass only): the lane
 * needs the attribute pass; NOMEM: the held list could not grow. */
enum {
    LANE_HELD = 0, LANE_GOOD = 1, LANE_REFUSE = -1, LANE_BY_ATTR = -2,
    LANE_NOMEM = -3,
};

/* The lanes lo..hi of a pass: the well-formed ones packed to lanes lo ..
 * lo + n_good of the rows, the malformed ones' positions in `held`, and
 * the outcome that ended the range early, if one did (`stop`). */
typedef struct {
    PyObject *const *items;
    const struct slots *slots;
    uint32_t *words;
    Py_ssize_t stride, lo, hi, n_good;
    int64_t *held;
    Py_ssize_t n_held, cap_held;
    int stop;
} range_t;

/* Thread-safe (raw allocator): the offset pass's threads call it. */
static int held_add(range_t *r, Py_ssize_t i) {
    if (r->n_held == r->cap_held) {
        Py_ssize_t cap = r->cap_held ? 2 * r->cap_held : 16;
        int64_t *h = PyMem_RawRealloc(r->held, (size_t)cap * sizeof(int64_t));
        if (h == NULL)
            return -1;
        r->held = h;
        r->cap_held = cap;
    }
    r->held[r->n_held++] = (int64_t)i;
    return 0;
}

/* One job by attribute: GOOD when its words went to `lane` (rows
 * `stride` words apart), HELD when it is malformed, REFUSE (nothing set)
 * to refuse the batch. */
static int pack_one(PyObject *job, uint32_t *lane, Py_ssize_t stride) {
    if (!is_ed25519(job))
        return LANE_REFUSE;
    PyObject *pk_o = NULL, *sig_o = NULL, *msg_o = NULL;
    field_t pk, sig, msg; /* only has_view needs a value up front */
    pk.has_view = sig.has_view = msg.has_view = 0;
    int rc = LANE_REFUSE;
    if (job_field(job, s_pubkey, &pk_o, &pk) != 0)
        goto out;
    if (pk.len != 32) {
        rc = LANE_HELD;
        goto out;
    }
    if (job_field(job, s_sig, &sig_o, &sig) != 0)
        goto out;
    if (sig.len != 64) {
        rc = LANE_HELD;
        goto out;
    }
    if (job_field(job, s_message, &msg_o, &msg) != 0 || msg.len != 32)
        goto out;
    put_words(lane, stride, pk.p);
    put_words(lane + 8 * stride, stride, sig.p);
    put_words(lane + 16 * stride, stride, sig.p + 32);
    put_words(lane + 24 * stride, stride, msg.p);
    rc = LANE_GOOD;
out:
    field_release(&msg);
    field_release(&sig);
    field_release(&pk);
    Py_XDECREF(msg_o);
    Py_XDECREF(sig_o);
    Py_XDECREF(pk_o);
    return rc;
}

/* The attribute pass: every lane as one range, on the calling thread. A
 * field's getter may run Python code that edits the list: each job is
 * held while it is read, and a list whose length moved is refused. */
static int pack_by_attr(PyObject *seq, range_t *r) {
    for (Py_ssize_t i = 0; i < r->hi; i++) {
        if (PySequence_Fast_GET_SIZE(seq) != r->hi)
            return LANE_REFUSE;
        PyObject *job = PySequence_Fast_GET_ITEM(seq, i);
        Py_INCREF(job);
        int rc = pack_one(job, r->words + r->n_good, r->stride);
        Py_DECREF(job);
        if (rc == LANE_GOOD)
            r->n_good++;
        else if (rc == LANE_HELD) {
            if (held_add(r, i) != 0)
                return LANE_NOMEM;
        } else
            return rc;
    }
    return LANE_GOOD;
}

#ifndef Py_T_OBJECT_EX /* before 3.12 */
#include <structmember.h>
#define Py_T_OBJECT_EX T_OBJECT_EX
#define Py_READONLY READONLY
#endif

/* A type's four fields as offsets into its objects, in the order a job
 * is judged. */
enum { F_SCHEME, F_PUBKEY, F_SIG, F_MESSAGE };

struct slots {
    PyTypeObject *type;
    Py_ssize_t off[4];
};

/* 1, filling `s`, when reading `tp`'s four fields by the generic lookup
 * is reading its __slots__ members: the object's own pointer at a fixed
 * offset, an unset one raising AttributeError. Else 0. */
static int slots_of(PyTypeObject *tp, struct slots *s) {
    PyObject *names[4] = {s_scheme, s_pubkey, s_sig, s_message};
    if (tp->tp_getattro != PyObject_GenericGetAttr)
        return 0;
    for (int k = 0; k < 4; k++) {
        PyObject *d = _PyType_Lookup(tp, names[k]);
        if (d == NULL || !Py_IS_TYPE(d, &PyMemberDescr_Type))
            return 0;
        PyMemberDef *m = ((PyMemberDescrObject *)d)->d_member;
        if (m->type != Py_T_OBJECT_EX || (m->flags & ~Py_READONLY) != 0)
            return 0;
        s->off[k] = m->offset;
    }
    s->type = tp;
    return 1;
}

static inline PyObject *slot_at(PyObject *job, Py_ssize_t off) {
    return *(PyObject **)((char *)job + off);
}

/* A slot as exact bytes: 0 with its data, else what the attribute pass
 * would make of it. An unset slot raises there, and a type that is not
 * bytes-like fails field_get: REFUSE. A bytearray or memoryview wants an
 * exported buffer: BY_ATTR. */
static inline int slot_bytes(PyObject *o, const unsigned char **p,
                             Py_ssize_t *len) {
    if (o != NULL && PyBytes_CheckExact(o)) {
        *p = (const unsigned char *)PyBytes_AS_STRING(o);
        *len = PyBytes_GET_SIZE(o);
        return 0;
    }
    if (o != NULL && (PyByteArray_CheckExact(o) || PyMemoryView_Check(o)))
        return LANE_BY_ATTR;
    return LANE_REFUSE;
}

/* The scheme slot: GOOD for the interned literal, or an exact str equal
 * to it by its data (str keeps the narrowest kind, as its == relies on);
 * REFUSE for an unset slot or another exact str; BY_ATTR for any other
 * type, whose == may run Python code. */
static inline int slot_scheme(PyObject *o) {
    if (o == s_ed25519)
        return LANE_GOOD;
    if (o == NULL)
        return LANE_REFUSE;
    if (!PyUnicode_CheckExact(o))
        return LANE_BY_ATTR;
    return PyUnicode_GET_LENGTH(o) == 7
                   && PyUnicode_KIND(o) == PyUnicode_1BYTE_KIND
                   && memcmp(PyUnicode_DATA(o), "ed25519", 7) == 0
               ? LANE_GOOD : LANE_REFUSE;
}

/* One job by offset, judged in pack_one's order: the scheme, the pubkey's
 * type then length, the sig's, the message's. */
static int lane_by_offset(PyObject *job, const struct slots *s,
                          uint32_t *lane, Py_ssize_t stride) {
    const unsigned char *pk, *sig, *msg;
    Py_ssize_t pk_len, sig_len, msg_len;
    int rc;
    if (Py_TYPE(job) != s->type)
        return LANE_BY_ATTR;
    if ((rc = slot_scheme(slot_at(job, s->off[F_SCHEME]))) != LANE_GOOD)
        return rc;
    if ((rc = slot_bytes(slot_at(job, s->off[F_PUBKEY]), &pk, &pk_len)))
        return rc;
    if (pk_len != 32)
        return LANE_HELD;
    if ((rc = slot_bytes(slot_at(job, s->off[F_SIG]), &sig, &sig_len)))
        return rc;
    if (sig_len != 64)
        return LANE_HELD;
    if ((rc = slot_bytes(slot_at(job, s->off[F_MESSAGE]), &msg, &msg_len)))
        return rc;
    if (msg_len != 32)
        return LANE_REFUSE;
    put_words(lane, stride, pk);
    put_words(lane + 8 * stride, stride, sig);
    put_words(lane + 16 * stride, stride, sig + 32);
    put_words(lane + 24 * stride, stride, msg);
    return LANE_GOOD;
}

/* One range of the offset pass; runs with the GIL held by the caller, on
 * whichever thread. It stops at the first lane that is neither GOOD nor
 * HELD: that outcome decides the batch whatever the later lanes hold. */
static void *pack_range(void *arg) {
    range_t *r = (range_t *)arg;
    for (Py_ssize_t i = r->lo; i < r->hi; i++) {
        int rc = lane_by_offset(r->items[i], r->slots,
                                r->words + r->lo + r->n_good, r->stride);
        if (rc == LANE_GOOD)
            r->n_good++;
        else if (rc != LANE_HELD || held_add(r, i) != 0) {
            r->stop = rc == LANE_HELD ? LANE_NOMEM : rc;
            break;
        }
    }
    return NULL;
}

/* Lanes a thread of the offset pass gets at least. Measured on an 8-core
 * Intel Xeon host (medians of 100 calls, batch sizes that are not powers
 * of two): a thread's start and join cost 30-45 us; one thread reads a
 * lane in 25-40 ns when the jobs are in cache and ~60 ns when they are
 * not (100,000 lanes: 5.9-6.1 ms on one thread, 3.0-3.1 on two, 2.5-2.6
 * on four). Two threads first beat one at 3,000-4,000 lanes, so a thread
 * takes 4,096 at least: the sidecar's ~800-lane batches stay on one. */
#define PASS_MIN_LANES 4096
#define PASS_MAX_THREADS 16

static int pass_threads(Py_ssize_t n, int asked) {
#ifdef Py_GIL_DISABLED
    /* No GIL to hold other threads off the jobs while they are read. */
    return 1;
#else
    Py_ssize_t t = asked;
    if (t == 0) {
        cpu_set_t set;
        int cores = sched_getaffinity(0, sizeof set, &set) == 0
                        ? CPU_COUNT(&set) : 1;
        t = n / PASS_MIN_LANES < cores ? n / PASS_MIN_LANES : cores;
    }
    if (t > PASS_MAX_THREADS)
        t = PASS_MAX_THREADS;
    if (t > n)
        t = n;
    return t < 1 ? 1 : (int)t;
#endif
}

/* The offset pass over `ranges` (set up by the caller): GOOD when no
 * range stopped early, else NOMEM or BY_ATTR when a range stopped so,
 * else REFUSE. Range 0, and any range whose thread did not start, runs on
 * the calling thread; `*ran` is the number of threads that ran ranges. */
static int pack_by_offset(range_t *ranges, int nr, int *ran) {
    pthread_t tids[PASS_MAX_THREADS];
    int spawned[PASS_MAX_THREADS] = {0};
    *ran = 1;
    for (int t = 1; t < nr; t++) {
        spawned[t] = pthread_create(&tids[t], NULL, pack_range,
                                    &ranges[t]) == 0;
        *ran += spawned[t];
    }
    for (int t = 0; t < nr; t++) {
        if (t == 0 || !spawned[t])
            pack_range(&ranges[t]);
    }
    for (int t = 1; t < nr; t++) {
        if (spawned[t])
            pthread_join(tids[t], NULL);
    }
    /* BY_ATTR anywhere reruns the batch by attribute, which judges every
     * lane as it judges a batch of any other type; else a REFUSE anywhere
     * refuses, as the attribute pass would on reaching it (every lane
     * before it reads alike by offset and by attribute, with no code
     * run). */
    int rc = LANE_GOOD;
    for (int t = 0; t < nr; t++) {
        int stop = ranges[t].stop;
        if (stop == LANE_NOMEM || stop == LANE_BY_ATTR)
            return stop;
        if (stop == LANE_REFUSE)
            rc = LANE_REFUSE;
    }
    return rc;
}

/* Close the 32 rows up from a stride of n lanes, each range's packed
 * lanes starting at its lo, to one of n_good, every range's lanes after
 * the ranges before it. Each move's destination lies at or before its
 * source and after every earlier move's source, so moving in order is
 * safe. */
static void close_up(uint32_t *words, Py_ssize_t n, Py_ssize_t n_good,
                     const range_t *ranges, int nr) {
    if (n_good == n)
        return;
    for (int row = 0; row < 32; row++) {
        Py_ssize_t at = row * n_good;
        for (int t = 0; t < nr; t++) {
            const uint32_t *src = words + row * n + ranges[t].lo;
            if (words + at != src)
                memmove(words + at, src,
                        (size_t)ranges[t].n_good * sizeof(uint32_t));
            at += ranges[t].n_good;
        }
    }
}

static PyObject *pack_jobs(PyObject *self, PyObject *args, PyObject *kw) {
    static char *kwlist[] = {"jobs", "out", "threads", NULL};
    PyObject *jobs, *out_obj;
    int threads = 0;
    if (!PyArg_ParseTupleAndKeywords(args, kw, "OO|i", kwlist, &jobs,
                                     &out_obj, &threads))
        return NULL;
    if (threads < 0) {
        PyErr_SetString(PyExc_ValueError, "threads must be 0 or more");
        return NULL;
    }
    PyObject *seq = PySequence_Fast(jobs, "jobs must be a sequence");
    if (seq == NULL)
        return NULL;
    Py_buffer out;
    if (PyObject_GetBuffer(out_obj, &out, PyBUF_WRITABLE) != 0) {
        Py_DECREF(seq);
        return NULL;
    }
    PyObject *result = NULL;
    range_t ranges[PASS_MAX_THREADS];
    memset(ranges, 0, sizeof ranges);
    int nr = 0, ran = 1, rc = LANE_BY_ATTR;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
    uint32_t *words = (uint32_t *)out.buf;
    if (out.len / 128 < n || (n > 0 && ((uintptr_t)out.buf & 3) != 0)) {
        PyErr_SetString(PyExc_ValueError,
                        "out must be 4-byte aligned and hold 128 bytes a job");
        goto done;
    }
    PyObject *const *items = PySequence_Fast_ITEMS(seq);
    struct slots slots;
    if (n > 0 && slots_of(Py_TYPE(items[0]), &slots)) {
        int t = pass_threads(n, threads);
        Py_ssize_t chunk = (n + t - 1) / t;
        for (Py_ssize_t lo = 0; lo < n; lo += chunk, nr++) {
            ranges[nr].items = items;
            ranges[nr].slots = &slots;
            ranges[nr].words = words;
            ranges[nr].stride = n;
            ranges[nr].lo = lo;
            ranges[nr].hi = lo + chunk < n ? lo + chunk : n;
        }
        rc = pack_by_offset(ranges, nr, &ran);
    }
    if (rc == LANE_BY_ATTR) {
        for (int t = 0; t < nr; t++)
            PyMem_RawFree(ranges[t].held);
        memset(ranges, 0, sizeof ranges);
        ranges[0].words = words;
        ranges[0].stride = ranges[0].hi = n;
        nr = ran = 1;
        rc = pack_by_attr(seq, &ranges[0]);
    }
    if (rc == LANE_NOMEM) {
        PyErr_NoMemory();
        goto done;
    }
    if (rc == LANE_REFUSE) {
        result = Py_NewRef(Py_None);
        goto done;
    }
    Py_ssize_t n_good = 0, n_held = 0;
    for (int t = 0; t < nr; t++) {
        n_good += ranges[t].n_good;
        n_held += ranges[t].n_held;
    }
    close_up(words, n, n_good, ranges, nr);
    if (n_held == 0) {
        result = Py_BuildValue("nOi", n_good, Py_None, ran);
    } else {
        PyObject *h = PyBytes_FromStringAndSize(NULL,
                                                n_held * sizeof(int64_t));
        if (h != NULL) {
            char *p = PyBytes_AS_STRING(h);
            for (int t = 0; t < nr; t++) {
                size_t len = (size_t)ranges[t].n_held * sizeof(int64_t);
                if (len)
                    memcpy(p, ranges[t].held, len);
                p += len;
            }
            result = Py_BuildValue("nNi", n_good, h, ran);
        }
    }

done:
    for (int t = 0; t < PASS_MAX_THREADS; t++)
        PyMem_RawFree(ranges[t].held);
    PyBuffer_Release(&out);
    Py_DECREF(seq);
    return result;
}

/* sign_many(seeds, msgs) -> bytes (64 bytes of signature per job).
 *
 * The INGEST mirror of verify_many: columnar layout (seeds and msgs are
 * single contiguous n*32-byte buffers — the batch-sign packer hands the
 * whole corpus over in two allocations, no per-item object traffic) and
 * the sign loop runs with the GIL RELEASED, fanned across the same
 * pthread budget as verify. Ed25519 signing is RFC 8032-deterministic,
 * so libcrypto's output here is byte-identical to both fast_ed25519.sign
 * and the ref_ed25519 oracle; there is no accept-set subtlety like
 * verify's S < L corner. Messages are fixed at 32 bytes because every
 * message on this path is a WireTransaction Merkle id; anything
 * variable-length takes the Python fallback. A libcrypto failure on any
 * job (cannot happen for well-formed 32-byte seeds; belt-and-braces for
 * allocation failure) raises, and the caller re-signs the batch on the
 * Python path — a wrong-or-missing signature never leaves this module
 * silently. */
typedef struct {
    const unsigned char *seeds;
    const unsigned char *msgs;
    unsigned char *sigs;
    Py_ssize_t lo, hi;
    int failed;
} sign_span_t;

static void *sign_worker(void *arg) {
    sign_span_t *s = (sign_span_t *)arg;
    for (Py_ssize_t i = s->lo; i < s->hi; i++) {
        EVP_PKEY *pkey = EVP_PKEY_new_raw_private_key(
            EVP_PKEY_ED25519, NULL, s->seeds + 32 * i, 32);
        if (pkey == NULL) {
            s->failed = 1;
            return NULL;
        }
        EVP_MD_CTX *ctx = EVP_MD_CTX_new();
        if (ctx == NULL) {
            EVP_PKEY_free(pkey);
            s->failed = 1;
            return NULL;
        }
        size_t siglen = 64;
        int ok = EVP_DigestSignInit(ctx, NULL, NULL, NULL, pkey) == 1
                 && EVP_DigestSign(ctx, s->sigs + 64 * i, &siglen,
                                   s->msgs + 32 * i, 32) == 1
                 && siglen == 64;
        EVP_MD_CTX_free(ctx);
        EVP_PKEY_free(pkey);
        if (!ok) {
            s->failed = 1;
            return NULL;
        }
    }
    return NULL;
}

static PyObject *sign_many(PyObject *self, PyObject *args) {
    Py_buffer seeds, msgs;
    if (!PyArg_ParseTuple(args, "y*y*", &seeds, &msgs))
        return NULL;
    PyObject *out = NULL;
    if (seeds.len % 32 != 0 || msgs.len != seeds.len) {
        PyErr_SetString(PyExc_ValueError,
                        "seeds and msgs must be equal-length multiples "
                        "of 32 bytes (columnar n*32 layout)");
        goto done;
    }
    Py_ssize_t n = seeds.len / 32;
    out = PyBytes_FromStringAndSize(NULL, n * 64);
    if (out == NULL)
        goto done;
    if (n > 0) {
        unsigned char *sig_buf = (unsigned char *)PyBytes_AS_STRING(out);
        const unsigned char *seed_buf = (const unsigned char *)seeds.buf;
        const unsigned char *msg_buf = (const unsigned char *)msgs.buf;
        int nthreads = n >= PAR_MIN ? (int)(n / (PAR_MIN / 2)) : 1;
        if (nthreads > PAR_MAX_THREADS)
            nthreads = PAR_MAX_THREADS;
        long cores = sysconf(_SC_NPROCESSORS_ONLN);
        if (cores > 0 && nthreads > cores)
            nthreads = (int)cores;
        sign_span_t spans[PAR_MAX_THREADS];
        pthread_t tids[PAR_MAX_THREADS];
        int started = 0, nspans = 0;
        Py_ssize_t chunk = (n + nthreads - 1) / nthreads;
        Py_BEGIN_ALLOW_THREADS
        for (int t = 0; t < nthreads; t++) {
            Py_ssize_t lo = (Py_ssize_t)t * chunk;
            Py_ssize_t hi = lo + chunk < n ? lo + chunk : n;
            if (lo >= hi)
                break;
            spans[nspans].seeds = seed_buf;
            spans[nspans].msgs = msg_buf;
            spans[nspans].sigs = sig_buf;
            spans[nspans].lo = lo;
            spans[nspans].hi = hi;
            spans[nspans].failed = 0;
            if (t < nthreads - 1 && hi < n
                && pthread_create(&tids[started], NULL, sign_worker,
                                  &spans[nspans]) == 0)
                started++;
            else
                sign_worker(&spans[nspans]);
            nspans++;
        }
        for (int t = 0; t < started; t++)
            pthread_join(tids[t], NULL);
        Py_END_ALLOW_THREADS
        for (int t = 0; t < nspans; t++) {
            if (spans[t].failed) {
                Py_DECREF(out);
                out = NULL;
                PyErr_SetString(PyExc_ValueError,
                                "libcrypto Ed25519 sign failed");
                goto done;
            }
        }
    }

done:
    PyBuffer_Release(&seeds);
    PyBuffer_Release(&msgs);
    return out;
}

static PyMethodDef methods[] = {
    {"verify_many", verify_many, METH_VARARGS,
     "Batch Ed25519 verify via libcrypto, GIL released; returns one 0/1 "
     "byte per job. Accept-fast only: rejects need an oracle re-check."},
    {"pack_words", pack_words, METH_VARARGS,
     "pack_words(pks, msgs, sigs, bucket) -> (a, r, s, m) raw (8, bucket) "
     "uint32 word arrays for the device-hash verify path; GIL released "
     "during the fill."},
    {"pack_jobs", (PyCFunction)(void (*)(void))pack_jobs,
     METH_VARARGS | METH_KEYWORDS,
     "pack_jobs(jobs, out, threads=0) -> (n_good, held, threads) or None: "
     "one pass over ed25519 VerifyJob objects writing the well-formed "
     "jobs' (4, 8, n_good) words into out, a slotted VerifyJob's fields "
     "read by offset over the calling thread's cores (threads 0) or a "
     "named number of threads; None when the batch is not for it."},
    {"sign_many", sign_many, METH_VARARGS,
     "sign_many(seeds, msgs) -> sigs: columnar batch Ed25519 sign via "
     "libcrypto, GIL released; n*32-byte seed and 32-byte-message "
     "buffers in, n*64 bytes of deterministic RFC 8032 signatures out."},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef module = {
    PyModuleDef_HEAD_INIT, "_cverify",
    "Batched libcrypto Ed25519 verification, signing and word packing "
    "(GIL-free).",
    -1, methods,
};

PyMODINIT_FUNC PyInit__cverify(void) {
    s_scheme = PyUnicode_InternFromString("scheme");
    s_pubkey = PyUnicode_InternFromString("pubkey");
    s_message = PyUnicode_InternFromString("message");
    s_sig = PyUnicode_InternFromString("sig");
    s_ed25519 = PyUnicode_InternFromString("ed25519");
    if (s_scheme == NULL || s_pubkey == NULL || s_message == NULL
        || s_sig == NULL || s_ed25519 == NULL)
        return NULL;
    return PyModule_Create(&module);
}
