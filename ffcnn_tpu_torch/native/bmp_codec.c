/* _ffcnn_native: the host-side BMP codec of ffcnn_tpu_torch, the port's own
 * copy of the JAX package's native/bmp_codec.c (same functions, framing,
 * bounds, error classes and messages; the pixel rows are read in blocks,
 * see decode_bmp_file).
 *
 * The C reference's only native non-compute components are its BMP codec +
 * rectangle drawing (bmpfile.c:42-156) and the demo's serial image loop
 * (ffcnn.c:577-580).  The compute kernels run on the card, but the host-side
 * image path stays native: a 24-bit BMP encoder/decoder with the
 * reference's exact framing (54-byte header read/written as packed fields,
 * bottom-up rows, ALIGN(w*3,4) stride, bfOffBits ignored on load) plus a
 * pthread fan-out batch loader that decodes straight into one contiguous
 * (N,H,W,3) buffer ready for the upload to the card, the interpreter lock
 * released while it runs.
 *
 * Pure CPython C API (no numpy ABI dependency): functions return/accept
 * objects supporting the buffer protocol; the Python wrappers
 * (ffcnn_tpu_torch/imageio/bmp.py, loader.py) view them as numpy arrays
 * zero-copy.  ffcnn_tpu_torch/imageio/native.py builds it with gcc at first
 * use and loads it.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <pthread.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#define HEADER_BYTES 54
/* Dimension bound for every w/h accepted from a file header or from Python:
 * keeps w*3 / w*h*3 comfortably inside int/size_t arithmetic (a hostile
 * header width near INT_MAX/3 would otherwise overflow the signed stride
 * computation — UB in a file parser). 32768^2*3 = 3 GiB is already far past
 * any real BMP. */
#define MAX_DIM 32768

static int dims_ok(int w, int h) {
    return w > 0 && h > 0 && w <= MAX_DIM && h <= MAX_DIM;
}

static uint32_t rd32(const uint8_t *p) {
    return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
           ((uint32_t)p[3] << 24);
}
static uint16_t rd16(const uint8_t *p) {
    return (uint16_t)(p[0] | (p[1] << 8));
}
static void wr32(uint8_t *p, uint32_t v) {
    p[0] = v & 0xff; p[1] = (v >> 8) & 0xff;
    p[2] = (v >> 16) & 0xff; p[3] = (v >> 24) & 0xff;
}
static void wr16(uint8_t *p, uint16_t v) { p[0] = v & 0xff; p[1] = v >> 8; }

static int align4(int x) { return (x + 3) & ~3; }

/* Decode one BMP file into caller-provided buffer (w*h*3, top-down BGR).
 * If buf is NULL, only parses dims.  Returns 0 ok, -1 io error, -2 format.
 *
 * The pixel rows are read in blocks of up to READ_BLOCK bytes, unbuffered:
 * one read call a block (one for a 320x320 frame) where stdio's row-by-row
 * reads would make one a 4 KiB buffer, and where each read call is
 * expensive (a user-space kernel, a network file system) those calls, not
 * the copies, set the decode's pace.  The bytes, the bounds and the result
 * codes are those of a row-by-row read. */
#define READ_BLOCK (1 << 20)
static int decode_bmp_file(const char *path, uint8_t *buf, int *out_w,
                           int *out_h, int expect_w, int expect_h) {
    FILE *fp = fopen(path, "rb");
    if (!fp) return -1;
    setvbuf(fp, NULL, _IONBF, 0);
    uint8_t hdr[HEADER_BYTES];
    if (fread(hdr, 1, HEADER_BYTES, fp) != HEADER_BYTES) { fclose(fp); return -2; }
    if (rd16(hdr) != 0x4D42) { fclose(fp); return -2; }
    int32_t w = (int32_t)rd32(hdr + 18);
    int32_t h = (int32_t)rd32(hdr + 22);
    int bits = rd16(hdr + 28);
    int flip = h > 0;                       /* bottom-up rows (the norm) */
    if (h < 0) h = -h;
    if (bits != 24 || !dims_ok(w, h)) { fclose(fp); return -2; }
    *out_w = w; *out_h = h;
    if (!buf) { fclose(fp); return 0; }
    if (expect_w && (w != expect_w || h != expect_h)) { fclose(fp); return -3; }
    int stride = align4(w * 3);
    int rows = READ_BLOCK / stride;         /* >= 10: stride <= 98307 */
    if (rows > h) rows = h;
    uint8_t *block = (uint8_t *)malloc((size_t)stride * rows);
    if (!block) { fclose(fp); return -1; }
    /* pixel data directly after the 54-byte header (bmpfile.c:53-64) */
    for (int y0 = 0; y0 < h; y0 += rows) {
        int n = h - y0 < rows ? h - y0 : rows;
        if (fread(block, 1, (size_t)stride * n, fp) != (size_t)stride * n) {
            free(block); fclose(fp); return -2;
        }
        for (int k = 0; k < n; k++) {
            int y = y0 + k;
            int dy = flip ? (h - 1 - y) : y;
            memcpy(buf + (size_t)dy * w * 3, block + (size_t)k * stride,
                   (size_t)w * 3);
        }
    }
    free(block);
    fclose(fp);
    return 0;
}

static PyObject *py_bmp_load(PyObject *self, PyObject *args) {
    const char *path;
    if (!PyArg_ParseTuple(args, "s", &path)) return NULL;
    int w = 0, h = 0, rc;
    Py_BEGIN_ALLOW_THREADS
    rc = decode_bmp_file(path, NULL, &w, &h, 0, 0);
    Py_END_ALLOW_THREADS
    if (rc == -1) return PyErr_Format(PyExc_IOError, "cannot read %s", path);
    if (rc != 0) return PyErr_Format(PyExc_ValueError,
                                     "%s: not a 24-bit BMP", path);
    PyObject *ba = PyByteArray_FromStringAndSize(NULL, (Py_ssize_t)w * h * 3);
    if (!ba) return NULL;
    uint8_t *buf = (uint8_t *)PyByteArray_AS_STRING(ba);
    Py_BEGIN_ALLOW_THREADS
    rc = decode_bmp_file(path, buf, &w, &h, w, h);
    Py_END_ALLOW_THREADS
    if (rc != 0) {
        Py_DECREF(ba);
        return PyErr_Format(PyExc_IOError, "decode failed for %s", path);
    }
    return Py_BuildValue("(Nii)", ba, h, w);
}

static PyObject *py_bmp_save(PyObject *self, PyObject *args) {
    const char *path;
    Py_buffer view;
    int h, w;
    if (!PyArg_ParseTuple(args, "sy*ii", &path, &view, &h, &w)) return NULL;
    if (!dims_ok(w, h)) {
        PyBuffer_Release(&view);
        return PyErr_Format(PyExc_ValueError, "bad dims %dx%d", w, h);
    }
    if (view.len < (Py_ssize_t)w * h * 3) {
        PyBuffer_Release(&view);
        return PyErr_Format(PyExc_ValueError, "buffer too small");
    }
    int stride = align4(w * 3);
    int ok = 1;
    Py_BEGIN_ALLOW_THREADS
    {
        FILE *fp = fopen(path, "wb");
        if (!fp) { ok = 0; }
        else {
            uint8_t hdr[HEADER_BYTES];
            memset(hdr, 0, sizeof hdr);
            wr16(hdr, 0x4D42);
            wr32(hdr + 2, HEADER_BYTES + (uint32_t)stride * h);
            wr32(hdr + 10, HEADER_BYTES);
            wr32(hdr + 14, 40);
            wr32(hdr + 18, (uint32_t)w);
            wr32(hdr + 22, (uint32_t)h);
            wr16(hdr + 26, 1);
            wr16(hdr + 28, 24);
            wr32(hdr + 34, (uint32_t)stride * h);
            uint8_t *row = (uint8_t *)calloc(1, (size_t)stride);
            if (!row) ok = 0;
            if (fwrite(hdr, 1, HEADER_BYTES, fp) != HEADER_BYTES) ok = 0;
            const uint8_t *src = (const uint8_t *)view.buf;
            for (int y = h - 1; ok && y >= 0 && row; y--) {   /* bottom-up */
                memcpy(row, src + (size_t)y * w * 3, (size_t)w * 3);
                if (fwrite(row, 1, (size_t)stride, fp) != (size_t)stride)
                    ok = 0;
            }
            free(row);
            fclose(fp);
        }
    }
    Py_END_ALLOW_THREADS
    PyBuffer_Release(&view);
    if (!ok) return PyErr_Format(PyExc_IOError, "cannot write %s", path);
    Py_RETURN_NONE;
}

/* ---- threaded batch loader ---- */

typedef struct {
    const char **paths;
    uint8_t *out;          /* (n, h, w, 3) */
    int n, w, h;
    int next;              /* work index, guarded by lock */
    int failed;            /* first failing index, -1 if none */
    pthread_mutex_t lock;
} batch_job;

static void *batch_worker(void *arg) {
    batch_job *job = (batch_job *)arg;
    for (;;) {
        pthread_mutex_lock(&job->lock);
        int i = job->next < job->n && job->failed < 0 ? job->next++ : -1;
        pthread_mutex_unlock(&job->lock);
        if (i < 0) break;
        int w, h;
        int rc = decode_bmp_file(job->paths[i],
                                 job->out + (size_t)i * job->w * job->h * 3,
                                 &w, &h, job->w, job->h);
        if (rc != 0) {
            pthread_mutex_lock(&job->lock);
            if (job->failed < 0) job->failed = i;
            pthread_mutex_unlock(&job->lock);
            break;
        }
    }
    return NULL;
}

static PyObject *py_load_batch(PyObject *self, PyObject *args) {
    PyObject *seq;
    int threads = 0;
    if (!PyArg_ParseTuple(args, "O|i", &seq, &threads)) return NULL;
    PyObject *fast = PySequence_Fast(seq, "load_batch expects a sequence");
    if (!fast) return NULL;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(fast);
    if (n == 0) {
        Py_DECREF(fast);
        return PyErr_Format(PyExc_ValueError, "empty path list");
    }
    const char **paths = (const char **)malloc(sizeof(char *) * (size_t)n);
    if (!paths) { Py_DECREF(fast); return PyErr_NoMemory(); }
    for (Py_ssize_t i = 0; i < n; i++) {
        paths[i] = PyUnicode_AsUTF8(PySequence_Fast_GET_ITEM(fast, i));
        if (!paths[i]) { free(paths); Py_DECREF(fast); return NULL; }
    }
    int w = 0, h = 0, rc;
    Py_BEGIN_ALLOW_THREADS
    rc = decode_bmp_file(paths[0], NULL, &w, &h, 0, 0);
    Py_END_ALLOW_THREADS
    if (rc != 0) {
        PyObject *e = PyErr_Format(PyExc_IOError, "cannot read %s", paths[0]);
        free(paths); Py_DECREF(fast);
        return e;
    }
    PyObject *ba = PyByteArray_FromStringAndSize(NULL,
                                                 (Py_ssize_t)n * h * w * 3);
    if (!ba) { free(paths); Py_DECREF(fast); return NULL; }

    batch_job job = {paths, (uint8_t *)PyByteArray_AS_STRING(ba),
                     (int)n, w, h, 0, -1, PTHREAD_MUTEX_INITIALIZER};
    if (threads <= 0) {
        long cpus = sysconf(_SC_NPROCESSORS_ONLN);
        threads = cpus > 1 ? (int)cpus : 1;
    }
    if (threads > (int)n) threads = (int)n;
    Py_BEGIN_ALLOW_THREADS
    {
        pthread_t tid[64];
        if (threads > 64) threads = 64;
        int spawned = 0;
        for (; spawned < threads; spawned++)
            if (pthread_create(&tid[spawned], NULL, batch_worker, &job))
                break;
        if (spawned == 0) batch_worker(&job);  /* degraded: run inline */
        for (int t = 0; t < spawned; t++) pthread_join(tid[t], NULL);
    }
    Py_END_ALLOW_THREADS
    free(paths);
    Py_DECREF(fast);
    if (job.failed >= 0) {
        PyObject *item = PySequence_GetItem(seq, job.failed);
        PyObject *e = PyErr_Format(
            PyExc_IOError, "batch load failed at %R (dims must match %dx%d)",
            item, w, h);
        Py_XDECREF(item);
        Py_DECREF(ba);
        return e;
    }
    return Py_BuildValue("(Niii)", ba, (int)n, h, w);
}

static PyObject *py_draw_rectangle(PyObject *self, PyObject *args) {
    Py_buffer view;
    int h, w, x1, y1, x2, y2, r, g, b;
    if (!PyArg_ParseTuple(args, "w*iiiiiiiii", &view, &h, &w,
                          &x1, &y1, &x2, &y2, &r, &g, &b))
        return NULL;
    if (!dims_ok(w, h)) {
        PyBuffer_Release(&view);
        return PyErr_Format(PyExc_ValueError, "bad dims %dx%d", w, h);
    }
    if (view.len < (Py_ssize_t)w * h * 3) {
        PyBuffer_Release(&view);
        return PyErr_Format(PyExc_ValueError, "buffer too small");
    }
    uint8_t *img = (uint8_t *)view.buf;
    int xl = x1 < x2 ? x1 : x2, xr = x1 < x2 ? x2 : x1;
    int yt = y1 < y2 ? y1 : y2, yb = y1 < y2 ? y2 : y1;
    /* per-pixel clip, like bmp_rectangle -> bmp_setpixel (bmpfile.c:121-156) */
    #define SETPX(x, y) do { \
        if ((x) >= 0 && (x) < w && (y) >= 0 && (y) < h) { \
            uint8_t *p = img + ((size_t)(y) * w + (x)) * 3; \
            p[0] = (uint8_t)b; p[1] = (uint8_t)g; p[2] = (uint8_t)r; } \
    } while (0)
    for (int x = xl; x <= xr; x++) { SETPX(x, y1); SETPX(x, y2); }
    for (int y = yt; y <= yb; y++) { SETPX(x1, y); SETPX(x2, y); }
    #undef SETPX
    PyBuffer_Release(&view);
    Py_RETURN_NONE;
}

static PyMethodDef methods[] = {
    {"bmp_load", py_bmp_load, METH_VARARGS,
     "bmp_load(path) -> (bytearray BGR top-down, h, w)"},
    {"bmp_save", py_bmp_save, METH_VARARGS,
     "bmp_save(path, buffer, h, w)"},
    {"load_batch", py_load_batch, METH_VARARGS,
     "load_batch(paths, threads=0) -> (bytearray, n, h, w)"},
    {"draw_rectangle", py_draw_rectangle, METH_VARARGS,
     "draw_rectangle(buffer, h, w, x1, y1, x2, y2, r, g, b)"},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_ffcnn_native",
    "Native BMP codec + threaded batch image loader", -1, methods,
};

PyMODINIT_FUNC PyInit__ffcnn_native(void) {
    return PyModule_Create(&moduledef);
}
