/* Native host-I/O helpers (CPython C extension).
 *
 * The render pipeline's host side is pipe- and memory-bound: rawvideo
 * frames stream from an ffmpeg child at up to ~3 GB/s for 1000 fps
 * 1080p (SURVEY.md §7 hard part 3). These helpers keep that path off
 * the GIL and out of Python-loop overhead:
 *
 *   readinto_exact(fd, buffer)        -- exact-length read loop, GIL
 *                                        released while blocking
 *   yuv420p_to_rgb24(src, dst, w, h)  -- BT.601 limited-range planar
 *                                        YUV 4:2:0 -> packed RGB24;
 *                                        lets decode pipes carry half
 *                                        the bytes of rgb24
 *
 * Built on demand by pythoncrt_tpu_torch.native (pure-Python fallbacks
 * exist); a copy of pythoncrt_tpu/native/_hostio.c.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <errno.h>
#include <stdint.h>
#include <string.h>
#include <unistd.h>

static PyObject *
hostio_readinto_exact(PyObject *self, PyObject *args)
{
    int fd;
    Py_buffer view;
    if (!PyArg_ParseTuple(args, "iw*", &fd, &view))
        return NULL;

    char *buf = (char *)view.buf;
    Py_ssize_t want = view.len;
    Py_ssize_t got = 0;
    int saved_errno = 0;

    Py_BEGIN_ALLOW_THREADS
    while (got < want) {
        ssize_t n = read(fd, buf + got, (size_t)(want - got));
        if (n > 0) {
            got += n;
        } else if (n == 0) {
            break; /* EOF */
        } else if (errno == EINTR) {
            continue;
        } else {
            saved_errno = errno;
            break;
        }
    }
    Py_END_ALLOW_THREADS

    PyBuffer_Release(&view);
    if (saved_errno) {
        errno = saved_errno;
        return PyErr_SetFromErrno(PyExc_OSError);
    }
    return PyLong_FromSsize_t(got);
}

/* BT.601 limited range, integer arithmetic matching the common
 * fixed-point formulation:
 *   C = Y - 16, D = U - 128, E = V - 128
 *   R = clip((298*C + 409*E + 128) >> 8)
 *   G = clip((298*C - 100*D - 208*E + 128) >> 8)
 *   B = clip((298*C + 516*D + 128) >> 8)
 */
static inline uint8_t clip_u8(int v)
{
    return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
}

static PyObject *
hostio_yuv420p_to_rgb24(PyObject *self, PyObject *args)
{
    Py_buffer src, dst;
    int w, h;
    if (!PyArg_ParseTuple(args, "y*w*ii", &src, &dst, &w, &h))
        return NULL;

    Py_ssize_t need_src = (Py_ssize_t)w * h * 3 / 2;
    Py_ssize_t need_dst = (Py_ssize_t)w * h * 3;
    if (src.len < need_src || dst.len < need_dst || (w % 2) || (h % 2)) {
        PyBuffer_Release(&src);
        PyBuffer_Release(&dst);
        PyErr_SetString(PyExc_ValueError,
                        "yuv420p_to_rgb24: bad buffer sizes or odd dims");
        return NULL;
    }

    const uint8_t *yp = (const uint8_t *)src.buf;
    const uint8_t *up = yp + (Py_ssize_t)w * h;
    const uint8_t *vp = up + (Py_ssize_t)w * h / 4;
    uint8_t *out = (uint8_t *)dst.buf;

    Py_BEGIN_ALLOW_THREADS
    for (int y = 0; y < h; y++) {
        const uint8_t *yrow = yp + (Py_ssize_t)y * w;
        const uint8_t *urow = up + (Py_ssize_t)(y / 2) * (w / 2);
        const uint8_t *vrow = vp + (Py_ssize_t)(y / 2) * (w / 2);
        uint8_t *orow = out + (Py_ssize_t)y * w * 3;
        for (int x = 0; x < w; x++) {
            int c = 298 * ((int)yrow[x] - 16);
            int d = (int)urow[x / 2] - 128;
            int e = (int)vrow[x / 2] - 128;
            orow[3 * x + 0] = clip_u8((c + 409 * e + 128) >> 8);
            orow[3 * x + 1] = clip_u8((c - 100 * d - 208 * e + 128) >> 8);
            orow[3 * x + 2] = clip_u8((c + 516 * d + 128) >> 8);
        }
    }
    Py_END_ALLOW_THREADS

    PyBuffer_Release(&src);
    PyBuffer_Release(&dst);
    Py_RETURN_NONE;
}

static PyMethodDef hostio_methods[] = {
    {"readinto_exact", hostio_readinto_exact, METH_VARARGS,
     "readinto_exact(fd, buffer) -> bytes read (GIL released)"},
    {"yuv420p_to_rgb24", hostio_yuv420p_to_rgb24, METH_VARARGS,
     "yuv420p_to_rgb24(src, dst, w, h) -> None (BT.601 limited range)"},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef hostio_module = {
    PyModuleDef_HEAD_INIT, "_hostio", "Native host I/O helpers", -1,
    hostio_methods,
};

PyMODINIT_FUNC
PyInit__hostio(void)
{
    return PyModule_Create(&hostio_module);
}
