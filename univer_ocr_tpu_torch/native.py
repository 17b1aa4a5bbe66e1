"""Native host CV (univer_ocr_tpu/native): 4-connectivity labels, their
bounding boxes, rotation with expansion and nearest-neighbour zoom in C++,
bound with ctypes, with the JAX package's signatures and return types;
and the port's own `label_stats`, the labels with every component's
pixel count, centre and box from the same pass.

The source is the port's own copy, `csrc/host/univocr_native.cpp`.  At
first use one `g++` with the JAX package's Makefile flags builds it into
`build/native/` at the root of the checkout (git-ignored), named by a hash
of the source and the flags, so a changed source is rebuilt and an
unchanged one is loaded as it is.  Processes that build at once each write
a temporary file of their own and move it into place with `os.replace`.
There is no fallback to scipy: a missing compiler or a failed build
raises with the compiler's output.

`ctypes.CDLL` releases the interpreter lock for each call, so the crop
pools' threads label concurrently.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

PACKAGE_DIR = Path(__file__).resolve().parent
SOURCE = PACKAGE_DIR / 'csrc' / 'host' / 'univocr_native.cpp'
BUILD_DIR = PACKAGE_DIR.parent / 'build' / 'native'
#: the JAX package's native/Makefile CXXFLAGS
CXXFLAGS = ('-O3', '-fPIC', '-shared', '-std=c++17', '-pthread')
_BUILD_LOCK = threading.Lock()


def library_path():
    digest = hashlib.sha256(' '.join(CXXFLAGS).encode())
    digest.update(SOURCE.read_bytes())
    return BUILD_DIR / f'libunivocr_native_{digest.hexdigest()[:16]}.so'


def build():
    """Compile the library unless one of this exact source exists.
    Returns {'path', 'seconds', 'log'}."""
    with _BUILD_LOCK:
        path = library_path()
        if path.exists():
            return {'path': path, 'seconds': 0.0, 'log': 'cached'}
        cxx = shutil.which('g++')
        if cxx is None:
            raise RuntimeError('g++ not found: the native host-CV library '
                               f'is built from {SOURCE} with g++')
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f'.{os.getpid()}.{threading.get_ident()}.tmp')
        cmd = [cxx, *CXXFLAGS, '-o', str(tmp), str(SOURCE)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f'g++ failed ({proc.returncode}) after '
                               f'{seconds:.1f} s: {" ".join(cmd)}\n'
                               f'{proc.stdout}')
        os.replace(tmp, path)
        return {'path': path, 'seconds': seconds,
                'log': proc.stdout.strip()}


@functools.lru_cache(maxsize=1)
def library():
    lib = ctypes.CDLL(str(build()['path']))
    i32p = ctypes.POINTER(ctypes.c_int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    c_int, c_double = ctypes.c_int, ctypes.c_double
    lib.ccl_4conn.restype = c_int
    lib.ccl_4conn.argtypes = [ctypes.POINTER(ctypes.c_uint8), c_int, c_int,
                              i32p]
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.ccl_4conn_stats.restype = c_int
    lib.ccl_4conn_stats.argtypes = [ctypes.POINTER(ctypes.c_uint8), c_int,
                                    c_int, i32p, c_int, i64p, i64p, i32p]
    lib.label_bboxes.restype = None
    lib.label_bboxes.argtypes = [i32p, c_int, c_int, c_int, i32p]
    lib.rotated_size.restype = None
    lib.rotated_size.argtypes = [c_int, c_int, c_double,
                                 ctypes.POINTER(c_int), ctypes.POINTER(c_int)]
    lib.rotate_image.restype = None
    lib.rotate_image.argtypes = [f32p, c_int, c_int, c_int, c_double, c_int,
                                 f32p, c_int, c_int]
    lib.zoom_nearest.restype = None
    lib.zoom_nearest.argtypes = [f32p, c_int, c_int, c_int, f32p, c_int,
                                 c_int]
    return lib


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def label(mask):
    """4-connectivity CCL over a 2-D boolean/uint8 mask.

    Returns (labels int32 HxW, count) with scipy.ndimage.label's
    raster-order numbering.
    """
    mask = np.ascontiguousarray(mask, dtype=np.uint8)
    H, W = mask.shape
    labels = np.empty((H, W), dtype=np.int32)
    n = library().ccl_4conn(_ptr(mask, ctypes.c_uint8), H, W,
                            _ptr(labels, ctypes.c_int32))
    return labels, n


def label_stats(mask):
    """`label`'s labels and count, and each component's statistics,
    gathered while it labels: (labels, n, counts, centres, boxes), with
    component l at row l - 1 of counts (n,) int64 (its pixels), centres
    (n, 2) float64 (the mean (y, x) of its pixels: integer sums over the
    count, so bit-equal to `np.argwhere(labels == l).mean(axis=0)`) and
    boxes (n, 4) int32 (ymin, ymax, xmin, xmax, the stops exclusive: the
    boxes of `find_objects`).  Room is made for 64 components; a mask
    with more is labelled again with room for all of them."""
    mask = np.ascontiguousarray(mask)
    mask = (mask.view(np.uint8) if mask.dtype == bool
            else np.ascontiguousarray(mask, dtype=np.uint8))
    H, W = mask.shape
    labels = np.empty((H, W), dtype=np.int32)
    cap = 64
    while True:
        counts = np.empty(cap, np.int64)
        sums = np.empty((cap, 2), np.int64)
        boxes = np.empty((cap, 4), np.int32)
        n = library().ccl_4conn_stats(
            _ptr(mask, ctypes.c_uint8), H, W, _ptr(labels, ctypes.c_int32),
            cap, _ptr(counts, ctypes.c_int64), _ptr(sums, ctypes.c_int64),
            _ptr(boxes, ctypes.c_int32))
        if n <= cap:
            break
        cap = n
    counts = counts[:n]
    return labels, n, counts, sums[:n] / counts[:, None], boxes[:n]


def find_objects(labels, n):
    """Bounding-box slices per label (scipy.ndimage.find_objects shape)."""
    labels = np.ascontiguousarray(labels, dtype=np.int32)
    H, W = labels.shape
    boxes = np.empty((n, 4), dtype=np.int32)
    library().label_bboxes(_ptr(labels, ctypes.c_int32), H, W, n,
                           _ptr(boxes, ctypes.c_int32))
    return [(slice(int(b[0]), int(b[1])), slice(int(b[2]), int(b[3])))
            for b in boxes]


def rotate(arr, angle, order=1):
    """Rotate a (H, W, C) float32 array with expansion, in the
    interpreter's rotate_array convention (scipy axes=(2, 1))."""
    lib = library()
    arr = np.ascontiguousarray(arr, dtype=np.float32)
    H, W, C = arr.shape
    out_h, out_w = ctypes.c_int(), ctypes.c_int()
    lib.rotated_size(H, W, float(angle), ctypes.byref(out_h),
                     ctypes.byref(out_w))
    out = np.empty((out_h.value, out_w.value, C), dtype=np.float32)
    lib.rotate_image(_ptr(arr, ctypes.c_float), H, W, C, float(angle),
                     int(order), _ptr(out, ctypes.c_float), out_h.value,
                     out_w.value)
    return out


def zoom(arr, out_h, out_w):
    """Nearest-neighbour zoom of (H, W, C) float32 to (out_h, out_w, C)."""
    arr = np.ascontiguousarray(arr, dtype=np.float32)
    H, W, C = arr.shape
    out = np.empty((out_h, out_w, C), dtype=np.float32)
    library().zoom_nearest(_ptr(arr, ctypes.c_float), H, W, C,
                           _ptr(out, ctypes.c_float), out_h, out_w)
    return out
