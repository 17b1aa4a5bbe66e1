"""Build and bind the port's CUDA kernels.

At first use, one `nvcc` per `univer_ocr_tpu_torch/csrc/*.cu`, all
started together, compiles the sources, one more links them into a shared
library with a plain C interface, and `ctypes` loads it.  No PyTorch
headers and no pybind11 are involved, so the build takes seconds.  The library lands in `build/kernels/` at the root of the
checkout (git-ignored), named by a hash of the sources and flags, so a
changed source is rebuilt and an unchanged one is loaded as it is.

Each C entry point launches on the stream it is given and returns
`cudaGetLastError()`; `check` raises when that is not 0.
"""

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / 'csrc'
BUILD_DIR = PACKAGE_DIR.parent / 'build' / 'kernels'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

#: launches of each kernel by its wrapper, keyed by kernel name; a wrapper
#: adds one where it launches its kernel and nowhere else, holding
#: COUNT_LOCK (the pipelines launch from several threads at once)
LAUNCHES = collections.Counter()
#: the same launches by (kernel name, index of the card launched on)
DEVICE_LAUNCHES = collections.Counter()
COUNT_LOCK = threading.Lock()
_BUILD_LOCK = threading.Lock()


def _nvcc():
    path = shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'
    if not os.path.exists(path):
        raise RuntimeError('nvcc not found: the CUDA kernels are built with '
                           'the CUDA toolkit on the machine with the card')
    return path


def sources():
    return sorted(CSRC_DIR.glob('*.cu'))


def library_path():
    digest = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for src in sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f'libuocr_kernels_{digest.hexdigest()[:16]}.so'


def _run(cmds):
    """Run the commands side by side; returns their (returncode, output)."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs = [proc.communicate()[0] for proc in procs]
    return [(proc.returncode, out.strip()) for proc, out in zip(procs, outs)]


def build():
    """Compile the kernels unless a library of these exact sources exists.
    Returns {'path', 'seconds', 'log'}; `log` holds nvcc's -Xptxas -v
    report (registers, shared memory and spills of each kernel)."""
    with _BUILD_LOCK:
        path = library_path()
        if path.exists():
            return {'path': path, 'seconds': 0.0, 'log': 'cached'}
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f'.{os.getpid()}.tmp')
        objects = [tmp.with_name(f'{tmp.name}.{src.stem}.o')
                   for src in sources()]
        compile_cmds = [[_nvcc(), *NVCC_FLAGS, '-c', '-o', str(obj), str(src)]
                        for src, obj in zip(sources(), objects)]
        link_cmd = [_nvcc(), *NVCC_FLAGS[:2], '-shared', '-o', str(tmp),
                    *map(str, objects)]
        t0 = time.perf_counter()
        try:
            results = _run(compile_cmds)
            if all(code == 0 for code, _ in results):
                results.append(_run([link_cmd])[0])
        finally:
            for obj in objects:
                obj.unlink(missing_ok=True)
        seconds = time.perf_counter() - t0
        log = '\n'.join(out for _, out in results if out)
        for cmd, (code, _) in zip(compile_cmds + [link_cmd], results):
            if code != 0:
                raise RuntimeError(f'nvcc failed ({code}) after '
                                   f'{seconds:.1f} s: {" ".join(cmd)}\n{log}')
        os.replace(tmp, path)
        print(f'kernels: built {path.name} in {seconds:.1f} s, '
              f'{len(compile_cmds)} sources side by side:\n{log}', flush=True)
        return {'path': path, 'seconds': seconds, 'log': log}


@functools.lru_cache(maxsize=1)
def library():
    lib = ctypes.CDLL(str(build()['path']))
    lib.uocr_error_string.argtypes = [ctypes.c_int]
    lib.uocr_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def function(name, argtypes):
    """The C entry `name` of the library, with its argument types set from
    the string `argtypes`: 'p' for a pointer or a stream (c_void_p), 'i'
    for an int (c_int)."""
    fn = getattr(library(), name)
    fn.argtypes = [ctypes.c_void_p if t == 'p' else ctypes.c_int
                   for t in argtypes]
    fn.restype = ctypes.c_int
    return fn


def check(code, kernel):
    if code != 0:
        msg = library().uocr_error_string(code).decode()
        raise RuntimeError(f'{kernel}: CUDA error {code} at launch: {msg}')
