"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each source under ``csrc/`` compiles on its own into a shared library with
a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/repro_torch/<name>-<hash>.so

into ``build/repro_torch/`` at the repository root (listed in .gitignore).
The file name carries a hash of the source, of every local header it
includes (``#include "..."``, followed recursively) and of the flags, so a
second run skips the build. The tensor-core kernels reach the driver's
``cuTensorMapEncodeTiled`` through ``cudaGetDriverEntryPoint``, so no
library links ``-lcuda`` (``embed_gather_bulk`` copies whole rows with 1-D
bulk copies and needs no tensor map). Builds happen at first use — never
at import — and ``build_all`` starts one ``nvcc`` per source, all
together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
import threading
import time
from pathlib import Path

from repro_torch import compat

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# kernel name -> (source file, C entry, argtypes); c_void_p for pointers and
# the stream, c_int64 for sizes (a bare int would be cut to 32 bits), c_float
# for a float
_P, _I, _F = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float
KERNELS = {
    "embed_gather": ("embed_gather.cu", "repro_embed_gather",
                     (_P, _P, _P, _I, _I, _I, _I, _I, _P)),
    # table, ids, out; n, vs, row bytes, row offset; stream
    "embed_gather_bulk": ("embed_gather_bulk.cu", "repro_embed_gather_bulk",
                          (_P, _P, _P, _I, _I, _I, _I, _P)),
    "embed_scatter_add": ("embed_scatter.cu", "repro_embed_scatter_add",
                          (_P, _P, _P, _I, _I, _I, _I, _P)),
    # ids, rows, out; n, vs, e, itemsize, rows per block, blocks; stream
    "embed_scatter_fused": ("embed_scatter_fused.cu",
                            "repro_embed_scatter_fused",
                            (_P, _P, _P) + (_I,) * 6 + (_P,)),
    # an empty kernel: the launch floor chip_smoke.py times the others by
    "launch_floor": ("launch_floor.cu", "repro_launch_floor", (_P,)),
    # q, k, v, o; b, sq, sk, h, d, itemsize, causal; 12 strides; scale; stream
    "flash_attention": ("flash_attention.cu", "repro_flash_attention",
                        (_P, _P, _P, _P) + (_I,) * 19 + (_F, _P)),
    # q, k, v, o; b, sq, sk, h, d, causal; 12 strides; scale; stream
    "flash_attention_tc": ("flash_attention_tc.cu",
                           "repro_flash_attention_tc",
                           (_P, _P, _P, _P) + (_I,) * 18 + (_F, _P)),
    # r, k, v, lw, bonus, state, out, state out; b, s, h, e, chunk,
    # itemsize, lw itemsize; 15 strides; stream
    "wkv": ("wkv.cu", "repro_wkv", (_P,) * 8 + (_I,) * 22 + (_P,)),
    # r, k, v, lw, bonus, state, out, state out; b, s, h, e, chunk,
    # lw itemsize; 15 strides; stream
    "wkv_tc": ("wkv_tc.cu", "repro_wkv_tc", (_P,) * 8 + (_I,) * 21 + (_P,)),
    # r, k, v, lw, bonus, state, out, state out; b, h, e, itemsize,
    # lw itemsize; 10 strides (b, h); stream
    "wkv_step": ("wkv_step.cu", "repro_wkv_step",
                 (_P,) * 8 + (_I,) * 15 + (_P,)),
}

_loaded: dict = {}
_lock = threading.Lock()


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def sources(name: str) -> list:
    """The kernel's source and every local header it includes, in the order
    first reached."""
    seen, todo = [], [CSRC / KERNELS[name][0]]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        todo += [path.parent / inc.decode()
                 for inc in _LOCAL_INCLUDE.findall(path.read_bytes())]
    return seen


def library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for path in sources(name):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    digest.update(" ".join(FLAGS).encode())
    src = CSRC / KERNELS[name][0]
    return BUILD_DIR / f"{src.stem}-{digest.hexdigest()[:16]}.so"


def _start(name: str):
    """Popen of nvcc for one kernel, or None when its library exists."""
    out = library_path(name)
    if out.exists():
        return None
    nvcc = compat.nvcc_path()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
            "the CUDA kernels are built from source on the machine with "
            "the card")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *FLAGS, "-o", str(tmp), str(CSRC / KERNELS[name][0])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> str:
    if started is None:
        return ""
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name} "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)          # atomic: a reader never sees half a file
    return log


def build_all(names=None) -> dict:
    """Compile every (or the named) kernel, one nvcc each, in parallel.
    Returns {name: {"seconds": wall time, "log": nvcc's -Xptxas -v output}}
    ("" log when the library was already built)."""
    names = list(names or KERNELS)
    t0 = time.perf_counter()
    started = {n: _start(n) for n in names}
    logs = {n: _finish(n, s) for n, s in started.items()}
    dt = time.perf_counter() - t0
    return {n: {"seconds": dt, "log": logs[n]} for n in names}


def load(name: str):
    """The C entry of one kernel (built on first use), argtypes set."""
    with _lock:
        fn = _loaded.get(name)
        if fn is None:
            _finish(name, _start(name))
            lib = ctypes.CDLL(str(library_path(name)))
            fn = getattr(lib, KERNELS[name][1])
            fn.argtypes = list(KERNELS[name][2])
            fn.restype = ctypes.c_int
            _loaded[name] = fn
        return fn
