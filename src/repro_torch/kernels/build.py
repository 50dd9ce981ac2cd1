"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C entry point and is compiled on
first use into its own shared library under ``build/repro_torch/`` at the
repository root (listed in ``.gitignore``):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/repro_torch/<name>-<hash>.so

The file name carries a hash of the source, of every header it includes
from ``csrc/`` (``#include "..."``, followed recursively) and of the flags,
so an edited kernel or header is never served from a stale library.  ``build_all`` starts one ``nvcc``
per source at once and waits for all of them.  Importing this module
compiles nothing (the CPU-only test machines have no ``nvcc``).

``load`` is safe from several threads (a serving worker and a background
merge may reach a kernel's first load together): one thread builds and
loads a library while the others wait for it.  Each first load counts
once, against the thread that made it (``first_loads_on_this_thread``),
which is how the search engines tell a request that paid for ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
KERNEL_SOURCES = ("fused_expand", "pool_merge", "sq8_distance",
                  "gather_distance", "crouting_prune", "l2_distance",
                  "segment_sum")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_load_lock = threading.Lock()           # one first load at a time
_LIBS: Dict[str, ctypes.CDLL] = {}      # guarded by: _lock
BUILD_LOG: Dict[str, str] = {}          # guarded by: _lock
_THREAD = threading.local()             # .first_loads: this thread's count


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on PATH, or
    ``/usr/local/cuda/bin/nvcc``."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, PATH and "
                       "/usr/local/cuda/bin); the CUDA kernels cannot be built")


_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)


def source_files(name: str) -> list:
    """``csrc/<name>.cu`` and every ``csrc/`` file it includes with
    ``#include "..."``, recursively, in a fixed order."""
    seen, todo = [], [f"{name}.cu"]
    while todo:
        f = todo.pop()
        if f in seen:
            continue
        seen.append(f)
        todo += [m.decode() for m in _INCLUDE.findall((CSRC / f).read_bytes())]
    return sorted(seen)


def _lib_path(name: str) -> Path:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for f in source_files(name):
        h.update(f.encode() + b"\0" + (CSRC / f).read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def _tmp_path(out: Path) -> Path:
    return out.with_suffix(f".{os.getpid()}.tmp")


def build_all(names: Sequence[str] = KERNEL_SOURCES) -> Dict[str, Path]:
    """Compile every missing library, one ``nvcc`` per source started at
    once; returns name -> path.  Raises ``RuntimeError`` with the
    compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: _lib_path(name) for name in names}
    procs = {}
    for name, out in paths.items():
        if not out.exists():
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(_tmp_path(out)),
                   str(CSRC / f"{name}.cu")]
            procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True)
    failed = []
    for name, proc in procs.items():
        log, _ = proc.communicate()
        with _lock:
            BUILD_LOG[name] = log
        tmp = _tmp_path(paths[name])
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, paths[name])
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it on first use."""
    with _lock:
        lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _load_lock:
        with _lock:
            lib = _LIBS.get(name)
        if lib is not None:             # another thread loaded it meanwhile
            return lib
        path = build_all([name])[name]
        lib = ctypes.CDLL(str(path))
        with _lock:
            _LIBS[name] = lib
        _THREAD.first_loads = first_loads_on_this_thread() + 1
    return lib


def first_loads_on_this_thread() -> int:
    """How many libraries this thread loaded first in the process."""
    return getattr(_THREAD, "first_loads", 0)


def check_args(kernel: str, dev, args) -> None:
    """Raise ``ValueError`` unless each ``(name, tensor, dtype, shape)`` in
    ``args`` is a contiguous tensor of that dtype and shape on ``dev``
    (``shape=None`` skips the shape check)."""
    for name, t, dt, shape in args:
        if (t.device != dev or t.dtype != dt or not t.is_contiguous()
                or (shape is not None and tuple(t.shape) != tuple(shape))):
            raise ValueError(
                f"{kernel}: {name} must be a contiguous {dt} tensor"
                f"{'' if shape is None else f' of shape {tuple(shape)}'} on "
                f"{dev}, got {t.dtype} {tuple(t.shape)} on {t.device} "
                f"(contiguous={t.is_contiguous()})")


_MASK_DTYPES = ("bool", "int8", "uint8")


def check_mask(kernel: str, name: str, x, shape, dev):
    """Raise ``ValueError`` unless ``x`` is None or a contiguous one-byte
    mask (bool, int8 or uint8) of ``shape`` on ``dev``, as the kernels read
    their masks; returns ``x``."""
    if x is not None and (str(x.dtype).removeprefix("torch.") not in
                          _MASK_DTYPES or x.device != dev
                          or tuple(x.shape) != tuple(shape)
                          or not x.is_contiguous()):
        raise ValueError(
            f"{kernel}: {name} must be a contiguous {list(shape)} bool, int8 "
            f"or uint8 tensor on {dev}, got {x.dtype} {tuple(x.shape)} on "
            f"{x.device} (contiguous={x.is_contiguous()})")
    return x
