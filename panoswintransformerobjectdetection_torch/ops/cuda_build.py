"""Build the port's CUDA kernels with `nvcc` and load them with ctypes.

Each source under `csrc/` becomes its own shared library with a plain C
interface, compiled for `sm_90a` into `build/torch_kernels/` at the root of
the checkout (listed in `.gitignore`).  The file name carries a hash of the
source and of the headers under `csrc/` (`tf32.cuh`), so an edited source or
header is rebuilt and an unchanged one is reused.
`build_all` starts one `nvcc` per source at once and waits for all of them.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence, Tuple

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torch_kernels"
SOURCES = ("stem_conv", "roi_align", "window_attention", "dense_crop")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}
_functions: Dict[Tuple[str, str], ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _target(name: str) -> Path:
    """The library of `csrc/<name>.cu`, named by a hash of the source and of
    every header under `csrc/`, so that an edited header rebuilds too."""
    digest = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.name.encode())
        digest.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:12]}.so"


def _start(name: str) -> subprocess.Popen:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = _target(name).with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def _finish(name: str, proc: subprocess.Popen) -> None:
    log, _ = proc.communicate()
    target = _target(name)
    (BUILD_DIR / f"{name}.log").write_text(log)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, target)


def build_all() -> float:
    """Compile every source that has no current library; returns seconds."""
    t0 = time.perf_counter()
    procs = {n: _start(n) for n in SOURCES if not _target(n).exists()}
    for name, proc in procs.items():
        _finish(name, proc)
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    """nvcc's output (with ptxas' register and shared-memory report)."""
    path = BUILD_DIR / f"{name}.log"
    return path.read_text() if path.exists() else ""


def library(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        if not _target(name).exists():
            _finish(name, _start(name))
        lib = ctypes.CDLL(str(_target(name)))
        _loaded[name] = lib
    return lib


def function(name: str, symbol: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """The C entry point `symbol` of `csrc/<name>.cu`, returning an int
    status; its argument types are set once, when it is first looked up."""
    fn = _functions.get((name, symbol))
    if fn is None:
        fn = getattr(library(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _functions[(name, symbol)] = fn
    return fn


def check(status: int, what: str) -> None:
    """Raise on a CUDA error code returned by a launch function."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status}")
