"""Build the CUDA kernels in ``qlora_tpu_torch/csrc`` and load them.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface under ``build/kernels/`` at the
root of the checkout, named by a hash of the sources, so an edited source
rebuilds.  All sources compile at once, one ``nvcc`` each, at first use;
``ctypes`` loads the results.  A missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC.parent.parent / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo"]

_LIBS: dict = {}
_FNS: dict = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _sources():
    srcs = sorted(CSRC.glob("*.cu"))
    headers = sorted(CSRC.glob("*.cuh"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in headers + srcs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return srcs, h.hexdigest()[:16]


def build_all(verbose: bool = False) -> dict:
    """Compile every kernel source (in parallel) and load each library.

    Returns {source stem: ctypes.CDLL}.  Cached for the process."""
    with _LOCK:
        if _LIBS:
            return _LIBS
        srcs, digest = _sources()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = None
        procs = []
        for src in srcs:
            out = BUILD_DIR / f"lib{src.stem}_{digest}.so"
            if out.exists():
                continue
            nvcc = nvcc or _nvcc()
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
                   "-o", str(tmp), str(src)]
            procs.append((src, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed = []
        for src, out, tmp, p in procs:
            log, _ = p.communicate()
            if p.returncode != 0:
                failed.append(f"--- {src.name} (nvcc exit {p.returncode})\n{log}")
                continue
            if verbose and log:
                print(f"--- {src.name}\n{log}", flush=True)
            os.replace(tmp, out)
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
        libs = {src.stem: ctypes.CDLL(str(BUILD_DIR / f"lib{src.stem}_{digest}.so"))
                for src in srcs}
        _LIBS.update(libs)
        return _LIBS


def kernel(lib: str, fn: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry `fn` of library `lib`, typed; every entry returns the
    launch's cudaError_t as an int.  Resolved once, then a dict lookup."""
    f = _FNS.get((lib, fn))
    if f is None:
        f = getattr(build_all()[lib], fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
        _FNS[(lib, fn)] = f
    return f


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")


def stream_ptr(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
