"""Build and load the Hopper kernels of ``repro_torch/csrc``.

At first use every ``csrc/*.cu`` is compiled by its own ``nvcc`` process
(all started together) for ``sm_90a``, and the objects are linked into one
shared library with a plain C interface, loaded with ``ctypes``. The build
goes to ``repro_torch/_build/`` (listed in ``.gitignore``), named by a hash
of the sources, so a changed source rebuilds and an unchanged one loads the
library already built.

Nothing here runs at import: ``nvcc`` is called only when a kernel first
launches, so the module imports on machines without the CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["load", "build_info", "SRC_DIR", "BUILD_DIR"]

SRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"

_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_c_void_p = ctypes.c_void_p
_c_int = ctypes.c_int
_c_int64 = ctypes.c_int64
_c_float = ctypes.c_float

# C entry points: name -> argtypes. Every launcher returns cudaGetLastError();
# the *_smem_bytes queries return a block's dynamic shared memory.
_SIGNATURES = {
    # keys, n_rows, n_cols, num_partitions, dest, hist (or NULL), stream
    "hash_partition_launch": [_c_void_p, _c_int64, _c_int, _c_int,
                              _c_void_p, _c_void_p, _c_void_p],
    # values, seg_ids, n_rows, width, num_segments, dtype code, op code, out, stream
    "segment_reduce_launch": [_c_void_p, _c_void_p, _c_int64, _c_int, _c_int64,
                              _c_int, _c_int, _c_void_p, _c_void_p],
    # q, k, v, out, B, S, H, KV, head_dim, dtype code, causal, window (<= 0: none),
    # softcap (<= 0: none), scale, stream
    "flash_attention_launch": [_c_void_p, _c_void_p, _c_void_p, _c_void_p,
                               _c_int, _c_int, _c_int, _c_int, _c_int, _c_int, _c_int,
                               _c_int64, _c_float, _c_float, _c_void_p],
    # x, dt, A, B, C, D, y, final state, scratch (chunk states, acum and dt, scores),
    # b, L, H, G, dh, ds, chunk, stream
    "ssd_scan_launch": [_c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p,
                        _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_int, _c_int,
                        _c_int, _c_int, _c_int, _c_int, _c_int, _c_void_p],
    # head_dim, dtype code
    "flash_attention_smem_bytes": [_c_int, _c_int],
    # dh, ds, chunk, pass (1 or 3)
    "ssd_scan_smem_bytes": [_c_int, _c_int, _c_int, _c_int],
}

_lock = threading.Lock()
_lib = None
_info: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _sources() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cu"))


def _digest(sources: list[Path]) -> str:
    h = hashlib.sha256()
    for p in sources + sorted(SRC_DIR.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(_ARCH + _FLAGS).encode())
    return h.hexdigest()[:16]


def _build(sources: list[Path], out: Path) -> dict:
    nvcc = _nvcc()
    work = out.parent / f"tmp-{os.getpid()}-{out.stem}"
    work.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for src in sources:
        obj = work / (src.stem + ".o")
        cmd = [nvcc, *_ARCH, *_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs = {}
    failed = []
    for src, _, p in procs:
        logs[src.name] = p.communicate()[0]
        if p.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[f] for f in failed))
    tmp_so = work / out.name
    link = [nvcc, *_ARCH, "-shared", "-o", str(tmp_so),
            *[str(obj) for _, obj, _ in procs]]
    res = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
    if res.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + res.stdout)
    os.replace(tmp_so, out)
    shutil.rmtree(work, ignore_errors=True)
    return {"seconds": time.perf_counter() - t0, "log": logs, "built": True}


def load() -> ctypes.CDLL:
    """The kernels' shared library, built at the first call."""
    global _lib, _info
    with _lock:
        if _lib is not None:
            return _lib
        sources = _sources()
        out = BUILD_DIR / f"librepro_torch_kernels-{_digest(sources)}.so"
        if out.exists():
            info = {"seconds": 0.0, "log": {}, "built": False}
        else:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            info = _build(sources, out)
        lib = ctypes.CDLL(str(out))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = _c_int
        lib.repro_cuda_error_string.argtypes = [_c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        info["path"] = str(out)
        _info = info
        _lib = lib
        return lib


def build_info() -> dict:
    """Seconds the build took, nvcc's output per source, and the library
    path (empty before :func:`load`)."""
    return dict(_info)


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = _lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
