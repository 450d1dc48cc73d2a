"""Build and bind the port's CUDA kernels.

The `.cu` sources under `csrc/` are compiled with nvcc for Hopper
(``-gencode arch=compute_90a,code=sm_90a``), one nvcc per source, all
started together, and linked into one shared library with a plain C
interface that `ctypes` loads. The build runs at first use into
``build/repro_torch/`` at the root of the checkout; the library's file
name carries a digest of the sources, so an edited source is never
served by a stale library. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # name: (argtypes, restype); pointers and the stream as c_void_p
    "masked_topk_blocks_launch": ([_P] * 7 + [_I] * 8 + [_P], _I),
    "tile_scan_smem_bytes": ([_I, _I], ctypes.c_longlong),
    "tile_scan_layout": ([_I], _I),
    "topk_select_workspace_bytes": ([_I] * 3, ctypes.c_longlong),
    "masked_topk_large_launch": ([_P] * 9 + [_I] * 8 + [_P], _I),
    "masked_topk_blocks_large_launch": ([_P] * 9 + [_I] * 11 + [_P], _I),
    "fused_live_launch": ([_P] * 4 + [_I] + [_P] * 4 + [_I] * 2 + [_P, _I]
                          + [_P] * 2 + [_I] * 6 + [_P], _I),
    "fused_live_large_launch": ([_P] * 4 + [_I] + [_P] * 4 + [_I] * 2
                                + [_P, _I] + [_P] * 4 + [_I] * 6 + [_P], _I),
    "merge_topk_workspace_bytes": ([_I] * 5, ctypes.c_longlong),
    "merge_topk_launch": ([_P] * 5 + [_I] * 5 + [_P], _I),
    "selectivity_launch": ([_P] * 5 + [_I] * 5 + [_P], _I),
    "selectivity_query_group": ([_I], _I),
    "selectivity_tile_rows": ([_I], _I),
    "repro_torch_error_string": ([_I], ctypes.c_char_p),
}

_lib: ctypes.CDLL | None = None
_lib_lock = threading.Lock()   # shard threads may make the first launch
_count_lock = threading.Lock()   # ... and count launches at the same time
build_log = ""          # nvcc's output of the build this process made
build_seconds = 0.0


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha1()
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:12]


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be "
                       "built")


def build() -> Path:
    """Compile the sources (if this digest is not built yet) and return
    the shared library's path. Raises RuntimeError with nvcc's output
    when a compile or the link fails."""
    global build_log, build_seconds
    lib_path = BUILD_DIR / f"kernels-{_digest()}.so"
    if lib_path.exists():
        return lib_path
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
                 "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        logs = [p.communicate()[0] for p in procs]
        log = "".join(logs)
        if any(p.returncode for p in procs):
            raise RuntimeError(f"nvcc failed:\n{log}")
        tmp_lib = Path(tmp) / lib_path.name
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp_lib),
             *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, lib_path)     # atomic: concurrent builds agree
    build_seconds = time.perf_counter() - t0
    build_log = log + link.stdout
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = lib
        return _lib


def check(code: int, what: str) -> None:
    """Raise if a launch entry point returned a CUDA error."""
    if code:
        msg = library().repro_torch_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")


def count_launch(wrapper) -> None:
    """Add one to `wrapper.launches`, the launch counter of a kernel's
    wrapper; shard threads launch at the same time."""
    with _count_lock:
        wrapper.launches += 1
