"""Build and bind the port's CUDA kernels.

Every ``csrc/*.cu`` source is compiled for Hopper (``sm_90a``) by an
``nvcc`` process of its own, all started together, and the objects are
linked into ``build/repro_torch/libkernels-<hash>.so`` under the
repository root, at first use.  The hash covers the sources, the headers
and the code-generation flags, so an edited source builds a new library
and an unchanged tree reuses the old one.  The library has a plain C interface and is bound
with ``ctypes``: no PyTorch headers are compiled, so a build takes seconds.

Nothing is built when the module is imported; :func:`lib` builds on the
first kernel launch (or when a caller asks for it, as ``chip_smoke.py``
does to time the build).  :func:`set_build_dir` moves the directory (the
tune cache points it at ``<tune dir>/kernels``, so a warm process with
that cache reuses the library built there); a library already loaded in
this process stays loaded.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "repro_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels build only on "
            "a machine with the CUDA toolkit")
    return found


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def set_build_dir(directory) -> Path:
    """Build and look up libraries under ``directory`` from now on;
    returns the previous directory."""
    global BUILD_DIR
    with _LOCK:
        prev, BUILD_DIR = BUILD_DIR, Path(directory)
    return prev


def loaded() -> bool:
    """True once :func:`lib` has bound a library in this process."""
    return _LIB is not None


def build(verbose: bool = False) -> Path:
    """Compile the sources unless the library for their hash exists.

    Returns the library's path.  With ``verbose`` the build also asks
    ptxas for its register and shared-memory report (``-Xptxas -v``, which
    changes no code) and prints the compiler's output.
    """
    build_dir = BUILD_DIR
    out = build_dir / f"libkernels-{_digest()}.so"
    if out.exists():
        return out
    build_dir.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    nvcc = _nvcc()
    objs, procs = [], []
    for src in _sources():
        obj = build_dir / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
               "-c", "-o", str(obj), str(src)]
        objs.append(obj)
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True)))
    try:
        failed = []
        for cmd, proc in procs:  # wait for every compiler, failed or not
            log = proc.communicate()[0]
            if verbose or proc.returncode:
                print(log)
            if proc.returncode:
                failed.append(f"nvcc failed ({proc.returncode}): "
                              f"{' '.join(cmd)}")
        if failed:
            raise RuntimeError("; ".join(failed))
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if verbose or proc.returncode:
            print(proc.stdout + proc.stderr)
        if proc.returncode:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}): "
                               f"{' '.join(cmd)}")
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    os.replace(tmp, out)  # atomic: a concurrent build never sees a torn file
    return out


def _bind(path: Path) -> ctypes.CDLL:
    so = ctypes.CDLL(str(path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    # the launch entry points end in (stream, start event, end event)
    timed = [ptr] * 3
    so.triangle_count_tiles_launch.argtypes = [ptr, ptr, ptr, i32, i32] + timed
    so.triangle_count_tiles_launch.restype = i32
    i64 = ctypes.c_longlong
    for name in ("clique_count_tiles_launch", "clique_count_items_launch"):
        getattr(so, name).argtypes = [ptr] * 6 + [i64] + [i32] * 3 + timed
        getattr(so, name).restype = i32
    so.clique_list_tiles_launch.argtypes = ([ptr] * 9 + [i64] + [i32] * 4
                                           + timed)
    so.clique_list_tiles_launch.restype = i32
    so.dfs_slot_words.argtypes = [i32, i32]
    so.dfs_slot_words.restype = i64
    so.edge_candidates_launch.argtypes = [ptr, ptr, ptr, ptr, i32, i32, ptr]
    so.edge_candidates_launch.restype = i32
    return so


def lib(verbose: bool = False) -> ctypes.CDLL:
    """The bound kernel library, built on first use."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = _bind(build(verbose=verbose))
        return _LIB
