"""Build the port's CUDA kernels from ``ops/csrc/*.cu`` and load them.

``nvcc`` compiles each source into an object, all sources at once in
parallel processes, and links them into one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), under
``build/kernels/`` at the repository root, named by a hash of the sources
and flags: a changed source rebuilds, an unchanged one loads the library
already built.  The library is loaded with ``ctypes``; every pointer and the
stream are passed as ``c_void_p``.  Nothing is built at import time.
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

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-lineinfo"]

_lib = None
build_log = ""  # nvcc's messages of the last build in this process
build_seconds = {}  # each source's nvcc wall seconds in that build


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "a machine with the CUDA toolkit")
    return found


def sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"wavernn_kernels_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile the sources if the library for their hash is missing.
    ``verbose`` asks ptxas for each kernel's registers, shared memory and
    spills (kept in ``build_log``)."""
    global build_log, build_seconds
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    cus = [s for s in sources() if s.suffix == ".cu"]
    objs = [BUILD_DIR / f"{tag}.{s.stem}.o" for s in cus]
    ptxas = ["-Xptxas", "-v"] if verbose else []
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc_path(), *NVCC_FLAGS, *ptxas, "-c",
                               "-o", str(o), str(s)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for s, o in zip(cus, objs)]
    outs, secs = {}, {}

    def wait(s, proc):   # one thread a source: its own end time
        outs[s.name] = proc.communicate()[0]
        secs[s.name] = round(time.perf_counter() - t0, 1)
    waits = [threading.Thread(target=wait, args=a) for a in zip(cus, procs)]
    for w in waits:
        w.start()
    for w in waits:
        w.join()
    logs, failed = [], []
    for s, proc in zip(cus, procs):
        log = outs[s.name]
        logs.append(f"== {s.name} ({secs[s.name]} s)\n{log}")
        if proc.returncode != 0:
            failed.append(f"{s.name} ({proc.returncode}):\n{log}")
    try:
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        link = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-shared", "-o",
                               str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stderr}")
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    build_log = "\n".join(logs)
    build_seconds = secs
    os.replace(tmp, out)
    return out


def load_library():
    """The built library, with its C entry points typed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for fn in (lib.wavernn_decode, lib.wavernn_decode_cluster,
                   lib.tts_decode, lib.tts_decode_spans, lib.matmul_floor):
            fn.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                           ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.wavernn_decode_cluster_spans.argtypes = [
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p,
            ctypes.c_void_p]
        lib.wavernn_decode_cluster_spans.restype = ctypes.c_int
        lib.wavernn_decode_cluster_max.argtypes = [
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_longlong)]
        lib.wavernn_decode_cluster_max.restype = ctypes.c_int
        lib.wavernn_decode_cluster_bytes.argtypes = [
            ctypes.POINTER(ctypes.c_longlong)]
        lib.wavernn_decode_cluster_bytes.restype = ctypes.c_longlong
        lib.tts_decode_max_ctas.argtypes = [ctypes.POINTER(ctypes.c_int),
                                            ctypes.c_longlong, ctypes.c_int,
                                            ctypes.c_int]
        lib.tts_decode_max_ctas.restype = ctypes.c_int
        for fn in (lib.tts_decode_smem_bytes, lib.tts_decode_workspace_bytes):
            fn.argtypes = [ctypes.POINTER(ctypes.c_longlong)]
            fn.restype = ctypes.c_longlong
        lib.tts_barrier_loop.argtypes = [ctypes.c_int, ctypes.c_int,
                                         ctypes.c_longlong, ctypes.c_void_p,
                                         ctypes.c_void_p]
        lib.tts_barrier_loop.restype = ctypes.c_int
        lib.wavernn_error_string.argtypes = [ctypes.c_int]
        lib.wavernn_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib
