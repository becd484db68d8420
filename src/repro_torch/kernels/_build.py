"""Build the port's CUDA kernels with nvcc and load them with ctypes.

The sources under ``src/repro_torch/csrc/`` have a plain C interface (no
PyTorch headers), so each compiles in seconds: every ``.cu`` file is
compiled to an object by its own ``nvcc`` process, all started together,
and the objects are linked into one shared library under ``build/`` at the
repository root (listed in ``.gitignore``).  The library's directory is
named by a hash of the sources and flags, so an edited kernel is rebuilt
and an unchanged one is loaded as it is.  Nothing builds at import time:
``load_library()`` runs the build on the first kernel launch.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build"
SOURCES = ("flash_attention.cu", "paged_prefill.cu", "fused_paged_decode.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")
LIB_NAME = "librepro_torch_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# name -> argtypes of the C entry points (restype is always int)
SIGNATURES = {
    # dtype, q, k, v, q_pos, k_pos, k_valid, out, B, H, Hkv, Sq, Skv, D,
    # causal, window, softcap, scale, stream
    "repro_flash_attention": [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                              _I, _I, _I, _I, _I, _F, _F, _P],
    # dtype, q, k_pages, v_pages, k_scales, v_scales, bt, offsets, out,
    # B, Hkv, G, S, D, P, NB, softcap, scale, stream
    "repro_paged_prefill": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                            _I, _I, _I, _I, _F, _F, _P],
    # dtype, q, k_new, v_new, k_pages, v_pages, k_scales, v_scales, bt,
    # positions, inv_freq, out, B, Hkv, G, D, P, NB, softcap, scale, stream
    "repro_fused_paged_decode": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                 _P, _P, _I, _I, _I, _I, _I, _I, _F, _F,
                                 _P],
}

_lib = None            # the loaded library (one per process)
last_build = {}        # what the last load did: {"built": bool, "seconds": s}


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit (CUDA_HOME or PATH)")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(CSRC)):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile every source in parallel and link one shared library;
    returns its path (reused when the sources have not changed)."""
    out_dir = BUILD_ROOT / _source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    nvcc = nvcc_path()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="tmp-", dir=BUILD_ROOT))
    extra = ("-Xptxas", "-v") if verbose else ()
    procs = []
    for src in SOURCES:
        obj = tmp / (Path(src).stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, *extra, "-c", str(CSRC / src),
               "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for src, _, p in procs:
        log, _ = p.communicate()
        if verbose and log:
            print(f"[nvcc {src}]\n{log}")
        if p.returncode != 0:
            failed.append(f"{src}:\n{log}")
    if failed:
        shutil.rmtree(tmp, ignore_errors=True)
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    link = subprocess.run(
        [nvcc, "-shared", *[str(o) for _, o, _ in procs],
         "-o", str(tmp / LIB_NAME)],
        capture_output=True, text=True)
    if link.returncode != 0:
        shutil.rmtree(tmp, ignore_errors=True)
        raise RuntimeError("nvcc link failed:\n" + link.stdout + link.stderr)
    try:
        os.replace(tmp, out_dir)        # atomic: a finished build or none
    except OSError:                     # another process finished first
        shutil.rmtree(tmp, ignore_errors=True)
    return lib


def load_library(verbose: bool = False) -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _lib
    if _lib is None:
        t0 = time.perf_counter()
        existed = (BUILD_ROOT / _source_hash() / LIB_NAME).exists()
        lib = ctypes.CDLL(str(build(verbose=verbose)))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        last_build.update(built=not existed,
                          seconds=time.perf_counter() - t0)
        _lib = lib
    return _lib


def check(err: int, name: str):
    """Raise if a kernel's C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name} failed to launch: CUDA error {err}")


def dtype_code(dtype) -> int:
    import torch
    codes = {torch.float32: 0, torch.bfloat16: 1}
    if dtype not in codes:
        raise ValueError(f"kernels take float32 or bfloat16, got {dtype}")
    return codes[dtype]
