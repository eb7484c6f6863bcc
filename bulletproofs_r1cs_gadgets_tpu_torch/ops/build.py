"""Build and load the port's CUDA kernels (``csrc/*.cu``).

The sources compile at first use with ``nvcc`` for ``sm_90a`` into one
plain C shared library under ``build/`` (gitignored), named by a hash of
the sources, the headers and the flags so an edit rebuilds: one ``nvcc -c``
per source, all started together, then one link.  The library loads
through ``ctypes``.  The C entry points take pointers and the stream as
``c_void_p`` and return ``cudaGetLastError()``; :func:`check` turns a
non-zero code into an exception.  There is no fallback: without ``nvcc``
or a card this raises.

Run ``python -m bulletproofs_r1cs_gadgets_tpu_torch.ops.build`` to build
ahead of time and print ptxas's register / spill report.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import threading

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
]

_VP, _I = ctypes.c_void_p, ctypes.c_int
# entry point -> argument types (every one returns an int)
SIGNATURES = {
    "bp_set_device": [_I],
    "bp_msm_threads": [],
    "bp_msm_w4": [_VP, _VP, _VP, _VP, _VP, _I, _VP],
    "bp_msm_w4_pair": [_VP, _VP, _VP, _VP, _VP, _I, _I, _I, _VP],
    "bp_msm_lane": [_VP, _VP, _VP, _VP, _I, _I, _VP],
    "bp_fold_bits": [_VP, _VP, _VP, _VP, _VP, _I, _VP],
    "bp_win_points_per_block": [],
    "bp_win5_windows": [],
    "bp_win4_windows": [],
    "bp_table_w5": [_VP, _VP, _I, _VP],
    "bp_table_w4": [_VP, _VP, _I, _VP],
    "bp_msm_win5": [_VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _VP],
    "bp_msm_win": [_VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _VP],
    "bp_msm_win_pair": [_VP] * 6 + [_I] * 10 + [_VP],
    "bp_fold_w3h": [_VP, _VP, _VP, _I, _I, _VP],
    "bp_fold_w3h_comb": [_VP, _VP, _VP, _I, _I, _VP],
    "bp_fold_c": [_VP, _VP, _VP, _I, _I, _VP],
    "bp_fold_c_comb": [_VP, _VP, _VP, _I, _I, _VP],
    "bp_padd": [_VP, _VP, _VP, _I, _VP],
    "bp_pdbl": [_VP, _VP, _I, _VP],
    "bp_smul_lanes": [_VP, _VP, _VP, _I, _VP],
    "bp_msm_block_totals": [_VP, _VP, _VP, _VP, _I, _VP],
    "bp_msm_chunk_acc": [_VP, _VP, _VP, _VP, _VP, _I, _VP],
    "bp_fold_grid": [_VP, _VP, _VP, _VP, _I, _I, _I, _VP],
    "bp_mul_fp": [_VP, _VP, _VP, _I, _VP],
    "bp_mul_fq": [_VP, _VP, _VP, _I, _VP],
}


def _sources() -> tuple[list[str], list[str]]:
    cu = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    headers = sorted(glob.glob(os.path.join(CSRC, "*.cuh")))
    return cu, headers


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"
    )
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> str:
    cu, headers = _sources()
    h = hashlib.sha256()
    for path in cu + headers:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libbp_kernels_{h.hexdigest()[:16]}.so")


def _run(procs: list[subprocess.Popen], verbose: bool) -> None:
    failed = []
    for proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{' '.join(proc.args)} ({proc.returncode}):\n"
                          f"{out}\n{err}")
        elif verbose:
            print(out + err)
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))


def build(verbose: bool = False) -> str:
    """Compile the kernels unless the library for these sources exists;
    returns its path.  ``verbose`` adds ptxas's per-kernel report."""
    so = library_path()
    if os.path.exists(so) and not verbose:
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    cu, _ = _sources()
    tmp = f"{so}.{os.getpid()}.tmp"
    objs = [f"{tmp}.{i}.o" for i in range(len(cu))]
    nvcc = [_nvcc(), *NVCC_FLAGS] + (["-Xptxas=-v"] if verbose else [])
    pipe = dict(stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    _run([
        subprocess.Popen([*nvcc, "-I", CSRC, "-c", "-o", obj, src], **pipe)
        for src, obj in zip(cu, objs)
    ], verbose)
    _run([subprocess.Popen([*nvcc, "-shared", "-o", tmp, *objs], **pipe)],
         False)
    for obj in objs:
        os.remove(obj)
    os.replace(tmp, so)
    return so


_LOAD_LOCK = threading.Lock()


def load() -> ctypes.CDLL:
    """The kernel library, built on first call (raises without nvcc or a
    CUDA device).  Threads that call it at once (one per device in
    ``prove_provers_devices``) wait for one build: two builds in one
    process would share their temporary file names."""
    with _LOAD_LOCK:
        return _load()


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the kernels cannot run")
    lib = ctypes.CDLL(build())
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


if __name__ == "__main__":
    print(build(verbose=True))
