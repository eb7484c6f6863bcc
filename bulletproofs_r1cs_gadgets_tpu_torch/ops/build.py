"""Build and load the port's CUDA kernels (``csrc/*.cu``).

The sources compile at first use with ``nvcc`` for ``sm_90a`` into one
plain C shared library under ``build/`` (gitignored), named by a hash of
the sources, the headers and the flags so an edit rebuilds: one ``nvcc -c``
per source, all started together, then one link.  The library loads
through ``ctypes``.  The C entry points take pointers and the stream as
``c_void_p`` and return ``cudaGetLastError()``; :func:`check` turns a
non-zero code into an exception.  There is no fallback: without ``nvcc``
or a card this raises.

Every build keeps ptxas's register / stack / spill report beside the
library (``<library>.ptxas``); :func:`ptxas_usage` reads it per kernel.
Run ``python -m bulletproofs_r1cs_gadgets_tpu_torch.ops.build`` to build
ahead of time and print the report.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import re
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
    "bp_w4_tile": [_I, _I],
    "bp_w4_partials": [_I, _I],
    "bp_msm_w4": [_VP] * 6 + [_I, _VP],
    "bp_msm_w4_pair": [_VP] * 6 + [_I, _I, _I, _VP],
    "bp_msm_lane": [_VP] * 5 + [_I, _I, _VP],
    "bp_fold_bits": [_VP, _VP, _VP, _VP, _VP, _I, _VP],
    "bp_win_partials": [_I, _I, _I],
    "bp_win5_windows": [],
    "bp_win4_windows": [],
    "bp_table_w5": [_VP, _VP, _I, _VP],
    "bp_table_w4": [_VP, _VP, _I, _VP],
    "bp_msm_win5": [_VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _VP],
    "bp_msm_win": [_VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _VP],
    "bp_msm_win_pair": [_VP] * 6 + [_I] * 10 + [_VP],
    "bp_fold_w3h": [_VP, _VP, _VP, _I, _I, _VP],
    "bp_fold_w3h_comb": [_VP, _VP, _VP, _I, _I, _VP],
    "bp_fold_c_design": [_I],
    "bp_fold_c": [_VP, _VP, _VP, _I, _I, _I, _VP],
    "bp_fold_c_comb": [_VP, _VP, _VP, _I, _I, _I, _VP],
    "bp_padd": [_VP, _VP, _VP, _I, _VP],
    "bp_pdbl": [_VP, _VP, _I, _VP],
    "bp_smul_lanes_design": [_I],
    "bp_smul_lanes": [_VP, _VP, _VP, _I, _I, _VP],
    "bp_msm_block_totals": [_VP] * 5 + [_I, _VP],
    "bp_msm_chunk_acc": [_VP] * 6 + [_I, _VP],
    "bp_fold_grid_design": [_I],
    "bp_fold_grid": [_VP] * 4 + [_I] * 4 + [_VP],
    "bp_mul_fp": [_VP, _VP, _VP, _I, _VP],
    "bp_mul_fq": [_VP, _VP, _VP, _I, _VP],
    "bp_fe_mul_test": [_VP, _VP, _VP, _I, _I, _I, _VP],
    "bp_poseidon_permute": [_VP] * 5 + [_I] * 4 + [_VP],
    "bp_poseidon_chain": [_VP] * 5 + [_I] * 5 + [_VP],
    "bp_sc_mul_test": [_VP, _VP, _VP, _I, _I, _VP],
    "bp_sc_powers": [_VP, _VP, _VP, _I, _I, _VP],
    "bp_tape_flatten": [_VP] * 5 + [_I, _VP],
    "bp_tape_sums_partials": [_I, _I],
    "bp_tape_sums": [_VP, _VP, _I, _VP, _VP, _VP, _I, _VP, _VP, _VP],
    "bp_gh_rows": [_VP, _VP, _I, _VP, _I, _VP],
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


def _run(procs: list[subprocess.Popen]) -> str:
    """Wait for the nvcc processes; their joined output (raises if one
    failed)."""
    failed, said = [], []
    for proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{' '.join(proc.args)} ({proc.returncode}):\n"
                          f"{out}\n{err}")
        said.append(out + err)
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    return "\n".join(said)


def build(verbose: bool = False) -> str:
    """Compile the kernels unless the library for these sources exists;
    returns its path.  ``verbose`` prints ptxas's per-kernel report."""
    so = library_path()
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        cu, _ = _sources()
        tmp = f"{so}.{os.getpid()}.tmp"
        objs = [f"{tmp}.{i}.o" for i in range(len(cu))]
        nvcc = [_nvcc(), *NVCC_FLAGS]
        pipe = dict(stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        said = _run([
            subprocess.Popen([*nvcc, "-Xptxas=-v", "-I", CSRC, "-c", "-o",
                              obj, src], **pipe)
            for src, obj in zip(cu, objs)
        ])
        _run([subprocess.Popen([*nvcc, "-shared", "-o", tmp, *objs], **pipe)])
        for obj in objs:
            os.remove(obj)
        with open(f"{tmp}.ptxas", "w") as f:
            f.write(said)
        os.replace(f"{tmp}.ptxas", f"{so}.ptxas")
        os.replace(tmp, so)
    if verbose:
        with open(f"{so}.ptxas") as f:
            print(f.read())
    return so


_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_PROPS = re.compile(r"Function properties for (\S+)")
_FRAME = re.compile(
    r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
    r"(\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")


def ptxas_usage(text: str) -> dict:
    """ptxas -v output -> {mangled kernel name: {"registers", "stack",
    "spill_stores", "spill_loads"}} for each entry function."""
    usage, frames, entry, props = {}, {}, None, None
    for line in text.splitlines():
        if m := _ENTRY.search(line):
            entry = m.group(1)
            usage.setdefault(entry, {})
        elif m := _PROPS.search(line):
            props = m.group(1)
        elif m := _FRAME.search(line):
            frames[props] = dict(zip(("stack", "spill_stores", "spill_loads"),
                                     map(int, m.groups())))
        elif (m := _REGS.search(line)) and entry is not None:
            usage[entry]["registers"] = int(m.group(1))
    for name, got in usage.items():
        got.update(frames.get(name, {}))
    return usage


def report() -> dict:
    """ptxas_usage of the library that :func:`build` made for these
    sources."""
    with open(f"{build()}.ptxas") as f:
        return ptxas_usage(f.read())


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
