"""ctypes loader for the native helper library, built on demand.

The library builds into the package's gitignored ``build/`` directory,
named by a hash of its source, its flags and the host CPU (it is built
with ``-march=native``, so a build from another CPU may not run here or
may run slower).  ``g++`` writes a temporary file
that is renamed into place under an exclusive file lock, so processes that
load it at the same time (parallel test workers) never see a half-written
library: the first builds it, the others wait and then load it.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import platform
import subprocess

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "bptpu_native.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "build")
_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]


# /proc/cpuinfo keys that name the CPU and its instruction sets (x86, Arm)
_CPU_KEYS = ("model name", "flags", "CPU implementer", "CPU part", "Features")


def _cpu_id() -> str:
    """The host CPU as ``-march=native`` sees it: /proc/cpuinfo's model and
    instruction-set lines (each distinct line once), or the platform's
    names where there is no /proc/cpuinfo."""
    try:
        with open("/proc/cpuinfo") as f:
            lines = f.read().splitlines()
    except OSError:
        return f"{platform.machine()} {platform.processor()}"
    keep = {ln.strip() for ln in lines if ln.split(":")[0].strip() in _CPU_KEYS}
    return "\n".join(sorted(keep)) or platform.machine()


def library_path() -> str:
    h = hashlib.sha256()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(_FLAGS).encode())
    h.update(_cpu_id().encode())
    return os.path.join(BUILD_DIR, f"libbptpu_{h.hexdigest()[:16]}.so")


def build(force: bool = False) -> str:
    """Compile the native library with g++ (idempotent; safe to call from
    several processes at once)."""
    so = library_path()
    if not force and os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "libbptpu.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if force or not os.path.exists(so):
            tmp = f"{so}.{os.getpid()}.tmp"
            try:
                subprocess.run(
                    ["g++", *_FLAGS, "-o", tmp, _SRC],
                    check=True, capture_output=True,
                )
                os.replace(tmp, so)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
    return so


class _Native:
    """Typed wrappers over the C ABI."""

    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        lib.keccak_f1600.argtypes = [ctypes.c_char_p]
        for name in ("sc_mul", "sc_add", "sc_sub"):
            getattr(lib, name).argtypes = [ctypes.c_char_p] * 3
        lib.sc_inv.argtypes = [ctypes.c_char_p] * 2
        lib.poseidon_permutation_batch.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int,
        ]
        # vectorized field layer (core/scvec.py): (n, 4) u64 arrays
        u64p = ctypes.POINTER(ctypes.c_uint64)
        i64 = ctypes.c_longlong
        i64p = ctypes.POINTER(i64)
        for name in ("sc_vec_mul", "sc_vec_add", "sc_vec_sub"):
            getattr(lib, name).argtypes = [u64p, u64p, u64p, i64]
        lib.sc_vec_scale.argtypes = [u64p, u64p, u64p, i64]
        lib.sc_vec_axpby.argtypes = [u64p, u64p, u64p, u64p, u64p, i64]
        lib.sc_vec_inner.argtypes = [u64p, u64p, i64, u64p]
        lib.sc_vec_powers.argtypes = [u64p, u64p, i64]
        lib.sc_vec_from_wide.argtypes = [ctypes.c_char_p, u64p, i64]
        lib.sc_vec_batch_inv.argtypes = [u64p, u64p, i64]
        lib.sc_flatten.argtypes = [u64p, u64p, i64p, i64p, i64, u64p]
        lib.vsmt2_chain_witness.argtypes = [
            u64p, u64p, u64p, i64, ctypes.c_int, ctypes.c_char_p,
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, u64p, u64p, u64p,
        ]
        lib.poseidon_permutation_witness.argtypes = [
            u64p, u64p, ctypes.c_int, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, u64p,
        ]
        lib.ge_from_uniform_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, i64
        ]
        # single-core group layer (NativeBackend / baseline proxy)
        lib.ge_msm.argtypes = [u64p, ctypes.c_void_p, i64, ctypes.c_void_p]
        lib.ge_fold_vec.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, u64p, u64p, ctypes.c_void_p,
            i64,
        ]
        lib.ge_fold_vec_var.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, u64p, u64p, ctypes.c_void_p,
            i64,
        ]
        lib.ge_scalar_mul_vec.argtypes = [
            ctypes.c_void_p, u64p, ctypes.c_void_p, i64
        ]
        lib.ge_bench.argtypes = [i64, ctypes.c_void_p, ctypes.c_int]

    def keccak_f1600(self, state: bytearray) -> None:
        buf = (ctypes.c_char * 200).from_buffer(state)
        self._lib.keccak_f1600(buf)

    def sc_op(self, name: str, a: bytes, b: bytes) -> bytes:
        out = ctypes.create_string_buffer(32)
        getattr(self._lib, name)(a, b, out)
        return out.raw

    def sc_inv(self, a: bytes) -> bytes:
        out = ctypes.create_string_buffer(32)
        self._lib.sc_inv(a, out)
        return out.raw

    def ge_from_uniform_batch(self, seeds: bytes, threads: int = 0) -> bytes:
        """n = len(seeds)//64 Elligator hash-to-group maps (RFC 9496
        one-way map x2 + Edwards add per point); returns n * 128 bytes of
        extended coordinates (4 x 32 LE).  The C call releases the GIL, so
        chunks run on a thread pool."""
        import os as _os
        from concurrent.futures import ThreadPoolExecutor

        n = len(seeds) // 64
        out = ctypes.create_string_buffer(128 * n)
        if n == 0:
            return out.raw
        nt = threads or min(max(1, (_os.cpu_count() or 2) - 1), 8)
        nt = min(nt, n)
        bounds = [n * k // nt for k in range(nt + 1)]
        sbuf = ctypes.create_string_buffer(seeds, len(seeds))
        fn = self._lib.ge_from_uniform_batch
        sa = ctypes.addressof(sbuf)
        oa = ctypes.addressof(out)

        def run(k):
            lo, hi = bounds[k], bounds[k + 1]
            fn(sa + 64 * lo, oa + 128 * lo, hi - lo)

        if nt == 1:
            run(0)
        else:
            with ThreadPoolExecutor(max_workers=nt) as pool:
                list(pool.map(run, range(nt)))
        return out.raw

    def poseidon_permutation_batch(
        self,
        states: bytes,
        n: int,
        width: int,
        round_keys: bytes,
        mds: bytes,
        full_b: int,
        partial: int,
        full_e: int,
        sbox_type: int,
    ) -> bytes:
        out = ctypes.create_string_buffer(len(states))
        self._lib.poseidon_permutation_batch(
            states, out, n, width, round_keys, mds, full_b, partial, full_e,
            sbox_type,
        )
        return out.raw


def load_native() -> _Native | None:
    try:
        so = build()
        return _Native(ctypes.CDLL(so))
    except Exception:
        return None


if __name__ == "__main__":
    print(build(force=True))
