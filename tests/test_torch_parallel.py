"""The port's multi-device layer and proof stream on the CPU, against the
JAX package.

* ``ShardedWalkMsm`` over ``["cpu"] * 4`` with ``ck.CHUNK`` lowered to 16
  (4 shards x 2 chunks) against the JAX package's host
  ``multiscalar_mul`` (the oracle of tests/test_sharded_fast.py), with
  every chunk valid, a valid span ending inside a shard, dead shards and
  one valid chunk; words past the span are nonzero and must be ignored,
  and each shard walks its clamped count.  (The JAX package's own sharded
  walk is a multi-minute ``shard_map`` compile, ``mesh_slow``.)
* ``ShardedWalkVerifyBackend`` on those shards verifies a real proof
  (``__graft_entry__.py``'s ``build_big`` chain at 41 multipliers, padded
  to 64 = 4 chunks of 16) made by the port and the same circuit's proof
  made by the JAX host engine, and rejects a tampered copy.
* ``prove_provers_devices`` on ``["cpu", "cpu"]`` with
  ``TorchBackend("cpu", min_device_n=1)``: bytes equal to the JAX
  package's ``prove_provers_devices`` on two of its CPU devices for the
  seeded provers of tests/test_device_batch.py; sequential equals
  threaded; without devices and without CUDA it raises.
  ``bootstrap_distributed`` is False in one process, True with an
  explicit ``init_method`` (gloo, world size 1); the kernel library's
  loader builds one at a time under many threads.
* ``prove_stream`` (port, on a CPU ``TorchBackend``) against the JAX
  package's ``prove_stream`` on the provers of tests/test_parallel.py:
  equal bytes in stream order, the report's count and group count,
  ``keep=False`` with ``on_result``; with no backend and no CUDA it
  raises.
* ``make_mesh`` splits devices by the reference's rule.

CPU tensors route to the kernels' plain versions.  Tolerance: exact
(equal compressed points, equal proof bytes).
"""

import hashlib
import os
import socket
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

import bulletproofs_r1cs_gadgets_tpu as jaxpkg
import bulletproofs_r1cs_gadgets_tpu_torch as port
from bulletproofs_r1cs_gadgets_tpu.core.ristretto import (
    multiscalar_mul as jmultiscalar_mul,
)
from bulletproofs_r1cs_gadgets_tpu.gadgets import r1cs_utils as jutils
from bulletproofs_r1cs_gadgets_tpu.ops.backend import DeviceBackend
from bulletproofs_r1cs_gadgets_tpu.parallel import device_batch as jdb
from bulletproofs_r1cs_gadgets_tpu.parallel import mesh as jmesh
from bulletproofs_r1cs_gadgets_tpu.parallel import stream as jstream
from bulletproofs_r1cs_gadgets_tpu_torch import (
    BulletproofGens,
    R1CSProof,
    TorchBackend,
    VerificationError,
    prove_provers_devices,
    prove_stream,
    scvec,
)
from bulletproofs_r1cs_gadgets_tpu_torch.gadgets import r1cs_utils as tutils
from bulletproofs_r1cs_gadgets_tpu_torch.ops import build
from bulletproofs_r1cs_gadgets_tpu_torch.ops import chunks as ck
from bulletproofs_r1cs_gadgets_tpu_torch.ops import cuda_curve as cc
from bulletproofs_r1cs_gadgets_tpu_torch.ops import field as F
from bulletproofs_r1cs_gadgets_tpu_torch.parallel.device_batch import (
    DevicePinnedBackend,
    bootstrap_distributed,
)
from bulletproofs_r1cs_gadgets_tpu_torch.parallel.mesh import make_mesh
from bulletproofs_r1cs_gadgets_tpu_torch.parallel.sharded_fast import (
    ShardedWalkMsm,
    ShardedWalkVerifyBackend,
    local_walk_plain,
)
from test_torch_backend import PKGS

torch.set_num_threads(1)

SHARD_CHUNK = 16  # ck.CHUNK lowered: 4 shards x 2 chunks = 128 points


def _counted(monkeypatch) -> list:
    """The valid count of every msm_grid_local call."""
    seen = []
    walk = cc.msm_grid_local

    def wrap(points, words, acc, valid, chunk):
        seen.append(valid)
        return walk(points, words, acc, valid, chunk)

    monkeypatch.setattr(cc, "msm_grid_local", wrap)
    return seen


# ------------------------------------------------------------ sharded walk
@pytest.mark.parametrize("valid, per_shard", [
    (8, [2, 2, 2, 2]),  # every chunk valid
    (5, [2, 2, 1, 0]),  # the span ends inside shard 2; shard 3 dead
    (3, [2, 1, 0, 0]),  # two dead shards
    (1, [1, 0, 0, 0]),
])
def test_sharded_walk_matches_host_oracle(valid, per_shard, monkeypatch):
    monkeypatch.setattr(ck, "CHUNK", SHARD_CHUNK)
    seen = _counted(monkeypatch)
    span = 8 * SHARD_CHUNK
    gens = jaxpkg.BulletproofGens(span).share(0)
    rows = scvec.from_wide_bytes(np.random.RandomState(40 + valid).bytes(64 * span))
    rows[:2] = scvec.from_ints([0, port.L - 1])
    sharded = ShardedWalkMsm(["cpu"] * 4, local_chunks=2)
    assert "4 shards on 1 device" in repr(sharded)
    got = sharded.msm(F.from_raw(gens.G_raw(span)), ck.w4_words(rows, "cpu"),
                      valid)
    live = valid * SHARD_CHUNK
    want = jmultiscalar_mul(
        [jaxpkg.Scalar(int(s.v)) for s in scvec.to_scalars(rows[:live])],
        gens.G(live),
    )
    assert got.compress() == want.compress()
    assert seen == per_shard


def test_sharded_walk_places_shards_and_takes_a_mesh(monkeypatch):
    """Shards from place() and a mesh's points axis give the same total
    as the plain local walk over the whole span."""
    monkeypatch.setattr(ck, "CHUNK", SHARD_CHUNK)
    mesh = make_mesh(devices=["cpu"] * 8)  # (4, 2): two points shards
    sharded = ShardedWalkMsm(mesh, local_chunks=4)
    assert sharded.n_shards == 2 and sharded.total_chunks == 8
    span = 8 * SHARD_CHUNK
    pts = F.from_raw(BulletproofGens(span).G_raw(span))
    words = ck.w4_words(
        scvec.from_wide_bytes(np.random.RandomState(5).bytes(64 * span)),
        "cpu")
    got = sharded.msm(sharded.place(pts), words, 6)
    plain = ShardedWalkMsm(["cpu"], local_chunks=8, local_walk=local_walk_plain)
    assert got == plain.msm(pts, words, 6)
    with pytest.raises(ValueError):
        sharded.msm(pts, words, 9)


def test_make_mesh_split_rule_matches_reference():
    for n in (1, 2, 4, 8):
        mesh = make_mesh(n, devices=["cpu"] * 8)
        assert mesh.shape == dict(jmesh.make_mesh(n).shape), n
        assert mesh.axis_names == ("batch", "points")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            make_mesh()


# ------------------------------------------------- sharded verify backend
def _build_big(m, cs, w, links=40):
    """``__graft_entry__.py``'s build_big at `links` links (links + 1
    multipliers) for the package namespace `m`."""
    if isinstance(w, tuple) and isinstance(w[0], int):
        a, b = w
        com_a, va = cs.commit(m.Scalar(a), m.Scalar.random())
        com_b, vb = cs.commit(m.Scalar(b), m.Scalar.random())
        comms = [com_a, com_b]
    else:
        comms = w
        va, vb = cs.commit(comms[0]), cs.commit(comms[1])
    _, _, o = cs.multiply(va, vb)
    for _ in range(links):
        _, _, o = cs.multiply(o + m.Scalar(1), o + m.Scalar(2))
    return comms


def _proof(m):
    prover = m.Prover(m.PedersenGens.default(), m.Transcript(b"ShardWalk"))
    comms = _build_big(m, prover, (3, 5))
    return comms, prover.prove(m.BulletproofGens(64))


def test_sharded_verify_backend_accepts_port_and_jax_proofs(monkeypatch):
    monkeypatch.setattr(ck, "CHUNK", SHARD_CHUNK)
    seen = _counted(monkeypatch)
    backend = ShardedWalkVerifyBackend(ShardedWalkMsm(["cpu"] * 4,
                                                      local_chunks=2))
    m = PKGS["port"]

    def verify(comms, proof):
        verifier = m.Verifier(m.Transcript(b"ShardWalk"))
        _build_big(m, verifier, list(comms))
        verifier.verify(proof, m.PedersenGens.default(), BulletproofGens(64),
                        backend=backend)

    comms, proof = _proof(m)
    verify(comms, proof)
    # G and H: 64 points = 4 of the 8 chunks, shards 2 and 3 dead
    assert seen == [2, 2, 0, 0] * 2
    jcomms, jproof = _proof(PKGS["jax"])
    verify(jcomms, R1CSProof.from_bytes(jproof.to_bytes()))
    raw = bytearray(proof.to_bytes())
    raw[len(raw) - 64] ^= 1  # low byte of the IPP's `a` scalar
    with pytest.raises(VerificationError):
        verify(comms, R1CSProof.from_bytes(bytes(raw)))


# ------------------------------------------------------- placed batches
def _mk_provers(m, n):
    """tests/test_device_batch.py's seeded provers (bound checks of
    20 + i in [10, 100], 16 bits) in the package namespace `m`."""
    provers = []
    for i in range(n):
        rng = np.random.RandomState(1000 + i)
        p = m.Prover(m.PedersenGens.default(), m.Transcript(b"DevBatch"),
                     rng=rng)
        val = 20 + i
        a, b = val - 10, 100 - val
        qs = []
        for x in (val, a, b):
            _, var = p.commit(m.Scalar(x), m.Scalar.random(rng))
            qs.append(m.AllocatedQuantity(var, x))
        m.bound_check_gadget(p, *qs, 100, 10, 16)
        provers.append(p)
    return provers


def _cpu_backend(device):
    return TorchBackend(device, min_device_n=1)


def test_placed_proofs_match_jax_package():
    jgens = jaxpkg.BulletproofGens(64)
    want = jdb.prove_provers_devices(
        _mk_provers(PKGS["jax"], 4), jgens, devices=jax.devices()[:2],
        backend_factory=lambda: DeviceBackend(min_device_n=1 << 30),
    )
    gens = BulletproofGens(64)
    placed = prove_provers_devices(
        _mk_provers(PKGS["port"], 4), gens, devices=["cpu", "cpu"],
        backend_factory=_cpu_backend,
    )
    assert [p.to_bytes() for p in placed] == [p.to_bytes() for p in want]
    seq = prove_provers_devices(
        _mk_provers(PKGS["port"], 4), gens, devices=["cpu", "cpu"],
        backend_factory=_cpu_backend, sequential=True,
    )
    assert [p.to_bytes() for p in seq] == [p.to_bytes() for p in want]


def test_pinned_backend_passes_attributes_and_defaults_need_cuda():
    pinned = DevicePinnedBackend(_cpu_backend("cpu"), "cpu")
    assert pinned.min_device_n == 1 and pinned.device == torch.device("cpu")
    assert pinned.inner.device == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            prove_provers_devices(_mk_provers(PKGS["port"], 1),
                                  BulletproofGens(64))


def test_kernel_library_builds_once_under_many_threads(monkeypatch):
    """``build.load`` from more threads than cores at once (the group
    threads of prove_provers_devices each launch first): one build at a
    time, every thread gets the library."""
    state = {"inside": 0, "most": 0, "builds": 0}
    lock = threading.Lock()

    def slow_load():
        with lock:
            state["inside"] += 1
            state["most"] = max(state["most"], state["inside"])
            state["builds"] += 1
        time.sleep(0.001)
        with lock:
            state["inside"] -= 1
        return "lib"

    monkeypatch.setattr(build, "_load", slow_load)
    got = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: got.append(build.load()))
                   for _ in range(4 * (os.cpu_count() or 4))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert got == ["lib"] * len(threads)
    assert state["most"] == 1 and state["builds"] == len(threads)


def test_bootstrap_distributed(monkeypatch):
    for key in ("MASTER_ADDR", "WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    assert bootstrap_distributed() is False
    with socket.socket() as s:
        s.bind(("localhost", 0))
        free = s.getsockname()[1]
    assert bootstrap_distributed(init_method=f"tcp://localhost:{free}",
                                 world_size=1, rank=0, backend="gloo")
    try:
        assert torch.distributed.get_world_size() == 1
        assert bootstrap_distributed() is True  # already joined
    finally:
        torch.distributed.destroy_process_group()


# ------------------------------------------------------------ the stream
class StreamRng:
    """tests/test_parallel.py's per-prover deterministic rng."""

    def __init__(self, seed: bytes):
        self.key = seed
        self.ctr = 0

    def bytes(self, n: int) -> bytes:
        out = b""
        while len(out) < n:
            out += hashlib.sha256(
                self.key + self.ctr.to_bytes(8, "little")
            ).digest()
            self.ctr += 1
        return out[:n]


def _stream_maker(m, constrain):
    def make_prover(i: int):
        p = m.Prover(m.PedersenGens.default(), m.Transcript(b"Stream"),
                     rng=StreamRng(b"s%d" % i))
        a, b = m.Scalar(3 + i), m.Scalar(5 + i)
        _, va = p.commit(a, m.Scalar(17))
        _, vb = p.commit(b, m.Scalar(19))
        _, _, o = p.multiply(va, vb)
        constrain(p, o, a * b)
        return p

    return make_prover


def test_prove_stream_matches_jax_package():
    want, _ = jstream.prove_stream(
        _stream_maker(PKGS["jax"], jutils.constrain_lc_with_scalar), 7,
        jaxpkg.BulletproofGens(128), backend=None, wave=2, inflight=4,
    )
    want = [p.to_bytes() for p in want]
    make = _stream_maker(PKGS["port"], tutils.constrain_lc_with_scalar)
    gens = BulletproofGens(128)
    backend = TorchBackend("cpu", min_device_n=1)
    proofs, rep = prove_stream(make, 7, gens, backend=backend, wave=2,
                               inflight=4)
    assert [p.to_bytes() for p in proofs] == want
    assert rep.count == 7 and rep.proofs_per_s > 0
    assert len(rep.group_times) == 4  # ceil(7 / 2) groups
    assert rep.hbm_peak_bytes is None  # a backend on the CPU
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):  # the card by default, never the CPU
            prove_stream(make, 7, gens, wave=2, inflight=4)
    got = {}
    proofs, rep = prove_stream(
        make, 5, gens, backend=backend, wave=2, inflight=2, keep=False,
        on_result=lambda i, pf: got.__setitem__(i, pf.to_bytes()),
    )
    assert proofs is None and rep.count == 5
    assert [got[i] for i in range(5)] == want[:5]
