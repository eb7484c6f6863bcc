"""Entry points of the port: the counterpart of the JAX package's
``__graft_entry__.py``.

``entry(device="cuda")`` - the forward step of the flagship pipeline
                  (batched VSMT-2 Poseidon witness hashing, width 6,
                  rounds 4+140+4, cube S-box, plus an MSM commitment
                  partial) and the reference's inputs, on one device.
``dryrun_multichip(n, devices=None)`` - proves AND verifies real R1CS
                  proofs with every MSM sharded over n devices (phases A,
                  B, B2 on ``parallel.sharded_backend``), places whole
                  proofs on the devices (C) and verifies a proof through
                  the fast path's sharded walk (D).

Both run on the card unless given CPU devices: ``dryrun_multichip``
takes the visible cards by default and raises if there are fewer than
n; only an explicit ``devices=["cpu"] * n`` runs on the host (the
kernels' plain versions).  A device list may repeat a card.

    python -m bulletproofs_r1cs_gadgets_tpu_torch.graft_entry [n]

runs ``dryrun_multichip(n)`` on the visible cards (n defaults to their
count; phase B needs two).
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from .parallel.mesh import cuda_devices


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        cuda_devices()  # raises without a card
    return dev


def entry(device="cuda"):
    """(proving_step, (witness, points, bits)): B 8 proofs of W 4 path
    lanes, N 8 points with 16-bit scalars, ``RandomState(0)`` bits."""
    from .core.ristretto import RistrettoPoint
    from .core.scalar import Scalar
    from .ops.curve import points_to_device
    from .ops.field import FQ
    from .parallel.pipeline import proving_step

    dev = _device(device)
    B, W, N, NBITS = 8, 4, 8, 16
    witness = FQ.to_device(list(range(1, B * W + 1)), dev).reshape(B, W, 8)
    base = RistrettoPoint.basepoint()
    pts = [base.scalar_mul(Scalar(i + 1)) for i in range(N)]
    points = points_to_device(pts, dev)
    rng = np.random.RandomState(0)
    bits = torch.from_numpy(
        rng.randint(0, 2, size=(N, NBITS)).astype(np.int32)).to(dev)
    return proving_step, (witness, points, bits)


def _bound_circuit(lower: int, upper: int, bits: int):
    """The bound-check circuit as ``parallel.batch``'s build_circuit."""
    from .core.prover import Prover
    from .core.scalar import Scalar
    from .gadgets.bound_check import bound_check_gadget
    from .gadgets.r1cs_utils import AllocatedQuantity

    def build(cs, w):
        if isinstance(cs, Prover):
            val = w
            a, b = val - lower, upper - val
            com_v, var_v = cs.commit(Scalar(val), Scalar.random())
            com_a, var_a = cs.commit(Scalar(a), Scalar.random())
            com_b, var_b = cs.commit(Scalar(b), Scalar.random())
            qs = [
                AllocatedQuantity(var_v, val),
                AllocatedQuantity(var_a, a),
                AllocatedQuantity(var_b, b),
            ]
            comms = [com_v, com_a, com_b]
        else:
            comms = w
            qs = [AllocatedQuantity(cs.commit(c)) for c in comms]
        bound_check_gadget(cs, *qs, upper, lower, bits)
        return comms

    return build


def _chain_circuit(length: int):
    """``length`` + 1 multipliers: a * b, then o <- (o + 1)(o + 2)."""
    from .core.prover import Prover
    from .core.scalar import Scalar

    def build(cs, w):
        if isinstance(cs, Prover):
            a, b = w
            com_a, va = cs.commit(Scalar(a), Scalar.random())
            com_b, vb = cs.commit(Scalar(b), Scalar.random())
            comms = [com_a, com_b]
        else:
            comms = w
            va = cs.commit(comms[0])
            vb = cs.commit(comms[1])
        _, _, o = cs.multiply(va, vb)
        for _ in range(length):
            _, _, o = cs.multiply(o + Scalar(1), o + Scalar(2))
        return comms

    return build


def dryrun_multichip(n_devices: int, devices=None) -> None:
    """Prove AND verify real R1CS proofs over n devices (see the module
    docstring); each phase prints one line."""
    from .core.pedersen import BulletproofGens, PedersenGens
    from .core.prover import Prover
    from .core.ristretto import multiscalar_mul
    from .core.scalar import Scalar
    from .core.transcript import Transcript
    from .core.verifier import Verifier
    from .gadgets.bound_check import (
        gen_proof_of_bounded_num,
        verify_proof_of_bounded_num,
    )
    from .ops import chunks as ck
    from .ops.backend import DeviceBackend
    from .ops.curve import points_from_device, points_to_device
    from .ops.msm import msm_chunk_impl, scalars_to_digits
    from .ops.native_backend import NativeBackend
    from .parallel.batch import prove_batch, prove_provers, verify_batch
    from .parallel.device_batch import prove_provers_devices
    from .parallel.mesh import make_mesh
    from .parallel.sharded_backend import (
        BatchShardedBackend,
        ShardedMsmBackend,
    )
    from .parallel.sharded_fast import ShardedWalkMsm, ShardedWalkVerifyBackend

    found = cuda_devices() if devices is None else [_device(d) for d in devices]
    if len(found) < n_devices:
        raise RuntimeError(
            f"dryrun_multichip({n_devices}) found only {len(found)} devices "
            f"({', '.join(str(d) for d in found)})"
        )
    if n_devices < 2:
        raise ValueError("dryrun_multichip needs two devices or more: "
                         "phase B splits its batch over two rows")
    devices = found[:n_devices]
    pc_gens = PedersenGens.default()
    bp_gens = BulletproofGens(256)

    # Phase A - the points axis: ONE proof (the 32-bit bound check, 64
    # multipliers) with every MSM of prover and verifier sharded over
    # all devices
    mesh = make_mesh(n_devices, batch_axis=1, devices=devices)
    backend = ShardedMsmBackend(mesh, min_device_n=64, chunk=256, window=2)
    t0 = time.time()
    proof, comms = gen_proof_of_bounded_num(
        42, None, 10, 100, 32, b"BoundsDryrun", pc_gens, bp_gens,
        backend=backend,
    )
    t1 = time.time()
    verify_proof_of_bounded_num(
        10, 100, 32, proof, comms, b"BoundsDryrun", pc_gens, bp_gens,
        backend=backend,
    )
    t2 = time.time()
    print(
        f"dryrun_multichip A OK: mesh {mesh.shape} — bound-check "
        f"proof ({len(proof.to_bytes())} B) proved in {t1-t0:.1f}s and "
        f"VERIFIED in {t2-t1:.1f}s with every MSM sharded over "
        f"{mesh.shape['points']} devices", flush=True
    )

    # Phase B - (batch, points): B same-shape proofs in lockstep, one
    # sync per IPP round for the batch, each proof's MSMs sharded over
    # its row's devices; verified on the host path
    bmesh = make_mesh(n_devices, batch_axis=max(2, n_devices // 2),
                      devices=devices)
    bbackend = BatchShardedBackend(bmesh, min_device_n=64, chunk=256,
                                   window=2)
    build = _bound_circuit(10, 100, 32)
    B = bmesh.shape["batch"]
    t0 = time.time()
    res = prove_batch(
        pc_gens, bp_gens, b"BatchDryrun",
        [20 + 7 * i for i in range(B)], build, backend=bbackend,
    )
    t1 = time.time()
    verify_batch(
        pc_gens, bp_gens, b"BatchDryrun", res, build, backend=None,
        combined=False,
    )
    t2 = time.time()
    print(
        f"dryrun_multichip B OK: mesh {bmesh.shape} — {B} proofs "
        f"proved in lockstep over the batch axis in {t1-t0:.1f}s and every "
        f"one VERIFIED on the host path in {t2-t1:.1f}s", flush=True
    )

    # Phase B2 - a heterogeneous batch (32- and 8-bit circuits) cannot
    # run in lockstep: the backend falls back to the per-job path (the
    # 8-bit circuits fall below min_device_n, onto the host)
    build8 = _bound_circuit(0, 200, 8)
    het_specs = [(build, 33), (build8, 150), (build8, 9)]
    provers, comms_het = [], []
    for bc, w in het_specs:
        p = Prover(pc_gens, Transcript(b"HetDryrun"))
        comms_het.append(bc(p, w))
        provers.append(p)
    t0 = time.time()
    het_proofs = prove_provers(provers, bp_gens, backend=bbackend)
    for (bc, _w), comms_i, proof in zip(het_specs, comms_het, het_proofs):
        v = Verifier(Transcript(b"HetDryrun"))
        bc(v, comms_i)
        v.verify(proof, pc_gens, bp_gens, backend=None)
    print(
        f"dryrun_multichip B2 OK: heterogeneous batch (32/8-bit circuits "
        f"mixed) fell back to per-job proving and all {len(het_specs)} "
        f"VERIFIED ({time.time()-t0:.1f}s)", flush=True
    )

    # Phase C - the batch axis as placement: whole proofs round-robin on
    # the devices, one backend each (host-threshold proof math), then a
    # 64-point windowed MSM (w = 2) on each placed backend's device, equal
    # to the host MSM and left on that device
    backends_seen = []

    def factory(device):
        be = DeviceBackend(device, min_device_n=1 << 30)
        backends_seen.append(be)
        return be

    provers_c, comms_c = [], []
    for i in range(n_devices):
        p = Prover(pc_gens, Transcript(b"PlacedDryrun"))
        comms_c.append(build(p, 15 + 3 * i))
        provers_c.append(p)
    t0 = time.time()
    placed_proofs = prove_provers_devices(
        provers_c, bp_gens, devices=devices, backend_factory=factory,
    )
    t1 = time.time()
    probe_pts = [pc_gens.B.scalar_mul(Scalar(3 * i + 2)) for i in range(64)]
    probe_sc = [Scalar(9973 * i + 7) for i in range(64)]
    exp_probe = multiscalar_mul(probe_sc, probe_pts).compress()
    digs = scalars_to_digits([s.v for s in probe_sc], 2)
    for be, dev in zip(backends_seen, devices):
        out = msm_chunk_impl(points_to_device(probe_pts, dev), digs, window=2)
        if be.device != dev or out.device != dev:
            raise RuntimeError(f"backend on {be.device}, probe on "
                               f"{out.device}, expected {dev}")
        if points_from_device(out)[0].compress() != exp_probe:
            raise RuntimeError(f"device {dev} MSM != host oracle")
    for comms_i, proof in zip(comms_c, placed_proofs):
        v = Verifier(Transcript(b"PlacedDryrun"))
        build(v, comms_i)
        v.verify(proof, pc_gens, bp_gens, backend=None)
    distinct = len({str(d) for d in devices})
    print(
        f"dryrun_multichip C OK: {n_devices} proofs round-robin placed over "
        f"{n_devices} devices ({distinct} distinct; per-device 64-point MSM "
        f"== host oracle, placement asserted) in {t1-t0:.1f}s; all "
        f"VERIFIED on host", flush=True
    )

    # Phase D - the fast path's sharded walk: a real proof (4,097
    # multipliers, padded 8,192 = 4 chunks) whose verifier G / H segments
    # are walked chunk-sharded over the points devices (msm_grid_local)
    bp_gens_d = BulletproofGens(8192)
    build_big = _chain_circuit(4096)
    t0 = time.time()
    p_d = Prover(pc_gens, Transcript(b"ShardWalkDryrun"))
    comms_d = build_big(p_d, (3, 5))
    proof_d = p_d.prove(bp_gens_d, backend=NativeBackend())
    t1 = time.time()
    n_pts = mesh.shape["points"]
    chunks = 8192 // ck.CHUNK
    walk = ShardedWalkMsm(mesh, axis="points",
                          local_chunks=-(-chunks // n_pts))
    v_d = Verifier(Transcript(b"ShardWalkDryrun"))
    build_big(v_d, comms_d)
    v_d.verify(proof_d, pc_gens, bp_gens_d,
               backend=ShardedWalkVerifyBackend(walk))
    t2 = time.time()
    print(
        f"dryrun_multichip D OK: verifier G/H segments ({chunks} valid "
        f"chunks, 8,192 padded) walked chunk-sharded over {n_pts} devices "
        f"(msm_grid_local + gather/fold) inside a VERIFIED proof "
        f"(prove {t1-t0:.1f}s, sharded verify {t2-t1:.1f}s)", flush=True
    )


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else len(cuda_devices())
    dryrun_multichip(n)
