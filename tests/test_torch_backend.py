"""Proofs through the port's ``TorchBackend`` (CPU tensors: the kernels'
plain versions) against the host engine and the JAX ``PallasBackend``.

With deterministic prover randomness the proof bytes must be identical
whichever backend computes the commitments and L/R points (the pattern of
tests/test_ipp_factor_fold.py and tests/test_native_backend.py).  The
backend's frozen-tail cap is lowered so that unfrozen rounds (one
``msm_w4`` launch per side and ``fold_bits`` folds), the freeze and the
frozen rounds (``msm_w4_pair``) all run at small sizes; ``min_device_n=1``
sends the phase-1 commitments through the device path too, and a lowered
``walker_min_n`` sends the shared-generator walks (phase 1, IPP round 1,
the verifier's G/H) through the w5 walker (``table_w5``, ``msm_win5``).  The
``PallasBackend`` runs with the JAX package's exact kernel mirrors patched
in.  Every device-path proof verifies through the port's verifier path,
and a tampered proof must raise ``VerificationError``.
Tolerance: exact (bytes equal).
"""

import numpy as np
import pytest
import torch

from bulletproofs_r1cs_gadgets_tpu import (
    BulletproofGens,
    PedersenGens,
    Prover,
    Scalar,
    Transcript,
    Verifier,
)
from bulletproofs_r1cs_gadgets_tpu.core import scvec
from bulletproofs_r1cs_gadgets_tpu.core.errors import VerificationError
from bulletproofs_r1cs_gadgets_tpu.core.proof import R1CSProof
from bulletproofs_r1cs_gadgets_tpu.core.ristretto import multiscalar_mul
from bulletproofs_r1cs_gadgets_tpu.gadgets.bound_check import (
    bound_check_gadget,
)
from bulletproofs_r1cs_gadgets_tpu.gadgets.r1cs_utils import AllocatedQuantity
from bulletproofs_r1cs_gadgets_tpu.ops import pallas_curve as pc
from bulletproofs_r1cs_gadgets_tpu.ops.pallas_backend import PallasBackend
from bulletproofs_r1cs_gadgets_tpu_torch import TorchBackend
from bulletproofs_r1cs_gadgets_tpu_torch.ops import cuda_curve as cc
from bulletproofs_r1cs_gadgets_tpu_torch.ops.torch_backend import WALKER_MIN_N
from test_ipp_factor_fold import (
    _DetRng,
    sim_fold_chunk,
    sim_msm_chunk_acc_w4,
    sim_msm_grid_pair,
)

# The plain versions run many small tensor ops: intra-op threads gain
# nothing there and contend with the other test workers' processes.
torch.set_num_threads(1)


# ------------------------------------------------------------ circuits
def _factor_chain(cs, v, v2, links=32):
    _, _, o = cs.multiply(v + v2, v - v2)
    for _ in range(links):
        _, _, o = cs.multiply(o + Scalar(1), o + Scalar(2))


class ChainCircuit:
    """links + 1 multipliers (33 padded to 64 by default): the factor
    breakpoint n1 lies inside the padded vector."""

    label = b"ffold"

    def __init__(self, links: int = 32, capacity: int = 64):
        self.links = links
        self.capacity = capacity

    def build(self, seed: int = 0):
        """(commitments, synthesized prover) with deterministic rng."""
        prover = Prover(
            PedersenGens.default(), Transcript(self.label),
            rng=_DetRng(b"torch-rng%d" % seed if seed else b"torch-rng"),
        )
        com, v = prover.commit(Scalar(41 + seed), Scalar(97))
        com2, v2 = prover.commit(Scalar(5), Scalar(13))
        _factor_chain(prover, v, v2, self.links)
        assert prover.num_multipliers() == self.links + 1
        return (com, com2), prover

    def prove(self, backend):
        comms, prover = self.build()
        return comms, prover.prove(
            BulletproofGens(self.capacity), backend=backend
        )

    def verifier(self, comms):
        """A verifier with the commitments bound and the circuit built."""
        verifier = Verifier(Transcript(self.label))
        v, v2 = (verifier.commit(c) for c in comms)
        _factor_chain(verifier, v, v2, self.links)
        return verifier

    def verify(self, comms, proof, backend):
        self.verifier(comms).verify(
            proof, PedersenGens.default(), BulletproofGens(self.capacity),
            backend=backend,
        )


class BoundCircuit:
    """tests/test_native_backend.py's bound check: 42 in [10, 100]."""

    label = b"TorchBounds"
    capacity = 256

    def build(self, seed: int = 0):
        rng = np.random.RandomState(1234 + seed)
        prover = Prover(PedersenGens.default(), Transcript(self.label),
                        rng=rng)
        val, lower, upper = 42, 10, 100
        a, b = val - lower, upper - val
        qs, comms = [], []
        for x in (val, a, b):
            com, var = prover.commit(Scalar(x), Scalar.random(rng))
            comms.append(com)
            qs.append(AllocatedQuantity(var, x))
        bound_check_gadget(prover, *qs, upper, lower, 32)
        return tuple(comms), prover

    def prove(self, backend):
        comms, prover = self.build()
        return comms, prover.prove(
            BulletproofGens(self.capacity), backend=backend
        )

    def verifier(self, comms):
        verifier = Verifier(Transcript(self.label))
        qs = [AllocatedQuantity(verifier.commit(c)) for c in comms]
        bound_check_gadget(verifier, *qs, 100, 10, 32)
        return verifier

    def verify(self, comms, proof, backend):
        self.verifier(comms).verify(
            proof, PedersenGens.default(), BulletproofGens(self.capacity),
            backend=backend,
        )


CIRCUITS = {
    "chain33": ChainCircuit(),
    "chain129": ChainCircuit(links=128, capacity=256),
    "bound": BoundCircuit(),
}
_REF: dict = {}


def _host_proof(name):
    """Host-engine reference (backend=None), once per circuit."""
    if name not in _REF:
        _REF[name] = CIRCUITS[name].prove(None)
    return _REF[name]


# frozen_max_side: 1024 freezes from round 1; 16 runs unfrozen rounds with
# folds, then freezes mid-proof; 0 never freezes.  The w5 cases lower the
# walker threshold: phase 1, the verifier's G/H and (unless frozen from
# round 1) IPP round 1 run msm_win5 over table_w5 tables.
@pytest.mark.parametrize("max_side, walker_min_n", [
    pytest.param(1024, WALKER_MIN_N, id="1024"),
    pytest.param(16, WALKER_MIN_N, id="16"),
    pytest.param(0, WALKER_MIN_N, id="0"),
    pytest.param(16, 1, id="w5-16"),
])
@pytest.mark.parametrize("name", ["chain33", "bound"])
def test_torch_backend_proof_bytes_match_host(name, max_side, walker_min_n,
                                              monkeypatch):
    circ = CIRCUITS[name]
    comms, ref = _host_proof(name)
    walks = []
    win5 = cc.msm_win5
    monkeypatch.setattr(
        cc, "msm_win5", lambda *a, **k: walks.append(a[3]) or win5(*a, **k)
    )
    backend = TorchBackend("cpu", min_device_n=1, frozen_max_side=max_side,
                           walker_min_n=walker_min_n)
    comms_t, got = circ.prove(backend)
    assert comms_t == comms
    assert got.to_bytes() == ref.to_bytes()
    circ.verify(comms, got, backend)
    # phase 1: 5 walks, IPP round 1: 4, the verifier's G and H: 2
    assert len(walks) == (11 if walker_min_n == 1 else 0)


@pytest.mark.parametrize("name", ["chain33", "bound"])
def test_torch_backend_matches_pallas_mirrors(name, monkeypatch):
    circ = CIRCUITS[name]
    comms, ref = _host_proof(name)
    monkeypatch.setattr(pc, "msm_chunk_acc_w4", sim_msm_chunk_acc_w4)
    monkeypatch.setattr(pc, "fold_chunk", sim_fold_chunk)
    monkeypatch.setattr(pc, "msm_grid_pair", sim_msm_grid_pair)
    _, pallas = circ.prove(PallasBackend())
    _, torch_proof = circ.prove(TorchBackend("cpu", frozen_max_side=16))
    assert pallas.to_bytes() == ref.to_bytes() == torch_proof.to_bytes()


@pytest.mark.parametrize("name", ["chain33", "bound"])
def test_torch_backend_rejects_tampered_proof(name):
    circ = CIRCUITS[name]
    comms, ref = _host_proof(name)
    raw = bytearray(ref.to_bytes())
    raw[len(raw) - 64] ^= 1  # low byte of the IPP's `a` scalar
    tampered = R1CSProof.from_bytes(bytes(raw))
    backend = TorchBackend("cpu", min_device_n=1)
    with pytest.raises(VerificationError):
        circ.verify(comms, tampered, backend)
    # a commitment that opens to another value is rejected too
    wrong = (PedersenGens.default().commit(Scalar(43), Scalar(97))
             .compress(),) + tuple(comms[1:])
    with pytest.raises(VerificationError):
        circ.verify(wrong, ref, backend)


def test_torch_backend_msm_matches_host():
    rng = np.random.RandomState(5)
    B = PedersenGens.default().B
    pts = [B.scalar_mul(Scalar(int(rng.randint(1, 1 << 30))))
           for _ in range(9)]
    rows = scvec.from_wide_bytes(rng.bytes(64 * 9))
    backend = TorchBackend("cpu", min_device_n=1)
    want = multiscalar_mul(scvec.to_scalars(rows), pts)
    assert backend.msm(rows, pts) == want
    assert backend.msm(scvec.to_scalars(rows), pts) == want
