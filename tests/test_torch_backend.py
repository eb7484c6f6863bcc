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
in.  The combined-route case lowers the combined layout's threshold
(``torch_backend.COMB_MIN_N``) as well, so that IPP rounds 2+ run the
half-width folds, the w4 tables and the paired walks (``fold_w3h``,
``table_w4``, ``msm_win_pair``, ``fold_w3h_comb``) before the tail.
Every device-path proof verifies through the port's verifier path, and a
tampered proof must raise ``VerificationError``.  The port's proofs are
made from the port's own objects (prover, transcript, generators); the
references from the JAX package's.  Tolerance: exact (bytes equal).
"""

import types

import numpy as np
import pytest
import torch

import bulletproofs_r1cs_gadgets_tpu as jaxpkg
import bulletproofs_r1cs_gadgets_tpu_torch as port
from bulletproofs_r1cs_gadgets_tpu.gadgets import bound_check as jbound
from bulletproofs_r1cs_gadgets_tpu.gadgets import r1cs_utils as jutils
from bulletproofs_r1cs_gadgets_tpu.ops import pallas_curve as pc
from bulletproofs_r1cs_gadgets_tpu.ops.pallas_backend import PallasBackend
from bulletproofs_r1cs_gadgets_tpu_torch import (
    BulletproofGens,
    PedersenGens,
    R1CSProof,
    Scalar,
    TorchBackend,
    VerificationError,
    multiscalar_mul,
    scvec,
)
from bulletproofs_r1cs_gadgets_tpu_torch.gadgets import bound_check as tbound
from bulletproofs_r1cs_gadgets_tpu_torch.gadgets import r1cs_utils as tutils
from bulletproofs_r1cs_gadgets_tpu_torch.ops import cuda_curve as cc
from bulletproofs_r1cs_gadgets_tpu_torch.ops import torch_backend as tb
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
def _pkg(mod, bound, utils):
    return types.SimpleNamespace(
        Prover=mod.Prover, Verifier=mod.Verifier, Transcript=mod.Transcript,
        Scalar=mod.Scalar, PedersenGens=mod.PedersenGens,
        BulletproofGens=mod.BulletproofGens,
        bound_check_gadget=bound.bound_check_gadget,
        AllocatedQuantity=utils.AllocatedQuantity,
    )


# the JAX package builds the references, the port its own proofs
PKGS = {
    "jax": _pkg(jaxpkg, jbound, jutils),
    "port": _pkg(port, tbound, tutils),
}


def _factor_chain(pkg, cs, v, v2, links=32):
    _, _, o = cs.multiply(v + v2, v - v2)
    for _ in range(links):
        _, _, o = cs.multiply(o + pkg.Scalar(1), o + pkg.Scalar(2))


class ChainCircuit:
    """links + 1 multipliers (33 padded to 64 by default): the factor
    breakpoint n1 lies inside the padded vector."""

    label = b"ffold"

    def __init__(self, links: int = 32, capacity: int = 64):
        self.links = links
        self.capacity = capacity

    def build(self, seed: int = 0, pkg: str = "port"):
        """(commitments, synthesized prover) with deterministic rng."""
        m = PKGS[pkg]
        prover = m.Prover(
            m.PedersenGens.default(), m.Transcript(self.label),
            rng=_DetRng(b"torch-rng%d" % seed if seed else b"torch-rng"),
        )
        com, v = prover.commit(m.Scalar(41 + seed), m.Scalar(97))
        com2, v2 = prover.commit(m.Scalar(5), m.Scalar(13))
        _factor_chain(m, prover, v, v2, self.links)
        assert prover.num_multipliers() == self.links + 1
        return (com, com2), prover

    def prove(self, backend, pkg: str = "port"):
        comms, prover = self.build(pkg=pkg)
        return comms, prover.prove(
            PKGS[pkg].BulletproofGens(self.capacity), backend=backend
        )

    def verifier(self, comms, pkg: str = "port"):
        """A verifier with the commitments bound and the circuit built."""
        m = PKGS[pkg]
        verifier = m.Verifier(m.Transcript(self.label))
        v, v2 = (verifier.commit(c) for c in comms)
        _factor_chain(m, verifier, v, v2, self.links)
        return verifier

    def verify(self, comms, proof, backend, pkg: str = "port"):
        m = PKGS[pkg]
        self.verifier(comms, pkg).verify(
            proof, m.PedersenGens.default(), m.BulletproofGens(self.capacity),
            backend=backend,
        )


class BoundCircuit:
    """tests/test_native_backend.py's bound check: 42 in [10, 100]."""

    label = b"TorchBounds"
    capacity = 256

    def build(self, seed: int = 0, pkg: str = "port"):
        m = PKGS[pkg]
        rng = np.random.RandomState(1234 + seed)
        prover = m.Prover(m.PedersenGens.default(), m.Transcript(self.label),
                          rng=rng)
        val, lower, upper = 42, 10, 100
        a, b = val - lower, upper - val
        qs, comms = [], []
        for x in (val, a, b):
            com, var = prover.commit(m.Scalar(x), m.Scalar.random(rng))
            comms.append(com)
            qs.append(m.AllocatedQuantity(var, x))
        m.bound_check_gadget(prover, *qs, upper, lower, 32)
        return tuple(comms), prover

    def prove(self, backend, pkg: str = "port"):
        comms, prover = self.build(pkg=pkg)
        return comms, prover.prove(
            PKGS[pkg].BulletproofGens(self.capacity), backend=backend
        )

    def verifier(self, comms, pkg: str = "port"):
        m = PKGS[pkg]
        verifier = m.Verifier(m.Transcript(self.label))
        qs = [m.AllocatedQuantity(verifier.commit(c)) for c in comms]
        m.bound_check_gadget(verifier, *qs, 100, 10, 32)
        return verifier

    def verify(self, comms, proof, backend, pkg: str = "port"):
        m = PKGS[pkg]
        self.verifier(comms, pkg).verify(
            proof, m.PedersenGens.default(), m.BulletproofGens(self.capacity),
            backend=backend,
        )


CIRCUITS = {
    "chain33": ChainCircuit(),
    "chain129": ChainCircuit(links=128, capacity=256),
    "bound": BoundCircuit(),
}
_REF: dict = {}


def _host_proof(name):
    """The JAX package's host-engine reference (backend=None), once per
    circuit."""
    if name not in _REF:
        _REF[name] = CIRCUITS[name].prove(None, pkg="jax")
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
    _, pallas = circ.prove(PallasBackend(), pkg="jax")
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
        circ.verify(wrong, R1CSProof.from_bytes(ref.to_bytes()), backend)


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


# The combined route at small sizes: COMB_MIN_N = 8 puts round 1's 32-128
# points per side past 2 * COMB_MIN_N, so 64 and 256 multipliers take the
# round-1 transition, the combined rounds while n >= 8, the chunk-list
# tail (fold_bits while n > 2) and the frozen rounds (side cap 4).
COMB_CHUNK = 8
COMB_KERNELS = ("fold_w3h", "table_w4", "msm_win_pair", "fold_w3h_comb")


def count_calls(monkeypatch, names) -> dict:
    """Count each named wrapper's calls (the plain route counts no
    launches)."""
    calls = dict.fromkeys(names, 0)
    for name in names:
        fn = getattr(cc, name)

        def wrap(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(cc, name, wrap)
    return calls


@pytest.mark.parametrize("name, combined_rounds", [
    ("bound", 2),     # 64 -> rounds at n = 16, 8
    ("chain129", 4),  # 256 -> rounds at n = 64, 32, 16, 8
])
def test_torch_backend_combined_route_matches_host(name, combined_rounds,
                                                   monkeypatch):
    circ = CIRCUITS[name]
    comms, ref = _host_proof(name)
    monkeypatch.setattr(tb, "COMB_MIN_N", COMB_CHUNK)
    calls = count_calls(
        monkeypatch, COMB_KERNELS + ("fold_bits", "msm_w4_pair", "msm_win5")
    )
    backend = TorchBackend("cpu", min_device_n=1, frozen_max_side=4,
                           walker_min_n=1)
    comms_t, got = circ.prove(backend)
    assert comms_t == comms
    assert got.to_bytes() == ref.to_bytes()
    assert calls == {
        "fold_w3h": 2, "table_w4": combined_rounds,
        "msm_win_pair": combined_rounds, "fold_w3h_comb": combined_rounds,
        "fold_bits": 2, "msm_w4_pair": 1, "msm_win5": 9,
    }
    circ.verify(comms, got, backend)
    raw = bytearray(got.to_bytes())
    raw[len(raw) - 64] ^= 1
    with pytest.raises(VerificationError):
        circ.verify(comms, R1CSProof.from_bytes(bytes(raw)), backend)
