"""The port's gadget zoo, MiMC and OSMT against the JAX package's, on the CPU.

The port keeps verbatim copies of the JAX package's gadgets
(``gadgets/``), trees (``models/``) and the rest of its jax-free host
layers.  Here:

* every gadget's wrapper (factors, bound check, range proof, not equals,
  set membership, set membership 1, set non-membership) and MiMC's
  circuit at 20 rounds (``tests/test_hashes.py``'s reduced size) run in
  each package on the same seeded ``secrets.token_bytes`` stream (the
  wrappers draw their blindings from ``Scalar.random()`` with no rng),
  on the host path: the proofs are byte-equal, each package's verifier
  accepts the other's proof parsed from bytes, and the port rejects a
  tampered copy, a non-member's membership proof and a member's
  non-membership proof;
* the OSMT gives the JAX package's roots, values and Merkle proofs, and
  its circuit gadget raises the same ``NotImplementedError``;
* ``chip_smoke.py`` phase 11's set-membership proof (32 elements)
  through ``TorchBackend("cpu", min_device_n=1)`` is byte-equal to the
  host path;
* the compiled Poseidon 2:1 circuit's witness equals the gadget's for
  both S-boxes (the repair of the cube S-box's squares);
* every copied host file equals its original, once the reference's
  absolute checkout path is made relative, apart from a named list of
  deliberate differences.

Tolerance: exact (equal bytes, roots and files).
"""

import importlib
import pathlib
import random
import re
import secrets
import textwrap

import numpy as np
import pytest

import bulletproofs_r1cs_gadgets_tpu_torch as port
import chip_smoke as cs

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX_PKG = "bulletproofs_r1cs_gadgets_tpu"
PORT_PKG = "bulletproofs_r1cs_gadgets_tpu_torch"
SET = [2, 3, 5, 6, 8, 20, 25]  # the reference's test set


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


class Pkg:
    """One package's names, for circuits written once for both."""

    def __init__(self, pkg: str):
        self.name = pkg
        top = importlib.import_module(pkg)
        for n in ("Scalar", "Prover", "Verifier", "Transcript",
                  "PedersenGens", "BulletproofGens", "R1CSProof"):
            setattr(self, n, getattr(top, n))
        self.VerificationError = _mod(pkg, "core.errors").VerificationError
        self.g = lambda name: _mod(pkg, f"gadgets.{name}")
        self.pc = self.PedersenGens.default()
        self.bp = self.BulletproofGens(128)


@pytest.fixture(scope="module")
def pkgs():
    return {"jax": Pkg(JAX_PKG), "port": Pkg(PORT_PKG)}


@pytest.fixture
def seed_secrets(monkeypatch):
    """reset(seed): from here on ``secrets.token_bytes`` is a seeded
    stream (both packages' ``Scalar.random()`` and default prover rng
    read it)."""

    def reset(seed: int):
        rng = np.random.RandomState(seed)
        monkeypatch.setattr(secrets, "token_bytes", lambda n: rng.bytes(n))

    return reset


# Each case: prove(P) -> (proof, public), check(P, proof, public) raises
# P.VerificationError unless the proof verifies.  `public` holds the
# commitments and whatever else the verifier needs.
def _factors_prove(P, p=17, q=19):
    m = P.g("factors")
    proof, comms, r = m.gen_proof_of_factors(
        P.Scalar(p), P.Scalar(q), b"Factors", P.pc, P.bp)
    return proof, (comms, r.v)


def _factors_check(P, proof, public):
    comms, r = public
    P.g("factors").verify_proof_of_factors(
        P.Scalar(r), proof, comms, b"Factors", P.pc, P.bp)


def _bound_prove(P, v=57):
    m = P.g("bound_check")
    bits = m.count_bits(100)
    proof, comms = m.gen_proof_of_bounded_num(
        v, P.Scalar.random(), 10, 100, bits, b"BoundsTest", P.pc, P.bp)
    return proof, comms


def _bound_check(P, proof, comms):
    m = P.g("bound_check")
    m.verify_proof_of_bounded_num(10, 100, m.count_bits(100), proof, comms,
                                  b"BoundsTest", P.pc, P.bp)


def _range_prove(P, v=57):
    proof, comms = P.g("range_proof").gen_range_proof(
        v, 10, 100, b"BoundsTest", P.pc, P.bp)
    return proof, comms


def _range_check(P, proof, comms):
    P.g("range_proof").verify_range_proof(10, 100, proof, comms,
                                          b"BoundsTest", P.pc, P.bp)


def _not_equals_prove(P, v=10):
    proof, comms = P.g("not_equals").gen_proof_of_not_equals(
        v, 5, b"NotEqualsTest", P.pc, P.bp)
    return proof, comms


def _not_equals_check(P, proof, comms):
    P.g("not_equals").verify_proof_of_not_equals(
        5, proof, comms, b"NotEqualsTest", P.pc, P.bp)


def _member_prove(P, v=3):
    proof, comms = P.g("set_membership").gen_proof_of_set_membership(
        v, P.Scalar.random(), SET, b"SetMemebershipTest", P.pc, P.bp)
    return proof, comms


def _member_check(P, proof, comms):
    P.g("set_membership").verify_proof_of_set_membership(
        SET, proof, comms, b"SetMemebershipTest", P.pc, P.bp)


def _member1_prove(P, v=20):
    proof, comms = P.g("set_membership_1").gen_proof_of_set_membership_1(
        v, P.Scalar.random(), SET, b"SetMemebership1Test", P.pc, P.bp)
    return proof, comms


def _member1_check(P, proof, comms):
    P.g("set_membership_1").verify_proof_of_set_membership_1(
        SET, proof, comms, b"SetMemebership1Test", P.pc, P.bp)


def _non_member_prove(P, v=10):
    m = P.g("set_non_membership")
    proof, comms = m.gen_proof_of_set_non_membership(
        v, P.Scalar.random(), SET, b"SetNonMemebershipTest", P.pc, P.bp)
    return proof, comms


def _non_member_check(P, proof, comms):
    P.g("set_non_membership").verify_proof_of_set_non_membership(
        SET, proof, comms, b"SetNonMemebershipTest", P.pc, P.bp)


MIMC_ROUNDS = 20  # tests/test_hashes.py::test_mimc_gadget_reduced


def _mimc_constants(P):
    rnd = random.Random(24)
    return [P.Scalar(rnd.randrange(port.L)) for _ in range(MIMC_ROUNDS)]


def _mimc_prove(P):
    m = P.g("mimc")
    xl, xr = P.Scalar.random(), P.Scalar.random()
    prover = P.Prover(P.pc, P.Transcript(b"MiMC"))
    com_l, var_l = prover.commit(xl, P.Scalar.random())
    com_r, var_r = prover.commit(xr, P.Scalar.random())
    lc = m.mimc_hash_2(prover, var_l.lc(), var_r.lc(), MIMC_ROUNDS,
                       _mimc_constants(P))
    image = prover.evaluate_lc(lc)
    prover.constrain(lc - image)
    return prover.prove(P.bp), ([com_l, com_r], image.v)


def _mimc_check(P, proof, public):
    (com_l, com_r), image = public
    m = P.g("mimc")
    verifier = P.Verifier(P.Transcript(b"MiMC"))
    vl, vr = verifier.commit(com_l), verifier.commit(com_r)
    lc = m.mimc_hash_2(verifier, vl.lc(), vr.lc(), MIMC_ROUNDS,
                       _mimc_constants(P))
    verifier.constrain(lc - P.Scalar(image))
    verifier.verify(proof, P.pc, P.bp)


CASES = {
    "factors": (_factors_prove, _factors_check),
    "bound_check": (_bound_prove, _bound_check),
    "range_proof": (_range_prove, _range_check),
    "not_equals": (_not_equals_prove, _not_equals_check),
    "set_membership": (_member_prove, _member_check),
    "set_membership_1": (_member1_prove, _member1_check),
    "set_non_membership": (_non_member_prove, _non_member_check),
    "mimc": (_mimc_prove, _mimc_check),
}


def _tampered(P, raw: bytes):
    bad = bytearray(raw)
    bad[len(bad) - 64] ^= 1
    return P.R1CSProof.from_bytes(bytes(bad))


@pytest.mark.parametrize("case", list(CASES))
def test_gadget_proofs_byte_equal_and_cross_verify(case, pkgs, seed_secrets):
    prove, check = CASES[case]
    made = {}
    for name, P in pkgs.items():
        seed_secrets(1234)
        proof, public = prove(P)
        made[name] = (proof.to_bytes(), public)
    (jraw, jpub), (traw, tpub) = made["jax"], made["port"]
    assert traw == jraw
    assert tpub == jpub
    for checker, raw in (("jax", traw), ("port", jraw)):
        P = pkgs[checker]
        check(P, P.R1CSProof.from_bytes(raw), tpub)
    P = pkgs["port"]
    with pytest.raises(P.VerificationError):
        check(P, _tampered(P, traw), tpub)


@pytest.mark.parametrize("case,value", [
    ("set_membership", 4),  # not in the set: the bitmap sums to 0
    ("set_membership_1", 4),  # no zero difference: the product is not 0
    ("set_non_membership", 20),  # in the set: 0 has no inverse
])
def test_port_rejects_unprovable_set_statements(case, value, pkgs):
    prove, check = CASES[case]
    P = pkgs["port"]
    proof, comms = prove(P, value)
    with pytest.raises(P.VerificationError):
        check(P, P.R1CSProof.from_bytes(proof.to_bytes()), comms)


def test_osmt_matches_jax_package():
    """tests/test_trees.py's OSMT updates at depth 16 with its reduced
    Poseidon: equal roots after every update, equal values and proofs."""
    trees = []
    for pkg in (JAX_PKG, PORT_PKG):
        top = importlib.import_module(pkg)
        osmt = _mod(pkg, "models.osmt")
        params = _mod(pkg, "gadgets.poseidon").PoseidonParams(6, 4, 4, 6)
        trees.append((top, osmt, osmt.OptimizedSparseMerkleTree(params, 16)))
    rnd = random.Random(24)
    kvs = [(i, i) for i in range(1, 10)]
    kvs += [(rnd.randrange(1 << 16), rnd.randrange(port.L)) for _ in range(12)]
    for k, v in kvs:
        roots = [t.update(top.Scalar(k), top.Scalar(v)).v
                 for top, _, t in trees]
        assert roots[0] == roots[1]
    for k, v in kvs[:12] + [(5000, 0)]:
        got = []
        for top, osmt, t in trees:
            proof = []
            val = t.get(top.Scalar(k), proof)
            assert t.verify_proof(top.Scalar(k), val, proof, t.root)
            got.append((val.v, [(n.is_leaf, n.a.v, n.b.v) for n in proof]))
        assert got[0] == got[1]
    errs = []
    for _, osmt, _ in trees:
        with pytest.raises(NotImplementedError) as e:
            osmt.optimized_sparse_merkle_tree_verif_gadget()
        errs.append(str(e.value))
    assert errs[0] == errs[1]


def test_set_membership_through_torch_backend_matches_host():
    """``chip_smoke.py`` phase 11's set-membership circuit (32 elements,
    the wrapper's gadget calls on a seeded prover and blindings) through
    TorchBackend("cpu", min_device_n=1): bytes equal to the host path,
    verified by the backend, a tampered copy rejected."""
    name = "set_membership_32"
    index = list(cs.ZOO).index(name)
    gens = port.BulletproofGens(128)
    comms, prover = cs.zoo_prover(port, index, name)
    host = prover.prove(gens, backend=None)
    backend = port.TorchBackend("cpu", min_device_n=1)
    comms_dev, prover = cs.zoo_prover(port, index, name)
    dev = prover.prove(gens, backend=backend)
    assert comms_dev == comms
    assert dev.to_bytes() == host.to_bytes()
    cs.zoo_verify(port, name, comms, dev, gens, backend)
    with pytest.raises(port.VerificationError):
        cs.zoo_verify(port, name, comms, cs.tampered(port, dev), gens, backend)


@pytest.mark.parametrize("sbox", ["Cube", "Inverse"])
def test_compiled_poseidon2_witness_matches_the_gadget(sbox):
    """The compiled Poseidon 2:1 preimage circuit's witness equals the
    gadget's (``Poseidon_hash_2_gadget`` on a prover) for both S-boxes,
    and its proof verifies.  The cube S-box's squares were read from a
    strided view by ``scvec.mul`` (which reads its arrays contiguously):
    every square but the first was wrong, and the proof failed; the JAX
    package's copy still does (``models/compiled.py``, left as it is)."""
    from bulletproofs_r1cs_gadgets_tpu_torch.gadgets import poseidon as P
    from bulletproofs_r1cs_gadgets_tpu_torch.gadgets.r1cs_utils import (
        AllocatedScalar,
    )
    from bulletproofs_r1cs_gadgets_tpu_torch.models.compiled import (
        CompiledPoseidon2,
    )

    params, kind = P.PoseidonParams(6, 4, 4, 6), getattr(P.SboxType, sbox)
    pc, gens = port.PedersenGens.default(), port.BulletproofGens(256)
    xl, xr = port.Scalar(31), port.Scalar(59)
    image = P.Poseidon_hash_2(xl, xr, params, kind)
    rec = port.Prover(pc, port.Transcript(b"P"))
    _, vl = rec.commit(xl, port.Scalar(1))
    _, vr = rec.commit(xr, port.Scalar(2))
    statics = P.allocate_statics_for_prover(rec, 4)
    P.Poseidon_hash_2_gadget(rec, AllocatedScalar(vl, xl),
                             AllocatedScalar(vr, xr), statics, params, kind,
                             image)
    comp = CompiledPoseidon2(params, kind)
    aL, aR, aO = comp.witness(xl, xr)
    for got, want in ((aL, rec.a_L), (aR, rec.a_R), (aO, rec.a_O)):
        assert [s.v for s in port.scvec.to_scalars(got)] == [s.v for s in want]
    prover = port.Prover(pc, port.Transcript(b"P"),
                         rng=np.random.RandomState(3))
    cl, _ = prover.commit(xl, port.Scalar(1))
    cr, _ = prover.commit(xr, port.Scalar(2))
    P.allocate_statics_for_prover(prover, 4)
    prover.load_compiled(comp.tape(image), aL, aR, aO)
    proof = prover.prove(gens)
    verifier = port.Verifier(port.Transcript(b"P"))
    verifier.commit(cl)
    verifier.commit(cr)
    P.allocate_statics_for_verifier(verifier, 4, pc)
    verifier.load_compiled(comp.tape(image), comp.num_multipliers)
    verifier.verify(proof, pc, gens)


# ------------------------------------------------------- verbatim copies
_BUILD_CMD = ("bulletproofs_r1cs_gadgets_tpu.native.build",
              "bulletproofs_r1cs_gadgets_tpu_torch.native.build")
# deliberate differences: the repair of the cube S-box witness ...
_CUBE_FIX = ("        flat_u = u.reshape(-1, 4)\n",
             "        flat_u = np.ascontiguousarray(u.reshape(-1, 4))\n")
# ... the build command names the port's module ...
RENAMED = ("native/__init__.py", "native/bptpu_native.cpp", "native/build.py")
# ... the engine's spans (the port's span recorder, utils/metrics.py): the
# prover's and the verifier's top spans and their phases, each mark
# closing the phase before it, in place of the JAX package's process-wide
# timers ...
_IMPORT_METRICS = ("from ..utils.stats import CircuitStats\n",
                   "from ..utils import metrics\n"
                   "from ..utils.stats import CircuitStats\n")
# ... the verifier's G/H rows built on the backend's device when it offers
# them (``ops/verify_rows.py``): the job takes the backend's
# ``verify_rows``, and its host-only work, from the IPP's s vector to h,
# runs under ``if dev is None:`` beside the device branch, with a, b, r
# and x^2 drawn before the branch ...
_DEVICE_BRANCH = (
    "        else:\n"
    "            # the host replays only the IPP's challenges, and fetches\n"
    "            # wV, wc and delta\n"
    "            u_sq, u_inv_sq = dev.challenges(proof.ipp_proof, padded_n,"
    " t, x, u)\n"
    "            wV, wc, delta = dev.sums()\n"
    "            g_scalars = h_scalars = None\n\n")


def _host_rows_branch(jax: str) -> tuple[str, str]:
    """(the JAX verifier's G/H work, the port's two branches of it)."""
    start = jax.index("        u_sq, u_inv_sq, s_arr = ")
    block = jax[start : jax.index("        B_scalar = w * (", start)]
    ab, r, xx = ("        a = proof.ipp_proof.a\n"
                 "        b = proof.ipp_proof.b\n",
                 "        # random combining factor for the two checks\n"
                 "        r = Scalar.from_bytes_mod_order_wide("
                 "secrets.token_bytes(64))\n\n",
                 "        xx = x * x\n")
    host = block
    for text in (ab, r, xx):
        assert host.count(text) == 1, text
        host = host.replace(text, "")
    return block, (ab + "\n" + r + xx + "        if dev is None:\n"
                   + textwrap.indent(host.rstrip("\n") + "\n", "    ")
                   + _DEVICE_BRANCH)


_DEVICE_ROWS = (
    ("        job = self._verification_job(proof, pc_gens, bp_gens)\n"
     "        scalars_arr = np.concatenate(\n"
     "            [\n"
     "                job.head_sc,\n"
     "                job.B_scalar_row[None, :],\n"
     "                job.B_blinding_row[None, :],\n"
     "                job.g, job.h, job.tail_sc,\n"
     "            ]\n"
     "        )\n",
     "        job = self._verification_job(\n"
     "            proof, pc_gens, bp_gens, getattr(backend, \"verify_rows\", None)\n"
     "        )\n"
     "        if job.rows is not None:\n"
     "            # the backend's device builds g and h (ops/verify_rows.py)\n"
     "            scalars_arr = job.rows.with_scalars(job)\n"
     "        else:\n"
     "            scalars_arr = np.concatenate(\n"
     "                [\n"
     "                    job.head_sc,\n"
     "                    job.B_scalar_row[None, :],\n"
     "                    job.B_blinding_row[None, :],\n"
     "                    job.g, job.h, job.tail_sc,\n"
     "                ]\n"
     "            )\n"),
    ("        bp_gens: BulletproofGens,\n    ) -> \"VerificationJob\":\n",
     "        bp_gens: BulletproofGens,\n        rows=None,\n"
     "    ) -> \"VerificationJob\":\n"),
    ("        (the shared G/H generator segments collapse across the batch).\n",
     "        (the shared G/H generator segments collapse across the batch).\n"
     "        With `rows` (a backend's ``verify_rows``) that builds this size's\n"
     "        G/H rows on its device, the job's ``g`` and ``h`` are None and its\n"
     "        ``rows`` builds them: the host replays only the IPP's challenges.\n"),
    ("        wL, wR, wO, wV, wc = tape.flatten(z, n, len(self.V), want_wc=True)\n",
     "        dev = None if rows is None else rows(\n"
     "            tape, n1, n, len(self.V), padded_n\n"
     "        )\n"
     "        if dev is None:\n"
     "            wL, wR, wO, wV, wc = tape.flatten(z, n, len(self.V), want_wc=True)\n"
     "        else:\n"
     "            dev.flatten(z, y.invert())\n"),
    _host_rows_branch((ROOT / JAX_PKG / "core" / "verifier.py").read_text()),
    ("            padded_n=padded_n,\n        )\n\n\nfrom dataclasses",
     "            padded_n=padded_n,\n            rows=dev,\n        )\n\n\n"
     "from dataclasses"),
    ("    tail_points: list\n    padded_n: int\n",
     "    tail_points: list\n    padded_n: int\n"
     "    rows: object = None          # the device's G/H rows (g, h None)\n"),
)
# the batch verifier's device rows: each job's rows built on the card, and
# the rho-weighted sum of the jobs that have them formed there, the other
# jobs' on the host, each part its own MSM (ops/verify_rows.py)
_BATCH_COMBINE = """\
    rhos = [Scalar.one()] + [
        Scalar.from_bytes_mod_order_wide(secrets.token_bytes(64))
        for _ in jobs[1:]
    ]
    B_row = scvec.scale(jobs[0].B_scalar_row[None, :], rhos[0])
    Bb_row = scvec.scale(jobs[0].B_blinding_row[None, :], rhos[0])
    for j, r in zip(jobs[1:], rhos[1:]):
        B_row = scvec.add(B_row, scvec.scale(j.B_scalar_row[None, :], r))
        Bb_row = scvec.add(
            Bb_row, scvec.scale(j.B_blinding_row[None, :], r)
        )

    def _pad(arr: np.ndarray, max_pad: int) -> np.ndarray:
        if arr.shape[0] == max_pad:
            return arr
        return np.concatenate([arr, scvec.zeros(max_pad - arr.shape[0])])

    # The jobs whose G/H rows the backend's device built sum them there
    # (ops/verify_rows.py), the others on the host: each part is one MSM
    # over the shared generators, and the batch's MSM is their sum.
    msms = []
    for part in (
        [(j, r) for j, r in zip(jobs, rhos) if j.rows is None],
        [(j, r) for j, r in zip(jobs, rhos) if j.rows is not None],
    ):
        if not part:
            continue
        max_pad = max(j.padded_n for j, _ in part)
        head_sc = np.concatenate([scvec.scale(j.head_sc, r) for j, r in part])
        head_points = [p for j, _ in part for p in j.head_points]
        tail_sc = np.concatenate([scvec.scale(j.tail_sc, r) for j, r in part])
        tail_points = [p for j, _ in part for p in j.tail_points]
        if not msms:
            # the shared basepoints, once
            head_sc = np.concatenate([head_sc, B_row, Bb_row])
            head_points = head_points + [pc_gens.B, pc_gens.B_blinding]
        if part[0][0].rows is not None:
            scalars_arr = part[0][0].rows.summed(
                [j.rows for j, _ in part], [r for _, r in part],
                head_sc, tail_sc,
            )
        else:
            g = scvec.scale(_pad(part[0][0].g, max_pad), part[0][1])
            h = scvec.scale(_pad(part[0][0].h, max_pad), part[0][1])
            for j, r in part[1:]:
                g = scvec.add(g, scvec.scale(_pad(j.g, max_pad), r))
                h = scvec.add(h, scvec.scale(_pad(j.h, max_pad), r))
            scalars_arr = np.concatenate([head_sc, g, h, tail_sc])
        msms.append((scalars_arr, head_points, max_pad, tail_points))
    metrics.mark(None)
    mega = RistrettoPoint.identity()
    for scalars_arr, points, max_pad, tail_points in msms:
        mega = mega + _run_msm(
            backend, scalars_arr, points, bp_gens.share(0), max_pad,
            tail_points,
        )
"""


def _batch_combine(jax: str) -> tuple[str, str]:
    """(the JAX batch verifier's combine as the trace lines leave it, the
    port's)."""
    start = jax.index("    max_pad = max(j.padded_n for j in jobs)\n")
    block = jax[start : jax.index("    if mega.is_identity():\n", start)]
    mark = "    mega = _run_msm("
    assert block.count(mark) == 1
    return block.replace(mark, "    metrics.mark(None)\n" + mark), _BATCH_COMBINE


_BATCH_ROWS = (
    ("    metrics.mark(\"batch_verify.jobs\")\n",
     "    metrics.mark(\"batch_verify.jobs\")\n"
     "    rows = getattr(backend, \"verify_rows\", None)\n"),
    ("                lambda vp: vp[0]._verification_job(vp[1], pc_gens,"
     " bp_gens),\n",
     "                lambda vp: vp[0]._verification_job(\n"
     "                    vp[1], pc_gens, bp_gens, rows\n"
     "                ),\n"),
    _batch_combine((ROOT / JAX_PKG / "core" / "verifier.py").read_text()),
    ("            backend,\n            np.concatenate(\n",
     "            backend,\n"
     "            j.rows.with_scalars(j) if j.rows is not None else"
     " np.concatenate(\n"),
)
TRACED = {
    "core/prover.py": (
        _IMPORT_METRICS,
        ("    def prove(self, bp_gens: BulletproofGens, backend=None)"
         " -> R1CSProof:\n"
         "        import time as _time\n\n"
         "        from ..utils.metrics import METRICS\n\n"
         "        _last = [_time.time()]\n\n"
         "        def _mark(name):\n"
         "            now = _time.time()\n"
         "            METRICS.add_time(f\"prove.{name}\", now - _last[0])\n"
         "            _last[0] = now\n",
         "    @metrics.traced(\"prove\")\n"
         "    def prove(self, bp_gens: BulletproofGens, backend=None)"
         " -> R1CSProof:\n"
         "        _mark = metrics.mark\n"
         "        _mark(\"prove.state\")\n"),
        ("        gens = st[\"gens\"]\n        if backend is not None:\n",
         "        gens = st[\"gens\"]\n        _mark(None)\n"
         "        if backend is not None:\n"),
        ("        _mark(\"phase1_commitments\")\n",
         "        _mark(\"prove.phase2\")\n"),
        ("        _mark(\"phase2\")\n", "        _mark(\"prove.flatten\")\n"),
        ("        _mark(\"flatten\")\n", "        _mark(\"prove.polys\")\n"),
        ("        _mark(\"polys\")\n", "        _mark(\"prove.ipp_inputs\")\n"),
        ("        t.innerproduct_domain_sep(mid[\"padded_n\"])\n",
         "        t.innerproduct_domain_sep(mid[\"padded_n\"])\n"
         "        _mark(None)\n"),
        ("\n        _mark(\"ipp\")\n"
         "        METRICS.add_count(\"prove.proofs\")\n"
         "        METRICS.dump_group(\"prove\")\n", "\n"),
    ),
    "core/verifier.py": (
        _IMPORT_METRICS,
        ("    def verify(\n        self,\n",
         "    @metrics.traced(\"verify\")\n    def verify(\n        self,\n"),
        ("        job = self._verification_job(proof, pc_gens, bp_gens)\n",
         "        metrics.mark(\"verify.scalars\")\n"
         "        job = self._verification_job(proof, pc_gens, bp_gens)\n"),
        ("        head_points = job.head_points"
         " + [pc_gens.B, pc_gens.B_blinding]\n",
         "        head_points = job.head_points"
         " + [pc_gens.B, pc_gens.B_blinding]\n"
         "        metrics.mark(None)\n"),
    ) + _DEVICE_ROWS + (
        # the batch verifier's top span and its phases
        ("def batch_verify(\n    verifiers: list,",
         "@metrics.traced(\"batch_verify\")\n"
         "def batch_verify(\n    verifiers: list,"),
        ("    if not proofs:\n        return\n",
         "    if not proofs:\n        return\n"
         "    metrics.count(\"proofs\", len(proofs))\n"),
        ("    _workers = max(1, min(",
         "    metrics.mark(\"batch_verify.jobs\")\n    _workers = max(1, min("),
        ("    max_pad = max(j.padded_n for j in jobs)\n",
         "    metrics.mark(\"batch_verify.combine\")\n"
         "    max_pad = max(j.padded_n for j in jobs)\n"),
        ("    points = head_points + [pc_gens.B, pc_gens.B_blinding]\n"
         "    mega = _run_msm(",
         "    points = head_points + [pc_gens.B, pc_gens.B_blinding]\n"
         "    metrics.mark(None)\n    mega = _run_msm("),
        ("    bad = []\n",
         "    metrics.mark(\"batch_verify.recheck\")\n    bad = []\n"),
        ("            bad.append(i)\n",
         "            bad.append(i)\n    metrics.count(\"bad\", len(bad))\n"),
    ) + _BATCH_ROWS,
    # the batch's top span ``prove_batch`` over the staged path (moved into
    # ``_prove_staged``), its phases and the pool's per-prover phases
    "parallel/batch.py": (
        ("from ..core.proof import R1CSProof\n",
         "from ..core.proof import R1CSProof\nfrom ..utils import metrics\n"),
        ("    # Host stages run on a thread pool:",
         "    return _prove_staged(provers, bp_gens, backend, host_workers)\n"
         "\n\n"
         "def _middle(parent, prover, st, triple, bp_gens):\n"
         "    \"\"\"One prover's host stages 2-5 on a pool thread, its phases (as\n"
         "    ``Prover.prove`` marks them) children of the batch's `parent`.\"\"\"\n"
         "    with metrics.adopt(parent):\n"
         "        metrics.mark(\"prove.phase2\")\n"
         "        return prover._prove_middle(st, *triple, bp_gens, metrics.mark)\n"
         "\n\n"
         "@metrics.traced(\"prove_batch\")\n"
         "def _prove_staged(provers, bp_gens, backend, host_workers):\n"
         "    \"\"\"One staged batch: a span ``prove_batch`` (count ``proofs``) with\n"
         "    children ``batch.state`` (the phase-1 states), the seam's\n"
         "    ``phase_commitments``, ``batch.middle`` (every prover's stages 2-5,\n"
         "    their phases recorded on the pool's threads) and ``ipp_create``.\"\"\"\n"
         "    metrics.count(\"proofs\", len(provers))\n"
         "    # Host stages run on a thread pool:"),
        ("        sts = list(pool.map(lambda p: p._phase1_state(bp_gens), provers))\n",
         "        metrics.mark(\"batch.state\")\n"
         "        sts = list(pool.map(lambda p: p._phase1_state(bp_gens), provers))\n"
         "        metrics.mark(None)\n"),
        ("        mids = list(\n",
         "        middle = metrics.begin(\"batch.middle\")\n        mids = list(\n"),
        ("                lambda a: a[0]._prove_middle(a[1], *a[2], bp_gens),\n",
         "                lambda a: _middle(middle, *a, bp_gens),\n"),
        ("                zip(provers, sts, triples),\n            )\n        )\n",
         "                zip(provers, sts, triples),\n            )\n        )\n"
         "        metrics.end(middle)\n"),
    ),
}
# ... and these two are the port's own (the loader builds into the port's
# build directory under a lock; the metrics are the port's span recorder)
OWN = ("native/loader.py", "utils/metrics.py")
COPIED_DIRS = ("core", "gadgets", "models", "utils", "native")


def _copied_files() -> list[str]:
    out = []
    for d in COPIED_DIRS:
        for p in sorted((ROOT / PORT_PKG / d).iterdir()):
            rel = f"{d}/{p.name}"
            if p.is_file() and p.suffix in (".py", ".json", ".cpp") \
                    and rel not in OWN:
                out.append(rel)
    return out + ["parallel/batch.py"]


def _relative_reference(text: str) -> str:
    """The JAX package cites the reference sources by an absolute checkout
    path; the copies cite them relative (``reference/src/...``)."""
    return re.sub(r"(?<![\w.])/(?:[\w.-]+/)+?(?=reference/src/)", "", text)


def test_every_port_host_file_is_compared_or_named():
    for d in COPIED_DIRS:
        for p in (ROOT / PORT_PKG / d).iterdir():
            if p.is_file() and p.suffix in (".py", ".json", ".cpp"):
                rel = f"{d}/{p.name}"
                assert rel in _copied_files() or rel in OWN, rel
                assert (ROOT / JAX_PKG / rel).exists(), rel


@pytest.mark.parametrize("rel", _copied_files())
def test_host_copies_are_verbatim(rel):
    want = _relative_reference((ROOT / JAX_PKG / rel).read_text())
    if rel in RENAMED:
        assert _BUILD_CMD[0] in want
        want = want.replace(*_BUILD_CMD)
    if rel == "models/compiled.py":
        assert want.count(_CUBE_FIX[0]) == 1
        want = want.replace(*_CUBE_FIX)
    for jax_text, port_text in TRACED.get(rel, ()):
        assert want.count(jax_text) == 1, jax_text
        want = want.replace(jax_text, port_text)
    assert (ROOT / PORT_PKG / rel).read_text() == want
