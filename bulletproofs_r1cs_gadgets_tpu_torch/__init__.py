"""bulletproofs_r1cs_gadgets_tpu_torch: the PyTorch + CUDA port of the
device layer of ``bulletproofs_r1cs_gadgets_tpu``.

The engine (``core/``), the gadgets, the trees and templates (``models/``)
and the C++ host library (``native/``) are the JAX package's, imported as
they are (none of them imports JAX).  This package replaces what sits
behind the engine's backend seam:

  ops/field.py          point layout, codecs, plain torch field ops
  ops/curve.py          plain torch point ops
  ops/chunks.py         host word encoders and flat point packing
  ops/cuda_curve.py     kernel wrappers + plain versions + launch counts
  ops/build.py          nvcc build of csrc/*.cu, ctypes binding
  ops/torch_backend.py  TorchBackend (the seam: msm, msm_gens,
                        phase_commitments, ipp_create and their batches)
  csrc/                 the Hopper kernels (sm_90a)

Batched proving and verification are the engine's own
``prove_provers(provers, gens, backend=TorchBackend("cuda"))`` and
``batch_verify(verifiers, proofs, pc_gens, gens, backend=...)``,
re-exported here.  It imports ``torch`` and never ``jax``.
"""

from bulletproofs_r1cs_gadgets_tpu.core import scvec
from bulletproofs_r1cs_gadgets_tpu.core.errors import VerificationError
from bulletproofs_r1cs_gadgets_tpu.core.pedersen import (
    BulletproofGens,
    PedersenGens,
)
from bulletproofs_r1cs_gadgets_tpu.core.proof import R1CSProof
from bulletproofs_r1cs_gadgets_tpu.core.prover import Prover
from bulletproofs_r1cs_gadgets_tpu.core.ristretto import (
    RistrettoPoint,
    multiscalar_mul,
)
from bulletproofs_r1cs_gadgets_tpu.core.scalar import Scalar
from bulletproofs_r1cs_gadgets_tpu.core.transcript import Transcript
from bulletproofs_r1cs_gadgets_tpu.core.verifier import Verifier, batch_verify
from bulletproofs_r1cs_gadgets_tpu.gadgets.poseidon import PoseidonParams
from bulletproofs_r1cs_gadgets_tpu.models.compiled import CompiledVSMT2
from bulletproofs_r1cs_gadgets_tpu.models.vsmt2 import (
    VanillaSparseMerkleTree,
    leaf_index_bit_scalars,
)
from bulletproofs_r1cs_gadgets_tpu.native import _native
from bulletproofs_r1cs_gadgets_tpu.parallel.batch import prove_provers
from bulletproofs_r1cs_gadgets_tpu.utils.constants import D2, L, P

from .ops.torch_backend import TorchBackend

NATIVE_LOADED = _native is not None  # C++ host library (gens, Poseidon)

__all__ = [
    "TorchBackend", "Scalar", "Prover", "Verifier", "PedersenGens",
    "BulletproofGens", "Transcript", "R1CSProof", "RistrettoPoint",
    "VerificationError", "multiscalar_mul", "scvec", "PoseidonParams",
    "CompiledVSMT2", "VanillaSparseMerkleTree", "leaf_index_bit_scalars",
    "D2", "L", "P", "NATIVE_LOADED", "prove_provers", "batch_verify",
]
