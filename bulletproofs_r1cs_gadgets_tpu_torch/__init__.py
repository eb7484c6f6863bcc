"""bulletproofs_r1cs_gadgets_tpu_torch: the PyTorch + CUDA port of
``bulletproofs_r1cs_gadgets_tpu``.

It imports ``torch`` and never ``jax``, and nothing of the JAX package.
The host layers that use no JAX are the port's own copies, in the JAX
package's relative layout (made verbatim, so the two stay comparable file
by file):

  core/                 the R1CS engine: scalars, ristretto points,
                        Merlin transcripts, Pedersen / Bulletproof
                        generators, prover, verifier, IPP, scvec
  utils/                constants, config, stats, metrics (the span
                        recorder: per-proof spans and counters)
  gadgets/              Poseidon, r1cs utilities, zero / nonzero, scalar
                        utilities, bound check
  models/               the VSMT-2 / VSMT-4 trees and compiled circuits
  parallel/batch.py     the batch scheduler (``prove_provers``)
  parallel/stream.py    the proof stream (``prove_stream``): lazily
                        built provers in wave groups, bounded in-flight
                        state (the reference's, with a torch memory probe)
  native/               the C++ host library, built by ``g++`` into
                        ``build/`` at first use (pure-Python fallback)
  carry.py              the JAX package's parameters (generator and
                        Poseidon arrays) as the port's objects
  golden/               proof digests of the JAX package's host engine

What sits behind the engine's backend seam is the port's device layer:

  ops/field.py          point layout, codecs, plain torch field ops
  ops/curve.py          plain torch point ops
  ops/chunks.py         host word encoders and flat point packing
  ops/cuda_curve.py     kernel wrappers + plain versions + launch counts
  ops/build.py          nvcc build of csrc/*.cu, ctypes binding
  ops/torch_backend.py  TorchBackend (the seam: msm, msm_gens,
                        phase_commitments, ipp_create and their batches;
                        one route, chosen by size) and Route (no fields,
                        accepted and ignored by TorchBackend)
  ops/native_backend.py NativeBackend: the JAX package's single-core C++
                        CPU backend, copied (the host leg of the proof
                        equivalence gate; not exported here, as it runs
                        nothing on the card)
  csrc/                 the Hopper kernels (sm_90a)

the device-oracle layer (the JAX package's XLA-composed oracle modules,
on nine more kernels):

  ops/field.py          LimbField, FQ (mod l) and FP (mod p) on (..., 8)
                        words: mul / square on the mul_fq / mul_fp kernels
  ops/curve.py          the JAX curve API: point_add / point_double (padd,
                        pdbl), scalar_mul_bits (smul_lanes),
                        scalar_mul_shared, tree_reduce, sqrt_ratio,
                        elligator_map, from_uniform_bytes_batch
  ops/msm.py            msm_device (msm_chunk_acc, chained) and MsmEngine
                        (msm_block_totals)
  ops/backend.py        DeviceBackend: the seam on msm_device and fold_grid
  ops/poseidon.py       DevicePoseidon: the batched permutation
                        (poseidon_permute; chain: poseidon_chain)
  parallel/pipeline.py  proving_step: batched Merkle-path hashing (one
                        poseidon_chain launch) and a commitment partial

and the multi-device layer:

  parallel/mesh.py      (batch, points) meshes of devices
  parallel/device_batch.py  whole proofs placed round-robin on devices,
                        one backend each (``prove_provers_devices``)
  parallel/sharded_fast.py  one MSM's chunks sharded over devices, each
                        walked by the ``msm_grid_local`` kernel, then
                        gathered and folded (``ShardedWalkMsm``,
                        ``ShardedWalkVerifyBackend``)

Their entry points default to every visible CUDA device and raise
without one; a device list may repeat a card, or name ``"cpu"`` (the
plain versions).

Batched proving and verification are the engine's own
``prove_provers(provers, gens, backend=TorchBackend("cuda"))`` and
``batch_verify(verifiers, proofs, pc_gens, gens, backend=...)``,
re-exported here.
"""
from .core import errors, scvec
from .core.errors import VerificationError
from .core.linear_combination import LinearCombination, Variable
from .core.pedersen import (
    BulletproofGens,
    PedersenGens,
)
from .core.proof import R1CSProof
from .core.prover import Prover
from .core.ristretto import (
    RistrettoPoint,
    multiscalar_mul,
)
from .core.scalar import Scalar
from .core.transcript import Transcript
from .core.verifier import Verifier, batch_verify
from .gadgets.poseidon import PoseidonParams
from .models.compiled import CompiledVSMT2
from .models.vsmt2 import (
    VanillaSparseMerkleTree,
    leaf_index_bit_scalars,
)
from .native import _native
from .parallel.batch import prove_provers
from .parallel.device_batch import prove_provers_devices
from .parallel.stream import prove_stream
from .utils.constants import D2, L, P

from .ops.backend import DeviceBackend
from .ops.torch_backend import Route, TorchBackend

NATIVE_LOADED = _native is not None  # C++ host library (gens, Poseidon)

__all__ = [
    "TorchBackend", "Route", "Scalar", "Prover", "Verifier", "PedersenGens",
    "BulletproofGens", "Transcript", "R1CSProof", "RistrettoPoint",
    "VerificationError", "multiscalar_mul", "scvec", "PoseidonParams",
    "CompiledVSMT2", "VanillaSparseMerkleTree", "leaf_index_bit_scalars",
    "D2", "L", "P", "NATIVE_LOADED", "prove_provers", "batch_verify",
    "prove_provers_devices", "prove_stream", "DeviceBackend", "Variable",
    "LinearCombination", "errors",
]
__version__ = "0.1.0"
