"""The proving pipeline's step, on one device and over a mesh (the JAX
package's ``parallel/pipeline.py``).

``proving_step`` is the computational heart of batched proving over the
real flagship primitives:

* witness transform: a batched Poseidon Merkle-path recompute (width 6,
  rounds 4+140+4: the VSMT-2 hash geometry of ``models/vsmt2.py``) that
  folds each proof's leaf up its path with the 2:1 hash
  (``DevicePoseidon.chain``: one ``poseidon_chain`` launch for the whole
  path), with the cube S-box as in the reference (the proving stack
  itself runs the inverse S-box end to end);
* partial MSM: a commitment partial, one ``smul_lanes`` scalar multiply
  per point and a ``padd`` halving tree.

``make_sharded_step(mesh)`` runs both over a ``(batch, points)`` mesh of
devices, where the reference runs them under ``shard_map``:

* witness: split over the batch rows; each row hashes its own proofs
  with its first device's hasher, one ``poseidon_chain`` launch a row
  (data parallel);
* points and bits: split over the points devices, one partial MSM each
  (tensor parallel), the partials gathered onto the mesh's first device
  and added with ``padd`` (the reference's ``all_gather`` and
  ``point_add``);
* the checksum, the reference's ``psum`` of the digests over the batch
  axis, is their sum mod l as ``FQ`` words.

``graft_entry.entry`` returns the single-device step with the
reference's inputs.
"""

from __future__ import annotations

import torch

from ..gadgets.poseidon_params import PoseidonParams
from ..ops.curve import scalar_mul_bits, tree_reduce
from ..ops.field import FQ
from ..ops.poseidon import DevicePoseidon
from .mesh import even_spans, make_mesh, sum_partials

_HASHERS: dict = {}


def flagship_hasher(device="cuda") -> DevicePoseidon:
    """The VSMT-2 hash geometry (width 6, rounds 4+140+4) with the cube
    S-box as a batched device permutation; built once per device."""
    key = str(torch.device(device))
    got = _HASHERS.get(key)
    if got is None:
        got = DevicePoseidon(PoseidonParams(6, 4, 4, 140), sbox="cube",
                             device=device)
        _HASHERS[key] = got
    return got


def witness_transform(witness: torch.Tensor) -> torch.Tensor:
    """Batched Merkle-path recompute: (B, W, 8) FQ words, per proof lane 0
    the leaf and lanes 1..W-1 the path nodes, folded with the Poseidon 2:1
    hash acc <- H(acc, node_i) in one launch.  Returns (B, 8) root digests
    (models/vsmt2.py:35-158)."""
    return flagship_hasher(witness.device).chain(witness)


def partial_msm(points: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """(N, 4, 8) x (N, nbits) LSB-first bits -> (4, 8) partial commitment."""
    return tree_reduce(scalar_mul_bits(points, bits))


def proving_step(witness, points, bits):
    """Single-device step: (digests (B, 8), commitment (4, 8))."""
    digest = witness_transform(witness)
    commitment = partial_msm(points, bits)
    return digest, commitment


def make_sharded_step(mesh=None):
    """The full step over `mesh` (default: every visible card, by
    ``make_mesh``'s rule): ``step(witness, points, bits)`` ->
    ``(digests (B, 8), checksum (8,), total (4, 8))`` on the mesh's first
    device.  B must split evenly over the batch rows."""
    mesh = make_mesh() if mesh is None else mesh
    row_devs = [torch.device(row[0]) for row in mesh.rows("batch")]
    pts_devs = mesh.axis_devices("points")
    lead = row_devs[0]
    for dev in row_devs:  # build every row's hasher before the first step
        flagship_hasher(dev)

    def step(witness, points, bits):
        B = witness.shape[0]
        if B % len(row_devs):
            raise ValueError(f"{B} proofs do not split over "
                             f"{len(row_devs)} batch rows")
        # tp: every shard's partial MSM launched, then gathered and added
        spans = even_spans(points.shape[0], len(pts_devs))
        parts = [partial_msm(points[lo:hi].to(dev), bits[lo:hi].to(dev))
                 for (lo, hi), dev in zip(spans, pts_devs)]
        total = sum_partials(parts, lead)
        # dp: each batch row hashes its own proofs
        digest = torch.cat([
            witness_transform(witness[lo:hi].to(dev)).to(lead)
            for (lo, hi), dev in zip(even_spans(B, len(row_devs)), row_devs)
        ])
        return digest, FQ.sum(digest, dim=0), total

    return step
