#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths, a VSMT-2 depth-253 membership proof
(143,704 multipliers padded to 2^18) proved alone (on the default route
and on the chunk-list route) and a batch of eight proved through
``prove_provers`` and verified by one ``batch_verify``, through
``TorchBackend("cuda")``, the reference's equivalence gate (one depth-8
proof down both routes and the host paths), and the multi-device layer
and the stream
(depth-253 proofs placed over the cards, the sharded walk at 2^18, a
stream of twelve), the device-oracle path (``DeviceBackend``,
``proving_step``, the batched generator derivation, ``MsmEngine``), the
gadget zoo, and the sharded oracle path (``ShardedMsmBackend``,
``BatchShardedBackend``, ``make_sharded_step``, the dry run), and checks
every kernel on the way.
Phases, each printing one line with its wall time (any failure exits
non-zero and prints no result):

0. device: nvidia-smi name and power limit, torch / CUDA versions, the
   card's 32-bit multiply rate (for the bounds); no CUDA device is a
   failure (this never runs on the CPU).
1. the port's C++ host library must have loaded; then build the kernels
   from ``bulletproofs_r1cs_gadgets_tpu_torch/csrc`` (one ``nvcc -c`` per
   source, all in parallel, then one link).
2. each kernel against its plain torch version on the card at main-path
   shapes (msm_w4 over 2^14 points and over 2048 and 1024, IPP rounds
   8-9's segments, with rows of 0, 1, L - 1, all -8 digits; msm_w4_pair
   over a 4096-point frozen pack with limits 0 / partial / full,
   fold_bits over 1024 lanes (IPP round 8's folds, the main path's shape)
   and 2048, with rows of both scalars 0, L - 1, every nibble 8 and bits
   253..255 set (not read),
   table_w5 over the 2^18 shared generators, msm_win5 over that table
   at the main path's walks (phase 1's 143,704 points, IPP round 1's
   2^17 at offset 2^17 and its 12,632-step a_R walk, the verifier's 2^18)
   plus a poff / split / poff2 walk, msm_lane over 16 segments of 2048
   points (rows 0, 1, L - 1, all -8 digits, an all-zero segment, a last
   segment identity-padded as the flotilla pads) and over 24, fold_w3h
   over the 2^18 generators into
   2^17 (random half-gcd pairs split at round 1's breakpoint, and the
   edge pairs (0, 1) / (1, -1)), fold_w3h_comb over a 2^18-point
   combined tensor (round 2) and an 8192-point one (round 7, one side on
   the edge pairs; breakpoints inside a block), table_w4 over 2^18
   points, msm_win_pair at IPP
   rounds 2 (n = 2^16) and 7 (n = 2048); the kernels of the reference's
   route flags (each must launch here: no path of the port's one route
   launches fold_c_comb, msm_win or msm_grid, and only padded n =
   4096's round 1 fold_c):
   fold_c over the 2^18 generators into 2^17 (random constants split at
   round 1's breakpoint, the edge constants 0, 1, L - 1) and over 4096
   into 2048 (breakpoints on and inside a warp), each in place, each
   under both designs (thread, group), fold_c_comb over a 2^18-point
   combined tensor under both,
   msm_win at round 2's L walk and R wrap walk and over the table_w4 of
   the shared generators at phase 1's 143,704 points, msm_grid over
   143,704 generators at offset 0 and 2048; msm_grid_local over one
   phase-8 shard, 32 chunks = 65,536 generators, at 32, 7 and 0 valid
   chunks; the device-oracle path's kernels: padd / pdbl over 2^18
   points (and timed at 2^14), smul_lanes over the path's 2^16 and over
   2^14 points x 253 bits under both designs, msm_block_totals over
   2^16 + 1000 points (a ragged last block, an all-zero block),
   msm_chunk_acc over 143,704 points and over the path's 2^14 with a
   nonzero acc, fold_grid from 2^18 into 2^17 with per-lane words (the edge scalars 0,
   1, L - 1) and with constant rows, and at 2,048 and 2^13 outputs under
   both designs, mul_fq / mul_fp over 2^20 elements with the edges 0, 1,
   m - 1, 2^256 - 1 (timed too at their callers' sizes: mul_fq's 288, 48
   and 8 elements, mul_fp's 2^18); poseidon_permute / poseidon_chain
   (csrc/poseidon.cu): the flagship cube permutation (width 6, 4 + 140 +
   4 rounds) over 2^14 rows under its round mask and all full, the
   inverse S-box over 1,024 rows under a mixed and an all-full mask,
   widths 2 and 8, the chain at 8 rows x 4 hashes (cube) and x 2
   (inverse), edge rows of 0, 1 and l - 1, and the depth probe
   sc_mul_test (one dependent mod-l multiply's latency)), and on a
   subset against the host MSM, scalar multiplication, the host Poseidon
   or Python ints.  Tolerance: exact (the same group
   elements, ``point_err`` 0: the windowed MSM and the niels fold add in
   another order than their plain versions, and so do msm_lane, fold_c*,
   smul_lanes, the oracle MSMs and fold_grid; equal table words; equal
   words for the other device-oracle kernels and the Poseidon kernel).  Every walk of the window
   walkers (msm_win5, msm_win_pair, msm_win) and of the windowed w4 MSM
   (msm_w4, msm_w4_pair, msm_grid, msm_grid_local, which end in the
   walkers' Horner) is timed, and split into its Horner tail (the
   profiler's device time of that kernel) and its passes (the rest; the
   ``walkers`` line); the walkers' carry-chain multiply and squaring are
   held word for word against fe_mul / fe_sq over 2^20 random and edge
   operand pairs and timed (``fe_mul_test``); table_w4 is timed at the
   main path's six sizes (2^18 down to 2^13 points); phase 1 logs
   ptxas's registers, stack and spills of the walkers, the windowed MSM
   (both word forms), the half-width fold,
   fold_bits, the constant folds, fold_grid and the tables (``ptxas``).
3. a VSMT-2 depth-4 proof through the port (padded to 4096: round 1
   folds with fold_c), byte-identical to the host
   path with the same prover randomness, its digest equal to the JAX
   package's (``golden/vsmt2_depth4.json``), and verified by the port's
   and the host verifier; then a batch of three depth-4 provers through
   ``prove_provers``, each proof byte-identical to the same prover proved
   alone through the port (flotilla rounds run).
4. the depth-253 proof: one cold prove, two warm proves, the port's
   verifier; every kernel of the default route but the flotilla's must
   have launched (launch counts over the cold prove, the verify and the
   warm proves), the verifier's row kernels among them
   (``route_kernels`` with a verify); then the same prover and rng, each
   on a fresh backend, on the default route and on the chunk-list route
   (``combined_off``: msm_w4 segments and fold_bits from round 2), each
   cold and warm (wall time, device-synchronised): both proofs
   byte-identical, each route's launches the kernels of its route and
   none of another's (``route_kernels``; the row kernels only in a
   verify); a tampered proof and a wrong root must raise
   VerificationError.
4b. the verifier's G/H row kernels (``sc_powers``, ``tape_flatten``,
   ``tape_sums``, ``gh_rows``) against their plain versions on the card
   at phase 4's 2^18 shape, over its tape's CSR, ``gh_rows`` over one row
   set and over a batch's eight (each its own z, y, challenges and rho):
   equal word for word, each timed beside its plain version and its
   bound (``rows_work``).
5. the depth-253 batch of eight (different leaves, deterministic prover
   randomness) through ``prove_provers`` as a user calls it (the default
   host pool: each prover's rng is private, so the pool cannot change
   the bytes): wall time, proofs/s and peak device memory; one
   ``batch_verify`` of the eight; proof 0 equals, byte for byte, the
   same prover re-proved alone; a batch holding one tampered proof must
   raise VerificationError naming its index.  Launch counts are taken
   over the batch's prove and verify (the row kernels too:
   ``batch_verify`` builds each proof's rows on the card and sums them
   in one ``gh_rows`` launch, ``route_kernels`` with a verify).
6. the equivalence gate of ``bench.py`` stage 5 (:482-627): its depth-8
   VSMT-2 circuit (4,544 multipliers padded to 8192, prover rng 42,
   commitments rng 7) proved on the default and the chunk-list route,
   through ``prove_provers`` (three provers, flotilla rounds), through
   the port's ``NativeBackend`` and through the host path (a
   low-priority process, ``chip_smoke.py --gate-host``, started before
   phase 2): one byte string, which verifies, and a tampered copy is
   rejected; each route must launch the kernels of its route and none
   of another's (``route_kernels``).
7. placement (the reference's dry run C): phase 5's first four
   depth-253 provers, restored to their state before proving, through
   ``prove_provers_devices`` over the visible cards (with one card, two
   ``TorchBackend`` instances on cuda:0, printed as such): each proof
   byte-identical to ``prove_provers`` on one backend, one
   ``batch_verify`` of the four, and on each placed backend one
   ``msm_w4`` of 2^14 points on its card equal to the host MSM.
8. the points-axis sharded walk (dry run D) at full width:
   ``ShardedWalkMsm`` with 4 shards x 32 chunks = 2^18 points over the
   visible cards (or all four on one, printed as such): the verifier's G
   segment of the phase-4 proof (128 valid chunks) and the phase-4
   prover's 143,704 phase-1 G words (71 valid chunks: shard 2 partial,
   shard 3 dead), each equal to ``msm_grid`` over the same points and
   words; the depth-253 proof verifies through
   ``ShardedWalkVerifyBackend`` (eight ``msm_grid_local`` launches) and a
   tampered copy is rejected; its wall time beside ``TorchBackend``'s.
9. the stream: ``prove_stream`` of 12 depth-253 provers built lazily
   from the compiled template (deterministic rngs), wave 4, inflight 8:
   one ``batch_verify`` of the twelve, proofs 0 and 11 byte-identical to
   the same provers, restored, through ``prove_provers``, the report (proofs/s, group times, peak device
   memory), and a short ``keep=False`` run whose ``on_result`` indices
   and bytes match.
10. the device-oracle path (the JAX package's XLA oracle modules, on the
   kernels of ``csrc/oracle.cu``), each part timed: (a) phase 4's
   depth-253 prover, restored, through ``DeviceBackend("cuda")``:
   byte-identical to phase 4's ``TorchBackend`` proof, verified through
   ``DeviceBackend``, a tampered copy rejected; (b) ``proving_step`` at
   B = 8 proofs x W = 254 (a leaf and a depth-253 path each, the cube
   Poseidon 2:1 hash) and 2^16 points x 253 bits: each digest equal to the
   host Poseidon chain, the commitment to the host MSM (the C++
   ``NativeBackend``); (c) party 0's 2^18 G generators from their
   SHAKE-256 seeds (``uniform_bytes_to_device``, the batched
   ``from_uniform_bytes``), equal as Ristretto points to
   ``BulletproofGens``' G (the products on the card by ``FP.mul``); (d)
   ``MsmEngine.msm`` at 2^16 against the host MSM and
   ``scalar_mul_shared`` over 2^14 points against host scalar
   multiplication; (e) ``DevicePoseidon`` with the inverse S-box over
   2^14 2:1 node hashes and 2^12 4:1 hashes (one ``poseidon_permute``
   launch each), on rows against the host Poseidon.  Each part must
   launch its kernels; (b) must launch ``poseidon_chain`` once and
   ``mul_fq`` never.
11. the gadget zoo through ``TorchBackend("cuda")`` on the default route,
   at the reference's sizes: the 64-bit bound check and range proof, set
   membership, set non-membership and ``set_membership_1`` over 32
   elements, not-equals, factors, MiMC at its 322 rounds (644
   multipliers), the Poseidon 2:1 preimage proof with the cube and the
   inverse S-box (``bench.py``:161-226's circuit) and VSMT-4 at depth 64
   (``CompiledVSMT4``, 37,312 multipliers padded to 2^16); each circuit
   built from the gadget functions on a prover with a seeded rng and
   blindings: its proof byte-identical to the same circuit proved on the
   host path (a low-priority process, ``chip_smoke.py --zoo-host``,
   started before phase 2; VSMT-4's host leg is the port's
   ``NativeBackend``, as the host path would take minutes), verified
   through the backend, a tampered copy rejected; per circuit its padded
   size, prove and verify wall times and launch counts.
12. the sharded oracle path over four shards of the visible cards (all on
   cuda:0 with one card, printed as such), each part timed: (a) phase 4's
   depth-253 prover, restored, through ``ShardedMsmBackend``:
   byte-identical to phase 4's proof, verified through it, a tampered
   copy rejected, its times beside phase 10 (a)'s; (b) phase 5's first
   four depth-253 provers, restored, through ``prove_provers`` on
   ``BatchShardedBackend`` over a (batch 2, points 2) mesh: each proof
   byte-identical to phase 5's, one ``batch_verify`` of the four through
   it; (a) and (b) must launch ``msm_chunk_acc``, ``padd`` and
   ``fold_grid``; (c) ``make_sharded_step`` on that mesh at B = 8 proofs
   x W = 254, 2^16 points x 253 bits (one ``poseidon_chain`` launch a
   batch row, no ``mul_fq``): digests equal to the host Poseidon chain, the checksum their sum mod l, the
   total the host MSM; (d) ``graft_entry.dryrun_multichip(4)``, its five
   phase lines (A, B, B2, C, D).

Each path's launch counts are set to 0 just before it and read just
after.  The third line from the end is the card's nvidia-smi name and
power limit, the line before the last holds the per-kernel JSON record
(``launches`` summed over phases 4 (both parts), 5, 6, 7, 8, 9, 10, 11
and 12,
every kernel at least once but ``mul_fq``, which no path calls
(``OFF_PATH``);
``bound_ms``
the larger of the work's 32-bit multiplies over the card's multiply rate
and its bytes over 3.35 TB/s, counted from this run's inputs; the
redesigned w4 MSMs (msm_lane and the oracle MSMs among them), half-width
folds, constant folds, fold_grid, fold_bits and tables also give
``bound_ladder_ms``, the bound
their first versions' work was held to; fold_bits, the constant folds
and the tables give ``kernel_int_muls``, the multiplies the kernel runs
with its repeated steps, beside ``int_muls``, the work's; msm_lane
also gives its time over 24 segments (``ms_24``), and fold_c its
design and its record at 2048 outputs (``*_2048``: padded n = 4096's
round 1 on the default route) and each design's time at both shapes
(``design_ms``); msm_chunk_acc its record at the path's 2^14 points
(``*_16384``); padd / pdbl their times at 2^14 points (``ms_16384``);
smul_lanes its design, each design's time and its record at 2^14 lanes
(``design_ms``, ``*_16384``); fold_grid its design, constant rows' times
(``const_ms``), each design's time and its records at 2,048 and 2^13
outputs (``design_ms``, ``*_2048``, ``*_8192``);
fold_bits gives its chain floor, ``chain_ops`` dependent cooperative
operations, and ``chain_ms``, computed, not timed: ``chain_ops`` times
one cooperative operation's latency as this run measured it in the w4
Horner tail (its ``tail_ms`` over its HORNER_OPS operations);
poseidon_permute its record at 2^14 rows, poseidon_chain at 8 x 4
hashes and (``*_253``) at phase 10 (b)'s 8 x 253, each bound counted
from the kernel's work (the MDS sums reduced once), beside
``bound_jax_ms`` / ``jax_int_muls`` from the JAX program's (every MDS
product reduced), and a chain floor,
``chain_ops`` dependent mod-l multiplies a row (three a cube round)
times the depth probe's ``sc_mul_latency_ns``; mul_fq / mul_fp their
times (CUDA events over back-to-back calls), device times a launch
(``device_ms_288`` ..., the profiler's) and byte bounds at their callers'
sizes (``ms_288`` ...); the row kernels their phase-4b records at 2^18
rows (``sc_powers`` also at z^1..z^m, ``*_z``, and for s, ``ms_s``;
``gh_rows`` with n1 = n / 2, ``ms_half_phase1``, and over a batch's
eight row sets, ``*_b8``);
``library_ms`` null: no PyTorch call computes these functions), and the
last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PKG = "bulletproofs_r1cs_gadgets_tpu_torch"
_W4 = f"{PKG}/csrc/msm_fold.cu"
_WIN = f"{PKG}/csrc/win.cu"
_W3H = f"{PKG}/csrc/fold_w3h.cu"
_OR = f"{PKG}/csrc/oracle.cu"
_PS = f"{PKG}/csrc/poseidon.cu"
_VR = f"{PKG}/csrc/verify_rows.cu"
SOURCES = {
    "msm_w4": _WIN, "msm_w4_pair": _WIN, "fold_bits": _W4, "msm_lane": _WIN,
    "table_w5": _WIN, "msm_win5": _WIN, "table_w4": _WIN,
    "msm_win_pair": _WIN, "fold_w3h": _W3H, "fold_w3h_comb": _W3H,
    "fold_c": _W4, "fold_c_comb": _W4, "msm_win": _WIN,
    "msm_grid": _WIN,  # launches msm_w4's kernels over a view
    "msm_grid_local": _WIN,  # msm_w4's kernels over one shard's live prefix
    "padd": _OR, "pdbl": _OR, "smul_lanes": _W4,
    "msm_block_totals": _WIN,  # the windowed w4 MSM over bit words
    "msm_chunk_acc": _WIN, "fold_grid": _W4, "mul_fp": _OR, "mul_fq": _OR,
    "poseidon_permute": _PS, "poseidon_chain": _PS,  # poseidon_perm's entries
    "sc_powers": _VR, "tape_flatten": _VR, "tape_sums": _VR, "gh_rows": _VR,
}
_PC = "bulletproofs_r1cs_gadgets_tpu/ops/pallas_curve.py"
_JV = "bulletproofs_r1cs_gadgets_tpu/core/verifier.py"
REPLACES = {
    "msm_w4": f"{_PC}:369",
    "msm_w4_pair": f"{_PC}:768",
    "fold_bits": f"{_PC}:1566",
    "table_w5": f"{_PC}:1233",
    "msm_win5": f"{_PC}:1345",
    "msm_lane": f"{_PC}:1515",
    "fold_w3h": f"{_PC}:646",
    "fold_w3h_comb": f"{_PC}:685",
    "table_w4": f"{_PC}:1012",
    "msm_win_pair": f"{_PC}:1462",
    "fold_c": f"{_PC}:541",
    "fold_c_comb": f"{_PC}:733",
    "msm_win": f"{_PC}:1156",
    "msm_grid": f"{_PC}:438",
    "msm_grid_local": f"{_PC}:487",
    "padd": f"{_PC}:176",
    "pdbl": f"{_PC}:190",
    "smul_lanes": f"{_PC}:1519",
    "msm_block_totals": f"{_PC}:252",
    "msm_chunk_acc": f"{_PC}:279",
    "fold_grid": f"{_PC}:865",
    "mul_fp": "bulletproofs_r1cs_gadgets_tpu/ops/pallas_field.py:201",
    "mul_fq": "bulletproofs_r1cs_gadgets_tpu/ops/pallas_field.py:200",
    # mul_fq as the port's Poseidon called it, three launches a round
    "poseidon_permute": "bulletproofs_r1cs_gadgets_tpu/ops/pallas_field.py:200",
    "poseidon_chain": "bulletproofs_r1cs_gadgets_tpu/ops/pallas_field.py:200",
    # the verifier's G/H rows, which the JAX package builds on the host
    "sc_powers": f"{_JV}:247",
    "tape_flatten": f"{_JV}:222",
    "tape_sums": f"{_JV}:250",
    "gh_rows": f"{_JV}:269",
}
# the kernels of the reference's other route flags (ported in the same
# slice): phase 2 launches each (phase_kernels_flags) and holds it to its
# plain version; of the port's paths only padded n = 4096's round 1
# launches one (fold_c, phase 3)
FLAG_KERNELS = ("fold_c", "fold_c_comb", "msm_win", "msm_grid")
# the device-oracle path's kernels (phase 10; TorchBackend launches none)
ORACLE_KERNELS = ("padd", "pdbl", "smul_lanes", "msm_block_totals",
                  "msm_chunk_acc", "fold_grid", "mul_fp", "mul_fq",
                  "poseidon_permute", "poseidon_chain")
# kernels no path calls: mul_fq's one caller on a path, the port's
# Poseidon, runs poseidon_perm since it was written (and no path of the JAX
# package calls the Pallas mul_fq); msm_win, msm_grid and fold_c_comb are
# the kernels of the reference's route flags, which the port's one route
# does not take; phase 2 still holds each to its plain version and times
# it
OFF_PATH = ("mul_fq", "msm_win", "msm_grid", "fold_c_comb")
# the verifier's G/H row kernels: a verify on the default route launches
# them (phase 4b holds them to their plain versions)
ROWS_KERNELS = ("sc_powers", "tape_flatten", "tape_sums", "gh_rows")
KERNELS = tuple(REPLACES)
GOLDEN = os.path.join(ROOT, PKG, "golden", "vsmt2_depth4.json")
SEED = 20261016
DEPTH = 253
SMALL_DEPTH = 4
BATCH = 8  # depth-253 proofs in phase 5
GENS_N = 1 << 18  # the padded size: table_w5 generators, msm_win5 words
N1 = 143_704  # depth-253 multipliers: the phase-1 walks
MSM_N = 1 << 14  # phase-2 shapes: msm_w4 points,
MSM_SIZES = (MSM_N, 2048, 1024)  # msm_w4 at 2^14 and IPP rounds 8-9
PAIR_S = 1024  # frozen side (the pair walks 4 * PAIR_S points),
FOLD_SIZES = (1024, 2048)  # fold_bits lanes: IPP round 8's (the main path's), and 2048,
FOLD_M = max(FOLD_SIZES)  # fold_grid lanes (phase 10's kernels),
TABLE_SIZES = tuple(1 << k for k in range(18, 12, -1))  # table_w4 per round
LANE_V, LANE_SEG = 16, 2048  # msm_lane segments x points (the batch of 8's flotilla)
LANE_V12 = 24  # msm_lane segments of the reference's batch of 12
FOLD_C_V = 2048  # fold_c outputs of padded n = 4096's round 1 (the default route)
COMB_N = (1 << 16, 2048)  # msm_win_pair: IPP rounds 2 and 7 (side n)
COMB7_M = 2048  # fold_w3h_comb at IPP round 7: 2 x 2^12 -> 2 x 2^11
SHARDS, SHARD_CHUNKS = 4, 32  # phase 8: 4 shards x 32 chunks = 2^18 points
PLACED = 4  # depth-253 provers placed over the devices in phase 7
STREAM = 12  # depth-253 provers streamed in phase 9
ORACLE_B, ORACLE_W = 8, 254  # phase 10 (b): proofs x (leaf + 253 nodes)
ORACLE_MSM_N = 1 << 16  # phase 10 (b) points, (d) MsmEngine points
# digits -16 in windows 0..49 and 1 in window 50
ALL_MINUS_16 = (1 << 250) - 16 * ((1 << 250) - 1) // 31
# The port's routes, each a padded size's branches of the one route:
# True is the default (the combined layout from IPP round 2), False the
# chunk-list route (``combined_off``: round 1 over the shared tables, then
# ``msm_w4`` segments and ``fold_bits``).  Phases 4 and 6 prove on both.
ROUTES = {"default": True, "combined off": False}


def route_kernels(combined: bool = True, verify: bool = False):
    """(launched, not launched): the kernels a proof (and with `verify`
    a verify) must launch and must not, for a padded size whose IPP
    reaches the combined layout (at least 4 * COMB_MIN_N), on the default
    route or with `combined` False the chunk-list route.  A verify builds
    its G/H rows on the card (ROWS_KERNELS), and so does a
    ``batch_verify``; a proof never does.  No path launches a kernel of
    FLAG_KERNELS at this size."""
    comb = {"fold_w3h", "fold_w3h_comb", "table_w4", "msm_win_pair"}
    if combined:
        on, off = {"table_w5", "msm_win5"} | comb, set(FLAG_KERNELS)
    else:
        on = {"table_w5", "msm_win5", "msm_w4", "fold_bits"}
        off = comb | set(FLAG_KERNELS)
    rows = set(ROWS_KERNELS)
    if verify:
        return on | rows, off
    return on, off | rows


def check_route(tag: str, ran: dict, combined: bool = True,
                verify: bool = False) -> None:
    """Fail unless the launch counts `ran` of one route's run (a proof,
    or with `verify` a proof and a verify) hold
    route_kernels(combined, verify)."""
    on, off = route_kernels(combined, verify)
    missing = sorted(k for k in on if not ran.get(k, 0))
    stray = sorted(k for k in off if ran.get(k, 0))
    assert not missing and not stray, \
        f"route {tag}: not launched {missing}, launched off-route {stray}"

# ---- the least time the card could take (bound_ms): the larger of the
# 32-bit integer multiplies over the card's multiply rate and the bytes
# over its memory rate.  A field multiply (csrc/fe25519.cuh fe_mul) is 73
# products of 32 x 32 -> 64 bits (64 schoolbook, 8 for the x38 fold, 1 in
# fe_fold), each two 32-bit multiplies (low and high word); point
# operations count their field multiplies: double 8, add 9 (with the 2d
# product), niels add 8.  The redesigned MSM and fold (csrc/win.cu
# msm_w4_tiles, csrc/fold_w3h.cu) square with fe_sq_cc, 45 products (36
# for the square, 9 for the reduction): their doublings count 4 squares
# ("sq") and 4 multiplies ("fe"), 3 where T is left out.  The multiply
# rate is 64 per clock per SM (CUDA C++ Programming Guide, arithmetic
# instruction throughput, compute capability 9.0: 32-bit integer multiply
# and multiply-add) times the SM count times the card's maximum SM clock
# (nvidia-smi clocks.max.sm), set in phase 0.  Memory: 3.35 TB/s (NVIDIA
# H100 SXM data sheet).
INT_MULS_PER_FE_MUL = 2 * 73
INT_MULS = {"dbl": 8 * INT_MULS_PER_FE_MUL, "add": 9 * INT_MULS_PER_FE_MUL,
            "nadd": 8 * INT_MULS_PER_FE_MUL, "fe": INT_MULS_PER_FE_MUL,
            "sq": 2 * 45, "sc": 2 * (64 + 81 + 45),
            "sc_prod": 2 * 64, "sc_red": 2 * (81 + 45)}
HBM_BYTES_PER_S = 3.35e12
CARD = {"int_muls_per_s": None}


def bounds(ops: dict, ladder: dict, nbytes: int, kernel: dict | None = None) -> dict:
    """bound() of a redesigned kernel's work `ops`, as bound_ladder_ms
    the bound of the work `ladder` its first version's ladders did, and as
    kernel_int_muls the multiplies the kernel itself runs (`kernel`: its
    repeated steps included), where they differ from the work's."""
    out = dict(**bound(ops, nbytes),
               bound_ladder_ms=bound(ladder, nbytes)["bound_ms"])
    if kernel is not None:
        out["kernel_int_muls"] = bound(kernel, nbytes)["int_muls"]
    return out


def bound(ops: dict, nbytes: int) -> dict:
    """bound_ms / bound_by of work holding `ops` point and field operations
    (keys of INT_MULS) and moving `nbytes` bytes."""
    muls = sum(INT_MULS[k] * int(v) for k, v in ops.items())
    t_ops = muls / CARD["int_muls_per_s"]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return dict(
        bound_ms=1e3 * max(t_ops, t_bytes),
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        int_muls=muls, bytes=int(nbytes),
    )


def _codes(words, field: int, count: int):
    """(n, k) int32 digit words -> (n, count) uint8 digit codes, `field`
    bits per digit (4: w4 / w3h nibbles, 8: w5 bytes)."""
    import numpy as np

    w = np.ascontiguousarray(words).view(np.uint32)
    per = 32 // field
    shifts = (field * np.arange(per)).astype(np.uint32)
    c = (w[:, :, None] >> shifts) & np.uint32((1 << field) - 1)
    return c.reshape(w.shape[0], -1)[:, :count].astype(np.uint8)


def ladder_ops(codes, step_dbl: int) -> dict:
    """Point operations of per-row ladders over digit codes (most
    significant last): from each row's top nonzero digit, `step_dbl`
    doublings per later digit and one add per nonzero digit after the
    first (the kernels skip zero digits and start at the top one)."""
    import numpy as np

    nz = codes != 0
    live = nz.any(axis=1)
    top = codes.shape[1] - 1 - np.argmax(nz[:, ::-1], axis=1)
    return dict(
        dbl=int(step_dbl * top[live].sum()),
        add=int((nz.sum(axis=1)[live] - 1).sum()),
    ), int(live.sum())


def ladder_w4_ops(words, blocks: int, finals: int = 1) -> dict:
    """The w4 ladder MSMs' work (msm_w4 / _pair / msm_lane before their
    redesign): 7-operation tables and the ladder per live row, each
    block's 127-add tree, the second pass's sums."""
    ops, live = ladder_ops(_codes(words, 4, 64), 4)
    ops["dbl"] += 4 * live
    ops["add"] += 3 * live + 127 * blocks + blocks + 128 * finals
    return ops


def w4_blocks(n: int, walks: int = 1) -> int:
    """First-pass blocks a segment of the windowed w4 MSM at n points on
    the current card (the library's geometry)."""
    from bulletproofs_r1cs_gadgets_tpu_torch.ops import build

    return build.load().bp_w4_partials(n, walks) // (64 * walks)


def msm_w4_ops(words, blocks: int, walks: int = 1, chained: bool = True) -> dict:
    """The windowed w4 MSM (msm_w4, _pair, msm_lane, msm_grid,
    msm_grid_local; csrc/win.cu): per live row its table (4 doublings with
    T, 3 niels adds, 8 2dT multiplies) and one niels add per nonzero digit;
    per walk and first-pass block 64 adds of the two halves' sums, and per
    window pass 2's sum of the blocks' partials and its 2dT; per walk
    Horner's 252 doublings (T on 63), 64 niels adds and, if `chained`, the
    chain's (niels form; msm_lane has none)."""
    codes = _codes(words, 4, 64)
    live = int((codes != 0).any(axis=1).sum())
    horner_dbl = 4 * 63
    chain = 1 if chained else 0
    return dict(
        sq=4 * (4 * live + walks * horner_dbl),
        fe=4 * 4 * live + 8 * live + walks * (3 * horner_dbl + 63 + 64 + chain),
        nadd=3 * live + int((codes != 0).sum()) + walks * (64 + chain),
        add=walks * 64 * 2 * blocks,
    )


# dependent cooperative operations of a w4 Horner walk (msm_win_horner<4>):
# its doublings, its window adds and the chain's add; a launch's Horner
# tail over this count is the latency of one cooperative operation
HORNER_OPS = 4 * 63 + 64 + 1


def fold_codes(words):
    """(n, 8) raw bit words -> (n, 64) signed base-16 digit codes of bits
    252..0, the top one taking the carry (csrc/msm_fold.cu fold_recode;
    the CPU tests' model of fold_bits recodes with this function)."""
    import numpy as np

    w = np.ascontiguousarray(words).view(np.uint32).copy()
    w[:, 7] &= np.uint32(0x1FFFFFFF)
    nib = _codes(w.view(np.int32), 4, 64).astype(np.int64)
    codes = np.zeros_like(nib)
    carry = np.zeros(len(w), np.int64)
    for j in range(64):
        e = nib[:, j] + carry
        carry = (e >= 8).astype(np.int64)
        codes[:, j] = e & 15
    return codes


def fold_bits_ops(wl, wr) -> tuple[dict, dict, int]:
    """(the work of fold_bits' function on these words, the work the kernel
    runs (csrc/msm_fold.cu), its chain).  The function: per scalar with a
    digit above 1 in magnitude its table (4 doublings with T, 3 niels adds,
    8 2dT multiplies), per other nonzero scalar P's 2dT; per output 4
    doublings a window below its top nonzero one (T on the last) and a
    niels add per nonzero digit but the first.  The kernel: per output
    (padded to warps of four) both tables (8 doublings with T, 6 niels
    adds, 18 2dT multiplies), and per group the warp's windows and adds
    (a warp doubles below its top window and adds where any of its groups
    has a nonzero digit).  The chain: the dependent cooperative operations
    of the slowest warp, the tables' 14 and their 4 conversion stages (as
    2), the warp's doublings and adds."""
    import numpy as np

    codes = np.stack([fold_codes(wl), fold_codes(wr)])  # (2, n, 64)
    nz = codes != 0
    big = (nz & (codes != 1) & (codes != 15)).any(axis=2)  # a digit |d| > 1
    small = nz.any(axis=2) & ~big
    either = nz.any(axis=0)
    live = either.any(axis=1)
    top = 63 - np.argmax(either[:, ::-1], axis=1)
    nlive, windows = int(live.sum()), int(top[live].sum())
    nbig = int(big.sum())
    ops = dict(sq=16 * nbig + 16 * windows,
               fe=24 * nbig + int(small.sum()) + 13 * windows,
               nadd=3 * nbig + int(nz.sum()) - nlive)
    pad = -nz.shape[1] % 4  # the kernel's last warp repeats the last output
    nz = np.concatenate([nz, np.repeat(nz[:, -1:], pad, axis=1)], axis=1)
    warp = nz.reshape(2, -1, 4, 64).any(axis=2)  # (2, warps, 64)
    wany = warp.any(axis=0)
    wtop = np.where(wany.any(axis=1), 63 - np.argmax(wany[:, ::-1], axis=1), 0)
    wadds = warp.sum(axis=(0, 2))
    groups = nz.shape[1]
    kernel = dict(sq=32 * groups + 4 * 16 * int(wtop.sum()),
                  fe=50 * groups + 4 * 13 * int(wtop.sum()),
                  nadd=6 * groups + 4 * int(wadds.sum()))
    chain = 14 + 2 + 4 * wtop + wadds
    return ops, kernel, int(chain.max())


def fold_bits_ladder_ops(wl, wr) -> dict:
    """The first fold_bits' dual bit-serial ladders on these words: from
    each output's top set bit one doubling a bit, one add per bit set in
    either scalar, and L + R."""
    bits = _codes(wl, 1, 253) | _codes(wr, 1, 253)
    ops, live = ladder_ops(bits, 1)
    ops["add"] += live
    return ops


def table_ops(entries: int, n: int) -> tuple[dict, dict, dict]:
    """(work, ladder work, kernel work) of the niels tables of n points:
    the function's (the sequence's doublings, with T, and niels adds of P;
    one 2dT multiply an entry), the first version's (full adds), and the
    two-role kernel's (both roles double P and convert it)."""
    adds = entries // 2 - 1
    dbls = entries - 1 - adds
    ops = dict(sq=4 * dbls * n, fe=(4 * dbls + entries) * n, nadd=adds * n)
    kernel = dict(sq=4 * (dbls + 1) * n, fe=(4 * (dbls + 1) + entries + 1) * n,
                  nadd=adds * n)
    return ops, dict(dbl=dbls * n, add=adds * n, fe=entries * n), kernel


def table_bounds(entries: int, n: int) -> dict:
    """bounds() of the niels tables of n points: each point read, its
    entries written."""
    ops, ladder, kernel = table_ops(entries, n)
    return bounds(ops, ladder, n * 128 * (entries + 1), kernel)


def walk_ops(codes, rows, blocks: int, windows: int, bits: int,
             walks: int = 1) -> tuple[dict, int]:
    """Window walks: one niels add per nonzero digit, the block and
    window trees and Horner; returns the ops and the table entries the
    digits select (distinct (row, entry) pairs)."""
    import numpy as np

    tbl = 1 << (bits - 1)
    mag = np.where(codes >= tbl, 2 * tbl - codes.astype(np.int64), codes)
    used = np.zeros(len(rows), np.int64)
    for k in range(1, tbl + 1):
        used |= (mag == k).any(axis=1).astype(np.int64) << (k - 1)
    acc = np.zeros(int(rows.max()) + 1, np.int64)
    np.bitwise_or.at(acc, rows, used)
    n_entries = int(np.unpackbits(acc.view(np.uint8)).sum())
    ops = dict(
        nadd=int((codes != 0).sum()),
        add=walks * windows * (128 * blocks + blocks + 1),
        dbl=walks * bits * (windows - 1),
    )
    return ops, n_entries


def log(msg: str) -> None:
    print(msg, flush=True)


class Phase:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.time()
        log(f"[{self.name}] start")
        return self

    def __exit__(self, exc_type, exc, tb):
        dt = time.time() - self.t0
        status = "ok" if exc_type is None else f"FAILED ({exc_type.__name__})"
        log(f"[{self.name}] {status} in {dt:.2f} s")
        return False


# ------------------------------------------------------------ helpers
def affine(pt, P):
    zi = pow(pt.Z, P - 2, P)
    return pt.X * zi % P, pt.Y * zi % P


def max_abs_err(got, want, P) -> int:
    """Largest |difference| of affine coordinates over two point lists
    (0 when every point is the same Edwards point)."""
    err = 0
    for a, b in zip(got, want, strict=True):
        (ax, ay), (bx, by) = affine(a, P), affine(b, P)
        err = max(err, abs(ax - bx), abs(ay - by))
    return err


def point_err(F, got, want, P) -> int:
    """max_abs_err of two (n, 4, 8) point tensors on the card: 0 when
    every pair is the same Edwards point (X1 Z2 = X2 Z1 and Y1 Z2 = Y2 Z1,
    checked in torch on the device), else the largest affine difference
    over the first 64 pairs that differ."""
    g, w = F.words_to_limbs(got), F.words_to_limbs(want)
    same = None
    for c in (0, 1):
        lhs = F.canonical(F.mul(g[:, c], w[:, 2]))
        rhs = F.canonical(F.mul(w[:, c], g[:, 2]))
        eq = (lhs == rhs).all(dim=-1)
        same = eq if same is None else same & eq
    bad = (~same).nonzero().flatten()[:64]
    if bad.numel() == 0:
        return 0
    return max_abs_err(F.to_points(got[bad]), F.to_points(want[bad]), P)


def decode_w4(row) -> int:
    total = 0
    for j, word in enumerate(int(v) & 0xFFFFFFFF for v in row):
        for t in range(8):
            nib = (word >> (4 * t)) & 15
            total += (nib - 16 if nib >= 8 else nib) << (4 * (8 * j + t))
    return total


def decode_bits(row) -> int:
    return sum((int(v) & 0xFFFFFFFF) << (32 * j) for j, v in enumerate(row))


def niels_affine(entry_ints, P, D2):
    """(Y+X, Y-X, 2dT, Z) as ints -> affine (x, y); checks 2dT."""
    ypx, ymx, t2d, z = entry_ints
    inv2 = pow(2, P - 2, P)
    X, Y = (ypx - ymx) * inv2 % P, (ypx + ymx) * inv2 % P
    assert t2d * z % P == D2 * X * Y % P, "niels 2dT does not match X, Y"
    zi = pow(z, P - 2, P)
    return X * zi % P, Y * zi % P


def time_ms(torch, fn, reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    fn()  # warm-up
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def kernel_ms(torch, fn, reps: int = 3) -> dict:
    """Device ms per launch of each kernel `fn` launches, by name: the
    mean over the launches a torch.profiler trace of `reps` calls (after a
    warm-up) holds, as the trace can miss some of them."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    spans = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            spans.setdefault(e.name, []).append(
                (e.time_range.end - e.time_range.start) / 1000)
    return {name: sum(v) / len(v) for name, v in spans.items()}


# walker timings of phase 2, by kernel and walk: CUDA-event ms per call
# and its device split into the window passes and the Horner tail
WALKS = {}


def time_walk(torch, kernel: str, walk: str, fn, reps: int = 5) -> float:
    """CUDA-event ms per call of a window walker, logged split into its
    Horner tail (the profiler's device time of its one launch of the
    kernel named ``msm_win_horner``) and its passes (the rest); kept in
    WALKS."""
    ms = time_ms(torch, fn, reps)
    by = kernel_ms(torch, fn)
    tail = sum(v for k, v in by.items() if "msm_win_horner" in k)
    WALKS.setdefault(kernel, {})[walk] = dict(
        ms=ms, passes_ms=ms - tail, tail_ms=tail)
    log(f"  {kernel} {walk}: {ms:.3f} ms (passes {ms - tail:.3f} + Horner "
        f"{tail:.3f} ms)")
    return ms


def timed_once(torch, fn):
    """(fn(), its wall time in ms), synchronised on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1000


def random_scalar_rows(bp, n: int, rng):
    return bp.scvec.from_wide_bytes(rng.bytes(64 * n))


def build_tree(bp, depth: int):
    params = bp.PoseidonParams(6, 4, 4, 140)
    tree = bp.VanillaSparseMerkleTree(params, depth=depth)
    for i in range(1, 11):
        tree.update(bp.Scalar(i), bp.Scalar(i))
    return params, tree


def synthesize(bp, params, tree, depth, rng=None, leaf=7, circuit=None):
    """The bench's VSMT-2 membership circuit for `leaf`: compiled tape,
    commitments and witness loaded into a prover.  `circuit` reuses a
    (comp, tape) pair of the same tree."""
    import numpy as np

    k = bp.Scalar(leaf)
    merkle_proof = []
    assert tree.get(k, merkle_proof) == k
    bits = [b.v for b in bp.leaf_index_bit_scalars(k, depth)]
    nodes = list(reversed(merkle_proof))
    if circuit is None:
        comp = bp.CompiledVSMT2(params, depth, constrain_index_bits=False)
        circuit = comp, comp.tape(tree.root)
    comp, tape = circuit
    if rng is None:
        prover = bp.Prover(bp.PedersenGens.default(), bp.Transcript(b"VSMT"))
        comms = comp.commit_prover(prover, k, bits, nodes)
    else:
        prover = bp.Prover(
            bp.PedersenGens.default(), bp.Transcript(b"VSMT"),
            rng=np.random.RandomState(rng),
        )
        comms = comp.commit_prover(
            prover, k, bits, nodes, rng=np.random.RandomState(rng + 1)
        )
    aL, aR, aO = comp.witness(k, bits, nodes)
    prover.load_compiled(tape, aL, aR, aO)
    return comp, tape, comms, prover


def verifier_for(bp, comp, tape, comms):
    verifier = bp.Verifier(bp.Transcript(b"VSMT"))
    comp.commit_verifier(verifier, comms, bp.PedersenGens.default())
    verifier.load_compiled(tape, comp.num_multipliers)
    return verifier


def verify(bp, comp, tape, comms, proof, gens, backend):
    verifier_for(bp, comp, tape, comms).verify(
        proof, bp.PedersenGens.default(), gens, backend=backend
    )


def tampered(bp, proof):
    """The proof with one flipped byte (the IPP's `a` scalar)."""
    raw = bytearray(proof.to_bytes())
    raw[len(raw) - 64] ^= 1
    return bp.R1CSProof.from_bytes(bytes(raw))


class Case:
    """A proof and fresh verifiers for it: ``verifier()`` for its
    statement, ``wrong()`` for a false one."""

    def __init__(self, proof, gens, verifier, wrong):
        self.proof, self.gens = proof, gens
        self.verifier, self.wrong = verifier, wrong


def vsmt2_case(bp, depth: int, backend=None) -> Case:
    """The VSMT-2 membership proof of leaf 7 at `depth` (prover seed 11),
    and the same proof against a root that is not the tree's."""
    params, tree = build_tree(bp, depth)
    comp, tape, comms, prover = synthesize(bp, params, tree, depth, 11)
    n = comp.num_multipliers
    gens = bp.BulletproofGens(1 << (n - 1).bit_length())
    proof = prover.prove(gens, backend=backend)
    other = comp.tape(bp.Scalar((tree.root.v + 1) % bp.L))
    return Case(proof, gens, lambda: verifier_for(bp, comp, tape, comms),
                lambda: verifier_for(bp, comp, other, comms))


def vsmt4_case(bp, depth: int, backend=None) -> Case:
    """A VSMT-4 membership proof of leaf 7 at `depth` (the benchmark's
    circuit, prover seeds 3 and 4), and the same proof against a root
    that is not the tree's."""
    import numpy as np

    from bulletproofs_r1cs_gadgets_tpu_torch.models.compiled import (
        CompiledVSMT4,
    )
    from bulletproofs_r1cs_gadgets_tpu_torch.models.vsmt4 import (
        VanillaSparseMerkleTree4,
    )

    pc = bp.PedersenGens.default()
    params = bp.PoseidonParams(6, 4, 4, 140)
    tree = VanillaSparseMerkleTree4(params, depth=depth)
    for i in range(1, 11):
        tree.update(bp.Scalar(i), bp.Scalar(i))
    k, path = bp.Scalar(7), []
    leaf = tree.get(k, path)
    nodes = [x for level in path for x in level]
    comp = CompiledVSMT4(params, depth)
    prover = bp.Prover(pc, bp.Transcript(b"VSMT"),
                       rng=np.random.RandomState(3))
    comms = comp.commit_prover(prover, leaf, k, nodes,
                               rng=np.random.RandomState(4))
    tape = comp.tape(tree.root)
    prover.load_compiled(tape, *comp.witness(leaf, k, nodes))
    n = comp.num_multipliers
    gens = bp.BulletproofGens(1 << (n - 1).bit_length())
    proof = prover.prove(gens, backend=backend)
    other = comp.tape(bp.Scalar((tree.root.v + 1) % bp.L))

    def verifier(t):
        v = bp.Verifier(bp.Transcript(b"VSMT"))
        comp.commit_verifier(v, comms, pc)
        v.load_compiled(t, n)
        return v

    return Case(proof, gens, lambda: verifier(tape), lambda: verifier(other))


def verdict(bp, verifier, proof, gens, backend) -> bool:
    """Whether `verifier` accepts `proof` through `backend`."""
    try:
        verifier.verify(proof, bp.PedersenGens.default(), gens,
                        backend=backend)
    except bp.VerificationError:
        return False
    return True


class HostRows:
    """A backend with `inner`'s ``verify_rows`` hidden: the verifier builds
    the G/H rows on the host, as the JAX package does, and hands them to
    `inner`'s ``msm_gens``."""

    def __init__(self, inner):
        self.inner = inner

    def __getattr__(self, name):
        if name == "verify_rows":
            raise AttributeError(name)
        return getattr(self.inner, name)


# the verifier-row kernels' work at a verification's shapes, for their
# bounds (``bound``): mod-l multiplies ("sc"; "sc_prod" a product summed
# unreduced, "sc_red" a reduction) and the bytes read and written
def _popcounts(K: int) -> int:
    return sum(bin(k).count("1") for k in range(K))


def rows_work(cc, m: int, n: int, N: int, T: int, W: int, tc: int,
              B: int = BATCH) -> dict:
    """{kernel: (ops, bytes)} for m constraints, n multipliers padded to N,
    T tape terms over W wires and tc constant terms: ``sc_powers`` (the
    bit products of its runs' bases, then a product an output) for z^1..z^m
    (``sc_powers_z``) and for N outputs (y^-i; s the same),
    ``tape_flatten``, ``tape_sums`` and ``gh_rows`` (seven products a
    row and row set, 224 B read a row and set and 128 B written a row;
    ``gh_rows_b8`` over B sets)."""
    R = cc.SP_RUN
    return {
        "sc_powers_z": ({"sc": _popcounts(-(-m // R)) + m}, 32 * m),
        "sc_powers": ({"sc": _popcounts(-(-N // R)) + N}, 32 * N),
        "tape_flatten": ({"sc_prod": T, "sc_red": W}, 68 * T + 36 * W),
        "tape_sums": ({"sc_prod": tc + n, "sc": n,
                       "sc_red": -(-tc // cc.TS_SPAN) * 256
                       + -(-n // cc.TS_SPAN) * 256}, 68 * tc + 96 * n),
        "gh_rows": ({"sc": 7 * N}, 352 * N),
        "gh_rows_b8": ({"sc": 7 * B * N}, (224 * B + 128) * N),
    }


# ------------------------------------------------------------- phases
def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: chip_smoke runs only on a GPU")
    log(f"device {torch.cuda.get_device_name(0)} "
        f"(count {torch.cuda.device_count()}); nvidia-smi: {card}")
    clk = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60,
    ).stdout.split()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(clk[0])
    CARD["int_muls_per_s"] = 64 * sms * mhz * 1e6
    log(f"  int32 multiply rate {CARD['int_muls_per_s']:.4e}/s "
        f"(64 / clock / SM x {sms} SMs x {mhz} MHz max SM clock)")
    return card


def phase_kernels(bp, torch, cc, F, gens, dev):
    """Each kernel against its plain version (same CUDA inputs) and a
    subset against the host MSM; returns the per-kernel records."""
    import numpy as np

    rng = np.random.RandomState(SEED)
    P, L = bp.P, bp.L
    records = {}
    G = F.from_raw(gens.G_raw(max(MSM_N, 2 * FOLD_M)), dev)
    H = F.from_raw(gens.H_raw(PAIR_S), dev)
    Bpt = bp.PedersenGens.default().B

    # ---- msm_w4: 2^14 points (and their first 2048 / 1024: IPP rounds 8
    # and 9's segments), random scalars + edge rows
    n = MSM_N
    from bulletproofs_r1cs_gadgets_tpu_torch.ops.chunks import (
        signed_digit_words,
        bit_words,
    )

    rows = random_scalar_rows(bp, n, rng)
    edge = bp.scvec.from_ints([0, 1, L - 1, L - 1, 0, 1])
    rows[: len(edge)] = edge
    words = signed_digit_words(rows)
    words[6] = np.int32(-0x77777778)  # 0x88888888: every digit -8
    words[7, :] = words[6]
    w = torch.from_numpy(words).to(dev)
    acc = F.from_points([Bpt], dev)
    err = 0
    for m in MSM_SIZES:
        Gm, wm = G[:m], w[:m]
        got = cc.msm_w4(Gm, wm, acc)
        plain, ms = timed_once(torch, lambda: cc.msm_w4_plain(Gm, wm, acc))
        e = point_err(F, got, plain, P)
        log(f"  msm_w4 {m} points: plain {ms:.1f} ms, max_abs_err {e}")
        err = max(err, e)
        kms = time_walk(torch, "msm_w4", f"n {m}", lambda: cc.msm_w4(Gm, wm, acc))
        if m == n:
            main_ms, main_plain_ms = kms, ms
    sub = 64
    sub_got = cc.msm_w4(G[:sub], w[:sub].contiguous(), acc)
    host = bp.multiscalar_mul(
        [bp.Scalar(decode_w4(r) % L) for r in words[:sub]] + [bp.Scalar(1)],
        F.to_points(G[:sub]) + [Bpt],
    )
    assert F.to_points(sub_got)[0] == host, "msm_w4 != host MSM"
    assert err == 0, f"msm_w4 != plain (err {err})"
    records["msm_w4"] = dict(
        max_abs_err=err, ms=main_ms, plain_ms=main_plain_ms,
        **bounds(msm_w4_ops(words, w4_blocks(n)),
                 ladder_w4_ops(words, -(-n // 128)), n * 160 + 2 * 128),
    )

    # ---- msm_w4_pair: a frozen pack [G(S) | H(S)] x 2, S = 1024
    S = PAIR_S
    half = 2 * S
    pts = torch.cat([G[:S], H[:S], G[:S], H[:S]]).contiguous()
    prow = random_scalar_rows(bp, 2 * half, rng)
    prow[:2] = bp.scvec.from_ints([0, L - 1])
    pwn = signed_digit_words(prow)
    pwn[[5, half + 3]] = np.int32(-0x77777778)  # every digit -8
    pw = torch.from_numpy(pwn).to(dev)
    acc2 = F.from_points([Bpt, Bpt.double()], dev)
    err = 0
    for lo, hi in ((0, half), (half // 3, 0), (half, half), (half, half - 5)):
        got = cc.msm_w4_pair(pts, pw, acc2, half, lo, hi)
        plain = cc.msm_w4_pair_plain(pts, pw, acc2, half, lo, hi)
        err = max(err, point_err(F, got, plain, P))
    assert err == 0, f"msm_w4_pair != plain (err {err})"
    a, b = min(40, half // 2), min(24, half // 2)  # host-checked limits
    got = F.to_points(cc.msm_w4_pair(pts, pw, acc2, half, a, b))
    sc = [bp.Scalar(decode_w4(r) % L) for r in np.concatenate(
        [pwn[:a], pwn[half : half + b]])]
    lo_host = bp.multiscalar_mul(sc[:a], F.to_points(pts[:a])) + Bpt
    hi_host = bp.multiscalar_mul(
        sc[a:], F.to_points(pts[half : half + b])
    ) + Bpt.double()
    assert got[0] == lo_host and got[1] == hi_host, "pair != host MSM"
    records["msm_w4_pair"] = dict(
        max_abs_err=err,
        ms=time_walk(torch, "msm_w4_pair", f"pack {2 * half}",
                     lambda: cc.msm_w4_pair(pts, pw, acc2, half)),
        plain_ms=time_ms(
            torch,
            lambda: cc.msm_w4_pair_plain(pts, pw, acc2, half, half, half), 1,
        ),
        **bounds(msm_w4_ops(pwn, w4_blocks(half, 2), 2),
                 ladder_w4_ops(pwn, 2 * -(-half // 128), 2),
                 2 * half * 160 + 4 * 128),
    )

    # ---- fold_bits: 1024 lanes (the main path's: IPP round 8's G and H
    # folds) and 2048, ones on the left as the IPP folds use, with edge
    # rows: both scalars 0, wl = L - 1, every nibble 8 (digits of -8 and
    # -7), bits 253..255 set (not read)
    err, fold = 0, {}
    for m in FOLD_SIZES:
        left, right = G[:m], G[m : 2 * m]
        srows = random_scalar_rows(bp, m, rng)
        ones = bp.scvec.from_ints([1] * m)
        ones[:3] = bp.scvec.from_ints([0, 0, L - 1])
        srows[:3] = bp.scvec.from_ints([0, 1, 0])
        wln, wrn = bit_words(ones), bit_words(srows)
        wln[3] = wrn[3] = np.int32(-0x77777778)  # 0x88888888
        wln[4, 7] |= np.int32(-0x20000000)  # 0xe0000000: bits 253..255
        wrn[4, 7] |= np.int32(-0x20000000)
        wl = torch.from_numpy(wln).to(dev)
        wr = torch.from_numpy(wrn).to(dev)
        got = cc.fold_bits(left, right, wl, wr)
        plain, pms = timed_once(torch, lambda: cc.fold_bits_plain(left, right, wl, wr))
        e = point_err(F, got, plain, P)
        lanes = list(range(8)) + [m - 1]
        gp = F.to_points(got[lanes])
        lpts, rpts = F.to_points(left[lanes]), F.to_points(right[lanes])
        for j, i in enumerate(lanes):
            want = bp.multiscalar_mul(
                [bp.Scalar(decode_bits(wl[i].tolist()) % (1 << 253) % L),
                 bp.Scalar(decode_bits(wr[i].tolist()) % (1 << 253) % L)],
                [lpts[j], rpts[j]],
            )
            assert gp[j] == want, f"fold_bits {m} lane {i} != host"
        assert gp[0].is_identity(), "fold of two zero scalars is not identity"
        kms = time_ms(torch, lambda: cc.fold_bits(left, right, wl, wr), 5)
        log(f"  fold_bits {m} lanes: kernel {kms:.3f} ms, plain {pms:.1f} ms, "
            f"max_abs_err {e}")
        err = max(err, e)
        fold[m] = (kms, pms, wln, wrn)
    assert err == 0, f"fold_bits != plain (err {err})"
    m = FOLD_SIZES[0]
    kms, pms, wln, wrn = fold[m]
    fops, fkernel, chain_ops = fold_bits_ops(wln, wrn)
    tail = WALKS["msm_w4"][f"n {m}"]["tail_ms"]  # HORNER_OPS dependent operations
    records["fold_bits"] = dict(
        max_abs_err=err, ms=kms, plain_ms=pms,
        ms_2048=fold[2048][0], plain_ms_2048=fold[2048][1],
        **bounds(fops, fold_bits_ladder_ops(wln, wrn), m * (2 * 128 + 2 * 32 + 128),
                 fkernel),
        chain_ops=chain_ops, chain_ms=chain_ops * tail / HORNER_OPS,
    )
    records.update(phase_kernels_w5(bp, torch, cc, F, gens, dev, rng))
    records["msm_lane"] = phase_kernel_lane(bp, torch, cc, F, gens, dev, rng)
    records.update(phase_kernels_comb(bp, torch, cc, F, gens, dev, rng))
    records.update(phase_kernels_flags(bp, torch, cc, F, gens, dev, rng))
    records["msm_grid_local"] = phase_kernel_grid_local(bp, torch, cc, F,
                                                        gens, dev, rng)
    records.update(phase_kernels_oracle(bp, torch, cc, F, gens, dev, rng))
    records.update(phase_kernels_poseidon(bp, torch, cc, F, dev, rng))
    log("walkers " + json.dumps(WALKS))
    phase_fe_mul(bp, torch, cc, F, dev, rng)
    for name, r in records.items():
        r["library_ms"] = None  # no PyTorch call computes these functions
        log(f"  {name}: kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} "
            f"ms, bound {r['bound_ms']:.3f} ms ({r['bound_by']}), "
            f"max_abs_err {r['max_abs_err']}")
    return records


def phase_kernels_w5(bp, torch, cc, F, gens, dev, rng):
    """table_w5 over the 2^18 shared generators and msm_win5 over that
    table at the main path's walks; both exact against their plain
    versions, subsets against the host."""
    from bulletproofs_r1cs_gadgets_tpu_torch.ops.chunks import (
        signed_digit5_bytes,
    )

    P, L = bp.P, bp.L
    N = GENS_N
    records = {}
    pts = F.from_raw(gens.G_raw(N), dev)
    tbl = cc.table_w5(pts)
    plain_tbl, plain_ms = timed_once(torch, lambda: cc.table_w5_plain(pts))
    err = 0
    if not torch.equal(tbl, plain_tbl):  # canonical words: equal or not
        err = max(
            abs(a - b) for a, b in zip(
                F.words_to_ints(tbl.cpu().numpy()),
                F.words_to_ints(plain_tbl.cpu().numpy()),
            )
        )
    assert err == 0, f"table_w5 != plain (err {err})"
    del plain_tbl
    checked = [0, 1, N // 2 + 3, N - 1]
    host_pts = F.to_points(pts[checked])
    for i, p in zip(checked, host_pts):  # entries against the host's (k+1)P
        ints = F.words_to_ints(tbl[i].cpu().numpy())
        for k in range(cc.TBL5):
            want = affine(p.scalar_mul(bp.Scalar(k + 1)), P)
            got = niels_affine(ints[4 * k : 4 * k + 4], P, bp.D2)
            assert got == want, f"table_w5 entry {k + 1}P of point {i}"
    records["table_w5"] = dict(
        max_abs_err=err, ms=time_ms(torch, lambda: cc.table_w5(pts), 5),
        plain_ms=plain_ms,
        **table_bounds(cc.TBL5, N),
    )

    # msm_win5: random scalars with 0, 1, L-1 and fifty -16 digits at the
    # start and the end of every walk's word range
    rows = random_scalar_rows(bp, N, rng)
    edge = bp.scvec.from_ints([0, 1, L - 1, ALL_MINUS_16])
    for at in (0, N // 4, N // 2, N1 - 4, N - 4):
        rows[at : at + 4] = edge
    words = torch.from_numpy(signed_digit5_bytes(rows)).to(dev)
    ident = F.identity_points(1, dev)
    chain = F.from_points([bp.PedersenGens.default().B], dev)
    half, vR = N // 2, N1 - N // 2
    walks = [  # (name, chain, walk): the main path's, then a split walk
        ("phase 1", ident, dict(v=N1)),
        ("round 1 G of L", ident, dict(v=half, poff=half, woff=half)),
        ("round 1 G of R", ident, dict(v=vR)),
        ("verifier", chain, dict(v=N)),
        ("split", chain, dict(v=3 * N // 8, poff=9 * N // 16, woff=N // 4,
                              split=N // 4, poff2=N // 64)),
    ]
    err = 0
    for name, acc, kw in walks:
        kw = dict(v=kw["v"], poff=0, woff=0, split=kw["v"], poff2=0) | kw
        got = cc.msm_win5(tbl, words, acc, **kw)
        plain, ms = timed_once(
            torch, lambda: cc.msm_win5_plain(tbl, words, acc, **kw)
        )
        e = max_abs_err(F.to_points(got), F.to_points(plain), P)
        log(f"  msm_win5 {name} {kw}: plain {ms:.1f} ms, max_abs_err {e}")
        kms = time_walk(torch, "msm_win5", f"{name} (v {kw['v']})",
                        lambda: cc.msm_win5(tbl, words, acc, **kw))
        if name == "phase 1":
            plain_ms, main_ms = ms, kms
        err = max(err, e)
    assert err == 0, f"msm_win5 != plain (err {err})"
    sc = bp.scvec.to_scalars(rows)
    sub, cut = 64, 40  # a split walk over both ends of the table
    got = F.to_points(cc.msm_win5(tbl, words, chain, sub, poff=N - cut,
                                  woff=N - sub, split=cut, poff2=half + 5))
    idx = [N - cut + j if j < cut else half + 5 + j - cut for j in range(sub)]
    host = bp.multiscalar_mul(
        sc[N - sub :] + [bp.Scalar(1)],
        F.to_points(pts[idx]) + [bp.PedersenGens.default().B],
    )
    assert got[0] == host, "msm_win5 != host MSM"
    import numpy as np

    wops, entries = walk_ops(
        _codes(words[:N1].cpu().numpy(), 8, 51), np.arange(N1),
        -(-N1 // 2048), 51, 5,
    )
    records["msm_win5"] = dict(
        max_abs_err=err, ms=main_ms, plain_ms=plain_ms,
        **bound(wops, entries * 128 + N1 * 64 + 2 * 128),
    )
    return records


FE_TEST_N, FE_TEST_REPS = 1 << 20, 64  # operand pairs, products deep


def phase_fe_mul(bp, torch, cc, F, dev, rng) -> dict:
    """The window walkers' carry-chain multiply and squaring (csrc/
    fe25519.cuh fe_mul_cc / fe_sq_cc, through the test entry
    ``cc.fe_mul_test``) against fe_mul / fe_sq over 2^20 operand pairs,
    random words and every pair of the edge values 0, 1, p - 1, p, p + 1,
    2^255, 2^256 - 38 and 2^256 - 1 (values >= p included): equal words
    after the canonical store, one product deep and FE_TEST_REPS deep, and
    equal to Python ints on the edges; then each timed FE_TEST_REPS deep
    (CUDA events).  Returns ms per call and products per second."""
    import numpy as np

    P = bp.P
    n = FE_TEST_N
    edges = [0, 1, P - 1, P, P + 1, 1 << 255, (1 << 256) - 38, (1 << 256) - 1]
    pairs = [(x, y) for x in edges for y in edges]
    raw = np.frombuffer(rng.bytes(64 * n), dtype="<i4").reshape(2, n, 8).copy()
    raw[0, : len(pairs)] = F.ints_to_words([x for x, _ in pairs])
    raw[1, : len(pairs)] = F.ints_to_words([y for _, y in pairs])
    a, b = (torch.from_numpy(raw[k]).to(dev) for k in (0, 1))
    out = {}
    for ref, new in (("fe_mul", "fe_mul_cc"), ("fe_sq", "fe_sq_cc")):
        for reps in (1, FE_TEST_REPS):
            want = cc.fe_mul_test(a, b, ref, reps)
            got = cc.fe_mul_test(a, b, new, reps)
            assert torch.equal(got, want), f"{new} != {ref} ({reps} deep)"
        got = F.words_to_ints(cc.fe_mul_test(a, b, new, 1)[: len(pairs)].cpu().numpy())
        host = [(x * (x if new == "fe_sq_cc" else y)) % P for x, y in pairs]
        assert got == host, f"{new} != Python ints on the edges"
        for op in (ref, new):
            ms = time_ms(torch, lambda: cc.fe_mul_test(a, b, op, FE_TEST_REPS), 5)
            # one warp's chain of FE_TEST_REPS dependent products: latency
            lat = time_ms(torch, lambda: cc.fe_mul_test(
                a[:32], b[:32], op, FE_TEST_REPS), 5)
            out[op] = dict(ms=ms, per_s=n * FE_TEST_REPS / ms * 1e3,
                           latency_ns=lat / FE_TEST_REPS * 1e6)
    log("fe_mul_test " + json.dumps(out) + f" ({n} x {FE_TEST_REPS} products)")
    return out


def phase_kernel_lane(bp, torch, cc, F, gens, dev, rng):
    """msm_lane over 16 segments of 2048 points (the batch of 8's
    flotilla) with rows 0, 1, L - 1 and all -8 digits, an all-zero
    segment and a last segment identity-padded past two thirds as
    ``ck.flotilla_pack`` pads (zero words); over 24 segments (the
    reference's batch of 12); three small segments against the host MSM.
    Exact by group element (``point_err``): the windowed order gives other
    projective coordinates than the plain ladder."""
    import numpy as np

    from bulletproofs_r1cs_gadgets_tpu_torch.ops.chunks import (
        signed_digit_words,
    )

    P, L = bp.P, bp.L
    seg = LANE_SEG
    n = LANE_V12 * seg
    pts = F.from_raw(gens.H_raw(n), dev)
    rows = random_scalar_rows(bp, n, rng)
    rows[:3] = bp.scvec.from_ints([0, 1, L - 1])
    wn = signed_digit_words(rows)
    wn[3] = np.int32(-0x77777778)  # 0x88888888: every digit -8
    zseg = LANE_V // 3
    wn[zseg * seg : (zseg + 1) * seg] = 0
    tail = (LANE_V - 1) * seg + 2 * seg // 3  # identity padding, zero words
    pts[tail : LANE_V * seg] = F.identity_points(LANE_V * seg - tail, dev)
    wn[tail : LANE_V * seg] = 0
    words = torch.from_numpy(wn).to(dev)
    err, ms, plain_ms = 0, {}, {}
    for v in (LANE_V, LANE_V12):
        pv, wv = pts[: v * seg], words[: v * seg]
        got = cc.msm_lane(pv, wv, v)
        plain, plain_ms[v] = timed_once(torch, lambda: cc.msm_lane_plain(pv, wv, v))
        e = point_err(F, got, plain, P)
        log(f"  msm_lane {v} x {seg}: plain {plain_ms[v]:.1f} ms, max_abs_err {e}")
        err = max(err, e)
        assert F.to_points(got[zseg : zseg + 1])[0].is_identity(), \
            "all-zero segment is not the identity"
        ms[v] = time_walk(torch, "msm_lane", f"{v} x {seg}",
                          lambda: cc.msm_lane(pv, wv, v))
    assert err == 0, f"msm_lane != plain (err {err})"
    sub = 24  # three small segments against the host MSM
    small = F.to_points(cc.msm_lane(pts[: 3 * sub].contiguous(),
                                    words[: 3 * sub].contiguous(), 3))
    sc = [bp.Scalar(decode_w4(r) % L) for r in words[: 3 * sub].tolist()]
    host_pts = F.to_points(pts[: 3 * sub])
    for s in range(3):
        want = bp.multiscalar_mul(sc[s * sub : (s + 1) * sub],
                                  host_pts[s * sub : (s + 1) * sub])
        assert small[s] == want, f"msm_lane segment {s} != host MSM"
    w16 = wn[: LANE_V * seg]
    return dict(
        max_abs_err=err, ms=ms[LANE_V], plain_ms=plain_ms[LANE_V],
        ms_24=ms[LANE_V12], plain_ms_24=plain_ms[LANE_V12],
        **bounds(msm_w4_ops(w16, w4_blocks(seg, LANE_V), LANE_V, chained=False),
                 ladder_w4_ops(w16, LANE_V * -(-seg // 128), LANE_V),
                 LANE_V * seg * 160 + LANE_V * 128),
    )


def fold_w3h_ops(ck, pairs, brk: int, v: int, ladder: bool = False) -> dict:
    """fold_w3h point operations for v outputs, pair 0 below brk: two
    4-entry niels tables (2 doublings with T, 1 niels add and 4 2dT
    multiplies each) and the shared ladder from the top nonzero digit (3
    doublings a window, T on the third; one niels add a nonzero digit
    after the first).  `ladder`: the count of the first version (full
    doublings and adds, extended tables), the bound it was held to."""
    ops = dict(dbl=0, add=0) if ladder else dict(sq=0, fe=0, nadd=0)
    for (alpha, beta), count in zip(pairs, (brk, v - brk)):
        cb = _codes(ck.w3h_digit_words(beta)[None], 4, 44) & 7
        ca = _codes(ck.w3h_digit_words(alpha)[None], 4, 44) & 7
        lad, _ = ladder_ops(cb | ca, 3)
        adds = max(int((cb != 0).sum() + (ca != 0).sum()) - 1, 0)
        if ladder:
            ops["dbl"] += count * (lad["dbl"] + 4)
            ops["add"] += count * (adds + 2)
            continue
        dbl = lad["dbl"] + 4
        ops["sq"] += count * 4 * dbl
        ops["fe"] += count * (3 * dbl + lad["dbl"] // 3 + 4 + 8)
        ops["nadd"] += count * (adds + 2)
    return ops


def phase_kernels_comb(bp, torch, cc, F, gens, dev, rng):
    """The combined-layout kernels at the main path's shapes: fold_w3h
    over the 2^18 generators into 2^17 (the round-1 transition), with
    pairs from half_gcd_split of random constants and with the edge pairs
    (0, 1) and (1, -1); fold_w3h_comb over a 2^18-point combined tensor;
    table_w4 over 2^18 points; msm_win_pair at IPP rounds 2 (n = 2^16)
    and 7 (n = 2048).  Each exact against its plain version on the same
    CUDA tensors, subsets against the host."""
    import numpy as np

    from bulletproofs_r1cs_gadgets_tpu_torch.ops import chunks as ck

    P, L = bp.P, bp.L
    N = GENS_N
    records = {}
    G = F.from_raw(gens.G_raw(N), dev)
    H = F.from_raw(gens.H_raw(N), dev)

    def rand_pair():
        return ck.half_gcd_split(
            int.from_bytes(rng.bytes(32), "little") % L, L
        )

    def host_fold(got, src, pairs, brk, lanes):
        v = src.shape[0] // 2
        gp = F.to_points(got[lanes])
        lp = F.to_points(src[lanes])
        rp = F.to_points(src[[i + v for i in lanes]])
        for j, i in enumerate(lanes):
            alpha, beta = pairs[0] if i < brk else pairs[1]
            want = bp.multiscalar_mul(
                [bp.Scalar(beta % L), bp.Scalar(alpha % L)], [lp[j], rp[j]]
            )
            assert gp[j] == want, f"fold lane {i} != host"

    # ---- fold_w3h: G(2^18) -> 2^17, split at round 1's breakpoint
    v = N // 2
    main = ([rand_pair(), rand_pair()], N1 - v)
    err = 0
    for name, (pairs, brk) in (("random", main),
                               ("edge", ([(0, 1), (1, -1)], v // 3))):
        words = ck.w3h_fold_words([pairs], dev)
        got = cc.fold_w3h(G, words, brk)
        plain, ms = timed_once(torch, lambda: cc.fold_w3h_plain(G, words, brk))
        e = point_err(F, got, plain, P)
        log(f"  fold_w3h {name} pairs, bp {brk}: plain {ms:.1f} ms, "
            f"max_abs_err {e}")
        err = max(err, e)
        host_fold(got, G, pairs, brk, [0, 1, brk - 1, brk, v - 1])
        if name == "random":
            fw, fms = words, ms
    assert err == 0, f"fold_w3h != plain (err {err})"
    records["fold_w3h"] = dict(
        max_abs_err=err, ms=time_ms(torch, lambda: cc.fold_w3h(G, fw, main[1]), 5),
        plain_ms=fms,
        **bounds(fold_w3h_ops(ck, *main, v), fold_w3h_ops(ck, *main, v, True),
                 v * 3 * 128 + fw.numel() * 4),
    )
    del plain

    # ---- fold_w3h_comb: [G(2^17) | H(2^17)] -> [G'(2^16) | H'(2^16)]
    # (IPP round 2), then [G(2^12) | H(2^12)] -> [G'(2^11) | H'(2^11)]
    # (round 7) with one side on the edge pairs; breakpoints inside a block
    round2 = [[rand_pair(), rand_pair()], [rand_pair(), rand_pair()]]
    round7 = [[rand_pair(), rand_pair()], [(0, 1), (1, -1)]]
    for m, sides in ((N // 4, round2), (COMB7_M, round7)):
        C = torch.cat([G[: 2 * m], H[: 2 * m]])
        brk = m // 5
        words = ck.w3h_fold_words(sides, dev)
        got = cc.fold_w3h_comb(C, words, brk)
        plain, ms = timed_once(
            torch, lambda: cc.fold_w3h_comb_plain(C, words, brk))
        err = point_err(F, got, plain, P)
        kms = time_ms(torch, lambda: cc.fold_w3h_comb(C, words, brk), 5)
        log(f"  fold_w3h_comb {4 * m} -> {2 * m} points, bp {brk}: kernel "
            f"{kms:.3f} ms, plain {ms:.1f} ms, max_abs_err {err}")
        assert err == 0, f"fold_w3h_comb != plain (err {err})"
        for s_ in (0, 1):  # each side equals fold_w3h of that side, word for word
            one = cc.fold_w3h(C[2 * m * s_ : 2 * m * (s_ + 1)],
                              words[s_ : s_ + 1].contiguous(), brk)
            assert torch.equal(got[m * s_ : m * (s_ + 1)], one), \
                f"fold_w3h_comb side {s_} != fold_w3h"
        host_fold(got[m:], C[2 * m :], sides[1], brk, [0, brk, m - 1])
        if m == N // 4:
            cops = fold_w3h_ops(ck, sides[0], brk, m)
            was = fold_w3h_ops(ck, sides[0], brk, m, ladder=True)
            for ops, ladder in ((cops, False), (was, True)):
                for k, val in fold_w3h_ops(ck, sides[1], brk, m, ladder).items():
                    ops[k] += val
            records["fold_w3h_comb"] = dict(
                max_abs_err=err, ms=kms, plain_ms=ms,
                **bounds(cops, was, 2 * m * 3 * 128 + words.numel() * 4),
            )
        del plain, got

    # ---- table_w4 over 2^18 points (rebuilt in place of a bigger table)
    tbl = cc.table_w4(G)
    plain_tbl, ms = timed_once(torch, lambda: cc.table_w4_plain(G))
    err = 0 if torch.equal(tbl, plain_tbl) else 1
    assert err == 0, "table_w4 != plain"
    del plain_tbl
    assert torch.equal(tbl, cc.table_w5(G)[:, : cc.TBL4]), \
        "table_w4 != the first 8 entries of table_w5"
    spare = torch.empty_like(tbl)
    again = cc.table_w4(G[N // 2 :], out=spare)
    assert again.data_ptr() == spare.data_ptr()
    assert torch.equal(again, tbl[N // 2 :]), "table_w4 into `out` differs"
    del spare, again
    checked = [0, N // 3, N - 1]
    for i, p in zip(checked, F.to_points(G[checked])):
        ints = F.words_to_ints(tbl[i].cpu().numpy())
        for k in range(cc.TBL4):
            want = affine(p.scalar_mul(bp.Scalar(k + 1)), P)
            got = niels_affine(ints[4 * k : 4 * k + 4], P, bp.D2)
            assert got == want, f"table_w4 entry {k + 1}P of point {i}"
    by_n = {}
    for k in TABLE_SIZES:  # the round-1 transition, then rounds 2-6
        Gk = G[:k]
        by_n[str(k)] = time_ms(torch, lambda: cc.table_w4(Gk), 5)
    log("  table_w4 ms by points " + json.dumps(by_n))
    records["table_w4"] = dict(
        max_abs_err=err, ms=by_n[str(N)], plain_ms=ms, ms_by_points=by_n,
        **table_bounds(cc.TBL4, N),
    )

    # ---- msm_win_pair: rounds 2 and 7 over the table of [G'|H'] (4n
    # points), random scalars with edge rows at both walks' ends
    chain2 = F.from_points([bp.PedersenGens.default().B,
                            bp.PedersenGens.default().B.double()], dev)
    err = 0
    for n in COMB_N:
        rows = random_scalar_rows(bp, 4 * n, rng)
        edge = bp.scvec.from_ints([0, 1, L - 1, L - 1])
        for at in (0, n - 2, 2 * n - 2, 3 * n, 4 * n - 4):
            rows[at : at + len(edge)] = edge[: min(len(edge), 4 * n - at)]
        wn = ck.signed_digit_words(rows)
        wn[3] = np.int32(-0x77777778)  # 0x88888888: every digit -8
        words = torch.from_numpy(wn).to(dev)
        t = tbl[: 4 * n]
        walks = ck.comb_walks(n)
        got = cc.msm_win_pair(t, words, chain2, walks)
        plain, ms = timed_once(
            torch, lambda: cc.msm_win_pair_plain(t, words, chain2, walks)
        )
        e = max_abs_err(F.to_points(got), F.to_points(plain), P)
        log(f"  msm_win_pair n {n}: plain {ms:.1f} ms, max_abs_err {e}")
        err = max(err, e)
        kms = time_walk(torch, "msm_win_pair", f"n {n}",
                        lambda: cc.msm_win_pair(t, words, chain2, walks))
        if n == COMB_N[0]:
            main_plain_ms, main_n, main_wn, main_ms = ms, n, wn, kms
    assert err == 0, f"msm_win_pair != plain (err {err})"
    sub = 16  # both walks over a 4 * 16-point table against the host
    rows = random_scalar_rows(bp, 4 * sub, rng)
    rows[:2] = bp.scvec.from_ints([0, L - 1])
    words = torch.from_numpy(ck.signed_digit_words(rows)).to(dev)
    got = F.to_points(cc.msm_win_pair(tbl[: 4 * sub].contiguous(), words,
                                      chain2, ck.comb_walks(sub)))
    sc, pts = bp.scvec.to_scalars(rows), F.to_points(G[: 4 * sub])
    B = bp.PedersenGens.default().B
    want_L = bp.multiscalar_mul(sc[: 2 * sub], pts[sub : 3 * sub]) + B
    want_R = (bp.multiscalar_mul(sc[2 * sub : 3 * sub], pts[:sub])
              + bp.multiscalar_mul(sc[3 * sub :], pts[3 * sub :]) + B.double())
    assert got[0] == want_L and got[1] == want_R, "msm_win_pair != host MSM"
    n = main_n
    walks = ck.comb_walks(n)
    t = tbl[: 4 * n]
    pops, entries = dict(nadd=0, add=0, dbl=0), 0
    for k, (wv, poff, woff, split, poff2) in enumerate(walks):
        j = np.arange(wv)
        prow = np.where(j < split, poff + j, poff2 + j - split)
        o, e_ = walk_ops(_codes(main_wn[woff : woff + wv], 4, 64), prow,
                         -(-wv // 2048), 64, 4)
        for key in pops:
            pops[key] += o[key]
        entries += e_
    records["msm_win_pair"] = dict(
        max_abs_err=err, ms=main_ms, plain_ms=main_plain_ms,
        **bound(pops, entries * 128 + 4 * n * 32 + 4 * 128),
    )
    return records


def fold_c_ops(codes_pairs, brk: int, v: int) -> tuple[dict, dict, dict]:
    """(the function's work, the thread design's own work, the first
    version's ladder work) of fold_c for v outputs, constant 0 below brk
    (csrc/msm_fold.cu).  The function, per output of a nonzero constant:
    an 8-entry niels table by the TPU tables' sequence (4 doublings with
    T, 3 niels adds, 8 2dT multiplies), 4 doublings a window below the
    top nonzero digit (T on the 4th), a niels add per nonzero digit after
    the first, and P[i] in niels form (its 2dT and an add); for a zero
    constant nothing (out = P[i]).  The thread design, per output: its
    table (a doubling with T, 6 niels adds, 9 2dT with P[i]'s), the same
    doublings, and an add per nonzero digit and for P[i].  The ladder: the
    first version's w4 ladder from the top digit with its 7-operation
    table, and the final add."""
    ops, kernel = dict(sq=0, fe=0, nadd=0), dict(sq=0, fe=0, nadd=0)
    ladder = dict(dbl=0, add=0)
    for codes, count in zip(codes_pairs, (brk, v - brk)):
        lad, live = ladder_ops(codes[None], 4)
        dbl, nnz = lad["dbl"], lad["add"] + live
        if live:
            ops["sq"] += count * 4 * (dbl + 4)
            ops["fe"] += count * (3 * dbl + dbl // 4 + 4 * 4 + 8 + 1)
            ops["nadd"] += count * (3 + nnz - 1 + 1)
        kernel["sq"] += count * 4 * (dbl + 1)
        kernel["fe"] += count * (3 * dbl + dbl // 4 + 4 + 9)
        kernel["nadd"] += count * (6 + nnz + 1)
        ladder["dbl"] += count * (dbl + 4)
        ladder["add"] += count * (lad["add"] + 3 + 1)
    return ops, kernel, ladder


def phase_kernels_flags(bp, torch, cc, F, gens, dev, rng):
    """FLAG_KERNELS, the kernels of the reference's route flags, at those
    routes' shapes: fold_c over the 2^18 generators into 2^17 (random
    constants split at round 1's breakpoint; the edge constants 0, 1,
    L - 1; the in-place form) and over 4096 into 2048 (padded n = 4096's
    round 1); fold_c_comb over a 2^18-point combined tensor; msm_win over
    a 2^18-point combined table at round 2's L walk and R wrap walk and
    over the table_w4 of the 2^18 shared generators at phase 1's 143,704
    points; msm_grid over 143,704 generators at offset 0 and at a chunk
    offset.  Each exact against its plain version on the same CUDA
    tensors, subsets against the host; each must have launched here."""
    import numpy as np

    from bulletproofs_r1cs_gadgets_tpu_torch.ops import chunks as ck

    before = dict(cc.LAUNCHES)

    P, L = bp.P, bp.L
    N = GENS_N
    records = {}
    G = F.from_raw(gens.G_raw(N), dev)
    H = F.from_raw(gens.H_raw(N), dev)
    B = bp.PedersenGens.default().B

    def rand_const():
        return bp.Scalar(int.from_bytes(rng.bytes(32), "little") % L)

    def host_fold(got, src, consts, brk, lanes):
        v = src.shape[0] // 2
        gp = F.to_points(got[lanes])
        lp = F.to_points(src[lanes])
        rp = F.to_points(src[[i + v for i in lanes]])
        for j, i in enumerate(lanes):
            c = consts[0] if i < brk else consts[1]
            assert gp[j] == lp[j] + rp[j].scalar_mul(c), f"fold_c lane {i} != host"

    def words_codes(words):
        return _codes(words.reshape(-1, 8).cpu().numpy(), 4, 64)

    # ---- fold_c: G(2^18) -> 2^17 at round 1's breakpoint; edges; 4096
    # (padded n = 4096's round 1, the default route: its own record);
    # each case in place too, the two shapes under both designs
    v = N // 2
    main = ((rand_const(), rand_const()), N1 - v)
    small = ((rand_const(), rand_const()), 1500)
    cases = [
        ("random", G, main),
        ("edge 0 / 1", G, ((bp.Scalar(0), bp.Scalar(1)), v // 3)),
        ("edge L-1 / 1", G, ((bp.Scalar(L - 1), bp.Scalar(1)), 2 * v // 3)),
        ("padded 4096", G[: 2 * FOLD_C_V], small),
        ("padded 4096, bp in a warp", G[: 2 * FOLD_C_V], (small[0], 1501)),
    ]
    err, shape = 0, {}
    for name, src, (consts, brk) in cases:
        words = ck.c_fold_words([consts], dev)
        half = src.shape[0] // 2
        got = cc.fold_c(src, words, brk)
        plain, ms = timed_once(torch, lambda: cc.fold_c_plain(src, words, brk))
        e = point_err(F, got, plain, P)
        kms = time_ms(torch, lambda: cc.fold_c(src, words, brk), 5)
        design = cc.fold_c_design(dev, half)
        log(f"  fold_c {name} ({src.shape[0]} -> {half}), bp {brk}, {design}: "
            f"kernel {kms:.3f} ms, plain {ms:.1f} ms, max_abs_err {e}")
        err = max(err, e)
        host_fold(got, src, consts, brk, [0, 1, brk - 1, brk, half - 1])
        for d in cc.FOLD_C_DESIGNS:
            own = src.clone()  # in place: out = the input's first half
            cc.fold_c(own, words, brk, out=own[:half], design=d)
            want = got if d == design else cc.fold_c(src, words, brk, design=d)
            assert torch.equal(own[:half], want), f"fold_c {d} in place differs"
            e = point_err(F, want, plain, P)
            assert e == 0, f"fold_c {name} {d} != plain (err {e})"
        del own
        if name in ("random", "padded 4096"):
            shape[half] = dict(
                words=words, brk=brk, ms=kms, plain_ms=ms, design=design,
                design_ms={d: time_ms(torch, lambda: cc.fold_c(
                    src, words, brk, design=d), 5) for d in cc.FOLD_C_DESIGNS})
            log(f"    by design: {shape[half]['design_ms']}")
    assert err == 0, f"fold_c != plain (err {err})"
    del plain

    def fold_c_bounds(words, brk, v, sides=1):
        codes = words_codes(words)
        ops, kernel, ladder = fold_c_ops(codes[:2], brk, v)
        for side in range(1, sides):
            more = fold_c_ops(codes[2 * side : 2 * side + 2], brk, v)
            for mine, add in zip((ops, kernel, ladder), more):
                for k, val in add.items():
                    mine[k] += val
        return bounds(ops, ladder, sides * v * 3 * 128 + words.numel() * 4, kernel)

    big, pad = shape[v], shape[FOLD_C_V]
    small_bounds = fold_c_bounds(pad["words"], pad["brk"], FOLD_C_V)
    records["fold_c"] = dict(
        max_abs_err=err, ms=big["ms"], plain_ms=big["plain_ms"],
        design=big["design"], design_ms=big["design_ms"],
        ms_2048=pad["ms"], plain_ms_2048=pad["plain_ms"], design_2048=pad["design"],
        design_ms_2048=pad["design_ms"], bound_ms_2048=small_bounds["bound_ms"],
        bound_ladder_ms_2048=small_bounds["bound_ladder_ms"],
        **fold_c_bounds(big["words"], big["brk"], v),
    )

    # ---- fold_c_comb: [G(2^17) | H(2^17)] -> [G'(2^16) | H'(2^16)], both
    # designs; each side equals fold_c of that side under the same design
    m = N // 4
    C = torch.cat([G[: 2 * m], H[: 2 * m]])
    sides = [(rand_const(), rand_const()), (rand_const(), rand_const())]
    brk = m // 5
    words = ck.c_fold_words(sides, dev)
    got = cc.fold_c_comb(C, words, brk)
    plain, ms = timed_once(torch, lambda: cc.fold_c_comb_plain(C, words, brk))
    err = point_err(F, got, plain, P)
    design = cc.fold_c_design(dev, 2 * m)
    log(f"  fold_c_comb ({design}): plain {ms:.1f} ms, max_abs_err {err}")
    assert err == 0, f"fold_c_comb != plain (err {err})"
    for d in cc.FOLD_C_DESIGNS:
        both = got if d == design else cc.fold_c_comb(C, words, brk, design=d)
        e = point_err(F, both, plain, P)
        assert e == 0, f"fold_c_comb {d} != plain (err {e})"
        for s_ in (0, 1):  # each side equals fold_c of that side, word for word
            one = cc.fold_c(C[2 * m * s_ : 2 * m * (s_ + 1)],
                            words[s_ : s_ + 1].contiguous(), brk, design=d)
            assert torch.equal(both[m * s_ : m * (s_ + 1)], one), \
                f"fold_c_comb {d} side {s_} != fold_c"
    host_fold(got[m:], C[2 * m :], sides[1], brk, [0, brk, m - 1])
    records["fold_c_comb"] = dict(
        max_abs_err=err,
        ms=time_ms(torch, lambda: cc.fold_c_comb(C, words, brk), 5),
        plain_ms=ms, design=design,
        **fold_c_bounds(words, brk, m, sides=2),
    )
    del plain, got, C, both

    # ---- msm_win: round 2's walks over the combined table, phase 1's
    # walk over the w4 table of the shared generators
    n = N // 4
    t_comb = cc.table_w4(torch.cat([G[: 2 * n], H[: 2 * n]]))
    rows = random_scalar_rows(bp, 4 * n, rng)
    edge = bp.scvec.from_ints([0, 1, L - 1, L - 1])
    for at in (0, 2 * n - 2, 2 * n, 4 * n - 4):
        rows[at : at + len(edge)] = edge
    wn = ck.signed_digit_words(rows)
    wn[3] = np.int32(-0x77777778)  # 0x88888888: every digit -8
    cw = torch.from_numpy(wn).to(dev)
    walk_L, walk_R = ck.comb_walks(n)
    t_shared = cc.table_w4(G)
    srows = random_scalar_rows(bp, N1, rng)
    srows[:3] = edge[:3]
    sw = torch.from_numpy(ck.signed_digit_words(srows)).to(dev)
    ident = F.identity_points(1, dev)
    chain = F.from_points([B], dev)
    walks = [  # (name, table, words, chain, walk)
        ("round 2 L", t_comb, cw, ident, walk_L),
        ("round 2 R wrap", t_comb, cw, chain, walk_R),
        ("phase 1", t_shared, sw, ident, (N1, 0, 0, N1, 0)),
    ]
    err = 0
    for name, tbl, words, acc, walk in walks:
        got = cc.msm_win(tbl, words, acc, *walk)
        plain, ms = timed_once(
            torch, lambda: cc.msm_win_plain(tbl, words, acc, *walk)
        )
        e = max_abs_err(F.to_points(got), F.to_points(plain), P)
        log(f"  msm_win {name} {walk}: plain {ms:.1f} ms, max_abs_err {e}")
        kms = time_walk(torch, "msm_win", f"{name} (v {walk[0]})",
                        lambda: cc.msm_win(tbl, words, acc, *walk))
        err = max(err, e)
        if name == "phase 1":
            main_ms, main_plain_ms = kms, ms
    assert err == 0, f"msm_win != plain (err {err})"
    sub, cut = 48, 20  # a wrap walk over both ends of the shared table
    got = F.to_points(cc.msm_win(t_shared, sw, chain, sub, N - cut, 0, cut,
                                 N // 2 + 3))
    idx = [N - cut + j if j < cut else N // 2 + 3 + j - cut for j in range(sub)]
    host = bp.multiscalar_mul(
        bp.scvec.to_scalars(srows[:sub]) + [bp.Scalar(1)],
        F.to_points(G[idx]) + [B],
    )
    assert got[0] == host, "msm_win != host MSM"
    wops, entries = walk_ops(_codes(sw.cpu().numpy(), 4, 64), np.arange(N1),
                             -(-N1 // 2048), 64, 4)
    records["msm_win"] = dict(
        max_abs_err=err, ms=main_ms, plain_ms=main_plain_ms,
        **bound(wops, entries * 128 + N1 * 32 + 2 * 128),
    )
    del t_comb, t_shared

    # ---- msm_grid: phase 1's 143,704 generators, at offset 0 and at a
    # chunk offset, chained
    gw = sw  # phase 1's words
    err = 0
    for poff in (0, 2048):
        got = cc.msm_grid(G, gw, chain, poff)
        plain, ms = timed_once(
            torch, lambda: cc.msm_grid_plain(G, gw, chain, poff)
        )
        e = max_abs_err(F.to_points(got), F.to_points(plain), P)
        log(f"  msm_grid {N1} points at offset {poff}: plain {ms:.1f} ms, "
            f"max_abs_err {e}")
        err = max(err, e)
        if poff == 0:
            grid_plain_ms = ms
    assert err == 0, f"msm_grid != plain (err {err})"
    sub = 64
    got = F.to_points(cc.msm_grid(G, gw[:sub].contiguous(), chain, 2048 + 7))
    host = bp.multiscalar_mul(
        bp.scvec.to_scalars(srows[:sub]) + [bp.Scalar(1)],
        F.to_points(G[2048 + 7 : 2048 + 7 + sub]) + [B],
    )
    assert got[0] == host, "msm_grid != host MSM"
    records["msm_grid"] = dict(
        max_abs_err=err,
        ms=time_walk(torch, "msm_grid", f"v {N1}",
                     lambda: cc.msm_grid(G, gw, chain, 0)),
        plain_ms=grid_plain_ms,
        **bounds(msm_w4_ops(gw.cpu().numpy(), w4_blocks(N1)),
                 ladder_w4_ops(gw.cpu().numpy(), -(-N1 // 128)),
                 N1 * 160 + 2 * 128),
    )
    for name in FLAG_KERNELS:
        assert cc.LAUNCHES[name] > before[name], f"kernel {name} not launched"
    return records


def phase_kernel_grid_local(bp, torch, cc, F, gens, dev, rng):
    """msm_grid_local over one phase-8 shard (32 chunks = 65,536 of the
    2^18 generators, random words with edge rows, nonzero past every
    valid span) at valid 32, 7 and 0, chained on B; exact against its
    plain version, and a small shard against the host MSM."""
    from bulletproofs_r1cs_gadgets_tpu_torch.ops import chunks as ck

    P, L = bp.P, bp.L
    chunk = ck.CHUNK
    n = SHARD_CHUNKS * chunk
    B = bp.PedersenGens.default().B
    pts = F.from_raw(gens.G_raw(n), dev)
    rows = random_scalar_rows(bp, n, rng)
    edge = bp.scvec.from_ints([0, 1, L - 1, L - 1])
    for at in (0, 7 * chunk - 2, n - 4):
        rows[at : at + len(edge)] = edge
    words = ck.w4_words(rows, dev)
    acc = F.from_points([B], dev)
    err, plain_ms = 0, None
    for valid in (SHARD_CHUNKS, 7, 0):
        got = cc.msm_grid_local(pts, words, acc, valid, chunk)
        plain, ms = timed_once(
            torch, lambda: cc.msm_grid_local_plain(pts, words, acc, valid,
                                                   chunk)
        )
        e = max_abs_err(F.to_points(got), F.to_points(plain), P)
        kms = time_walk(torch, "msm_grid_local", f"{valid} valid chunks",
                        lambda: cc.msm_grid_local(pts, words, acc, valid, chunk))
        log(f"  msm_grid_local {n} points, {valid} valid chunks: kernel "
            f"{kms:.3f} ms, plain {ms:.1f} ms, max_abs_err {e}")
        err = max(err, e)
        if valid == SHARD_CHUNKS:
            main_ms, plain_ms = kms, ms
    assert err == 0, f"msm_grid_local != plain (err {err})"
    assert F.to_points(cc.msm_grid_local(pts, words, acc, 0, chunk))[0] == B
    sub = 16  # four 16-point chunks, three valid, against the host
    got = F.to_points(cc.msm_grid_local(pts[: 4 * sub].contiguous(),
                                        words[: 4 * sub].contiguous(), acc,
                                        3, sub))
    host = bp.multiscalar_mul(bp.scvec.to_scalars(rows[: 3 * sub]) + [bp.Scalar(1)],
                              F.to_points(pts[: 3 * sub]) + [B])
    assert got[0] == host, "msm_grid_local != host MSM"
    return dict(
        max_abs_err=err, ms=main_ms, plain_ms=plain_ms,
        **bounds(msm_w4_ops(words.cpu().numpy(), w4_blocks(n)),
                 ladder_w4_ops(words.cpu().numpy(), -(-n // 128)),
                 n * 160 + 2 * 128),
    )


def proof_digest(comms, proof) -> dict:
    """SHA-256 of the commitments (compressed, concatenated) and of the
    proof bytes: the golden file's keys."""
    import hashlib

    raw = proof.to_bytes()
    return {
        "commitments_sha256": hashlib.sha256(b"".join(comms)).hexdigest(),
        "proof_sha256": hashlib.sha256(raw).hexdigest(),
        "proof_len": len(raw),
    }


class combined_off:
    """Within the block, TorchBackend's IPP skips the combined layout (its
    threshold, the module constant COMB_MIN_N, above the padded size):
    rounds 2+ take the chunk-list route (``msm_w4`` + ``fold_bits``)."""

    def __enter__(self):
        from bulletproofs_r1cs_gadgets_tpu_torch.ops import torch_backend

        self.mod, self.old = torch_backend, torch_backend.COMB_MIN_N
        torch_backend.COMB_MIN_N = 2 * GENS_N
        return self

    def __exit__(self, *exc):
        self.mod.COMB_MIN_N = self.old
        return False


def phase_bytes(bp, torch, cc, gens_small):
    params, tree = build_tree(bp, SMALL_DEPTH)
    backend = bp.TorchBackend("cuda")
    comp, tape, comms, prover = synthesize(bp, params, tree, SMALL_DEPTH, 11)
    log(f"  depth {SMALL_DEPTH}: {prover.num_multipliers()} multipliers")
    cc.reset_launches()
    t0 = time.time()
    proof_dev = prover.prove(gens_small, backend=backend)
    torch.cuda.synchronize()
    log(f"  port prove {time.time() - t0:.2f} s")
    # padded n = 4096: round 1 folds each side with fold_c
    # (pallas_backend.py:1069-1076)
    assert cc.LAUNCHES["fold_c"] == 2, "round 1 did not run fold_c"
    comp, tape, comms_h, prover_h = synthesize(
        bp, params, tree, SMALL_DEPTH, 11
    )
    t0 = time.time()
    proof_host = prover_h.prove(gens_small, backend=None)
    log(f"  host prove {time.time() - t0:.2f} s")
    assert comms == comms_h
    assert proof_dev.to_bytes() == proof_host.to_bytes(), \
        "port proof bytes differ from the host path"
    log(f"  proof bytes identical ({len(proof_dev.to_bytes())} B)")
    with open(GOLDEN) as f:
        golden = json.load(f)
    got = proof_digest(comms, proof_dev)
    for key in ("commitments_sha256", "proof_sha256", "proof_len"):
        assert got[key] == golden[key], \
            f"{key} {got[key]} != the JAX package's {golden[key]}"
    log(f"  digest equals the JAX package's golden digest "
        f"({golden['proof_sha256'][:16]}...)")
    verify(bp, comp, tape, comms, proof_dev, gens_small, backend)
    verify(bp, comp, tape, comms, proof_dev, gens_small, None)
    log("  verified by the port's and the host verifier")

    # a batch of three: proof 0 is the prover above (its host proof just
    # matched); proofs 1 and 2 are held against their provers proved alone
    # through the port
    specs = [(7, 11), (3, 21), (9, 31)]  # (leaf, rng seed)
    circuit = (comp, tape)
    alone = [proof_dev] + [
        synthesize(bp, params, tree, SMALL_DEPTH, seed, leaf, circuit)[3]
        .prove(gens_small, backend=backend)
        for leaf, seed in specs[1:]
    ]
    provers = [
        synthesize(bp, params, tree, SMALL_DEPTH, seed, leaf, circuit)[3]
        for leaf, seed in specs
    ]
    lanes = cc.LAUNCHES["msm_lane"]
    t0 = time.time()
    batch = bp.prove_provers(provers, gens_small, backend=backend,
                             host_workers=1)
    torch.cuda.synchronize()
    log(f"  batch of {len(batch)} through prove_provers "
        f"{time.time() - t0:.2f} s, "
        f"{cc.LAUNCHES['msm_lane'] - lanes} flotilla rounds")
    assert cc.LAUNCHES["msm_lane"] > lanes, "no flotilla round ran"
    for i, (got, want) in enumerate(zip(batch, alone)):
        assert got.to_bytes() == want.to_bytes(), \
            f"batched proof {i} differs from the prover proved alone"
    log("  batched proofs byte-identical to the provers proved alone")
    return dict(cc.LAUNCHES)


def phase_full(bp, torch, cc, gens, params, tree):
    out = {}
    t0 = time.time()
    comp, tape, comms, prover = synthesize(bp, params, tree, DEPTH)
    out["setup_s"] = time.time() - t0
    log(f"  depth {DEPTH}: {prover.num_multipliers()} multipliers, "
        f"tree + synthesis {out['setup_s']:.2f} s")
    snap = prover.snapshot()
    backend = bp.TorchBackend("cuda")
    torch.cuda.reset_peak_memory_stats()
    cc.reset_launches()
    t0 = time.time()
    proof = prover.prove(gens, backend=backend)
    torch.cuda.synchronize()
    out["cold_prove_s"] = time.time() - t0
    t0 = time.time()
    verify(bp, comp, tape, comms, proof, gens, backend)
    torch.cuda.synchronize()
    out["verify_s"] = time.time() - t0
    warm = []
    for _ in range(2):
        prover.restore(snap)
        t0 = time.time()
        prover.prove(gens, backend=backend)
        torch.cuda.synchronize()
        warm.append(time.time() - t0)
    out["warm_prove_s"] = warm
    out["launches"] = dict(cc.LAUNCHES)
    check_route("default", out["launches"], verify=True)
    out["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    log(f"  cold prove {out['cold_prove_s']:.2f} s, warm "
        f"{warm[0]:.2f} / {warm[1]:.2f} s, verify {out['verify_s']:.2f} s, "
        f"peak device memory {out['peak_mem_bytes']} B")
    log(f"  launches {out['launches']}")
    for name, count in out["launches"].items():  # the default route's
        assert count > 0 or name in ("msm_lane", "msm_grid_local") \
            or name in FLAG_KERNELS or name in ORACLE_KERNELS, \
            f"kernel {name} was not launched on the single-proof path"
    out["routes"], out["route_launches"], route_bytes = phase_full_routes(
        bp, torch, cc, gens, prover, snap
    )

    # negative cases: a flipped proof byte (the IPP's `a` scalar) and a
    # wrong root must each be rejected
    try:
        verify(bp, comp, tape, comms, tampered(bp, proof), gens, backend)
    except bp.VerificationError:
        log("  tampered proof rejected")
    else:
        raise AssertionError("tampered proof was accepted")
    wrong_tape = comp.tape(bp.Scalar((tree.root.v + 1) % bp.L))
    try:
        verify(bp, comp, wrong_tape, comms, proof, gens, backend)
    except bp.VerificationError:
        log("  wrong root rejected")
    else:
        raise AssertionError("proof verified against a wrong root")
    backend.evict_gens()
    out["case"] = (comp, tape, comms, prover, proof)  # for phase 8
    out["oracle_case"] = (snap, route_bytes)  # for phase 10
    return out


def phase_full_routes(bp, torch, cc, gens, prover, snap):
    """The same prover and rng on each of ROUTES, each on a fresh backend:
    both proofs byte-identical (the L/R points are the same group
    elements).  Each route proves cold (its generators and tables built)
    and warm, wall time device-synchronised, and its launches must hold
    route_kernels.  Returns the times and the launch counts of these
    proofs, and the proof bytes (prover rng SEED)."""
    import contextlib

    import numpy as np

    def prove(be):
        prover.restore(snap)
        prover.rng = np.random.RandomState(SEED)
        return timed_once(torch, lambda: prover.prove(gens, backend=be))

    times, want = {}, None
    cc.reset_launches()
    for name, combined in ROUTES.items():
        be = bp.TorchBackend("cuda")
        before = dict(cc.LAUNCHES)
        with contextlib.nullcontext() if combined else combined_off():
            got, cold_ms = prove(be)
            _, warm_ms = prove(be)
        if want is None:
            want = got.to_bytes()
        assert got.to_bytes() == want, f"route {name}: proof bytes differ"
        times[name] = dict(cold_ms=cold_ms, warm_ms=warm_ms)
        be.evict_gens()
        ran = {k: cc.LAUNCHES[k] - before[k] for k in cc.LAUNCHES}
        check_route(name, ran, combined)
        log(f"  route {name}: byte-identical, {times[name]}, launches "
            f"{ {k: v for k, v in ran.items() if v} }")
    return times, dict(cc.LAUNCHES), want


def batch_row_sets(bp, cc, t, n: int, N: int, rng, B: int = BATCH):
    """(sets, consts) of ``gh_rows`` over B row sets of the device tape `t`
    (n multipliers, one phase, padded to N), each from its own random z,
    y^-1, x, a, u, b and IPP challenges, its constants weighted by its own
    random rho, as a batch verification's."""
    from bulletproofs_r1cs_gadgets_tpu_torch.ops import verify_rows as vr

    dev = t.off.device
    sets, consts = [], []
    for _ in range(B):
        z, y_inv, x, a, u, b, all_inv, rho = (
            bp.Scalar.from_bytes_mod_order_wide(rng.bytes(64))
            for _ in range(8))
        u_sq = [c * c for c in (
            bp.Scalar.from_bytes_mod_order_wide(rng.bytes(64))
            for _ in range(N.bit_length() - 1))]
        zp = cc.sc_powers(*vr.power_tables(z, 1, t.m, dev), t.m)
        sets.append((cc.tape_flatten(t.off, t.cidx, t.coeff, zp),
                     cc.sc_powers(*vr.power_tables(y_inv, 0, N, dev), N),
                     cc.sc_powers(*vr.s_tables(u_sq, all_inv, dev), N), n, n))
        consts += [rho * c for c in (x, a, bp.Scalar.one(), u * x, u * a,
                                     u)] + [x, b]
    return sets, vr.host_words(consts).reshape(B, 8, 8)


def phase_kernels_rows(bp, torch, cc, case, dev) -> dict:
    """The verifier-row kernels (``csrc/verify_rows.cu``) against their
    plain versions on the same CUDA tensors, at phase 4's VSMT-2 depth-253
    shape: its tape's CSR on the card (``DeviceTape``: 334,973
    constraints, 143,704 multipliers padded to 2^18), random z, y^-1,
    x, a, u, b and IPP challenges.  ``sc_powers`` for z^1..z^m, y^-i and
    the IPP's s vector, ``tape_flatten``, ``tape_sums``, and ``gh_rows``
    with n1 = n (the circuit's one phase) and n1 = n / 2 (u_g = u from n1
    on), and over BATCH row sets of the same tape, each from its own
    random z, y^-1 and challenges and weighted by its own rho (``_b8``):
    every output equal word for word.  Each record: CUDA-event ms a call
    (20 calls after a warm-up), the plain version's ms (one call,
    synchronised), bound (rows_work), for ``sc_powers`` the same at
    z^1..z^m (``*_z``) and s (``ms_s``), and for ``gh_rows`` at B = 8
    (``*_b8``)."""
    import numpy as np

    from bulletproofs_r1cs_gadgets_tpu_torch.ops import verify_rows as vr

    comp, tape, comms, _, _ = case
    v = verifier_for(bp, comp, tape, comms)
    n, nv = v.num_vars, len(v.V)
    N = 1 << (n - 1).bit_length()
    t = vr.DeviceTape(tape, n, nv, dev)
    rng = np.random.RandomState(SEED + 18)
    sc = [bp.Scalar.from_bytes_mod_order_wide(rng.bytes(64))
          for _ in range(6 + N.bit_length())]
    z, y_inv, x, a, u, b, all_inv = sc[:7]
    u_sq = [c * c for c in sc[7:]]
    assert 1 << len(u_sq) == N
    consts = vr.host_words([x, a, bp.Scalar.one(), u * x, u * a, u, x,
                            b]).reshape(1, 8, 8)
    zt = vr.power_tables(z, 1, t.m, dev)
    yt = vr.power_tables(y_inv, 0, N, dev)
    st = vr.s_tables(u_sq, all_inv, dev)
    zp = cc.sc_powers(*zt, t.m)
    wires = cc.tape_flatten(t.off, t.cidx, t.coeff, zp)
    yinv = cc.sc_powers(*yt, N)
    s = cc.sc_powers(*st, N)
    one, half = [(wires, yinv, s, n, n)], [(wires, yinv, s, n, n // 2)]
    sets, c8 = batch_row_sets(bp, cc, t, n, N, rng)
    calls = {
        "sc_powers_z": (lambda: cc.sc_powers(*zt, t.m),
                        lambda: cc.sc_powers_plain(*zt, t.m)),
        "sc_powers": (lambda: cc.sc_powers(*yt, N),
                      lambda: cc.sc_powers_plain(*yt, N)),
        "sc_powers_s": (lambda: cc.sc_powers(*st, N),
                        lambda: cc.sc_powers_plain(*st, N)),
        "tape_flatten": (
            lambda: cc.tape_flatten(t.off, t.cidx, t.coeff, zp),
            lambda: cc.tape_flatten_plain(t.off, t.cidx, t.coeff, zp)),
        "tape_sums": (
            lambda: cc.tape_sums(t.ccidx, t.ccoeff, zp, wires, yinv, n),
            lambda: cc.tape_sums_plain(t.ccidx, t.ccoeff, zp, wires, yinv,
                                       n)),
        "gh_rows": (lambda: cc.gh_rows(one, consts),
                    lambda: cc.gh_rows_plain(one, consts)),
        "gh_rows_n1": (lambda: cc.gh_rows(half, consts),
                       lambda: cc.gh_rows_plain(half, consts)),
        "gh_rows_b8": (lambda: cc.gh_rows(sets, c8),
                       lambda: cc.gh_rows_plain(sets, c8)),
    }
    work = rows_work(cc, t.m, n, N, t.cidx.shape[0], t.off.shape[0] - 1,
                     t.ccidx.shape[0])
    got = {}
    for key, (fn, plain) in calls.items():
        want, pms = timed_once(torch, plain)
        assert torch.equal(fn(), want), f"{key} != plain at depth {DEPTH}"
        got[key] = dict(ms=time_ms(torch, fn, 20), plain_ms=pms)
        if key in work:
            got[key].update(bound(*work[key]))
        log(f"  {key}: kernel {got[key]['ms']:.4f} ms, plain {pms:.1f} ms"
            + (f", bound {got[key]['bound_ms']:.4f} ms "
               f"({got[key]['bound_by']})" if key in work else "")
            + ", equal")
    records = {k: dict(got[k], max_abs_err=0) for k in ROWS_KERNELS}
    sp = records["sc_powers"]
    for k, v in got["sc_powers_z"].items():
        sp[f"{k}_z"] = v
    sp["ms_s"], sp["plain_ms_s"] = (got["sc_powers_s"]["ms"],
                                    got["sc_powers_s"]["plain_ms"])
    records["gh_rows"]["ms_half_phase1"] = got["gh_rows_n1"]["ms"]
    for k, v in got["gh_rows_b8"].items():
        records["gh_rows"][f"{k}_b8"] = v
    for r in records.values():
        r.update(m=t.m, n=n, N=N, library_ms=None)
    return records


def phase_batch(bp, torch, cc, gens, params, tree):
    """BATCH depth-253 provers (leaves 1..BATCH) through prove_provers,
    one batch_verify, proof 0 against the same prover proved alone, and
    a batch with one tampered proof.  out["reuse"] keeps the circuit and
    the first PLACED jobs with their snapshots, seeds and proof bytes for
    phases 7, 9 and 12."""
    import numpy as np

    out = {}
    t0 = time.time()
    comp = bp.CompiledVSMT2(params, DEPTH, constrain_index_bits=False)
    circuit = (comp, comp.tape(tree.root))
    seeds = [SEED + 100 * i for i in range(BATCH)]
    jobs = [
        synthesize(bp, params, tree, DEPTH, seed, i + 1, circuit)
        for i, seed in enumerate(seeds)
    ]
    provers = [j[3] for j in jobs]
    snaps = [p.snapshot() for p in provers[:PLACED]]
    out["setup_s"] = time.time() - t0
    log(f"  {BATCH} provers synthesized in {out['setup_s']:.2f} s")
    backend = bp.TorchBackend("cuda")
    torch.cuda.reset_peak_memory_stats()
    cc.reset_launches()
    t0 = time.time()
    proofs = bp.prove_provers(provers, gens, backend=backend)
    torch.cuda.synchronize()
    out["batch_prove_s"] = time.time() - t0
    out["proofs_per_s"] = BATCH / out["batch_prove_s"]
    out["batch_peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    log(f"  batch of {BATCH}: {out['batch_prove_s']:.2f} s, "
        f"{out['proofs_per_s']:.3f} proofs/s, peak device memory "
        f"{out['batch_peak_mem_bytes']} B")

    pc_gens = bp.PedersenGens.default()
    t0 = time.time()
    bp.batch_verify(
        [verifier_for(bp, comp, j[1], j[2]) for j in jobs], proofs, pc_gens,
        gens, backend=backend,
    )
    torch.cuda.synchronize()
    out["batch_verify_s"] = time.time() - t0
    log(f"  one batch_verify of {BATCH}: {out['batch_verify_s']:.2f} s")
    out["launches"] = dict(cc.LAUNCHES)
    log(f"  launches {out['launches']}")
    for name in ("msm_lane", "msm_win5", "table_w5", "fold_w3h",
                 "fold_w3h_comb", "table_w4", "msm_win_pair"):
        assert out["launches"][name] > 0, \
            f"kernel {name} was not launched on the batched path"
    on, _ = route_kernels(verify=True)
    for name in ROWS_KERNELS:  # each proof's rows, and their sum, on the card
        assert name in on and out["launches"][name] > 0, \
            f"batch_verify did not launch {name}"

    prover = provers[0]
    prover.restore(snaps[0])
    prover.rng = np.random.RandomState(seeds[0])
    alone = prover.prove(gens, backend=backend)
    assert alone.to_bytes() == proofs[0].to_bytes(), \
        "batched proof 0 differs from the prover proved alone"
    log("  proof 0 byte-identical to its prover proved alone")

    bad = list(proofs)
    bad[3] = tampered(bp, proofs[3])
    try:
        bp.batch_verify(
            [verifier_for(bp, comp, j[1], j[2]) for j in jobs], bad, pc_gens,
            gens, backend=backend,
        )
    except bp.VerificationError as exc:
        assert "[3]" in str(exc), f"wrong proof blamed: {exc}"
        log("  batch with a tampered proof rejected (index 3)")
    else:
        raise AssertionError("batch with a tampered proof was accepted")
    backend.evict_gens()
    out["reuse"] = (circuit, jobs[:PLACED], snaps, seeds[:PLACED],
                    [p.to_bytes() for p in proofs[:PLACED]])
    return out


# ---- phase 6: bench.py stage 5's equivalence gate (bench.py:482-627):
# one seeded depth-8 VSMT-2 proof (4,544 multipliers padded to 8192)
GATE_DEPTH = 8
GATE_N = 8192


def gate_circuit(bp):
    """The gate's circuit: a depth-8 tree over leaves 1..3, key 2."""
    params = bp.PoseidonParams(6, 4, 4, 140)
    tree = bp.VanillaSparseMerkleTree(params, depth=GATE_DEPTH)
    for i in range(1, 4):
        tree.update(bp.Scalar(i), bp.Scalar(i))
    k = bp.Scalar(2)
    merkle_proof = []
    assert tree.get(k, merkle_proof) == k
    bits = [b.v for b in bp.leaf_index_bit_scalars(k, GATE_DEPTH)]
    nodes = list(reversed(merkle_proof))
    comp = bp.CompiledVSMT2(params, GATE_DEPTH, constrain_index_bits=False)
    return comp, comp.tape(tree.root), k, bits, nodes


def gate_prover(bp, circuit):
    """(commitments, prover) with the gate's rngs (prover 42, commitments
    7), the witness loaded."""
    import numpy as np

    comp, tape, k, bits, nodes = circuit
    prover = bp.Prover(bp.PedersenGens.default(), bp.Transcript(b"VSMT"),
                       rng=np.random.RandomState(42))
    comms = comp.commit_prover(prover, k, bits, nodes,
                               rng=np.random.RandomState(7))
    prover.load_compiled(tape, *comp.witness(k, bits, nodes))
    return comms, prover


def gate_host_proof_hex() -> str:
    """The gate's proof through the port's host path (backend=None), as
    hex: what ``chip_smoke.py --gate-host`` prints, in a process of its
    own beside the card's phases."""
    sys.path.insert(0, ROOT)
    import bulletproofs_r1cs_gadgets_tpu_torch as bp

    _, prover = gate_prover(bp, gate_circuit(bp))
    return prover.prove(bp.BulletproofGens(GATE_N), backend=None).to_bytes().hex()


def phase_gate(bp, torch, cc, host):
    """The gate's proof through TorchBackend on each of ROUTES (a fresh
    backend each, its generator cache evicted after), through
    prove_provers with three provers (flotilla rounds run), through the
    port's NativeBackend and through the host path (`host`, the
    ``--gate-host`` process, about a minute of one core): one byte
    string.  The common proof verifies and a tampered copy is rejected;
    each route's launches hold route_kernels.  Returns the launch counts
    and the times."""
    import contextlib

    circuit = gate_circuit(bp)
    gens = bp.BulletproofGens(GATE_N)
    results, times = {}, {}
    cc.reset_launches()
    for tag, combined in ROUTES.items():
        before = dict(cc.LAUNCHES)
        backend = bp.TorchBackend("cuda")
        comms, prover = gate_prover(bp, circuit)
        with contextlib.nullcontext() if combined else combined_off():
            proof, times[tag] = timed_once(
                torch, lambda: prover.prove(gens, backend=backend)
            )
        backend.evict_gens()
        results[tag] = proof.to_bytes()
        ran = {k: cc.LAUNCHES[k] - before[k] for k in cc.LAUNCHES}
        check_route(tag, ran, combined)
        log(f"  {tag}: {times[tag]:.1f} ms, launches "
            f"{ {k: v for k, v in ran.items() if v} }")
    tag = "batch"
    backend = bp.TorchBackend("cuda")
    provers = [gate_prover(bp, circuit)[1] for _ in range(3)]
    lanes = cc.LAUNCHES["msm_lane"]
    proofs, times[tag] = timed_once(
        torch, lambda: bp.prove_provers(provers, gens, backend=backend)
    )
    backend.evict_gens()
    assert len({p.to_bytes() for p in proofs}) == 1, f"{tag} differs"
    assert cc.LAUNCHES["msm_lane"] > lanes, f"{tag}: no flotilla round"
    results[tag] = proofs[0].to_bytes()
    log(f"  {tag}: 3 proofs in {times[tag]:.1f} ms, "
        f"{cc.LAUNCHES['msm_lane'] - lanes} flotilla rounds")
    from bulletproofs_r1cs_gadgets_tpu_torch.ops.native_backend import (
        NativeBackend,
    )

    _, prover = gate_prover(bp, circuit)
    proof, times["native-cpu"] = timed_once(
        torch, lambda: prover.prove(gens, backend=NativeBackend())
    )
    results["native-cpu"] = proof.to_bytes()
    t0 = time.time()
    out, err = host.communicate(timeout=900)
    assert host.returncode == 0, f"host-path gate proof failed: {err[-2000:]}"
    results["host"] = bytes.fromhex(out.split()[-1])
    log(f"  native-cpu {times['native-cpu']:.1f} ms; host path waited "
        f"{time.time() - t0:.1f} s")
    blobs = set(results.values())
    assert len(blobs) == 1, (
        f"{len(blobs)} distinct proofs across {list(results)}: "
        + str({k: v[:8].hex() for k, v in results.items()})
    )
    comp, tape = circuit[:2]
    backend = bp.TorchBackend("cuda")
    common = bp.R1CSProof.from_bytes(blobs.pop())
    verify(bp, comp, tape, comms, common, gens, backend)
    try:
        verify(bp, comp, tape, comms, tampered(bp, common), gens, backend)
    except bp.VerificationError:
        pass
    else:
        raise AssertionError("gate: tampered proof was accepted")
    backend.evict_gens()
    log(f"  {len(results)} paths byte-identical "
        f"({len(common.to_bytes())} B), verified, tampered copy rejected")
    launches = dict(cc.LAUNCHES)
    log(f"  launches {launches}")
    return launches, times


# ---- phases 7-9: the multi-device layer and the stream
def card_devices(torch, want: int):
    """`want` devices over the visible cards, round-robin (one card takes
    every slot), and a line saying which."""
    count = torch.cuda.device_count()
    devices = [torch.device("cuda", d % count) for d in range(want)]
    if count < want:
        log(f"  {count} card(s) visible: {want} slots on "
            f"{', '.join(sorted({str(d) for d in devices}))}")
    return devices


def phase_placement(bp, torch, cc, F, gens, reuse):
    """Dry run C: phase 5's first PLACED depth-253 provers (leaves
    1..PLACED, deterministic rngs; `reuse` is phase 5's out["reuse"]),
    restored, through prove_provers_devices over the visible cards (two
    TorchBackends on cuda:0 with one card): each proof byte-identical to
    the same prover through prove_provers on one backend, one batch_verify
    of all, and on each placed backend one msm_w4 of 2^14 points (words
    live on 64 rows) on that backend's card, equal to the host MSM of the
    64."""
    import numpy as np

    from bulletproofs_r1cs_gadgets_tpu_torch.ops import chunks as ck

    out = {}
    ndev = max(2, torch.cuda.device_count())
    devices = card_devices(torch, ndev)
    circuit, jobs, snaps, seeds, _ = reuse
    provers = [j[3] for j in jobs]

    def restore():
        for p, snap, seed in zip(provers, snaps, seeds):
            p.restore(snap)
            p.rng = np.random.RandomState(seed)

    restore()
    placed = []

    def factory(device):
        be = bp.TorchBackend(device)
        placed.append(be)
        return be

    cc.reset_launches()
    proofs, ms = timed_once(torch, lambda: bp.prove_provers_devices(
        provers, gens, devices=devices, backend_factory=factory))
    out["launches"] = dict(cc.LAUNCHES)
    out["placed_ms"] = ms
    log(f"  {PLACED} proofs over {[str(d) for d in devices]}: {ms:.1f} ms, "
        f"launches { {k: v for k, v in out['launches'].items() if v} }")
    for name in ("table_w5", "msm_win5", "fold_w3h", "msm_win_pair",
                 "msm_lane"):
        assert out["launches"][name] > 0, f"{name} not launched when placed"
    restore()
    one = bp.TorchBackend("cuda")
    again, out["one_backend_ms"] = timed_once(
        torch, lambda: bp.prove_provers(provers, gens, backend=one))
    for i, (got, want) in enumerate(zip(proofs, again)):
        assert got.to_bytes() == want.to_bytes(), f"placed proof {i} differs"
    log(f"  byte-identical to prove_provers on one backend "
        f"({out['one_backend_ms']:.1f} ms)")
    _, out["verify_ms"] = timed_once(torch, lambda: bp.batch_verify(
        [verifier_for(bp, circuit[0], j[1], j[2]) for j in jobs], proofs,
        bp.PedersenGens.default(), gens, backend=one))
    log(f"  one batch_verify of {PLACED}: {out['verify_ms']:.1f} ms")
    share = gens.share(0)
    rows = np.zeros((MSM_N, 4), np.uint64)
    rows[:64] = random_scalar_rows(bp, 64, np.random.RandomState(SEED + 7))
    for be in placed:
        pts = be._gens(share, MSM_N, "G")
        got = cc.msm_w4(pts, ck.w4_words(rows, be.device),
                        F.identity_points(1, be.device))
        assert got.device == be.device, f"msm_w4 on {got.device}"
        want = bp.multiscalar_mul(bp.scvec.to_scalars(rows[:64]),
                                  F.to_points(pts[:64]))
        assert F.to_points(got)[0] == want, f"msm_w4 on {be.device} != host"
        be.evict_gens()
    one.evict_gens()
    log(f"  msm_w4 of {MSM_N} points on each placed backend's card "
        f"({', '.join(str(be.device) for be in placed)}) == host MSM")
    return out


class Capture(HostRows):
    """A backend that records the verifier's mega-MSM scalars, built on
    the host (HostRows), and passes every call to `inner`."""

    def __init__(self, inner):
        super().__init__(inner)
        self.gens_scalars = None

    def msm_gens(self, scalars, head_points, gens_share, padded_n, tail_points):
        self.gens_scalars = (scalars, len(head_points), padded_n)
        return self.inner.msm_gens(scalars, head_points, gens_share, padded_n,
                                   tail_points)


def phase_sharded(bp, torch, cc, F, gens, case):
    """Dry run D at full width: ShardedWalkMsm with SHARDS x SHARD_CHUNKS
    chunks (2^18 points) over the visible cards (or all on one): (a) the
    verifier's G segment of the phase-4 proof (128 valid chunks) and (b)
    the phase-4 prover's a_L, phase 1's 143,704-point G words (71 valid
    chunks: shard 2 partial, shard 3 dead), each equal to msm_grid over
    the same points and words; (c) the depth-253 proof verifies through
    ShardedWalkVerifyBackend and a tampered copy is rejected; the sharded
    verify's wall time beside TorchBackend's."""
    import numpy as np

    from bulletproofs_r1cs_gadgets_tpu_torch.ops import chunks as ck
    from bulletproofs_r1cs_gadgets_tpu_torch.parallel.sharded_fast import (
        ShardedWalkMsm,
        ShardedWalkVerifyBackend,
    )

    comp, tape, comms, prover, proof = case
    out = {}
    sharded = ShardedWalkMsm(card_devices(torch, SHARDS),
                             local_chunks=SHARD_CHUNKS)
    log(f"  {sharded!r}")
    span = sharded.total_chunks * ck.CHUNK
    assert span == GENS_N
    home = sharded.devices[0]
    G = F.from_raw(gens.G_raw(span), home)
    shards = sharded.place(G)
    cap = Capture(bp.TorchBackend("cuda"))
    verify(bp, comp, tape, comms, proof, gens, cap)  # captures, builds tables
    _, out["torch_verify_ms"] = timed_once(
        torch, lambda: verify(bp, comp, tape, comms, proof, gens, cap))
    cap.inner.evict_gens()
    scalars, nh, padded_n = cap.gens_scalars
    assert padded_n == span
    if not isinstance(scalars, np.ndarray):
        scalars = bp.scvec.from_scalars(list(scalars))
    a_L = prover._witness_arrays()[0]
    cases = (("verifier G", scalars[nh : nh + padded_n]), ("phase 1 a_L", a_L))
    cc.reset_launches()
    walk_ms, wants = {}, {}
    for name, seg in cases:
        w = np.zeros((span, 8), np.int32)
        w[: seg.shape[0]] = ck.signed_digit_words(seg)
        words = torch.from_numpy(w)
        valid = -(-seg.shape[0] // ck.CHUNK)
        got, walk_ms[name] = timed_once(
            torch, lambda: sharded.msm(shards, words, valid))
        wants[name] = (G, words[: seg.shape[0]].to(home), valid)
        log(f"  sharded {name}: {seg.shape[0]} points, {valid} valid chunks, "
            f"shard counts {[ck.shard_valid(valid, d, SHARD_CHUNKS) for d in range(SHARDS)]}, "
            f"{walk_ms[name]:.1f} ms wall")
        out[name] = got
    sharded_msm = dict(cc.LAUNCHES)
    for name, (pts, words, _) in wants.items():
        want = cc.msm_grid(pts, words, F.identity_points(1, home))
        assert F.to_points(want)[0] == out.pop(name), \
            f"sharded {name} != msm_grid"
    log("  both sharded MSMs equal msm_grid over the same points and words")
    out["walk_ms"] = walk_ms
    backend = ShardedWalkVerifyBackend(sharded)
    cc.reset_launches()
    _, cold = timed_once(torch, lambda: verify(bp, comp, tape, comms, proof,
                                               gens, backend))
    verify_launches = dict(cc.LAUNCHES)
    _, out["sharded_verify_ms"] = timed_once(
        torch, lambda: verify(bp, comp, tape, comms, proof, gens, backend))
    assert verify_launches["msm_grid_local"] == 2 * SHARDS, verify_launches
    try:
        verify(bp, comp, tape, comms, tampered(bp, proof), gens, backend)
    except bp.VerificationError:
        log("  tampered proof rejected by the sharded verifier")
    else:
        raise AssertionError("sharded verifier accepted a tampered proof")
    log(f"  depth-253 proof verified through ShardedWalkVerifyBackend: cold "
        f"{cold:.1f} ms, warm {out['sharded_verify_ms']:.1f} ms; "
        f"TorchBackend warm (host rows) {out['torch_verify_ms']:.1f} ms")
    # the path's launches: the sharded MSMs (a, b) and the cold verify
    out["launches"] = {k: sharded_msm[k] + verify_launches[k]
                       for k in cc.LAUNCHES}
    assert set(k for k, v in out["launches"].items() if v) == \
        {"msm_grid_local"}, out["launches"]
    return out


def phase_stream(bp, torch, cc, gens, params, tree, circuit):
    """prove_stream of STREAM depth-253 provers (leaves 1..10 in turn,
    deterministic rngs), built lazily from the compiled template, wave 4,
    inflight 8, on TorchBackend("cuda"): one batch_verify of all; proofs
    0 and STREAM - 1 byte-identical to the same provers (those the stream
    built, restored) through prove_provers; the report; then a short
    keep=False run of restored provers 0 and 1 whose on_result indices and
    bytes match."""
    import threading

    import numpy as np

    out = {}
    seeds = [SEED + 900 + 100 * i for i in range(STREAM)]
    ends = [0, STREAM - 1]
    jobs, snaps = {}, {}
    lock = threading.Lock()

    def make_prover(i):
        job = synthesize(bp, params, tree, DEPTH, seeds[i], i % 10 + 1,
                         circuit)
        snap = job[3].snapshot() if i in (0, 1, STREAM - 1) else None
        with lock:
            jobs[i], snaps[i] = job, snap
        return job[3]

    def restored(i):
        """The prover make_prover built for `i`, as it was built."""
        p = jobs[i][3]
        p.restore(snaps[i])
        p.rng = np.random.RandomState(seeds[i])
        return p

    backend = bp.TorchBackend("cuda")
    torch.cuda.reset_peak_memory_stats()
    cc.reset_launches()
    (proofs, rep), ms = timed_once(torch, lambda: bp.prove_stream(
        make_prover, STREAM, gens, backend=backend, wave=4, inflight=8))
    out["launches"] = dict(cc.LAUNCHES)
    out["report"] = dict(
        count=rep.count, wave=rep.wave, inflight=rep.inflight,
        wall_s=rep.wall_s, proofs_per_s=rep.proofs_per_s, build_s=rep.build_s,
        prove_s=rep.prove_s, cpu_util=rep.cpu_util,
        hbm_peak_bytes=rep.hbm_peak_bytes, group_times=rep.group_times,
    )
    log(f"  stream of {STREAM}: {ms:.1f} ms, report {out['report']}")
    assert rep.count == STREAM and len(rep.group_times) == -(-STREAM // 4)
    assert rep.hbm_peak_bytes == torch.cuda.max_memory_allocated()
    for name in ("msm_win5", "fold_w3h", "msm_win_pair", "msm_lane"):
        assert out["launches"][name] > 0, f"{name} not launched in the stream"
    _, out["verify_ms"] = timed_once(torch, lambda: bp.batch_verify(
        [verifier_for(bp, circuit[0], jobs[i][1], jobs[i][2])
         for i in range(STREAM)],
        proofs, bp.PedersenGens.default(), gens, backend=backend))
    log(f"  one batch_verify of {STREAM}: {out['verify_ms']:.1f} ms")
    again = bp.prove_provers([restored(i) for i in ends], gens,
                             backend=backend)
    for i, got in zip(ends, again):
        assert got.to_bytes() == proofs[i].to_bytes(), \
            f"streamed proof {i} differs from prove_provers"
    log(f"  proofs {ends} byte-identical to prove_provers")
    got = {}  # two workers of one prover each: results in any order
    kept, rep2 = bp.prove_stream(
        restored, 2, gens, backend=backend, wave=1, inflight=2, keep=False,
        on_result=lambda i, pf: got.__setitem__(i, pf.to_bytes()))
    assert kept is None and rep2.count == 2 and sorted(got) == [0, 1]
    assert all(got[i] == proofs[i].to_bytes() for i in range(2)), \
        "keep=False results out of order"
    log("  keep=False run: on_result indices and bytes match the stream")
    backend.evict_gens()
    return out


# ---- the device-oracle path's kernels (phase 2) and the path (phase 10)
ORACLE_PTS = 1 << 18  # padd / pdbl points
SMUL_N = 1 << 14  # smul_lanes' second shape; phase 10 (d)'s scalar_mul_shared points
TOTALS_N = (1 << 16) + 1000  # msm_block_totals: 33 blocks, the last ragged
GRID_V = (2048, 1 << 13)  # fold_grid outputs of the device-oracle IPP's rounds 7 and 5
FIELD_N = 1 << 20  # mul_fq / mul_fp elements
# the elements a launch of each takes on the paths that call it: mul_fq as
# the port's Poseidon called it before poseidon_perm (the MDS product, a
# full round's S-box, a partial round's), mul_fp in the 2^18 derivation
FIELD_CALLER_N = {"mul_fq": (288, 48, 8), "mul_fp": (1 << 18,)}
SC_PRODUCTS = 64 + 81 + 45  # mul_fq's 32 x 32 -> 64 products (Barrett)


def exact_err(F, got, want, P) -> int:
    """0 when the two tensors hold the same words; else the affine
    difference of the first points that differ (never 0)."""
    import torch

    if torch.equal(got, want):
        return 0
    if got.dim() == 3:
        return max(1, point_err(F, got, want, P))
    return 1


def bit_ladder_ops(words, count: int = 253) -> tuple[dict, int]:
    """The bit ladder's work that the data needs: from each row's top set
    bit, one doubling per later bit and one add per set bit after it."""
    return ladder_ops(_codes(words, 1, count), 1)


def bit_w4_words(words):
    """(n, 8) raw bit words -> the signed w4 words the bit-word MSMs' tiles
    recode them into (fold_codes, packed a nibble a digit)."""
    import numpy as np

    codes = fold_codes(words).astype(np.uint32).reshape(-1, 8, 8)
    shifts = (4 * np.arange(8)).astype(np.uint32)
    return (codes << shifts).sum(axis=2, dtype=np.uint32).view(np.int32)


def fold_w2_ops(wl, wr) -> dict:
    """fold_grid's first version's work that the data needs (the TPU's
    dual w2 ladder): two table doublings per output, from the top nonzero
    window of either scalar two doublings per window, and one add per
    nonzero digit past the first."""
    import numpy as np

    codes = np.concatenate([_codes(wl, 2, 128), _codes(wr, 2, 128)], axis=1)
    per_win = (_codes(wl, 2, 128) != 0) | (_codes(wr, 2, 128) != 0)
    live = per_win.any(axis=1)
    top = 127 - np.argmax(per_win[:, ::-1], axis=1)
    return dict(
        dbl=int(2 * top[live].sum() + 2 * len(wl)),
        add=int(((codes != 0).sum(axis=1)[live] - 1).sum()),
    )


def phase_kernels_oracle(bp, torch, cc, F, gens, dev, rng):
    """The device-oracle path's eight kernels at its shapes, each exactly
    against its plain version (equal words; the redesigned smul_lanes,
    msm_block_totals, msm_chunk_acc and fold_grid by group element,
    ``point_err``), and on subsets against the host group law, MSM or
    Python ints: padd / pdbl over 2^18 points (timed at 2^14 too),
    smul_lanes over the path's 2^16 and over 2^14 points x 253 bits under
    both designs (edge rows 0, 1, L - 1, 2^253 - 1 and bits 253..255
    set), msm_block_totals over 2^16 + 1000 points (a ragged last
    block, an all-zero block), msm_chunk_acc over 143,704 points and over
    the path's 2^14 with a nonzero acc, fold_grid from 2^18 into 2^17 (per-lane words with the
    edge scalars 0, 1, L - 1; then constant rows) and at 2,048 and 2^13
    outputs (rounds 7 and 5) under both designs, mul_fq / mul_fp over 2^20
    elements with the edges 0, 1, m - 1, 2^256 - 1."""
    import numpy as np

    from bulletproofs_r1cs_gadgets_tpu_torch.ops import chunks as ck

    P, L = bp.P, bp.L
    records = {}
    G = F.from_raw(gens.G_raw(ORACLE_PTS), dev)
    H = F.from_raw(gens.H_raw(ORACLE_PTS), dev)
    hostG = F.to_points(G[:64])
    hostH = F.to_points(H[:64])

    def record(name, got, plain_fn, fn, reps, ops, nbytes):
        plain, plain_ms = timed_once(torch, plain_fn)
        err = exact_err(F, got, plain, P)
        assert err == 0, f"{name} != plain (err {err})"
        records[name] = dict(max_abs_err=err, ms=time_ms(torch, fn, reps),
                             plain_ms=plain_ms, **bound(ops, nbytes))

    def by_point(name, got, plain_fn):
        """(point_err, the plain version's ms) of a redesigned kernel."""
        plain, plain_ms = timed_once(torch, plain_fn)
        err = point_err(F, got, plain, P)
        assert err == 0, f"{name} != plain (err {err})"
        return err, plain_ms

    # ---- padd / pdbl over 2^18 points, timed at 2^14 too
    n = ORACLE_PTS
    got = cc.padd(G, H)
    assert F.to_points(got[:64]) == [a + b for a, b in zip(hostG, hostH)]
    record("padd", got, lambda: cc.padd_plain(G, H), lambda: cc.padd(G, H), 20,
           dict(add=n), 3 * n * 128)
    got = cc.pdbl(G)
    assert F.to_points(got[:64]) == [a.double() for a in hostG]
    record("pdbl", got, lambda: cc.pdbl_plain(G), lambda: cc.pdbl(G), 20,
           dict(dbl=n), 2 * n * 128)
    m = SMUL_N
    Gm, Hm = G[:m], H[:m]
    records["padd"][f"ms_{m}"] = time_ms(torch, lambda: cc.padd(Gm, Hm), 50)
    records["pdbl"][f"ms_{m}"] = time_ms(torch, lambda: cc.pdbl(Gm), 50)

    # ---- smul_lanes over the path's 2^16 lanes and over 2^14, each under
    # both designs: edge rows 0, 1, L - 1, 2^253 - 1, bits 253..255 set
    smul = {}
    rows = random_scalar_rows(bp, ORACLE_MSM_N, rng)
    rows[:3] = bp.scvec.from_ints([0, 1, L - 1])
    words = ck.bit_words(rows).copy()  # bit_words is a view of rows
    words[3] = np.frombuffer(((1 << 253) - 1).to_bytes(32, "little"), "<i4")
    words[4, 7] |= np.int32(-0x20000000)  # bits 253..255: not read
    w_all = torch.from_numpy(words).to(dev)
    for n in (ORACLE_MSM_N, SMUL_N):
        w, pts = w_all[:n], G[:n]
        got = cc.smul_lanes(pts, w)
        err, plain_ms = by_point("smul_lanes", got,
                                 lambda: cc.smul_lanes_plain(pts, w))
        for d in cc.SMUL_LANES_DESIGNS:
            e = point_err(F, cc.smul_lanes(pts, w, design=d), got, P)
            assert e == 0, f"smul_lanes {n} {d} != plain (err {e})"
        ops, _, _ = fold_bits_ops(words[:n], np.zeros_like(words[:n]))
        ladder, _ = bit_ladder_ops(words[:n])
        smul[n] = dict(
            max_abs_err=err, ms=time_ms(torch, lambda: cc.smul_lanes(pts, w), 5),
            plain_ms=plain_ms, design=cc.smul_lanes_design(dev, n),
            design_ms={d: time_ms(torch, lambda: cc.smul_lanes(pts, w, design=d), 5)
                       for d in cc.SMUL_LANES_DESIGNS},
            **bounds(ops, ladder, n * (2 * 128 + 32)))
        log(f"  smul_lanes {n} lanes ({smul[n]['design']}): {smul[n]['ms']:.3f} ms, "
            f"designs {smul[n]['design_ms']}, plain {plain_ms:.1f} ms")
    want = [p.scalar_mul(bp.Scalar(decode_bits(r) % (1 << 253) % L))
            for p, r in zip(hostG[:16], words[:16])]
    assert F.to_points(cc.smul_lanes(G[:16], w_all[:16])) == want, "smul_lanes != host"
    records["smul_lanes"] = dict(
        smul[ORACLE_MSM_N], **{f"{k}_{SMUL_N}": v for k, v in smul[SMUL_N].items()
                               if k in ("ms", "plain_ms", "design", "design_ms",
                                        "bound_ms", "bound_ladder_ms")})

    # ---- msm_block_totals over 2^16 + 1000 points: 33 blocks, the last
    # ragged, block 1 all zero
    n = TOTALS_N
    rows = random_scalar_rows(bp, n, rng)
    rows[:2] = bp.scvec.from_ints([0, L - 1])
    rows[n - 300 : n - 200] = 0
    rows[cc.BLOCK_PTS : 2 * cc.BLOCK_PTS] = 0
    words = ck.bit_words(rows)
    w = torch.from_numpy(words).to(dev)
    pts = G[:n]
    got = cc.msm_block_totals(pts, w)
    nb = -(-n // cc.BLOCK_PTS)
    assert got.shape == (nb, 4, 8)
    last = (nb - 1) * cc.BLOCK_PTS
    host = bp.multiscalar_mul(bp.scvec.to_scalars(rows[last:]),
                              F.to_points(pts[last:]))
    assert F.to_points(got[-1:])[0] == host, "ragged block total != host MSM"
    assert F.to_points(got[1:2])[0].is_identity(), "all-zero block total"
    err, plain_ms = by_point("msm_block_totals", got,
                             lambda: cc.msm_block_totals_plain(pts, w))
    ladder, live = bit_ladder_ops(words)
    ladder["add"] += nb * cc.BLOCK_PTS - nb  # block trees
    seg = min(n, cc.BLOCK_PTS)
    records["msm_block_totals"] = dict(
        max_abs_err=err, ms=time_ms(torch, lambda: cc.msm_block_totals(pts, w), 5),
        plain_ms=plain_ms,
        **bounds(msm_w4_ops(bit_w4_words(words), w4_blocks(seg, nb), nb,
                            chained=False),
                 ladder, n * (128 + 32) + nb * 128),
    )

    # ---- msm_chunk_acc over 143,704 points and over the path's 2^14 (one
    # chunk of msm_device), a nonzero acc
    acc = F.from_points([bp.PedersenGens.default().B], dev)
    chunk = {}
    for n in (N1, MSM_N):
        rows = random_scalar_rows(bp, n, rng)
        rows[:2] = bp.scvec.from_ints([0, L - 1])
        words = ck.bit_words(rows).copy()  # bit_words is a view of rows
        words[2, 7] |= np.int32(-0x20000000)  # bits 253..255: not read
        w = torch.from_numpy(words).to(dev)
        pts = G[:n]
        got = cc.msm_chunk_acc(pts, w, acc)
        err, plain_ms = by_point("msm_chunk_acc", got,
                                 lambda: cc.msm_chunk_acc_plain(pts, w, acc))
        ms = time_ms(torch, lambda: cc.msm_chunk_acc(pts, w, acc), 5)
        ladder, live = bit_ladder_ops(words)
        ladder["add"] += n
        chunk[n] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms,
            **bounds(msm_w4_ops(bit_w4_words(words), w4_blocks(n)), ladder,
                     n * (128 + 32) + 256))
        log(f"  msm_chunk_acc {n} points: {ms:.3f} ms, plain {plain_ms:.1f} ms")
    sub = cc.msm_chunk_acc(G[:64], w[:64].contiguous(), acc)
    host = bp.multiscalar_mul(bp.scvec.to_scalars(rows[:64]), hostG) \
        + bp.PedersenGens.default().B
    assert F.to_points(sub)[0] == host, "msm_chunk_acc != host MSM"
    records["msm_chunk_acc"] = dict(
        chunk[N1], **{f"{k}_{MSM_N}": v for k, v in chunk[MSM_N].items()
                      if k in ("ms", "plain_ms", "bound_ms", "bound_ladder_ms")})

    # ---- fold_grid from 2^18 into 2^17: per-lane words with edges, then
    # the constants u^-1, u of a round as one row each; both at 2,048 and
    # 2^13 outputs under each design
    def grid_bounds(sl, sr, v, nbytes):
        """The function's work (fold_bits_ops on the scalars' bit words:
        w2_recode's digits are fold_recode's for a canonical scalar), the w2
        ladder's count beside it."""
        bl, br = ck.bit_words(sl), ck.bit_words(sr)
        ops, _, _ = fold_bits_ops(bl, br)
        return bounds(ops, fold_w2_ops(ck.signed_digit2_words(sl),
                                       ck.signed_digit2_words(sr)), nbytes)

    v = ORACLE_PTS // 2
    sl = random_scalar_rows(bp, v, rng)
    sr = random_scalar_rows(bp, v, rng)
    sl[:3] = bp.scvec.from_ints([0, 1, L - 1])
    sr[:3] = bp.scvec.from_ints([0, L - 1, 1])
    wl, wr = ck.w2_words(sl, dev), ck.w2_words(sr, dev)
    got = cc.fold_grid(G, wl, wr, v)
    hostR = F.to_points(G[v : v + 8])
    want = [a.scalar_mul(x) + b.scalar_mul(y) for a, b, x, y in zip(
        hostG[:8], hostR, bp.scvec.to_scalars(sl[:8]),
        bp.scvec.to_scalars(sr[:8]))]
    assert F.to_points(got[:8]) == want, "fold_grid != host"
    err, plain_ms = by_point("fold_grid", got,
                             lambda: cc.fold_grid_plain(G, wl, wr, v))
    records["fold_grid"] = dict(
        max_abs_err=err, ms=time_ms(torch, lambda: cc.fold_grid(G, wl, wr, v), 5),
        plain_ms=plain_ms, design=cc.fold_grid_design(dev, v),
        **grid_bounds(sl, sr, v, v * (3 * 128 + 2 * 32)))
    u = bp.scvec.to_scalars(sr[5:6])[0]
    cu, ci = ck.const_grid_words(u, dev), ck.const_grid_words(u.invert(), dev)
    got = cc.fold_grid(G, ci, cu, v)
    e, const_plain_ms = by_point("constant fold_grid", got,
                                 lambda: cc.fold_grid_plain(G, ci, cu, v))
    want = [a.scalar_mul(u.invert()) + b.scalar_mul(u)
            for a, b in zip(hostG[:8], hostR)]
    assert F.to_points(got[:8]) == want, "constant fold_grid != host"
    for c0, c1 in ((0, 1), (1, L - 1)):  # edge constants on 2048 outputs
        e0 = ck.const_grid_words(bp.Scalar(c0), dev)
        e1 = ck.const_grid_words(bp.Scalar(c1), dev)
        sub = G[: 2 * FOLD_M].contiguous()
        for d in cc.FOLD_GRID_DESIGNS:
            assert point_err(F, cc.fold_grid(sub, e0, e1, FOLD_M, design=d),
                             cc.fold_grid_plain(sub, e0, e1, FOLD_M), P) == 0, \
                f"edge constant fold_grid {d} != plain"
    rec = records["fold_grid"]
    rec["const_ms"] = time_ms(torch, lambda: cc.fold_grid(G, ci, cu, v), 5)
    rec["const_plain_ms"] = const_plain_ms
    rec["design_ms"] = {d: time_ms(torch, lambda: cc.fold_grid(
        G, wl, wr, v, design=d), 3) for d in cc.FOLD_GRID_DESIGNS}
    for m in GRID_V:  # rounds 7 and 5: constant rows, both designs
        sub = G[: 2 * m].contiguous()
        plain = cc.fold_grid_plain(sub, ci, cu, m)
        for d in cc.FOLD_GRID_DESIGNS:
            e = point_err(F, cc.fold_grid(sub, ci, cu, m, design=d), plain, P)
            assert e == 0, f"fold_grid {m} {d} != plain (err {e})"
        rec[f"design_{m}"] = cc.fold_grid_design(dev, m)
        rec[f"ms_{m}"] = time_ms(torch, lambda: cc.fold_grid(sub, ci, cu, m), 10)
        rec[f"design_ms_{m}"] = {d: time_ms(torch, lambda: cc.fold_grid(
            sub, ci, cu, m, design=d), 10) for d in cc.FOLD_GRID_DESIGNS}
        cs_rows = bp.scvec.from_ints([u.invert().v, u.v])
        b = grid_bounds(np.repeat(cs_rows[:1], m, axis=0),
                        np.repeat(cs_rows[1:], m, axis=0), m, m * 3 * 128 + 64)
        rec[f"bound_ms_{m}"] = b["bound_ms"]
        rec[f"bound_ladder_ms_{m}"] = b["bound_ladder_ms"]
        log(f"  fold_grid {m} (constant rows, {rec[f'design_{m}']}): "
            f"{rec[f'design_ms_{m}']} ms")

    # ---- mul_fq / mul_fp over 2^20 elements with edges
    n = FIELD_N
    for name, m, kern, plain_fn, prods in (
            ("mul_fq", L, cc.mul_fq, cc.mul_fq_plain, SC_PRODUCTS),
            ("mul_fp", P, cc.mul_fp, cc.mul_fp_plain, 73)):
        raw = np.frombuffer(rng.bytes(64 * n), dtype="<i4").reshape(2, n, 8)
        edge = F.ints_to_words([0, 1, m - 1, (1 << 256) - 1])
        a_np, b_np = raw[0].copy(), raw[1].copy()
        a_np[:4], b_np[:4] = edge, edge[::-1]
        a_np[4:8], b_np[4:8] = edge, edge
        a = torch.from_numpy(a_np).to(dev)
        b = torch.from_numpy(b_np).to(dev)
        got = kern(a, b)
        xs, ys = F.words_to_ints(a_np[:64]), F.words_to_ints(b_np[:64])
        assert F.words_to_ints(got[:64].cpu().numpy()) == [
            x * y % m for x, y in zip(xs, ys)], f"{name} != Python ints"
        plain, plain_ms = timed_once(torch, lambda: plain_fn(a, b))
        assert torch.equal(got, plain), f"{name} != plain"
        records[name] = dict(
            max_abs_err=0, ms=time_ms(torch, lambda: kern(a, b), 20),
            plain_ms=plain_ms,
            **bound(dict(fe=n * prods / 73), 3 * 32 * n),
        )
        for k in FIELD_CALLER_N[name]:  # at the callers' sizes: the events
            # over back-to-back calls (the wrapper's host work a call sets
            # them) and the profiler's device time a launch
            ak, bk = a[:k].contiguous(), b[:k].contiguous()
            records[name][f"ms_{k}"] = time_ms(torch, lambda: kern(ak, bk), 200)
            records[name][f"device_ms_{k}"] = sum(
                v for kname, v in kernel_ms(torch, lambda: kern(ak, bk), 20).items()
                if f"{name}_kernel" in kname)
            records[name][f"bound_ms_{k}"] = bound(
                dict(fe=k * prods / 73), 3 * 32 * k)["bound_ms"]
    return records


# ---- poseidon_perm (csrc/poseidon.cu): the flagship hash geometry, width
# 6 and 4 + 140 + 4 rounds
PS_BULK = 1 << 14  # poseidon_permute rows: the bulk node hashing (timed)
PS_SMALL = 1024  # rows of the inverse S-box's and the other widths' cases
PS_CHAIN_B, PS_CHAIN_W = 8, 5  # poseidon_chain held to its plain version: 8 x 4 hashes
PS_INV_W = 3  # the inverse S-box's chain: 8 x 2 hashes
SC_PROBE_N, SC_PROBE_REPS = 1 << 14, 256  # the depth probe: elements, products deep
# products a mod-l S-box makes: the cube 2; the inverse l - 2's 252
# squarings and a multiply for each of its set bits below the top
SBOX_PRODUCTS = {"cube": 2, "inverse": 252 + bin((1 << 252) + 27742317777372353535851937790883648491).count("1") - 1}


def poseidon_work(w: int, mask: list, sbox: str, hashes: int) -> tuple:
    """(ops for bound() of `hashes` permutations as the kernel computes
    them: the S-boxes' mod-l multiplies, the MDS's w x w 256 x 256-bit
    products summed unreduced and one reduction a lane a round; ops as the
    JAX program makes them, every MDS product reduced (bound_jax_ms); the
    chain depth of one row: a round at least an S-box and one multiply
    deep)."""
    R, nfull = len(mask), sum(1 for f in mask if f)
    boxes = hashes * (nfull * w + (R - nfull)) * SBOX_PRODUCTS[sbox]
    mix = hashes * R * w * w
    kernel = dict(sc=boxes, sc_prod=mix, sc_red=hashes * R * w)
    return kernel, dict(sc=boxes + mix), hashes * R * (SBOX_PRODUCTS[sbox] + 1)


def phase_kernels_poseidon(bp, torch, cc, F, dev, rng):
    """poseidon_permute / poseidon_chain word for word against their plain
    versions on the same CUDA inputs: the flagship cube permutation over
    2^14 rows under its round mask (4 + 140 + 4) and all full, the
    inverse S-box over 2^14 rows under a mixed mask and 1,024 under an
    all-full one (three and two of the flagship's rounds: its plain
    version is a Fermat power of plain products a round), widths 2 and 8, the chain at 8 x 4
    hashes (cube) and 8 x 2 (inverse); edge rows hold 0, 1 and l - 1; a
    few rows against the host permutation and the host Poseidon_hash_2
    chain.  The depth probe (sc_mul_test) is held to its plain version
    and gives one dependent sc_mul_canon's latency.  Timed (CUDA events):
    the permute at 2^14 rows, the chain at 8 x 4 and 8 x 253 hashes
    (phase 10 (b)'s), with their bounds and chain floors."""
    import numpy as np

    from bulletproofs_r1cs_gadgets_tpu_torch.gadgets.poseidon import (
        Poseidon_hash_2,
        Poseidon_permutation,
        SboxType,
    )
    from bulletproofs_r1cs_gadgets_tpu_torch.ops.poseidon import DevicePoseidon

    L = bp.L
    params = bp.PoseidonParams(6, 4, 4, 140)
    rk, mds, mask, _ = DevicePoseidon(params, "cube", device=dev)._consts()
    w, full = 6, torch.ones_like(mask)
    flag_mask = mask.tolist()

    def words(n, k):
        """(n, k, 8) random canonical words, rows 0-2 holding 0, 1, l - 1."""
        vals = [int.from_bytes(rng.bytes(32), "little") % L for _ in range(n * k)]
        for r in range(min(n, 3)):
            vals[r * k : (r + 1) * k] = [[0, 1, L - 1][(r + j) % 3] for j in range(k)]
        return torch.from_numpy(F.ints_to_words(vals).reshape(n, k, 8).copy()).to(dev)

    def same(name, got, plain_fn):
        plain, ms = timed_once(torch, plain_fn)
        assert torch.equal(got, plain), f"{name} != plain"
        return ms

    def nbytes(B, rows_in, rows_out, R, k):
        return 32 * (B * rows_in + B * rows_out + R * k + k * k) + 4 * R

    # the flagship cube permutation at 2^14 rows, both masks
    state = words(PS_BULK, w)
    out = {}
    for tag, m in (("flagship", mask), ("all full", full)):
        got = cc.poseidon_permute(state, rk, mds, m, "cube")
        out[tag] = same(f"poseidon_permute cube {tag}", got, lambda: cc.poseidon_permute_plain(
            state, rk, mds, m, "cube"))
        if tag == "flagship":
            host = [Poseidon_permutation([bp.Scalar(v) for v in F.words_to_ints(
                state[i].cpu().numpy())], params, SboxType.Cube) for i in range(4)]
            assert [F.words_to_ints(got[i].cpu().numpy()) for i in range(4)] == [
                [x.v for x in h] for h in host], "poseidon_permute != host"
    perm_plain_ms = out["flagship"]
    # the inverse S-box over the flagship's keys: a mixed mask at 2^14 rows
    # (the grid strides past its first pass, as phase 10 (e)'s launches do)
    # and an all-full one at 1,024
    small = state[:PS_SMALL].contiguous()
    for m, st in (([1, 0, 1], state), ([1, 1], small)):
        mt = torch.tensor(m, dtype=torch.int32, device=dev)
        keys = rk[: len(m)].contiguous()
        same(f"poseidon_permute inverse {m} {st.shape[0]} rows",
             cc.poseidon_permute(st, keys, mds, mt, "inverse"),
             lambda: cc.poseidon_permute_plain(st, keys, mds, mt, "inverse"))
    # the kernel's narrowest and widest states, random constants
    for k in (2, 8):
        st_k, rk_k, mds_k = words(PS_SMALL, k), words(3, k), words(k, k)
        mt = torch.tensor([1, 0, 1], dtype=torch.int32, device=dev)
        same(f"poseidon_permute width {k}",
             cc.poseidon_permute(st_k, rk_k, mds_k, mt, "cube"),
             lambda: cc.poseidon_permute_plain(st_k, rk_k, mds_k, mt, "cube"))
    # the chain: cube over the flagship rounds, inverse over three
    wit = words(PS_CHAIN_B, PS_CHAIN_W)
    got = cc.poseidon_chain(wit, rk, mds, mask, "cube")
    chain_plain_ms = same("poseidon_chain cube", got, lambda: cc.poseidon_chain_plain(
        wit, rk, mds, mask, "cube"))
    for i in range(PS_CHAIN_B):
        vals = F.words_to_ints(wit[i].cpu().numpy())
        acc = bp.Scalar(vals[0])
        for x in vals[1:]:
            acc = Poseidon_hash_2(acc, bp.Scalar(x), params, SboxType.Cube)
        assert F.words_to_ints(got[i : i + 1].cpu().numpy()) == [acc.v], \
            f"poseidon_chain row {i} != host Poseidon_hash_2 chain"
    wit3 = wit[:, :PS_INV_W].contiguous()
    mt = torch.tensor([1, 0, 1], dtype=torch.int32, device=dev)
    keys = rk[:3].contiguous()
    same("poseidon_chain inverse", cc.poseidon_chain(wit3, keys, mds, mt, "inverse"),
         lambda: cc.poseidon_chain_plain(wit3, keys, mds, mt, "inverse"))

    # the depth probe: one dependent mod-l multiply's latency
    pa, pb = words(SC_PROBE_N, 1)[:, 0].contiguous(), words(SC_PROBE_N, 1)[:, 0].flip(0).contiguous()
    for reps in (1, 64):
        same(f"sc_mul_test {reps} deep", cc.sc_mul_test(pa, pb, reps),
             lambda: cc.sc_mul_test_plain(pa, pb, reps))
    a32, b32 = pa[:32].contiguous(), pb[:32].contiguous()
    lat_ms = time_ms(torch, lambda: cc.sc_mul_test(a32, b32, SC_PROBE_REPS), 5) / SC_PROBE_REPS
    log(f"  sc_mul_canon: {lat_ms * 1e6:.1f} ns a dependent product "
        f"(32 elements x {SC_PROBE_REPS} deep)")

    # times and bounds
    records = {}
    def bounded(hashes, nb):
        """bound() of the kernel's work and bound_jax_ms, the JAX
        program's, for `hashes` permutations moving `nb` bytes."""
        kernel, jax_ops, depth = poseidon_work(w, flag_mask, "cube", hashes)
        jax = bound(jax_ops, nb)
        return dict(**bound(kernel, nb), bound_jax_ms=jax["bound_ms"],
                    jax_int_muls=jax["int_muls"]), depth

    b, depth = bounded(PS_BULK, nbytes(PS_BULK, w, w, len(flag_mask), w))
    records["poseidon_permute"] = dict(
        max_abs_err=0, rows=PS_BULK, plain_ms=perm_plain_ms,
        ms=time_ms(torch, lambda: cc.poseidon_permute(state, rk, mds, mask, "cube"), 5),
        **b, chain_ops=depth // PS_BULK, chain_ms=depth // PS_BULK * lat_ms)
    rec = dict(max_abs_err=0, rows=PS_CHAIN_B, hashes=PS_CHAIN_W - 1,
               plain_ms=chain_plain_ms,
               ms=time_ms(torch, lambda: cc.poseidon_chain(wit, rk, mds, mask, "cube"), 5))
    b, depth = bounded(PS_CHAIN_B * (PS_CHAIN_W - 1),
                       nbytes(PS_CHAIN_B, PS_CHAIN_W, 1, len(flag_mask), w))
    rec.update(b, chain_ops=depth // PS_CHAIN_B, chain_ms=depth // PS_CHAIN_B * lat_ms)
    W = ORACLE_W
    wit_full = words(ORACLE_B, W)
    b, depth = bounded(ORACLE_B * (W - 1), nbytes(ORACLE_B, W, 1, len(flag_mask), w))
    rec.update({f"ms_{W - 1}": time_ms(torch, lambda: cc.poseidon_chain(
        wit_full, rk, mds, mask, "cube"), 3),
        **{f"{k}_{W - 1}": v for k, v in b.items()},
        f"chain_ops_{W - 1}": depth // ORACLE_B,
        f"chain_ms_{W - 1}": depth // ORACLE_B * lat_ms})
    rec["sc_mul_latency_ns"] = lat_ms * 1e6
    records["poseidon_chain"] = rec
    for name, r in records.items():
        log(f"  {name}: " + json.dumps(r))
    return records


def phase_oracle(bp, torch, cc, F, gens, full, dev):
    """Phase 10, the device-oracle path at full width: (a) the depth-253
    proof through DeviceBackend("cuda"), (b) proving_step at B = 8,
    W = 254, N = 2^16 x 253 bits, (c) from_uniform_bytes over party 0's
    2^18 G seeds, (d) MsmEngine.msm at 2^16 and scalar_mul_shared over
    2^14 points, (e) DevicePoseidon's bulk node hashing with the inverse
    S-box: 2^14 2:1 hashes and 2^12 4:1 hashes, one poseidon_permute launch
    each.  Each part's launches are counted from 0 and its wall time
    recorded."""
    import numpy as np

    from bulletproofs_r1cs_gadgets_tpu_torch.core.pedersen import (
        GeneratorsChain,
        _chain_label,
    )
    from bulletproofs_r1cs_gadgets_tpu_torch.gadgets.poseidon import (
        Poseidon_hash_2,
        SboxType,
    )
    from bulletproofs_r1cs_gadgets_tpu_torch.ops import curve as C
    from bulletproofs_r1cs_gadgets_tpu_torch.ops.field import FP, FQ
    from bulletproofs_r1cs_gadgets_tpu_torch.ops.msm import MsmEngine
    from bulletproofs_r1cs_gadgets_tpu_torch.ops.native_backend import (
        NativeBackend,
    )
    from bulletproofs_r1cs_gadgets_tpu_torch.parallel import pipeline

    rng = np.random.RandomState(SEED + 10)
    out, launches = {}, dict.fromkeys(cc.LAUNCHES, 0)

    def part(tag, need):
        ran = dict(cc.LAUNCHES)
        for k in launches:
            launches[k] += ran[k]
        missing = [k for k in need if not ran[k]]
        assert not missing, f"phase 10 {tag}: {missing} not launched"
        log(f"  ({tag}) launches { {k: v for k, v in ran.items() if v} }")
        return ran

    # (a) the depth-253 proof through DeviceBackend, phase 4's prover / rng
    comp, tape, comms, prover, _ = full["case"]
    snap, want = full["oracle_case"]
    backend = bp.DeviceBackend(dev)
    cc.reset_launches()
    prover.restore(snap)
    prover.rng = np.random.RandomState(SEED)
    proof, out["a_prove_ms"] = timed_once(
        torch, lambda: prover.prove(gens, backend=backend))
    assert proof.to_bytes() == want, \
        "DeviceBackend proof differs from TorchBackend's"
    _, out["a_verify_ms"] = timed_once(
        torch, lambda: verify(bp, comp, tape, comms, proof, gens, backend))
    part("a", ("msm_chunk_acc", "fold_grid"))
    try:
        verify(bp, comp, tape, comms, tampered(bp, proof), gens, backend)
    except bp.VerificationError:
        pass
    else:
        raise AssertionError("DeviceBackend accepted a tampered proof")
    log(f"  (a) DeviceBackend depth-253 proof byte-identical to TorchBackend's,"
        f" prove {out['a_prove_ms']:.1f} ms, verify {out['a_verify_ms']:.1f} "
        f"ms; tampered copy rejected")

    # (b) proving_step: B proofs of a depth-253 path each, N points
    B, W, N = ORACLE_B, ORACLE_W, ORACLE_MSM_N
    vals = [[int.from_bytes(rng.bytes(32), "little") % bp.L for _ in range(W)]
            for _ in range(B)]
    witness = FQ.to_device([x for r in vals for x in r], dev).reshape(B, W, 8)
    points = F.from_raw(gens.G_raw(N), dev)
    rows = random_scalar_rows(bp, N, rng)
    bitw = torch.from_numpy(
        np.unpackbits(rows.view(np.uint8), axis=1, bitorder="little")[:, :253]
        .astype(np.int32)).to(dev)
    pipeline.flagship_hasher(dev)
    cc.reset_launches()
    (digest, commitment), out["b_step_ms"] = timed_once(
        torch, lambda: pipeline.proving_step(witness, points, bitw))
    ran = part("b", ("smul_lanes", "padd", "poseidon_chain"))
    assert ran["poseidon_chain"] == 1 and ran["mul_fq"] == 0, \
        "proving_step: not one poseidon_chain launch and no mul_fq"
    params = pipeline.flagship_hasher(dev).params
    exp = []
    for r in vals:
        acc = bp.Scalar(r[0])
        for x in r[1:]:
            acc = Poseidon_hash_2(acc, bp.Scalar(x), params, SboxType.Cube)
        exp.append(acc.v)
    assert FQ.to_ints(digest) == exp, "digests != host Poseidon chain"
    host = NativeBackend().msm(rows, gens.G(N))
    assert C.points_from_device(commitment)[0] == host, \
        "commitment != host MSM"
    log(f"  (b) proving_step B={B} W={W} N={N}: {out['b_step_ms']:.1f} ms; "
        f"digests equal the host Poseidon chain, commitment the host MSM")

    # (c) party 0's 2^18 G generators from their SHAKE-256 seeds
    n = GENS_N
    seeds = GeneratorsChain(_chain_label(b"G", 0)).uniform_bytes(n)
    cc.reset_launches()
    pts, out["c_derive_ms"] = timed_once(
        torch, lambda: C.uniform_bytes_to_device(seeds, dev))
    part("c", ("mul_fp", "padd"))
    G = F.from_raw(gens.G_raw(n), dev)
    X1, Y1, X2, Y2 = pts[:, 0], pts[:, 1], G[:, 0], G[:, 1]
    same = ((FP.mul(X1, Y2) == FP.mul(Y1, X2)).all(-1)
            | (FP.mul(X1, X2) == FP.mul(Y1, Y2)).all(-1))
    assert bool(same.all()), \
        f"{int((~same).sum())} derived points != BulletproofGens' G"
    log(f"  (c) {n} generators derived in {out['c_derive_ms']:.1f} ms, equal "
        f"to BulletproofGens({n})'s G")

    # (d) MsmEngine.msm at 2^16 (bench.py stage 1), scalar_mul_shared
    n = ORACLE_MSM_N
    rows = random_scalar_rows(bp, n, rng)
    eng = MsmEngine(dev)
    hostG = gens.G(n)
    eng.device_points(hostG)
    cc.reset_launches()
    got, out["d_msm_ms"] = timed_once(torch, lambda: eng.msm(rows, hostG))
    k = int.from_bytes(rng.bytes(32), "little") % bp.L
    pts = G[:SMUL_N]
    shared, out["d_shared_ms"] = timed_once(
        torch, lambda: C.scalar_mul_shared(pts, k))
    part("d", ("msm_block_totals", "pdbl"))
    assert got == NativeBackend().msm(rows, hostG), "MsmEngine.msm != host MSM"
    assert C.points_from_device(shared[:32]) == [
        p.scalar_mul(bp.Scalar(k)) for p in hostG[:32]
    ], "scalar_mul_shared != host"
    log(f"  (d) MsmEngine.msm {n} points {out['d_msm_ms']:.1f} ms, "
        f"scalar_mul_shared {SMUL_N} points {out['d_shared_ms']:.1f} ms")

    # (e) bulk node hashing: one level of 2^14 VSMT-2 nodes (the 2:1 hash,
    # inverse S-box) and 2^12 4:1 hashes through DevicePoseidon
    from bulletproofs_r1cs_gadgets_tpu_torch.gadgets.poseidon import (
        Poseidon_permutation,
    )
    from bulletproofs_r1cs_gadgets_tpu_torch.ops.poseidon import DevicePoseidon

    hasher = DevicePoseidon(params, "inverse", device=dev)
    n = PS_BULK
    kids = FQ.to_device([int.from_bytes(rng.bytes(32), "little") % bp.L
                         for _ in range(2 * n)], dev).reshape(n, 2, 8)
    quads = kids.reshape(n // 2, 4, 8)[: n // 4]
    cc.reset_launches()
    nodes, out["e_hash_2_ms"] = timed_once(
        torch, lambda: hasher.hash_2(kids[:, 0], kids[:, 1]))
    quad, out["e_hash_4_ms"] = timed_once(torch, lambda: hasher.hash_4(quads))
    ran = part("e", ("poseidon_permute",))
    assert ran["poseidon_permute"] == 2 and ran["mul_fq"] == 0
    inv = SboxType.Inverse
    # the first and last 8 rows and one in each 512 (2:1) or 256 (4:1):
    # every tile pass of the grid's stride
    for i in sorted({*range(8), *range(n - 8, n), *range(5, n, 512)}):
        xl, xr = FQ.to_ints(kids[i])
        assert FQ.to_ints(nodes[i : i + 1]) == [Poseidon_hash_2(
            bp.Scalar(xl), bp.Scalar(xr), params, inv).v], f"node {i} != host"
    for i in sorted({*range(8), *range(n // 4 - 8, n // 4), *range(5, n // 4, 256)}):
        state = [0] + FQ.to_ints(quads[i]) + [101]
        assert FQ.to_ints(quad[i : i + 1]) == [Poseidon_permutation(
            [bp.Scalar(v) for v in state], params, inv)[1].v], f"4:1 {i} != host"
    log(f"  (e) {n} 2:1 node hashes {out['e_hash_2_ms']:.1f} ms, {n // 4} 4:1 "
        f"hashes {out['e_hash_4_ms']:.1f} ms (inverse S-box); equal to the host")
    out["launches"] = launches
    return out


# ---- phase 11: the gadget zoo (BASELINE.json configs 1-4 and the other
# gadgets) through TorchBackend at the reference's sizes
ZOO_SET = [7 * i + 3 for i in range(32)]  # the 32-element set
ZOO_MIMC_ROUNDS = 322  # gadget_mimc.rs:15: 644 multipliers
ZOO_VSMT4_DEPTH = 64  # BASELINE.json config 4


class Wires:
    """One side of a circuit: the prover commits values with blindings
    ``Scalar.random(rng)``, the verifier binds the commitments in order.
    ``val(x)`` is the assignment (None on the verifier's side)."""

    def __init__(self, bp, cs, w):
        self.bp, self.cs = bp, cs
        self.prover = isinstance(cs, bp.Prover)
        self.rng = w if self.prover else None
        self.comms = [] if self.prover else list(w)
        self.i = 0

    def commit(self, value):
        bp = self.bp
        if self.prover:
            s = value if isinstance(value, bp.Scalar) else bp.Scalar(value)
            com, var = self.cs.commit(s, bp.Scalar.random(self.rng))
            self.comms.append(com)
            return var
        var = self.cs.commit(self.comms[self.i])
        self.i += 1
        return var

    def val(self, x):
        return x if self.prover else None


def zoo_bound(bp, cs, w):
    """The 64-bit bound check (gadget_bound_check.rs:49-116)."""
    from bulletproofs_r1cs_gadgets_tpu_torch.gadgets.bound_check import (
        bound_check_gadget,
    )
    from bulletproofs_r1cs_gadgets_tpu_torch.gadgets.r1cs_utils import (
        AllocatedQuantity as Q,
    )

    lo, hi, v = 1 << 62, (1 << 64) - 1, 0xDEADBEEF12345678
    x = Wires(bp, cs, w)
    qs = [Q(x.commit(c), x.val(c)) for c in (v, v - lo, hi - v)]
    bound_check_gadget(cs, *qs, hi, lo, 64)
    return x.comms


def zoo_range(bp, cs, w):
    """The 64-bit range proof (gadget_range_proof.rs:127-202)."""
    from bulletproofs_r1cs_gadgets_tpu_torch.gadgets.r1cs_utils import (
        AllocatedQuantity as Q,
        constrain_lc_with_scalar,
        positive_no_gadget,
    )

    lo, hi, v = 1 << 62, (1 << 64) - 1, 0xC0FFEE0123456789
    x = Wires(bp, cs, w)
    va = x.commit(v - lo)
    positive_no_gadget(cs, Q(va, x.val(v - lo)), 64)
    vb = x.commit(hi - v)
    positive_no_gadget(cs, Q(vb, x.val(hi - v)), 64)
    constrain_lc_with_scalar(cs, va + vb, bp.Scalar(hi - lo))
    return x.comms


def zoo_member(bp, cs, w):
    """Set membership over 32 elements (gadget_set_membership.rs)."""
    from bulletproofs_r1cs_gadgets_tpu_torch.gadgets import set_membership as m
    from bulletproofs_r1cs_gadgets_tpu_torch.gadgets.r1cs_utils import (
        AllocatedQuantity as Q,
    )

    value = ZOO_SET[17]
    x = Wires(bp, cs, w)
    bits = []
    for elem in ZOO_SET:
        b = int(elem == value)
        q = Q(x.commit(b), x.val(b))
        m.bit_gadget(cs, q)
        bits.append(q)
    m.vector_sum_gadget(cs, bits, 1)
    m.vector_product_gadget(cs, ZOO_SET, bits, Q(x.commit(value), x.val(value)))
    return x.comms


def zoo_member_1(bp, cs, w):
    """Set membership by a product of differences over 32 elements
    (gadget_set_membership_1.rs)."""
    from bulletproofs_r1cs_gadgets_tpu_torch.gadgets import set_membership_1 as m
    from bulletproofs_r1cs_gadgets_tpu_torch.gadgets.r1cs_utils import (
        AllocatedScalar as A,
    )

    val = bp.Scalar(ZOO_SET[5])
    x = Wires(bp, cs, w)
    v = A(x.commit(val), x.val(val))
    diffs = [A(x.commit(bp.Scalar(e) - val), x.val(bp.Scalar(e) - val))
             for e in ZOO_SET]
    m.set_membership_1_gadget(cs, v, diffs, ZOO_SET)
    return x.comms


def zoo_non_member(bp, cs, w):
    """Set non-membership over 32 elements
    (gadget_set_non_membership.rs)."""
    from bulletproofs_r1cs_gadgets_tpu_torch.gadgets import set_non_membership as m
    from bulletproofs_r1cs_gadgets_tpu_torch.gadgets.r1cs_utils import (
        AllocatedScalar as A,
    )

    val = bp.Scalar(1000)
    x = Wires(bp, cs, w)
    v = A(x.commit(val), x.val(val))
    diffs, invs = [], []
    for e in ZOO_SET:
        d = bp.Scalar(e) - val
        diffs.append(A(x.commit(d), x.val(d)))
        invs.append(A(x.commit(d.invert()), x.val(d.invert())))
    m.set_non_membership_gadget(cs, v, diffs, invs, ZOO_SET)
    return x.comms


def zoo_not_equals(bp, cs, w):
    """gadget_not_equals.rs: v = 10 != 5."""
    from bulletproofs_r1cs_gadgets_tpu_torch.gadgets.not_equals import (
        not_equals_gadget,
    )
    from bulletproofs_r1cs_gadgets_tpu_torch.gadgets.r1cs_utils import (
        AllocatedScalar as A,
    )

    val = bp.Scalar(10)
    d = bp.Scalar(5) - val
    x = Wires(bp, cs, w)
    qs = [A(x.commit(s), x.val(s)) for s in (val, d, d.invert())]
    not_equals_gadget(cs, *qs, 5)
    return x.comms


def zoo_factors(bp, cs, w):
    """factors.rs: 17 * 19 = 323."""
    from bulletproofs_r1cs_gadgets_tpu_torch.gadgets.factors import factors_gadget
    from bulletproofs_r1cs_gadgets_tpu_torch.gadgets.r1cs_utils import (
        AllocatedScalar as A,
    )

    p, q = bp.Scalar(17), bp.Scalar(19)
    x = Wires(bp, cs, w)
    factors_gadget(cs, A(x.commit(p), x.val(p)), A(x.commit(q), x.val(q)),
                   p * q)
    return x.comms


def zoo_mimc(bp, cs, w):
    """MiMC preimage, the full 322 rounds (gadget_mimc.rs:91-175)."""
    import random

    from bulletproofs_r1cs_gadgets_tpu_torch.gadgets.mimc import mimc, mimc_gadget
    from bulletproofs_r1cs_gadgets_tpu_torch.gadgets.r1cs_utils import (
        AllocatedScalar as A,
    )

    rnd = random.Random(24)
    consts = [bp.Scalar(rnd.randrange(bp.L)) for _ in range(ZOO_MIMC_ROUNDS)]
    xl, xr = bp.Scalar(5), bp.Scalar(6)
    x = Wires(bp, cs, w)
    mimc_gadget(cs, A(x.commit(xl), x.val(xl)), A(x.commit(xr), x.val(xr)),
                ZOO_MIMC_ROUNDS, consts, mimc(xl, xr, consts))
    return x.comms


def zoo_poseidon(sbox_name):
    def build(bp, cs, w):
        """The Poseidon 2:1 preimage proof (bench.py:161-226's circuit)."""
        from bulletproofs_r1cs_gadgets_tpu_torch.gadgets.poseidon import (
            Poseidon_hash_2,
            SboxType,
            allocate_statics_for_prover,
            allocate_statics_for_verifier,
        )
        from bulletproofs_r1cs_gadgets_tpu_torch.models.compiled import (
            CompiledPoseidon2,
        )

        sbox = getattr(SboxType, sbox_name)
        params = bp.PoseidonParams(6, 4, 4, 140)
        comp = CompiledPoseidon2(params, sbox)
        xl, xr = bp.Scalar(31), bp.Scalar(59)
        tape = comp.tape(Poseidon_hash_2(xl, xr, params, sbox))
        x = Wires(bp, cs, w)
        x.commit(xl)
        x.commit(xr)
        if x.prover:
            allocate_statics_for_prover(cs, 4)
            cs.load_compiled(tape, *comp.witness(xl, xr))
        else:
            allocate_statics_for_verifier(cs, 4, bp.PedersenGens.default())
            cs.load_compiled(tape, comp.num_multipliers)
        return x.comms

    return build


def zoo_vsmt4(bp, cs, w):
    """VSMT-4 membership at depth 64 (BASELINE.json config 4,
    gadget_vsmt_4.rs:199-312; bench.py stage 3b's synthetic siblings)."""
    from bulletproofs_r1cs_gadgets_tpu_torch.models.compiled import CompiledVSMT4

    depth = ZOO_VSMT4_DEPTH
    comp = CompiledVSMT4(bp.PoseidonParams(6, 4, 4, 140), depth)
    k = bp.Scalar(7)
    nodes = [bp.Scalar(1000 + i) for i in range(3 * depth)]
    aL, aR, aO = comp.witness(k, k, nodes)
    tape = comp.tape(comp._root)
    if isinstance(cs, bp.Prover):
        comms = comp.commit_prover(cs, k, k, nodes, rng=w)
        cs.load_compiled(tape, aL, aR, aO)
        return comms
    comp.commit_verifier(cs, w, bp.PedersenGens.default())
    cs.load_compiled(tape, comp.num_multipliers)
    return w


# name: (circuit, transcript label); every prover's rng SEED + 1100 + 10 i,
# its blindings' SEED + 1101 + 10 i
ZOO = {
    "bound_check_64": (zoo_bound, b"BoundsTest"),
    "range_proof_64": (zoo_range, b"RangeProofTest"),
    "set_membership_32": (zoo_member, b"SetMemebershipTest"),
    "set_non_membership_32": (zoo_non_member, b"SetNonMemebershipTest"),
    "set_membership_1_32": (zoo_member_1, b"SetMemebership1Test"),
    "not_equals": (zoo_not_equals, b"NotEqualsTest"),
    "factors": (zoo_factors, b"Factors"),
    "mimc_322": (zoo_mimc, b"MiMC"),
    "poseidon2_cube": (zoo_poseidon("Cube"), b"PoseidonBench"),
    "poseidon2_inverse": (zoo_poseidon("Inverse"), b"PoseidonBench"),
    "vsmt4_64": (zoo_vsmt4, b"VSMT"),
}
ZOO_HOST_NATIVE = ("vsmt4_64",)  # host leg on NativeBackend: see zoo_host_hex


def zoo_prover(bp, i: int, name: str):
    """(commitments, prover) of ZOO[name], seeded by its index."""
    import numpy as np

    build, label = ZOO[name]
    prover = bp.Prover(bp.PedersenGens.default(), bp.Transcript(label),
                       rng=np.random.RandomState(SEED + 1100 + 10 * i))
    comms = build(bp, prover, np.random.RandomState(SEED + 1101 + 10 * i))
    return comms, prover


def zoo_verify(bp, name, comms, proof, gens, backend):
    build, label = ZOO[name]
    verifier = bp.Verifier(bp.Transcript(label))
    build(bp, verifier, comms)
    verifier.verify(proof, bp.PedersenGens.default(), gens, backend=backend)


def zoo_host_hex() -> str:
    """Every ZOO proof through the port's host path, as JSON of hex: what
    ``chip_smoke.py --zoo-host`` prints, in a process of its own beside
    the card's phases.  VSMT-4 at depth 64 (2^16 padded) would take
    ~12 min of one core on the host path, so its host leg is the port's
    ``NativeBackend`` (the C++ CPU backend, byte-identical to the host
    path by phase 6's gate)."""
    sys.path.insert(0, ROOT)
    import bulletproofs_r1cs_gadgets_tpu_torch as bp
    from bulletproofs_r1cs_gadgets_tpu_torch.ops.native_backend import (
        NativeBackend,
    )

    gens = bp.BulletproofGens(GENS_N)
    out = {}
    for i, name in enumerate(ZOO):
        _, prover = zoo_prover(bp, i, name)
        be = NativeBackend() if name in ZOO_HOST_NATIVE else None
        out[name] = prover.prove(gens, backend=be).to_bytes().hex()
    return json.dumps(out, separators=(",", ":"))


def start_host(flag: str):
    """Start a host-path leg (``--gate-host``, ``--zoo-host``) in a
    low-priority process of its own; the phase collects it."""
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), flag],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )


def phase_zoo(bp, torch, cc, gens, host):
    """Every ZOO circuit through TorchBackend("cuda") on the default
    route: its proof byte-identical to the host leg (`host`, the
    ``--zoo-host`` process), verified through the backend, a tampered
    copy rejected; per circuit its padded size, prove and verify wall
    times and launch counts (counted from 0 before each prove)."""
    backend = bp.TorchBackend("cuda")
    out, launches = {}, dict.fromkeys(cc.LAUNCHES, 0)
    proofs = {}
    for i, name in enumerate(ZOO):
        comms, prover = zoo_prover(bp, i, name)
        cc.reset_launches()
        proof, prove_ms = timed_once(
            torch, lambda: prover.prove(gens, backend=backend))
        _, verify_ms = timed_once(
            torch, lambda: zoo_verify(bp, name, comms, proof, gens, backend))
        ran = {k: v for k, v in cc.LAUNCHES.items() if v}
        for k, v in ran.items():
            launches[k] += v
        try:
            zoo_verify(bp, name, comms, tampered(bp, proof), gens, backend)
        except bp.VerificationError:
            pass
        else:
            raise AssertionError(f"{name}: tampered proof accepted")
        proofs[name] = proof.to_bytes()
        out[name] = dict(
            multipliers=prover.num_multipliers(),
            padded_n=1 << len(proof.ipp_proof.L_vec),
            prove_ms=prove_ms, verify_ms=verify_ms, launches=ran)
        log(f"  {name}: {out[name]}")
    backend.evict_gens()
    t0 = time.time()
    got, err = host.communicate(timeout=900)
    assert host.returncode == 0, f"host-path zoo proofs failed: {err[-2000:]}"
    want = json.loads(got.split()[-1])
    for name in ZOO:
        assert proofs[name].hex() == want[name], \
            f"{name}: card proof differs from the host path's"
    log(f"  {len(ZOO)} proofs byte-identical to the host path (waited "
        f"{time.time() - t0:.1f} s), verified, tampered copies rejected")
    return out, launches


# ---- phase 12: the sharded oracle path (parallel/sharded_backend.py,
# make_sharded_step, graft_entry.dryrun_multichip)


def phase_sharded_oracle(bp, torch, cc, F, gens, full, reuse, oracle_ms):
    """(a) phase 4's depth-253 prover, restored, through ShardedMsmBackend
    over 4 shards: byte-identical to phase 4's proof, verified through the
    backend, a tampered copy rejected, its wall time beside phase 10 (a)'s
    DeviceBackend (`oracle_ms`); (b) phase 5's first four depth-253
    provers, restored, through prove_provers on BatchShardedBackend over a
    (batch 2, points 2) mesh: each proof byte-identical to phase 5's, one
    batch_verify of the four through the backend; (c) make_sharded_step on
    that mesh at B = 8, W = 254 (phase 10 (b)'s), 2^16 points x 253 bits,
    one poseidon_chain launch a batch row and no mul_fq: digests
    equal to the host Poseidon chain, the checksum their sum mod l, the
    total the host MSM; (d) graft_entry.dryrun_multichip(4) over the
    visible cards (four shards on one card when there is one).  Each
    part's launches are counted from 0."""
    import numpy as np

    from bulletproofs_r1cs_gadgets_tpu_torch import graft_entry
    from bulletproofs_r1cs_gadgets_tpu_torch.gadgets.poseidon import (
        Poseidon_hash_2,
        SboxType,
    )
    from bulletproofs_r1cs_gadgets_tpu_torch.ops import curve as C
    from bulletproofs_r1cs_gadgets_tpu_torch.ops.field import FQ
    from bulletproofs_r1cs_gadgets_tpu_torch.ops.native_backend import (
        NativeBackend,
    )
    from bulletproofs_r1cs_gadgets_tpu_torch.parallel import pipeline
    from bulletproofs_r1cs_gadgets_tpu_torch.parallel.mesh import make_mesh
    from bulletproofs_r1cs_gadgets_tpu_torch.parallel.sharded_backend import (
        BatchShardedBackend,
        ShardedMsmBackend,
    )

    rng = np.random.RandomState(SEED + 12)
    out, launches = {}, dict.fromkeys(cc.LAUNCHES, 0)

    def part(tag, need):
        ran = dict(cc.LAUNCHES)
        for k in launches:
            launches[k] += ran[k]
        missing = [k for k in need if not ran[k]]
        assert not missing, f"phase 12 {tag}: {missing} not launched"
        out[f"{tag}_launches"] = {k: v for k, v in ran.items() if v}
        log(f"  ({tag}) launches {out[f'{tag}_launches']}")

    devices = card_devices(torch, 4)
    # (a) one depth-253 proof, every MSM over 4 shards
    comp, tape, comms, prover, _ = full["case"]
    snap, want = full["oracle_case"]
    backend = ShardedMsmBackend(devices)
    log(f"  {backend!r}")
    cc.reset_launches()
    prover.restore(snap)
    prover.rng = np.random.RandomState(SEED)
    proof, out["a_prove_ms"] = timed_once(
        torch, lambda: prover.prove(gens, backend=backend))
    assert proof.to_bytes() == want, \
        "ShardedMsmBackend proof differs from phase 4's"
    _, out["a_verify_ms"] = timed_once(
        torch, lambda: verify(bp, comp, tape, comms, proof, gens, backend))
    part("a", ("msm_chunk_acc", "padd", "fold_grid"))
    try:
        verify(bp, comp, tape, comms, tampered(bp, proof), gens, backend)
    except bp.VerificationError:
        pass
    else:
        raise AssertionError("ShardedMsmBackend accepted a tampered proof")
    log(f"  (a) depth-253 proof over 4 shards byte-identical to phase 4's, "
        f"prove {out['a_prove_ms']:.1f} ms, verify {out['a_verify_ms']:.1f} "
        f"ms (DeviceBackend, phase 10 (a): {oracle_ms['a_prove_ms']:.1f} / "
        f"{oracle_ms['a_verify_ms']:.1f} ms); tampered copy rejected")
    del backend

    # (b) four depth-253 proofs in lockstep on a (2, 2) mesh
    circuit, jobs, snaps, seeds, batch_bytes = reuse
    provers = [j[3] for j in jobs]
    for p, s, seed in zip(provers, snaps, seeds):
        p.restore(s)
        p.rng = np.random.RandomState(seed)
    mesh = make_mesh(devices=devices, batch_axis=2)
    bbackend = BatchShardedBackend(mesh)
    log(f"  {mesh!r}")
    cc.reset_launches()
    proofs, out["b_prove_ms"] = timed_once(
        torch, lambda: bp.prove_provers(provers, gens, backend=bbackend))
    for i, (got, want_i) in enumerate(zip(proofs, batch_bytes)):
        assert got.to_bytes() == want_i, f"lockstep proof {i} != phase 5's"
    _, out["b_verify_ms"] = timed_once(torch, lambda: bp.batch_verify(
        [verifier_for(bp, circuit[0], j[1], j[2]) for j in jobs], proofs,
        bp.PedersenGens.default(), gens, backend=bbackend))
    part("b", ("msm_chunk_acc", "padd", "fold_grid"))
    log(f"  (b) {len(proofs)} depth-253 proofs in lockstep byte-identical to "
        f"phase 5's: prove {out['b_prove_ms']:.1f} ms, one batch_verify "
        f"{out['b_verify_ms']:.1f} ms")
    del bbackend

    # (c) the sharded step
    B, W, N = ORACLE_B, ORACLE_W, ORACLE_MSM_N
    vals = [[int.from_bytes(rng.bytes(32), "little") % bp.L for _ in range(W)]
            for _ in range(B)]
    witness = FQ.to_device([x for r in vals for x in r], devices[0]
                           ).reshape(B, W, 8)
    points = F.from_raw(gens.G_raw(N), devices[0])
    rows = random_scalar_rows(bp, N, rng)
    bitw = torch.from_numpy(
        np.unpackbits(rows.view(np.uint8), axis=1, bitorder="little")[:, :253]
        .astype(np.int32)).to(devices[0])
    step = pipeline.make_sharded_step(mesh)
    cc.reset_launches()
    (digest, checksum, total), out["c_step_ms"] = timed_once(
        torch, lambda: step(witness, points, bitw))
    part("c", ("smul_lanes", "padd", "poseidon_chain"))
    assert out["c_launches"]["poseidon_chain"] == len(mesh.rows("batch")) \
        and "mul_fq" not in out["c_launches"], \
        "make_sharded_step: not one poseidon_chain launch a batch row"
    params = pipeline.flagship_hasher(devices[0]).params
    exp = []
    for r in vals:
        acc = bp.Scalar(r[0])
        for x in r[1:]:
            acc = Poseidon_hash_2(acc, bp.Scalar(x), params, SboxType.Cube)
        exp.append(acc.v)
    assert FQ.to_ints(digest) == exp, "digests != host Poseidon chain"
    assert FQ.to_ints(checksum[None]) == [sum(exp) % bp.L], "checksum"
    assert C.points_from_device(total)[0] == NativeBackend().msm(
        rows, gens.G(N)), "sharded total != host MSM"
    log(f"  (c) make_sharded_step B={B} W={W} N={N}: {out['c_step_ms']:.1f} "
        f"ms; digests equal the host Poseidon chain, checksum their sum mod "
        f"l, total the host MSM")

    # (d) the dry run
    cc.reset_launches()
    _, out["d_dryrun_ms"] = timed_once(
        torch, lambda: graft_entry.dryrun_multichip(4, devices=devices))
    part("d", ("msm_chunk_acc", "padd", "fold_grid", "msm_grid_local"))
    return out, launches


def main() -> int:
    hosts = {"--gate-host": gate_host_proof_hex, "--zoo-host": zoo_host_hex}
    if len(sys.argv) == 2 and sys.argv[1] in hosts:
        os.nice(19)  # beside the card's phases: yield the host's cores
        print(hosts[sys.argv[1]](), flush=True)
        return 0
    sys.path.insert(0, ROOT)
    import torch

    with Phase("0 device"):
        card = phase_device(torch)
    import bulletproofs_r1cs_gadgets_tpu_torch as bp
    from bulletproofs_r1cs_gadgets_tpu_torch.ops import build
    from bulletproofs_r1cs_gadgets_tpu_torch.ops import cuda_curve as cc
    from bulletproofs_r1cs_gadgets_tpu_torch.ops import field as F

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    with Phase("1 build"):
        log(f"  native C++ host library loaded: {bp.NATIVE_LOADED}")
        if not bp.NATIVE_LOADED:
            raise RuntimeError("the port's C++ host library did not load")
        t0 = time.time()
        build.load()
        log(f"  kernels built and loaded in {time.time() - t0:.2f} s")
        redesigned = {k: v for k, v in build.report().items()
                      if any(s in k for s in ("win", "msm_w4", "fold_w3h",
                                              "fold_bits", "table_kernel",
                                              "fold_c", "fold_grid",
                                              "pointwise", "smul_lanes",
                                              "poseidon_kernel"))}
        for part in ("msm_w4_tiles", "fold_w3h", "fold_bits", "table_kernel",
                     "fold_c_group", "fold_c_thread", "fold_grid_group",
                     "fold_grid_thread", "pointwise_kernel",
                     "smul_lanes_group", "smul_lanes_thread",
                     "poseidon_kernel"):
            assert any(part in k for k in redesigned), f"no ptxas report for {part}"
        log("ptxas " + json.dumps(redesigned))
    with Phase("gens"):
        gens = bp.BulletproofGens(1 << 18)
        gens_small = bp.BulletproofGens(1 << 12)
    # phase 6's and phase 11's host-path proofs, beside the card
    host, zoo_host = start_host("--gate-host"), start_host("--zoo-host")
    try:
        with Phase("2 kernels vs plain"):
            records = phase_kernels(bp, torch, cc, F, gens, dev)
        with Phase("3 byte identity"):
            small_launches = phase_bytes(bp, torch, cc, gens_small)
        with Phase("tree"):
            params, tree = build_tree(bp, DEPTH)
        with Phase("4 full proof"):
            full = phase_full(bp, torch, cc, gens, params, tree)
        with Phase("4b verifier rows vs plain"):
            records.update(phase_kernels_rows(bp, torch, cc, full["case"],
                                              dev))
        with Phase("5 batch"):
            batch = phase_batch(bp, torch, cc, gens, params, tree)
        with Phase("6 equivalence gate"):
            gate_launches, gate_times = phase_gate(bp, torch, cc, host)
        reuse = batch.pop("reuse")  # phase 5's circuit, provers and proofs
        with Phase("7 placement"):
            placed = phase_placement(bp, torch, cc, F, gens, reuse)
        with Phase("8 sharded walk"):
            sharded = phase_sharded(bp, torch, cc, F, gens, full["case"])
        with Phase("9 stream"):
            stream = phase_stream(bp, torch, cc, gens, params, tree, reuse[0])
        with Phase("10 device-oracle path"):
            oracle = phase_oracle(bp, torch, cc, F, gens, full, dev)
        with Phase("11 gadget zoo"):
            zoo, zoo_launches = phase_zoo(bp, torch, cc, gens, zoo_host)
    finally:
        for proc in (host, zoo_host):
            if proc.poll() is None:
                proc.kill()
            proc.communicate()
    with Phase("12 sharded oracle path"):
        shoracle, shoracle_launches = phase_sharded_oracle(
            bp, torch, cc, F, gens, full, reuse, oracle)
    runs = (small_launches, full["launches"], full["route_launches"],
            batch["launches"], gate_launches, placed["launches"],
            sharded["launches"], stream["launches"], oracle.pop("launches"),
            zoo_launches, shoracle_launches)
    kernels = [
        dict(
            name=name, route="cuda", source=SOURCES[name],
            replaces=REPLACES[name],
            launches=sum(run[name] for run in runs),
            **records[name],
        )
        for name in KERNELS
    ]
    idle = [k["name"] for k in kernels
            if not k["launches"] and k["name"] not in OFF_PATH]
    assert not idle, f"kernels never launched on a path: {idle}"
    summary = {
        "single": {k: v for k, v in full.items()
                   if k not in ("launches", "route_launches", "case",
                                "oracle_case")},
        "batch": {k: v for k, v in batch.items() if k != "launches"},
        "gate_ms": gate_times,
        "placed": {k: v for k, v in placed.items() if k != "launches"},
        "sharded": {k: v for k, v in sharded.items() if k != "launches"},
        "stream": {k: v for k, v in stream.items() if k != "launches"},
        "oracle": oracle,
        "zoo": zoo,
        "sharded_oracle": shoracle,
    }
    log("summary " + json.dumps(summary))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SystemExit:
        raise
    except BaseException:
        import traceback

        traceback.print_exc()
        sys.exit(1)
