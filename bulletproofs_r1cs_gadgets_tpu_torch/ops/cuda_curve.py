"""Wrappers for the port's Hopper kernels, with their plain versions.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty`` and then

* for CPU tensors, runs the plain torch version beside it (this is what
  the CPU tests exercise);
* for CUDA tensors, launches its kernel from ``csrc/msm_fold.cu``,
  ``csrc/win.cu``, ``csrc/fold_w3h.cu``, ``csrc/oracle.cu`` or
  ``csrc/poseidon.cu`` on the current stream of the
  tensors' device (from any thread), raises if the launch failed, and
  adds one to ``LAUNCHES[name]`` and to the ``launches`` count of the
  innermost open span (``utils/metrics``).  There is no fallback to the
  plain version.

Tensors (see :mod:`.field`): points ``(n, 4, 8)`` int32, w4 and bit
scalar words ``(n, 8)`` int32, w5 words ``(n, 16)`` int32, w5 / w4
tables ``(n, 16, 4, 8)`` / ``(n, 8, 4, 8)`` int32 (niels entries),
half-width fold words ``(sides, 2, 2, 8)`` int32, constant fold words
``(sides, 2, 8)`` int32, w2 fold words ``(v, 8)`` or one ``(1, 8)`` row
for every lane, field elements ``(n, 8)`` int32, accumulators
``(k, 4, 8)``, Poseidon states ``(B, w, 8)`` and witnesses ``(B, W, 8)``
int32 (canonical words mod l).  Outputs are canonical.

Kernel notes (what each replaces, what bounds it on an H100, what its
design does about that):

``msm_w4`` replaces ``pallas_curve.msm_chunk_acc_w4`` (ops/pallas_curve.py
:369, the ``_ladder_w4`` signed-digit ladder + ``emit_block_reduce``)
together with the per-chunk loop of ``chunks.msm_chain``.  Bound: 32-bit
integer multiplies (per live point a 7-operation table and one niels add
per nonzero digit, ~64; 160 B read per point).  Design (``csrc/win.cu``):
windows, then Horner.  A first pass gives each block tiles of 16 or 64
points (the library picks by size and card); per tile
the block builds every point's eight multiples in niels form in shared
memory (two threads a point) and each thread adds, for one of the 64
windows, the entries its digits select over half the tile into a
register-resident sum (the walkers' inlined niels add on the carry-chain
multiply); one partial per window and block.  The walkers' second pass
and cooperative Horner (``msm_win_windows<4>``, ``msm_win_horner<4>``)
finish, with the incoming accumulator as the chain.  The first pass's
blocks come from the card's resident blocks, so the library sizes the
scratch (``bp_w4_partials``).

``msm_w4_pair`` replaces ``pallas_curve.msm_grid_pair`` (:768).  Same
bound and design, over two segments, points [0, lo_limit) and [half,
half + hi_limit) (a grid dimension of the first pass, one Horner walk
each); limits skip work, and each segment chains its own accumulator.

``fold_bits`` replaces ``pallas_curve.fold_chunk`` (:1566, ``_emit_fold``
:1533): out_i = wl_i * L_i + wr_i * R_i over bits 252..0 of raw bit
words.  Bound: at the main path's 1,024-2,048 lanes, latency (the
throughput bound, ~0.02-0.04 ms, is out of reach of so few outputs).
Design (``csrc/msm_fold.cu``): a group of 8 lanes per
output on the walkers' cooperative point operations (two stages of four
multiplies, the products exchanged by shuffles), four outputs a warp;
each scalar recoded in the kernel into 64 signed base-16 digits, an
8-entry niels table of L and one of R in shared memory, then Straus: 64
windows of 4 doublings and one niels add per nonzero digit (a zero
digit of every group in the warp adds nothing, so ``wl = 1`` costs one
add).

``msm_lane`` replaces ``pallas_curve.msm_lane_dyn`` (:1515,
``_msm_lane_kernel`` :1473): v independent MSM totals, one per segment of
``seg`` points (the flotilla of batched frozen IPP rounds).  Bound and
design: ``msm_w4``'s, over v segments (``csrc/win.cu``: the first pass's
grid dimension, one Horner walk a segment, each walk on its own warp) and
no chain (the Horner pass starts each total from the identity); the
TPU's lattice-position output is a (v, 4, 8) tensor.

``table_w5`` replaces ``pallas_curve.table_grid5_full`` (:1233,
``_table16_body`` :1174, ``_to_niels`` :934): the 16 multiples (k+1)P of
each generator in niels form, built once per generator set.  Bound: the
integer multiplies of its 15 point operations per point, then the 2 KiB
store.  Design (``csrc/win.cu``): two threads a
point, four warps per role over 128 points, each running half of the TPU's
doubling/adding sequence on inlined carry-chain operations (the same
residues, so the canonical words equal the plain version's) and keeping
only the points a later step reads; each step's entries are staged in
shared memory and stored as 16-byte vectors, an entry's 128 contiguous
bytes by eight lanes.

``msm_win5`` replaces ``pallas_curve.msm_win5_dyn`` (:1345,
``_msm_win5_kernel`` :1263, ``_win5_digit_select`` :1236): the w5
window-accumulator MSM over a ``table_w5`` table, with the TPU's
[v, poff, woff, split, poff2] walk in points.  Bound: integer
multiplies (51 niels adds of 8 field multiplies per point, against ~330
point operations per point for the w4 ladder), then the 128 B table read
per point and window.  Design (``csrc/win.cu``): the windows run in
parallel, a block per window and range of steps, as many
blocks as the card holds at once; each thread keeps its sum in registers
through inlined niels adds on the carry-chain multiply (``fe_mul_cc``)
and loads the next entry during the current add; a warp shuffle tree sums
each block, a warp per window sums the blocks, and a warp per walk runs
Horner with each stage's four operations on lanes (a multiply on two).
On the card: 1.78 ms at 143,704 steps (3.02 before), the first pass at
2.7x the bound, held by the multiply's instruction mix; the Horner tail
0.27 ms a launch (1.0 before).  ``fe_mul_test`` holds the carry-chain multiply and
squaring against ``fe_mul`` (test entry, no launch count).

``table_w4`` replaces ``pallas_curve.table_grid_full`` / ``_half`` /
``_full_donate`` / ``_half_donate`` (:1012-1026, ``_table_body`` :922,
``_to_niels`` :934): the 8 multiples over the combined [G' | H'] layout,
rebuilt each combined round.  One kernel: the four TPU variants are
capacity shapes and XLA buffer donation; here `out` takes the previous
round's table storage.  Bound: the multiplies of 7 point operations per
point, then the 1 KiB store.  Design: ``table_w5``'s kernel template at 8
entries, the first four steps of each role (entry for entry its first
half).

``msm_win_pair`` replaces ``pallas_curve.msm_win_pair_dyn`` (:1462,
``_msm_win_pair_kernel`` :1360, ``_win_digit_select`` :1037): both w4
window walks of a combined IPP round in one launch.  Bound: integer
multiplies (64 niels adds per point), then the table stream.  Design:
``msm_win5``'s kernel template at 4 bits (64 windows, 8 entries) with a
walk dimension, each walk with its own [v, poff, woff, split, poff2];
the first pass is sized over both walks, and the Horner pass runs a warp
per walk.  On the card: 3.22 ms at n = 2^16 (5.39 before).

``fold_w3h`` replaces ``pallas_curve.fold_grid_w3h`` (:646,
``_fold_w3h_call`` :618, ``_fold_w3h_kernel`` :604, ``_emit_fold_w3h``
:574, ``_w3_digit_select`` :561), and ``fold_w3h_comb`` replaces
``fold_grid_w3h_comb`` (:685, ``_fold_w3h_comb_call`` :649): out[i] =
beta * P[i] + alpha * P[i + v] with two signed half-width pairs split at
a breakpoint, one side or both sides of the combined layout.  Bound:
integer multiplies (~226 point operations per point).  Design
(``csrc/fold_w3h.cu``): one thread per output point, two 4-entry niels
tables and one shared doubling chain over 44 signed w3 digits, every
point operation inlined on the carry-chain multiply
(squares by ``fe_sq_cc``, the first two doublings of a window without T,
8-multiply niels adds); the kernels take the two pairs' digit words and
the breakpoint (the TPU passes per-lane word arrays), and write a tensor
apart from their input (the TPU folds in place, which blocks running in
any order cannot).

``fold_c`` replaces ``pallas_curve.fold_grid_c`` / ``fold_grid_c_donate``
(:541 / :548, ``_fold_c_call`` :513, ``_fold_c_kernel`` :490), and
``fold_c_comb`` replaces ``fold_grid_c_comb`` (:733, ``_fold_c_comb_call``
:698): out[i] = P[i] + c_i * P[i + v] with two constants split at a
breakpoint, one side or both sides of the combined layout.  Bound: at
2^16-2^17 outputs integer multiplies (~320 point operations per output),
at the default route's 2,048 latency (one output's dependent chain).
Design (``csrc/msm_fold.cu``): Straus over an 8-entry niels table of
P[i + v] and the constant's signed base-16 digits, P[i] added last, in
two designs that the library picks by the outputs against the card's
resident groups (``bp_fold_c_design``): ``group``, ``fold_bits``'
cooperative table and window loop (8 lanes an output), up to half the
groups the card holds at once; ``thread``, one thread an output on inlined
carry-chain operations with the table in local memory (``fold_w3h``'s
pattern), past that.  The kernels take the two constants' w4 words and
the breakpoint (the TPU passes per-lane word arrays).  One side may fold
in place (an output's thread or group reads rows i and i + v and writes
row i only), the counterpart of the TPU's donated variant; the combined
fold writes a new tensor, as ``fold_w3h_comb`` does.

``msm_win`` replaces ``pallas_curve.msm_win_dyn`` (:1156,
``_msm_win_call`` :1105, ``_msm_win_kernel`` :1065): one w4 window walk
over a ``table_w4`` table, [v, poff, woff, split, poff2] in points.  Bound
and design: ``msm_win_pair``'s, with one walk (2.0 ms at 143,704 steps on
the card).

``msm_grid`` replaces ``pallas_curve.msm_grid_acc`` (:438,
``_msm_grid_kernel`` :415): a chained w4 MSM over a chunk range of the
generators.  Its body is ``msm_chunk_acc_w4``'s (``_ladder_w4``, block
reduce, add); the two TPU kernels differ only in the capacity shapes they
address.  So it launches the ``msm_w4`` kernels over the view
``points[poff : poff + n]`` of the cached generator tensor (no copy), and
counts its own launches.

``msm_grid_local`` replaces ``pallas_curve.msm_grid_local`` (:487, the
same ``_msm_grid_kernel`` over the whole width of one device's shard,
clamped to its valid chunks): one shard's walk in
``parallel/sharded_fast.py``.  Again the ``msm_w4`` kernels, over the
shard's live prefix, with its own wrapper and count.  The reference walks
a shard with no valid chunk over one zero-word chunk; here it launches
over no points (the passes return the accumulator), so the result does
not rest on the words past the valid span being zero.

The device-oracle path's kernels (callers in
``ops/{field,curve,msm,backend,poseidon}.py`` and ``parallel/pipeline.py``)
take any n, not only the TPU's multiples of 2048.  ``padd``, ``pdbl``,
``mul_fp`` and ``mul_fq`` agree with their plain versions word for word;
the redesigned scalar multiply, MSMs and fold add in another order and
agree as group elements:

``padd`` / ``pdbl`` replace ``pallas_curve.padd`` / ``pdbl`` (:176 / :190,
``_padd_kernel`` :163, ``_pdbl_kernel`` :167): pointwise add and doubling.
Bound: bytes and multiplies nearly alike (384 / 256 B per point moved for
9 / 8 field multiplies).  Design (``csrc/oracle.cu``): one templated
kernel, one thread per point on the inlined carry-chain ``ge_add_cc`` /
``ge_double_cc`` (the same formulas, so the same canonical words as the
plain versions), tiles of 128 points staged through shared memory for
16-byte coalesced loads and stores, a grid of the card's resident blocks
striding over the tiles.

``smul_lanes`` replaces ``pallas_curve.smul_lanes`` (:1519, ``_smul_kernel``
:243, ``_ladder`` :219): s_i * P_i per lane, s_i bits 252..0 of a bit
word row.  Bound: integer multiplies (the windowed ladder's ~250
doublings and ~60 adds per lane; the TPU's bit ladder, 253 doublings and
253 adds, was the first version's work).  Design (``csrc/msm_fold.cu``):
each row recoded in the kernel into 64 signed base-16 digits
(``fold_recode``), then Straus over an 8-entry niels table of P_i, in
``fold_c``'s two designs picked by size (``bp_smul_lanes_design``;
``design=`` forces one): ``group``, 8 lanes an output, and ``thread``, one
thread a lane with its table in local memory.

``msm_chunk_acc`` replaces ``pallas_curve.msm_chunk_acc`` (:279,
``_smul_acc_kernel`` :269): acc + sum_i s_i * P_i over any n, the scalars
bit words (bits 252..0).  ``msm_block_totals`` replaces
``pallas_curve.msm_block_totals`` (:252, ``_smul_reduce_kernel`` :239):
one such sum per 2048 input points, (ceil(n / 2048), 4, 8), the last one
ragged, which the host adds up.  Bound: ``msm_w4``'s (the TPU's bit
ladder, 253 doublings and 253 adds a point, is the first versions' work).
Design (``csrc/win.cu``): ``msm_w4``'s windowed passes, the tiles
recoding each bit word row into signed w4 digits as they load it
(``fold_recode``); ``msm_chunk_acc`` one segment chained on acc,
``msm_block_totals`` one segment a block with no chain (as ``msm_lane``).  They add in another order than their plain versions, which
keep the first kernels' ladder and trees: equal as group elements.

``fold_grid`` replaces ``pallas_curve.fold_grid`` (:865, ``_fold_grid_kernel``
:850, ``_emit_fold_w2`` :823, ``_w2_digit_select`` :811): out[i] = wl_i *
P[i] + wr_i * P[i + v] with 128 signed 2-bit digits per scalar.  Bound:
at 2^17 outputs integer multiplies (two tables, 256 doublings and ~120
adds an output), at the later rounds' few outputs latency.  Design
(``csrc/msm_fold.cu``): each w2 row recoded in the kernel into 64 signed
base-16 digits and a borrow window (``w2_recode``), then Straus over an
8-entry niels table of P[i] and one of P[i + v], half the w2 ladder's
adds, in ``fold_c``'s two designs picked by size
(``bp_fold_grid_design``; ``design=`` forces one): ``group``, 8 lanes an
output (``fold_bits``' body), and ``thread``, one thread an output with
its tables in local memory; a constant scalar is one ``(1, 8)`` row read
by every lane (word stride 0) instead of the TPU's capacity array of
copies; the output is a new ``(v, 4, 8)`` tensor, equal to the plain
version's (the TPU's ladder) as a group element.

``mul_fp`` / ``mul_fq`` replace ``pallas_field.mul_fp`` / ``mul_fq``
(ops/pallas_field.py:200-201, ``_make_mul`` :173, ``emit_mul`` :144):
elementwise products mod p and mod l of any words below 2^256, canonical
(the TPU's stay lazy).  Bound: memory (96 B per element for one field
multiply).  Design: one thread per element; mod p is ``fe_mul`` then
``fe_canon``, mod l the 8 x 8 word product and Barrett's reduction with
base 2^32 (``sc_mul_canon``), the plain version the same reduction over
int64 word limbs (``field.mul_mod_plain``).

``poseidon_permute`` / ``poseidon_chain`` (one template, ``poseidon_perm``,
in ``csrc/poseidon.cu``) replace ``pallas_field.mul_fq`` as the port's
Poseidon used it (three launches a round over 288, 48 or 8 elements) and
the JAX package's jitted ``DevicePoseidon._permute`` (ops/poseidon.py:62,
one XLA program): every round of a permutation in one launch, and
``parallel.pipeline.witness_transform``'s chain of 2:1 hashes in one
launch.  Bound: the mod-l products' 32-bit multiplies, and at the chain's
8 rows the latency of a row's dependent products.  Design: a group of 8
lanes a state row, lane i holding st[i]; the MDS row by shuffles, its w
products summed unreduced and reduced once (``sc_mul_canon``'s Barrett
reduction takes any value below 2^512); round keys, MDS and round mask
staged in shared memory once a block; the chain's accumulator stays in
registers.  The plain versions are the round loop the port ran before,
on ``field.mul_mod_plain``: equal words.

Every launch makes its tensors' device current first (``_launch``): the
library launches on the calling thread's current device, and a pool
thread or a backend on a second card need not have it current.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from ..utils import metrics
from . import build
from . import curve as C
from . import field as F

LAUNCHES = {
    "msm_w4": 0, "msm_w4_pair": 0, "fold_bits": 0,
    "table_w5": 0, "msm_win5": 0, "msm_lane": 0,
    "fold_w3h": 0, "fold_w3h_comb": 0, "table_w4": 0, "msm_win_pair": 0,
    "fold_c": 0, "fold_c_comb": 0, "msm_win": 0, "msm_grid": 0,
    "msm_grid_local": 0,
    "padd": 0, "pdbl": 0, "smul_lanes": 0, "msm_block_totals": 0,
    "msm_chunk_acc": 0, "fold_grid": 0, "mul_fp": 0, "mul_fq": 0,
    "poseidon_permute": 0, "poseidon_chain": 0,
}
_COUNT_LOCK = threading.Lock()  # batched IPP rounds launch from a pool
TBL5 = 16
W5_WINDOWS = 51  # ceil(253 / 5)
TBL4 = 8
W4_WINDOWS = 64
W3H_DIGITS = 44
W2_WINDOWS = 128
LADDER_BITS = 253
# The device-oracle MSMs' plain versions sum in their first kernels' order:
# a tree of ORACLE_THREADS ladders, then the partials
ORACLE_THREADS = 128  # points per first-pass partial
BLOCK_PTS = 2048  # msm_block_totals: input points per total (the TPU's block)


def reset_launches() -> None:
    with _COUNT_LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def _count(name: str) -> None:
    with _COUNT_LOCK:
        LAUNCHES[name] += 1
    metrics.count("launches")


# ------------------------------------------------------------ checks
def _check(t: torch.Tensor, name: str, shape: tuple, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor")
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _route(device: torch.device) -> str:
    if device.type == "cpu":
        return "plain"
    if device.type == "cuda":
        return "cuda"
    raise ValueError(f"no kernel for device {device}")


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _launch(name: str, dev: torch.device, entry: str, *args,
            count: bool = True) -> None:
    """Call the library's entry point `entry` with `args` and the current
    stream of `dev`, raise if the launch failed, and (unless `count` is
    False: the test entries ``fe_mul_test``, ``sc_mul_test``) count it
    under `name`.  The
    library launches on the calling thread's current device, which need
    not be `dev` (a pool thread, a backend on a second card), so `dev` is
    made current for the call: in torch, which restores the thread's
    device after it, and in the library's own CUDA runtime (linked
    statically, so it keeps a current device of its own)."""
    lib = build.load()
    with torch.cuda.device(dev):
        build.check(lib.bp_set_device(dev.index), f"{name} (set device)")
        build.check(getattr(lib, entry)(*args, _stream(dev)), name)
    if count:
        _count(name)


def _w4_scratch(dev: torch.device, vmax: int, walks: int):
    """The windowed w4 MSM's scratch for `walks` segments of at most vmax
    points: pass 1's partials, as many as the library's geometry gives on
    `dev` (it asks the card how many blocks it holds), and pass 2's
    window totals."""
    lib = build.load()
    with torch.cuda.device(dev):
        build.check(lib.bp_set_device(dev.index), "msm_w4 scratch (set device)")
        nparts = lib.bp_w4_partials(vmax, walks)
    partials = torch.empty((nparts, 4, 8), dtype=torch.int32, device=dev)
    wtot = torch.empty((walks * lib.bp_win4_windows(), 4, 8), dtype=torch.int32,
                       device=dev)
    return partials, wtot


# ------------------------------------------------------- plain versions
def _digits(words: torch.Tensor, pos: int) -> torch.Tensor:
    w = words[:, pos // 8].to(torch.int64) & 0xFFFFFFFF
    return (w >> (4 * (pos % 8))) & 15


def ladder_w4_plain(pts: torch.Tensor, words: torch.Tensor) -> torch.Tensor:
    """Per point d * P (signed w4 ladder, 64 windows, 8-entry table; the
    top digit -8 takes the 8P entry).  (n, 4, 16) limbs in and out."""
    n = pts.shape[0]
    ident = C.identity(n, pts.device)
    t2 = C.point_double_limbs(pts)
    t3 = C.point_add_limbs(t2, pts)
    t4 = C.point_double_limbs(t2)
    t5 = C.point_add_limbs(t4, pts)
    t6 = C.point_double_limbs(t3)
    t7 = C.point_add_limbs(t6, pts)
    t8 = C.point_double_limbs(t4)
    table = torch.stack([ident, pts, t2, t3, t4, t5, t6, t7, t8])
    rows = torch.arange(n, device=pts.device)
    acc = ident
    for pos in range(63, -1, -1):
        for _ in range(4):
            acc = C.point_double_limbs(acc)
        e = _digits(words, pos)
        neg = e >= 8
        mag = torch.where(neg, 16 - e, e)
        acc = C.point_add_limbs(acc, C.point_negate(table[mag, rows], neg))
    return acc


def msm_w4_plain(points, words, acc) -> torch.Tensor:
    live = words.ne(0).any(dim=1)  # all-zero rows add nothing (as in the kernel)
    points, words = points[live], words[live]
    total = C.block_reduce(ladder_w4_plain(F.words_to_limbs(points), words))
    return F.limbs_to_words(C.point_add_limbs(total, F.words_to_limbs(acc)))


def msm_w4_pair_plain(points, words, acc2, half, lo_limit, hi_limit):
    lo = msm_w4_plain(points[:lo_limit], words[:lo_limit], acc2[0:1])
    hi = msm_w4_plain(
        points[half : half + hi_limit], words[half : half + hi_limit],
        acc2[1:2],
    )
    return torch.cat([lo, hi])


def fold_bits_plain(left, right, wl, wr) -> torch.Tensor:
    L, R = F.words_to_limbs(left), F.words_to_limbs(right)
    both = C.point_add_limbs(L, R)
    ident = C.identity(L.shape[0], L.device)
    wl64 = wl.to(torch.int64) & 0xFFFFFFFF
    wr64 = wr.to(torch.int64) & 0xFFFFFFFF
    acc = ident
    for pos in range(252, -1, -1):
        acc = C.point_double_limbs(acc)
        bl = ((wl64[:, pos // 32] >> (pos % 32)) & 1).bool()
        br = ((wr64[:, pos // 32] >> (pos % 32)) & 1).bool()
        sel = C.point_select_limbs(
            bl & br, both,
            C.point_select_limbs(bl, L, C.point_select_limbs(br, R, ident)),
        )
        acc = C.point_add_limbs(acc, sel)
    return F.limbs_to_words(acc)


def msm_lane_plain(points, words, v: int) -> torch.Tensor:
    """(v, 4, 8): the w4 ladder per point with a nonzero word row (as in
    the kernel), then one sum per segment."""
    n = points.shape[0]
    live = words.ne(0).any(dim=1)
    per_point = C.identity(n, points.device)
    per_point[live] = ladder_w4_plain(
        F.words_to_limbs(points[live]), words[live]
    )
    totals = C.block_reduce(per_point.view(v, n // v, 4, F.NLIMBS))
    return F.limbs_to_words(totals[:, 0])


def _table_plain(points, entries: int) -> torch.Tensor:
    """(n, entries, 4, 8): entry k = (k+1)P in niels form, by the
    kernel's sequence (odd multiples t(k-1) + P, even ones doubled from
    t(k/2)), so the canonical words equal the kernel's bit for bit."""
    p = F.words_to_limbs(points)
    t = [p, C.point_double_limbs(p)]
    for k in range(3, entries + 1):
        t.append(
            C.point_add_limbs(t[k - 2], p) if k % 2 else C.point_double_limbs(t[k // 2 - 1])
        )
    return F.limbs_to_words(torch.stack([C.to_niels(q) for q in t], dim=1))


def table_w5_plain(points) -> torch.Tensor:
    return _table_plain(points, TBL5)


def table_w4_plain(points) -> torch.Tensor:
    """The first 8 entries of ``table_w5_plain``, word for word."""
    return _table_plain(points, TBL4)


def _digits5(words: torch.Tensor, win: int) -> torch.Tensor:
    w = words[:, win // 4].to(torch.int64) & 0xFFFFFFFF
    return (w >> (8 * (win % 4))) & 31


def _win_plain(table, words, chain, v, poff, woff, split, poff2, bits):
    """The window-accumulator walk over a niels table: each window's sum
    of every step's selected entry (windows batched, about 2^16
    selections at a time), then Horner over the window sums, most
    significant first.  `bits` 5: w5 bytes and a 16-entry table; 4: w4
    nibbles and an 8-entry table."""
    windows, entries, digit = (
        (W5_WINDOWS, TBL5, _digits5) if bits == 5 else (W4_WINDOWS, TBL4, _digits)
    )
    dev = table.device
    j = torch.arange(v, device=dev)
    rows = torch.where(j < split, poff + j, poff2 + j - split)
    tbl = F.words_to_limbs(table[rows])  # (v, entries, 4, 16)
    w = words[woff : woff + v]
    ident_n = C.identity(1, dev)[:, [1, 1, 3, 2]]  # niels (1, 1, 0, 1)
    group = max(1, (1 << 16) // max(v, 1))
    sums = []
    for w0 in range(0, windows, group):
        e = torch.stack([
            digit(w, win) for win in range(w0, min(w0 + group, windows))
        ])  # (g, v)
        neg = e >= entries
        mag = torch.where(neg, 2 * entries - e, e)
        ent = tbl[j, (mag - 1).clamp(min=0)]  # (g, v, 4, 16)
        ent = torch.where((mag == 0)[..., None, None], ident_n, ent)
        sel = C.point_add_niels(
            C.identity(1, dev).expand_as(ent), C.niels_negate(ent, neg)
        )
        sums.append(C.block_reduce(sel)[:, 0])
    sums = torch.cat(sums)  # (windows, 4, 16)
    acc = sums[windows - 1 :]
    for win in range(windows - 2, -1, -1):
        for _ in range(bits):
            acc = C.point_double_limbs(acc)
        acc = C.point_add_limbs(acc, sums[win : win + 1])
    return F.limbs_to_words(C.point_add_limbs(acc, F.words_to_limbs(chain)))


def msm_win5_plain(table, words, chain, v, poff, woff, split, poff2):
    return _win_plain(table, words, chain, v, poff, woff, split, poff2, 5)


def msm_win_plain(table, words, chain, v, poff, woff, split, poff2):
    return _win_plain(table, words, chain, v, poff, woff, split, poff2, 4)


def msm_grid_plain(points, words, acc, poff) -> torch.Tensor:
    return msm_w4_plain(points[poff : poff + words.shape[0]], words, acc)


def msm_grid_local_plain(points, words, acc, valid, chunk) -> torch.Tensor:
    m = valid * chunk
    return msm_w4_plain(points[:m], words[:m], acc)


def msm_win_pair_plain(table, words, chain2, walks) -> torch.Tensor:
    """(2, 4, 8): row s = chain2[s] + walk s (v, poff, woff, split,
    poff2) over a ``table_w4`` table with w4 words."""
    return torch.cat([
        _win_plain(table, words, chain2[s : s + 1], *walks[s], 4)
        for s in range(2)
    ])


def _fold_w3h_side(points, words, bp) -> torch.Tensor:
    """One side of the half-width fold: points (2v, 4, 8), words
    (2, 2, 8) [pair][beta, alpha] -> (v, 4, 8), out[i] = beta * P[i] +
    alpha * P[i + v] with pair 0 below bp and pair 1 from bp on."""
    v = points.shape[0] // 2
    dev = points.device
    pair = (torch.arange(v, device=dev) >= bp).long()
    rows = torch.arange(v, device=dev)
    acc = C.identity(v, dev)
    steps = []
    for half, k in ((points[:v], 0), (points[v:], 1)):
        p = F.words_to_limbs(half)
        t2 = C.point_double_limbs(p)
        table = torch.stack([acc, p, t2, C.point_add_limbs(t2, p), C.point_double_limbs(t2)])
        steps.append((words[pair, k], table))
    for pos in range(W3H_DIGITS - 1, -1, -1):
        for _ in range(3):
            acc = C.point_double_limbs(acc)
        for w, table in steps:
            e = _digits(w, pos) & 7
            neg = e >= 4
            mag = torch.where(neg, 8 - e, e)  # code 4 is the digit -4
            acc = C.point_add_limbs(acc, C.point_negate(table[mag, rows], neg))
    return F.limbs_to_words(acc)


def fold_w3h_plain(points, words, bp) -> torch.Tensor:
    return _fold_w3h_side(points, words[0], bp)


def fold_w3h_comb_plain(points, words, bp) -> torch.Tensor:
    """[G(2v) | H(2v)] -> [G'(v) | H'(v)], side s with words[s]."""
    half = points.shape[0] // 2
    return torch.cat([
        _fold_w3h_side(points[s * half : (s + 1) * half], words[s], bp)
        for s in range(2)
    ])


def _fold_c_side(points, words, bp) -> torch.Tensor:
    """One side of the constant fold: points (2v, 4, 8), words (2, 8) ->
    (v, 4, 8), out[i] = P[i] + c * P[i + v] with words[0] below bp and
    words[1] from bp on."""
    v = points.shape[0] // 2
    pair = (torch.arange(v, device=points.device) >= bp).long()
    prod = ladder_w4_plain(F.words_to_limbs(points[v:]), words[pair])
    return F.limbs_to_words(C.point_add_limbs(prod, F.words_to_limbs(points[:v])))


def fold_c_plain(points, words, bp) -> torch.Tensor:
    return _fold_c_side(points, words[0], bp)


def fold_c_comb_plain(points, words, bp) -> torch.Tensor:
    """[G(2v) | H(2v)] -> [G'(v) | H'(v)], side s with words[s]."""
    half = points.shape[0] // 2
    return torch.cat([
        _fold_c_side(points[s * half : (s + 1) * half], words[s], bp)
        for s in range(2)
    ])


# ------------------------------------------------------------- wrappers
def _msm_w4_launch(name: str, points: torch.Tensor, words: torch.Tensor,
                   acc: torch.Tensor) -> torch.Tensor:
    """The ``msm_w4`` kernel over `points` (a contiguous view is enough),
    counted under `name`."""
    dev = points.device
    n = points.shape[0]
    _check(points, "points", (n, 4, 8), dev)
    _check(words, "words", (n, 8), dev)
    _check(acc, "acc", (1, 4, 8), dev)
    if _route(dev) == "plain":
        return msm_w4_plain(points, words, acc)
    out = torch.empty((1, 4, 8), dtype=torch.int32, device=dev)
    partials, wtot = _w4_scratch(dev, n, 1)
    _launch(name, dev, "bp_msm_w4", _ptr(points), _ptr(words), _ptr(acc),
            _ptr(out), _ptr(partials), _ptr(wtot), n)
    return out


def msm_w4(points: torch.Tensor, words: torch.Tensor,
           acc: torch.Tensor) -> torch.Tensor:
    """(1, 4, 8) = acc + sum_i d_i * points_i (signed w4 words)."""
    return _msm_w4_launch("msm_w4", points, words, acc)


def msm_grid(points: torch.Tensor, words: torch.Tensor, acc: torch.Tensor,
             poff: int = 0) -> torch.Tensor:
    """(1, 4, 8) = acc + sum_{i < n} d_i * points[poff + i], n = len(words):
    the ``msm_w4`` kernel over a view of `points` (the cached generators),
    no copy."""
    n = words.shape[0]
    if not 0 <= poff <= poff + n <= points.shape[0]:
        raise ValueError(
            f"msm_grid: {n} words at offset {poff} leave {points.shape[0]} points"
        )
    return _msm_w4_launch("msm_grid", points[poff : poff + n], words, acc)


def msm_grid_local(points: torch.Tensor, words: torch.Tensor,
                   acc: torch.Tensor, valid: int, chunk: int) -> torch.Tensor:
    """(1, 4, 8) = acc + sum_{i < valid * chunk} d_i * points_i: one
    shard's walk of the points-axis sharded MSM.  The shard holds whole
    chunks of `chunk` points; the first `valid` are live and the rest add
    nothing (the reference's [valid, 0] clamp), their words never read.
    The ``msm_w4`` kernel over the live prefix (no copy): a shard with no
    live chunk launches over no points and returns acc."""
    n = points.shape[0]
    if chunk < 1 or n % chunk or not 0 <= valid <= n // chunk:
        raise ValueError(
            f"msm_grid_local: {valid} valid chunks of {chunk} in {n} points"
        )
    _check(words, "words", (n, 8), points.device)
    m = valid * chunk
    return _msm_w4_launch("msm_grid_local", points[:m], words[:m], acc)


def msm_w4_pair(points: torch.Tensor, words: torch.Tensor,
                acc2: torch.Tensor, half: int, lo_limit: int | None = None,
                hi_limit: int | None = None) -> torch.Tensor:
    """(2, 4, 8): row 0 = acc2[0] + MSM over points [0, lo_limit), row 1 =
    acc2[1] + MSM over [half, half + hi_limit).  Limits are point counts
    within each half (default: the whole half; 0 skips the half)."""
    dev = points.device
    lo = half if lo_limit is None else max(0, min(lo_limit, half))
    hi = half if hi_limit is None else max(0, min(hi_limit, half))
    _check(points, "points", (2 * half, 4, 8), dev)
    _check(words, "words", (2 * half, 8), dev)
    _check(acc2, "acc2", (2, 4, 8), dev)
    if _route(dev) == "plain":
        return msm_w4_pair_plain(points, words, acc2, half, lo, hi)
    out = torch.empty((2, 4, 8), dtype=torch.int32, device=dev)
    partials, wtot = _w4_scratch(dev, max(lo, hi), 2)
    _launch("msm_w4_pair", dev, "bp_msm_w4_pair", _ptr(points), _ptr(words),
            _ptr(acc2), _ptr(out), _ptr(partials), _ptr(wtot), half, lo, hi)
    return out


def fold_bits(left: torch.Tensor, right: torch.Tensor, wl: torch.Tensor,
              wr: torch.Tensor) -> torch.Tensor:
    """(n, 4, 8): out_i = wl_i * left_i + wr_i * right_i (raw bit words)."""
    dev = left.device
    n = left.shape[0]
    _check(left, "left", (n, 4, 8), dev)
    _check(right, "right", (n, 4, 8), dev)
    _check(wl, "wl", (n, 8), dev)
    _check(wr, "wr", (n, 8), dev)
    if _route(dev) == "plain":
        return fold_bits_plain(left, right, wl, wr)
    out = torch.empty((n, 4, 8), dtype=torch.int32, device=dev)
    _launch("fold_bits", dev, "bp_fold_bits", _ptr(left), _ptr(right),
            _ptr(wl), _ptr(wr), _ptr(out), n)
    return out


def msm_lane(points: torch.Tensor, words: torch.Tensor, v: int
             ) -> torch.Tensor:
    """(v, 4, 8): row s = sum_i d_i * points_i over segment s, points
    [s * seg, (s + 1) * seg) with seg = len(points) / v (signed w4 words)."""
    dev = points.device
    n = points.shape[0]
    if v < 1 or n % v or n == 0:
        raise ValueError(f"msm_lane: {n} points do not split into {v} segments")
    seg = n // v
    _check(points, "points", (n, 4, 8), dev)
    _check(words, "words", (n, 8), dev)
    if _route(dev) == "plain":
        return msm_lane_plain(points, words, v)
    out = torch.empty((v, 4, 8), dtype=torch.int32, device=dev)
    partials, wtot = _w4_scratch(dev, seg, v)
    _launch("msm_lane", dev, "bp_msm_lane", _ptr(points), _ptr(words),
            _ptr(out), _ptr(partials), _ptr(wtot), v, seg)
    return out


def table_w5(points: torch.Tensor) -> torch.Tensor:
    """(n, 16, 4, 8): entry k of row i = (k+1) * points_i, niels form."""
    dev = points.device
    n = points.shape[0]
    _check(points, "points", (n, 4, 8), dev)
    if _route(dev) == "plain":
        return table_w5_plain(points)
    out = torch.empty((n, TBL5, 4, 8), dtype=torch.int32, device=dev)
    _launch("table_w5", dev, "bp_table_w5", _ptr(points), _ptr(out), n)
    return out


def _check_walk(name: str, walk: tuple, N: int, M: int) -> None:
    """A walk (v, poff, woff, split, poff2) must stay inside a table of N
    rows and M word rows."""
    v, poff, woff, split, poff2 = walk
    if not (
        0 <= split <= v and min(poff, poff2, woff) >= 0
        and poff + split <= N and poff2 + (v - split) <= N and woff + v <= M
    ):
        raise ValueError(
            f"{name}: walk v={v} poff={poff} woff={woff} split={split} "
            f"poff2={poff2} leaves table ({N}) / words ({M})"
        )


def _win_scratch(dev, bits: int, vmax: int, walks: int):
    """The walker passes' scratch for `walks` walks of at most vmax steps,
    sized by the library: pass 1's partials and pass 2's window totals."""
    lib = build.load()
    windows = lib.bp_win5_windows() if bits == 5 else lib.bp_win4_windows()
    partials = torch.empty((lib.bp_win_partials(vmax, walks, bits), 4, 8),
                           dtype=torch.int32, device=dev)
    wtot = torch.empty((walks * windows, 4, 8), dtype=torch.int32, device=dev)
    return partials, wtot


def _win_walk(name: str, bits: int, table, words, chain, v, poff, woff,
              split, poff2) -> torch.Tensor:
    """One window walk over a w5 (``msm_win5``) or w4 (``msm_win``)
    table."""
    entries, wcols = (TBL5, 16) if bits == 5 else (TBL4, 8)
    dev = table.device
    N, M = table.shape[0], words.shape[0]
    _check(table, "table", (N, entries, 4, 8), dev)
    _check(words, "words", (M, wcols), dev)
    _check(chain, "chain", (1, 4, 8), dev)
    if split is None:
        split, poff2 = v, poff
    _check_walk(name, (v, poff, woff, split, poff2), N, M)
    if _route(dev) == "plain":
        return _win_plain(table, words, chain, v, poff, woff, split, poff2,
                          bits)
    if table.data_ptr() % 16:
        raise ValueError(f"{name}: table not 16-byte aligned")
    out = torch.empty((1, 4, 8), dtype=torch.int32, device=dev)
    partials, wtot = _win_scratch(dev, bits, v, 1)
    _launch(name, dev, f"bp_{name}", _ptr(table), _ptr(words), _ptr(chain),
            _ptr(out), _ptr(partials), _ptr(wtot), v, poff, woff, split,
            poff2)
    return out


def msm_win5(table: torch.Tensor, words: torch.Tensor, chain: torch.Tensor,
             v: int, poff: int = 0, woff: int = 0, split: int | None = None,
             poff2: int = 0) -> torch.Tensor:
    """(1, 4, 8) = chain + sum_{j < v} d_j * P_row(j) over a ``table_w5``
    table, d_j from word row woff + j (w5 bytes).  Step j reads table row
    poff + j for j < split and poff2 + (j - split) beyond (default split:
    v, one segment)."""
    return _win_walk("msm_win5", 5, table, words, chain, v, poff, woff,
                     split, poff2)


def msm_win(table: torch.Tensor, words: torch.Tensor, chain: torch.Tensor,
            v: int, poff: int = 0, woff: int = 0, split: int | None = None,
            poff2: int = 0) -> torch.Tensor:
    """``msm_win5``'s walk over a ``table_w4`` table with w4 words."""
    return _win_walk("msm_win", 4, table, words, chain, v, poff, woff,
                     split, poff2)


def table_w4(points: torch.Tensor, out: torch.Tensor | None = None
             ) -> torch.Tensor:
    """(n, 8, 4, 8): entry k of row i = (k+1) * points_i, niels form.
    `out`, a table of at least n rows (the previous round's), takes the
    result in its first n rows instead of a new tensor."""
    dev = points.device
    n = points.shape[0]
    _check(points, "points", (n, 4, 8), dev)
    if out is not None:
        if out.shape[0] < n:
            raise ValueError(f"table_w4: out holds {out.shape[0]} < {n} rows")
        _check(out, "out", (out.shape[0], TBL4, 4, 8), dev)
        out = out[:n]
    if _route(dev) == "plain":
        got = table_w4_plain(points)
        return got if out is None else out.copy_(got)
    if out is None:
        out = torch.empty((n, TBL4, 4, 8), dtype=torch.int32, device=dev)
    elif out.data_ptr() % 16:
        raise ValueError("table_w4: out not 16-byte aligned")
    _launch("table_w4", dev, "bp_table_w4", _ptr(points), _ptr(out), n)
    return out


def msm_win_pair(table: torch.Tensor, words: torch.Tensor,
                 chain2: torch.Tensor, walks) -> torch.Tensor:
    """(2, 4, 8): row s = chain2[s] + sum_{j < v} d_j * P_row(j) over a
    ``table_w4`` table for walk s = (v, poff, woff, split, poff2): step j
    reads word row woff + j (w4 nibbles) and table row poff + j below
    split, poff2 + (j - split) from there on (``ck.comb_walks`` gives a
    combined round's two walks)."""
    dev = table.device
    N, M = table.shape[0], words.shape[0]
    _check(table, "table", (N, TBL4, 4, 8), dev)
    _check(words, "words", (M, 8), dev)
    _check(chain2, "chain2", (2, 4, 8), dev)
    walks = tuple(tuple(int(x) for x in w) for w in walks)
    if len(walks) != 2 or any(len(w) != 5 for w in walks):
        raise ValueError(f"msm_win_pair: two walks of 5 ints, got {walks}")
    for w in walks:
        _check_walk("msm_win_pair", w, N, M)
    if _route(dev) == "plain":
        return msm_win_pair_plain(table, words, chain2, walks)
    if table.data_ptr() % 16:
        raise ValueError("msm_win_pair: table not 16-byte aligned")
    out = torch.empty((2, 4, 8), dtype=torch.int32, device=dev)
    partials, wtot = _win_scratch(dev, 4, max(w[0] for w in walks), 2)
    _launch("msm_win_pair", dev, "bp_msm_win_pair", _ptr(table), _ptr(words),
            _ptr(chain2), _ptr(out), _ptr(partials), _ptr(wtot), *walks[0],
            *walks[1])
    return out


def _fold_launch(name, plain, points, words, word_shape, bp, v, sides, out,
                 *design):
    """The half-width (``fold_w3h*``) and constant (``fold_c*``) folds:
    2 * sides * v points in, sides * v out, the words' pair 0 below bp;
    `design` the constant folds' (``_fold_c_design``)."""
    dev = points.device
    _check(points, "points", (2 * sides * v, 4, 8), dev)
    _check(words, "words", (sides, *word_shape), dev)
    if out is None:
        out = torch.empty((sides * v, 4, 8), dtype=torch.int32, device=dev)
    else:
        _check(out, "out", (sides * v, 4, 8), dev)
    bp = min(max(int(bp), 0), v)
    if _route(dev) == "plain":
        return out.copy_(plain(points, words, bp))
    _launch(name, dev, f"bp_{name}", _ptr(points), _ptr(out), _ptr(words), v,
            bp, *design)
    return out


def fold_w3h(points: torch.Tensor, words: torch.Tensor, bp: int,
             out: torch.Tensor | None = None) -> torch.Tensor:
    """(v, 4, 8) from points (2v, 4, 8): out[i] = beta * P[i] + alpha *
    P[i + v], (beta, alpha) = words[0, 0] below bp and words[0, 1] from
    bp on (``ck.w3h_fold_words``).  `out` (v, 4, 8), which must not
    overlap `points`, takes the result instead of a new tensor."""
    v = points.shape[0] // 2
    return _fold_launch("fold_w3h", fold_w3h_plain, points, words, (2, 2, 8),
                        bp, v, 1, out)


def fold_w3h_comb(points: torch.Tensor, words: torch.Tensor, bp: int
                  ) -> torch.Tensor:
    """(2v, 4, 8) = [G'(v) | H'(v)] from points (4v, 4, 8) = [G(2v) |
    H(2v)] in one launch, side s folded with words[s] (both sides split
    at bp).  Always a new tensor: never in place."""
    v = points.shape[0] // 4
    return _fold_launch("fold_w3h_comb", fold_w3h_comb_plain, points, words,
                        (2, 2, 8), bp, v, 2, None)


FOLD_C_DESIGNS = ("thread", "group")  # csrc/msm_fold.cu's designs, by number
FOLD_GRID_DESIGNS = FOLD_C_DESIGNS  # fold_grid's: the same two, numbered alike
SMUL_LANES_DESIGNS = FOLD_C_DESIGNS  # smul_lanes': the same two, numbered alike


def _design_number(name: str, designs: tuple, design: str | None) -> int:
    """The library's number of `design` among `designs`: None (-1) lets it
    choose by size."""
    if design is None:
        return -1
    if design not in designs:
        raise ValueError(f"{name}: design {design!r}, expected one of "
                         f"{designs} or None")
    return designs.index(design)


def _fold_c_design(design: str | None) -> int:
    return _design_number("fold_c", FOLD_C_DESIGNS, design)


def _library_design(name: str, designs: tuple, dev: torch.device,
                    outputs: int) -> str:
    """The design the library picks for kernel `name` on card `dev` for
    `outputs` outputs (its ``bp_<name>_design`` entry)."""
    lib = build.load()
    with torch.cuda.device(dev):
        build.check(lib.bp_set_device(dev.index), f"{name} design (set device)")
        return designs[getattr(lib, f"bp_{name}_design")(outputs)]


def fold_c_design(dev: torch.device, outputs: int) -> str:
    """The design the constant folds take on card `dev` for `outputs`
    outputs (v, or 2v for ``fold_c_comb``)."""
    return _library_design("fold_c", FOLD_C_DESIGNS, dev, outputs)


def fold_c(points: torch.Tensor, words: torch.Tensor, bp: int,
           out: torch.Tensor | None = None, design: str | None = None
           ) -> torch.Tensor:
    """(v, 4, 8) from points (2v, 4, 8): out[i] = P[i] + c_i * P[i + v],
    c_i the constant of words[0, 0] below bp and of words[0, 1] from bp
    on (``ck.c_fold_words``).  `out` (v, 4, 8) takes the result instead of
    a new tensor; it may be ``points[:v]`` (in place).  `design`
    (``"thread"`` / ``"group"``, for measurements) overrides the
    library's choice by size; the point is the same either way."""
    v = points.shape[0] // 2
    return _fold_launch("fold_c", fold_c_plain, points, words, (2, 8), bp, v,
                        1, out, _fold_c_design(design))


def fold_c_comb(points: torch.Tensor, words: torch.Tensor, bp: int,
                design: str | None = None) -> torch.Tensor:
    """(2v, 4, 8) = [G'(v) | H'(v)] from points (4v, 4, 8) = [G(2v) |
    H(2v)] in one launch, side s folded with words[s] (both sides split
    at bp).  Always a new tensor: never in place.  `design` as in
    ``fold_c``."""
    v = points.shape[0] // 4
    return _fold_launch("fold_c_comb", fold_c_comb_plain, points, words,
                        (2, 8), bp, v, 2, None, _fold_c_design(design))


# ------------------------------------------- the device-oracle path's kernels
def _limbs_op(fn, *pts) -> torch.Tensor:
    return F.limbs_to_words(fn(*(F.words_to_limbs(p) for p in pts)))


def padd_plain(a, b) -> torch.Tensor:
    return _limbs_op(C.point_add_limbs, a, b)


def pdbl_plain(a) -> torch.Tensor:
    return _limbs_op(C.point_double_limbs, a)


def ladder_bits_plain(pts: torch.Tensor, words: torch.Tensor) -> torch.Tensor:
    """Per point s * P by the bit ladder over bits 252..0: double, then add
    P where the bit is set and the identity where not (the TPU's sequence,
    and the first kernels').  (n, 4, 16) limbs in and out."""
    n = pts.shape[0]
    ident = C.identity(n, pts.device)
    w = words.to(torch.int64) & 0xFFFFFFFF
    acc = ident
    for pos in range(LADDER_BITS - 1, -1, -1):
        acc = C.point_double_limbs(acc)
        bit = ((w[:, pos // 32] >> (pos % 32)) & 1).bool()
        acc = C.point_add_limbs(acc, C.point_select_limbs(bit, pts, ident))
    return acc


def smul_lanes_plain(points, words) -> torch.Tensor:
    return F.limbs_to_words(ladder_bits_plain(F.words_to_limbs(points), words))


def _tree(x: torch.Tensor) -> torch.Tensor:
    """(k, 2^j, 4, 16) -> (k, 4, 16): the kernels' shared-memory tree,
    x[s] += x[s + half] at halving strides."""
    while x.shape[1] > 1:
        h = x.shape[1] // 2
        x = C.point_add_limbs(x[:, :h], x[:, h:])
    return x[:, 0]


def _partials_plain(points, words, nparts: int) -> torch.Tensor:
    """(nparts, 4, 16): the first pass, one tree sum of the ladders of
    each ORACLE_THREADS points, the identity past n."""
    n = points.shape[0]
    per = C.identity(nparts * ORACLE_THREADS, points.device)
    if n:
        per[:n] = ladder_bits_plain(F.words_to_limbs(points), words)
    return _tree(per.view(nparts, ORACLE_THREADS, 4, F.NLIMBS))


def msm_block_totals_plain(points, words) -> torch.Tensor:
    nb = -(-points.shape[0] // BLOCK_PTS)
    per_block = BLOCK_PTS // ORACLE_THREADS
    parts = _partials_plain(points, words, nb * per_block)
    return F.limbs_to_words(_tree(parts.view(nb, per_block, 4, F.NLIMBS)))


def msm_chunk_acc_plain(points, words, acc) -> torch.Tensor:
    """(1, 4, 8): thread t of the second pass adds partials t, t + T, ...
    to the identity, the tree sums the threads, then acc is added."""
    nparts = -(-points.shape[0] // ORACLE_THREADS)
    parts = _partials_plain(points, words, nparts)
    T = ORACLE_THREADS
    v = C.identity(T, points.device)
    t = torch.arange(T, device=points.device)
    for r in range(-(-nparts // T)):
        j = r * T + t
        live = j < nparts
        v = C.point_select_limbs(
            live, C.point_add_limbs(v, parts[j.clamp(max=nparts - 1)]), v
        )
    total = _tree(v[None])
    return F.limbs_to_words(C.point_add_limbs(total, F.words_to_limbs(acc)))


def _w2_select(w: torch.Tensor, pos: int, p1, p2, ident) -> torch.Tensor:
    e = (w[:, pos // 16] >> (2 * (pos % 16))) & 3
    neg = e >= 2
    mag = torch.where(neg, 4 - e, e)  # e = 2 is d = -2, e = 3 is d = -1
    sel = C.point_select_limbs(
        mag == 1, p1, C.point_select_limbs(mag == 2, p2, ident)
    )
    return C.point_negate(sel, neg)


def fold_grid_plain(points, wl, wr, v: int) -> torch.Tensor:
    """(v, 4, 8): the dual w2 ladder, windows 127..0, two doublings and the
    two selected adds each (the kernel's sequence)."""
    dev = points.device
    L1 = F.words_to_limbs(points[:v])
    R1 = F.words_to_limbs(points[v : 2 * v])
    L2, R2 = C.point_double_limbs(L1), C.point_double_limbs(R1)
    ident = C.identity(v, dev)
    wl = (wl.to(torch.int64) & 0xFFFFFFFF).expand(v, 8)
    wr = (wr.to(torch.int64) & 0xFFFFFFFF).expand(v, 8)
    acc = ident
    for pos in range(W2_WINDOWS - 1, -1, -1):
        acc = C.point_double_limbs(C.point_double_limbs(acc))
        acc = C.point_add_limbs(acc, _w2_select(wl, pos, L1, L2, ident))
        acc = C.point_add_limbs(acc, _w2_select(wr, pos, R1, R2, ident))
    return F.limbs_to_words(acc)


def mul_fp_plain(a, b) -> torch.Tensor:
    return F.limbs_to_words(F.mul(F.words_to_limbs(a), F.words_to_limbs(b)))


def mul_fq_plain(a, b) -> torch.Tensor:
    return F.mul_mod_plain(a, b, F.L)


def padd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(n, 4, 8) = a + b pointwise."""
    dev = a.device
    n = a.shape[0]
    _check(a, "a", (n, 4, 8), dev)
    _check(b, "b", (n, 4, 8), dev)
    if _route(dev) == "plain":
        return padd_plain(a, b)
    out = torch.empty((n, 4, 8), dtype=torch.int32, device=dev)
    _launch("padd", dev, "bp_padd", _ptr(a), _ptr(b), _ptr(out), n)
    return out


def pdbl(a: torch.Tensor) -> torch.Tensor:
    """(n, 4, 8) = 2a pointwise."""
    dev = a.device
    n = a.shape[0]
    _check(a, "a", (n, 4, 8), dev)
    if _route(dev) == "plain":
        return pdbl_plain(a)
    out = torch.empty((n, 4, 8), dtype=torch.int32, device=dev)
    _launch("pdbl", dev, "bp_pdbl", _ptr(a), _ptr(out), n)
    return out


def smul_lanes_design(dev: torch.device, n: int) -> str:
    """The design ``smul_lanes`` takes on card `dev` for n lanes."""
    return _library_design("smul_lanes", SMUL_LANES_DESIGNS, dev, n)


def smul_lanes(points: torch.Tensor, words: torch.Tensor,
               design: str | None = None) -> torch.Tensor:
    """(n, 4, 8): row i = s_i * points_i, s_i from bit words (n, 8) (bits
    253..255 are not read).  `design` (``"thread"`` / ``"group"``, for
    measurements) overrides the library's choice by size; the points are
    the same either way."""
    dev = points.device
    n = points.shape[0]
    _check(points, "points", (n, 4, 8), dev)
    _check(words, "words", (n, 8), dev)
    number = _design_number("smul_lanes", SMUL_LANES_DESIGNS, design)
    if _route(dev) == "plain":
        return smul_lanes_plain(points, words)
    out = torch.empty((n, 4, 8), dtype=torch.int32, device=dev)
    _launch("smul_lanes", dev, "bp_smul_lanes", _ptr(points), _ptr(words),
            _ptr(out), n, number)
    return out


def msm_block_totals(points: torch.Tensor, words: torch.Tensor
                     ) -> torch.Tensor:
    """(ceil(n / 2048), 4, 8): row b = sum of s_i * points_i over input
    points [2048 b, 2048 (b + 1)) (bit words), for the host to add up."""
    dev = points.device
    n = points.shape[0]
    _check(points, "points", (n, 4, 8), dev)
    _check(words, "words", (n, 8), dev)
    if _route(dev) == "plain":
        return msm_block_totals_plain(points, words)
    nb = -(-n // BLOCK_PTS)
    out = torch.empty((nb, 4, 8), dtype=torch.int32, device=dev)
    partials, wtot = _w4_scratch(dev, min(n, BLOCK_PTS), nb)
    _launch("msm_block_totals", dev, "bp_msm_block_totals", _ptr(points),
            _ptr(words), _ptr(out), _ptr(partials), _ptr(wtot), n)
    return out


def msm_chunk_acc(points: torch.Tensor, words: torch.Tensor,
                  acc: torch.Tensor) -> torch.Tensor:
    """(1, 4, 8) = acc + sum_i s_i * points_i (bit words), any n."""
    dev = points.device
    n = points.shape[0]
    _check(points, "points", (n, 4, 8), dev)
    _check(words, "words", (n, 8), dev)
    _check(acc, "acc", (1, 4, 8), dev)
    if _route(dev) == "plain":
        return msm_chunk_acc_plain(points, words, acc)
    out = torch.empty((1, 4, 8), dtype=torch.int32, device=dev)
    partials, wtot = _w4_scratch(dev, n, 1)
    _launch("msm_chunk_acc", dev, "bp_msm_chunk_acc", _ptr(points),
            _ptr(words), _ptr(acc), _ptr(out), _ptr(partials), _ptr(wtot), n)
    return out


def fold_grid_design(dev: torch.device, v: int) -> str:
    """The design ``fold_grid`` takes on card `dev` for v outputs."""
    return _library_design("fold_grid", FOLD_GRID_DESIGNS, dev, v)


def fold_grid(points: torch.Tensor, wl: torch.Tensor, wr: torch.Tensor,
              v: int, design: str | None = None) -> torch.Tensor:
    """(v, 4, 8) new tensor: out[i] = wl_i * points[i] + wr_i * points[i +
    v] for i < v, from w2 words (``ck.signed_digit2_words``): per lane
    ``(v, 8)``, or one ``(1, 8)`` row for every lane
    (``ck.const_grid_words``).  `design` (``"thread"`` / ``"group"``, for
    measurements) overrides the library's choice by size; the points are
    the same either way."""
    dev = points.device
    N = points.shape[0]
    if not 0 <= 2 * v <= N:
        raise ValueError(f"fold_grid: {N} points do not hold 2 x {v}")
    _check(points, "points", (N, 4, 8), dev)
    for name, w in (("wl", wl), ("wr", wr)):
        _check(w, name, (1 if w.shape[0] == 1 else v, 8), dev)
    number = _design_number("fold_grid", FOLD_GRID_DESIGNS, design)
    if _route(dev) == "plain":
        return fold_grid_plain(points, wl, wr, v)
    out = torch.empty((v, 4, 8), dtype=torch.int32, device=dev)
    strides = [0 if w.shape[0] == 1 else 8 for w in (wl, wr)]
    _launch("fold_grid", dev, "bp_fold_grid", _ptr(points), _ptr(wl),
            _ptr(wr), _ptr(out), v, *strides, number)
    return out


def _mul_launch(name: str, plain, a: torch.Tensor, b: torch.Tensor
                ) -> torch.Tensor:
    dev = a.device
    n = a.shape[0]
    _check(a, "a", (n, 8), dev)
    _check(b, "b", (n, 8), dev)
    if _route(dev) == "plain":
        return plain(a, b)
    out = torch.empty((n, 8), dtype=torch.int32, device=dev)
    _launch(name, dev, f"bp_{name}", _ptr(a), _ptr(b), _ptr(out), n)
    return out


FE_MUL_TEST_OPS = ("fe_mul", "fe_mul_cc", "fe_sq", "fe_sq_cc")


def fe_mul_test_plain(a, b, op: str, reps: int = 1) -> torch.Tensor:
    """(n, 8) canonical: a * b^reps mod p (fe_mul / fe_mul_cc) or a^(2^reps)
    (fe_sq / fe_sq_cc)."""
    x = a
    for _ in range(reps):
        x = mul_fp_plain(x, x if op.startswith("fe_sq") else b)
    return x


def fe_mul_test(a: torch.Tensor, b: torch.Tensor, op: str, reps: int = 1
                ) -> torch.Tensor:
    """The test entry of ``csrc/fe25519.cuh``'s multiplies: (n, 8) words,
    `reps` products deep (``fe_mul_test_plain``), canonical.  `op` is one
    of FE_MUL_TEST_OPS.  Not a kernel of any path: it holds the
    carry-chain multiply and squaring of the window walkers against
    ``fe_mul`` on the card and times them; counts no launch."""
    dev = a.device
    n = a.shape[0]
    _check(a, "a", (n, 8), dev)
    _check(b, "b", (n, 8), dev)
    if op not in FE_MUL_TEST_OPS or reps < 1:
        raise ValueError(f"fe_mul_test: op {op!r}, reps {reps}")
    if _route(dev) == "plain":
        return fe_mul_test_plain(a, b, op, reps)
    out = torch.empty((n, 8), dtype=torch.int32, device=dev)
    _launch("fe_mul_test", dev, "bp_fe_mul_test", _ptr(a), _ptr(b), _ptr(out),
            n, FE_MUL_TEST_OPS.index(op), reps, count=False)
    return out


def mul_fp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(n, 8) = a * b mod p, canonical, for any words below 2^256."""
    return _mul_launch("mul_fp", mul_fp_plain, a, b)


def mul_fq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(n, 8) = a * b mod l, canonical, for any words below 2^256."""
    return _mul_launch("mul_fq", mul_fq_plain, a, b)


# ------------------------------------------------------------- Poseidon
# csrc/poseidon.cu's S-boxes by number, and its limits: PS_LANES lanes a
# state row, PS_MAX_SHARED bytes of constants a block (the test suite holds
# these equal to the kernel's #defines)
POSEIDON_SBOXES = ("cube", "inverse")
POSEIDON_MAX_WIDTH = 8
POSEIDON_MAX_SHARED = 232_448


def _pow_l_plain(x: torch.Tensor, e: int) -> torch.Tensor:
    """x^e mod l (e >= 1), square and multiply from the top bit."""
    acc = x
    for bit in bin(e)[3:]:
        acc = mul_fq_plain(acc, acc)
        if bit == "1":
            acc = mul_fq_plain(acc, x)
    return acc


def _sbox_plain(x: torch.Tensor, sbox: str) -> torch.Tensor:
    if sbox == "cube":
        return mul_fq_plain(mul_fq_plain(x, x), x)
    return _pow_l_plain(x, F.L - 2)  # inv(0) == 0


def poseidon_permute_plain(state, round_keys, mds, full_mask, sbox: str
                           ) -> torch.Tensor:
    """(B, w, 8): each round adds its keys, applies the S-box to every
    lane (full round) or to the last (partial), and mixes with the MDS
    matrix, st'[i] = sum_j M[i][j] * st[j] mod l."""
    st = state
    for keys, full in zip(round_keys, full_mask.tolist()):
        st = F.FQ.add(st, keys)
        if full:
            st = _sbox_plain(st, sbox)
        else:
            st = torch.cat([st[:, :-1], _sbox_plain(st[:, -1:], sbox)], dim=1)
        st = F.FQ.sum(mul_fq_plain(mds[None], st[:, None]), dim=-2)
    return st


def poseidon_chain_plain(witness, round_keys, mds, full_mask, sbox: str
                         ) -> torch.Tensor:
    """(B, 8): acc <- hash_2(acc, witness[:, i]) for i = 1..W-1, from acc =
    witness[:, 0]; each hash lane 1 of the permuted 2:1 hash state."""
    from .poseidon import hash_state  # the hash layout; imports this module

    acc = witness[:, 0]
    for i in range(1, witness.shape[1]):
        state = hash_state(torch.stack([acc, witness[:, i]], dim=1),
                           mds.shape[0])
        acc = poseidon_permute_plain(state, round_keys, mds, full_mask,
                                     sbox)[:, 1]
    return acc.contiguous()


def _poseidon_consts(round_keys, mds, full_mask, sbox: str, dev,
                     min_width: int) -> tuple[int, int, int]:
    """(w, R, the S-box's number) after checking the constants."""
    w = mds.shape[0] if isinstance(mds, torch.Tensor) and mds.dim() == 3 else 0
    if not min_width <= w <= POSEIDON_MAX_WIDTH:
        raise ValueError(f"poseidon: width {w}, the kernel takes "
                         f"{min_width}..{POSEIDON_MAX_WIDTH}")
    R = round_keys.shape[0] if isinstance(round_keys, torch.Tensor) else 0
    _check(round_keys, "round_keys", (R, w, 8), dev)
    _check(mds, "mds", (w, w, 8), dev)
    _check(full_mask, "full_mask", (R,), dev)
    if sbox not in POSEIDON_SBOXES:
        raise ValueError(f"poseidon: S-box {sbox!r}, expected one of "
                         f"{POSEIDON_SBOXES}")
    if 4 * (8 * R * w + 8 * w * w + R) > POSEIDON_MAX_SHARED:
        raise ValueError(f"poseidon: {R} rounds of width {w} do not fit a "
                         f"block's shared memory")
    return w, R, POSEIDON_SBOXES.index(sbox)


def poseidon_permute(state: torch.Tensor, round_keys: torch.Tensor,
                     mds: torch.Tensor, full_mask: torch.Tensor, sbox: str
                     ) -> torch.Tensor:
    """(B, w, 8) new tensor: every state row through all R rounds
    (``poseidon_permute_plain``) in one launch; full_mask ``(R,)`` int32
    (non-zero: a full round), w from 2 to 8.  State, round keys
    ``(R, w, 8)`` and MDS ``(w, w, 8)`` must be canonical words mod l
    (unchecked: the kernel's sums and its single conditional subtraction
    rely on it)."""
    dev = state.device
    w, R, number = _poseidon_consts(round_keys, mds, full_mask, sbox, dev, 2)
    B = state.shape[0]
    _check(state, "state", (B, w, 8), dev)
    if _route(dev) == "plain":
        return poseidon_permute_plain(state, round_keys, mds, full_mask, sbox)
    out = torch.empty((B, w, 8), dtype=torch.int32, device=dev)
    _launch("poseidon_permute", dev, "bp_poseidon_permute", _ptr(state),
            _ptr(out), _ptr(round_keys), _ptr(mds), _ptr(full_mask), B, w, R,
            number)
    return out


def poseidon_chain(witness: torch.Tensor, round_keys: torch.Tensor,
                   mds: torch.Tensor, full_mask: torch.Tensor, sbox: str
                   ) -> torch.Tensor:
    """(B, 8) new tensor: each witness row (W >= 1 words) folded by the 2:1
    hash (``poseidon_chain_plain``) in one launch, the accumulator never
    leaving the card; w from 4 to 8.  Witness and constants must be
    canonical words mod l, as for ``poseidon_permute`` (unchecked)."""
    dev = witness.device
    w, R, number = _poseidon_consts(round_keys, mds, full_mask, sbox, dev, 4)
    B, W = witness.shape[:2] if witness.dim() == 3 else (0, 0)
    if W < 1:
        raise ValueError(f"poseidon_chain: witness shape {tuple(witness.shape)}")
    _check(witness, "witness", (B, W, 8), dev)
    if _route(dev) == "plain":
        return poseidon_chain_plain(witness, round_keys, mds, full_mask, sbox)
    out = torch.empty((B, 8), dtype=torch.int32, device=dev)
    _launch("poseidon_chain", dev, "bp_poseidon_chain", _ptr(witness),
            _ptr(out), _ptr(round_keys), _ptr(mds), _ptr(full_mask), B, W, w,
            R, number)
    return out


def sc_mul_test_plain(a, b, reps: int = 1) -> torch.Tensor:
    """(n, 8) canonical: a * b^reps mod l."""
    x = a
    for _ in range(reps):
        x = mul_fq_plain(x, b)
    return x


def sc_mul_test(a: torch.Tensor, b: torch.Tensor, reps: int = 1
                ) -> torch.Tensor:
    """The depth probe of ``csrc/poseidon.cu``'s mod-l multiply: (n, 8)
    words, `reps` dependent products deep (``sc_mul_test_plain``).  Not a
    kernel of any path: it times one dependent ``sc_mul_canon`` (the
    Poseidon chain's floor); counts no launch."""
    dev = a.device
    n = a.shape[0]
    _check(a, "a", (n, 8), dev)
    _check(b, "b", (n, 8), dev)
    if reps < 1:
        raise ValueError(f"sc_mul_test: reps {reps}")
    if _route(dev) == "plain":
        return sc_mul_test_plain(a, b, reps)
    out = torch.empty((n, 8), dtype=torch.int32, device=dev)
    _launch("sc_mul_test", dev, "bp_sc_mul_test", _ptr(a), _ptr(b), _ptr(out),
            n, reps, count=False)
    return out
