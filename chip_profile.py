#!/usr/bin/env python3
"""Where the time goes on one NVIDIA GPU: the port's profile run.

    python3 chip_profile.py [--out profile.json]

Measures, for a VSMT-2 depth-253 proof (143,704 multipliers padded to
2^18) through ``TorchBackend("cuda")``:

1. three routes of the single-proof path in one process, each picked
   by a size threshold of the port's one route: the combined route (the
   default: shared-generator walks on ``msm_win5``, then IPP rounds 2-7
   on the combined layout, ``msm_win_pair`` + ``fold_w3h_comb`` +
   ``table_w4``), the w5 route (the combined layout off, its threshold
   COMB_MIN_N raised above 2^18, so rounds 2+ run ``msm_w4`` +
   ``fold_bits``) and the chunk-list route (``walker_min_n`` above 2^18,
   every walk on ``msm_w4``); warm prove and verify times in the routes'
   order and back, twice, each proof checked by the port's verifier and
   all routes' bytes equal;
2. one ``torch.profiler`` trace per route of a warm prove and a verify:
   wall time, device time (the union of the device intervals), the
   device's idle share (1 - device / wall) and device time per kernel;
3. ``msm_win5`` against ``msm_w4`` over the same 143,704 and 2^18
   generators (CUDA events; the results must be equal), the w5 and w4
   word encoders' wall times, and ``table_w5`` over 2^18 generators;
4. a batch of 8 depth-253 provers through ``prove_provers`` on the
   combined and the w5 route: wall times with one host worker and with
   the default host pool (w5, comb, comb, w5), peak device memory, and a
   profiled batch with one host worker per route.

Prints the card's nvidia-smi name and power limit first and one JSON line
per part; ``--out`` also writes every number to a JSON file.  Needs one
CUDA device; imports nothing of JAX.

    python3 chip_profile.py --walkers [--out walkers.json]

times only the window walkers at ``chip_smoke.py`` phase 2's shapes
(``msm_win5`` at 143,704 and 12,632 steps, 2^17 and 2^18; ``msm_win_pair``
at n = 2^16 and 2^11; ``msm_win`` at 143,704), each split into its
passes and its Horner tail, and the carry-chain multiply's test entry: a
quick run for tuning the walkers (no plain versions, no proofs).

    python3 chip_profile.py --sass

prints the instruction counts, by opcode, of the walker kernels, the
windowed w4 MSM, the half-width fold, fold_bits, the tables and the
multiply test entry in the built library (``cuobjdump -sass``).

    python3 chip_profile.py --routes comb [--out p.json]

runs parts 1-2 for the named routes only (comma-separated), for a warm
prove's device time by kernel without the rest.  Part 2 also lists a
warm prove's host-to-device copies by the port's function that asks for
each, with their bytes (``copies``).

    python3 chip_profile.py --batch [--out batch.json]

runs part 4 alone (the batch of 8), for its device time by kernel.

    python3 chip_profile.py --kernels [--out kernels.json]

times the windowed w4 MSM, the half-width fold, fold_bits and the tables
at ``chip_smoke.py`` phase 2's main-path shapes through their wrappers
only (so a copy of the script times an older tree's kernels too):
``msm_w4_pair`` over the 4096-point frozen pack, ``msm_w4`` at 2^14,
2048 and 1024 points, ``msm_grid`` at 143,704, ``msm_grid_local`` over a
65,536-point shard, ``fold_w3h`` 2^18 -> 2^17, ``fold_w3h_comb`` 2^18 ->
2^17 and 8192 -> 4096, ``fold_bits`` at 1024 and 2048 lanes (the main
path) and 2^17 (the chunk-list route's first fold; ones on the left),
``table_w4`` at 2^18 down to 2^13 points and ``table_w5`` at
2^18, ``msm_lane`` over 16 segments of 2048 points (the batch of 8's
flotilla), ``fold_c`` at 2^11, 2^13, 2^14, 2^15 and 2^17 outputs and
``fold_c_comb`` 2^18 -> 2^17 (by the library's choice, and under each
design where the wrappers take ``design``); and, on the frozen pack, the
composition ``table_w4`` + ``msm_win_pair``, which computes
``msm_w4_pair``'s function, in turns with it (pair, composition,
composition, pair; equal results); then the device-oracle kernels as
``--oracle`` times them.

    python3 chip_profile.py --oracle [--out oracle.json]

times the device-oracle path's kernels through their wrappers only:
``padd`` / ``pdbl`` at 1, 2^10, 2^14 and 2^18 points (CUDA events a call,
the profiler's device time a launch, and the wrapper's wall time a call
over back-to-back calls), ``smul_lanes`` at the path's 2^16 lanes, at
2^14 and at 12,288, 2^13, 4,096 and 2,048 (around its designs'
crossover), ``scalar_mul_shared`` over 2^14 points (phase 10 (d)): five
calls' wall, then three ``torch.profiler`` traces (wall, device time,
idle share, device time by kernel), ``msm_chunk_acc`` at 2^14 (the
path's chunk) and 143,704 points, ``msm_block_totals`` at 2^16 + 1,000
points, ``fold_grid`` at 2^17,
2^14, 12,288, 2^13 and 2,048 outputs with per-lane words and with
constant rows (by the library's choice, and under each design where the
wrapper takes ``design``); then the depth-253 proof of
``chip_smoke.py`` phase 10 (a) through ``DeviceBackend("cuda")``: one
cold prove and three warm proves and verifies (wall ms, synchronised;
the proof checked byte for byte against ``TorchBackend``'s and by the
verifier), and ``MsmEngine.msm`` at 2^16 (phase 10 (d)), five calls.  A
copy of the script times an older tree the same way.

    python3 chip_profile.py --step [--out step.json]

runs ``proving_step`` at ``chip_smoke.py`` phase 10 (b)'s shape (B = 8
proofs x W = 254 Merkle-path lanes, the cube Poseidon 2:1 hash, and
2^16 points x 253 bits) once after a small warm-up call: its wall time
(synchronised), its launches by kernel and a SHA-256 of its outputs'
bytes (equal across trees when both compute the same step).  It reads
only ``proving_step``, the launch counts and phase 10 (b)'s constants, so
a copy of the script placed in an older tree times that tree (for turns
parent, change, change, parent in one call).  Where the hasher has
``chain``, it also times ``witness_transform``'s fold in turns as one
``chain`` launch and as W - 1 ``hash_2`` calls (``chain_ms``,
``hash_2_loop_ms``; each digest checked against the step's).

    python3 chip_profile.py --rows [--out rows.json]

times the verifier's G/H rows on the card for ``chip_smoke.py``'s
depth-253 VSMT-2 proof (2^18 rows) and a depth-128 VSMT-4 proof (2^17):
each row kernel (``sc_powers`` for z^1..z^m, y^-i and s, ``tape_flatten``,
``tape_sums``, ``gh_rows`` over one row set and over a batch's eight,
``chip_smoke.batch_row_sets``), equal to its plain version, by CUDA events a
call and the profiler's device time, beside its plain version's time (one
call) and its bound (``chip_smoke.rows_work``); the tape's device copy
(``DeviceTape``) built three times, on the host alone and with its upload;
then verifications in turns, host rows (``chip_smoke.HostRows``: the
parent's path), device rows with the tape's copy cached, and device rows
over a new tape object (``cold``: the copy built and uploaded first, as
for a verifier built through the gadget API), four each: wall ms and the
program's spans of each (``verify.scalars``, its ``seam.fetch``,
``msm_gens`` and its ``seam.rows`` / ``seam.encode`` / ``seam.launch`` /
``seam.fetch``) and the bytes each copies to the card; and the host's
decompression of the proof's points alone.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import inspect
import json
import os
import re
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
ROUTES = ["w4", "w5", "comb"]
ROUTE_ORDER = (ROUTES + ROUTES[::-1]) * 2
BATCH = 8
FOLD_WIDE = 1 << 17  # the chunk-list route's first fold_bits round
FOLD_C_OUTPUTS = tuple(1 << k for k in (11, 13, 14, 15, 17))  # fold_c shapes
# fold_grid outputs: the oracle IPP's rounds 1, 4, 5 and 7, and 12,288 (the
# designs' crossover)
GRID_OUTPUTS = (1 << 17, 1 << 14, 12288, 1 << 13, 2048)
POINTWISE_N = (1, 1 << 10, 1 << 14, 1 << 18)  # padd / pdbl points
# smul_lanes lanes: the path's 2^16, phase 2's 2^14, and sizes around the
# designs' crossover
SMUL_LANES = (1 << 16, 1 << 14, 12288, 1 << 13, 4096, 2048)


def device_time_ms(prof, torch) -> tuple[float, dict]:
    """Union of the trace's device intervals (ms) and the device time per
    kernel name (top 16: [launches, ms])."""
    spans, by = [], {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        a, b = e.time_range.start, e.time_range.end
        spans.append((a, b))
        got = by.setdefault(e.name[:40], [0, 0.0])
        got[0] += 1
        got[1] += (b - a) / 1000
    total, cur = 0.0, None
    for a, b in sorted(spans):
        if cur is None or a > cur[1]:
            total += 0 if cur is None else cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    total += 0 if cur is None else cur[1] - cur[0]
    top = dict(sorted(by.items(), key=lambda kv: -kv[1][1])[:16])
    return total / 1000, top


def profiled(torch, fn) -> dict:
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1000
    dev, by = device_time_ms(prof, torch)
    return dict(wall_ms=wall, device_ms=dev, idle_share=1 - dev / wall,
                by_kernel=by)


def copies(torch, fn) -> dict:
    """The host-to-device copies `fn` asks for through torch's Python API
    (``Tensor.to`` / ``.cuda`` / ``.copy_``, ``torch.tensor`` /
    ``as_tensor`` onto a card), by the innermost function of the port on
    the stack and its caller in the port: {"module.function <-
    module.caller": [copies, bytes]}.  Copies torch makes in C++ alone
    (an indexed assignment from the host) are not seen; the profile's
    HtoD count holds them all."""
    pkg = os.sep + "bulletproofs_r1cs_gadgets_tpu_torch" + os.sep
    got = {}

    def note(nbytes):
        names, f = [], sys._getframe(2)
        while f is not None and len(names) < 2:
            if pkg in f.f_code.co_filename:
                mod = os.path.splitext(os.path.basename(f.f_code.co_filename))[0]
                names.append(f"{mod}.{f.f_code.co_name}")
            f = f.f_back
        c = got.setdefault(" <- ".join(names) or "outside the port", [0, 0])
        c[0] += 1
        c[1] += int(nbytes)

    T = torch.Tensor
    orig = dict(to=T.to, cuda=T.cuda, copy_=T.copy_, tensor=torch.tensor,
                as_tensor=torch.as_tensor)

    def moved(self, out):
        if self.device.type == "cpu" and out.device.type == "cuda":
            note(out.nbytes)
        return out

    def made(data, out):
        on_card = isinstance(data, torch.Tensor) and data.device.type == "cuda"
        if out.device.type == "cuda" and not on_card:
            note(out.nbytes)
        return out

    def copy_(self, src, *a, **k):
        if self.device.type == "cuda" and src.device.type == "cpu":
            note(src.nbytes)
        return orig["copy_"](self, src, *a, **k)

    T.to = lambda self, *a, **k: moved(self, orig["to"](self, *a, **k))
    T.cuda = lambda self, *a, **k: moved(self, orig["cuda"](self, *a, **k))
    T.copy_ = copy_
    torch.tensor = lambda data, *a, **k: made(data, orig["tensor"](data, *a, **k))
    torch.as_tensor = lambda data, *a, **k: made(
        data, orig["as_tensor"](data, *a, **k))
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        T.to, T.cuda, T.copy_ = orig["to"], orig["cuda"], orig["copy_"]
        torch.tensor, torch.as_tensor = orig["tensor"], orig["as_tensor"]
    return dict(sorted(got.items(), key=lambda kv: -kv[1][1]))


def wall_s(torch, fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def sass(build) -> dict:
    """Instructions of the walker kernels and the multiply test entry in
    the built library (cuobjdump -sass): the total and the eight commonest
    opcodes, by mangled kernel name."""
    cuobjdump = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", build.build()],
                          capture_output=True, text=True, check=True).stdout
    out = {}
    for body in re.split(r"\n\s+Function : ", text)[1:]:
        name = body.split("\n", 1)[0].strip()
        if not any(k in name for k in ("msm_win", "msm_w4", "fold_w3h",
                                       "fold_bits", "fold_c", "table_kernel",
                                       "fold_grid",
                                       "fe_mul_test")):
            continue
        ops = re.findall(
            r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]+)", body)
        count = collections.Counter(op.split(".")[0] for op in ops)
        out[name] = dict(total=len(ops), **dict(count.most_common(8)))
    return out


def walkers(bp, torch, cs, cc, ck, F, gens) -> dict:
    """The window walkers at chip_smoke.py phase 2's shapes over random
    words (cs.time_walk: CUDA events split into the Horner tail, by the
    profiler, and the passes), then cs.phase_fe_mul."""
    import numpy as np

    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(cs.SEED)
    N, N1 = cs.GENS_N, cs.N1
    G = F.from_raw(gens.G_raw(N), dev)
    H = F.from_raw(gens.H_raw(N), dev)
    ident = F.identity_points(1, dev)
    rows = cs.random_scalar_rows(bp, N, rng)
    w5, w4 = ck.w5_words(rows, dev), ck.w4_words(rows, dev)
    tbl = cc.table_w5(G)
    for v, poff in ((N1, 0), (N1 - N // 2, 0), (N // 2, N // 2), (N, 0)):
        cs.time_walk(torch, "msm_win5", f"v {v}", lambda: cc.msm_win5(
            tbl, w5, ident, v, poff=poff, woff=poff))
    del tbl
    chain2 = torch.cat([ident, ident])
    for n in cs.COMB_N:
        t = cc.table_w4(torch.cat([G[: 2 * n], H[: 2 * n]]))
        walks = ck.comb_walks(n)
        cs.time_walk(torch, "msm_win_pair", f"n {n}",
                     lambda: cc.msm_win_pair(t, w4, chain2, walks))
    t = cc.table_w4(G)
    cs.time_walk(torch, "msm_win", f"v {N1}",
                 lambda: cc.msm_win(t, w4, ident, N1))
    del t
    return dict(walkers=cs.WALKS,
                fe_mul_test=cs.phase_fe_mul(bp, torch, cc, F, dev, rng))


def kernels(bp, torch, cs, cc, ck, F, gens) -> dict:
    """The windowed w4 MSM and the half-width fold at chip_smoke.py phase
    2's main-path shapes over random words (cs.time_ms, ms a call), and
    msm_w4_pair against table_w4 + msm_win_pair on the frozen pack."""
    import numpy as np

    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(cs.SEED)
    N, N1, L = cs.GENS_N, cs.N1, bp.L
    G = F.from_raw(gens.G_raw(N), dev)
    H = F.from_raw(gens.H_raw(N), dev)
    rows = cs.random_scalar_rows(bp, N, rng)
    w4 = ck.w4_words(rows, dev)
    ident = F.identity_points(1, dev)
    ms = {}

    def timed(name, fn, reps=10):
        ms[name] = cs.time_ms(torch, fn, reps)
        print(f"  {name}: {ms[name]:.3f} ms", flush=True)

    S = cs.PAIR_S
    half = 2 * S
    pack = torch.cat([G[:S], H[:S], G[:S], H[:S]]).contiguous()
    pw = w4[: 2 * half].contiguous()
    acc2 = torch.cat([ident, ident])
    walks = ((half, 0, 0, half, 0), (half, half, half, half, half))

    def pair():
        return cc.msm_w4_pair(pack, pw, acc2, half)

    def composition():
        return cc.msm_win_pair(cc.table_w4(pack), pw, acc2, walks)

    assert F.to_points(pair()) == F.to_points(composition())
    for turn, (tag, fn) in enumerate((("pair", pair), ("composition", composition),
                                      ("composition", composition), ("pair", pair))):
        timed(f"frozen pack {2 * half}: {tag} (turn {turn})", fn)
    for n in cs.MSM_SIZES:
        Gn, wn = G[:n], w4[:n]
        timed(f"msm_w4 {n}", lambda: cc.msm_w4(Gn, wn, ident))
    timed(f"msm_grid {N1}", lambda: cc.msm_grid(G, w4[:N1], ident, 0))
    shard = cs.SHARD_CHUNKS * ck.CHUNK
    Gs, ws = G[:shard], w4[:shard]
    timed(f"msm_grid_local {shard}", lambda: cc.msm_grid_local(
        Gs, ws, ident, cs.SHARD_CHUNKS, ck.CHUNK))

    def rand_pair():
        return ck.half_gcd_split(int.from_bytes(rng.bytes(32), "little") % L, L)

    words = ck.w3h_fold_words([[rand_pair(), rand_pair()]], dev)
    timed(f"fold_w3h {N} -> {N // 2}", lambda: cc.fold_w3h(G, words, N1 - N // 2))
    for m in (N // 4, cs.COMB7_M):
        C = torch.cat([G[: 2 * m], H[: 2 * m]])
        cw = ck.w3h_fold_words([[rand_pair(), rand_pair()]] * 2, dev)
        timed(f"fold_w3h_comb {4 * m} -> {2 * m}",
              lambda: cc.fold_w3h_comb(C, cw, m // 5))
    for m in (*cs.FOLD_SIZES, FOLD_WIDE):  # the IPP's folds: ones on the left
        wl = ck.fold_words(ck.const_rows(bp.Scalar(1), m), dev)
        wr = ck.fold_words(rows[:m], dev)
        Gl, Gr = G[:m], G[m : 2 * m]
        timed(f"fold_bits {m}", lambda: cc.fold_bits(Gl, Gr, wl, wr))
    for k in cs.TABLE_SIZES:
        Gk = G[:k]
        timed(f"table_w4 {k}", lambda: cc.table_w4(Gk))
    timed(f"table_w5 {N}", lambda: cc.table_w5(G), 5)
    lane_n = cs.LANE_V * cs.LANE_SEG
    Hl, wl4 = H[:lane_n], w4[:lane_n]
    timed(f"msm_lane {cs.LANE_V} x {cs.LANE_SEG}",
          lambda: cc.msm_lane(Hl, wl4, cs.LANE_V))

    def rand_const():
        return bp.Scalar(int.from_bytes(rng.bytes(32), "little") % L)

    designs = designs_of(cc.fold_c, cc.FOLD_C_DESIGNS)
    for v in FOLD_C_OUTPUTS:
        Gv = G[: 2 * v]
        cw = ck.c_fold_words([(rand_const(), rand_const())], dev)
        for d in designs:
            kw = {} if d is None else dict(design=d)
            timed(f"fold_c {v} {d or 'auto'}",
                  lambda: cc.fold_c(Gv, cw, v // 2 + 3, **kw), 5)
    m = N // 4
    C = torch.cat([G[: 2 * m], H[: 2 * m]])
    cw = ck.c_fold_words([(rand_const(), rand_const())] * 2, dev)
    for d in designs:
        kw = {} if d is None else dict(design=d)
        timed(f"fold_c_comb {4 * m} -> {2 * m} {d or 'auto'}",
              lambda: cc.fold_c_comb(C, cw, m // 5, **kw), 5)
    ms.update(oracle_kernels(bp, torch, cs, cc, ck, F, gens))
    return dict(kernels_ms=ms)


def designs_of(fn, names) -> list:
    """[None] (the library's choice by size), then each of `names` if the
    wrapper `fn` takes ``design`` (an older tree's may not)."""
    if "design" in inspect.signature(fn).parameters:
        return [None, *names]
    return [None]


def oracle_kernels(bp, torch, cs, cc, ck, F, gens) -> dict:
    """The device-oracle path's kernels at their path's shapes over
    random scalars (cs.time_ms, ms a call): padd / pdbl at POINTWISE_N
    points (with the profiler's device ms a launch and the wrapper's wall
    ms a call beside each), smul_lanes at SMUL_LANES, the MSMs, fold_grid
    (smul_lanes and fold_grid by the library's choice and under each
    design where the wrapper takes one), and scalar_mul_shared over 2^14
    points (phase 10 (d)): five calls' wall, then three in torch.profiler
    traces (wall, device time, idle share)."""
    import numpy as np

    from bulletproofs_r1cs_gadgets_tpu_torch.ops import curve as C

    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(cs.SEED + 11)
    N, L = cs.GENS_N, bp.L
    G = F.from_raw(gens.G_raw(N), dev)
    H = F.from_raw(gens.H_raw(N), dev)
    ms = {}

    def timed(name, fn, reps=10):
        ms[name] = cs.time_ms(torch, fn, reps)
        print(f"  {name}: {ms[name]:.3f} ms", flush=True)

    def wall_per_call(fn, calls):
        def run():
            for _ in range(calls):
                fn()

        fn()
        return 1000 * wall_s(torch, run) / calls

    for n in POINTWISE_N:
        a, b = G[:n], H[:n]
        for name, fn in (("padd", lambda: cc.padd(a, b)),
                         ("pdbl", lambda: cc.pdbl(a))):
            key = f"{name} {n}"
            timed(key, fn, 20 if n > 1 << 14 else 200)
            ms[f"{key} device"] = max(cs.kernel_ms(torch, fn, 20).values())
            ms[f"{key} wall"] = wall_per_call(fn, 20 if n > 1 << 14 else 200)
            print(f"  {key}: device {ms[key + ' device']:.4f} ms, wall "
                  f"{ms[key + ' wall']:.4f} ms a call", flush=True)
    rows = cs.random_scalar_rows(bp, max(SMUL_LANES), rng)
    bits_all = torch.from_numpy(ck.bit_words(rows)).to(dev)
    for n in SMUL_LANES:
        Gn, wn = G[:n], bits_all[:n]
        # smul_lanes' design names are fold_c's (an older tree lacks its own)
        for d in designs_of(cc.smul_lanes, cc.FOLD_C_DESIGNS):
            kw = {} if d is None else dict(design=d)
            timed(f"smul_lanes {n} {d or 'auto'}",
                  lambda: cc.smul_lanes(Gn, wn, **kw), 5)
    k = int.from_bytes(rng.bytes(32), "little") % L
    pts = G[: cs.SMUL_N]
    C.scalar_mul_shared(pts, k)
    before = dict(cc.LAUNCHES)
    shared = [profiled(torch, lambda: C.scalar_mul_shared(pts, k)) for _ in range(3)]
    launches = sum(cc.LAUNCHES[x] - before[x] for x in ("padd", "pdbl")) // 3
    ms["scalar_mul_shared"] = dict(
        launches=launches,
        unprofiled_wall_ms=[1000 * wall_s(torch, lambda: C.scalar_mul_shared(pts, k))
                            for _ in range(5)],
        wall_ms=[r["wall_ms"] for r in shared],
        device_ms=[r["device_ms"] for r in shared],
        idle_share=[r["idle_share"] for r in shared], by_kernel=shared[-1]["by_kernel"])
    print(f"  scalar_mul_shared {cs.SMUL_N}: {json.dumps(ms['scalar_mul_shared'])}",
          flush=True)

    acc = F.from_points([bp.PedersenGens.default().B], dev)
    rows = cs.random_scalar_rows(bp, N, rng)
    bits = torch.from_numpy(ck.bit_words(rows)).to(dev)
    for n in (cs.MSM_N, cs.N1):
        Gn, wn = G[:n], bits[:n]
        timed(f"msm_chunk_acc {n}", lambda: cc.msm_chunk_acc(Gn, wn, acc), 5)
    n = cs.TOTALS_N
    Gn, wn = G[:n], bits[:n]
    timed(f"msm_block_totals {n}", lambda: cc.msm_block_totals(Gn, wn), 5)
    sl = cs.random_scalar_rows(bp, N // 2, rng)
    sr = cs.random_scalar_rows(bp, N // 2, rng)
    wl_all, wr_all = ck.w2_words(sl, dev), ck.w2_words(sr, dev)
    u = bp.Scalar(int.from_bytes(rng.bytes(32), "little") % L)
    ci, cu = ck.const_grid_words(u.invert(), dev), ck.const_grid_words(u, dev)
    designs = designs_of(cc.fold_grid, cc.FOLD_GRID_DESIGNS)
    for v in GRID_OUTPUTS:
        Gv = G[: 2 * v]
        wl, wr = wl_all[:v], wr_all[:v]
        for tag, a, b in (("lanes", wl, wr), ("const", ci, cu)):
            for d in designs:
                kw = {} if d is None else dict(design=d)
                timed(f"fold_grid {v} {tag} {d or 'auto'}",
                      lambda: cc.fold_grid(Gv, a, b, v, **kw), 5 if v > 8192 else 10)
    return ms


def oracle_path(bp, torch, cs, cc, ck, F, gens) -> dict:
    """chip_smoke.py phase 10 (a) and (d) alone: the depth-253 proof
    through DeviceBackend("cuda") (cold, then three warm proves and
    verifies; the bytes TorchBackend's) and MsmEngine.msm at 2^16."""
    import numpy as np

    from bulletproofs_r1cs_gadgets_tpu_torch.ops.msm import MsmEngine

    params, tree = cs.build_tree(bp, cs.DEPTH)
    comp, tape, comms, prover = cs.synthesize(bp, params, tree, cs.DEPTH, cs.SEED)
    snap = prover.snapshot()

    def fresh():
        prover.restore(snap)
        prover.rng = np.random.RandomState(cs.SEED)

    fresh()
    want = prover.prove(gens, backend=bp.TorchBackend("cuda")).to_bytes()
    backend = bp.DeviceBackend(torch.device("cuda", 0))
    out = dict(prove_ms=[], verify_ms=[])
    for k in range(4):
        fresh()
        proof = [None]

        def prove():
            proof[0] = prover.prove(gens, backend=backend)

        t = 1000 * wall_s(torch, prove)
        assert proof[0].to_bytes() == want, "DeviceBackend proof != TorchBackend's"
        v = 1000 * wall_s(torch, lambda: cs.verify(bp, comp, tape, comms, proof[0],
                                                   gens, backend))
        if k == 0:
            out["cold_prove_ms"], out["cold_verify_ms"] = t, v
        else:
            out["prove_ms"].append(t)
            out["verify_ms"].append(v)
    rows = cs.random_scalar_rows(bp, cs.ORACLE_MSM_N, np.random.RandomState(cs.SEED))
    hostG = gens.G(cs.ORACLE_MSM_N)
    eng = MsmEngine(torch.device("cuda", 0))
    eng.device_points(hostG)
    eng.msm(rows, hostG)
    out["msm_engine_ms"] = [1000 * wall_s(torch, lambda: eng.msm(rows, hostG))
                            for _ in range(5)]
    print(json.dumps(out), flush=True)
    return out


def step(bp, torch, cs, cc, F) -> dict:
    """proving_step at phase 10 (b)'s shape, as ``--step`` describes."""
    import hashlib

    import numpy as np

    from bulletproofs_r1cs_gadgets_tpu_torch.ops.field import FQ
    from bulletproofs_r1cs_gadgets_tpu_torch.parallel import pipeline

    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(cs.SEED + 10)
    B, W, N = cs.ORACLE_B, cs.ORACLE_W, cs.ORACLE_MSM_N
    vals = [int.from_bytes(rng.bytes(32), "little") % bp.L
            for _ in range(B * W)]
    witness = FQ.to_device(vals, dev).reshape(B, W, 8)
    gens = bp.BulletproofGens(N)
    points = F.from_raw(gens.G_raw(N), dev)
    rows = cs.random_scalar_rows(bp, N, rng)
    bitw = torch.from_numpy(
        np.unpackbits(rows.view(np.uint8), axis=1, bitorder="little")[:, :253]
        .astype(np.int32)).to(dev)
    pipeline.proving_step(witness[:, :2].contiguous(), points[:16],
                          bitw[:16])  # warm-up: the hasher, first launches
    cc.reset_launches()
    (digest, commitment), ms = cs.timed_once(
        torch, lambda: pipeline.proving_step(witness, points, bitw))
    sha = hashlib.sha256(digest.cpu().numpy().tobytes()
                         + commitment.cpu().numpy().tobytes()).hexdigest()
    out = dict(B=B, W=W, N=N, step_ms=ms, outputs_sha256=sha,
               launches={k: v for k, v in cc.LAUNCHES.items() if v})
    h = pipeline.flagship_hasher(dev)
    if hasattr(h, "chain"):
        # witness_transform's two designs in turns: one chain launch, and
        # W - 1 hash_2 calls (one permute launch each)
        def loop():
            acc = witness[:, 0]
            for i in range(1, W):
                acc = h.hash_2(acc, witness[:, i])
            return acc

        for key, fn in (("chain_ms", lambda: h.chain(witness)),
                        ("hash_2_loop_ms", loop), ("hash_2_loop_ms", loop),
                        ("chain_ms", lambda: h.chain(witness))):
            got, t = cs.timed_once(torch, fn)
            assert torch.equal(got, digest), f"{key}: digest differs"
            out.setdefault(key, []).append(t)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write every number to this file")
    ap.add_argument("--walkers", action="store_true",
                    help="time the window walkers only")
    ap.add_argument("--sass", action="store_true",
                    help="count the redesigned kernels' instructions")
    ap.add_argument("--kernels", action="store_true",
                    help="time the redesigned kernels only")
    ap.add_argument("--oracle", action="store_true",
                    help="time the device-oracle kernels and path only")
    ap.add_argument("--routes",
                    help="profile these routes only (comma-separated), no batch")
    ap.add_argument("--batch", action="store_true",
                    help="run part 4 (the batch of 8) only")
    ap.add_argument("--step", action="store_true",
                    help="time proving_step at phase 10 (b)'s shape only")
    ap.add_argument("--rows", action="store_true",
                    help="time the verifier's G/H rows on the card only")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: chip_profile runs only on a GPU")
    import chip_smoke as cs
    import bulletproofs_r1cs_gadgets_tpu_torch as bp
    from bulletproofs_r1cs_gadgets_tpu_torch.ops import build
    from bulletproofs_r1cs_gadgets_tpu_torch.ops import chunks as ck
    from bulletproofs_r1cs_gadgets_tpu_torch.ops import cuda_curve as cc
    from bulletproofs_r1cs_gadgets_tpu_torch.ops import field as F

    out = {}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    out["card"] = smi.stdout.strip()
    print(out["card"], flush=True)
    build.load()
    if args.sass:
        print(json.dumps(sass(build)), flush=True)
        return 0
    if args.step:
        out.update(step(bp, torch, cs, cc, F))
        print(json.dumps(out), flush=True)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(out, f, indent=1)
        return 0
    if args.rows:
        cs.phase_device(torch)
        out.update(verify_rows(bp, torch, cs, cc))
        print(json.dumps(out), flush=True)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(out, f, indent=1)
        return 0
    gens = bp.BulletproofGens(cs.GENS_N)
    if args.walkers or args.kernels or args.oracle:
        if args.oracle:
            out["kernels_ms"] = oracle_kernels(bp, torch, cs, cc, ck, F, gens)
            out["oracle"] = oracle_path(bp, torch, cs, cc, ck, F, gens)
        else:
            part = walkers if args.walkers else kernels
            out.update(part(bp, torch, cs, cc, ck, F, gens))
        print(json.dumps(out), flush=True)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(out, f, indent=1)
        return 0
    params, tree = cs.build_tree(bp, cs.DEPTH)
    if not args.batch:
        out.update(single(bp, torch, cs, cc, ck, F, gens, params, tree, args))
    if not args.routes:
        out.update(batch8(bp, torch, cs, gens, params, tree))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


def single(bp, torch, cs, cc, ck, F, gens, params, tree, args) -> dict:
    """Parts 1-3 (part 3 unless `args.routes`)."""
    import numpy as np

    out = {}
    comp, tape, comms, prover = cs.synthesize(
        bp, params, tree, cs.DEPTH, cs.SEED
    )
    snap = prover.snapshot()

    def fresh():  # the prover as synthesized, its rng from the seed again
        prover.restore(snap)
        prover.rng = np.random.RandomState(cs.SEED)

    # 1-2. the three routes of one proof
    shared = bp.TorchBackend("cuda")
    routes = {  # name: (backend, context of its proves)
        "w4": (bp.TorchBackend("cuda", walker_min_n=2 * cs.GENS_N),
               contextlib.nullcontext),
        "w5": (shared, cs.combined_off),
        "comb": (shared, contextlib.nullcontext),
    }

    if args.routes:
        routes = {name: routes[name] for name in args.routes.split(",")}

    def prove(name):
        be, ctx = routes[name]
        with ctx():
            return prover.prove(gens, backend=be)

    proofs = {}
    for name, (be, _) in routes.items():  # cold: tables, uploads
        fresh()
        proofs[name] = prove(name)
        cs.verify(bp, comp, tape, comms, proofs[name], gens, be)
    assert len({p.to_bytes() for p in proofs.values()}) == 1
    prove_s = {name: [] for name in routes}
    verify_s = {name: [] for name in routes}
    for name in ROUTE_ORDER:
        if name not in routes:
            continue
        be = routes[name][0]
        fresh()
        prove_s[name].append(wall_s(torch, lambda: prove(name)))
        verify_s[name].append(wall_s(
            torch,
            lambda: cs.verify(bp, comp, tape, comms, proofs[name], gens, be),
        ))
    out["warm_prove_s"], out["verify_s"] = prove_s, verify_s
    print(json.dumps({"warm_prove_s": prove_s, "verify_s": verify_s}),
          flush=True)
    for name, (be, _) in routes.items():
        def prove_once():
            fresh()
            prove(name)

        out[f"profile_prove_{name}"] = profiled(torch, prove_once)
        out[f"copies_prove_{name}"] = copies(torch, prove_once)
        print(name, "copies", json.dumps(out[f"copies_prove_{name}"]),
              flush=True)
        out[f"profile_verify_{name}"] = profiled(
            torch,
            lambda: cs.verify(bp, comp, tape, comms, proofs[name], gens, be),
        )
        print(name, json.dumps(out[f"profile_prove_{name}"]),
              json.dumps(out[f"profile_verify_{name}"]), flush=True)

    if args.routes:
        return out

    # 3. the walker against the w4 ladder over the same generators
    dev = torch.device("cuda", 0)
    be, share = shared, gens.share(0)
    tG = be._gens_table(share, cs.GENS_N, "G")
    G = be._gens(share, cs.GENS_N, "G")
    rng = np.random.RandomState(cs.SEED)
    kern = {}
    for n in (cs.N1, cs.GENS_N):
        rows = cs.random_scalar_rows(bp, n, rng)
        w5, w4 = ck.w5_words(rows, dev), ck.w4_words(rows, dev)
        chain = F.identity_points(1, dev)
        Gn = G[:n].contiguous()
        assert (F.to_points(cc.msm_win5(tG, w5, chain, n))
                == F.to_points(cc.msm_w4(Gn, w4, chain)))
        kern[f"msm_win5_ms_{n}"] = cs.time_ms(
            torch, lambda: cc.msm_win5(tG, w5, chain, n), 5
        )
        kern[f"msm_w4_ms_{n}"] = cs.time_ms(
            torch, lambda: cc.msm_w4(Gn, w4, chain), 5
        )
        kern[f"w5_encode_ms_{n}"] = 200 * wall_s(
            torch, lambda: [ck.w5_words(rows, dev) for _ in range(5)]
        )
        kern[f"w4_encode_ms_{n}"] = 200 * wall_s(
            torch, lambda: [ck.w4_words(rows, dev) for _ in range(5)]
        )
    kern[f"table_w5_ms_{cs.GENS_N}"] = cs.time_ms(
        torch, lambda: cc.table_w5(G), 3
    )
    out.update(kern)
    print(json.dumps(kern), flush=True)
    be.evict_gens()
    return out


def batch8(bp, torch, cs, gens, params, tree) -> dict:
    """Part 4: the batch of 8 on the w5 and the combined route."""
    # 4. the batch of 8
    comp8 = bp.CompiledVSMT2(params, cs.DEPTH, constrain_index_bits=False)
    circuit = (comp8, comp8.tape(tree.root))
    jobs = [
        cs.synthesize(bp, params, tree, cs.DEPTH, cs.SEED + 100 * i, i + 1,
                      circuit)[3]
        for i in range(BATCH)
    ]
    snaps = [p.snapshot() for p in jobs]
    bb = bp.TorchBackend("cuda")
    batch_ctx = {"w5": cs.combined_off, "comb": contextlib.nullcontext}

    def batch(workers, route):
        def run():
            for p, s in zip(jobs, snaps):
                p.restore(s)
            with batch_ctx[route]():
                bp.prove_provers(jobs, gens, backend=bb, host_workers=workers)
        return run

    batch(1, "comb")()  # cold: tables, uploads
    res = {}
    for route in ("w5", "comb", "comb", "w5"):
        for workers, tag in ((1, "workers1"), (None, "default_pool")):
            res.setdefault(f"batch8_s_{tag}_{route}", []).append(
                wall_s(torch, batch(workers, route))
            )
    for route in ("w5", "comb"):
        torch.cuda.reset_peak_memory_stats()
        res[f"batch8_s_peak_mem_{route}"] = wall_s(torch, batch(None, route))
        res[f"batch8_peak_mem_bytes_{route}"] = torch.cuda.max_memory_allocated()
        res[f"profile_batch8_workers1_{route}"] = profiled(
            torch, batch(1, route)
        )
    print(json.dumps(res), flush=True)
    return res

def _scalars_split(bp, torch, case, backend, reps: int = 5) -> dict:
    """The device job (``Verifier._verification_job`` with device rows,
    the ``verify.scalars`` phase) split by stubbing its parts, medians of
    `reps` ms: ``job``; ``no_decompress`` with point decompression a
    stub; ``transcript`` with the rows a stand-in too that launches
    nothing (the replay, the IPP's challenges and the head scalars).
    Decompression is job - no_decompress, the device rows' host side
    (launches, tables, the sums' wait) no_decompress - transcript."""
    import statistics
    from unittest import mock

    import numpy as np

    from bulletproofs_r1cs_gadgets_tpu_torch.core import verifier as vmod
    from bulletproofs_r1cs_gadgets_tpu_torch.ops import verify_rows as vr

    class NoRows(vr.VerifyRows):
        def __init__(self, nv):
            self.wV = np.zeros((nv, 4), np.uint64)

        def flatten(self, z, y_inv):
            pass

        def sums(self):
            return self.wV, bp.Scalar.zero(), bp.Scalar.zero()

    ident = bp.RistrettoPoint.identity()
    nodec = (mock.patch.object(vmod.RistrettoPoint, "decompress",
                               staticmethod(lambda b: ident)),
             mock.patch.object(vmod, "_decompress_allow_identity",
                               lambda b: ident))

    def job(stub_points: bool, stub_rows: bool) -> float:
        v = case.verifier()
        rows = backend.verify_rows
        if stub_rows:
            def rows(*a):
                return NoRows(len(v.V))
        with contextlib.ExitStack() as stack:
            if stub_points:
                for p in nodec:
                    stack.enter_context(p)
            torch.cuda.synchronize()
            a = time.perf_counter()
            v._verification_job(case.proof, bp.PedersenGens.default(),
                                case.gens, rows)
            torch.cuda.synchronize()
            return 1e3 * (time.perf_counter() - a)

    got = {"job": [], "no_decompress": [], "transcript": []}
    for _ in range(reps):
        got["job"].append(job(False, False))
        got["no_decompress"].append(job(True, False))
        got["transcript"].append(job(True, True))
    return {k: statistics.median(v) for k, v in got.items()}


def _verify_turn(bp, torch, cs, case, backend, turn: str) -> dict:
    """One verification of `case` on `turn`'s path, with the program's
    spans: ``host`` (the backend's ``verify_rows`` hidden: host rows, the
    parent's path), ``device`` (the tape's device copy cached) or
    ``cold`` (a new tape object, as a verifier built through the gadget
    API brings: its ``DeviceTape`` is built and uploaded first)."""
    import copy

    from bulletproofs_r1cs_gadgets_tpu_torch.utils import metrics

    v = case.verifier()
    if turn == "cold":
        v._tape_memo = copy.copy(v._tape_memo)
    be = cs.HostRows(backend) if turn == "host" else backend
    metrics.take()
    metrics.enable()
    torch.cuda.synchronize()
    a = time.perf_counter()
    ok = cs.verdict(bp, v, case.proof, case.gens, be)
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - a)
    metrics.disable()
    spans = metrics.take()
    assert ok, turn
    parts = collections.defaultdict(float)
    for x in spans:
        par = next((y.name for y in spans if y.id == x.parent), "")
        key = x.name if par in ("", "verify") else f"{par}/{x.name}"
        parts[key] += 1e3 * (x.end - x.start)
    return dict(
        wall_ms=wall, spans_ms=dict(parts),
        h2d_bytes=sum(x.counts.get("h2d_bytes", 0) for x in spans),
        device_rows=sum(x.counts.get("device_rows", 0) for x in spans),
        launches=sum(x.counts.get("launches", 0) for x in spans))


def verify_rows(bp, torch, cs, cc) -> dict:
    """--rows: the row kernels at the cells' shapes, and verifications
    with host, device and cold-tape device rows in turns (see the module
    docstring)."""
    import numpy as np

    from bulletproofs_r1cs_gadgets_tpu_torch.ops import verify_rows as vr

    dev = torch.device("cuda", 0)
    backend = bp.TorchBackend(dev)
    rng = np.random.RandomState(cs.SEED + 18)
    out = {}
    for name, make in (
            ("vsmt2-d253", lambda: cs.vsmt2_case(bp, cs.DEPTH, backend)),
            ("vsmt4-d128", lambda: cs.vsmt4_case(bp, 128, backend))):
        case = make()
        v = case.verifier()
        tape = v._tape_memo
        n, nv = v.num_vars, len(v.V)
        N = 1 << (n - 1).bit_length()
        rows = backend.verify_rows(tape, n, n, nv, N)
        sc = [bp.Scalar.from_bytes_mod_order_wide(rng.bytes(64))
              for _ in range(6 + N.bit_length())]
        t = rows.tape
        zt = vr.power_tables(sc[0], 1, t.m, dev)
        yt = vr.power_tables(sc[1], 0, N, dev)
        st = vr.s_tables([u * u for u in sc[7:]], sc[6], dev)
        zp = cc.sc_powers(*zt, t.m)
        wires = cc.tape_flatten(t.off, t.cidx, t.coeff, zp)
        yinv = cc.sc_powers(*yt, N)
        s = cc.sc_powers(*st, N)
        consts = vr.host_words(sc[2:6] + sc[2:6]).reshape(1, 8, 8)
        one = [(wires, yinv, s, n, n)]
        sets, c8 = cs.batch_row_sets(bp, cc, t, n, N, rng)
        T, W, tc = t.cidx.shape[0], t.off.shape[0] - 1, t.ccidx.shape[0]
        work = cs.rows_work(cc, t.m, n, N, T, W, tc)
        calls = {
            "sc_powers z": ("sc_powers_z", lambda: cc.sc_powers(*zt, t.m),
                            lambda: cc.sc_powers_plain(*zt, t.m)),
            "sc_powers y": ("sc_powers", lambda: cc.sc_powers(*yt, N),
                            lambda: cc.sc_powers_plain(*yt, N)),
            "sc_powers s": ("sc_powers", lambda: cc.sc_powers(*st, N),
                            lambda: cc.sc_powers_plain(*st, N)),
            "tape_flatten": (
                "tape_flatten",
                lambda: cc.tape_flatten(t.off, t.cidx, t.coeff, zp),
                lambda: cc.tape_flatten_plain(t.off, t.cidx, t.coeff, zp)),
            "tape_sums": (
                "tape_sums",
                lambda: cc.tape_sums(t.ccidx, t.ccoeff, zp, wires, yinv, n),
                lambda: cc.tape_sums_plain(t.ccidx, t.ccoeff, zp, wires,
                                           yinv, n)),
            "gh_rows": ("gh_rows", lambda: cc.gh_rows(one, consts),
                        lambda: cc.gh_rows_plain(one, consts)),
            "gh_rows b8": ("gh_rows_b8", lambda: cc.gh_rows(sets, c8),
                           lambda: cc.gh_rows_plain(sets, c8)),
        }
        kern = {}
        for key, (wkey, fn, plain) in calls.items():
            want, pms = cs.timed_once(torch, plain)
            assert torch.equal(fn(), want), f"{name} {key} != plain"
            ms = cs.time_ms(torch, fn, 20)
            by = cs.kernel_ms(torch, fn)
            kern[key] = dict(ms=ms, plain_ms=pms, device_ms=by,
                             **cs.bound(*work[wkey]))
            print(f"  {name} {key}: {ms:.4f} ms (device {by}), plain "
                  f"{pms:.1f} ms, bound {kern[key]['bound_ms']:.4f} ms by "
                  f"{kern[key]['bound_by']}", flush=True)
        build = {"host_ms": [], "total_ms": []}
        for _ in range(3):
            for key, where in (("host_ms", "cpu"), ("total_ms", dev)):
                torch.cuda.synchronize()
                a = time.perf_counter()
                vr.DeviceTape(tape, n, nv, where)
                torch.cuda.synchronize()
                build[key].append(1e3 * (time.perf_counter() - a))
        ver = {"host": [], "device": [], "cold": []}
        for turn in ("host", "device", "cold") * 4:
            ver[turn].append(_verify_turn(bp, torch, cs, case, backend, turn))
        pts = ([case.proof.A_I1, case.proof.A_O1, case.proof.S1]
               + list(case.verifier().V)
               + [case.proof.T_1, case.proof.T_3, case.proof.T_4,
                  case.proof.T_5, case.proof.T_6]
               + case.proof.ipp_proof.L_vec + case.proof.ipp_proof.R_vec)
        dec = []
        for _ in range(3):
            a = time.perf_counter()
            for p in pts:
                bp.RistrettoPoint.decompress(p)
            dec.append(1e3 * (time.perf_counter() - a))
        split = _scalars_split(bp, torch, case, backend)
        med = {k: float(np.median([r["wall_ms"] for r in ver[k]]))
               for k in ver}
        print(f"  {name} verify wall median host {med['host']:.1f} ms, "
              f"device {med['device']:.1f} ms, cold tape {med['cold']:.1f} "
              f"ms; DeviceTape build {build}; decompressing {len(pts)} "
              f"points {dec} ms; the device job split {split}", flush=True)
        for k in ver:
            print(f"  {name} {k} verify spans: "
                  f"{json.dumps(ver[k][-1])}", flush=True)
        out[name] = dict(n=n, N=N, terms=T, wires=W, const_terms=tc,
                         constraints=t.m, kernels=kern, verify=ver,
                         verify_median_ms=med, tape_build_ms=build,
                         decompress_ms=dec, decompress_points=len(pts),
                         scalars_split=split)
        backend.evict_gens()
    return out


if __name__ == "__main__":
    sys.exit(main())
