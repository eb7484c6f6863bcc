"""The plain reference's judgement of membership proofs.

From the inputs the benchmark drew (the tree's items, each proof's leaf
and the seed of its commitment blindings) it works out again the tree,
its root, the committed values and the Pedersen commitments, and checks
each R1CS proof (the dalek Bulletproofs wire format, one-phase) against
that statement: the Fiat-Shamir transcript is replayed and the whole
verification equation is one multiscalar multiplication on the device,
over the generators it derives itself.  Several proofs share one
multiplication by a random linear combination; when it is not the
identity, each proof is checked alone.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from . import curve
from . import field as fe
from .circuit import Circuit
from .merlin import L, Transcript
from .poseidon import Params, Tree

IDENTITY_BYTES = bytes(32)


class Rejected(Exception):
    pass


def _inv(x: int) -> int:
    return pow(x, L - 2, L)


def parse(raw: bytes) -> dict:
    """The proof's fields; raises Rejected on a malformed encoding."""
    if len(raw) < 1 or (len(raw) - 1) % 32:
        raise Rejected("bad length")
    version, body = raw[0], raw[1:]
    chunks = [body[i:i + 32] for i in range(0, len(body), 32)]
    if version == 0:
        npts = 8
        names = ["A_I1", "A_O1", "S1"]
    elif version == 1:
        npts = 11
        names = ["A_I1", "A_O1", "S1", "A_I2", "A_O2", "S2"]
    else:
        raise Rejected("unknown version")
    names += ["T_1", "T_3", "T_4", "T_5", "T_6"]
    rest = len(chunks) - npts - 3
    if rest < 2 or rest % 2:
        raise Rejected("bad shape")
    out = dict(zip(names, chunks[:npts]))
    for k in ("A_I2", "A_O2", "S2"):
        out.setdefault(k, IDENTITY_BYTES)
    scal = chunks[npts:npts + 3] + chunks[-2:]
    vals = [int.from_bytes(c, "little") for c in scal]
    if any(v >= L for v in vals):
        raise Rejected("non-canonical scalar")
    out["t_x"], out["t_x_blinding"], out["e_blinding"], out["a"], out["b"] = vals
    ipp = chunks[npts + 3:-2]
    out["L"], out["R"] = ipp[0::2], ipp[1::2]
    return out


class Reference:
    """The reference of one configuration on `device`."""

    def __init__(self, config: dict, device):
        ps = config["poseidon"]
        self.p = Params(ps["width"], ps["full_rounds_beginning"],
                        ps["partial_rounds"], ps["full_rounds_end"])
        self.depth = config["depth"]
        self.label = config["transcript_label"].encode()
        self.circuit = Circuit(config["circuit"], self.depth, self.p)
        self.N = 1 << (self.circuit.n - 1).bit_length()
        self.device = torch.device(device)
        self._gens = None

    def tree(self, items: dict) -> Tree:
        return self.circuit.kind.tree(self.depth, items, self.p)

    def generators(self):
        if self._gens is None:
            dev = self.device
            B = curve.from_host([curve.BASEPOINT], dev)[0]
            Bb = curve.hash_to_group(bytes(curve.compress(B[None])[0].tolist()),
                                     dev)
            G = curve.generator_chain(b"G" + (0).to_bytes(4, "little"),
                                      self.N, dev)
            H = curve.generator_chain(b"H" + (0).to_bytes(4, "little"),
                                      self.N, dev)
            self._gens = (B, Bb, G, H)
        return self._gens

    def commitments(self, cases: list[dict], tree: Tree):
        """(num_v, 4, 10) points per case and their encodings: the leaf's
        committed values with blindings from its seed, then the statics."""
        c = self.circuit
        B, Bb, _, _ = self.generators()
        tables = [curve.comb_table(curve.to_host(B[None])[0], self.device),
                  curve.comb_table(curve.to_host(Bb[None])[0], self.device)]
        values, blinds = [], []
        for case in cases:
            vals = c.values(case["key"], case["value"], tree.siblings(case["key"]))
            rng = np.random.RandomState(case["blind_seed"])
            bl = [int.from_bytes(rng.bytes(64), "little") % L for _ in vals]
            values += vals + c.statics()
            blinds += bl + [0] * c.nstat
        pts = curve.fixed_base(tables, [values, blinds])
        enc = curve.compress(pts).cpu().numpy()
        m = c.num_v
        return (pts.reshape(len(cases), m, 4, fe.NLIMBS),
                [[bytes(enc[i * m + j]) for j in range(m)]
                 for i in range(len(cases))])

    def _equation(self, pf: dict, vbytes: list[bytes], root: int, r: int):
        """The proof's verification equation as scalars: (head scalars
        for A_I1 A_O1 S1 T_1 T_3..T_6 L.. R.., V scalars, B, B~, g, h)."""
        c, N = self.circuit, self.N
        t = Transcript(self.label)
        t.append(b"dom-sep", b"r1cs v1")
        for v in vbytes:
            t.append(b"V", v)
        t.append_u64(b"m", len(vbytes))
        for k in ("A_I1", "A_O1", "S1"):
            if pf[k] == IDENTITY_BYTES:
                raise Rejected(f"{k} is the identity")
            t.append(k.encode(), pf[k])
        t.append(b"dom-sep", b"r1cs-1phase")
        for k in ("A_I2", "A_O2", "S2"):
            t.append(k.encode(), pf[k])
        y = t.challenge(b"y")
        z = t.challenge(b"z")
        wL, wR, wO, wV, wc = c.weights(z, root)
        for k in ("T_1", "T_3", "T_4", "T_5", "T_6"):
            if pf[k] == IDENTITY_BYTES:
                raise Rejected(f"{k} is the identity")
            t.append(k.encode(), pf[k])
        u = t.challenge(b"u")
        x = t.challenge(b"x")
        t.append_scalar(b"t_x", pf["t_x"])
        t.append_scalar(b"t_x_blinding", pf["t_x_blinding"])
        t.append_scalar(b"e_blinding", pf["e_blinding"])
        w = t.challenge(b"w")
        lg = len(pf["L"])
        if (1 << lg) != N:
            raise Rejected("inner-product proof of the wrong size")
        t.append(b"dom-sep", b"ipp v1")
        t.append_u64(b"n", N)
        us = []
        for Lj, Rj in zip(pf["L"], pf["R"]):
            if IDENTITY_BYTES in (Lj, Rj):
                raise Rejected("an IPP point is the identity")
            t.append(b"L", Lj)
            t.append(b"R", Rj)
            us.append(t.challenge(b"u"))
        u_inv = [_inv(v) for v in us]
        u_sq = [v * v % L for v in us]
        u_inv_sq = [v * v % L for v in u_inv]
        s = [1]
        for v in u_inv:
            s[0] = s[0] * v % L
        for j in range(lg):
            m = u_sq[lg - 1 - j]
            s += [e * m % L for e in s]
        a, b = pf["a"], pf["b"]
        n = c.n
        y_inv = _inv(y)
        yp = [1] * N
        for i in range(1, N):
            yp[i] = yp[i - 1] * y_inv % L
        delta = sum(yi * wr % L * wl for yi, wr, wl in zip(yp, wR, wL)) % L
        xx = x * x % L
        pad = [0] * (N - n)
        wRp, wLp, wOp = wR + pad, wL + pad, wO + pad
        g = [(x * yi % L * wr - a * si) % L
             for yi, wr, si in zip(yp, wRp, s)]
        h = [(yi * ((x * wl + wo - b * si) % L) - 1) % L
             for yi, wl, wo, si in zip(yp, wLp, wOp, reversed(s))]
        if N > n:  # padding multipliers carry the phase challenge u
            g[n:] = [e * u % L for e in g[n:]]
            h[n:] = [e * u % L for e in h[n:]]
        rxx = r * xx % L
        head = [x, xx, xx * x % L,
                r * x % L, rxx * x % L, rxx * xx % L,
                rxx * xx % L * x % L, rxx * xx % L * xx % L]
        head += u_sq + u_inv_sq
        vsc = [rxx * v % L for v in wV]
        Bs = (w * (pf["t_x"] - a * b) + r * (xx * (wc + delta) - pf["t_x"])) % L
        Bbs = (-pf["e_blinding"] - r * pf["t_x_blinding"]) % L
        return head, vsc, Bs, Bbs, g, h

    def _heads(self, pf: dict):
        names = ["A_I1", "A_O1", "S1", "T_1", "T_3", "T_4", "T_5", "T_6"]
        raw = [pf[k] for k in names] + list(pf["L"]) + list(pf["R"])
        return np.frombuffer(b"".join(raw), dtype=np.uint8).reshape(-1, 32)

    def judge(self, items: dict, cases: list[dict], seed: int) -> dict:
        """Judge each case (key, value, blind_seed, comms, proof bytes):
        returns the number of proofs rejected and of the program's
        commitments that differ from the reference's."""
        rng = np.random.RandomState(seed % (2**32))
        draw = lambda: int.from_bytes(rng.bytes(64), "little") % L  # noqa: E731
        times, t0 = {}, time.perf_counter()
        tree = self.tree(items)
        times["tree_s"] = time.perf_counter() - t0
        self.generators()
        times["generators_s"] = time.perf_counter() - t0 - sum(times.values())
        vpts, vbytes = self.commitments(cases, tree)
        times["commitments_s"] = time.perf_counter() - t0 - sum(times.values())
        differ = 0
        for case, vb in zip(cases, vbytes):
            mine = vb[: len(vb) - self.circuit.nstat]
            theirs = list(case["comms"])
            differ += sum(a != b for a, b in zip(mine, theirs))
            differ += abs(len(mine) - len(theirs))
        eqs, rejected = [], 0
        for i, case in enumerate(cases):
            try:
                pf = parse(case["proof"])
                heads = torch.from_numpy(self._heads(pf).copy()).to(self.device)
                hp, ok = curve.decompress(heads)
                if not bool(ok.all()):
                    raise Rejected("invalid point encoding")
                eqs.append((i, hp, self._equation(pf, vbytes[i], tree.root,
                                                  draw())))
            except Rejected:
                rejected += 1
        times["equations_s"] = time.perf_counter() - t0 - sum(times.values())
        if eqs and not self._holds(eqs, vpts, [draw() for _ in eqs]):
            rejected += sum(not self._holds([e], vpts, [1]) for e in eqs)
        times["msm_s"] = time.perf_counter() - t0 - sum(times.values())
        return {"proofs_rejected": rejected, "commitments_differ": differ,
                "times": times}

    def _holds(self, eqs, vpts, rhos) -> bool:
        """Whether sum_b rho_b * (equation b) is the identity."""
        B, Bb, G, H = self.generators()
        N = self.N
        pts, sc = [], []
        g, h, Bs, Bbs = [0] * N, [0] * N, 0, 0
        for (i, hp, (head, vsc, bs, bbs, gi, hi)), rho in zip(eqs, rhos):
            pts += [hp, vpts[i]]
            sc += [v * rho % L for v in head] + [v * rho % L for v in vsc]
            Bs, Bbs = (Bs + rho * bs) % L, (Bbs + rho * bbs) % L
            g = [(a + rho * b) % L for a, b in zip(g, gi)]
            h = [(a + rho * b) % L for a, b in zip(h, hi)]
        pts += [B[None], Bb[None], G, H]
        sc += [Bs, Bbs] + g + h
        total = curve.msm(torch.cat(pts), sc)
        return curve.h_is_identity(total)
