"""The system under test: the port's prover and verifier for one
configuration, built from the inputs the benchmark drew.

Everything here goes through the port's public API on
``TorchBackend(device, route=Route())`` (the default route, whatever the
environment says); the configuration's circuit kind is
``circuits/<kind>.py``.  The benchmark adds only ``Seam``, a thin wrapper
that times the backend's seam calls.
"""

from __future__ import annotations

import time

import numpy as np

from .named import load
from .spans import Spans


class Seam:
    """Delegates to a backend and records a span around each seam call
    that ends in host data (so the device work inside it is done)."""

    TIMED = ("phase_commitments", "phase_commitments_batch", "ipp_create",
             "ipp_create_batch", "msm_gens")

    def __init__(self, inner, spans: Spans):
        self._inner = inner
        self._spans = spans

    def __getattr__(self, name):
        attr = getattr(self._inner, name)
        if name not in self.TIMED:
            return attr

        def timed(*args, **kwargs):
            with self._spans.span(name):
                return attr(*args, **kwargs)
        return timed


class System:
    def __init__(self, config: dict, items: dict, device: str, spans: Spans,
                 backend=None):
        import bulletproofs_r1cs_gadgets_tpu_torch as bp

        self.bp = bp
        self.config = config
        ps = config["poseidon"]
        self.params = bp.PoseidonParams(
            ps["width"], ps["full_rounds_beginning"], ps["full_rounds_end"],
            ps["partial_rounds"])
        self.kind = load("circuits", config["circuit"])
        self.label = config["transcript_label"].encode()
        t0 = time.perf_counter()
        self.tree = self.kind.tree(bp, self.params, config)
        for k, v in items.items():
            self.tree.update(bp.Scalar(k), bp.Scalar(v))
        t1 = time.perf_counter()
        self.comp = self.kind.compile(bp, self.params, config)
        self.tape = self.comp.tape(self.tree.root)
        t2 = time.perf_counter()
        self.gens = bp.BulletproofGens(config["generators"])
        t3 = time.perf_counter()
        self.pc = bp.PedersenGens.default()
        if backend is None:  # the tests pass a host backend on the CPU
            backend = bp.TorchBackend(device, route=bp.Route())
        self.backend = Seam(backend, spans)
        self.setup_parts = {"tree_s": t1 - t0, "template_s": t2 - t1,
                            "generators_s": t3 - t2}

    def prover(self, key: int, value: int, prover_seed: int, blind_seed: int):
        """A synthesized prover for the leaf `key` and its commitments."""
        bp = self.bp
        path = []
        got = self.tree.get(bp.Scalar(key), path)
        if got.v != value:
            raise ValueError("the tree does not hold this leaf")
        prover = bp.Prover(self.pc, bp.Transcript(self.label),
                           rng=np.random.RandomState(prover_seed))
        comms, wires = self.kind.synthesize(
            bp, self.comp, prover, key, got, path,
            np.random.RandomState(blind_seed))
        prover.load_compiled(self.tape, *wires)
        return prover, comms

    def verify(self, comms, proof) -> bool:
        """The port's verdict on `proof` for these commitments."""
        bp = self.bp
        verifier = bp.Verifier(bp.Transcript(self.label))
        self.comp.commit_verifier(verifier, comms, self.pc)
        verifier.load_compiled(self.tape, self.comp.num_multipliers)
        try:
            verifier.verify(proof, self.pc, self.gens, backend=self.backend)
        except bp.VerificationError:
            return False
        return True

    def free(self) -> None:
        evict = getattr(self.backend._inner, "evict_gens", None)
        if evict is not None:
            evict()
