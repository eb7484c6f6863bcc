"""The general driver: sets the system up, offers one traffic mix for the
window, and hands what the window produced to the judge.

A traffic mix is a data file (``traffic/<name>.json``) whose ``mode``
names its loop, ``traffic/<mode>.py`` (its ``run``), and whose other keys
are the loop's parameters.  The loops share the helpers below.
``check`` proofs of the window, drawn from the seed, go to the plain
reference once the window has closed, the device peak has been read and
the program's state is freed.  ``fault``, for the tests and the control
only, alters what the timed path produces.
"""

from __future__ import annotations

import time

from .inputs import Inputs
from .named import load
from .spans import Spans
from .system import System


class Record:
    """What a run measured; the metric readers read it."""

    def __init__(self, cell: dict, config: dict, traffic: dict):
        self.cell, self.config, self.traffic = cell, config, traffic
        self.spans = Spans()
        self.window = (0.0, 0.0)
        self.setup_s = None
        self.setup_parts: dict = {}
        self.launches: list[int] = []
        self.completions: list[tuple] = []  # (time, thread, proofs)
        self.cpu = None  # (process CPU seconds in the window, cores)
        self.trace = None
        self.shapes: dict = {}
        self.attempted = self.failed = 0
        self.checks: dict = {}
        self.memory_peak_bytes = 0
        self.device_name = "cpu"
        self.reference_parts: dict = {}


def completions_by_worker(rec) -> list[list[float]]:
    """Each stream worker's group completions, in seconds from the
    window's start."""
    by: dict = {}
    for t, thread, _ in sorted(rec.completions):
        by.setdefault(thread, []).append(round(t - rec.window[0], 3))
    return list(by.values())


def step_ms(rec) -> list[list[int]]:
    """The window's prove and verify times, step by step, in ms."""
    pv = [rec.spans.of(n, *rec.window) for n in ("prove", "verify")]
    return [[round(1e3 * (b - a)) for _, a, b, _, _ in spans] for spans in pv
            if spans]


def sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def launch_count() -> int:
    from bulletproofs_r1cs_gadgets_tpu_torch.ops import cuda_curve

    return sum(cuda_curve.LAUNCHES.values())


def anchor() -> float:
    """The host time of a ``bench.anchor`` range in the trace."""
    import torch

    with torch.profiler.record_function("bench.anchor"):
        return time.perf_counter()


def profiler(device):
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def run(cell, config, traffic, seed, seconds, trace, device="cuda",
        fault=None, backend=None) -> Record:
    import torch

    rec = Record(cell, config, traffic)
    if torch.device(device).type == "cuda":
        rec.device_name = torch.cuda.get_device_name(device)
    t_start = time.perf_counter()
    inputs = Inputs(config, seed)
    system = System(config, inputs.items, device, rec.spans, backend)
    rec.setup_parts = dict(system.setup_parts)
    rec.shapes = {"n": system.comp.num_multipliers,
                  "padded": 1 << (system.comp.num_multipliers - 1).bit_length()}
    mode = load("traffic", traffic["mode"])
    judged = mode.run(rec, system, inputs, seconds, trace, device, fault,
                      t_start)
    if torch.device(device).type == "cuda":
        rec.memory_peak_bytes = int(torch.cuda.max_memory_allocated(device))
    system.free()
    del system
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    from .judge import judge

    t0 = time.perf_counter()
    rec.reference_parts = {}
    rec.checks.update(judge(config, inputs, judged, traffic["check"], device,
                            rec.reference_parts))
    rec.reference_parts["total_s"] = time.perf_counter() - t0
    return rec
