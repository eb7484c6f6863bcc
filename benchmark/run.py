"""Run one cell of the benchmark once.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell, its configuration and its
traffic mix are found by name through ``BENCHMARK.json``: the
configuration's file, ``benchmark/traffic/<traffic>.json`` (whose
``mode`` names its loop, ``benchmark/traffic/<mode>.py``), the
configuration's circuit kind (``benchmark/circuits/<kind>.py``,
``benchmark/reference/circuits/<kind>.py``) and, for each metric the cell
reports, ``benchmark/metrics/<metric>.py`` (its ``read(rec)`` returns the
value, or None where it finds nothing to read).
With ``--trace 0`` the line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics.  The last line on standard output is
one JSON object; the numbers compared for ``correct`` close standard
error.  A machine without the CUDA devices the cell asks for gets no
result and a non-zero exit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BANNED = ("jax", "jaxlib", "flax", "bulletproofs_r1cs_gadgets_tpu")


def load_spec() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_parts(spec: dict, workload: str):
    """(cell, configuration file's contents, traffic parameters)."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    with open(os.path.join(ROOT, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(HERE, "traffic", cell["traffic"] + ".json")) as f:
        traffic = json.load(f)
    return cell, config, traffic


def metrics_of(spec: dict, cell: dict, trace: bool) -> list[dict]:
    group = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in group
            if "workloads" not in m or cell["name"] in m["workloads"]]


def read_metric(name: str, rec):
    from .named import load

    return load("metrics", name).read(rec)


THREADS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")


def steady() -> None:
    """One process with few threads, its caches inside the checkout.
    Called before torch or numpy loads: the libraries' own thread pools
    keep one thread (the program's host work is Python and its own
    pools), and the generators come from the checkout's cache."""
    for var in THREADS:
        os.environ[var] = "1"
    os.environ["BPTPU_GENS_CACHE"] = os.path.join(ROOT, ".gens_cache")
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch

    torch.set_num_threads(1)


def banned_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    return out.strip().splitlines()[0] if out.strip() else "unknown"


def result(rec, spec, trace: bool, device_name: str, count: int) -> dict:
    metrics, missing = {}, []
    for m in metrics_of(spec, rec.cell, trace):
        value = read_metric(m["name"], rec)
        if value is None:
            if not trace:
                missing.append(m["name"])
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if missing:
        raise RuntimeError(f"end-to-end metrics not measured: {missing}")
    checks = {k: {"value": v, "limit": lim} for k, (v, lim) in rec.checks.items()}
    device = {"platform": "gpu", "kind": device_name, "count": count,
              "memory_peak_bytes": rec.memory_peak_bytes}
    out = {"correct": all(v <= lim for v, lim in rec.checks.values()),
           "attempted": rec.attempted, "failed": rec.failed,
           "metrics": metrics, "device": device}
    if trace and rec.trace is not None:
        device["busy_s"] = rec.trace.busy_s()
        device["window_s"] = rec.trace.window_s
        out["breakdown"] = rec.trace.breakdown()
    out["checked"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = load_spec()
    cell, config, traffic = cell_parts(spec, args.workload)
    steady()
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); this "
              "machine has none to offer", file=sys.stderr)
        return 2
    from . import drive

    rec = drive.run(cell, config, traffic, args.seed, args.seconds,
                    bool(args.trace), device="cuda")
    found = banned_modules()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 3
    out = result(rec, spec, bool(args.trace), torch.cuda.get_device_name(0),
                 cell["chips"])
    print(f"card: {power_limit()}; set-up parts (s): "
          + json.dumps(rec.setup_parts) + "; reference parts (s): "
          + json.dumps(rec.reference_parts), file=sys.stderr)
    if rec.completions:
        print("group completions (s from the window's start, by worker): "
              + json.dumps(drive.completions_by_worker(rec)), file=sys.stderr)
    steps = drive.step_ms(rec)
    if steps:
        print("window steps (ms, prove / verify): " + json.dumps(steps),
              file=sys.stderr)
    for k, c in out["checked"].items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
