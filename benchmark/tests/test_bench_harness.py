"""The harness driven on the CPU at tiny depths, the chip's look skipped:
every mode judges a sound run correct and a run with a fault planted in
what the timed path produces not correct; the stream's rate holds a
stall against the whole window; and a cell, a configuration of a new
circuit kind, a traffic mix in a new mode and a metric are added by
adding files and entries alone."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import drive, faults, named, run as bench

ROOT = bench.ROOT
SEED = 2**31 + 977


def _parts(workload, depth):
    """The cell ``<config>.<traffic>`` from its files, at a tiny depth."""
    conf, mix = workload.split(".")
    cell = dict(name=workload, config=conf, traffic=mix, chips=1)
    with open(os.path.join(ROOT, "benchmark", "configs", conf + ".json")) as f:
        config = json.load(f)
    with open(os.path.join(ROOT, "benchmark", "traffic", mix + ".json")) as f:
        traffic = json.load(f)
    per = 568 if config["circuit"] == "vsmt2" else 583
    config = dict(config, depth=depth, tree_updates=4,
                  generators=1 << (depth * per - 1).bit_length())
    return cell, config, traffic


def _run(workload, depth, seconds, fault=None, trace=False):
    from bulletproofs_r1cs_gadgets_tpu_torch.ops.native_backend import (
        NativeBackend)

    cell, config, traffic = _parts(workload, depth)
    rec = drive.run(cell, config, traffic, SEED, seconds, trace, device="cpu",
                    fault=fault, backend=NativeBackend())
    return rec, bench.result(rec, bench.load_spec(), trace, "cpu", 1)


@pytest.mark.parametrize("workload,depth,seconds", [
    ("vsmt2-d253.single", 4, 2.0), ("vsmt4-d128.stream", 4, 8.0)])
def test_sound_run_is_correct(workload, depth, seconds):
    rec, out = _run(workload, depth, seconds)
    assert out["correct"], out["checked"]
    assert out["attempted"] > 0 and out["failed"] == 0
    names = {m["name"] for m in bench.metrics_of(bench.load_spec(), rec.cell, False)}
    assert set(out["metrics"]) == names
    assert list(out)[-1] == "checked"
    if rec.traffic["mode"] == "stream":  # its rate's reader, on a whole run
        assert named.load("metrics", "proofs_per_s").read(rec) > 0


@pytest.mark.parametrize("workload,depth,seconds,fault", [
    pytest.param("vsmt2-d253.single", 4, 2.0, lambda: faults.tamper,
                 id="single-tamper"),
    pytest.param("vsmt2-d253.single", 4, 2.0, faults.Stale, id="single-stale"),
    pytest.param("vsmt4-d128.stream", 4, 8.0, lambda: faults.tamper,
                 id="stream-tamper"),
    pytest.param("vsmt4-d128.stream", 4, 8.0, faults.Stale, id="stream-stale"),
    pytest.param("vsmt4-d128.stream", 4, 8.0, lambda: faults.drop_half,
                 id="stream-drop_half"),
])
def test_fault_in_the_timed_path_is_not_correct(workload, depth, seconds, fault):
    _, out = _run(workload, depth, seconds, fault=fault())
    assert not out["correct"], out["checked"]


def _stream_rec(completions, window=(0.0, 51.0)):
    rec = drive.Record({}, {}, {"wave": 4})
    rec.window = window
    rec.completions = [(t, w, 0) for w, ts in completions.items() for t in ts]
    return rec


def test_a_stall_at_the_end_of_the_window_lowers_the_rate():
    rate = named.load("metrics", "proofs_per_s").read
    steady = {1: [-2, 6, 14, 22, 30, 38, 46, 54], 2: [0, 8, 16, 24, 32, 40, 48, 56]}
    stalled = {**steady, 1: [-2, 6, 14, 22, 60]}
    assert rate(_stream_rec(steady)) == pytest.approx(4 * 7 / 56 + 4 * 7 / 56)
    # worker 1 completes nothing from +22 s until +60 s, 9 s past the end
    assert rate(_stream_rec(stalled)) == pytest.approx(4 * 4 / 62 + 4 * 7 / 56)
    # a worker whose last group completed inside and that started no other
    # is held to the whole window all the same
    idle = {**steady, 1: [-2, 6, 14, 22]}
    assert rate(_stream_rec(idle)) == pytest.approx(4 * 3 / 53 + 4 * 7 / 56)


def test_traced_run_reads_its_per_layer_metrics():
    rec, out = _run("vsmt2-d253.single", 4, 2.0, trace=True)
    assert out["correct"]
    for name in ("ipp_ms.prove", "msm_gens_ms.verify", "engine_host_ms.prove"):
        assert out["metrics"][name]["value"] > 0
    # no device on the CPU: the device readings find nothing to read
    assert "device_idle.prove" not in out["metrics"]
    assert "kernel_roofline.prove" not in out["metrics"]


def test_no_cuda_device_means_no_result():
    got = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "vsmt2-d253.single", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert got.returncode != 0 and got.stdout.strip() == ""


NEW_CELL = r'''
import json, sys
from benchmark import drive, run as bench
from bulletproofs_r1cs_gadgets_tpu_torch.ops.native_backend import NativeBackend
spec = bench.load_spec()
cell, config, traffic = bench.cell_parts(spec, "toy-d4.burst")
rec = drive.run(cell, config, traffic, 5, 1.0, True, device="cpu",
                backend=NativeBackend())
print(json.dumps(bench.result(rec, spec, True, "cpu", 1)))
'''


RELAY = """
from benchmark.named import load


def run(rec, *args):
    rec.relayed = True
    return load("traffic", "single").run(rec, *args)
"""


def test_a_cell_is_added_by_files_and_entries_alone(tmp_path):
    """A new configuration of a new circuit kind, a new traffic mix in a
    new mode and a new metric: files and entries, and no file that was
    there changes but BENCHMARK.json's lists."""
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    before = {p: (tmp_path / p).read_bytes()
              for p in ["BENCHMARK.json"] + [
                  os.path.relpath(os.path.join(d, f), tmp_path)
                  for d, _, fs in os.walk(tmp_path / "benchmark") for f in fs]}
    b = tmp_path / "benchmark"
    for side in ("circuits", "reference/circuits"):  # a new circuit kind
        shutil.copy(b / side / "vsmt2.py", b / side / "toykind.py")
    conf = json.loads((b / "configs" / "vsmt2-d253.json").read_text())
    conf.update(name="toy-d4", circuit="toykind", depth=4, tree_updates=3,
                generators=4096)
    (b / "configs" / "toy-d4.json").write_text(json.dumps(conf))
    traffic = json.loads((b / "traffic" / "single.json").read_text())
    traffic.update(mode="relay", provers=2, check=1, traced_steps=1)
    (b / "traffic" / "burst.json").write_text(json.dumps(traffic))
    (b / "traffic" / "relay.py").write_text(RELAY)  # a new mode
    (b / "metrics" / "relayed_steps.py").write_text(
        "def read(rec):\n"
        "    return float(rec.attempted) if getattr(rec, 'relayed', 0) else None\n")
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["configs"].append(dict(name="toy-d4", source="https://example.org/toy",
                                file="benchmark/configs/toy-d4.json",
                                reduced=["depth"], why="a toy"))
    spec["workloads"].append(dict(name="toy-d4.burst", config="toy-d4",
                                  traffic="burst", chips=1, why="a toy"))
    next(m for m in spec["end_to_end"] if m["name"] == "prove_s")[
        "workloads"].append("toy-d4.burst")
    spec["per_layer"].append(dict(name="relayed_steps", unit="steps",
                                  better="higher", source="host_clock",
                                  layer="harness", moves="prove_s",
                                  workloads=["toy-d4.burst"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    got = subprocess.run(
        [sys.executable, "-c", NEW_CELL], cwd=tmp_path, capture_output=True,
        text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=f"{tmp_path}{os.pathsep}{ROOT}"))
    assert got.returncode == 0, got.stderr[-2000:]
    out = json.loads(got.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["metrics"]["relayed_steps"]["value"] >= 1
    for p, data in before.items():  # no file that was there changed but the
        if p != "BENCHMARK.json":   # list of entries
            assert (tmp_path / p).read_bytes() == data, p


@pytest.mark.cuda
@pytest.mark.parametrize("workload,seconds", [
    ("vsmt2-d253.single", 3.0), ("vsmt4-d128.stream", 12.0)])
def test_control_on_the_card_is_not_correct(card, workload, seconds):
    """The control (every proof tampered) through the card's main path at
    depth 4; the full-size control is ``python3 -m benchmark.control``."""
    cell, config, traffic = _parts(workload, 4)
    sound = drive.run(cell, config, traffic, SEED, seconds, False, device=card)
    assert all(v <= lim for v, lim in sound.checks.values()), sound.checks
    bad = drive.run(cell, config, traffic, SEED, seconds, False, device=card,
                    fault=faults.tamper)
    assert not all(v <= lim for v, lim in bad.checks.values()), bad.checks
