"""The control of ``correct``: a cell's run with one guarantee broken in
the timed path, which the judge has to call not correct.

    python3 -m benchmark.control --workload <name> --seeds a,b,c --seconds <s>

runs the cell once per seed in one process on the card, as
``benchmark.run`` does, with every proof of the window altered
(``faults.tamper``: the guarantee that an altered proof is rejected), and
prints each number compared beside its limit.  Exits 0 when every seed's
run reads not correct.
"""

from __future__ import annotations

import argparse
import json
import sys

from . import run as bench


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    cell, config, traffic = bench.cell_parts(bench.load_spec(), args.workload)
    bench.steady()
    import torch

    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 2
    from . import drive
    from .faults import tamper

    caught = True
    for seed in (int(s) for s in args.seeds.split(",")):
        rec = drive.run(cell, config, traffic, seed, args.seconds, False,
                        device="cuda", fault=tamper)
        correct = all(v <= lim for v, lim in rec.checks.values())
        caught &= not correct
        print(json.dumps({"workload": args.workload, "fault": "tamper",
                          "seed": seed, "correct": correct,
                          "attempted": rec.attempted, "checked": {
                              k: {"value": v, "limit": lim}
                              for k, (v, lim) in rec.checks.items()}}),
              flush=True)
    return 0 if caught else 1


if __name__ == "__main__":
    sys.exit(main())
