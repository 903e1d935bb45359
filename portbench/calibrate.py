"""Readings for the output check's limits, many seeds in one process:

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        --seconds 2 [--control | --fault <name>]

For each seed it sets the cell up, runs a short window at the cell's own
sizes and load, and prints one JSON line with every number the check
compares.  ``--control`` runs the program with every complex64 product
on TF32 (the configuration's or the traffic mix's ``control``), and
``--fault`` with a fault of faults.py planted underneath; the check has
to fail both.  A cell on several cards runs its seeds over one process a
card, as its runs do (ranks.py).  The benchmark's own runs never run
this."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def reading(cell, seed, run, t0, control=False, fault=None):
    """Check ``run``, seed ``seed`` of ``cell`` set up from ``t0`` on, and
    print its line: every number the check compares."""
    from portbench.check import check_run

    t1 = time.perf_counter()
    correct, attempted, failed = check_run(run)
    print(json.dumps({
        "workload": cell.name, "seed": seed, "control": control,
        "fault": fault,
        "correct": correct, "attempted": attempted, "failed": failed,
        "checks": {k: v["value"] for k, v in run.checks.items()},
        "iteration_counts": getattr(run, "iteration_counts", []),
        "iterations_per_step": run.iterations_per_step(),
        "rank_calls": getattr(run, "rank_calls", [run.calls]),
        "run_s": t1 - t0, "check_s": time.perf_counter() - t1,
    }), flush=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault")
    args = p.parse_args(argv)

    from portbench import harness, ranks
    from portbench.faults import wrap

    harness._cache_dirs()
    cell = harness.Cell(harness.load_benchmark(), args.workload)
    if cell.chips > 1:
        seeds = args.seeds.split(",")
        return ranks.launch(
            ["--workload", cell.name, "--seeds", args.seeds, "--seconds",
             repr(args.seconds), "--calibrate"]
            + (["--control"] if args.control else [])
            + (["--fault", args.fault] if args.fault else []),
            cell.chips, ranks.deadline_s(args.seconds) * len(seeds))
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        run, program = harness.measure(cell, seed, args.seconds, 0,
                                       control=args.control,
                                       wrap=wrap(args.fault))
        harness.release(program)
        del program
        reading(cell, seed, run, t0, args.control, args.fault)
    return 0


if __name__ == "__main__":
    sys.exit(main())
