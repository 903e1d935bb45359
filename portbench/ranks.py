"""A cell on more than one card: one process a card, on a dp mesh.

``harness.main`` hands a cell whose ``chips`` exceed 1 to :func:`launch`,
which starts this file once a card, with torchrun's environment set by
hand (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``), and watches the ranks.  Each rank:

* brings up NCCL through ``quflow_tpu_torch.parallel.distributed``
  (gloo on the CPU, for the tests) and builds its dp mesh, plus a small
  gloo group of the harness's own;
* runs ``harness.measure`` on its card with its share of the members:
  the ranks meet at a barrier before the window, rank 0 alone decides
  when it ends and tells the others, so every rank makes the same calls;
* frees its program and sends rank 0 its members of the outputs the
  check reads (the same intervals on every rank: the reservoir draws
  from the seed and the count of outputs), its iteration counts and its
  memory peak.

Rank 0 reads the metrics (its own spans, counters and stamps), checks
every member against the reference and prints the result; the other
ranks print nothing to standard output.  A rank that exits with an error
stops the run: :func:`launch` ends the others and exits non-zero with no
result, and so it does when the run outlasts its deadline.

``calibrate.py`` runs its seeds the same way (``--calibrate``)."""

from __future__ import annotations

import argparse
import faulthandler
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import traceback
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

#: seconds a run may take beyond its window: set-up, the profiled call
#: and the check; a first run in a checkout also builds the kernels
ALLOWANCE_S = 330.0
FIRST_BUILD_S = 1150.0


def deadline_s(seconds):
    """How long :func:`launch` lets the ranks of one run take, from its
    start: the contract's 360 s for a run (less what the window asks
    beyond its usual length), 1200 s where the program's kernels are not
    yet built in this checkout."""
    pkg = ROOT / "quflow_tpu_torch"
    built = all(any((pkg / "_build").glob(f"{cu.stem}-*.so"))
                for cu in (pkg / "csrc").glob("*.cu"))
    return (ALLOWANCE_S if built else FIRST_BUILD_S) + max(0.0, seconds - 24)


def run_args(args):
    """The ranks' arguments for one run of ``harness.main``'s ``args``."""
    return ["--workload", args.workload, "--seed", str(args.seed),
            "--seconds", repr(args.seconds), "--trace", str(args.trace)]


def _free_port():
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _relay(stream, rank, keep, out, on_line):
    """Copy a rank's stream line by line: into ``keep`` (rank 0's, said
    at the end), or at once to ``out`` under the rank's name."""
    for line in stream:
        if on_line is not None:
            on_line(rank, line)
        if keep is not None:
            keep.append(line)
        else:
            out.write(f"[rank {rank}] {line}")
            out.flush()
    stream.close()


def _end(procs, late=False):
    """Stop every rank still running, each with its children (a rank is
    the leader of its own session), and wait for each; ``late`` (the
    deadline passed) first has each print its threads' stacks."""
    if late:
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGUSR1)
        time.sleep(3.0)
    for sig, wait in ((signal.SIGTERM, 5.0), (signal.SIGKILL, 5.0)):
        alive = [p for p in procs if p.poll() is None]
        for p in alive:
            try:
                os.killpg(p.pid, sig)
            except ProcessLookupError:
                pass
        for p in alive:
            try:
                p.wait(timeout=wait)
            except subprocess.TimeoutExpired:
                pass


def launch(child_args, chips, deadline, device="cuda", t_start=None,
           stdout=None, stderr=None, on_spawn=None, on_line=None,
           script=HERE / "ranks.py"):
    """Run ``script`` (this file, of the checkout whose cell it runs)
    once a rank, ``chips`` ranks, with ``child_args``; returns the exit
    code.  Rank 0's standard output goes to ``stdout``
    once every rank has ended with 0, after its standard error, which
    comes last on ``stderr`` (the check's numbers are its last lines);
    the other ranks' lines go to ``stderr`` as they come.  A rank that
    ends with another code, or a run still going after ``deadline``
    seconds, ends the rest: non-zero, and nothing on ``stdout``.
    ``on_spawn(procs)`` and ``on_line(rank, line)`` let the tests watch
    and stop a rank."""
    stdout = sys.stdout if stdout is None else stdout
    stderr = sys.stderr if stderr is None else stderr
    t_start = time.perf_counter() if t_start is None else t_start
    t0_wall = time.time() - (time.perf_counter() - t_start)
    port = _free_port()
    out0, err0 = [], []
    procs, threads = [], []
    previous = None
    if threading.current_thread() is threading.main_thread():
        def stop(signum, frame):
            raise SystemExit(128 + signum)
        previous = signal.signal(signal.SIGTERM, stop)
    code, why, late = 1, None, False
    try:
        for rank in range(chips):
            env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(chips),
                       LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(chips),
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                       PORTBENCH_T0=repr(t0_wall))
            p = subprocess.Popen(
                [sys.executable, str(script), *child_args,
                 "--device", device], cwd=os.getcwd(), env=env,
                stdin=subprocess.DEVNULL, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True, start_new_session=True)
            procs.append(p)
            for stream, keep in ((p.stdout, out0), (p.stderr, err0)):
                t = threading.Thread(target=_relay, daemon=True, args=(
                    stream, rank, keep if rank == 0 else None, stderr,
                    on_line))
                t.start()
                threads.append(t)
        if on_spawn is not None:
            on_spawn(procs)
        end = time.monotonic() + deadline
        while True:
            codes = [p.poll() for p in procs]
            bad = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                why = "; ".join(f"rank {r} exited with {c}" for r, c in bad)
                break
            if all(c == 0 for c in codes):
                code = 0
                break
            if time.monotonic() > end:
                why = f"the ranks outlasted the deadline of {deadline:.0f} s"
                late = True
                break
            time.sleep(0.05)
    finally:
        _end(procs, late)
        for t in threads:
            t.join(timeout=10.0)
        if previous is not None:
            signal.signal(signal.SIGTERM, previous)
    if code == 0:
        from .harness import forbidden_modules

        found = forbidden_modules()
        if found:
            why, code = ("modules of the JAX side were loaded: "
                         + ", ".join(found)), 4
    if code != 0:
        stderr.writelines(f"[rank 0 stdout] {line}" for line in out0)
    stderr.writelines(err0)
    if code != 0:
        stderr.write(f"portbench: {why}; no result\n")
    stderr.flush()
    if code == 0:
        stdout.writelines(out0)
        stdout.flush()
    return code


# ---------------------------------------------------------------------------
# a rank
# ---------------------------------------------------------------------------

def gather(run, group):
    """Rank 0's run made whole from every rank's (collective over the
    harness's gloo ``group``): the outputs the check reads with every
    member, in the mesh's order of the members; every rank's iteration
    counts (``rank_iterations``, ``rank_setup_iterations``) and calls;
    the device's memory peak, the fullest card's, and in a traced run its
    busy seconds and traced window, the mean over the cards.  Other ranks
    get None.  Raises where the ranks made different calls or kept
    different intervals."""
    import numpy as np
    import torch
    import torch.distributed as dist

    rec = run.recorder
    sample = sorted(rec.sample, key=lambda x: x[0])
    meta = {"calls": run.calls, "count": rec.count,
            "iterations": rec.iterations,
            "setup_iterations": run.setup_iterations,
            "ks": [k for k, _, _ in sample], "device": run.device}
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    metas = [None] * world
    dist.all_gather_object(metas, meta, group=group)
    for key in ("calls", "count", "ks"):
        if len({json.dumps(m[key]) for m in metas}) != 1:
            raise RuntimeError(f"the ranks differ in {key}: "
                               + ", ".join(str(m[key]) for m in metas))
    arrays = [rec.first, rec.last, run.setup_output] + [
        x for _, start, end in sample for x in (start, end)]
    whole = []
    for a in arrays:
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.float32))
        parts = [torch.empty_like(t) for _ in range(world)] if rank == 0 \
            else None
        dist.gather(t, parts, dst=0, group=group)
        if rank == 0:
            whole.append(np.concatenate([p.numpy() for p in parts]).view(
                a.dtype))
    dist.barrier(group=group)  # every piece is in before a rank ends
    if rank != 0:
        return None
    rec.first, rec.last, run.setup_output = whole[:3]
    rec.sample = [(k, whole[3 + 2 * i], whole[4 + 2 * i])
                  for i, (k, _, _) in enumerate(sample)]
    run.rank_iterations = [m["iterations"] for m in metas]
    run.rank_setup_iterations = [m["setup_iterations"] for m in metas]
    run.rank_calls = [m["calls"] for m in metas]
    devices = [m["device"] for m in metas]
    if run.device:
        run.device["count"] = world
        run.device["memory_peak_bytes"] = max(
            d["memory_peak_bytes"] for d in devices)
        for key in ("busy_s", "window_s"):
            if key in run.device:
                run.device[key] = sum(d[key] for d in devices) / world
    return run


def _parse(argv):
    p = argparse.ArgumentParser(description="one rank of a multi-card cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int)
    p.add_argument("--seeds")
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--calibrate", action="store_true")
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault")
    return p.parse_args(argv)


def _t_start():
    """The run's start on this process's clock: the launcher's, which
    ``PORTBENCH_T0`` holds on the wall clock."""
    t0 = os.environ.get("PORTBENCH_T0")
    now = time.perf_counter()
    return now if t0 is None else now - (time.time() - float(t0))


def up(cell, device):
    """This rank's process group, dp mesh and device, and the harness's
    own gloo group (which moves host values only)."""
    import torch
    import torch.distributed as dist

    from quflow_tpu_torch.parallel import distributed

    distributed.initialize(backend="gloo" if device == "cpu" else "nccl")
    shape = cell.traffic.get("mesh", {})
    dp = int(shape.get("dp", dist.get_world_size()))
    if dp * int(shape.get("tp", 1)) != dist.get_world_size():
        raise ValueError(f"{cell.name}: a mesh of {shape} on "
                         f"{dist.get_world_size()} ranks")
    mesh = distributed.global_mesh(dp=dp)
    group = dist.new_group(backend="gloo")
    dev = (torch.device("cpu") if device == "cpu"
           else torch.device("cuda", torch.cuda.current_device()))
    return mesh, group, dev


def _one(cell, seed, seconds, trace, dev, mesh, group, t_start,
         control=False, wrap=None):
    """One run on this rank: measure, the metrics (rank 0), free the
    program, gather.  Returns (the whole run or None, metrics, the
    breakdown)."""
    from . import harness

    run, program = harness.measure(cell, seed, seconds, trace, device=dev,
                                   control=control, wrap=wrap,
                                   t_start=t_start, mesh=mesh, group=group)
    if mesh.rank == 0:
        print(f"portbench: window of {run.window_s:.3f} s, {run.calls} "
              "calls", file=sys.stderr, flush=True)
    metrics = (harness.read_metrics(cell, run, cell.per_layer if trace
                                    else cell.end_to_end)
               if mesh.rank == 0 else None)
    breakdown = run.profile["breakdown"] if trace and run.profile else None
    harness.release(program)
    del program
    return gather(run, group), metrics, breakdown


def rank_main(argv=None):
    t_start = _t_start()
    faulthandler.register(signal.SIGUSR1, all_threads=True)  # see _end
    args = _parse(argv)
    from . import harness

    cell = harness.Cell(harness.load_benchmark(), args.workload)
    harness._cache_dirs()
    if args.device == "cuda":
        import torch

        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if found < cell.chips:
            print(f"portbench: {cell.name} needs {cell.chips} CUDA "
                  f"devices; found {found}", file=sys.stderr)
            return 3
    mesh, group, dev = up(cell, args.device)
    print(f"portbench: rank {mesh.rank} of {mesh.size} on {dev}",
          file=sys.stderr, flush=True)
    if args.calibrate:
        return _calibrate(cell, args, dev, mesh, group)
    run, metrics, breakdown = _one(cell, args.seed, args.seconds,
                                   args.trace, dev, mesh, group, t_start)
    if run is None:
        return 0
    from .check import check_run, conservation

    print(json.dumps({"conservation": conservation(run)}))
    t_check = time.perf_counter()
    correct, attempted, failed = check_run(run)
    run.stages["check_s"] = time.perf_counter() - t_check
    print(json.dumps({"stages": run.stages, "outputs": run.recorder.count,
                      "rank_calls": run.rank_calls,
                      "iteration_counts": run.iteration_counts}))
    found = harness.forbidden_modules()
    if found:
        print("portbench: modules of the JAX side were loaded: "
              + ", ".join(found), file=sys.stderr)
        return 4
    for name, c in run.checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(harness.result_line(run, correct, attempted, failed,
                                         metrics, breakdown)))
    sys.stdout.flush()
    return 0


def _calibrate(cell, args, dev, mesh, group):
    """calibrate.py's readings, seed by seed, on every rank; rank 0
    prints each seed's line."""
    from .calibrate import reading
    from .faults import wrap

    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        run, _, _ = _one(cell, seed, args.seconds, 0, dev, mesh, group, t0,
                         control=args.control, wrap=wrap(args.fault))
        if run is not None:
            reading(cell, seed, run, t0, args.control, args.fault)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    from portbench.ranks import rank_main as _main  # the package's module

    try:
        _code = _main()
    except BaseException:  # said, and the rank ends: launch ends the rest
        traceback.print_exc()
        _code = 1
    sys.stdout.flush()
    sys.stderr.flush()
    # no teardown of the process groups: NCCL's, whose communicators the
    # captured graphs hold, can hang in it, and a rank's end is the run's
    os._exit(_code)
