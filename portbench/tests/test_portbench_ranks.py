"""A cell on several cards (ranks.py), on the CPU: gloo groups of 2 and 4
processes at a small N, whose dp mesh keeps the host loop (each
iteration's residual reduced over the ranks by ``Mesh.max``)."""

import io
import json
import multiprocessing
import os
import signal
import threading
import time

import numpy as np
import pytest

from conftest import DP_CELL, REPO, dp_copy
from portbench import faults, harness, ranks
from portbench.check import check_run

NAME = DP_CELL
SEED = 2 ** 31 + 11


def _cell(root):
    return harness.Cell(harness.load_benchmark(root), NAME, root=root,
                        here=root / "portbench")


def _rank(root, rank, world, port, jobs, out):
    """One rank in a spawned process: each job (seed, seconds, fault, the
    ranks it is planted on) measured, gathered and, on rank 0, checked
    and kept in ``out``."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    import torch.distributed as dist

    cell = _cell(root)
    mesh, group, dev = ranks.up(cell, "cpu")
    try:
        for i, (seed, seconds, fault, on) in enumerate(jobs):
            wrap = faults.wrap(fault) if rank in on else None
            run, _, _ = ranks._one(cell, seed, seconds, 0, dev, mesh, group,
                                   time.perf_counter(), wrap=wrap)
            if run is None:
                continue
            correct, attempted, failed = check_run(run)
            np.savez(out / f"{i}.npz", first=run.recorder.first,
                     last=run.recorder.last, setup=run.setup_output)
            (out / f"{i}.json").write_text(json.dumps({
                "correct": correct, "attempted": attempted,
                "checks": {k: v["value"] for k, v in run.checks.items()},
                "calls": run.rank_calls, "batch": run.batch,
                "members": run.recorder.last.shape[0],
                "iteration_counts": run.iteration_counts}))
    finally:
        dist.destroy_process_group()


def _ranks(root, world, jobs, out, timeout=240):
    """``jobs`` on ``world`` spawned ranks; their results, in order."""
    ctx = multiprocessing.get_context("spawn")
    port = ranks._free_port()
    procs = [ctx.Process(target=_rank, args=(root, r, world, port, jobs, out))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
    assert not alive and all(p.exitcode == 0 for p in procs), [
        p.exitcode for p in procs]
    return [(json.loads((out / f"{i}.json").read_text()),
             np.load(out / f"{i}.npz")) for i in range(len(jobs))]


@pytest.mark.parametrize("world", [2, 4])
def test_ranks_equal_one_process_and_make_the_same_calls(tmp_path, world):
    """The members stepped over the ranks are bit-equal to the same
    members stepped in one process, batched (the same arithmetic: each
    member's products and solves alone, the residual's max over all of
    them), and every rank makes the same number of calls."""
    root = dp_copy(tmp_path, world)
    out = tmp_path / "out"
    out.mkdir()
    (one, arrays), (timed, _) = _ranks(
        root, world, [(SEED, 0.0, None, ()), (SEED + 1, 3.0, None, ())], out)
    run, program = harness.measure(_cell(root), SEED, 0.0, 0, device="cpu")
    assert program.mesh is None and program.integrator.mesh is None
    harness.release(program)
    assert one["members"] == run.batch == 16
    for key, mine in (("setup", run.setup_output), ("first",
                                                    run.recorder.first),
                      ("last", run.recorder.last)):
        np.testing.assert_array_equal(arrays[key], mine, err_msg=key)
    assert one["correct"] and one["calls"] == [1] * world
    assert timed["correct"], timed["checks"]
    assert len(set(timed["calls"])) == 1 and timed["calls"][0] > 1


def test_the_check_covers_every_member_and_the_max_over_ranks(tmp_path):
    """On 4 ranks: a sound run is correct; each member's output altered
    on the last rank only, or each rank deciding from its own members
    (the max over the ranks left out: six intervals checked, each
    missing an iteration on some rank, over the limit of 4), or every
    rank's step returning its state unchanged, or half of each rank's
    members left unstepped, is not."""
    root = dp_copy(tmp_path, 4, outputs_per_call=6, check_intervals=5)
    out = tmp_path / "out"
    out.mkdir()
    results = _ranks(root, 4, [(SEED + 2, 0.0, None, ()),
                               (SEED + 3, 0.0, "altered", (3,)),
                               (SEED + 4, 0.0, "local_max", (0, 1, 2, 3)),
                               (SEED + 5, 0.0, "unchanged", (0, 1, 2, 3)),
                               (SEED + 6, 0.0, "half_batch", (0, 1, 2, 3))],
                     out)
    (sound, _), (altered, _), (local, _), (same, _), (half, _) = results
    assert sound["correct"], sound["checks"]
    assert not altered["correct"], altered["checks"]
    assert altered["checks"]["gap_W_start"] > 0.01
    assert not local["correct"], local["checks"]
    assert local["checks"]["iterations"] >= 6
    for broken in (same, half):
        assert not broken["correct"] and broken["checks"]["gap_W_start"] > 0.5


def test_a_killed_rank_ends_the_run_with_no_result(tmp_path):
    """Rank 1 killed once its window is open: the run ends non-zero,
    prints nothing on standard output, and leaves no rank running, well
    before its deadline."""
    root = dp_copy(tmp_path, 2)
    procs, killed = [], threading.Event()

    def on_line(rank, line):
        if rank == 1 and "window open" in line and not killed.is_set():
            killed.set()
            os.kill(procs[1].pid, signal.SIGKILL)

    out, err = io.StringIO(), io.StringIO()
    env = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = str(REPO)
    try:
        t0 = time.monotonic()
        code = ranks.launch(
            ["--workload", NAME, "--seed", str(SEED), "--seconds", "120",
             "--trace", "0"], 2, 90.0, device="cpu", stdout=out, stderr=err,
            on_spawn=procs.extend, on_line=on_line,
            script=root / "portbench" / "ranks.py")
        took = time.monotonic() - t0
    finally:
        if env is None:
            os.environ.pop("PYTHONPATH")
        else:
            os.environ["PYTHONPATH"] = env
    assert killed.is_set(), err.getvalue()
    assert code != 0 and out.getvalue() == ""
    assert took < 60.0, took
    assert all(p.poll() is not None for p in procs)
    assert "rank 1 exited with -9" in err.getvalue()


def test_a_one_card_cell_builds_no_mesh_and_starts_no_process(monkeypatch):
    """harness.main on a one-card cell takes the one-process path: no
    launch, no process group, measure with no mesh."""
    import subprocess

    import torch

    from quflow_tpu_torch.parallel import distributed

    def refuse(*args, **kwargs):
        raise AssertionError("a one-card cell started ranks")

    seen = {}

    class Stop(Exception):
        pass

    def measure(cell, seed, seconds, trace, **kwargs):
        seen.update(cell=cell.name, kwargs=kwargs)
        raise Stop

    for name in ("TRITON_CACHE_DIR", "TORCH_EXTENSIONS_DIR"):
        monkeypatch.delenv(name, raising=False)  # restored afterwards
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(ranks, "launch", refuse)
    monkeypatch.setattr(subprocess, "Popen", refuse)
    monkeypatch.setattr(distributed, "initialize", refuse)
    monkeypatch.setattr(harness, "measure", measure)
    with pytest.raises(Stop):
        harness.main(["--workload", "euler-n1024-c64.ens16", "--seed", "5",
                      "--seconds", "1"])
    assert seen["cell"] == "euler-n1024-c64.ens16"
    assert seen["kwargs"].get("mesh") is None
    assert seen["kwargs"].get("group") is None


def test_a_one_card_cell_asks_for_one_card_and_a_dp_cell_for_its_mesh(
        tmp_path):
    """Every cell of the benchmark, and the tests' cell over four."""
    root = dp_copy(tmp_path, 4)
    bench = harness.load_benchmark(root)
    chips = []
    for w in bench["workloads"]:
        cell = harness.Cell(bench, w["name"], root=root,
                            here=root / "portbench")
        mesh = cell.traffic.get("mesh")
        chips.append(cell.chips)
        if cell.chips == 1:
            assert mesh is None
        else:
            assert mesh["dp"] * mesh.get("tp", 1) == cell.chips
            assert cell.traffic["batch"] % mesh["dp"] == 0
    assert 1 in chips and 4 in chips
