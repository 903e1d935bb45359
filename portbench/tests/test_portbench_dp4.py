"""The cell euler-n1024-c64.dp4 as committed (its traffic mix dp4.json and
its limits), on a small copy over four gloo ranks on the CPU, where the
dp mesh keeps the host loop: a sound run compares with the reference and
passes; each rank deciding from its own members alone (the fault
``local_max``) fails the check.  The four ranks start once for both
runs.

The copy is at N=64, not the other tests' N=16: at N=16 every member's
residual after each iteration lies far from the mix's tol 1e-5 (three
iterations a step on every rank and on the whole batch alike), so no
rank's own maximum decides otherwise than the max over all 16 and the
fault cannot show; at N=64 three of the four ranks alone stop a step an
iteration early in every output interval."""

import json
import multiprocessing
import os
import time

from conftest import small_copy
from portbench import faults, harness, ranks
from portbench.check import check_run

NAME = "euler-n1024-c64.dp4"
#: the configurations' N in the copy (see the module's note)
N = 64
SEED = 2 ** 31 + 25
WORLD = 4


def _cell(root):
    return harness.Cell(harness.load_benchmark(root), NAME, root=root,
                        here=root / "portbench")


def _rank(root, rank, port, jobs, out):
    """One rank: each job (seed, fault) measured with no window beyond
    the first call, gathered, and on rank 0 checked into ``out``."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(WORLD),
                      LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    cell = _cell(root)
    mesh, group, dev = ranks.up(cell, "cpu")
    try:
        for i, (seed, fault) in enumerate(jobs):
            run, _, _ = ranks._one(cell, seed, 0.0, 0, dev, mesh, group,
                                   time.perf_counter(),
                                   wrap=faults.wrap(fault))
            if run is None:
                continue
            correct, attempted, _ = check_run(run)
            (out / f"{i}.json").write_text(json.dumps({
                "correct": correct, "attempted": attempted,
                "checks": {k: v["value"] for k, v in run.checks.items()},
                "limits": {k: v["limit"] for k, v in run.checks.items()},
                "members": run.recorder.last.shape[0],
                "calls": run.rank_calls,
                "iteration_counts": run.iteration_counts}))
    finally:
        dist.destroy_process_group()


def test_dp4_as_committed_passes_and_local_max_fails(tmp_path):
    root = small_copy(tmp_path, N=N)
    cell = _cell(root)
    assert cell.chips == WORLD and cell.traffic["mesh"] == {"dp": 4, "tp": 1}
    assert faults.applies("local_max", cell.traffic)
    out = tmp_path / "out"
    out.mkdir()
    jobs = [(SEED, None), (SEED + 1, "local_max")]
    ctx = multiprocessing.get_context("spawn")
    port = ranks._free_port()
    procs = [ctx.Process(target=_rank, args=(root, r, port, jobs, out))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(120)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
    assert not alive and all(p.exitcode == 0 for p in procs), [
        p.exitcode for p in procs]
    sound, local = (json.loads((out / f"{i}.json").read_text())
                    for i in range(len(jobs)))
    assert sound["members"] == 16 and sound["calls"] == [1] * WORLD
    assert sound["correct"] and sound["attempted"] == 10, sound["checks"]
    assert sound["checks"]["iterations"] == 0
    assert sound["limits"] == {"gap_W_start": 1e-3, "gap_W_window": 1e-3,
                               "iterations": 2}, sound["limits"]
    assert not local["correct"], local["checks"]
    assert local["checks"]["iterations"] > local["limits"]["iterations"]
