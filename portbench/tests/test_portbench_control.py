"""The output check has to fail what it guards against: the program with
its timed path broken underneath by each fault of faults.py that the
cell can have (on the CPU, at a small N), and the control, every
complex64 product on TF32 (on the card, where TF32 exists, at the sizes
the limits were set at)."""

import pytest
import torch

from conftest import REPO
from portbench import harness
from portbench.check import check_run
from portbench.faults import FAULTS, applies

CELLS = ["euler-n1024-c64.single", "mhd-n1024-c64.single",
         "euler-n1024-c64.adaptive", "euler-n1024-c64.ens16"]


def _faults():
    bench = harness.load_benchmark(REPO)
    return [(name, fault) for name in CELLS for fault in sorted(FAULTS)
            if applies(fault, harness.Cell(bench, name).traffic)]


def _check(root, name, seed, device="cpu", seconds=0.2, **kw):
    cell = harness.Cell(harness.load_benchmark(root), name, root=root,
                        here=root / "portbench")
    run, program = harness.measure(cell, seed, seconds, 0, device=device,
                                   **kw)
    harness.release(program)
    return check_run(run), run


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(small, name):
    (correct, attempted, failed), run = _check(small, name, 2 ** 31 + 1)
    assert correct and failed == 0, run.checks


@pytest.mark.parametrize("name,fault", _faults())
def test_a_broken_path_is_not_correct(small, name, fault):
    def wrap(integrator, program):
        return FAULTS[fault](program.default_integrator())

    (correct, attempted, failed), run = _check(small, name, 2 ** 31 + 2,
                                               wrap=wrap)
    assert not correct, run.checks


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct_on_the_card(card, name):
    """The program with every complex64 product on TF32, at the cell's own
    sizes (its limits were set there) with a one-second window, on three
    seeds; the same seeds without it are correct."""
    for seed in (2 ** 31 + 3, 17, 4_000_000_001):
        (correct, _, _), run = _check(REPO, name, seed, device=card,
                                      seconds=1.0)
        assert correct, run.checks
        (correct, _, _), run = _check(REPO, name, seed, device=card,
                                      seconds=1.0, control=True)
        assert not correct, run.checks
        torch.cuda.empty_cache()
