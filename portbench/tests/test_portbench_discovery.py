"""Discovery by name: every cell of BENCHMARK.json finds its
configuration, traffic mix, limits and metric readers, and a new one
needs only new files and new entries."""

import json

import pytest

from conftest import REPO, small_copy
from portbench import harness


def _bench():
    return harness.load_benchmark(REPO)


@pytest.mark.parametrize("name", [w["name"] for w in json.loads(
    (REPO / "BENCHMARK.json").read_text())["workloads"]])
def test_every_cell_is_found(name):
    cell = harness.Cell(_bench(), name)
    assert cell.config["N"] >= 1024
    assert cell.traffic["steps_out"] >= 1
    assert set(cell.limits["gap"]) == set(cell.config["gaps"])
    for spec in cell.end_to_end + cell.per_layer:
        assert callable(cell.reader(spec["name"]))
    names = {m["name"] for m in cell.end_to_end}
    assert {"setup_s", "state_steps_per_s"} <= names
    assert cell.per_layer


def test_unknown_names_are_refused():
    with pytest.raises(harness.CellError):
        harness.Cell(_bench(), "no-such-cell")
    cell = harness.Cell(_bench(), "euler-n1024-c64.single")
    with pytest.raises(harness.CellError):
        cell.reader("no_such_metric")


def test_a_new_configuration_mix_and_metric_are_files(tmp_path):
    """A configuration, a traffic mix, a metric and a cell added as new
    files and new entries, nothing edited, run through discovery and a
    run on the CPU."""
    root = small_copy(tmp_path)
    here = root / "portbench"
    cfg = json.loads((here / "configs" / "euler-n1024-c64.json").read_text())
    cfg["integrator"] = {"class": "IsompTorch", "maxit": 3}
    (here / "configs" / "euler-n16-c64-m3.json").write_text(json.dumps(cfg))
    (here / "traffic" / "pair.json").write_text(json.dumps(
        {"batch": 2, "batched": True, "steps_out": 4, "outputs_per_call": 2,
         "check_intervals": 1}))
    (here / "metrics" / "outputs_in_window.py").write_text(
        "def read(run):\n    return run.recorder.count\n")
    (here / "limits" / "euler-n16-c64-m3.pair.json").write_text(
        json.dumps({"gap": {"W": 1e-3}}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "euler-n16-c64-m3", "source": "https://example.org/x",
        "file": "portbench/configs/euler-n16-c64-m3.json", "reduced": [],
        "why": "a test"})
    bench["workloads"].append({
        "name": "euler-n16-c64-m3.pair", "config": "euler-n16-c64-m3",
        "traffic": "pair", "chips": 1, "why": "a test"})
    bench["per_layer"].append({
        "name": "outputs_in_window", "unit": "outputs", "better": "higher",
        "source": "program_counter", "layer": "driver",
        "moves": "state_steps_per_s", "workloads": ["euler-n16-c64-m3.pair"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = harness.Cell(harness.load_benchmark(root), "euler-n16-c64-m3.pair",
                        root=root, here=here)
    assert cell.traffic["batch"] == 2
    assert [m["name"] for m in cell.per_layer][-1] == "outputs_in_window"
    run, program = harness.measure(cell, 5, 0.2, 0, device="cpu")
    assert program.integrator.maxit == 3
    metrics = harness.read_metrics(cell, run, cell.per_layer)
    assert metrics["outputs_in_window"]["value"] == run.recorder.count
    assert run.recorder.first.shape == (2, 16, 16)


_SCHEME = '''
import torch

from portbench.reference.scheme import Midpoint


class Scheme(Midpoint):
    """Euler's midpoint, written out again{note}."""

    def iterate(self, S, dS, eps):
        Wh = S + dS
        P = eps * self.lap.solve(Wh)
        PW = P @ Wh
        PWc = PW - PW.mH
        return PW @ P + PWc, {scale} * PWc
'''


@pytest.mark.parametrize("scale,correct", [(2.0, True), (0.0, False)])
def test_a_new_reference_scheme_is_a_file(tmp_path, scale, correct):
    """A configuration that names a scheme of its own, added with
    reference/<scheme>.py as a new file: the check follows that file (a
    scheme that does not move the state fails the same run)."""
    from portbench.check import check_run

    root = small_copy(tmp_path)
    here = root / "portbench"
    (here / "reference" / "euler_again.py").write_text(_SCHEME.format(
        note="" if correct else ", with no update", scale=scale))
    cfg = json.loads((here / "configs" / "euler-n1024-c64.json").read_text())
    cfg["scheme"] = "euler_again"
    (here / "configs" / "euler-again.json").write_text(json.dumps(cfg))
    (here / "limits" / "euler-again.single.json").write_text(
        (here / "limits" / "euler-n1024-c64.single.json").read_text())
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "euler-again", "source": "https://example.org/x",
        "file": "portbench/configs/euler-again.json", "reduced": [],
        "why": "a test"})
    bench["workloads"].append({
        "name": "euler-again.single", "config": "euler-again",
        "traffic": "single", "chips": 1, "why": "a test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = harness.Cell(harness.load_benchmark(root), "euler-again.single",
                        root=root, here=here)
    assert type(cell.reference(16, "cpu")).__module__.endswith("euler_again")
    run, program = harness.measure(cell, 9, 0.2, 0, device="cpu")
    harness.release(program)
    assert check_run(run)[0] is correct, run.checks
