"""chip_smoke.py, the port's check on a CUDA card, rehearsed on the CPU:
without a card it refuses to run and prints no result; its phases run at
small sizes through the plain solves, so that an API change breaks here
and not first on the card."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402
from quflow_tpu_torch import config  # noqa: E402
from quflow_tpu_torch.ops import shear_solve  # noqa: E402
from quflow_tpu_torch.ops.cuda_scan_solve import (  # noqa: E402
    shear_scan,
    shear_scan_reference,
)
from quflow_tpu_torch.ops.cuda_solve import (  # noqa: E402
    shear_thomas,
    shear_thomas_reference,
)
from quflow_tpu_torch.parallel import stepper  # noqa: E402

torch.set_num_threads(1)


def test_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the refusal")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    assert "cuda.is_available() is false" in res.stderr


def test_ptxas_summary():
    log = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z6kernelIfEv' for 'sm_90a'
ptxas info    : Function properties for _Z6kernelIfEv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 59 registers, used 1 barriers
ptxas info    : Compile time = 101.702 ms
"""
    assert chip_smoke.ptxas_summary(log) == (
        "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads | "
        "Used 59 registers, used 1 barriers")


@pytest.fixture
def cpu_rehearsal(monkeypatch):
    """The smoke's phases on the CPU: no CUDA events, graphs or
    synchronize, the default device is the CPU, and the column-solve
    selector hands out each kernel's plain version, counted as if it were
    that kernel's launches (1 ms a kernel call)."""

    def counted(kernel, plain):
        def solve(w, binv, u, d):
            kernel.launches += 1
            return plain(w, binv, u, d)
        return solve

    stand_in = {shear_thomas: counted(shear_thomas, shear_thomas_reference),
                shear_scan: counted(shear_scan, shear_scan_reference)}
    select = shear_solve.column_solver

    def column_solver(solver=None):
        chosen = select(solver)
        return stand_in.get(chosen, chosen)

    # the step builders' selector and the Poisson family's
    monkeypatch.setattr(stepper, "column_solver", column_solver)
    monkeypatch.setattr(shear_solve, "column_solver", column_solver)
    monkeypatch.setattr(chip_smoke, "cuda_ms", lambda fn, reps: (fn(), 0.0)[1])
    monkeypatch.setattr(chip_smoke, "graph_ms", lambda fn, reps: (fn(), 1.0)[1])
    # the card: what the smoke builds without device= lands here
    monkeypatch.setattr(config, "device",
                        lambda dev=None: torch.device("cpu" if dev is None
                                                      else dev))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.delenv("QUFLOW_PALLAS_KERNEL", raising=False)


def test_solve_bound():
    """Bytes bound both tiers: (16 B + 12) N (N+1) bytes for complex64,
    twice that for complex128, at 3.35 TB/s."""
    ms, by = chip_smoke.solve_bound(1024, 1, torch.complex64)
    assert by == "bytes"
    assert ms == pytest.approx(28 * 1024 * 1025 / 3.35e9, rel=1e-12)
    ms, by = chip_smoke.solve_bound(1024, 4, torch.complex128)
    assert by == "bytes"
    assert ms == pytest.approx(2 * 76 * 1024 * 1025 / 3.35e9, rel=1e-12)


def test_phases_rehearse_on_cpu(cpu_rehearsal):
    rows = chip_smoke.kernel_vs_plain("cpu", Ns=(16,), Bs=(1, 2))
    assert len(rows) == 4 and all(r["max_abs_err"] == 0.0 for r in rows)
    for r in rows:
        dtype = getattr(torch, r["dtype"])
        assert (r["bound_ms"], r["bound_by"]) == chip_smoke.solve_bound(
            16, r["B"], dtype)
        assert r["share"] == r["bound_ms"] / r["ms"]
    c64 = chip_smoke.main_path_c64("cpu", N=32, steps=10, steps_out=5,
                                   compare_steps=2)
    assert c64["launches"] == c64["expected_launches"] == 10 * 5 + 3
    assert c64["kernel_vs_plain_10_steps"] == 0.0
    c128 = chip_smoke.main_path_c128("cpu", N=32, steps=20)
    assert c128["tr_W2_drift"] <= 1e-10 and c128["tr_W3_drift"] <= 1e-10
    assert c128["launches"] == {"shear_thomas": 100, "shear_scan": 0}


def test_scan_and_mhd_phases_rehearse_on_cpu(cpu_rehearsal):
    scan = chip_smoke.kernel_vs_plain(
        "cpu", Ns=(16, 40), Bs=(1, 2), kernel=shear_scan,
        plain=shear_scan_reference, against=shear_thomas)
    assert len(scan) == 8 and all(r["max_abs_err"] == 0.0 for r in scan)
    assert all(r["vs_shear_thomas_rel"] <= 1e-5 for r in scan)
    assert all(r["share"] == r["bound_ms"] for r in scan)
    # the defaults are the shapes of phase 3, so phase 6 times the same ones
    defaults = chip_smoke.kernel_vs_plain.__defaults__
    assert defaults[:2] == ((512, 1024, 2048, 4096), (1, 4, 8))
    ragged = chip_smoke.ragged_bit_equal("cpu", shear_scan,
                                         shear_scan_reference, Ns=(1, 7, 40))
    assert [(r["N"], r["B"]) for r in ragged] == [
        (1, 1), (1, 3), (7, 1), (7, 3), (40, 1), (40, 3)] * 2
    assert all(r["max_abs_err"] == 0.0 for r in ragged)
    assert chip_smoke.ragged_bit_equal.__defaults__ == (
        (1, 7, 100, 257, 1000), (1, 3))
    # the Euler path first, as in the smoke
    chip_smoke.main_path_c64("cpu", N=32, steps=2, steps_out=1,
                             compare_steps=1)
    m64 = chip_smoke.mhd_c64("cpu", N=32, steps=10, steps_out=5,
                             compare_steps=2)
    assert m64["integrator_launches"] == {"shear_thomas": 0,
                                          "shear_scan": 10 * 5}
    # the logs' energy solves read the variable at each call, as every
    # Poisson-family solve does
    assert m64["log_launches"] == {"shear_thomas": 0, "shear_scan": 3}
    assert m64["kernel_vs_plain_10_steps"] == 0.0
    assert m64["scan_vs_thomas_10_steps"] <= 1e-5
    assert "QUFLOW_PALLAS_KERNEL" not in chip_smoke.os.environ
    # N=128: at smaller N the five fixed-point iterations leave Theta's
    # Casimirs drifting past the 1e-10 gate (quflow_tpu shows the same)
    m128 = chip_smoke.mhd_c128("cpu", N=128, steps=10)
    assert m128["launches"] == {"shear_thomas": 0, "shear_scan": 50}
    assert m128["tr_Theta2_drift"] <= 1e-10
    big = chip_smoke.mhd_large("cpu", N=24, steps=2)
    assert big["launches"] == {"shear_thomas": 0, "shear_scan": 10}


def test_reference_phases_rehearse_on_cpu(cpu_rehearsal):
    """Phases 10-13 at small N: the launch counts the smoke checks (one a
    fixed-point iteration and one an energy log; the scan alone under the
    variable; one a family solve; one a magmp iteration), the host syncs,
    the gates."""
    ref = chip_smoke.reference_euler("cpu", N=32, steps=10, steps_out=5,
                                     compare_steps=2)
    iterations = round(ref["iterations_per_step"] * 10)
    assert ref["launches"] == ref["expected_launches"] == iterations + 3
    assert ref["syncs"] == iterations
    assert 0.0 < ref["sync_share"] < 1.0
    assert ref["gate_tr_W2_drift"] <= 1e-10 and ref["gate_tr_W3_drift"] <= 1e-10
    assert ref["gate_launches"] == round(ref["gate_iterations_per_step"] * 10
                                         ) + 1
    assert ref["kernel_vs_plain_10_steps"] == 0.0
    qg = chip_smoke.reference_qg("cpu", N=32, steps=5)
    assert qg["launches"] == {"shear_thomas": 0, "shear_scan": round(
        qg["iterations_per_step"] * 5)}
    assert qg["enstrophy_drift"] <= 1e-3 and qg["setup_s"] > 0.0
    assert "QUFLOW_PALLAS_KERNEL" not in chip_smoke.os.environ
    fam = chip_smoke.poisson_family("cpu", N=24)
    assert fam["launches"] == 2 * len(chip_smoke.FAMILIES)
    assert all(r["complex128_rel_err"] <= 1e-12 for r in fam["families"])
    assert all(r["complex64_rel_err"] <= 1e-5 for r in fam["families"])
    assert fam["laplace_round_trip"] <= 1e-10
    mhd = chip_smoke.reference_mhd("cpu", N=24, steps=5)
    assert mhd["launches"] == round(mhd["iterations_per_step"] * 5)
    assert mhd["tr_Theta3_drift"] <= 1e-10


def test_hooks_phases_rehearse_on_cpu(cpu_rehearsal):
    """Phase 14 at small N: the launch counts it checks (maxit + 2 a step
    and one a call with diagnostics; the scan alone under the variable;
    one an adaptive iteration; one a fixed iteration of solve on a
    tensor), the host syncs, the comparisons."""
    hq = chip_smoke.hooked_qg("cpu", N=32, steps=10, steps_out=5,
                              compare_steps=2)
    assert hq["launches"] == hq["expected_launches"] == {
        "shear_thomas": 10 * 7 + 2, "shear_scan": 0}
    assert hq["kernel_vs_plain"] == 0.0
    with chip_smoke.kernel_variable("scan"):
        hs = chip_smoke.hooked_qg("cpu", shear_scan, shear_scan_reference,
                                  N=32, steps=4, steps_out=4,
                                  compare_steps=2)
    assert hs["launches"] == {"shear_thomas": 0, "shear_scan": 4 * 7 + 1}
    assert "QUFLOW_PALLAS_KERNEL" not in chip_smoke.os.environ
    hvr = chip_smoke.hooked_vs_reference("cpu", N=32, steps=4)
    assert hvr["stepper_vs_isomp"] <= 1e-11
    assert hvr["stepper_launches"] == 4 * 7 and hvr["stepper_syncs"] == 20
    # isomp's probe of the Hamiltonian for ``time`` fails before a solve
    assert hvr["isomp_launches"] == 4 * 7
    gate = {}
    chip_smoke.reference_euler("cpu", N=32, steps=10, steps_out=5,
                               compare_steps=2, gate_out=gate)
    ad = chip_smoke.adaptive_euler("cpu", gate, steps_out=5)
    assert ad["launches"] == ad["syncs"] == round(
        ad["iterations_per_step"] * 10)
    assert ad["vs_isomp_gate"] <= 1e-11 and ad["tr_W3_drift"] <= 1e-10
    hm = chip_smoke.hooked_mhd("cpu", N=32, steps=4, compare_steps=2)
    assert hm["launches"] == {"shear_thomas": 0, "shear_scan": 4 * 7}
    assert hm["kernel_vs_plain"] == 0.0
    card = chip_smoke.solve_on_card("cpu", N=32, steps=10, steps_out=5)
    assert card["launches"] == {"shear_thomas": 50, "shear_scan": 0}
    assert not any(card["host_copies"].values())


def test_ensemble_phases_rehearse_on_cpu(cpu_rehearsal, monkeypatch):
    """Phase 15 at small N: launches steps x maxit whatever the ensemble
    size, the members against their own runs, the complex128 drift gate
    on every member, the MHD ensemble's launches of B and of 2 B."""
    monkeypatch.setattr(chip_smoke, "profiled", lambda fn, st, steps=20: {
        "device_ms": 0.5, "shear_thomas_ms": 0.1, "wall_ms_profiled": 1.0})
    out = {}
    ens = chip_smoke.ensemble_euler("cpu", N=24, Bs=(1, 3), steps_out=3,
                                    calls=2, compare_steps=2, out=out)
    assert [r["launches"] for r in ens["by_B"]] == [6 * 5, 6 * 5]
    assert [r["B"] for r in ens["by_B"]] == [1, 3]
    for r in ens["by_B"]:
        assert r["state_steps_per_s"] == pytest.approx(
            r["B"] * r["steps_per_s"])
        assert r["idle_share"] == pytest.approx(
            1 - 0.5 / r["wall_ms_a_step"])
    assert ens["members_vs_own_runs"] <= 1e-5
    assert out["W"].shape == (3, 24, 24) and out["launches"] == 30
    e128 = chip_smoke.ensemble_c128("cpu", N=32, B=2, steps=10, steps_out=5)
    assert e128["launches"] == {"shear_thomas": 50, "shear_scan": 0}
    assert e128["max_tr_W2_drift"] <= 1e-10
    em = chip_smoke.ensemble_mhd("cpu", N=24, B=2, steps=3, compare_steps=2)
    assert em["launches"] == {"shear_thomas": 0, "shear_scan": 3 * 7}
    assert (em["launches_of_B"], em["launches_of_2B"]) == (15, 6)
    assert em["kernel_vs_plain"] == 0.0
    assert "QUFLOW_PALLAS_KERNEL" not in chip_smoke.os.environ
    rows = chip_smoke.kernel_vs_plain("cpu", Ns=(16,), Bs=(16,))
    assert all(r["max_abs_err"] == 0.0 for r in rows)


def test_persistence_phases_rehearse_on_cpu(cpu_rehearsal):
    """Phase 16 at small N: the checkpoint restart bit-equal; a one-rank
    group (gloo here, NCCL on the card) runs phase 15's ensemble on the
    mesh bit-equal, and its adaptive run makes one all_reduce an
    iteration."""
    import torch.distributed as dist

    ckpt = chip_smoke.checkpoint_restart("cpu", N=24, steps=3)
    assert ckpt["bit_equal"]
    assert ckpt["launches"] == {"shear_thomas": 4 * 3 * 5, "shear_scan": 0}
    # phase 15's largest run, as ensemble_euler hands it on: two calls
    W0 = torch.from_numpy(chip_smoke.euler_members(24, 2, np.complex64))
    z = torch.zeros_like(W0)
    fn = stepper.build_step_fn(24, 0.25 * chip_smoke.hbar(24), steps=3,
                               maxit=5, dtype=np.complex64, batched=True,
                               device="cpu")
    chip_smoke.reset_counts()
    st = fn(*fn(W0, z, z))
    ens = dict(W0=W0, W=st[0], launches=shear_thomas.launches, steps_out=3,
               calls=2, maxit=5)
    dp = chip_smoke.nccl_dp("cpu", ens, backend="gloo", tol_steps=2)
    assert not dist.is_initialized()
    assert dp["backend"] == "gloo" and dp["bit_equal_to_phase_15"]
    assert dp["launches"]["shear_thomas"] == 30
    assert dp["all_reduces"] == sum(dp["adaptive_iterations"]) > 0
