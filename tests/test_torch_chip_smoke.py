"""chip_smoke.py, the port's check on a CUDA card, rehearsed on the CPU:
without a card it refuses to run and prints no result; its phases run at
small sizes through the plain solves, so that an API change breaks here
and not first on the card."""

import json
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
from quflow_tpu_torch.ops.cuda_row_solve import (  # noqa: E402
    row_thomas,
    row_thomas_reference,
)
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
    that kernel's launches (a real rhs as its real-lane entry's), and the
    row layouts' solve ``row_thomas``'s (1 ms a kernel call)."""

    def counted(kernel, plain):
        def solve(w, binv, u, d):
            if d.is_complex():
                kernel.launches += 1
            else:
                kernel.real_launches += 1
            return plain(w, binv, u, d)
        return solve

    def counted_rows(w, binv, u, d):
        row_thomas.launches += 1
        return row_thomas_reference(w, binv, u, d)

    monkeypatch.setattr(stepper, "row_thomas", counted_rows)

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
    ens = dict(W0=W0, W=st[0], launches=shear_thomas.launches,
               gemm_launches=chip_smoke.read_gemm(), steps_out=3, calls=2,
               maxit=5)
    dp = chip_smoke.nccl_dp("cpu", ens, backend="gloo", tol_steps=2)
    assert not dist.is_initialized()
    assert dp["backend"] == "gloo" and dp["bit_equal_to_phase_15"]
    assert dp["launches"]["shear_thomas"] == 30
    # the CPU's 'highest' is torch.matmul: the kernel never runs
    assert dp["launches"]["cgemm"] == 0
    assert all(r["counts"]["cgemm"] == 0 for r in dp["adaptive"].values())
    assert dp["all_reduces"] == sum(dp["adaptive_iterations"]) > 0


def test_dp_adaptive_rehearses_the_device_loop_on_cpu(cpu_rehearsal,
                                                      monkeypatch):
    """Phase 16b's adaptive run on a one-rank gloo group with the capture
    rule read as on a card and the composite emulated: the runner takes
    the device loop with the mesh's reduce, bit-equal to the run off the
    mesh with the same counts, one host read a call and one all_reduce an
    iteration."""
    import torch.distributed as dist

    from quflow_tpu_torch.parallel import capture
    from quflow_tpu_torch.parallel.distributed import global_mesh, initialize

    monkeypatch.setattr(capture, "available",
                        lambda device: not config.is_eager())
    assert initialize(init_method=f"tcp://localhost:{chip_smoke.free_port()}",
                      world_size=1, rank=0, backend="gloo")
    try:
        W0 = torch.from_numpy(chip_smoke.euler_members(24, 2, np.complex64))
        with capture.emulation():
            out = chip_smoke.dp_adaptive("cpu", global_mesh(),
                                         stepper.build_step_fn, W0, steps=2)
    finally:
        dist.destroy_process_group()
    assert out["bit_equal_off_mesh"] and out["host_reads"] == 1
    assert out["counts"]["all_reduces"] == sum(out["iterations"]) > 0


def test_split_kernels_carry_the_contract_keys():
    """The kernels line's rows of the split pass's two entries: every key
    the contract names, launches from phase 16b's first adaptive run."""
    runs = {"euler": {"counts": {"loop_pass_key": 17, "loop_decide": 17}},
            "mhd": {"counts": {"loop_pass_key": 9, "loop_decide": 9}}}
    row = dict(ms=0.1, plain_ms=1.0, bound_ms=0.05, bound_by="bytes",
               share=0.5, max_abs_err=0.0)
    split = [dict(row, entry="loop_pass_key", name="a", library_ms=0.2,
                  max_rel_err_rn=1e-7),
             dict(row, entry="loop_pass_key", name="b", library_ms=0.3,
                  max_rel_err_rn=2e-7),
             dict(row, entry="loop_decide", name="r", library_ms=None)]
    rows = chip_smoke.split_kernels({"adaptive": runs}, split)
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    assert [r["name"] for r in rows] == ["loop_pass_key", "loop_decide"]
    for r in rows:
        assert keys <= set(r) and r["route"] == "cuda"
        assert (ROOT / r["source"]).is_file()
        assert r["launches"] == 17
    assert rows[0]["max_rel_err_rn"] == 2e-7 and rows[1]["library_ms"] is None
    json.dumps(rows)


class _GemmSpy(torch.overrides.TorchFunctionMode):
    """Counts the products a call makes, by the state of cuBLAS's TF32
    flag at each: the CPU's stand-in for the profiler's kernel names."""

    def __init__(self):
        super().__init__()
        self.flags = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in (torch.matmul, torch.Tensor.__matmul__):
            self.flags.append(torch.backends.cuda.matmul.allow_tf32)
        return func(*args, **(kwargs or {}))


def _fake_kernel_table(fn, steps):
    """kernel_table on the CPU: the products of one call of ``fn`` as two
    'kernels', one for each state of the TF32 flag."""
    spy = _GemmSpy()
    with spy:
        fn()
    n_tf32 = sum(spy.flags)
    n_full = len(spy.flags) - n_tf32
    return ({"gemm_full": (n_full / steps, 0.1 * n_full / steps),
             "gemm_tf32": (n_tf32 / steps, 0.05 * n_tf32 / steps),
             "shear_thomas_kernel": (5.0, 0.01)}, 1.0)


@pytest.fixture
def gemm_rehearsal(cpu_rehearsal, monkeypatch):
    monkeypatch.setattr(chip_smoke, "kernel_table", _fake_kernel_table)
    monkeypatch.setattr(chip_smoke, "gemm_kernels",
                        lambda device, shape: ({"gemm_full"}, {"gemm_tf32"}))


def test_gemm_split():
    """The kernels of a profile told apart: by the probes' names first,
    then by cuBLAS's naming (tensorop/tf32 against ffma)."""
    table = {
        "sm80_xmma_gemm_cf32cf32_f32f32_cf32_nn_n_tilesize64x64x8_ffma":
            (4.0, 1.0),
        "cutlass_80_tensorop_c1688gemm_64x64_16x4_nn_align1": (6.0, 0.5),
        "probe_full_kernel": (1.0, 0.1),
        "shear_thomas_kernel<float, 64, 4>": (5.0, 0.2)}
    full, tf32 = chip_smoke.gemm_split(table, {"probe_full_kernel"}, set())
    assert full == {table_key: table[table_key][0] for table_key in (
        "sm80_xmma_gemm_cf32cf32_f32f32_cf32_nn_n_tilesize64x64x8_ffma",
        "probe_full_kernel")}
    assert tf32 == {"cutlass_80_tensorop_c1688gemm_64x64_16x4_nn_align1": 6.0}
    assert chip_smoke.gemm_counts(table, {"probe_full_kernel"}, set()) == (
        5.0, 6.0, 1.6)


def test_gemm_split_counts_the_port_product_full():
    """The port's 'highest' complex64 product (csrc/cgemm_tf32x3.cu, TF32
    in its name) is one full-precision GEMM a launch; its split pass is a
    part of it, no GEMM of its own."""
    table = {
        "void (anonymous namespace)::cgemm_tf32x3_kernel(Product)": (4.0, 0.3),
        "(anonymous namespace)::cgemm_tf32x3_split_kernel(Operand, Operand":
            (4.0, 0.07),
        "cutlass_80_tensorop_c1688gemm_64x64_16x4_nn_align1": (6.0, 0.5)}
    full, tf32 = chip_smoke.gemm_split(table, set(), set())
    assert full == {"void (anonymous namespace)::cgemm_tf32x3_kernel(Product)":
                    4.0}
    assert tf32 == {"cutlass_80_tensorop_c1688gemm_64x64_16x4_nn_align1": 6.0}
    assert chip_smoke.gemm_counts(table, set(), set()) == (4.0, 6.0, 0.8)


def test_phase_list_names_26():
    doc = chip_smoke.__doc__
    assert "\n26. the 'highest' complex64 product" in doc
    assert "csrc/cgemm_tf32x3.cu" in doc


def test_cgemm_phase_rehearses_on_cpu():
    """Phase 26's check at small shapes: on the CPU the wrapper hands every
    product to the plain version, so the kernel's column reads 0, and both
    errors against float64 are float32-sized."""
    shapes = (("N100", (100, 100), (100, 100)),
              ("ragged", (37, 100), (100, 51)))
    rows = chip_smoke.cgemm_vs_plain("cpu", shapes=shapes)
    assert [r["name"] for r in rows] == ["N100", "ragged",
                                         "mhd_theta_strided",
                                         "mhd_P_broadcast"]
    for r in rows:
        assert r["max_abs_err"] == 0.0
        assert max(r["errors"] + r["library_errors"]) < 1e-6
    json.dumps(rows)


def test_gemm_counts_rehearse_on_cpu(cpu_rehearsal, monkeypatch):
    """The paths that read the 'highest' complex64 product's launches from
    their own runs (phases 4, 7, 14a, 15a, 15d) at small N, with the
    product routed as on a card: each launch counted, 2 (Euler) or 4 (MHD)
    an iteration at 'highest', none in the warm prefix; and none on the
    CPU's own route."""
    c64 = chip_smoke.main_path_c64("cpu", N=24, steps=4, steps_out=2,
                                   compare_steps=1)
    assert c64["gemm_launches"] == 0

    def counted(a, b):
        chip_smoke.cgemm.cgemm.launches += 1
        return torch.matmul(a, b)

    monkeypatch.setattr(stepper, "_highest_c64", counted)
    monkeypatch.setattr(chip_smoke, "on_card", lambda device: True)
    monkeypatch.setattr(chip_smoke, "profiled", lambda fn, st, steps=20: {
        "device_ms": 0.5, "shear_thomas_ms": 0.1, "wall_ms_profiled": 1.0})
    c64 = chip_smoke.main_path_c64("cpu", N=24, steps=4, steps_out=2,
                                   compare_steps=1)
    assert c64["gemm_launches"] == 2 * 2 * 4  # warm 'high': 2 of 5 full
    m64 = chip_smoke.mhd_c64("cpu", N=24, steps=4, steps_out=2,
                             compare_steps=1)
    assert m64["integrator_gemm_launches"] == 4 * 2 * 4
    full = chip_smoke.mhd_c64("cpu", N=24, steps=4, steps_out=2,
                              compare_steps=1, warm_precision=None)
    assert full["integrator_gemm_launches"] == 4 * 5 * 4
    hq = chip_smoke.hooked_qg("cpu", N=24, steps=4, steps_out=2,
                              compare_steps=1)
    assert hq["gemm_launches"] == 2 * 5 * 4
    ens = chip_smoke.ensemble_euler("cpu", N=24, Bs=(1, 3), steps_out=2,
                                    calls=2, compare_steps=1)
    assert [r["gemm_launches"] for r in ens["by_B"]] == [2 * 5 * 4] * 2
    em = chip_smoke.ensemble_mhd("cpu", N=24, B=2, steps=3, compare_steps=1)
    assert em["gemm_launches"] == 4 * 5 * 3
    # a count the path does not make is caught
    with pytest.raises(AssertionError, match="cgemm: 2 launches"):
        chip_smoke.check_gemm("cuda", 2, 4, 1)


def test_warm_phases_rehearse_on_cpu(gemm_rehearsal):
    """Phase 17 at small N: maxit launches a step with and without the
    warm schedule, 6 warm-precision (TF32 on the card) and 4 full GEMMs a
    step against 10, the c64 gates, the ensemble in turns, phase 7 without
    the warm schedule, the karatsuba products, the adaptive counts without
    the warm prefix."""
    we = chip_smoke.warm_euler("cpu", N=24, steps=20, chunk=10)
    assert we["warm"]["warm_precision"] == "high"
    assert we["full"]["warm_precision"] is None
    assert we["warm"]["launches"] == we["full"]["launches"] == 100
    assert (we["warm"]["gemms_a_step_full"],
            we["warm"]["gemms_a_step_tf32"]) == (4, 6)
    assert (we["full"]["gemms_a_step_full"],
            we["full"]["gemms_a_step_tf32"]) == (10, 0)
    # every name is a full float32 product on the CPU
    assert we["max_trajectory_deviation"] == 0.0
    assert we["warm"]["enstrophy_drift"] <= 1e-4
    ens = chip_smoke.warm_ensemble("cpu", N=24, B=3, steps_out=3, calls=2)
    assert ens["launches"] == {"full": 30, "warm": 30}
    assert len(ens["warm"]["state_steps_per_s"]) == 2
    assert ens["warm"]["gemms_a_step_tf32"] == 6
    assert ens["full"]["gemms_a_step_tf32"] == 0
    assert ens["warm_vs_full_after_one_call"] == 0.0
    m64 = chip_smoke.mhd_c64("cpu", N=32, steps=10, steps_out=5,
                             compare_steps=2)
    assert m64["warm_precision"] == "high"
    wm = chip_smoke.warm_mhd("cpu", m64, N=32, steps=10, steps_out=5,
                             compare_steps=2)
    assert wm["full"]["warm_precision"] is None
    assert wm["full"]["energy_drift"] <= 1e-4
    assert wm["full"]["integrator_launches"]["shear_scan"] == 50
    kara = chip_smoke.karatsuba_euler("cpu", N=24, steps=6)
    assert kara["highest_karatsuba"]["launches"] == 30
    assert 0.0 < kara["karatsuba_vs_highest"] <= 1e-5
    aw = chip_smoke.adaptive_warm("cpu", N=24, steps=4)
    assert aw["warm"]["launches"] == 4 * 2 + sum(aw["warm"]["counts"])
    assert aw["full"]["launches"] == sum(aw["full"]["counts"])
    assert "QUFLOW_PALLAS_KERNEL" not in chip_smoke.os.environ


def test_slice_modules_phases_rehearse_on_cpu(cpu_rehearsal):
    """Phase 18 at small sizes: the device maps against the host ones, the
    device SHT against the host transform, the native solve against
    solve_poisson with one launch."""
    maps = chip_smoke.device_maps("cpu", N=64, lmaxes=(5, 16))
    assert [r["lmax"] for r in maps] == [5, 16]
    assert all(r["shr2mat_rel_err"] <= 1e-12 and r["round_trip_rel_err"]
               <= 1e-12 for r in maps)
    sht = chip_smoke.device_sht("cpu", L=16)
    assert sht["float64"]["round_trip_rel_err"] <= 1e-10
    assert sht["float32"]["synthesis_rel_err"] <= 1e-5
    from quflow_tpu_torch import native

    if not native.available():
        pytest.skip("no C++ toolchain for the native phase")
    nat = chip_smoke.native_poisson("cpu", N=32)
    assert nat["launches"] == {"shear_thomas": 1, "shear_scan": 0}
    assert nat["max_abs_err"] <= 1e-13 * 32


def test_block_phase_rehearses_on_cpu(cpu_rehearsal):
    """Phase 19a at small N: every (dtype, N, B, tp) bit-equal to the plain
    version and within the gates of the unsharded solve; the timed rows at
    their (N, tp, B), both dtypes, an N outside the checked ones and a
    batch among them, each phase bit-equal and timed alone, with the bound
    and the three-launch floor of one rank's rows; the defaults are the
    card's shapes."""
    rows, times = chip_smoke.block_sweeps(
        "cpu", Ns=(16, 24), Bs=(1, 2), tps=(2, 3, 4),
        timed=((24, 4, 1), (16, 2, 2), (40, 4, 1)))
    assert len(rows) == 2 * 2 * 2 * 3
    assert all(r["max_abs_err"] == 0.0 for r in rows)
    for r in rows:
        if r["dtype"] == "complex128":
            assert r["vs_shear_thomas_rel"] <= chip_smoke.BLOCK_GATE_C128
            assert "vs_f64_rel" not in r
        else:
            assert r["vs_f64_rel"] <= max(1e-6, chip_smoke.BLOCK_ACCURACY_C64
                                          * r["shear_thomas_vs_f64_rel"])
            assert r["vs_shear_thomas_rel_m0"] <= 1e-6
    assert [(t["dtype"], t["N"], t["tp"], t["B"], t["rows"])
            for t in times] == [
        (dt, N, tp, B, R) for dt in ("complex64", "complex128")
        for N, tp, B, R in ((24, 4, 1, 6), (16, 2, 2, 8), (40, 4, 1, 10))]
    for t in times:
        dtype = getattr(torch, t["dtype"])
        assert t["max_abs_err"] == 0.0 and t["geometry"] is None
        assert (t["bound_ms"], t["bound_by"]) == chip_smoke.solve_bound(
            t["N"], t["B"], dtype, rows=t["rows"])
        assert t["share"] == t["bound_ms"] / t["ms"]
        assert set(t["phase_ms"]) == set(t["phase_floor_ms"]) == {
            "summary", "forward", "backward"}
        assert t["floor_ms"] == pytest.approx(sum(t["phase_floor_ms"].values()),
                                              rel=1e-12)
        assert t["floor_share"] == t["floor_ms"] / t["ms"]
    assert chip_smoke.block_sweeps.__defaults__[:3] == (
        (512, 1024, 4096), (1, 4), (2, 3, 4))
    assert chip_smoke.BLOCK_TIMED == ((1024, 2, 1), (4096, 4, 1),
                                      (1024, 2, 4), (8192, 4, 1))
    # (16 B + 12) R (N+1) bytes at 3.35 TB/s, twice that in complex128
    ms, by = chip_smoke.solve_bound(4096, 1, torch.complex64, rows=1024)
    assert by == "bytes"
    assert ms == pytest.approx(28 * 1024 * 4097 / 3.35e9, rel=1e-12)
    # the floor of three launches: 12 + 28 + 24 = 64 B an element at
    # complex64, B=1; (40 B + 24) in general, twice that in complex128
    phase, floor = chip_smoke.block_floor(1024, 1, torch.complex64, 512)
    assert phase["summary"] == pytest.approx(12 * 512 * 1025 / 3.35e9,
                                             rel=1e-12)
    assert phase["forward"] == pytest.approx(28 * 512 * 1025 / 3.35e9,
                                             rel=1e-12)
    assert floor == pytest.approx(64 * 512 * 1025 / 3.35e9, rel=1e-12)
    _, floor = chip_smoke.block_floor(1024, 4, torch.complex128, 512)
    assert floor == pytest.approx(2 * 184 * 512 * 1025 / 3.35e9, rel=1e-12)


def test_tp_phase_that_did_not_run_fails_the_run():
    """main()'s gate after phase 19b: a run where every backend refused
    the two ranks raises, naming the refusals; a run that ran passes."""
    refused = {"ran": False, "refusals": {"nccl": "invalid usage",
                                          "gloo": "timed out after 300 s"}}
    with pytest.raises(AssertionError, match="did not run.*nccl: invalid "
                                             "usage; gloo: timed out"):
        chip_smoke.check_tp_ran(refused)
    chip_smoke.check_tp_ran({"ran": True, "backend": "gloo",
                             "refusals": {"nccl": "invalid usage"}})


def test_tp_phase_rehearses_on_cpu(cpu_rehearsal):
    """Phase 19b at small N on the CPU: the two ranks run this script
    with --tp-rank; NCCL (absent here) is refused at set-up and named,
    gloo runs; the launches and gathers of each rank and the tp run
    against one rank."""
    tp = chip_smoke.tp_mhd("cpu", N=16, steps=2, timeout=120)
    assert tp["ran"] and tp["backend"] == "gloo"
    assert set(tp["refusals"]) == {"nccl"} and tp["refusals"]["nccl"]
    for name, gathers in (("complex64", 6), ("complex128", 4)):
        run = tp[name]
        assert run["launches_by_rank"] == [{"shear_thomas": 0,
                                            "shear_scan": 0,
                                            "shear_block": 3 * 2 * 5}] * 2
        assert run["gathers_by_rank"] == [gathers * 2 * 5] * 2
        assert run["vs_one_rank"] <= chip_smoke.TP_TOL[name]
        assert run["tolerance"] == max(chip_smoke.TP_TOL[name],
                                       3 * run["scan_vs_thomas"])
    refused = chip_smoke.tp_mhd("cpu", N=16, steps=2, backends=("nccl",),
                                timeout=120)
    assert not refused["ran"] and set(refused["refusals"]) == {"nccl"}


def _dtype_kernel_table(fn, steps):
    """kernel_table on the CPU: the products of one call of ``fn`` as one
    'kernel' for each complex dtype."""
    counts = {torch.complex64: 0, torch.complex128: 0}

    class Spy(torch.overrides.TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func in (torch.matmul, torch.Tensor.__matmul__):
                counts[args[0].dtype] += 1
            return func(*args, **(kwargs or {}))

    with Spy():
        fn()
    return ({"gemm_c64": (counts[torch.complex64] / steps, 0.1),
             "gemm_c128": (counts[torch.complex128] / steps, 0.2),
             "shear_thomas_kernel": (5.0, 0.3)}, 1.0)


def test_dw_phase_rehearses_on_cpu(cpu_rehearsal, monkeypatch):
    """Phase 20 at small N: the drift gates, one launch an iteration, the
    GEMMs a step by dtype (6 + 4 for Euler, 12 + 8 launches for MHD), the
    steppers in turns."""
    monkeypatch.setattr(chip_smoke, "kernel_table", _dtype_kernel_table)
    monkeypatch.setattr(chip_smoke, "product_kernels",
                        lambda device, shapes, dtype: {
                            torch.complex64: {"gemm_c64"},
                            torch.complex128: {"gemm_c128"}}[dtype])
    dw = chip_smoke.dw_steppers("cpu", N=128, steps=4, mhd_steps=2, chunk=2)
    assert dw["euler"]["launches"] == 4 * 5 and dw["mhd"]["launches"] == 10
    assert (dw["euler"]["cgemm_kernels_a_step"],
            dw["euler"]["zgemm_kernels_a_step"]) == (6, 4)
    assert (dw["mhd"]["cgemm_kernels_a_step"],
            dw["mhd"]["zgemm_kernels_a_step"]) == (12, 8)
    assert dw["mhd"]["products_a_step"] == 30
    assert max(dw["euler"]["casimir_drift"] + dw["mhd"]["casimir_drift"]) \
        <= 1e-10
    assert [len(v) for v in dw["turns_steps_per_s"].values()] == [2, 2]
    assert chip_smoke.dw_steppers.__defaults__[:4] == (512, 200, 50, 5)


def test_dw_phase_profiles_again_when_kernels_are_lost(cpu_rehearsal,
                                                      monkeypatch):
    """Phase 20 counts GEMMs only from a profile that holds every
    ``shear_thomas`` launch: a profile that lost the window's first kernels
    is taken again, and a GEMM count short on a whole profile still
    fails."""
    tables = []

    def lossy(fn, steps):
        table, wall = _dtype_kernel_table(fn, steps)
        tables.append(table)
        if len(tables) % 2:        # every other profile lost two kernels
            table = dict(table, gemm_c64=(table["gemm_c64"][0] - 0.5, 0.1),
                         shear_thomas_kernel=(4.5, 0.3))
        return table, wall

    monkeypatch.setattr(chip_smoke, "kernel_table", lossy)
    monkeypatch.setattr(chip_smoke, "product_kernels",
                        lambda device, shapes, dtype: {
                            torch.complex64: {"gemm_c64"},
                            torch.complex128: {"gemm_c128"}}[dtype])
    dw = chip_smoke.dw_steppers("cpu", N=128, steps=2, mhd_steps=2, chunk=2)
    assert len(tables) == 4
    assert (dw["euler"]["cgemm_kernels_a_step"],
            dw["mhd"]["cgemm_kernels_a_step"]) == (6, 12)

    def short(fn, steps):
        table, wall = _dtype_kernel_table(fn, steps)
        return dict(table, gemm_c64=(table["gemm_c64"][0] - 1, 0.1)), wall

    monkeypatch.setattr(chip_smoke, "kernel_table", short)
    with pytest.raises(AssertionError, match="GEMM kernels a step"):
        chip_smoke.dw_steppers("cpu", N=128, steps=2, mhd_steps=2, chunk=2)


def _counted_kernel_table(fn, steps):
    """kernel_table on the CPU: the column solves of one call of ``fn``,
    from the launch counters, as the profiler names kernels."""
    before = {k: k.launches for k in chip_smoke.KERNELS}
    fn()
    return ({f"{k.__name__}_kernel": ((k.launches - before[k]) / steps, 0.01)
             for k in chip_smoke.KERNELS}, 1.0)


def test_replay_phase_rehearses_on_cpu(cpu_rehearsal, monkeypatch):
    """Phase 21 at small N: every run in both modes, which are both eager
    on the CPU (reported so), equal results and launches, the profile's
    solve count held to the counters'."""
    monkeypatch.setattr(chip_smoke, "kernel_table", _counted_kernel_table)
    cases = chip_smoke.capture_cases("cpu", n_large=16, n_small=12, B=2,
                                     steps=2)
    assert len(cases) == 7
    rows = chip_smoke.replay_vs_eager("cpu", cases)
    assert set(rows) == set(cases)
    for name, row in rows.items():
        assert row["bit_equal"] and row["max_abs_diff"] == 0.0, name
        assert row["launches_a_call"]["replay"] == \
            row["launches_a_call"]["eager"] > 0
        for mode in ("eager", "replay"):
            assert row[mode]["captured"] is False
            assert (row[mode]["solve_launches_a_step_profiled"]
                    == row[mode]["solve_launches_a_step_counted"])
        assert row["replay"]["graph_pool_bytes"] is None
        assert len(row["steps_per_s"]["eager"]) == 2
    assert rows["mhd_c64_N16_scan_warm"]["kernel"] == "shear_scan"
    assert rows["isomp_c128_N16"]["iterations_equal"]
    assert rows["adaptive_euler_c128_N16"]["iterations_equal"]


def test_qg_forcing_takes_a_0d_tensor():
    """Phases 14 and 22's forcing cos(t) F0 takes time as the card gives
    it, a 0-d tensor of the working precision, and as the CPU gives it, a
    numpy scalar or a float; the result is F0's dtype."""
    for rdtype, cdtype in ((torch.float32, torch.complex64),
                           (torch.float64, torch.complex128)):
        F0 = torch.arange(6.0).reshape(2, 3).to(cdtype) * (1 + 2j)
        forcing = chip_smoke.qg_forcing(F0)
        t = torch.tensor(0.7, dtype=rdtype)
        out = forcing(None, None, time=t)
        assert out.dtype == cdtype
        assert torch.equal(out, torch.cos(t) * F0)
        numpy_time = np.dtype(str(rdtype).split(".")[1]).type(0.7)
        assert torch.equal(forcing(None, None, time=numpy_time), out)


def test_phase_list_names_22():
    doc = chip_smoke.__doc__
    assert "\n22. hooked runs" in doc
    for part in "abcdefg":
        assert f"\n    {part}. " in doc.split("\n22. ")[1].split("\n23. ")[0]


def test_phase_list_names_23():
    doc = chip_smoke.__doc__
    assert "Twenty-six phases" in doc and "\n23. the row-packed" in doc
    assert "phases 4, 5, 7-25" in doc
    for part in "abcdefg":
        assert f"\n    {part}. " in doc.split("\n23. ")[1].split("\n24. ")[0]


def test_phase_list_names_24():
    doc = chip_smoke.__doc__
    assert "\n24. the adaptive fixed point on the card" in doc
    for part in "ab":
        assert f"\n    {part}. " in doc.split("\n24. ")[1].split("\n25. ")[0]
    assert "csrc/graph_loop.cu" in doc


def test_phase_list_names_25():
    doc = chip_smoke.__doc__
    assert "\n25. the Runge-Kutta integrators on the card" in doc
    for part in "abcde":
        assert f"\n    {part}. " in doc.split("\n25. ")[1]
    assert "Every path (phases 4, 5, 7-25)" in doc


class _ProductSpy(_GemmSpy):
    """_GemmSpy that also sees ``A @ B`` (``Tensor.matmul``), as
    ops.geometry.bracket writes its products."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func is torch.Tensor.matmul:
            self.flags.append(torch.backends.cuda.matmul.allow_tf32)
        return super().__torch_function__(func, types, args, kwargs)


def _erk_kernel_table(fn, steps):
    """kernel_table on the CPU for phase 25's runs: the column solves that
    one call of ``fn`` counted, by the names a profile gives them, and its
    products as one full-precision and one TF32 'kernel' (by the TF32 flag
    at each)."""
    before = {k: k.launches for k in chip_smoke.KERNELS}
    spy = _ProductSpy()
    with spy:
        fn()
    n_tf32 = sum(spy.flags)
    table = {f"{k.__name__}_kernel": ((k.launches - before[k]) / steps, 0.01)
             for k in chip_smoke.KERNELS}
    table["gemm_full"] = ((len(spy.flags) - n_tf32) / steps, 0.1)
    table["gemm_tf32"] = (n_tf32 / steps, 0.05)
    return table, 1.0


def test_erk_phase_rehearses_on_cpu(cpu_rehearsal, monkeypatch):
    """Phase 25 at small N: every run in both modes (both eager on the CPU,
    reported so) bit-equal, with steps x (1, 2, 4) launches of its solve
    and 2 full-precision products a solve; the second calls, no capture
    off a card; the drifts beside isomp's; 25c's kernels against their
    plain solves; 25d's hooks run; 25e's solve in five chunks."""
    monkeypatch.setattr(chip_smoke, "kernel_table", _erk_kernel_table)
    monkeypatch.setattr(chip_smoke, "gemm_kernels",
                        lambda device, shape, dtype: ({"gemm_full"},
                                                      {"gemm_tf32"}))
    cases = chip_smoke.erk_cases("cpu", n_large=16, n_small=12, steps=3)
    assert set(cases) == {f"{m}_{tag}" for m in ("euler", "heun", "rk4")
                          for tag in ("c64_N16", "c128_N12")} | {
        "rk4_c64_N16_scan", "rk4_c64_N16_forced"}
    rows = chip_smoke.erk_replays("cpu", cases, second_steps=2)
    assert set(rows) == set(cases)
    json.dumps(rows)  # the phase's line
    for name, row in rows.items():
        solves = chip_smoke.ERK_SOLVES[name.split("_")[0]]
        assert row["bit_equal"] and row["max_abs_diff"] == 0.0, name
        assert row["launches_a_call"] == {"eager": 3 * solves,
                                          "replay": 3 * solves}, name
        for mode in ("eager", "replay"):
            assert row[mode]["captured"] is False
            assert row[mode]["gemms_a_step_full"] == 2 * solves
            assert row[mode]["gemms_a_step_tf32"] == 0
        assert row["captures_in_two_calls"] == 0
        assert row["second_call"]["launches"] == 2 * solves
        assert 0.0 <= row["drift"]["tr_W2"] and 0.0 <= row["drift"]["energy"]
        assert row["isomp_drift"]["tr_W2"] <= 1e-10 or "c64" in name
    assert rows["rk4_c64_N16_scan"]["kernel"] == "shear_scan"
    plain = chip_smoke.erk_vs_plain("cpu", N=16, steps=2)
    assert set(plain) == {"shear_thomas", "shear_scan"}
    assert all(r["kernel_vs_plain"] == 0.0 for r in plain.values())
    raises = chip_smoke.erk_hook_raises("cpu", N=12)
    assert set(raises) == {"numpy_forcing", "host_norm_forcing"}
    assert all(r["eager_ran"] and r["error"] is None
               for r in raises.values())
    es = chip_smoke.erk_solve("cpu", N=12, steps=10, steps_out=2)
    json.dumps([plain, raises, es])
    assert es["chunks"] == 5 and es["captures"] == 0 and es["bit_equal"]
    assert es["launches"] == {"shear_thomas": 40, "shear_scan": 0}
    assert "QUFLOW_PALLAS_KERNEL" not in chip_smoke.os.environ


def test_erk_solve_captures_once_under_the_card_rule(cpu_rehearsal,
                                                    monkeypatch):
    """Phase 25e with the rule read as on a card and a step graph that
    steps eagerly: one capture across the five chunks of ``solve``, none
    inside ``config.eager()``, the states equal."""
    from collections import OrderedDict

    from quflow_tpu_torch.integrators import erk, isospectral
    from quflow_tpu_torch.parallel import capture

    class Eager:
        def __init__(self, step, W):
            self.step = step

        def run(self, W, steps):
            for _ in range(steps):
                W = self.step(W)
            return W

        def close(self):
            pass

    monkeypatch.setattr(capture, "available",
                        lambda device: not config.is_eager())
    monkeypatch.setattr(isospectral, "_LOOPS", OrderedDict())
    monkeypatch.setattr(erk, "_StepGraph", Eager)
    es = chip_smoke.erk_solve("cpu", N=12, steps=10, steps_out=2)
    assert es["captures"] == 1 and es["bit_equal"]
    assert len(isospectral._LOOPS) == 1


def test_device_loop_phase_rehearses_on_cpu(cpu_rehearsal, monkeypatch):
    """Phase 24 at small N: ``loop_pass`` (its plain version on the CPU)
    against the plain version at small shapes and at the timed ones,
    ``loop_pass`` and
    ``loop_decide`` through every crafted sequence, both dtypes, words
    equal; its times, the replaced sequence's and the library's at small
    shapes, with the bound of its bytes; every run of 24b in both modes
    (both eager on the CPU) equal, with equal launches and iterations, the
    profile's solve count held to the counters'."""
    from quflow_tpu_torch.ops import cuda_graph_loop

    checks = tuple((f"{name}_N{n}", dtype, shape(n))
                   for n in (1, 7, 12)
                   for name, dtype, shape in (
                       ("c64", torch.complex64, lambda n: (n, n)),
                       ("c128", torch.complex128, lambda n: (n, n)),
                       ("planes_f32", torch.float32, lambda n: (2, n, n)),
                       ("mhd_c128", torch.complex128, lambda n: (3, 2, n, n))))
    times = {"c128_N1024": (torch.complex128, (12, 12), [(12, 12)]),
             "mhd_c64_N1024": (torch.complex64, (2, 12, 12),
                               [(2, 12, 12), (12, 12)])}
    ld = chip_smoke.loop_pass_vs_plain("cpu", reps=2, checks=checks,
                                       times=times)
    assert len(ld["sequences"]) == 2 * len(chip_smoke.LOOP_SEQUENCES)
    assert ld["max_abs_err"] == 0.0 and ld["max_rel_err_rn"] == 0.0
    # every timed shape is held to the plain version too
    assert ld["checked"] == [c[0] for c in checks] + list(times)
    assert all(r["max_rel_err_rn"] == 0.0 for r in ld["times"])
    assert ld["bound_by"] == "bytes"
    assert ld["bound_ms"] == pytest.approx(3 * 16 * 144 / 3.35e9, rel=1e-12)
    assert ld["while_pass_ms"] is None  # measured on the card only
    by = {(r["sequence"], r["dtype"]): r for r in ld["sequences"]}
    assert by["nan", "float64"]["counts"] == [6, 6]
    assert by["nan", "float64"]["capped"] == 2
    assert by["maxit_cap", "float32"]["counts"] == [5, 5]
    assert by["minit", "float64"]["counts"] == [3, 3]
    rows = {r["name"]: r for r in ld["times"]}
    assert rows["mhd_c64_N1024"]["bound_ms"] == pytest.approx(
        3 * 8 * 288 / 3.35e9, rel=1e-12)
    assert rows["mhd_c64_N1024"]["plan"] == list(
        cuda_graph_loop.plan(24, 12, torch.complex64, 132))
    assert rows["c128_N1024"]["replaced_ms"] == 1.0  # graph_ms stood in
    # the main path's shapes: the bound of 3 reads and writes of a value
    assert chip_smoke.loop_pass_bound(torch.complex128, (1024, 1024)) == (
        pytest.approx(3 * 16 * 1024 ** 2 / 3.35e9, rel=1e-12), "bytes")
    assert set(chip_smoke.LOOP_RUN_TIMES.values()) <= set(
        chip_smoke.LOOP_PASS_TIMES)
    monkeypatch.setattr(chip_smoke, "kernel_table", _counted_kernel_table)
    cases = chip_smoke.loop_cases("cpu", n_small=12, n_large=16, n_mhd=14,
                                  steps=4, steps_out=2, call_steps=2)
    assert len(cases) == 6
    # 24b's runs at full size, each with its timed shape in 24a
    small = {name.replace("N12", "N256").replace("N16", "N1024")
             .replace("N14", "N512") for name in cases}
    assert set(chip_smoke.LOOP_RUN_TIMES) == small
    rows = chip_smoke.device_loop("cpu", cases)
    assert set(rows) == set(cases)
    for name, row in rows.items():
        assert row["bit_equal"] and row["iterations_equal"], name
        assert row["launches_a_call"]["loop"] == \
            row["launches_a_call"]["eager"], name
        assert row["launches_a_call"]["loop"]["solve"] > 0, name
        for mode in ("eager", "loop"):
            assert (row[mode]["solve_launches_a_step_profiled"]
                    == row[mode]["solve_launches_a_step_counted"])
            assert row[mode]["device_ms_by"] == "profile"
        # the host loop reads its residual once an iteration
        assert row["host_reads_a_call"]["eager"] >= row["iterations_a_step"]
        assert row["eager"]["iteration_ms_a_step"] == pytest.approx(
            row["eager"]["kernel_ms_a_step_profiled"])
    assert rows["quickstart_isomp_c128_N12"]["integrator_calls"] == 2
    assert cuda_graph_loop.loop_decide.launches == 0
    assert cuda_graph_loop.loop_pass.launches == 0


def test_hooked_cases_capture_under_the_card_rule(monkeypatch):
    """Phase 22's runs build on the CPU with the rule read as on a card:
    every stepper captures (22d its iteration) and its config.eager()
    twin does not; isomp and magmp key their loops by their hooks."""
    from quflow_tpu_torch.integrators import isospectral
    from quflow_tpu_torch.parallel import capture

    monkeypatch.setattr(capture, "available",
                        lambda device: not config.is_eager())
    monkeypatch.setattr(config, "device",
                        lambda dev=None: torch.device("cpu" if dev is None
                                                      else dev))
    cases = chip_smoke.hooked_cases("cpu", n_large=16, n_small=14, steps=2)
    assert len(cases) == 6
    modes = {}
    for name, (make, steps, kernel) in cases.items():
        assert steps == 4
        fn, _ = make(False)
        eager, _ = make(True)
        if fn is None:
            continue
        modes[name] = (fn.captured, fn.captured_iteration)
        assert not (eager.captured or eager.captured_iteration)
        assert fn.timed == ("qg" in name)
    assert modes == {"qg_c64_N16_warm": (True, False),
                     "qg_c64_N16_warm_scan": (True, False),
                     "mhd_c64_N16_scan": (True, False),
                     "custom_qg_c128_N14_tol": (False, True)}
    W = torch.zeros(14, 14, dtype=torch.complex128)
    hooks = chip_smoke.custom_qg_hooks()
    assert isospectral._capture_key("isomp", W, *hooks.values()) is not None


def test_hooked_phase_rehearses_on_cpu(cpu_rehearsal, monkeypatch):
    """Phase 22 at small N: every run in both modes (both eager on the
    CPU, reported so) equal, with equal launches, two calls of two steps
    a run; 22a-c's kernels against their plain solves; 22e's stepper
    against isomp; 22g's hooks run on the CPU, where nothing captures."""
    monkeypatch.setattr(chip_smoke, "kernel_table", _counted_kernel_table)
    cases = chip_smoke.hooked_cases("cpu", n_large=16, n_small=14, steps=2)
    rows = chip_smoke.replay_vs_eager("cpu", cases, strict=True)
    assert set(rows) == set(cases)
    for name, row in rows.items():
        assert row["bit_equal"] and row["steps"] == 4, name
        assert row["launches_a_call"]["replay"] == \
            row["launches_a_call"]["eager"] > 0
        for mode in ("eager", "replay"):
            assert row[mode]["captured"] is False
    # maxit + 2 a step: the fixed point and the two Strang half-steps
    for name in ("qg_c64_N16_warm", "qg_c64_N16_warm_scan",
                 "mhd_c64_N16_scan"):
        assert rows[name]["launches_a_call"]["replay"] == 4 * 7, name
    assert rows["qg_c64_N16_warm_scan"]["kernel"] == "shear_scan"
    assert rows["custom_qg_c128_N14_tol"]["iterations_equal"]
    assert rows["isomp_c128_N14"]["launches_a_call"]["replay"] == 4 * 7
    assert rows["magmp_c128_N14"]["iterations_equal"]
    assert "QUFLOW_PALLAS_KERNEL" not in chip_smoke.os.environ
    plain = chip_smoke.hooked_vs_plain("cpu", n_large=16,
                                       compare_steps=(2, 2, 2))
    assert [r["kernel"] for r in plain.values()] == [
        "shear_thomas", "shear_scan", "shear_scan"]
    assert all(r["kernel_vs_plain"] == 0.0 for r in plain.values())
    svi = chip_smoke.hooked_stepper_vs_isomp("cpu", N=14, steps=3)
    assert svi["stepper_vs_isomp"] <= 1e-11
    raises = chip_smoke.hook_raises("cpu", N=14)
    assert set(raises) == {"numpy_forcing", "host_read_forcing"}
    assert all(r["eager_ran"] and r["error"] is None
               for r in raises.values())


def _layout_kernel_table(fn, steps):
    """kernel_table on the CPU for phase 23's runs: the kernels that one
    call of ``fn`` counted, by the names a profile gives them."""
    before = chip_smoke.all_counts()
    fn()
    after = chip_smoke.all_counts()
    moved = {k: (after[k] - before[k]) / steps for k in after}
    return ({"row_thomas_kernel<float, 4>": (moved["row_thomas"], 0.01),
             "shear_thomas_kernel<float, 32, 1, 1>": (
                 moved["shear_thomas"] + moved["shear_thomas_real"], 0.01),
             "shear_scan_kernel<float, One<float>>": (
                 moved["shear_scan"] + moved["shear_scan_real"], 0.01)},
            1.0)


def test_layout_phase_rehearses_on_cpu(cpu_rehearsal, monkeypatch):
    """Phase 23 at small N on the CPU: the kernels against their plain
    versions (23a), the times' fields and bounds (23b), every layout's
    stepper with its launches and gates (23c), MHD (23d), the planes
    stepper (23e), the replays (23f, both modes eager here) and the tp = 2
    'shard' and 'scatter' ranks (23g, this script with --layout-rank)."""
    lk = chip_smoke.layout_kernels(
        "cpu", Ns=(8,), Bs=(1, 2), ragged=(1, 6, 7), large_B=3,
        offset_Ns=(6, 7), long_rows=((torch.complex64, 40),
                                     (torch.complex128, 24)),
        lane_Ns=(8, 9), lane_offset_Ns=(9,),
        lane_edge_Ns={("shear_thomas", "planes", "float32"): (10, 11)})
    assert {r["kernel"] for r in lk} == {"row_thomas", "shear_thomas_real",
                                         "shear_scan_real"}
    # row_thomas, per dtype: 4 N x 2 layouts x 3 B, at 2 N x 2 layouts the
    # offset and aligned d in both modes; 2 long rows; the real lanes, per
    # dtype and kernel: 2 N and 1 offset N x 2 views, and 2 edge N
    assert len(lk) == 2 * (4 * 2 * 3 + 2 * 2 * 4) + 2 + 2 * 2 * 3 * 2 + 2
    assert all(r["max_abs_err"] == 0.0 for r in lk)
    lanes = [r for r in lk if r["kernel"] != "row_thomas"]
    assert all(r.get("interleaved_vs_complex", 0.0) == 0.0 for r in lanes)
    assert sum(r["view"] == "interleaved" for r in lanes) == 12
    assert [(r["N"], r["view"]) for r in lanes if r["edge"]] == [
        (10, "planes"), (11, "planes")]
    assert {r["N"] for r in lanes if r["offset"]} == {9}
    assert all(r["plan"] is None for r in lanes)  # a plan only on a card
    modes = {(r["N"], r["offset"], r["mode"]) for r in lk if "mode" in r}
    assert modes == {(n, o, m) for n in (6, 7) for o in (0, 1)
                     for m in ("resident", "through_out")}
    assert [(r["N"], r["R"], r["B"], r["resident"]) for r in lk
            if "resident" in r] == [(40, 3, 2, None), (24, 3, 2, None)]
    lt = chip_smoke.layout_kernel_times(
        "cpu", row_times=(("wrapped", 16, 1, torch.complex64),
                          ("rolls", 16, 1, torch.complex64),
                          ("wrapped", 16, 4, torch.complex64),
                          ("wrapped", 8, 1, torch.complex128),
                          ("wrapped", 32, 1, torch.complex64)),
        lane_times=((torch.float32, "planes", 16),
                    (torch.float32, "interleaved", 16),
                    (torch.float64, "interleaved", 8),
                    (torch.float32, "planes", 24)))
    lane_rows = [(kernel, B, view) for kernel in ("shear_thomas_real",
                                                  "shear_scan_real")
                 for B, view in ((2, "planes"), (1, "interleaved"),
                                 (1, "interleaved"), (2, "planes"))]
    assert [(r["kernel"], r.get("R"), r.get("B"), r.get("view"))
            for r in lt] == [
        ("row_thomas", 16, 1, None), ("row_thomas", 9, 1, None),
        ("row_thomas", 16, 4, None), ("row_thomas", 8, 1, None),
        ("row_thomas", 32, 1, None),
        *((kernel, None, B, view) for kernel, B, view in lane_rows)]
    assert [r.get("dtype") for r in lt[5:9]] == [
        "float32", "float32", "float64", "float32"]
    assert lt[0]["bound_ms"] == pytest.approx(28 * 16 * 16 / 3.35e9)
    assert lt[2]["bound_ms"] == pytest.approx(76 * 16 * 16 / 3.35e9)
    assert lt[3]["bound_ms"] == pytest.approx(56 * 8 * 8 / 3.35e9)
    assert lt[5]["bound_ms"] == pytest.approx((8 * 2 + 12) * 16 * 17 / 3.35e9)
    assert lt[6]["bound_ms"] == pytest.approx(20 * 16 * 34 / 3.35e9)
    assert lt[7]["bound_ms"] == pytest.approx(40 * 8 * 18 / 3.35e9)
    assert lt[8]["bound_ms"] == pytest.approx(28 * 24 * 25 / 3.35e9)
    assert all(r["share"] == r["bound_ms"] for r in lt)
    assert all("plan" not in r for r in lt)  # a plan only on a card
    ls = chip_smoke.layout_steppers(
        "cpu", runs=((np.complex64, 16, 4), (np.complex128, 32, 4)),
        redirect_N=None)
    for run in ("complex64_N16", "complex128_N32"):
        rows = ls[run]["layouts"]
        assert set(rows) == set(chip_smoke.STEP_LAYOUTS)
        for label, row in rows.items():
            key = chip_smoke.STEP_LAYOUTS[label][3]
            assert row["launches"][key] == 4 * 5, (run, label)
            assert sum(row["launches"].values()) == 4 * 5
    assert ls["complex64_N16"]["layouts"]["scatter"]["refine"] == 0
    assert ls["complex64_N16"]["layouts"]["pallas"]["refine"] == "m0"
    lm = chip_smoke.layout_mhd("cpu", N128=128, steps128=2, N64=24,
                               steps64=2)
    for run in lm.values():
        for row in run["layouts"].values():
            assert row["launches"]["row_thomas"] == 2 * 5
    assert lm["complex128_N128"]["layouts"]["rolls"]["vs_shear"] <= 1e-11
    pl = chip_smoke.planes_stepper("cpu", N=24, steps=3, large_N=16,
                                   large_steps=2)
    assert pl["N24"]["warm"]["launches"]["shear_thomas_real"] == 3 * 5
    assert pl["N16"]["pure"]["vs_complex_builder"] <= 1e-5
    monkeypatch.setattr(chip_smoke, "kernel_table", _layout_kernel_table)
    lr = chip_smoke.replay_vs_eager(
        "cpu", chip_smoke.layout_capture_cases("cpu", N=16, steps=2),
        strict=True)
    assert [r["kernel"] for r in lr.values()] == [
        "row_thomas", "shear_thomas_real", "shear_thomas_real"]
    for row in lr.values():
        assert row["bit_equal"]
        assert row["launches_a_call"]["replay"] == 2 * 5
    ltp = chip_smoke.layouts_tp(
        "cpu", cases=(("shard", "wrapped", 16, "complex64"),
                      ("shard", "wrapped", 16, "complex128"),
                      ("scatter", "scatter", 13, "complex64")),
        steps=2, timeout=120)
    assert ltp["shard_16_complex128"]["mesh_calls_by_rank"] == [
        {"all_to_all": 20, "shift": 20, "gather_rows": 20}] * 2
    assert ltp["scatter_13_complex64"]["mesh_calls_by_rank"] == [
        {"gather_rows": 30}] * 2
    assert ltp["shard_16_complex128"]["vs_one_rank"] <= 1e-12
    for phase in (lk, lt, ls, lm, pl, lr, ltp):  # each phase prints JSON
        json.dumps(phase)
    paths = chip_smoke.layout_paths("row_thomas", ls, lm, pl, lr, ltp)
    assert paths["euler_complex64_N16_pallas"] == 20
    assert paths["tp_scatter_13_complex64_rank1"] == 10
    assert chip_smoke.layout_paths("shear_scan_real", ls, lm, pl, lr, ltp) == {
        "euler_complex64_N16_shear_pallas_il_scan": 20,
        "euler_complex128_N32_shear_pallas_il_scan": 20}


def test_layout_launch_count_short_fails_the_run():
    """Phase 23's launch gate: a path short of its kernel's launches, or
    one that launched another kernel, fails the run."""
    counts = dict(shear_thomas=0, shear_scan=0, row_thomas=20,
                  shear_thomas_real=0, shear_scan_real=0)
    chip_smoke._layout_counts_ok("ok", counts, "wrapped", 20)
    with pytest.raises(AssertionError, match="expected 25 of row_thomas"):
        chip_smoke._layout_counts_ok("short", counts, "pallas", 25)
    with pytest.raises(AssertionError, match="shear_thomas_real only"):
        chip_smoke._layout_counts_ok("other", counts, "shear_pallas_il", 20)
