"""The yardstick's arithmetic and the readers that use it."""

import math
import statistics
import types

import numpy as np
import pytest

from portbench import yardstick
from portbench.harness import Recorder, Run
from portbench.profiling import summarize

from conftest import REPO


@pytest.mark.parametrize("N,B,dtype,ms", [
    # chip_smoke.solve_bound's values at these shapes
    (1024, 1, "complex64", 0.008772776119402985),
    (1024, 16, "complex64", 0.083968),
    (512, 8, "complex128", 0.021953337313432835),
    (4096, 1, "complex64", 0.14026171223880596),
])
def test_solve_bound_is_chip_smokes(N, B, dtype, ms):
    assert yardstick.solve_bound(N, B, dtype) == (pytest.approx(ms, rel=1e-12),
                                                   "bytes")


@pytest.mark.parametrize("dtype,shape,ms", [
    # chip_smoke.loop_pass_bound's values
    ("complex128", (1024, 1024), 0.015024372537313433),
    ("complex64", (16, 1024, 1024), 0.12019498029850746),
    ("float32", (2, 512, 512), 0.001878046567164179),
])
def test_loop_pass_bound_is_chip_smokes(dtype, shape, ms):
    assert yardstick.loop_pass_bound(dtype, shape) == (
        pytest.approx(ms, rel=1e-12), "bytes")


def test_gemm_flops_count():
    # Euler c64 N=1024 maxit 5: 2 products an iteration, 8 N^3 each
    assert yardstick.gemm_flops_per_step(1024, 1, 5, 2) == 80 * 1024 ** 3
    assert yardstick.gemm_flops_per_step(1024, 16, 2.5, 6) == (
        16 * 2.5 * 6 * 8 * 1024 ** 3)


def test_percentiles_and_spread():
    xs = list(range(1, 101))
    assert yardstick.p95(xs) == pytest.approx(np.percentile(xs, 95))
    assert yardstick.percentile([3.0], 95) == 3.0
    q1, q2, q3 = statistics.quantiles(xs, n=4)
    assert yardstick.spread(xs) == pytest.approx((q3 - q1) / q2)


@pytest.mark.parametrize("name,kind", [
    ("void shear_thomas_kernel<float2, 4>(float const*)", "solve"),
    ("shear_scan_kernel", "solve"),
    ("sm90_xmma_gemm_c64f32_c64f32_f32_nn_n_tilesize", "gemm"),
    ("void cutlass::Kernel2<cutlass_80_tensorop_c1688tf32gemm>", "gemm"),
    ("ampere_cgemm_32x32_tn", "gemm"),
    ("void at::native::vectorized_elementwise_kernel<4>", "glue"),
    ("loop_pass", "glue"),
])
def test_kernel_kinds(name, kind):
    assert yardstick.kernel_kind(name) == kind


def _run(stamps, steps, batch=1, start=0.0):
    cell = types.SimpleNamespace(config={"gemms_per_iteration": 2})
    run = Run(cell, 1)
    run.batch, run.N, run.dtype = batch, 1024, np.dtype("complex64")
    run.window_start, run.window_end = start, stamps[-1]
    run.recorder = Recorder()
    run.recorder.stamps = list(stamps)
    run.recorder.steps = list(steps)
    run.recorder.iterations = [5.0 * s for s in steps]
    run.recorder.copy_s = [0.001] * len(stamps)
    return run


def _reader(name):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, REPO / "portbench" / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def test_p95_is_over_every_interval_from_the_window_start():
    stamps = [0.04 * (k + 1) for k in range(99)] + [0.04 * 99 + 1.0]
    run = _run(stamps, [20] * 100)
    intervals = run.output_intervals_s()
    assert len(intervals) == 100 and intervals[0] == pytest.approx(0.04)
    assert _reader("output_interval_p95_ms")(run) == pytest.approx(
        np.percentile(np.array(intervals) * 1e3, 95))


def test_state_steps_per_s_and_step_mfu():
    run = _run([1.0, 2.0], [20, 20], batch=16)
    assert _reader("state_steps_per_s")(run) == pytest.approx(16 * 40 / 2.0)
    flops = 16 * 5 * 2 * 8 * 1024 ** 3 * 40
    assert _reader("step_mfu")(run) == pytest.approx(
        100 * flops / (2.0 * 495e12))
    assert _reader("output_copy_ms")(run) == pytest.approx(1.0)


def _trace():
    ev = []

    def x(cat, name, ts, dur):
        ev.append({"ph": "X", "cat": cat, "name": name, "ts": ts,
                   "dur": dur})

    x("user_annotation", "portbench.solve", 0.0, 1000.0)
    x("user_annotation", "portbench.output_copy", 800.0, 190.0)
    x("kernel", "shear_thomas_kernel", 10.0, 100.0)
    x("kernel", "sm90_xmma_gemm_c64", 110.0, 300.0)
    x("kernel", "vectorized_elementwise_kernel", 600.0, 50.0)
    x("gpu_memcpy", "Memcpy DtoH", 820.0, 100.0)
    x("kernel", "outside_the_window", 2000.0, 10.0)
    return {"traceEvents": ev}


def test_trace_summary():
    s = summarize(_trace(), steps=2)
    assert s["window_s"] == pytest.approx(1e-3)
    assert s["busy_s"] == pytest.approx((400 + 50 + 100) * 1e-6)
    assert s["kernels"] == 3
    assert s["ms"] == pytest.approx({"solve": 0.1, "gemm": 0.3,
                                     "glue": 0.05})
    assert s["breakdown"]["device_ops"][0] == ["sm90_xmma_gemm_c64",
                                               pytest.approx(3e-4)]
    gaps = s["breakdown"]["idle_gaps"]
    assert gaps[0] == ["inside_solve", pytest.approx(190e-6)]
    assert ["output_copy", pytest.approx(80e-6)] in gaps
    assert sum(g for _, g in gaps) == pytest.approx(1e-3 - s["busy_s"])
    assert math.isclose(s["idle_by_host"]["inside_solve"], 370e-6)


def _feed(seed, n, keep=3):
    import torch

    rec = Recorder(keep=keep, seed=seed, before=np.full(1, -1.0))
    for k in range(n):
        rec(torch.full((1,), float(k)), delta_steps=20)
    return rec


def test_recorder_keeps_a_seeded_sample_of_intervals():
    rec = _feed(7, 50)
    assert rec.count == 50 and len(rec.sample) == 3
    assert rec.first[0] == 0 and rec.last[0] == 49
    for k, start, end in rec.sample:
        assert end[0] == k and start[0] == k - 1
    assert [k for k, *_ in _feed(7, 50).sample] == [k for k, *_ in rec.sample]
    assert [k for k, *_ in _feed(8, 50).sample] != [k for k, *_ in rec.sample]
    hits = np.zeros(20)
    for seed in range(2000):
        for k, *_ in _feed(seed, 20).sample:
            hits[k] += 1
    assert hits.min() > 0.8 * 300 and hits.max() < 1.2 * 300  # 3/20 each
