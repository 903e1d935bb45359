"""The MHD slice: quflow_tpu_torch's magnetic-midpoint stepper, MagmpTorch,
magmp_torch and MHDFlow against quflow_tpu's build_mhd_step_fn, MagmpTPU,
magmp and MHDFlow, on the same numpy inputs (numpy seeds or
tests/data/oracle.npz)."""

from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import quflow_tpu as qf
from quflow_tpu.integrators import magmp, solve_mhd
from quflow_tpu.models import MHDFlow as JMHDFlow
from quflow_tpu.parallel import stepper as jst

import quflow_tpu_torch as qt
from quflow_tpu_torch.models import MHDFlow
from quflow_tpu_torch.ops.cuda_scan_solve import (
    shear_scan,
    shear_scan_reference,
)
from quflow_tpu_torch.ops.cuda_solve import shear_thomas, shear_thomas_reference
from quflow_tpu_torch.parallel import stepper as tst
from quflow_tpu_torch.parallel.mesh import Mesh
from quflow_tpu_torch.sim import registry

torch.set_num_threads(1)

ORACLE = Path(__file__).resolve().parent / "data" / "oracle.npz"


@pytest.fixture(scope="module")
def oracle():
    return np.load(ORACLE)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rand_mhd_state(N, seed=7, scale_theta=0.1, dtype=np.complex128):
    """tests/test_mhd.py's random (W, Theta): skew-Hermitian, trace-free,
    spectral radius 1 and ``scale_theta``."""
    rng = np.random.RandomState(seed)

    def skewh(scale):
        A = rng.randn(N, N) + 1j * rng.randn(N, N)
        A = A - A.conj().T
        A = A - np.eye(N) * np.trace(A) / N
        return scale * A / np.abs(np.linalg.eigvalsh(-1j * A)).max()

    return np.stack([skewh(1.0), skewh(scale_theta)]).astype(dtype)


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


def _jax_run(S, N, dt, steps, maxit, dtype, **kw):
    fn = jst.build_mhd_step_fn(N, dt, steps=steps, maxit=maxit, dtype=dtype,
                               **kw)
    Sp = jnp.asarray(jst.to_planes(S))
    z = jnp.zeros_like(Sp)
    return [np.asarray(a) for a in fn(Sp, z, z)]


def _torch_run(S, N, dt, steps, maxit, dtype, **kw):
    fn = tst.build_mhd_step_fn(N, dt, steps=steps, maxit=maxit, dtype=dtype,
                               device="cpu", **kw)
    St = torch.from_numpy(S)
    z = torch.zeros_like(St)
    return [a.numpy() for a in fn(St, z, z)]


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
@pytest.mark.parametrize("N", [8, 16, 33])
def test_mhd_lap_op_bit_equal(N, dtype):
    """The Laplacian operator comes over with the factors' numpy cast."""
    rd = np.zeros(1, dtype).real.dtype
    got = tst._mhd_lap_op(N, dtype, device="cpu")
    ref = jst._mhd_lap_op(N, "shear", rd)
    assert got.dtype == tst.config.torch_dtype(rd) and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("N", [8, 16, 33])
def test_laplace_core_matches(N):
    S = _rand_mhd_state(N, seed=N)
    op = jst._mhd_lap_op(N, "shear", np.float64)
    ref = np.asarray(jst._laplace_core(jnp.asarray(S), jnp.asarray(op),
                                       layout="shear"))
    got = tst._laplace_core(torch.from_numpy(S),
                            tst._mhd_lap_op(N, np.complex128, device="cpu"))
    assert np.abs(got.numpy() - ref).max() <= 1e-13 * np.abs(ref).max()
    # the quantized Laplacian of quflow_tpu's reference backend
    np.testing.assert_allclose(got.numpy()[1],
                               np.asarray(qf.laplace(S[1], skewh=True)),
                               atol=1e-10)


def test_step_fn_matches_oracle(oracle):
    """The tests/test_mhd.py:56-70 contract on the port: 20 steps of
    maxit 8 at N=12 equal JAX's production stepper and magmp at the same
    fixed iteration count to 1e-12."""
    S0 = oracle["mhd_state0"]
    dtm = float(oracle["mhd_dt"])
    got = _torch_run(S0, 12, dtm, 20, 8, np.complex128)[0]
    ref = jst.from_planes(_jax_run(S0, 12, dtm, 20, 8, np.complex128)[0])
    np.testing.assert_allclose(got, ref, atol=1e-12)
    np.testing.assert_allclose(
        got, magmp(S0.copy(), dtm, steps=20, tol=1e-18, maxit=8, minit=8),
        atol=1e-12)


@pytest.mark.parametrize("compsum", [False, True])
def test_step_fn_compsum_matches(compsum):
    N = 16
    S = _rand_mhd_state(N)
    dt = 0.2 * qf.hbar(N)
    got = _torch_run(S, N, dt, 10, 5, np.complex128, compsum=compsum)
    ref = [jst.from_planes(r)
           for r in _jax_run(S, N, dt, 10, 5, np.complex128, compsum=compsum)]
    assert _rel(got[0], ref[0]) <= 1e-12 and _rel(got[1], ref[1]) <= 1e-12
    # the compensation is roundoff of S: held at S's scale
    assert np.abs(got[2] - ref[2]).max() <= 1e-12 * np.abs(ref[0]).max()
    assert compsum or not got[2].any()


def test_step_fn_c64_m0_matches():
    """complex64 with refine 'm0' (the default) within the Euler stepper's
    bound 5e-5 (tests/test_torch_stepper.py): JAX's associative scan and the serial Thomas solve round
    differently in float32."""
    N = 32
    S = MHDFlow(N, np.complex64).random_initial(lmax=6, seed=5)
    dt = 0.25 * qf.hbar(N)
    got = _torch_run(S, N, dt, 10, 5, np.complex64)
    ref = _jax_run(S, N, dt, 10, 5, np.complex64)
    assert got[0].dtype == np.complex64
    for g, r in zip(got[:2], ref[:2]):
        assert _rel(g, jst.from_planes(r)) <= 5e-5


def test_scan_path_matches_jax_pallas_scan(monkeypatch):
    """The port through shear_scan (its plain version on the CPU) against
    JAX with layout='shear_pallas' and QUFLOW_PALLAS_KERNEL=scan, i.e.
    through the TPU kernel K3 in interpret mode: 5 steps at N=32."""
    monkeypatch.setenv("QUFLOW_PALLAS_KERNEL", "scan")
    N = 32
    S = MHDFlow(N, np.complex128).random_initial(lmax=6, seed=11)
    dt = 0.25 * qf.hbar(N)
    assert tst.column_solver() is shear_scan
    got = _torch_run(S, N, dt, 5, 5, np.complex128, layout="shear_pallas")
    ref = _jax_run(S, N, dt, 5, 5, np.complex128, layout="shear_pallas")
    assert _rel(got[0], jst.from_planes(ref[0])) <= 1e-12
    plain = _torch_run(S, N, dt, 5, 5, np.complex128,
                       solver=shear_scan_reference)
    np.testing.assert_array_equal(got[0], plain[0])


def test_state_from_planes_takes_mhd_planes():
    """JAX's MHD planes (2, 2, N, N) continue on the port as in JAX."""
    N = 16
    S = _rand_mhd_state(N, seed=3)
    dt = 0.2 * qf.hbar(N)
    fj = jst.build_mhd_step_fn(N, dt, steps=4, maxit=5, dtype=np.complex128)
    Sp = jnp.asarray(jst.to_planes(S))
    z = jnp.zeros_like(Sp)
    half = fj(Sp, z, z)
    full = jst.from_planes(np.asarray(fj(*half)[0]))
    state = tst.state_from_planes(*(np.asarray(a) for a in half),
                                  device="cpu")
    assert all(t.shape == (2, N, N) and t.is_complex() for t in state)
    ft = tst.build_mhd_step_fn(N, dt, steps=4, maxit=5, dtype=np.complex128,
                               device="cpu")
    assert _rel(ft(*state)[0].numpy(), full) <= 1e-12


def test_magmp_torch_matches_magmp_tpu_warm_chunks():
    """Two warm chunks of MagmpTorch == two warm chunks of MagmpTPU; the
    stats; the refusals."""
    N = 16
    S0 = _rand_mhd_state(N, seed=9)
    dt = 0.3 * qf.hbar(N)
    a = jst.MagmpTPU(maxit=6, dtype=np.complex128)
    b = tst.MagmpTorch(maxit=6, dtype=np.complex128, device="cpu")
    sa, sb = {}, {}
    Sa = a(a(S0.copy(), dt, steps=15), dt, steps=15, stats=sa)
    Sb = b(b(S0.copy(), dt, steps=15), dt, steps=15, stats=sb)
    assert isinstance(Sb, np.ndarray) and Sb.dtype == np.complex128
    assert _rel(Sb, Sa) <= 1e-12
    # iterations as in MagmpTPU; 'maxit' is the fraction of steps at the cap
    assert sb == {"iterations": 6.0, "maxit": 1.0}
    assert sa["iterations"] == sb["iterations"]
    with pytest.raises(ValueError, match="two-component"):
        b(S0[0].copy(), dt, steps=1)
    with pytest.raises(TypeError, match="MagmpTorch does not accept per-call"):
        b(S0.copy(), dt, steps=1, tol=1e-8)
    # warm_precision='auto' resolves as MagmpTPU resolves it
    for kw in ({}, {"dtype": np.complex128}, {"precision": "high"}):
        assert tst.MagmpTorch(warm_precision="auto", device="cpu",
                              **kw).warm_precision == jst.MagmpTPU(
            warm_precision="auto", **kw).warm_precision
    # an ensemble runs; a mesh whose 'tp' axis splits the rows builds (its
    # runs: tests/test_torch_distributed.py); the row layouts build as
    # quflow_tpu resolves them ('wrapped' on one device, 'shard' under a
    # mesh whose 'tp' divides N), and 'shard' without a mesh raises
    Sb2 = tst.MagmpTorch(maxit=6, dtype=np.complex128, device="cpu",
                         batched=True)(np.stack([S0, S0[::-1]]), dt, steps=2)
    np.testing.assert_array_equal(Sb2[0], tst.MagmpTorch(
        maxit=6, dtype=np.complex128, device="cpu")(S0.copy(), dt, steps=2))
    rows = Mesh(dp=1, tp=2, rank=0, ranks=[0, 1])
    tst.build_mhd_step_fn(8, 0.1, device="cpu", mesh=rows)
    assert tst.MagmpTorch(device="cpu", mesh=rows).layout == "shear_shard"
    for layout in ("wrapped", "rolls", "pallas", "scatter"):
        tst.build_mhd_step_fn(8, 0.1, device="cpu", layout=layout)
        assert tst.MagmpTorch(device="cpu", layout=layout).layout == layout
        assert tst._resolve_layout(8, rows, layout) == "shard"
        tst.build_mhd_step_fn(8, 0.1, device="cpu", mesh=rows, layout=layout)
    with pytest.raises(ValueError, match="mesh"):
        tst.build_mhd_step_fn(8, 0.1, device="cpu", layout="shard")
    with pytest.raises(ValueError, match="mesh"):
        tst.MagmpTorch(device="cpu", layout="shard")
    # the warm schedule's options and every precision name build; an
    # unknown name raises at construction (JAX's MHD stepper raises a
    # KeyError when it builds its program)
    for kw in ({"warm_precision": "high"}, {"warm_iters": 2},
               {"precision": "default"}, {"precision": "high_karatsuba"}):
        tst.build_mhd_step_fn(8, 0.1, device="cpu", **kw)
        tst.MagmpTorch(device="cpu", **kw)
    for kw in ({"precision": "tf32"}, {"warm_precision": "bf16"}):
        with pytest.raises(ValueError, match="precision"):
            tst.build_mhd_step_fn(8, 0.1, device="cpu", **kw)
        with pytest.raises(ValueError, match="precision"):
            tst.MagmpTorch(device="cpu", **kw)


@pytest.mark.parametrize("precision", ["high", "default"])
def test_mhd_warm_schedule_matches_jax(precision):
    """The MHD warm schedule against JAX's build_mhd_step_fn: warm
    iterations at ``precision`` (warm_iters=3 of maxit=5) within 1e-6 of
    JAX's in complex64 (every name is full float32 on the CPU, as
    tests/test_parallel.py says); under tol, the counts of the
    full-precision iterations equal JAX's; the '_karatsuba' warm, which
    only the port's MHD stepper takes, to float32 roundoff of the pure
    schedule."""
    N = 16
    S0 = _rand_mhd_state(N, seed=5, dtype=np.complex64)
    dt = 0.3 * qf.hbar(N)
    Sp = jnp.asarray(jst.to_planes(S0).astype(np.float32))
    zj = jnp.zeros_like(Sp)
    St = torch.from_numpy(S0)
    zt = torch.zeros_like(St)

    def ours(**kw):
        return tst.build_mhd_step_fn(N, dt, dtype=np.complex64,
                                     device="cpu", **kw)(St, zt, zt)

    def theirs(**kw):
        return jst.build_mhd_step_fn(N, dt, dtype=np.complex64, **kw)(
            Sp, zj, zj)

    kw = dict(steps=4, maxit=5, warm_precision=precision, warm_iters=3)
    warm = ours(**kw)[0].numpy()
    np.testing.assert_allclose(
        warm, jst.from_planes(np.asarray(theirs(**kw)[0])), atol=1e-6)
    np.testing.assert_array_equal(warm, ours(steps=4, maxit=5)[0].numpy())
    np.testing.assert_allclose(
        ours(steps=4, maxit=5, warm_precision=precision + "_karatsuba")[0]
        .numpy(), warm, atol=1e-6)
    kw = dict(steps=3, maxit=10, tol=1e-6, warm_precision=precision,
              warm_iters=2)
    out, jout = ours(**kw), theirs(**kw)
    np.testing.assert_array_equal(out[3].numpy(), np.asarray(jout[3]))
    np.testing.assert_allclose(out[0].numpy(),
                               jst.from_planes(np.asarray(jout[0])),
                               atol=1e-6)


def test_solve_with_magmp_torch_matches():
    """solve + MagmpTorch against qf.solve + MagmpTPU: the same state, and
    the same stats handed to the callback."""
    N = 16
    S0 = JMHDFlow(N, np.complex128).random_initial(lmax=6, seed=42)
    kw = dict(stepsize=0.25, steps=40, steps_out=10, progress_bar=False)
    seen_j, seen_t = [], []

    def cb(seen):
        def log(S, delta_time=0.0, delta_steps=0, **stats):
            seen.append((delta_steps, stats.get("iterations")))
        return log

    Sj = qf.solve(S0.copy(), integrator=jst.MagmpTPU(maxit=5,
                                                     dtype=np.complex128),
                  callback=cb(seen_j), **kw)
    St = qt.solve(S0.copy(), integrator=tst.MagmpTorch(
        maxit=5, dtype=np.complex128, device="cpu"), callback=cb(seen_t), **kw)
    assert St.shape == (2, N, N)
    assert _rel(St, Sj) <= 1e-11
    assert seen_t == seen_j == [(10, 5.0)] * 4


def test_magmp_torch_registry():
    """magmp_torch resolves by name, keeps one warm instance per
    (maxit, fast, device), steps like MagmpTorch, and raises on tol/minit/compsum
    instead of dropping them."""
    assert registry.resolve("magmp_torch") is registry.magmp_torch
    assert registry.name_of(registry.magmp_torch) == "magmp_torch"
    N = 12
    S0 = _rand_mhd_state(N, seed=4)
    dt = 0.2 * qf.hbar(N)
    got = registry.magmp_torch(S0.copy(), dt, steps=6, maxit=7, fast=False,
                               time=0.0, device="cpu")
    ref = tst.MagmpTorch(maxit=7, dtype=np.complex128, device="cpu")(
        S0.copy(), dt, steps=6)
    np.testing.assert_array_equal(got, ref)
    key = (tst.MagmpTorch, 7, False, torch.device("cpu"))
    inst = registry._WARM[key]
    registry.magmp_torch(S0.copy(), dt, steps=1, maxit=7, fast=False,
                         device="cpu")
    assert registry._WARM[key] is inst
    for kw in ("tol", "minit", "compsum"):
        with pytest.raises(TypeError, match=kw):
            registry.magmp_torch(S0.copy(), dt, steps=1, device="cpu",
                                 **{kw: 1})


def test_mhd_flow_matches():
    """random_initial bit-equal to quflow_tpu's; the stepper runs; the
    reference-semantics hamiltonian/step agree with quflow_tpu's."""
    for dtype in (np.complex64, np.complex128):
        S = MHDFlow(24, dtype).random_initial(lmax=6, seed=3)
        np.testing.assert_array_equal(
            S, JMHDFlow(24, dtype).random_initial(lmax=6, seed=3))
        assert S.shape == (2, 24, 24) and S.dtype == dtype
    assert qt.MHDFlow is MHDFlow and qt.MagmpTorch is tst.MagmpTorch
    flow = MHDFlow(16, np.complex128)
    S = torch.from_numpy(flow.random_initial(lmax=5, seed=1))
    z = torch.zeros_like(S)
    out = flow.stepper(0.1 * flow.hbar, steps=2, device="cpu")(S, z, z)[0]
    assert out.shape == S.shape and (out - S).abs().max() > 0
    jflow = JMHDFlow(16, np.complex128)
    for got, ref in zip(flow.hamiltonian(S.numpy(), device="cpu"),
                        jflow.hamiltonian(S.numpy())):
        np.testing.assert_allclose(got, np.asarray(ref), atol=1e-10)
    got = flow.step(S.numpy().copy(), 0.1 * flow.hbar, steps=3, device="cpu")
    ref = jflow.step(S.numpy().copy(), 0.1 * flow.hbar, steps=3)
    assert _rel(got, ref) <= 1e-11


def test_mhd_flow_stepper_matches_build_mhd_step_fn():
    """MHDFlow.stepper builds the magnetic-midpoint step: the same run as
    quflow_tpu's build_mhd_step_fn.  (quflow_tpu's own MHDFlow.stepper is
    EulerFlow's, which builds the Euler step on the (2, N, N) state.)"""
    N, steps = 16, 3
    flow = MHDFlow(N, np.complex128)
    S0 = flow.random_initial(lmax=5, seed=1)
    dt = 0.2 * flow.hbar
    S = torch.from_numpy(S0)
    z = torch.zeros_like(S)
    got = flow.stepper(dt, steps, device="cpu")(S, z, z)
    fj = jst.build_mhd_step_fn(N, dt, steps=steps, maxit=5,
                               dtype=np.complex128, compsum=True,
                               planes_io=False)
    zj = jnp.zeros_like(jnp.asarray(S0))
    ref = fj(jnp.asarray(S0), zj, zj)
    for a, b in zip(got[:2], ref[:2]):  # the state and the fixed point
        assert _rel(a.numpy(), np.asarray(b)) <= 1e-12


@pytest.mark.cuda
def test_mhd_step_on_card_kernels_match_plain(cuda):
    """The MHD step on the card through each kernel and through its plain
    version: the same trajectory, one launch per fixed-point iteration."""
    N, steps, maxit = 64, 3, 5
    S0 = torch.from_numpy(MHDFlow(N, np.complex64).random_initial(
        lmax=6, seed=1)).to(cuda)
    z = torch.zeros_like(S0)
    dt = 0.25 * qt.hbar(N)
    for kernel, plain in ((shear_thomas, shear_thomas_reference),
                          (shear_scan, shear_scan_reference)):
        before = kernel.launches
        Sk = tst.build_mhd_step_fn(N, dt, steps=steps, maxit=maxit,
                                   device=cuda, solver=kernel)(S0, z, z)[0]
        assert kernel.launches == before + steps * maxit
        Sp = tst.build_mhd_step_fn(N, dt, steps=steps, maxit=maxit,
                                   device=cuda, solver=plain)(S0, z, z)[0]
        torch.testing.assert_close(Sk, Sp, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the reference-semantics MHD integrator (integrators/mhd.py)
# ---------------------------------------------------------------------------

def test_magmp_oracle(oracle):
    """tests/test_mhd.py's reference case on the port: the oracle to
    1e-10 and quflow_tpu's magmp to 1e-11, with the same stats."""
    st0 = oracle["mhd_state0"]
    dtm = float(oracle["mhd_dt"])
    s_t, s_j = {}, {}
    out = qt.magmp(st0.copy(), dtm, steps=20, tol=1e-12, maxit=20,
                   stats=s_t, device="cpu")
    np.testing.assert_allclose(out, oracle["mhd_state20"], atol=1e-10)
    ref = magmp(st0.copy(), dtm, steps=20, tol=1e-12, maxit=20, stats=s_j)
    np.testing.assert_allclose(out, ref, atol=1e-11)
    assert s_t == s_j


def test_solve_mhd_hamiltonian(oracle):
    st = oracle["mhd_state0"]
    P, B = qt.solve_mhd(st, device="cpu")
    np.testing.assert_allclose(P, np.asarray(qf.solve_poisson(st[0],
                                                              skewh=True)),
                               atol=1e-13)
    np.testing.assert_allclose(B, np.asarray(qf.laplace(st[1], skewh=True)),
                               atol=1e-10)
    Pt, Bt = qt.solve_mhd(torch.from_numpy(st))
    np.testing.assert_array_equal(Pt.numpy(), P)
    np.testing.assert_array_equal(Bt.numpy(), B)


def test_magmp_conservation(oracle):
    """Theta is advected isospectrally: its spectrum holds over 100
    steps."""
    st = oracle["mhd_state0"].copy()
    e0 = np.sort(np.linalg.eigvalsh(-1j * st[1]))
    out = qt.magmp(st.copy(), float(oracle["mhd_dt"]), steps=100, tol=1e-12,
                   maxit=20, device="cpu")
    np.testing.assert_allclose(np.sort(np.linalg.eigvalsh(-1j * out[1])), e0,
                               atol=1e-9)


@pytest.mark.parametrize("case", ["auto", "callback", "time", "forcing"])
def test_magmp_options_match(oracle, case):
    """The 'auto' tolerance (its stats key 'tol'), the callback (W_prev,
    W_new - W_prev), a Hamiltonian that takes ``time``, and forcing,
    each against quflow_tpu's magmp."""
    st0 = oracle["mhd_state0"]
    dtm = float(oracle["mhd_dt"])
    kw_j = {"tol": 1e-12}
    kw_t = dict(kw_j)
    if case == "auto":
        kw_t, kw_j = {}, {}
    elif case == "callback":
        seen = []
        kw_t["callback"] = lambda W, dW: seen.append((W.copy(), dW.copy()))
    elif case == "time":
        def ham(W, time=0.0):
            P, B = qt.solve_mhd(W)
            return P * (1.0 + 0.1 * time), B

        def jham(W, time=0.0):
            P, B = solve_mhd(W)
            return P * (1.0 + 0.1 * time), B

        kw_t.update(hamiltonian=ham, time=0.2)
        kw_j.update(hamiltonian=jham, time=0.2)
    else:
        F = np.stack([st0[0] * 0.01, st0[1] * 0.0])
        kw_t["forcing"] = kw_j["forcing"] = lambda P, W: F
    s_t, s_j = {}, {}
    out = qt.magmp(st0.copy(), dtm, steps=10, stats=s_t, device="cpu", **kw_t)
    ref = magmp(st0.copy(), dtm, steps=10, stats=s_j, **kw_j)
    np.testing.assert_allclose(out, ref, atol=1e-11)
    assert s_t == s_j
    if case == "auto":
        assert set(s_t) == {"tol", "iterations", "maxit"}
    if case == "callback":
        assert len(seen) == 10 and isinstance(seen[0][0], np.ndarray)
        np.testing.assert_allclose(seen[0][0], st0)
        for k in range(9):
            np.testing.assert_allclose(seen[k + 1][0],
                                       seen[k][0] + seen[k][1], atol=1e-13)


def test_mhd_model():
    """MHDFlow.step is magmp (tests/test_mhd.py's model case)."""
    flow = MHDFlow(N=12)
    st = flow.random_initial(lmax=5)
    assert st.shape == (2, 12, 12)
    out = flow.step(st.copy(), 0.1 * flow.hbar, steps=3, device="cpu")
    assert out.shape == st.shape
    assert np.abs(out - st).max() > 0
    np.testing.assert_allclose(
        out, JMHDFlow(N=12).step(st.copy(), 0.1 * flow.hbar, steps=3),
        atol=1e-12)


def test_magmp_torch_equals_magmp_at_fixed_iterations(oracle):
    """MagmpTorch's fixed iteration count is the port's magmp with
    tol=1e-18 and maxit=minit, complex128 (tests/test_mhd.py:56-83 checks
    the same of quflow_tpu's production stepper)."""
    st0 = oracle["mhd_state0"]
    dtm = float(oracle["mhd_dt"])
    ref = qt.magmp(st0.copy(), dtm, steps=20, tol=1e-18, maxit=8, minit=8,
                   device="cpu")
    out = tst.MagmpTorch(maxit=8, dtype=np.complex128, compsum=False,
                         device="cpu")(st0.copy(), dtm, steps=20)
    np.testing.assert_allclose(out, ref, atol=1e-12)
