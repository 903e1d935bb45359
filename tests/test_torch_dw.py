"""The double-word steppers and ops/dwgemm.py of quflow_tpu_torch against
quflow_tpu's: twins of the CPU-runnable tests of tests/test_dwgemm.py and
tests/test_dw_compose.py at N <= 24.

quflow_tpu multiplies by an Ozaki split of bf16 slices (relative error
~2^-50); the port by complex128 products (a ZGEMM on the card).  Both are
f64-accurate, so the pure double-word schedule (dw_iters = maxit) and the
adaptive tol are held to quflow_tpu's at JAX's own tolerance, 1e-12 of
the largest entry (an absolute 1e-12 on these O(1) states).  The mixed
schedule's warm iterations multiply in float32, which the two packages
round differently (a complex64 product here, four real float32 products
there); the dw iterations contract that difference, and the test holds it
to 1e-10 beside the conservation gate JAX's own test holds.

quflow_tpu's dw compiles take seconds each, so every quflow_tpu run is
made once, in a module fixture, and shared.
"""

from functools import partial

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import quflow_tpu as qf
from quflow_tpu.integrators.isospectral import isomp_fixedpoint
from quflow_tpu.integrators.mhd import magmp_fixedpoint
from quflow_tpu.models import MHDFlow as JMHDFlow
from quflow_tpu.ops import dwgemm as jdw
from quflow_tpu.ops.laplacian import solve_globalqg, solve_viscdamp
from quflow_tpu.parallel import stepper as jst

from quflow_tpu_torch.ops import dwgemm as tdw
from quflow_tpu_torch.ops.laplacian import solve_poisson
from quflow_tpu_torch.parallel import stepper as tst
from quflow_tpu_torch.parallel.mesh import Mesh

torch.set_num_threads(1)

N, N_MHD = 24, 16
STEPS, MAXIT = 6, 6
ATOL = 1e-12
VISC = dict(nu=1e-3, alpha=0.02)


def _dt(n=N):
    return 0.25 * qf.hbar(n)


@pytest.fixture(scope="module")
def W0():
    return qf.shr2mat(qf.random_shr(lmax=7, seed=3), N=N).astype(np.complex128)


@pytest.fixture(scope="module")
def S0():
    return JMHDFlow(N=N_MHD, dtype=np.complex128).random_initial(lmax=5,
                                                                  seed=5)


def _planes(X):
    return np.stack([X.real, X.imag]).astype(np.float64)


def _complex(Xp):
    Xp = Xp.numpy() if isinstance(Xp, torch.Tensor) else np.asarray(Xp)
    return Xp[0] + 1j * Xp[1]


def run_port(X, mhd=False, t0=(), steps=STEPS, **kw):
    n = X.shape[-1]
    build = tst.build_dw_mhd_step_fn if mhd else tst.build_dw_step_fn
    kw = {"maxit": MAXIT, "dw_iters": MAXIT, **kw}
    fn = build(n, _dt(n), steps=steps, device="cpu", **kw)
    Xp = torch.from_numpy(_planes(X) if X.ndim == (3 if mhd else 2)
                          else np.stack([_planes(x) for x in X], axis=1))
    z = torch.zeros_like(Xp)
    return fn(Xp, z, z, *t0)


def run_jax(X, mhd=False, t0=(), steps=STEPS, **kw):
    n = X.shape[-1]
    build = jst.build_dw_mhd_step_fn if mhd else jst.build_dw_step_fn
    kw = {"maxit": MAXIT, "dw_iters": MAXIT, **kw}
    fn = build(n, _dt(n), steps=steps, **kw)
    Xp = jnp.asarray(_planes(X))
    z = jnp.zeros_like(Xp)
    return [np.asarray(a) for a in fn(Xp, z, z, *t0)]


def _cmm_np(xp, Ap, Bp):
    re = Ap[0] @ Bp[0] - Ap[1] @ Bp[1]
    im = Ap[0] @ Bp[1] + Ap[1] @ Bp[0]
    return xp.stack([re, im])


def force_c(P, W):
    return 0.05 * (P @ W - W @ P)


def force_p_port(Pp, Wp):
    return 0.05 * (_cmm_np(torch, Pp, Wp) - _cmm_np(torch, Wp, Pp))


def force_p_jax(Pp, Wp):
    return 0.05 * (_cmm_np(jnp, Pp, Wp) - _cmm_np(jnp, Wp, Pp))


def force_t_c(P, W, time=0.0):
    return 0.03 * jnp.sin(time) * (P - W)


def force_t_jax(Pp, Wp, time=0.0):
    return 0.03 * jnp.sin(time) * (Pp - Wp)


def force_t_port(Pp, Wp, time=0.0):
    return 0.03 * np.sin(time) * (Pp - Wp)


#: the Euler twins: name -> (port options, quflow_tpu dw options, t0);
#: the timed forcing, the theta scheme and the planes callables are held
#: against quflow_tpu's complex128 integrator below, which compiles faster
EULER = {
    "pure_diagnostics": (dict(with_diagnostics=True),
                         dict(with_diagnostics=True), ()),
    "tol": (dict(maxit=10, dw_iters=8, tol=1e-10),
            dict(maxit=10, dw_iters=8, tol=1e-10), ()),
    "all_hooks_adaptive": (
        dict(maxit=12, dw_iters=12, tol=1e-13, hamiltonian=("globalqg", 1.7),
             forcing=force_p_port, strang_splitting=("viscdamp", VISC)),
        dict(maxit=12, dw_iters=12, tol=1e-13, hamiltonian=("globalqg", 1.7),
             forcing=force_p_jax, strang_splitting=("viscdamp", VISC)), ()),
}
#: the mixed schedule's run: quflow_tpu's test_dw_stepper_mixed_schedule_
#: conserves at N=24 (its N=32 state would not fit the file's N), a state
#: of lmax 5 on which quflow_tpu's own drift is inside its 1e-11 gate
MIXED = dict(maxit=5, dw_iters=2, steps=50)
MIXED_DT = 0.2


def force_mhd_port(Pp, Sp):
    P4 = Pp[:, None]
    return 0.04 * (_cmm_np(torch, P4, Sp) - _cmm_np(torch, Sp, P4))


def force_mhd_jax(Pp, Sp):
    P4 = Pp[:, None]
    return 0.04 * (_cmm_np(jnp, P4, Sp) - _cmm_np(jnp, Sp, P4))


#: the MHD twins (the pure schedule is held against quflow_tpu's
#: complex128 magmp below)
MHD = {
    "forcing_strang": (
        dict(forcing=force_mhd_port, strang_splitting=("viscdamp", VISC)),
        dict(forcing=force_mhd_jax, strang_splitting=("viscdamp", VISC))),
    "mixed_tol": (dict(maxit=6, dw_iters=2, tol=1e-15, steps=20),
                  dict(maxit=6, dw_iters=2, tol=1e-15, steps=20)),
}


@pytest.fixture(scope="module")
def W_mixed():
    return qf.shr2mat(qf.random_shr(lmax=5, seed=4), N=N).astype(np.complex128)


def _run_mixed(run, W):
    n = W.shape[-1]
    kw = dict(MIXED, device="cpu") if run is tst.build_dw_step_fn else MIXED
    fn = run(n, MIXED_DT * qf.hbar(n), **kw)
    Wp = _planes(W)
    if run is tst.build_dw_step_fn:
        Wp = torch.from_numpy(Wp)
        return _complex(fn(Wp, torch.zeros_like(Wp), torch.zeros_like(Wp))[0])
    Wp = jnp.asarray(Wp)
    return _complex(fn(Wp, jnp.zeros_like(Wp), jnp.zeros_like(Wp))[0])


@pytest.fixture(scope="module")
def jax_runs(W0, S0, W_mixed):
    """Every quflow_tpu dw run of the file, made once (a dw compile takes
    seconds)."""
    out = {name: run_jax(W0, t0=t0, **kw)
           for name, (_, kw, t0) in EULER.items()}
    out.update({"mhd_" + name: run_jax(S0, mhd=True, **kw)
                for name, (_, kw) in MHD.items()})
    out["mixed"] = _run_mixed(jst.build_dw_step_fn, W_mixed)
    return out


def _dist(a, b):
    return np.abs(_complex(a) - _complex(b)).max()


@pytest.mark.parametrize("case", list(EULER))
def test_dw_step_matches_quflow_tpu(W0, jax_runs, case):
    port_kw, _, t0 = EULER[case]
    got = run_port(W0, t0=t0, **port_kw)
    ref = jax_runs[case]
    assert _dist(got[0], ref[0]) < ATOL
    assert _dist(got[1], ref[1]) < ATOL  # the warm-start dW
    if "tol" in port_kw:
        counts = got[3].numpy()
        assert counts.dtype == np.int32 and counts.shape == (STEPS,)
        np.testing.assert_array_equal(counts, ref[3])
    if "with_diagnostics" in port_kw:
        np.testing.assert_allclose(got[-1].numpy(), ref[-1], rtol=1e-12)
        e, z2 = got[-1].numpy()
        assert abs(z2 - float(qf.enstrophy(_complex(got[0])))) < 1e-12


def test_dw_step_matches_c128_host(W0):
    """The pure schedule against quflow_tpu's complex128 reference-
    semantics integrator at the same iteration count."""
    out = _complex(run_port(W0)[0])
    ref = np.asarray(isomp_fixedpoint(W0.copy(), _dt(), steps=STEPS,
                                      maxit=MAXIT, minit=MAXIT, tol=1e-300,
                                      compsum=True))
    assert np.abs(out - ref).max() < ATOL
    # forcing changes the trajectory, and its c128 twin agrees
    forced = _complex(run_port(W0, forcing=force_p_port)[0])
    ref_f = np.asarray(isomp_fixedpoint(W0.copy(), _dt(), steps=STEPS,
                                        maxit=MAXIT, minit=MAXIT, tol=1e-300,
                                        compsum=True, forcing=force_c))
    assert np.abs(forced - ref_f).max() < ATOL
    assert np.abs(forced - ref).max() > 1e-8


def test_dw_hooks_match_c128_host(W0):
    """Named QG + named Strang and the theta scheme against the complex128
    integrator with the callables of the same families."""
    ham = partial(solve_globalqg, gamma=1.7, skewh=True)
    for theta in (1, 0.5):
        strang = partial(solve_viscdamp, theta=theta, skewh=True, **VISC)
        out = _complex(run_port(
            W0, hamiltonian=("globalqg", 1.7),
            strang_splitting=("viscdamp", dict(theta=theta, **VISC)))[0])
        ref = np.asarray(isomp_fixedpoint(
            W0.copy(), _dt(), steps=STEPS, maxit=MAXIT, minit=MAXIT,
            tol=1e-300, compsum=True, hamiltonian=ham,
            strang_splitting=strang))
        assert np.abs(out - ref).max() < ATOL


def test_dw_planes_callables(W0):
    """A callable Hamiltonian on planes that solves Poisson reproduces the
    named path; a planes Strang callable and a timed planes forcing run
    as quflow_tpu's complex twins do."""
    def ham_planes(Wp):
        P = solve_poisson(torch.complex(Wp[0], Wp[1]), skewh=True)
        return torch.stack([P.real, P.imag])

    a = _complex(run_port(W0, hamiltonian=ham_planes)[0])
    b = _complex(run_port(W0)[0])
    assert np.abs(a - b).max() < 1e-14

    def strang_planes(h, Wp):
        W = torch.complex(Wp[0], Wp[1])
        from quflow_tpu_torch.ops.laplacian import solve_viscdamp as tvd

        out = tvd(h, W, theta=1, skewh=True, **VISC)
        return torch.stack([out.real, out.imag])

    a = _complex(run_port(W0, strang_splitting=strang_planes)[0])
    b = _complex(run_port(W0, strang_splitting=("viscdamp", VISC))[0])
    assert np.abs(a - b).max() < 1e-14
    timed = _complex(run_port(W0, forcing=force_t_port, t0=(0.7,))[0])
    ref = np.asarray(isomp_fixedpoint(
        W0.copy(), _dt(), steps=STEPS, maxit=MAXIT, minit=MAXIT, tol=1e-300,
        compsum=True, forcing=force_t_c, time=0.7))
    assert np.abs(timed - ref).max() < ATOL


def test_dw_mixed_schedule_conserves(W_mixed, jax_runs):
    """The production schedule (3 complex64 iterations, then 2 in
    complex128) holds the Casimirs inside quflow_tpu's gate (1e-11 on the
    spectrum over 50 steps) and drifts as quflow_tpu's mixed run does; the
    two stay within 1e-10: their float32 products round differently, the
    dw iterations contract that."""
    Wf = _run_mixed(tst.build_dw_step_fn, W_mixed)
    spec0 = np.sort(np.linalg.eigvalsh(-1j * W_mixed))

    def drift(W):
        return np.abs(np.sort(np.linalg.eigvalsh(-1j * W)) - spec0).max()

    assert drift(Wf) < 1e-11
    assert drift(Wf) <= 1.5 * drift(jax_runs["mixed"])
    assert np.abs(Wf - jax_runs["mixed"]).max() < 1e-10


def test_dw_batched(W0):
    """(2, E, N, N) planes: each member equals its own run."""
    W1 = qf.shr2mat(qf.random_shr(lmax=7, seed=9), N=N).astype(np.complex128)
    out = run_port(np.stack([W0, W1]), batched=True)[0].numpy()
    for e, W in enumerate((W0, W1)):
        own = run_port(W)[0].numpy()
        assert np.abs(out[:, e] - own).max() < 1e-13


@pytest.mark.parametrize("case", list(MHD))
def test_dw_mhd_matches_quflow_tpu(S0, jax_runs, case):
    port_kw, _ = MHD[case]
    got = run_port(S0, mhd=True, **port_kw)
    ref = jax_runs["mhd_" + case]
    if case == "mixed_tol":
        # the float32 warm prefix rounds differently (see the module note)
        assert _dist(got[0], ref[0]) < 1e-10
        np.testing.assert_array_equal(got[3].numpy(), ref[3])
        Sf = _complex(got[0])
        T0, Tf = S0[1], Sf[1]
        spec0 = np.sort(np.linalg.eigvalsh(-1j * T0))
        spec = np.sort(np.linalg.eigvalsh(-1j * Tf))
        assert np.abs(spec - spec0).max() < 1e-12
        ch0 = float(np.einsum("ij,ji->", S0[0], T0).real)
        ch = float(np.einsum("ij,ji->", Sf[0], Tf).real)
        assert abs(ch - ch0) < 1e-12 * max(abs(ch0), 1.0)
    else:
        assert _dist(got[0], ref[0]) < ATOL


def test_dw_mhd_matches_c128_host(S0):
    out = _complex(run_port(S0, mhd=True, steps=4)[0])
    ref = np.asarray(magmp_fixedpoint(S0.copy(), _dt(N_MHD), steps=4,
                                      maxit=MAXIT, minit=MAXIT, tol=1e-300))
    assert np.abs(out - ref).max() < ATOL


def test_dwgemm_matches_quflow_tpu():
    """split_params equal to quflow_tpu's (and its refusal); dw_matmul and
    dw_matmul_planes within 1e-14 of the exact products and of
    quflow_tpu's, on the CPU as asked and a tensor on its own device."""
    for K in (16, 64, 512, 1024, 4096, 16384):
        for bits in (50, 53):
            assert tdw.split_params(K, bits) == jdw.split_params(K, bits)
    with pytest.raises(ValueError, match="too large"):
        tdw.split_params(1 << 21)
    rng = np.random.RandomState(1)
    for K in (64,):
        A = rng.randn(24, K) * np.exp(rng.randn(24, 1))
        B = rng.randn(K, 24) * np.exp(rng.randn(1, 24))
        C = tdw.dw_matmul(A, B, device="cpu")
        assert isinstance(C, torch.Tensor) and C.dtype == torch.float64
        Cx = A @ B
        assert np.abs(C.numpy() - Cx).max() / np.abs(Cx).max() < 1e-14
        Cj = np.asarray(jax.jit(jdw.dw_matmul)(A, B))
        assert np.abs(C.numpy() - Cj).max() / np.abs(Cx).max() < 1e-14
    Ap, Bp = rng.randn(2, 16, 128), rng.randn(2, 128, 16)
    Cp = tdw.dw_matmul_planes(torch.from_numpy(Ap), torch.from_numpy(Bp))
    Cx = (Ap[0] + 1j * Ap[1]) @ (Bp[0] + 1j * Bp[1])
    assert Cp.shape == (2, 16, 16)
    assert np.abs(_complex(Cp) - Cx).max() / np.abs(Cx).max() < 1e-14
    Cj = np.asarray(jax.jit(jdw.dw_matmul_planes)(Ap, Bp))
    assert np.abs(Cp.numpy() - Cj).max() / np.abs(Cx).max() < 1e-14


def test_dw_refusals():
    """As quflow_tpu: a callable MHD Hamiltonian, an N that the mesh's tp
    does not divide, a contraction too long for the split."""
    with pytest.raises(NotImplementedError, match="named"):
        tst.build_dw_mhd_step_fn(8, 0.1, hamiltonian=lambda W: W,
                                 device="cpu")
    rows = Mesh(dp=1, tp=4, rank=0, ranks=[0, 1, 2, 3])
    with pytest.raises(ValueError, match="divisible"):
        tst.build_dw_step_fn(30, 0.01, mesh=rows, device="cpu")
    with pytest.raises(ValueError, match="too large"):
        tst.build_dw_mhd_step_fn(1 << 21, 0.01, device="cpu")
