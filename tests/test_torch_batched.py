"""Ensembles on one device: quflow_tpu_torch's build_step_fn,
build_mhd_step_fn, build_poisson_fn, IsompTorch and MagmpTorch with
``batched=True`` against quflow_tpu's with ``batched=True`` on the same
seeded numpy states, with and without ``tol``; every fixed-point iteration
is one column solve of the whole ensemble (the MHD Strang step one of
2 B).  Tolerances: complex128 1e-12 of the largest entry, complex64 5e-5
(tests/test_torch_stepper.py::test_step_fn_matches_jax_10_steps)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from quflow_tpu.parallel import stepper as jst

from quflow_tpu_torch.ops.cuda_solve import shear_thomas_reference
from quflow_tpu_torch.parallel import stepper as tst

torch.set_num_threads(1)

B, N, STEPS, MAXIT, TOL = 3, 16, 4, 5, 1e-10


def _states(shape, seed, dtype):
    """Skew-Hermitian states of spectral radius 1; an MHD state (..., 2, N,
    N) has Theta at 0.1, as tests/test_mhd.py's random states."""
    rng = np.random.RandomState(seed)
    W = rng.randn(*shape) + 1j * rng.randn(*shape)
    W = W - np.conj(np.swapaxes(W, -1, -2))
    W = W / np.abs(np.linalg.eigvalsh(-1j * W)).max(-1)[..., None, None]
    if len(shape) == 4:
        W[:, 1] *= 0.1
    return W.astype(dtype)


def _close(a, b, dtype):
    tol = 1e-12 if dtype == np.complex128 else 5e-5
    assert np.abs(np.asarray(a) - b).max() <= tol * np.abs(b).max()


class _Spy:
    """The plain column solve, counting its calls and the ensemble size
    (the product of the leading axes) of each."""

    def __init__(self):
        self.batches = []

    def __call__(self, w, binv, u, d):
        self.batches.append(int(np.prod(d.shape[:-2])))
        return shear_thomas_reference(w, binv, u, d)


def _run(kind, dtype, tol, strang=None):
    """(the port's outputs, quflow_tpu's outputs, the spy) of one batched
    run of ``kind`` ('euler' or 'mhd')."""
    dt = 0.2 * jst.hbar(N)
    shape = (B, N, N) if kind == "euler" else (B, 2, N, N)
    S = _states(shape, 11, dtype)
    kw = dict(steps=STEPS, maxit=MAXIT, dtype=dtype, batched=True, tol=tol,
              strang_splitting=strang)
    jb = jst.build_step_fn if kind == "euler" else jst.build_mhd_step_fn
    tb = tst.build_step_fn if kind == "euler" else tst.build_mhd_step_fn
    Sj = jnp.asarray(S)
    z = jnp.zeros_like(Sj)
    ref = [np.asarray(a) for a in jb(N, dt, planes_io=False, layout="shear",
                                     **kw)(Sj, z, z)]
    spy = _Spy()
    St = torch.from_numpy(S)
    zt = torch.zeros_like(St)
    out = tb(N, dt, device="cpu", solver=spy, **kw)(St, zt, zt)
    return out, ref, spy


@pytest.mark.parametrize("dtype", [np.complex128, np.complex64])
@pytest.mark.parametrize("tol", [None, TOL])
@pytest.mark.parametrize("kind", ["euler", "mhd"])
def test_batched_matches_quflow_tpu(kind, tol, dtype):
    if tol is not None and dtype == np.complex64:
        tol = 1e-5  # a float32 residual does not reach 1e-10
    out, ref, spy = _run(kind, dtype, tol)
    _close(out[0].numpy(), ref[0], dtype)
    iters = STEPS * MAXIT
    if tol is not None:
        # the batch-max exit: one count a step for the whole ensemble
        np.testing.assert_array_equal(out[3].numpy(), ref[3])
        iters = int(out[3].sum())
    # one column solve of the whole ensemble an iteration
    assert spy.batches == [B] * iters


def test_mhd_strang_is_one_solve_of_2b():
    """The named MHD Strang half-step solves both components of every
    member in one launch: B states give a solve of 2 B."""
    out, ref, spy = _run("mhd", np.complex128, None,
                         strang=("heat", {"nu": 1e-3}))
    _close(out[0].numpy(), ref[0], np.complex128)
    strang = [b for b in spy.batches if b != B]
    assert strang == [2 * B] * (2 * STEPS)
    assert len(spy.batches) == STEPS * (MAXIT + 2)


@pytest.mark.parametrize("dtype", [np.complex128, np.complex64])
def test_batched_poisson_matches_quflow_tpu(dtype):
    W = _states((B, N, N), 12, dtype)
    ref = np.asarray(jst.build_poisson_fn(N, dtype=dtype, batched=True,
                                          planes_io=False, layout="shear")(
        jnp.asarray(W)))
    spy = _Spy()
    got = tst.build_poisson_fn(N, dtype=dtype, batched=True, device="cpu",
                               solver=spy)(torch.from_numpy(W))
    _close(got.numpy(), ref, dtype)
    assert spy.batches == [B]
    with pytest.raises(ValueError, match="ensemble axis"):
        tst.build_poisson_fn(N, dtype=dtype, batched=True, device="cpu")(
            torch.from_numpy(W[0]))


@pytest.mark.parametrize("kind", ["euler", "mhd"])
def test_batched_integrators_match_quflow_tpu(kind):
    """IsompTorch/MagmpTorch(batched=True) against IsompTPU/MagmpTPU
    (batched=True), two warm calls, complex128."""
    dt = 0.2 * jst.hbar(N)
    shape = (B, N, N) if kind == "euler" else (B, 2, N, N)
    S = _states(shape, 13, np.complex128)
    jcls = jst.IsompTPU if kind == "euler" else jst.MagmpTPU
    tcls = tst.IsompTorch if kind == "euler" else tst.MagmpTorch
    a = jcls(maxit=MAXIT, dtype=np.complex128, batched=True)
    b = tcls(maxit=MAXIT, dtype=np.complex128, batched=True, device="cpu")
    Sa = a(a(S.copy(), dt, steps=3), dt, steps=3)
    Sb = b(b(S.copy(), dt, steps=3), dt, steps=3)
    _close(Sb, Sa, np.complex128)


def test_members_match_their_own_runs():
    """Member b of a batched run against its own unbatched run (no tol: the
    same iterations), complex128 within 1e-13 of the largest entry."""
    dt = 0.2 * jst.hbar(N)
    S = torch.from_numpy(_states((B, N, N), 14, np.complex128))
    fn = tst.build_step_fn(N, dt, steps=STEPS, maxit=MAXIT,
                           dtype=np.complex128, device="cpu")
    fb = tst.build_step_fn(N, dt, steps=STEPS, maxit=MAXIT,
                           dtype=np.complex128, device="cpu", batched=True)
    z = torch.zeros_like(S)
    Wb = fb(S, z, z)[0]
    for b in range(B):
        Wm = fn(S[b], z[b], z[b])[0]
        assert (Wb[b] - Wm).abs().max() <= 1e-13 * Wm.abs().max()
