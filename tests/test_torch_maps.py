"""quflow_tpu_torch.quantization.torchmaps against quflow_tpu's jaxmaps
(twins of tests/test_jaxmaps.py), on the same numpy-seeded inputs:
shr2mat/mat2shr in complex128 within 1e-12 of JAX's maps and of the host
transforms, the round trip, the gradient against jax.grad, the batched
maps against jax.vmap."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import quflow_tpu as qf
from quflow_tpu.quantization import jaxmaps

import quflow_tpu_torch as qt
from quflow_tpu_torch.quantization import torchmaps

torch.set_num_threads(1)


@pytest.mark.parametrize("N,lmax", [(17, 5), (33, 10), (64, 16)])
def test_shr2mat_parity(N, lmax):
    rng = np.random.RandomState(N)
    omega = rng.randn((lmax + 1) ** 2)
    W_jax = np.asarray(jaxmaps.build_shr2mat_fn(N, lmax)(omega))
    W = torchmaps.build_shr2mat_fn(N, lmax, device="cpu")(
        torch.from_numpy(omega))
    assert W.dtype == torch.complex128 and W.shape == (N, N)
    np.testing.assert_allclose(W.numpy(), W_jax, atol=1e-12)
    np.testing.assert_allclose(W.numpy(), qt.shr2mat(omega, N=N), atol=1e-12)


@pytest.mark.parametrize("N,lmax", [(17, 5), (33, 10)])
def test_mat2shr_parity(N, lmax):
    rng = np.random.RandomState(N + 1)
    W = qf.shr2mat(rng.randn(N**2), N=N)
    om_jax = np.asarray(jaxmaps.build_mat2shr_fn(N, lmax)(W))
    om = torchmaps.build_mat2shr_fn(N, lmax, device="cpu")(W)
    assert om.dtype == torch.float64
    np.testing.assert_allclose(om.numpy(), om_jax, atol=1e-12)
    np.testing.assert_allclose(om.numpy(), qt.mat2shr(W)[: (lmax + 1) ** 2],
                               atol=1e-12)


def test_basis_tensor_matches():
    """The truncated per-m blocks equal JAX's, built without the full
    basis, and from the full basis when one is cached."""
    from quflow_tpu_torch.quantization.basis import _basis_cache

    B = torchmaps.basis_tensor(21, 6)
    assert (21, np.dtype(np.float64)) not in _basis_cache
    np.testing.assert_array_equal(B, jaxmaps.basis_tensor(21, 6))
    qt.get_basis(19)  # now resident: basis_tensor reuses it
    np.testing.assert_allclose(torchmaps.basis_tensor(19, 4),
                               jaxmaps.basis_tensor(19, 4), atol=1e-13)
    with pytest.raises(ValueError, match="lmax"):
        torchmaps.basis_tensor(8, 8)


def test_roundtrip_and_grad():
    N, lmax = 17, 6
    fn = torchmaps.build_shr2mat_fn(N, lmax, device="cpu")
    gn = torchmaps.build_mat2shr_fn(N, lmax, device="cpu")
    rng = np.random.RandomState(2)
    omega_np = rng.randn((lmax + 1) ** 2)
    omega = torch.from_numpy(omega_np).requires_grad_(True)
    np.testing.assert_allclose(gn(fn(omega)).detach().numpy(), omega_np,
                               atol=1e-12)

    def loss_jax(om):
        return jnp.sum(jnp.abs(jaxmaps.build_shr2mat_fn(N, lmax)(om)) ** 2)

    g_jax = np.asarray(jax.grad(loss_jax)(jnp.asarray(omega_np)))
    (g,) = torch.autograd.grad(torch.sum(fn(omega).abs() ** 2), omega)
    np.testing.assert_allclose(g.numpy(), g_jax, rtol=1e-10)
    # the L2 isometry: d/d om ||T om||^2 = 2 N om
    np.testing.assert_allclose(g.numpy(), 2 * N * omega_np, rtol=1e-10)
    # through mat2shr as well: <gn(W), c> is linear in W
    W = fn(omega).detach().requires_grad_(True)
    c = torch.from_numpy(rng.randn((lmax + 1) ** 2))
    (gW,) = torch.autograd.grad((gn(W) * c).sum(), W)
    assert gW.shape == (N, N) and torch.isfinite(gW.abs()).all()


def test_vmap_batched():
    """A leading batch axis takes the place of jax.vmap: each member equal
    to JAX's vmapped map and to the host transform."""
    N, lmax = 17, 4
    rng = np.random.RandomState(3)
    oms = rng.randn(5, (lmax + 1) ** 2)
    Ws_jax = np.asarray(jax.vmap(jaxmaps.build_shr2mat_fn(N, lmax))(
        jnp.asarray(oms)))
    Ws = torchmaps.build_shr2mat_fn(N, lmax, device="cpu")(
        torch.from_numpy(oms))
    assert Ws.shape == (5, N, N)
    np.testing.assert_allclose(Ws.numpy(), Ws_jax, atol=1e-12)
    np.testing.assert_allclose(Ws[2].numpy(), qf.shr2mat(oms[2], N=N),
                               atol=1e-12)
    back_jax = np.asarray(jax.vmap(jaxmaps.build_mat2shr_fn(N, lmax))(
        jnp.asarray(Ws_jax)))
    back = torchmaps.build_mat2shr_fn(N, lmax, device="cpu")(Ws)
    assert back.shape == (5, (lmax + 1) ** 2)
    np.testing.assert_allclose(back.numpy(), back_jax, atol=1e-12)
    np.testing.assert_allclose(back.numpy(), oms, atol=1e-12)


def test_complex64_and_default_device(monkeypatch):
    """complex64 maps run in float32 within 1e-5 of the complex128 ones;
    without device= the maps want the card."""
    N, lmax = 17, 5
    omega = np.random.RandomState(4).randn((lmax + 1) ** 2)
    W64 = torchmaps.build_shr2mat_fn(N, lmax, np.complex64, device="cpu")(
        omega)
    assert W64.dtype == torch.complex64
    W = qf.shr2mat(omega, N=N)
    assert np.abs(W64.numpy() - W).max() <= 1e-5 * np.abs(W).max()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        torchmaps.build_shr2mat_fn(N, lmax)
