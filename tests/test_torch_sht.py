"""quflow_tpu_torch.ops.sht_torch against quflow_tpu.ops.sht_jax (twins of
tests/test_sht_jax.py) on the same numpy-seeded planes: synthesis and
analysis within 1e-12 of JAX's builders and of the host Gauss-Legendre
transform, in quflow_tpu's planes layout."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import quflow_tpu as qf
from quflow_tpu.ops import sht_jax
from quflow_tpu_torch.ops import sht_torch
from quflow_tpu_torch.ops.sht import shanalysis, shsynthesis

torch.set_num_threads(1)


def _flm(L, seed):
    flm = qf.shr2shc(np.random.RandomState(seed).randn(L * L))
    return flm, np.stack([flm.real, flm.imag])


@pytest.mark.parametrize("L", [16, 33, 64])
def test_synthesis_parity(L):
    flm, planes = _flm(L, L)
    f = sht_torch.build_synthesis_fn(L, device="cpu")(planes)
    assert f.shape == (2, L, 2 * L - 1) and f.dtype == torch.float64
    f_jax = np.asarray(sht_jax.build_synthesis_fn(L)(jnp.asarray(planes)))
    np.testing.assert_allclose(f.numpy(), f_jax, atol=1e-12)
    np.testing.assert_allclose(f[0].numpy(), shsynthesis(flm, L, reality=True),
                               atol=1e-12)
    assert np.abs(f[1].numpy()).max() == 0.0


@pytest.mark.parametrize("L", [16, 33])
def test_analysis_parity(L):
    flm, _ = _flm(L, L + 1)
    f = shsynthesis(flm, L, reality=True)
    planes = np.stack([f, np.zeros_like(f)])
    out = sht_torch.build_analysis_fn(L, device="cpu")(torch.from_numpy(planes))
    assert out.shape == (2, L * L)
    out_jax = np.asarray(sht_jax.build_analysis_fn(L)(jnp.asarray(planes)))
    np.testing.assert_allclose(out.numpy(), out_jax, atol=1e-12)
    got = out[0].numpy() + 1j * out[1].numpy()
    np.testing.assert_allclose(got, shanalysis(f, L, reality=True), atol=1e-12)
    np.testing.assert_allclose(got, flm, atol=1e-11)


@pytest.mark.parametrize("L", [16, 33])
def test_complex_signal_parity(L):
    """reality=False both ways: a complex grid's planes through JAX's and
    the port's builders, and the round trip."""
    rng = np.random.RandomState(L + 2)
    flm = rng.randn(L * L) + 1j * rng.randn(L * L)
    planes = np.stack([flm.real, flm.imag])
    syn = sht_torch.build_synthesis_fn(L, reality=False, device="cpu")
    ana = sht_torch.build_analysis_fn(L, reality=False, device="cpu")
    f = syn(planes)
    np.testing.assert_allclose(f.numpy(), np.asarray(sht_jax.build_synthesis_fn(
        L, reality=False)(jnp.asarray(planes))), atol=1e-12)
    back = ana(f)
    np.testing.assert_allclose(back.numpy(), np.asarray(
        sht_jax.build_analysis_fn(L, reality=False)(jnp.asarray(f.numpy()))),
        atol=1e-12)
    np.testing.assert_allclose(back.numpy(), planes, atol=1e-11)


def test_float32_and_tensor():
    """float32 within 1e-5 of float64 (relative to the largest entry),
    and the legendre tensor equal to JAX's."""
    L = 24
    flm, planes = _flm(L, 5)
    f64 = sht_torch.build_synthesis_fn(L, device="cpu")(planes)
    f32 = sht_torch.build_synthesis_fn(L, np.float32, device="cpu")(planes)
    assert f32.dtype == torch.float32
    assert (f32.double() - f64).abs().max() <= 1e-5 * f64.abs().max()
    T, wq = sht_torch.legendre_tensor(L)
    Tj, wqj = sht_jax.legendre_tensor(L)
    np.testing.assert_array_equal(T, Tj)
    np.testing.assert_array_equal(wq, wqj)
