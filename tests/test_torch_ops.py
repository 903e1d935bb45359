"""quflow_tpu_torch against quflow_tpu: package imports, numpy copies,
geometry and the shear pack.  Inputs come from numpy RandomState and go
through both packages."""

import subprocess
import sys

import numpy as np
import pytest
import torch

import quflow_tpu as qf
from quflow_tpu.ops import diagpack as jdp
from quflow_tpu.ops import geometry as jgeo

import quflow_tpu_torch as qt
from quflow_tpu_torch import config
from quflow_tpu_torch.ops import diagpack as tdp
from quflow_tpu_torch.ops import geometry as tgeo

torch.set_num_threads(1)

NS = [8, 16, 33, 48, 64]


def _rand(N, seed, skewh=True):
    rng = np.random.RandomState(seed)
    W = rng.randn(N, N) + 1j * rng.randn(N, N)
    return W - W.conj().T if skewh else W


def test_imports_without_jax_and_h5py():
    """The port imports where jax and h5py are missing (the card's host
    has no h5py) and never pulls in quflow_tpu."""
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['h5py'] = None\n"
        "import quflow_tpu_torch, quflow_tpu_torch.ops.tridiag\n"
        "import quflow_tpu_torch.ops.cuda_solve, quflow_tpu_torch.sim.solve\n"
        "assert not any(m == 'quflow_tpu' or m.startswith('quflow_tpu.')"
        " for m in sys.modules)\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_config_precision_and_devices():
    """TF32 off for cuBLAS and cuDNN; torch's default dtype untouched."""
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_default_dtype() == torch.float32
    assert config.device("cpu") == torch.device("cpu")
    assert config.torch_dtype(np.complex64) == torch.complex64
    assert config.numpy_dtype(torch.complex128) == np.dtype(np.complex128)


@pytest.mark.parametrize("N", NS)
def test_quantization_copies_match(N):
    """Numpy copies: basis, shr2mat/mat2shr, shr2fun and random_shr give
    the same arrays as quflow_tpu."""
    omega = qf.random_shr(lmax=min(N - 1, 10), seed=N)
    np.testing.assert_array_equal(qt.random_shr(lmax=min(N - 1, 10), seed=N),
                                  omega)
    np.testing.assert_array_equal(qt.get_basis(N), qf.get_basis(N))
    W = qt.shr2mat(omega, N=N)
    np.testing.assert_array_equal(W, qf.shr2mat(omega, N=N))
    np.testing.assert_array_equal(qt.mat2shr(W), qf.mat2shr(W))
    np.testing.assert_array_equal(qt.shr2fun(qt.mat2shr(W)),
                                  qf.shr2fun(qf.mat2shr(W)))


def test_streamed_transform_matches():
    """The streamed band-limited path (N >= 768, no full basis) matches."""
    omega = qf.random_shr(lmax=4, seed=1)
    np.testing.assert_array_equal(qt.shr2mat(omega, N=800),
                                  qf.shr2mat(omega, N=800))


@pytest.mark.parametrize("N", NS)
def test_geometry_matches(N):
    P, W = _rand(N, 1), _rand(N, 2)
    Pt, Wt = torch.from_numpy(P), torch.from_numpy(W)
    assert tgeo.hbar(N) == jgeo.hbar(N)
    np.testing.assert_allclose(tgeo.inner_L2(Pt, Wt).numpy(),
                               np.asarray(jgeo.inner_L2(P, W)), rtol=1e-13)
    np.testing.assert_allclose(tgeo.norm_L2(Wt).numpy(),
                               np.asarray(jgeo.norm_L2(W)), rtol=1e-13)
    np.testing.assert_allclose(tgeo.bracket(Pt, Wt).numpy(),
                               np.asarray(jgeo.bracket(P, W)), atol=1e-12)
    # numpy in, numpy out, as in quflow_tpu
    assert isinstance(tgeo.norm_L2(W), (np.ndarray, np.floating))


@pytest.mark.parametrize("N", NS)
def test_shear_pack_exact(N):
    """mat2shear/shear2mat are exact copies of quflow_tpu's, and the
    trace projection agrees to roundoff."""
    W = _rand(N, 3, skewh=False)
    Wt = torch.from_numpy(W)
    D = tdp.mat2shear(Wt, tracefree=False)
    np.testing.assert_array_equal(
        D.numpy(), np.asarray(jdp.mat2shear(W, tracefree=False)))
    np.testing.assert_array_equal(tdp.shear2mat(D).numpy(), W)
    np.testing.assert_allclose(
        tdp.mat2shear(Wt, tracefree=True).numpy(),
        np.asarray(jdp.mat2shear(W, tracefree=True)), atol=1e-14)
    # leading batch axes pass through
    Wb = np.stack([W, 2 * W])
    np.testing.assert_array_equal(
        tdp.shear2mat(tdp.mat2shear(torch.from_numpy(Wb), tracefree=False))
        .numpy(), Wb)
