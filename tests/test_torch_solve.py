"""quflow_tpu_torch's shear Poisson solve against quflow_tpu: bit-equal
host factors, the plain Thomas version against the Pallas kernels it
replaces (interpret mode), the kernel wrapper's dispatch, and the Poisson
core.  The kernel itself runs only on a CUDA device (marked ``cuda``)."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from quflow_tpu.ops import tridiag as jtri
from quflow_tpu.ops.pallas_solve import _solve_T, _solve_T_chunked, pad_cols
from quflow_tpu.parallel import stepper as jst

from quflow_tpu_torch.ops import cuda_build, cuda_solve
from quflow_tpu_torch.ops import tridiag as ttri
from quflow_tpu_torch.ops.cuda_solve import shear_thomas, shear_thomas_reference
from quflow_tpu_torch.parallel import stepper as tst

torch.set_num_threads(1)

NS = [8, 16, 33, 48, 64]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rand_skewh(N, seed, dtype=np.complex128):
    rng = np.random.RandomState(seed)
    W = rng.randn(N, N) + 1j * rng.randn(N, N)
    W = W - W.conj().T
    return (W - np.eye(N) * np.trace(W) / N).astype(dtype)


@pytest.mark.parametrize("N", NS)
def test_host_builders_bit_equal(N):
    np.testing.assert_array_equal(ttri.shear_laplacian(N, bc=True),
                                  jtri.shear_laplacian(N, bc=True))
    for a, b in zip(ttri._shear_slots(N), jtri._shear_slots(N)):
        np.testing.assert_array_equal(a, b)
    for kind, params in (("poisson", ()), ("heat", (0.01,)),
                         ("helmholtz", (0.2,)),
                         ("viscdamp", (0.1, 1e-3, 0.01, 0.5)),
                         ("globalqg", (2.0,))):
        np.testing.assert_array_equal(ttri.shear_operator(N, kind, params),
                                      jtri.shear_operator(N, kind, params))
    fa = ttri.TridiagFactors(ttri.shear_laplacian(N, bc=True))
    fb = jtri.TridiagFactors(jtri.shear_laplacian(N, bc=True))
    for name in ("w", "binv", "u", "op"):
        np.testing.assert_array_equal(getattr(fa, name), getattr(fb, name))
    for a, b in zip(ttri._m0_semisep(N), jtri._m0_semisep(N)):
        assert a.dtype == np.float32  # float32 for every solve dtype
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tst._shear_factors_cached(N), jst._shear_factors_cached(N)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
@pytest.mark.parametrize("N", NS)
def test_factors_from_numpy_bit_equal(N, dtype):
    """The JAX package's host factors, carried into the port, equal both
    the JAX stepper's cast factors and the port's own builders."""
    rd = np.zeros(1, dtype).real.dtype
    jw, jb, ju, jop = jst._real_factors(N, rd, with_op=True, shear=True,
                                        device=False)
    got = tst.factors_from_numpy(*jst._shear_factors_cached(N), device="cpu",
                                 dtype=dtype)
    own = tst._real_factors(N, dtype, device="cpu", with_op=True)
    for g, o, ref in zip(got, own, (jw, jb, ju, jop)):
        np.testing.assert_array_equal(g.numpy(), ref)
        np.testing.assert_array_equal(o.numpy(), ref)
        assert g.dtype == o.dtype


def _planes_case(N, tile, seed):
    """Factors and rhs in the Pallas kernels' planes layout (C=2, N, Rp),
    and the same rhs as the port's complex (N, M) shear array."""
    w, binv, u, _ = jst._shear_factors_cached(N)
    M = N + 1
    pad = pad_cols(M, tile)

    def padf(f, fill):
        return np.concatenate([f, np.full((N, pad), fill)], axis=1)

    rng = np.random.RandomState(seed)
    d = rng.randn(2, N, M)
    planes = np.concatenate([d, np.zeros((2, N, pad))], axis=2)
    args = [jnp.asarray(a) for a in (padf(w, 0.0), padf(binv, 1.0),
                                     padf(u, 0.0), planes)]
    tw, tb, tu = (torch.from_numpy(a) for a in (w, binv, u))
    return args, (tw, tb, tu, torch.from_numpy(d[0] + 1j * d[1])), M


@pytest.mark.parametrize("N,chunk", [(64, 16), (128, 32), (256, 64)])
def test_reference_matches_pallas_chunked(N, chunk):
    """K1 (_solve_T_chunked, the TPU path at N >= 4096) in interpret mode
    against the plain version of the kernel that replaces it."""
    args, targs, M = _planes_case(N, 128, seed=N)
    xj = np.asarray(_solve_T_chunked(*args, tile=128, chunk=chunk,
                                     interpret=True))
    xt = shear_thomas_reference(*targs).numpy()
    np.testing.assert_allclose(xt, xj[0, :, :M] + 1j * xj[1, :, :M],
                               atol=1e-11)


@pytest.mark.parametrize("N", [64, 128])
def test_reference_matches_pallas_monolithic(N):
    """K2 (_solve_T, whole column block resident) in interpret mode."""
    args, targs, M = _planes_case(N, 128, seed=N + 1)
    xj = np.asarray(_solve_T(*args, tile=128, interpret=True))
    xt = shear_thomas_reference(*targs).numpy()
    np.testing.assert_allclose(xt, xj[0, :, :M] + 1j * xj[1, :, :M],
                               atol=1e-11)


def test_wrapper_takes_plain_version_on_cpu():
    """On a CPU tensor the wrapper runs the plain version and counts no
    launch; it checks its inputs on every device."""
    N = 16
    w, binv, u = tst._real_factors(N, np.complex128, device="cpu")
    d = torch.from_numpy(np.random.RandomState(0).randn(3, N, N + 1)
                         + 1j * np.random.RandomState(1).randn(3, N, N + 1))
    before = shear_thomas.launches
    np.testing.assert_array_equal(shear_thomas(w, binv, u, d).numpy(),
                                  shear_thomas_reference(w, binv, u, d).numpy())
    assert shear_thomas.launches == before
    # a real rhs is the real-lane entry's: each lane its own system, here
    # the real part of the complex solve
    dr = d.real.contiguous()
    np.testing.assert_array_equal(shear_thomas(w, binv, u, dr).numpy(),
                                  shear_thomas_reference(w, binv, u, d)
                                  .real.numpy())
    assert shear_thomas.real_launches == 0
    with pytest.raises(TypeError, match="complex"):
        shear_thomas(w, binv, u, dr.to(torch.int64))
    with pytest.raises(ValueError, match="binv"):
        shear_thomas(w, binv.float(), u, d)
    with pytest.raises(ValueError, match="u must be"):
        shear_thomas(w, binv, u[:, :-1], d)
    # no silent fallback: a device without the kernel raises
    meta = [t.to("meta") for t in (w, binv, u, d)]
    with pytest.raises(ValueError, match="no kernel for device meta"):
        shear_thomas(*meta)


def test_build_command(monkeypatch, tmp_path):
    """The kernel library is built for sm_90a from the package's own
    source, into quflow_tpu_torch/_build, keyed on the source's hash."""
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text("")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    lib = cuda_solve.LIBRARY
    out = lib.library_path()
    cmd = lib.nvcc_command(out)
    assert cmd[0] == str(nvcc)
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert cmd[-1] == str(lib.source) and lib.source.exists()
    assert lib.source.name == "shear_thomas.cu"
    assert out.parent == cuda_build.BUILD_DIR
    assert out.parent.parent.name == "quflow_tpu_torch"


@pytest.mark.parametrize("N", NS)
def test_poisson_core_c128_matches(N):
    """The c128 core against build_poisson_fn(layout='shear') - the
    tests/test_shear_layout.py:66-78 contract - single and batched."""
    W = _rand_skewh(N, seed=N)
    ref = np.asarray(jst.build_poisson_fn(N, np.complex128, planes_io=False,
                                          layout="shear")(jnp.asarray(W)))
    fn = tst.build_poisson_fn(N, np.complex128, device="cpu")
    np.testing.assert_allclose(fn(torch.from_numpy(W)).numpy(), ref,
                               atol=1e-12)
    Wb = np.stack([W, _rand_skewh(N, seed=N + 7)])
    refb = np.asarray(jst.build_poisson_fn(N, np.complex128, planes_io=False,
                                           layout="shear")(jnp.asarray(Wb)))
    np.testing.assert_allclose(fn(torch.from_numpy(Wb)).numpy(), refb,
                               atol=1e-12)


@pytest.mark.parametrize("refine", ["m0", 1])
@pytest.mark.parametrize("N", NS)
def test_poisson_core_c64_refined_matches(N, refine):
    """complex64 with the m0 (and full) float64-residual refinement against
    the JAX core at 5e-5 relative: JAX's associative scan and the serial
    Thomas solve round differently in float32."""
    W = _rand_skewh(N, seed=2 * N, dtype=np.complex64)
    jw, jb, ju, jop = jst._real_factors(N, np.float32, with_op=True,
                                        shear=True)
    core = jax.jit(lambda W: jst._poisson_core(W, jw, jb, ju, layout="shear",
                                               refine=refine, op=jop))
    ref = np.asarray(core(jnp.asarray(W)))
    w, binv, u, op = tst._real_factors(N, np.complex64, device="cpu",
                                       with_op=True)
    got = tst._poisson_core(torch.from_numpy(W), w, binv, u, refine=refine,
                            op=op).numpy()
    assert got.dtype == np.complex64
    assert np.abs(got - ref).max() <= 5e-5 * np.abs(ref).max()


@pytest.mark.parametrize("N", [16, 33])
def test_dot_cols_and_m0_correction_match(N):
    """Both in float64, where the two cumsum orders agree to roundoff."""
    rng = np.random.RandomState(N)
    _, _, _, op = jst._shear_factors_cached(N)
    d = rng.randn(2, N, N + 1)
    dc = d[0] + 1j * d[1]
    np.testing.assert_allclose(
        ttri.dot_cols(torch.from_numpy(op), torch.from_numpy(dc)).numpy(),
        np.asarray(jtri.dot_cols(jnp.asarray(op), jnp.asarray(dc))),
        atol=1e-12)
    x0 = rng.randn(N) + 1j * rng.randn(N)
    d0 = rng.randn(N) + 1j * rng.randn(N)
    main, off = op[0, :, 0], op[1, :, 0]
    got = ttri.m0_correction(torch.from_numpy(x0), torch.from_numpy(d0),
                             torch.from_numpy(main), torch.from_numpy(off))
    ref = np.asarray(jtri.m0_correction(jnp.asarray(x0), jnp.asarray(d0),
                                        jnp.asarray(main), jnp.asarray(off)))
    np.testing.assert_allclose(got.numpy(), ref,
                               atol=1e-12 * np.abs(ref).max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("N", [100, 257, 1024])
@pytest.mark.parametrize("B", [1, 3])
def test_kernel_matches_reference_on_card(cuda, dtype, N, B):
    """The CUDA kernel against its plain version on the card: the same
    roundings in the same order, so bit-equal, at ragged edges too: N not
    a multiple of a ring slot's rows, N+1 not a multiple of a tile's 16
    columns, and three batch entries."""
    w, binv, u = tst._real_factors(N, dtype, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(N + B)
    d = torch.randn(B, N, N + 1, dtype=dtype, device=cuda, generator=g)
    before = shear_thomas.launches
    x = shear_thomas(w, binv, u, d)
    torch.cuda.synchronize()
    assert shear_thomas.launches == before + 1
    torch.testing.assert_close(x, shear_thomas_reference(w, binv, u, d),
                               rtol=0, atol=0)
