"""quflow_tpu_torch's chunked column solve (shear_scan) against the TPU's
blocked-affine-scan kernel K3 (quflow_tpu/ops/pallas_scan_solve.py, in
interpret mode, as tests/test_pallas_scan.py runs it) and against the
serial Thomas solve; the selection of the column solve by
QUFLOW_PALLAS_KERNEL; the shear layouts the builders take.  The kernel
itself runs only on a CUDA device (marked ``cuda``)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from quflow_tpu.ops.diagpack import mat2shear as jmat2shear
from quflow_tpu.ops.pallas_scan_solve import scan_base_cols
from quflow_tpu.ops.tridiag import solve_factored as jsolve_factored
from quflow_tpu.parallel import stepper as jst

from quflow_tpu_torch.ops import (
    cuda_build,
    cuda_scan_solve,
    cuda_solve,
    shear_solve,
)
from quflow_tpu_torch.ops.cuda_scan_solve import (
    chunk_rows,
    shear_scan,
    shear_scan_reference,
)
from quflow_tpu_torch.ops.cuda_solve import shear_thomas, shear_thomas_reference
from quflow_tpu_torch.parallel import stepper as tst

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _skewh(N, seed=0):
    rng = np.random.RandomState(seed)
    W = rng.randn(N, N) + 1j * rng.randn(N, N)
    return W - W.conj().T


def _factors(N, rd=np.float64):
    w, binv, u, _ = jst._shear_factors_cached(N)
    return (w, binv, u), tuple(torch.from_numpy(f.astype(rd))
                               for f in (w, binv, u))


def test_reference_matches_pallas_scan_f64():
    """K3 in interpret mode (N=256, tile 128, chunk 64) against the plain
    version of the kernel that replaces it, on a complex128 shear rhs."""
    N = 256
    jf, tf = _factors(N)
    d = jmat2shear(jnp.asarray(_skewh(N)), tracefree=True)
    xk = np.asarray(scan_base_cols(*jf, tile=128, chunk=64,
                                   interpret=True)(d))
    xt = shear_scan_reference(*tf, torch.from_numpy(np.array(d))).numpy()
    assert np.abs(xt - xk).max() <= 1e-12 * np.abs(xk).max()


def test_reference_f32_error_comparable():
    """In complex64 the plain scan's error against the float64 truth stays
    within 3x that of the JAX XLA float32 solve (the
    tests/test_pallas_scan.py bound for K3 itself)."""
    N = 256
    jf, tf32 = _factors(N, np.float32)
    d64 = jmat2shear(jnp.asarray(_skewh(N, seed=1)), tracefree=True)
    x64 = np.asarray(jsolve_factored(jst._Fac(*jf), d64, axis=-2))
    x32 = np.asarray(jsolve_factored(jst._Fac(*jf),
                                     d64.astype(jnp.complex64), axis=-2))
    d32 = torch.from_numpy(np.asarray(d64).astype(np.complex64))
    xt = shear_scan_reference(*tf32, d32).numpy()
    assert xt.dtype == np.complex64
    scale = np.abs(x64).max()
    assert np.abs(xt - x64).max() / scale < 3 * np.abs(x32 - x64).max() / scale


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("N", [7, 96, 100, 250, 257, 2100])
def test_reference_matches_thomas(N, B):
    """The chunked solve against the serial one in complex128: a single
    short chunk (7), whole chunks (96 = 12*8), a short last chunk
    (100 = 12*8 + 4, 250 = 31*8 + 2, 257 = 28*9 + 5, 2100 = 32*64 + 52
    with the chunks held to 64 rows), and chunk counts that do not divide
    among the 2, 4 or 8 blocks of a cluster (1, 13, 29, 33).  The most
    chunks a column can have, 128 at N=8192, are held on the card
    (benchmarks/torch_column_solve.py, phase ``large``)."""
    _, tf = _factors(N)
    rng = np.random.RandomState(N + B)
    d = torch.from_numpy(rng.randn(B, N, N + 1) + 1j * rng.randn(B, N, N + 1))
    if B == 1:
        d = d[0]
    x = shear_scan(*tf, d)
    ref = shear_thomas_reference(*tf, d)
    assert x.shape == d.shape and x.dtype == d.dtype and x.is_contiguous()
    assert (x - ref).abs().max() <= 1e-12 * ref.abs().max()


def test_chunk_rows():
    """ceil(N / 32) rows, at least 8, at most 64 while that leaves at most
    128 chunks (the kernel's table of summaries); the sizes the tests use
    for a short last chunk do give one."""
    sizes = (7, 96, 100, 250, 257, 512, 1024, 2048, 2100, 4096, 8192, 8193,
             16384)
    assert [chunk_rows(N) for N in sizes] == [8, 8, 8, 8, 9, 16, 32, 64, 64,
                                              64, 64, 65, 128]
    for N in range(1, 20000):
        L = chunk_rows(N)
        assert L >= 8 and -(-N // L) <= 128
        assert L == max(8, -(-N // 32)) or N > 2048
    assert [N % chunk_rows(N) for N in (7, 100, 250, 257, 2100)] == [
        7, 4, 2, 5, 52]
    assert [-(-N // chunk_rows(N)) for N in (7, 100, 257, 2100, 8192)] == [
        1, 13, 29, 33, 128]


def test_wrapper_takes_plain_version_on_cpu():
    """On a CPU tensor the wrapper runs the plain version and counts no
    launch; it checks its inputs on every device and never falls back."""
    N = 20
    _, (w, binv, u) = _factors(N)
    rng = np.random.RandomState(3)
    d = torch.from_numpy(rng.randn(2, N, N + 1) + 1j * rng.randn(2, N, N + 1))
    before = shear_scan.launches
    np.testing.assert_array_equal(
        shear_scan(w, binv, u, d).numpy(),
        shear_scan_reference(w, binv, u, d).numpy())
    assert shear_scan.launches == before
    # a real rhs is the real-lane entry's: the real part of the complex
    # solve, lane for lane
    dr = d.real.contiguous()
    np.testing.assert_array_equal(shear_scan(w, binv, u, dr).numpy(),
                                  shear_scan_reference(w, binv, u, d)
                                  .real.numpy())
    assert shear_scan.real_launches == 0
    with pytest.raises(TypeError, match="complex"):
        shear_scan(w, binv, u, dr.to(torch.int64))
    with pytest.raises(ValueError, match="shear_scan: binv"):
        shear_scan(w, binv.float(), u, d)
    meta = [t.to("meta") for t in (w, binv, u, d)]
    with pytest.raises(ValueError, match="no kernel for device meta"):
        shear_scan(*meta)


def test_column_solver_selection(monkeypatch):
    """An explicit solver wins; else QUFLOW_PALLAS_KERNEL picks the kernel
    when the builder runs, and any other value raises."""
    monkeypatch.delenv("QUFLOW_PALLAS_KERNEL", raising=False)
    assert tst.column_solver() is shear_thomas
    monkeypatch.setenv("QUFLOW_PALLAS_KERNEL", "thomas")
    assert tst.column_solver() is shear_thomas
    monkeypatch.setenv("QUFLOW_PALLAS_KERNEL", "scan")
    assert tst.column_solver() is shear_scan
    monkeypatch.setenv("QUFLOW_PALLAS_KERNEL", "xla")
    assert tst.column_solver(shear_thomas_reference) is shear_thomas_reference
    with pytest.raises(ValueError, match="'thomas' or 'scan'"):
        tst.column_solver()
    for build in (lambda: tst.build_poisson_fn(8, device="cpu"),
                  lambda: tst.build_step_fn(8, 0.1, device="cpu"),
                  lambda: tst.build_mhd_step_fn(8, 0.1, device="cpu"),
                  lambda: tst.IsompTorch(device="cpu"),
                  lambda: tst.MagmpTorch(device="cpu")):
        with pytest.raises(ValueError, match="QUFLOW_PALLAS_KERNEL"):
            build()


def test_builders_solve_through_the_selected_kernel(monkeypatch):
    """Every builder takes its column solve from the selector
    (ops.shear_solve.column_solver), read when it is built: counted
    stand-ins show which one each step runs."""
    calls = []

    def counted(name, fn):
        def solve(w, binv, u, d):
            calls.append(name)
            return fn(w, binv, u, d)
        return solve

    monkeypatch.setattr(shear_solve, "shear_thomas",
                        counted("thomas", shear_thomas_reference))
    monkeypatch.setattr(shear_solve, "shear_scan",
                        counted("scan", shear_scan_reference))
    N, dt = 8, 0.1
    W = torch.from_numpy(_skewh(N)) * 0.1
    S = torch.stack([W, 0.5 * W])
    for kernel in ("thomas", "scan"):
        monkeypatch.setenv("QUFLOW_PALLAS_KERNEL", kernel)
        builds = [
            (tst.build_poisson_fn(N, np.complex128, device="cpu"), (W,), 1),
            (tst.build_step_fn(N, dt, maxit=3, dtype=np.complex128,
                               device="cpu"), (W, W * 0, W * 0), 3),
            (tst.build_mhd_step_fn(N, dt, maxit=2, dtype=np.complex128,
                                   device="cpu"), (S, S * 0, S * 0), 2),
        ]
        isomp = tst.IsompTorch(maxit=4, dtype=np.complex128, device="cpu")
        magmp = tst.MagmpTorch(maxit=5, dtype=np.complex128, device="cpu")
        monkeypatch.delenv("QUFLOW_PALLAS_KERNEL")  # read at build time only
        for fn, args, n in builds:
            calls.clear()
            fn(*args)
            assert calls == [kernel] * n
        for integ, state, n in ((isomp, W, 4), (magmp, S, 5)):
            calls.clear()
            integ(state.numpy().copy(), dt, steps=1)
            assert calls == [kernel] * n


def test_shear_layouts():
    """'shear_pallas' (the JAX package's TPU layout at N >= 4096) is the
    shear path here; the interleaved 'shear_pallas_il' builds everywhere
    and its Poisson solve is the shear one, bit for bit."""
    N = 8
    W = torch.from_numpy(_skewh(N))
    ref = tst.build_poisson_fn(N, np.complex128, device="cpu")(W)
    got = tst.build_poisson_fn(N, np.complex128, device="cpu",
                               layout="shear_pallas")(W)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    tst.build_step_fn(N, 0.1, device="cpu", layout="shear_pallas")
    tst.build_mhd_step_fn(N, 0.1, device="cpu", layout="shear_pallas")
    tst.IsompTorch(device="cpu", layout="shear_pallas")
    tst.MagmpTorch(device="cpu", layout="shear_pallas")
    il = tst.build_poisson_fn(N, np.complex128, device="cpu",
                              layout="shear_pallas_il")(W)
    torch.testing.assert_close(il, ref, rtol=0, atol=0)
    tst.build_step_fn(N, 0.1, device="cpu", layout="shear_pallas_il")
    tst.build_mhd_step_fn(N, 0.1, device="cpu", layout="shear_pallas_il")
    assert tst.IsompTorch(device="cpu",
                          layout="shear_pallas_il").layout == "shear_pallas_il"
    tst.MagmpTorch(device="cpu", layout="shear_pallas_il")


def test_build_all_starts_one_compiler_per_source(monkeypatch, tmp_path):
    """Both kernel libraries build from the package's sources, one nvcc
    each, into the build directory, with the compiler's report beside
    each; a failed compile raises after every compiler has ended."""
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n'
                    'echo "ptxas info: Used 9 registers"\ntouch "$2"\n')
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    libs = [cuda_solve.LIBRARY, cuda_scan_solve.LIBRARY]
    paths = cuda_build.build_all(libs)
    assert [p.name.split("-")[0] for p in paths] == ["shear_thomas",
                                                     "shear_scan"]
    for p in paths:
        assert p.exists() and "Used 9 registers" in \
            p.with_suffix(".log").read_text()
    assert cuda_build.build_all(libs) == paths  # built: nothing to do
    nvcc.write_text("#!/bin/sh\necho broken >&2\nexit 3\n")
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "other")
    with pytest.raises(RuntimeError, match="shear_scan.cu \\(3\\)"):
        cuda_build.build_all(libs)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("N", [1, 7, 100, 257, 1000])
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_kernel_matches_reference_on_card(cuda, dtype, N, B):
    """The CUDA kernel against its plain version on the card, at shapes
    that cross its seams (N below one chunk, a short last chunk, chunks
    that do not fill the cluster's blocks, a ragged last tile of columns):
    the same roundings in the same order, so bit-equal."""
    w, binv, u = tst._real_factors(N, dtype, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(0)
    d = torch.randn(B, N, N + 1, dtype=dtype, device=cuda, generator=g)
    before = shear_scan.launches
    x = shear_scan(w, binv, u, d)
    torch.cuda.synchronize()
    assert shear_scan.launches == before + 1
    torch.testing.assert_close(
        x, shear_scan_reference(w, binv, u, d), rtol=0, atol=0)


@pytest.mark.cuda
def test_refused_launch_raises_on_card(cuda):
    """A launch the kernel refuses (here more chunks than its table of
    summaries holds, or a cluster that asks for more shared memory than a
    block may have) raises from the wrapper's launch and returns no
    tensor."""
    N = 1024
    w, binv, u = tst._real_factors(N, torch.complex64, device=cuda)
    d = torch.zeros(1, N, N + 1, dtype=torch.complex64, device=cuda)
    with pytest.raises(RuntimeError, match="shear_scan launch failed"):
        cuda_solve.launch_solve("shear_scan", cuda_scan_solve.LIBRARY,
                                w, binv, u, d, 1)
    geo = cuda_scan_solve.geometry(1, N, torch.complex64)
    assert geo["cluster_blocks"] in (1, 2, 4, 8)
    assert geo["shared_bytes"] <= 232448 and geo["active_clusters"] >= 1
