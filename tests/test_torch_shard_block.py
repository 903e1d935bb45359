"""The block sweep of the row-sharded shear solve (ops/cuda_block_solve.py):
its plain version with the row blocks of tp ranks folded in one process,
as the ranks fold them (parallel/shard_shear.solve_shear_blocks), against
the unsharded plain Thomas solve and against quflow_tpu's
solve_shear_sharded on the 8-device CPU mesh; the edges (uneven blocks,
one-row blocks, a batch); the phases' contract; and, on a card (marked
``cuda``), the kernel against its plain version, bit for bit.

Tolerances, relative to the largest entry: complex128 1e-13 (the fold of
the carries rounds where the serial chain does not); complex64 5e-5, as
tests/test_torch_solve.py holds the complex64 solve against JAX's.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from quflow_tpu.parallel import make_mesh
from quflow_tpu.parallel import shard_shear as jss
from quflow_tpu.parallel import stepper as jst

from quflow_tpu_torch.ops import cuda_block_solve
from quflow_tpu_torch.ops.cuda_block_solve import (
    BACKWARD,
    FORWARD,
    SUMMARY,
    shear_block,
    shear_block_reference,
)
from quflow_tpu_torch.ops.cuda_solve import shear_thomas_reference
from quflow_tpu_torch.parallel import stepper as tst
from quflow_tpu_torch.parallel.mesh import row_blocks
from quflow_tpu_torch.parallel.shard_shear import solve_shear_blocks

torch.set_num_threads(1)

TOL = {torch.complex64: 5e-5, torch.complex128: 1e-13}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rhs(N, B, dtype, seed=0, device="cpu"):
    g = torch.Generator(device=device).manual_seed(1000 * N + B + seed)
    return torch.randn(B, N, N + 1, dtype=dtype, device=device, generator=g)


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max()).item()


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("N,tp,B", [
    (16, 2, 1),   # even blocks
    (13, 4, 3),   # uneven: rows 4, 3, 3, 3; a batch
    (10, 3, 2),   # uneven: rows 4, 3, 3
    (7, 7, 1),    # one row a block
    (9, 8, 2),    # one row a block but the first (2 rows)
    (33, 5, 1),
])
def test_blocks_fold_to_the_unsharded_solve(dtype, N, tp, B):
    w, binv, u = tst._real_factors(N, dtype, device="cpu")
    D = _rhs(N, B, dtype)
    x = solve_shear_blocks(w, binv, u, D, tp, shear_block_reference)
    assert x.shape == D.shape and x.dtype == dtype
    assert _rel(x, shear_thomas_reference(w, binv, u, D)) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_two_blocks_are_the_serial_chain(dtype):
    """With two blocks the second rank's carry is the first block's end
    row, unrounded by any fold: the result equals the serial solve bit for
    bit."""
    N = 16
    w, binv, u = tst._real_factors(N, dtype, device="cpu")
    D = _rhs(N, 2, dtype)
    x = solve_shear_blocks(w, binv, u, D, 2, shear_block_reference)
    assert torch.equal(x, shear_thomas_reference(w, binv, u, D))


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_blocks_match_quflow_tpu_sharded_solve(tp, dtype):
    """Against quflow_tpu's distributed associative scan on the CPU mesh
    of the conftest (tp of its 8 devices), the same factors and rhs."""
    N = 16
    rd = np.float32 if dtype == np.complex64 else np.float64
    rng = np.random.RandomState(tp)
    D = (rng.randn(2, N, N + 1) + 1j * rng.randn(2, N, N + 1)).astype(dtype)
    jw, jb, ju = jst._real_factors(N, rd, shear=True)
    mesh = make_mesh(jax.devices()[:tp], dp=1)
    ref = np.asarray(jss.solve_shear_sharded(jw, jb, ju, jnp.asarray(D), mesh,
                                             batched=True))
    w, binv, u = tst._real_factors(N, dtype, device="cpu")
    x = solve_shear_blocks(w, binv, u, torch.from_numpy(D), tp,
                           shear_block_reference).numpy()
    tol = TOL[torch.complex64 if dtype == np.complex64 else torch.complex128]
    assert np.abs(x - ref).max() <= tol * np.abs(ref).max()


def test_phases_contract():
    """What each phase returns, and the checks: a carry where the phase
    takes one, factors of the block's shape, a known phase.  The wrapper
    on a CPU tensor is its plain version and counts no launch."""
    N, dtype = 12, torch.complex128
    w, binv, u = tst._real_factors(N, dtype, device="cpu")
    a, b = row_blocks(N, 3)[1]
    fac = (w[a:b], binv[a:b], u[a:b])
    D = _rhs(N, 2, dtype)[:, a:b].contiguous()
    carry = torch.ones(2, N + 1, dtype=dtype)
    before = shear_block.launches
    none, y_end = shear_block(SUMMARY, *fac, D)
    assert none is None and y_end.shape == (2, N + 1)
    y, x_end = shear_block(FORWARD, *fac, D, carry)
    assert y.shape == D.shape and x_end.shape == (2, N + 1)
    x, none = shear_block(BACKWARD, *fac, y, carry)
    assert x.shape == D.shape and none is None
    assert shear_block.launches == before
    # a zero-carry forward sweep ends where the summary does
    y0, _ = shear_block(FORWARD, *fac, D, torch.zeros_like(carry))
    assert torch.equal(y0[:, -1], y_end)
    with pytest.raises(ValueError, match="carry"):
        shear_block(FORWARD, *fac, D)
    with pytest.raises(ValueError, match="must be"):
        shear_block(SUMMARY, w, binv, u, D)
    with pytest.raises(ValueError, match="phase"):
        shear_block(3, *fac, D, carry)
    with pytest.raises(TypeError, match="complex"):
        shear_block(SUMMARY, *fac, D.real.contiguous())


#: shapes of the card tests, (N, tp, B), that reach each branch of the
#: kernel's geometry: strips of 1, 4 or 8 columns, the last one ragged
#: (M = 101, 258, 1001, 1025, 2049); rows within one ring (R = 1, 34, 65,
#: 512) and rings that wrap (R = 2048); y kept in shared memory and read
#: back (R = 2048); several batch entries a block (B = 3 in blocks of 2,
#: B = 4 in one)
CARD_SHAPES = [(100, 3, 1), (257, 4, 3), (1024, 2, 1), (9, 9, 2),
               (1000, 2, 1), (1024, 2, 4), (2048, 1, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("N,tp,B", CARD_SHAPES)
def test_kernel_matches_reference_on_card(cuda, dtype, N, tp, B):
    """Every phase of the kernel bit-equal to the plain version on the
    card, on uneven and one-row blocks; the folded kernel solve within
    the tolerance of the unsharded plain solve; one launch a phase."""
    w, binv, u = tst._real_factors(N, dtype, device=cuda)
    D = _rhs(N, B, dtype, device=cuda)
    before = shear_block.launches
    x = solve_shear_blocks(w, binv, u, D, tp, shear_block)
    plain = solve_shear_blocks(w, binv, u, D, tp, shear_block_reference)
    torch.cuda.synchronize()
    assert shear_block.launches - before == 3 * tp
    assert torch.equal(x, plain)
    assert _rel(x, shear_thomas_reference(w, binv, u, D)) <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("N,tp,B", CARD_SHAPES)
def test_each_phase_matches_reference_on_card(cuda, dtype, N, tp, B):
    """On every rank's block: SUMMARY's end row, FORWARD's y and end row,
    BACKWARD's x, each bit-equal to the plain version's from the same
    inputs, one launch a phase."""
    w, binv, u = tst._real_factors(N, dtype, device=cuda)
    D = _rhs(N, B, dtype, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(N + B)
    for a, b in row_blocks(N, tp):
        fac = (w[a:b].contiguous(), binv[a:b].contiguous(),
               u[a:b].contiguous())
        d = D[:, a:b].contiguous()
        carry = torch.randn(B, N + 1, dtype=dtype, device=cuda, generator=g)
        before = shear_block.launches
        got = (shear_block(SUMMARY, *fac, d)[1],
               *shear_block(FORWARD, *fac, d, carry),
               shear_block(BACKWARD, *fac, d, carry)[0])
        torch.cuda.synchronize()
        assert shear_block.launches - before == 3
        ref = (shear_block_reference(SUMMARY, *fac, d)[1],
               *shear_block_reference(FORWARD, *fac, d, carry),
               shear_block_reference(BACKWARD, *fac, d, carry)[0])
        for x, y in zip(got, ref):
            assert torch.equal(x, y)


@pytest.mark.cuda
def test_geometry_on_card(cuda):
    """The geometry read from the built library: at N=1024, tp=2, B=1 a
    wave of blocks (at least 128 of the 132 SMs) with y kept in shared
    memory; a block of R = 2048 rows reads y back in complex128; a batch
    of 4 shares a block; every phase's block fits and runs."""
    geo = cuda_block_solve.geometry
    for dtype in (torch.complex64, torch.complex128):
        g = geo(1, 512, 1025, dtype)
        assert set(g) == set(cuda_block_solve.GEOMETRY)
        assert g["blocks"] >= 128 and g["resident_y"] == 1
        assert g["threads"] in (64, 96)  # a computing warp, 1 or 2 copying
        assert g["strip_columns"] * g["batch_block"] <= 32
        assert all(r >= 512 for r in g["ring_rows"])
        assert all(b <= 232448 for b in g["shared_bytes"])
        assert all(n >= 1 for n in g["blocks_per_sm"])
    assert geo(1, 2048, 2049, torch.complex128)["resident_y"] == 0
    assert geo(4, 512, 1025, torch.complex64)["batch_block"] > 1


def test_library_is_built_from_its_source():
    lib = cuda_block_solve.LIBRARY
    assert lib.source.name == "shear_block.cu" and lib.source.exists()
    assert lib.library_path().name.startswith("shear_block-")
