"""The 'highest' complex64 product (quflow_tpu_torch/ops/cgemm.py,
csrc/cgemm_tf32x3.cu): every float split into two TF32 numbers and each
real product formed from three passes.  Imports no JAX.

On the CPU: the plain version against float64 products at N in {1024,
513, 256, 100}, batched, broadcast and rectangular, within 1.5x of the
library's complex64 product's error; the split's properties (10 explicit
mantissa bits, |x - big - small| <= 2^-22 |x|, the specials, bit-equal to
a rounding in float64); the batch axes the wrapper hands the kernel; the
wrapper's checks; the launch counter among capture.COUNTERS;
``_make_mm`` on the CPU: 'highest' complex64 still ``torch.matmul``,
bit-equal, and '_karatsuba', 'high' and complex128 untouched.  On a card
(``cuda``): the kernel against its plain version and float64 at those
shapes, the routing of ``_make_mm``, a capture and its replays, the
counter, the checks raising."""

import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from chip_smoke import product_errors as errors  # noqa: E402
from quflow_tpu_torch import tracing  # noqa: E402
from quflow_tpu_torch.ops import cgemm as cg  # noqa: E402
from quflow_tpu_torch.parallel import capture  # noqa: E402
from quflow_tpu_torch.parallel import stepper as tst  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def randn(shape, device="cpu", seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, dtype=torch.complex64, device=device,
                       generator=g)


SHAPES = {
    "N1024": ((1024, 1024), (1024, 1024)),
    "N513": ((513, 513), (513, 513)),
    "N256": ((256, 256), (256, 256)),
    "N100": ((100, 100), (100, 100)),
    "batched": ((4, 100, 100), (4, 100, 100)),
    "broadcast": ((100, 100), (2, 100, 100)),
    "broadcast_size1": ((3, 1, 64, 64), (1, 2, 64, 64)),
    "rectangular": ((37, 100), (100, 513)),
    "rows_tp2": ((256, 513), (513, 513)),
}


# --- the plain version --------------------------------------------------------

@pytest.mark.parametrize("name", list(SHAPES))
def test_reference_against_float64(name):
    """The plain version's error against float64 is within 1.5x of the
    library's complex64 product's, in both measures, and float32-sized."""
    sa, sb = SHAPES[name]
    A, B = randn(sa, seed=1), randn(sb, seed=2)
    C = cg.cgemm_reference(A, B)
    assert C.shape == torch.broadcast_shapes(sa[:-2], sb[:-2]) + (
        sa[-2], sb[-1]) and C.dtype == torch.complex64
    mine, lib = errors(C, A, B), errors(A @ B, A, B)
    assert mine[0] <= 1.5 * lib[0] and mine[1] <= 1.5 * lib[1], (mine, lib)
    assert mine[0] < 1e-6 and mine[1] < 1e-6


def test_cpu_tensors_take_the_plain_version():
    A, B = randn((40, 30), seed=3), randn((2, 30, 20), seed=4)
    assert torch.equal(cg.cgemm(A, B), cg.cgemm_reference(A, B))


def _conjugated(device):
    """Operand pairs with a lazy conjugation (``.conj()``, ``.mH``), each
    with the same pair made whole."""
    A, B = randn((3, 40, 30), device, 9), randn((3, 40, 20), device, 10)
    C = randn((20, 30), device, 11)
    return [((A.mH, B), (A.mH.resolve_conj(), B)),
            ((A.conj(), C.mT), (A.conj().resolve_conj(), C.mT)),
            ((C.mH, B[0].mT), (C.mH.resolve_conj(), B[0].mT))]


def test_lazy_conjugation_resolved():
    """``.conj()`` and ``.mH`` operands give ``a @ b`` of the conjugated
    values, as ``torch.matmul`` does, not of the memory underneath."""
    for (a, b), (x, y) in _conjugated("cpu"):
        assert a.is_conj() or b.is_conj()
        C = cg.cgemm(a, b)
        assert torch.equal(C, cg.cgemm_reference(x, y))
        assert (C - a @ b).abs().max().item() <= 1e-5 * (
            a.abs() @ b.abs()).max().item()


def _rounded(x, bits=11):
    """x rounded to ``bits`` significant bits, ties to even, in float64
    (exact for float32 x)."""
    m, e = math.frexp(x)
    return math.ldexp(round(m * 2 ** bits), e - bits)


def test_split_properties():
    rng = np.random.default_rng(5)
    x = (rng.standard_normal(20000)
         * np.exp2(rng.integers(-100, 100, 20000))).astype(np.float32)
    xt = torch.from_numpy(x)
    big, small = cg.split_tf32(xt)
    for part in (big, small):
        # at most 10 explicit mantissa bits: the 13 low bits are zero
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
    x64 = xt.double()
    rest = (x64 - big.double() - small.double()).abs()
    assert bool((rest <= 2.0 ** -22 * x64.abs()).all())
    assert bool((small.double().abs() <= 2.0 ** -11 * x64.abs()).all())
    for xi, bi in zip(x[:500].tolist(), big[:500].tolist()):
        assert bi == _rounded(xi)


def test_split_specials():
    fmax = float(np.finfo(np.float32).max)
    x = torch.tensor([0.0, -0.0, math.inf, -math.inf, math.nan, fmax, -fmax,
                      1.0 + 2 ** -11, 1.0 + 3 * 2 ** -12])
    big, small = cg.split_tf32(x)
    assert big[:2].tolist() == [0.0, 0.0] and small[:4].tolist() == [0.0] * 4
    assert big[2] == math.inf and big[3] == -math.inf and bool(big[4].isnan())
    assert small[4] == 0.0
    # the largest floats would round to inf: cut instead, the rest kept
    assert bool(torch.isfinite(big[5:7]).all())
    rest = x[5:7].double() - big[5:7].double() - small[5:7].double()
    assert bool((rest.abs() <= 2.0 ** -22 * fmax).all())
    # ties to even: 1 + 2^-11 lies halfway and goes down, 1 + 3 2^-12 up
    assert big[7] == 1.0 and small[7] == 2 ** -11
    assert big[8] == 1.0 + 2 ** -10 and small[8] == -(2 ** -12)
    with pytest.raises(TypeError):
        cg.split_tf32(x.double())


# --- what the wrapper hands the kernel ---------------------------------------

def test_scratch_bytes():
    assert cg.scratch_bytes(1024, 1024, 1024) == 32 << 20
    # ragged edges are whole zero-padded tiles
    assert cg.scratch_bytes(100, 100, 100) == (2 * 4 * cg.A_TILE
                                               + 1 * 4 * cg.B_TILE)
    assert cg.scratch_bytes(64, 128, 32, 3, 2) == 3 * cg.A_TILE + 2 * cg.B_TILE


@pytest.mark.parametrize("case", [
    # (a shape, b shape, merged dims, A's index, B's index)
    ((8, 8), (8, 8), [1, 1, 1, 1], [0, 0, 0, 0], [0, 0, 0, 0]),
    ((16, 8, 8), (16, 8, 8), [1, 1, 1, 16], [0, 0, 0, 1], [0, 0, 0, 1]),
    ((8, 8), (2, 8, 8), [1, 1, 1, 2], [0, 0, 0, 0], [0, 0, 0, 1]),
    ((4, 1, 8, 8), (4, 2, 8, 8), [1, 1, 4, 2], [0, 0, 1, 0], [0, 0, 2, 1]),
    ((3, 1, 8, 8), (1, 2, 8, 8), [1, 1, 3, 2], [0, 0, 1, 0], [0, 0, 0, 1]),
    ((2, 3, 4, 8, 8), (2, 3, 4, 8, 8), [1, 1, 1, 24], [0, 0, 0, 1],
     [0, 0, 0, 1]),
])
def test_batch_axes(case):
    sa, sb, dims, ia, ib = case
    a, b = torch.zeros(sa), torch.zeros(sb)
    batch = torch.broadcast_shapes(sa[:-2], sb[:-2])
    _, xa = cg._own(a, batch)
    _, xb = cg._own(b, batch)
    assert cg._batch_dims(batch, xa, xb) == (dims, ia, ib)


def test_batch_axes_of_a_stride0_operand():
    """An expanded operand is split once: its stride-0 axis broadcasts."""
    a = torch.zeros(8, 8).expand(5, 8, 8)
    x, index = cg._own(a, (5,))
    assert tuple(x.shape) == (1, 8, 8) and index == [0]


def test_batch_axes_that_alternate_are_too_many():
    batch = (2,) * 6
    ia = [1 if d % 2 else 0 for d in range(6)]
    ib = [0 if d % 2 else 1 for d in range(6)]
    assert cg._batch_dims(batch, ia, ib) is None


def test_wrapper_checks():
    A = randn((8, 8))
    with pytest.raises(TypeError):
        cg.cgemm(A.to(torch.complex128), A.to(torch.complex128))
    with pytest.raises(TypeError):
        cg.cgemm(A.real, A.real)
    with pytest.raises(ValueError):
        cg.cgemm(A, randn((7, 8)))
    with pytest.raises(ValueError):
        cg.cgemm(A[0], A)
    with pytest.raises(ValueError):
        cg.cgemm(A, A.to("meta"))
    with pytest.raises(ValueError):
        cg.cgemm(A.to("meta"), A.to("meta"))
    with pytest.raises(ValueError):
        cg.cgemm(randn((3, 8, 8)), randn((2, 8, 8)))


@pytest.mark.parametrize("x, y", [((), ()), ((4,), ()), ((3, 1), (1, 2)),
                                  ((2, 1, 5), (4, 1)), ((0,), (1,)),
                                  ((1,), (0,))])
def test_batch_broadcasts_as_torch(x, y):
    assert cg._batch(x, y) == tuple(torch.broadcast_shapes(x, y))


def test_first_product_imports_nothing_heavy():
    """The wrapper's shape work imports no new module (torch's own
    broadcast_shapes pulls in sympy, seconds of a run's set-up)."""
    import subprocess
    import sys
    code = ("import sys, torch\n"
            "from quflow_tpu_torch.ops import cgemm as cg\n"
            "a = torch.zeros(2, 1, 8, 8, dtype=torch.complex64)\n"
            "b = torch.zeros(3, 8, 8, dtype=torch.complex64).expand(3, 8, 8)\n"
            "n = len(sys.modules)\n"
            "batch = cg._check(a, b)\n"
            "x, ia = cg._own(a, batch)\n"
            "y, ib = cg._own(b, batch)\n"
            "cg._batch_dims(batch, ia, ib)\n"
            "print(len(sys.modules) - n, 'sympy' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True).stdout.split()
    assert out == ["0", "False"]


def test_counter_among_the_capture_counters():
    assert (cg.cgemm, "launches") in capture.COUNTERS
    assert cg.cgemm in capture.KERNELS
    assert "cgemm.launches" in tracing.counters()


# --- the routing of _make_mm on the CPU ---------------------------------------

def test_make_mm_highest_c64_on_cpu_is_torch_matmul():
    A, B = randn((64, 64), seed=6), randn((3, 64, 64), seed=7)
    before = cg.cgemm.launches
    mm = tst._make_mm("highest", np.complex64)
    assert torch.equal(mm(A, B), torch.matmul(A, B))
    assert cg.cgemm.launches == before


@pytest.mark.parametrize("name", ["high", "default", "highest_karatsuba",
                                  "high_karatsuba"])
def test_make_mm_other_names_untouched_on_cpu(name):
    A, B = randn((48, 48), seed=8), randn((48, 48), seed=9)
    before = cg.cgemm.launches
    got = tst._make_mm(name, np.complex64)(A, B)
    want = (tst._karatsuba(torch.matmul)(A, B) if name.endswith("_karatsuba")
            else torch.matmul(A, B))
    assert torch.equal(got, want)
    assert cg.cgemm.launches == before


def test_make_mm_complex128_untouched():
    assert tst._make_mm("highest", np.complex128) is torch.matmul
    A = randn((32, 32)).to(torch.complex128)
    assert torch.equal(tst._make_mm("high", np.complex128)(A, A), A @ A)


# --- on the card ---------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SHAPES) + ["N1024_batch16"])
def test_kernel_matches_plain_and_float64_on_card(cuda, name):
    """The kernel within 2^-20 max|A||B| of its plain version (the same
    passes summed in another order), and within 1.5x of cuBLAS's complex64
    product's error against float64 in both measures."""
    sa, sb = SHAPES.get(name, ((16, 1024, 1024), (16, 1024, 1024)))
    A, B = randn(sa, cuda, 1), randn(sb, cuda, 2)
    C = cg.cgemm(A, B)
    plain = cg.cgemm_reference(A, B)
    scale = (A.abs() @ B.abs()).max().item()
    assert (C - plain).abs().max().item() <= 2.0 ** -20 * scale
    mine, lib = errors(C, A, B), errors(A @ B, A, B)
    assert mine[0] <= 1.5 * lib[0] and mine[1] <= 1.5 * lib[1], (mine, lib)


@pytest.mark.cuda
def test_kernel_takes_strided_and_broadcast_batches_on_card(cuda):
    """MHD's shapes: P[..., None, :, :] @ S, and Theta = S[:, 1] of a
    batched state (a batch stride of 2 N^2); an expanded operand; a
    column-major B."""
    S, P = randn((3, 2, 130, 130), cuda, 3), randn((3, 130, 130), cuda, 4)
    cases = ((P[:, None], S), (P, S[:, 1]), (S[:, 1], P),
             (P[0].expand(3, 130, 130), S[:, 0]), (P[0], P[1].mT))
    for A, B in cases:
        scale = (A.abs() @ B.abs()).max().item()
        diff = (cg.cgemm(A, B) - cg.cgemm_reference(A, B)).abs().max()
        assert diff.item() <= 2.0 ** -20 * scale


@pytest.mark.cuda
def test_lazy_conjugation_resolved_on_card(cuda):
    for (a, b), (x, y) in _conjugated(cuda):
        C = cg.cgemm(a, b)
        assert torch.equal(C, cg.cgemm(x, y))
        scale = (x.abs() @ y.abs()).max().item()
        diff = (C - cg.cgemm_reference(x, y)).abs().max()
        assert diff.item() <= 2.0 ** -20 * scale


@pytest.mark.cuda
def test_make_mm_highest_runs_the_kernel_on_card(cuda):
    A, B = randn((256, 256), cuda, 5), randn((256, 256), cuda, 6)
    before = cg.cgemm.launches
    C = tst._make_mm("highest", np.complex64)(A, B)
    assert cg.cgemm.launches == before + 1
    assert torch.equal(C, cg.cgemm(A, B))
    # '_karatsuba' and complex128 stay with the library
    tst._make_mm("highest_karatsuba", np.complex64)(A, B)
    A2 = A.to(torch.complex128)
    tst._make_mm("highest", np.complex128)(A2, A2)
    assert cg.cgemm.launches == before + 2


@pytest.mark.cuda
def test_kernel_captured_and_replayed_on_card(cuda):
    """A capture holds the product: its replays write the eager result into
    the graph's output, and advance ``cgemm.launches`` once each."""
    A, B = randn((2, 300, 300), cuda, 7), randn((300, 300), cuda, 8)
    eager = cg.cgemm(A, B)
    a, b = capture.static_copy(A), capture.static_copy(B)
    out = {}

    def piece():
        out["C"] = cg.cgemm(a, b)

    graphs = capture.Graphs(cuda)
    (graph,) = graphs.capture(piece)
    before = cg.cgemm.launches
    for _ in range(3):
        out["C"].zero_()
        graph.replay()
    torch.cuda.synchronize()
    assert cg.cgemm.launches == before + 3
    assert torch.equal(out["C"], eager)


@pytest.mark.cuda
def test_wrapper_checks_raise_on_card(cuda, monkeypatch):
    A = randn((64, 64), cuda)
    with pytest.raises(TypeError):
        cg.cgemm(A.to(torch.complex128), A.to(torch.complex128))
    with pytest.raises(ValueError):
        cg.cgemm(A, A.cpu())
    with pytest.raises(ValueError):
        cg.cgemm(A, randn((63, 64), cuda))
    # a batch the library refuses: its dims do not multiply to its count
    monkeypatch.setattr(cg, "_batch_dims",
                        lambda *args: ([1, 1, 1, 2], [0] * 4, [0] * 4))
    with pytest.raises(RuntimeError, match="cgemm launch failed"):
        cg.cgemm(A, A)
