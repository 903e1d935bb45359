"""quflow_tpu_torch's solve layouts against quflow_tpu's: the row packs
('wrapped', 'rolls', the skewh pack with pad rows) and the interleaved
shear view, the row factors, the row solve (``row_thomas``) and the
real-lane column solves, ``solve_factored`` on rows and on real rhs, the
m=0 corrections, and the Poisson core, ``build_poisson_fn``,
``build_step_fn``, ``build_mhd_step_fn`` and the integrators in every
layout, each against quflow_tpu's same layout on the same seeded numpy
inputs.

Tolerances are quflow_tpu's own (tests/test_shear_layout.py:82-160,
216-260): 1e-12 for complex128 solves and steps (the row solve here is
serial where quflow_tpu's is an associative scan: the same systems,
rounded in another order), 1e-11 in the MHD 'pallas' twin, 1e-6 in
complex64; the packs are data movement and bit-equal.  The kernels run on
the CPU as their plain versions; the tests marked ``cuda`` hold the
kernels bit-equal to them and the new runners' replays bit-equal to their
eager runs on a card.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quflow_tpu.ops import diagpack as jdp
from quflow_tpu.ops import tridiag as jtri
from quflow_tpu.ops.pallas_scan_solve import scan_base_cols
from quflow_tpu.ops.pallas_solve import pallas_base_cols, solve_factored_pallas
from quflow_tpu.parallel import stepper as jst

from quflow_tpu_torch import config
from quflow_tpu_torch.ops import cuda_row_solve as crs
from quflow_tpu_torch.ops import diagpack as tdp
from quflow_tpu_torch.ops import tridiag as ttri
from quflow_tpu_torch.ops.cuda_row_solve import row_thomas, row_thomas_reference
from quflow_tpu_torch.ops.cuda_scan_solve import shear_scan, shear_scan_reference
from quflow_tpu_torch.ops.cuda_solve import shear_thomas, shear_thomas_reference
from quflow_tpu_torch.ops.shear_solve import row_factors_host
from quflow_tpu_torch.parallel import stepper as tst
from quflow_tpu_torch.parallel.mesh import Mesh

torch.set_num_threads(1)

ROW_LAYOUTS = ["wrapped", "rolls", "pallas", "scatter"]
LAYOUTS = ROW_LAYOUTS + ["shear_pallas_il"]
FAMILIES = [("poisson", ()), ("heat", (0.001,)), ("helmholtz", (0.1,)),
            ("viscdamp", (0.1, 0.01, 0.6, 0.5)), ("globalqg", (0.7,))]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _skewh(N, seed=0, B=None, scale=1.0):
    rng = np.random.RandomState(seed)
    shape = (N, N) if B is None else (B, N, N)
    W = rng.randn(*shape) + 1j * rng.randn(*shape)
    W = W - np.conj(np.swapaxes(W, -1, -2))
    W = W - np.eye(N) * np.trace(W, axis1=-2, axis2=-1)[..., None, None] / N
    return scale * W / np.abs(W).max()


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(
        np.asarray(b)).max()


def _dt(N):
    return 0.25 * (2.0 / np.sqrt(N ** 2 - 1))


# --- packs and factors -------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
@pytest.mark.parametrize("N", [1, 2, 7, 16, 33])
def test_packs_bit_equal(N, dtype):
    """Every row pack and unpack, and the interleaved shear pack, against
    quflow_tpu's with a batch axis: bit-equal (data movement); the trace
    projections to roundoff (sums in another order)."""
    rng = np.random.RandomState(N)
    W = (rng.randn(2, N, N) + 1j * rng.randn(2, N, N)).astype(dtype)
    Wt = torch.from_numpy(W)
    eq = np.testing.assert_array_equal
    R = N // 2 + 1
    for pad in [p for p in (0, 1, 3) if R + p <= N] + [2]:
        d = tdp.mat2diagh(Wt, True, False, pad)
        eq(d.numpy(), np.asarray(jdp.mat2diagh(W, True, False, pad)))
        eq(tdp.diagh2mat(d).numpy(),
           np.asarray(jdp.diagh2mat(jnp.asarray(d.numpy()))))
        if R + pad <= N:
            dr = tdp.mat2diagh_rolls(Wt, False, pad)
            eq(dr.numpy(), np.asarray(jdp.mat2diagh_rolls(W, False, pad)))
            eq(tdp.diagh2mat_rolls(dr).numpy(),
               np.asarray(jdp.diagh2mat_rolls(jnp.asarray(dr.numpy()))))
    V = tdp.mat2wrapped(Wt, tracefree=False)
    eq(V.numpy(), np.asarray(jdp.mat2wrapped(W, tracefree=False)))
    eq(tdp.wrapped2mat(V).numpy(), W)
    D = tdp.mat2shear_interleaved(Wt, tracefree=False)
    eq(D.numpy(), np.asarray(jdp.mat2shear_interleaved(W, tracefree=False)))
    eq(tdp.shear2mat_interleaved(D).numpy(), W)
    eq(tdp.scatter_indices(N, True, 2)[0], jdp.scatter_indices(N, True, 2)[0])
    atol = 1e-14 if dtype == np.complex128 else 1e-6
    for got, ref in (
            (tdp.mat2wrapped(Wt), jdp.mat2wrapped(W)),
            (tdp.mat2diagh(Wt), jdp.mat2diagh(W)),
            (tdp.mat2shear_interleaved(Wt), jdp.mat2shear_interleaved(W))):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=atol)


@pytest.mark.parametrize("kind,params", FAMILIES)
def test_row_factors_bit_equal(kind, params):
    """The row factors of every family, wrapped or skewh with pad rows,
    against quflow_tpu's ``_real_factors_host``, on the host and on the
    device through the stepper's ``_real_factors``."""
    N = 12
    for wrapped, pad in ((True, 0), (False, 0), (False, 3)):
        for rd in (np.float32, np.float64):
            got = row_factors_host(N, rd, pad, True, wrapped, kind, params)
            ref = jst._real_factors_host(N, rd, pad, True, wrapped, False,
                                         kind, params)
            for a, b in zip(got, ref):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
        dev = tst._real_factors(N, np.complex64, device="cpu", with_op=True,
                                kind=kind, params=params,
                                layout="wrapped" if wrapped else "scatter",
                                pad_rows=pad)
        for a, b in zip(dev, jst._real_factors_host(
                N, np.float32, pad, True, wrapped, False, kind, params)):
            np.testing.assert_array_equal(a.numpy(), b)


# --- the solves --------------------------------------------------------------

@pytest.mark.parametrize("N,R", [(32, 17), (64, 64), (100, 51)])
def test_row_reference_matches_pallas_k2(N, R):
    """K2 (_solve_T through solve_factored_pallas, the rows transposed) in
    interpret mode against the plain version of ``row_thomas``."""
    fac = jtri.TridiagFactors(jtri.packed_laplacian(N, nrows=R, bc=True))
    rng = np.random.RandomState(N)
    d = rng.randn(2, R, N)
    xj = np.asarray(solve_factored_pallas(fac.w, fac.binv, fac.u,
                                          jnp.asarray(d), interpret=True))
    tw, tb, tu = (torch.from_numpy(a) for a in (fac.w, fac.binv, fac.u))
    xt = row_thomas_reference(tw, tb, tu, torch.from_numpy(d[0] + 1j * d[1]))
    np.testing.assert_allclose(xt.numpy(), xj[0] + 1j * xj[1], atol=1e-11)
    # a real rhs: each row its own system; the wrapper takes it on the CPU
    xr = row_thomas(tw, tb, tu, torch.from_numpy(d[1]))
    np.testing.assert_allclose(xr.numpy(), xj[1], atol=1e-11)


@pytest.mark.parametrize("sms", [1, 132])
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("N", [1, 2, 7, 100, 257, 511, 514, 1000, 1024, 4096,
                               8192, 16384, 32768])
def test_row_plan(N, dtype, sms):
    """``row_thomas``'s launch plan over batches B in {1, 4, 16, 65535}, the
    packs' row counts R in {N, N//2+1}, with and without y sent through
    the output: a block's shared bytes within the card's 232 448
    and equal to the kernel's layout, blocks that cover every row of every
    batch entry once, a grid within its limits (x < 2^31, y <= 65535),
    chunks of whole 16-byte lines, y resident exactly where one row fits."""
    real = 4 if dtype == torch.complex64 else 8
    row_fits = crs.shared_bytes(1, min(64, -(-N // 4) * 4), True, N,
                                dtype) <= 232448
    # a row fits where its values do, with room left for a small ring
    assert row_fits == (2 * real * N + 4352 <= 232448)
    for B in (1, 4, 16, 65535):
        for R in sorted({N, N // 2 + 1}):
            for through_out in (False, True):
                p = crs.plan(B, R, N, dtype, sms, through_out)
                assert p.shared_bytes == crs.shared_bytes(
                    p.rows, p.chunk, p.resident, N, dtype) <= 232448
                assert 1 <= p.rows <= min(16, R)
                assert p.chunk % 4 == 0 and 4 <= p.chunk <= 256
                gx = -(-R // p.rows)
                assert p.blocks == gx * B and gx < 2 ** 31 and B <= 65535
                starts = range(0, gx * p.rows, p.rows)
                assert all(s < R for s in starts)  # no empty block
                assert [r for s in starts for r in range(s, min(s + p.rows, R))
                        ] == list(range(R))
                assert p.resident == (row_fits and not through_out)
                if p.resident:
                    assert p.shared_bytes >= p.rows * 2 * real * N


def test_row_plan_fills_the_card():
    """At Euler N=1024 complex64 on 132 SMs, both packs' row solves run a
    wave of 4-row blocks with y resident; a batch of 4 runs 16-row blocks."""
    for R, blocks in ((1024, 256), (513, 129)):
        assert crs.plan(1, R, 1024, torch.complex64, 132) == crs.Plan(
            rows=4, chunk=256, resident=True,
            shared_bytes=crs.shared_bytes(4, 256, True, 1024,
                                          torch.complex64),
            blocks=blocks)
    p = crs.plan(4, 1024, 1024, torch.complex64, 132)
    assert (p.rows, p.resident, p.blocks) == (16, True, 256)
    assert not crs.plan(1, 3, 32768, torch.complex64, 132).resident


@pytest.mark.parametrize("kernel", ["thomas", "scan"])
@pytest.mark.parametrize("lanes", ["planes", "interleaved"])
def test_real_lane_references_match_pallas(kernel, lanes):
    """The real-lane plain versions against pallas_base_cols (K1/K2) and
    scan_base_cols (K3) with a real rhs in interpret mode: float planes
    (B = 2, L = N+1) and the interleaved view (L = 2(N+1), factor columns
    duplicated)."""
    N = 64
    w, binv, u = (np.array(a) for a in
                  jst._real_factors(N, np.float64, shear=True))
    if lanes == "interleaved":
        w, binv, u = (np.repeat(a, 2, axis=-1) for a in (w, binv, u))
    rng = np.random.RandomState(5)
    d = rng.randn(2, N, w.shape[-1])
    base = (pallas_base_cols if kernel == "thomas" else scan_base_cols)(
        w, binv, u, interpret=True)
    ref = np.asarray(base(jnp.asarray(d)))
    plain = shear_thomas_reference if kernel == "thomas" else \
        shear_scan_reference
    got = plain(*(torch.from_numpy(a) for a in (w, binv, u, d)))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-11)


@pytest.mark.parametrize("real", [False, True])
@pytest.mark.parametrize("refine", [0, 1])
def test_solve_factored_rows_matches(refine, real):
    """solve_factored along the rows (axis=-1) and on a real rhs, with and
    without a float64 refinement step, against quflow_tpu's: 1e-12 of the
    largest entry in complex128 (a serial solve against an associative
    scan)."""
    N, R = 24, 13
    fac = jtri.TridiagFactors(jtri.packed_laplacian(N, nrows=R, bc=True))
    rng = np.random.RandomState(3)
    d = rng.randn(2, R, N) + (0 if real else 1j * rng.randn(2, R, N))
    ref = np.asarray(jtri.solve_factored(fac, jnp.asarray(d), refine=refine,
                                         op=fac.op))
    got = ttri.solve_factored(fac, torch.from_numpy(d), refine=refine,
                              op=fac.op, axis=-1)
    assert _rel(got.numpy(), ref) <= 1e-12
    # the shear axis with a real rhs
    jw, jb, ju, jop = jst._real_factors(N, np.float64, with_op=True,
                                        shear=True)
    dc = rng.randn(2, N, N + 1)
    refc = np.asarray(jtri.solve_factored(jst._Fac(jw, jb, ju), jnp.asarray(dc),
                                          refine=refine, op=jop, axis=-2))
    gotc = ttri.solve_factored(tst._Fac(*(torch.from_numpy(np.array(a))
                                          for a in (jw, jb, ju))),
                               torch.from_numpy(dc), refine=refine,
                               op=np.asarray(jop))
    assert _rel(gotc.numpy(), refc) <= 1e-12


@pytest.mark.parametrize("kind,params", [("poisson", ()), ("globalqg", (0.7,))])
def test_refine_m0_rows_and_interleaved_match(kind, params):
    """The m=0 correction on row 0 of a row layout (the (R, 2, N) operator)
    and lane by lane on the interleaved view, against quflow_tpu's."""
    N = 24
    rng = np.random.RandomState(11)
    w, binv, u, op = jst._real_factors_host(N, np.float32, 0, True, True,
                                            False, kind, params)
    # a float32 solve and its rhs: the correction is what it is made for
    d = (rng.randn(N, N) + 1j * rng.randn(N, N)).astype(np.complex64)
    x = np.asarray(jtri.solve_factored(jst._Fac(w, binv, u), jnp.asarray(d)))
    ref = np.asarray(jtri.refine_m0(jnp.asarray(x), jnp.asarray(d), op,
                                    axis=-1, ham=(kind, params)))
    got = ttri.refine_m0(torch.from_numpy(x.copy()), torch.from_numpy(d),
                         torch.from_numpy(op), axis=-1, ham=(kind, params))
    assert _rel(got.numpy(), ref) <= 1e-6  # float32 cumsums, another order
    np.testing.assert_array_equal(got.numpy()[1:], x[1:])
    sw, sb, su, sop = jst._real_factors_host(N, np.float32, with_op=True,
                                             shear=True)
    di = rng.randn(2, N, 2 * (N + 1)).astype(np.float32)
    xi = np.asarray(jtri.solve_factored(
        jst._Fac(*(np.repeat(a, 2, axis=-1) for a in (sw, sb, su))),
        jnp.asarray(di), axis=-2))
    ref = np.asarray(jtri.refine_m0_interleaved(jnp.asarray(xi),
                                                jnp.asarray(di), sop))
    got = ttri.refine_m0_interleaved(torch.from_numpy(xi.copy()),
                                     torch.from_numpy(di),
                                     torch.from_numpy(sop))
    assert _rel(got.numpy(), ref) <= 1e-6
    np.testing.assert_array_equal(got.numpy()[..., 2:], xi[..., 2:])


# --- the Poisson core and the builders ---------------------------------------

@pytest.mark.parametrize("refine", [0, "m0", 1])
@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_poisson_core_matches(layout, dtype, refine):
    """_poisson_core in every layout against quflow_tpu's same layout:
    1e-12 of the largest entry in complex128, 1e-6 in complex64 (the
    m=0 correction's cumsums and the solves' order differ)."""
    N = 20
    W = _skewh(N, 5).astype(dtype)
    rd = np.dtype(dtype).type(0).real.dtype
    shear = layout == "shear_pallas_il"
    jw, jb, ju, jop = jst._real_factors(
        N, rd, with_op=True, shear=shear,
        wrapped=layout in ("wrapped", "pallas"))
    ref = np.asarray(jst._poisson_core(jnp.asarray(W), jw, jb, ju,
                                       layout=layout, refine=refine, op=jop))
    w, binv, u, op = tst._real_factors(N, dtype, device="cpu", with_op=True,
                                       layout=layout)
    got = tst._poisson_core(torch.from_numpy(W), w, binv, u, refine=refine,
                            op=op, layout=layout).numpy()
    assert _rel(got, ref) <= (1e-12 if dtype == np.complex128 else 1e-6)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_build_poisson_fn_batched_matches(layout):
    """build_poisson_fn in every layout on an ensemble, planes and
    complex, against quflow_tpu's same layout (1e-12)."""
    N = 16
    Ws = _skewh(N, 2, B=3)
    jf = jst.build_poisson_fn(N, dtype=np.complex128, batched=True,
                              layout=layout)
    ref = np.asarray(jf(jnp.asarray(jst.to_planes(Ws))))
    tf = tst.build_poisson_fn(N, dtype=np.complex128, batched=True,
                              layout=layout, device="cpu", planes_io=True)
    got = tf(tst.to_planes(Ws)).numpy()
    assert _rel(got, ref) <= 1e-12
    one = tst.build_poisson_fn(N, dtype=np.complex128, layout=layout,
                               device="cpu")(torch.from_numpy(Ws[1]))
    np.testing.assert_array_equal(one.numpy(), got[0, 1] + 1j * got[1, 1])


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_step_fn_matches(layout, dtype):
    """build_step_fn in every layout, 5 steps, with diagnostics, against
    quflow_tpu's same layout (and the default refine of the layout:
    'm0' in complex64 except on 'scatter')."""
    N = 16
    W = _skewh(N, 7).astype(dtype)
    kw = dict(steps=5, maxit=5, dtype=dtype, layout=layout,
              with_diagnostics=True)
    jf = jst.build_step_fn(N, _dt(N), planes_io=False, **kw)
    Wj = jnp.asarray(W)
    ref = jf(Wj, jnp.zeros_like(Wj), jnp.zeros_like(Wj))
    tf = tst.build_step_fn(N, _dt(N), device="cpu", **kw)
    Wt = torch.from_numpy(W)
    got = tf(Wt, torch.zeros_like(Wt), torch.zeros_like(Wt))
    tol = 1e-12 if dtype == np.complex128 else 1e-6
    # W, dW and the diagnostics; csum is rounding noise of either package
    for i in (0, 1, 3):
        assert _rel(got[i].numpy(), ref[i]) <= tol


@pytest.mark.parametrize("layout", LAYOUTS)
def test_mhd_step_fn_matches(layout):
    """build_mhd_step_fn in every layout, 5 steps of the two-component
    state, against quflow_tpu's same layout (1e-11, the tolerance of its
    'pallas' twin, tests/test_shear_layout.py:160)."""
    N = 16
    S = np.stack([_skewh(N, 1), _skewh(N, 2, scale=0.1)])
    kw = dict(steps=5, maxit=5, dtype=np.complex128, layout=layout)
    jf = jst.build_mhd_step_fn(N, _dt(N), planes_io=False, **kw)
    Sj = jnp.asarray(S)
    ref = np.asarray(jf(Sj, jnp.zeros_like(Sj), jnp.zeros_like(Sj))[0])
    tf = tst.build_mhd_step_fn(N, _dt(N), device="cpu", **kw)
    St = torch.from_numpy(S)
    got = tf(St, torch.zeros_like(St), torch.zeros_like(St))[0].numpy()
    assert _rel(got, ref) <= 1e-11


HOOKS = {
    "viscdamp_theta": dict(strang_splitting=("viscdamp", {"theta": 0.5,
                                                          "nu": 1e-3})),
    "heat_qg": dict(strang_splitting=("heat", {"nu": 1e-3}),
                    hamiltonian=("globalqg", 0.7)),
    "qg_tol": dict(hamiltonian=("globalqg", 0.7), tol=1e-10, maxit=10),
}


@pytest.mark.parametrize("hook", sorted(HOOKS))
@pytest.mark.parametrize("layout", ["rolls", "pallas"])
def test_hooks_on_row_layouts_match(layout, hook):
    """Named Strang steps (the theta scheme with its Laplacian in the
    layout, heat) and a named family, with tol, batched, on 'rolls' and
    'pallas' against quflow_tpu's same layout."""
    N, B = 12, 2
    W = _skewh(N, 4, B=B)
    kw = {**dict(steps=3, maxit=5, dtype=np.complex128, layout=layout,
                 batched=True), **HOOKS[hook]}
    jf = jst.build_step_fn(N, _dt(N), planes_io=False, **kw)
    Wj = jnp.asarray(W)
    ref = jf(Wj, jnp.zeros_like(Wj), jnp.zeros_like(Wj))
    tf = tst.build_step_fn(N, _dt(N), device="cpu", **kw)
    Wt = torch.from_numpy(W)
    got = tf(Wt, torch.zeros_like(Wt), torch.zeros_like(Wt))
    assert _rel(got[0].numpy(), ref[0]) <= 1e-12
    if "tol" in HOOKS[hook]:
        np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))


@pytest.mark.parametrize("layout", ["rolls", "pallas", "shear_pallas_il"])
def test_integrators_take_the_layout(layout):
    """IsompTorch and MagmpTorch with ``layout=`` against IsompTPU and
    MagmpTPU with the same layout, two calls each."""
    N = 12
    W = _skewh(N, 9)
    S = np.stack([W, _skewh(N, 3, scale=0.05)])
    dt = _dt(N)
    for T, J, X in ((tst.IsompTorch, jst.IsompTPU, W),
                    (tst.MagmpTorch, jst.MagmpTPU, S)):
        t = T(maxit=5, dtype=np.complex128, layout=layout, device="cpu")
        j = J(maxit=5, dtype=np.complex128, layout=layout)
        got = t(t(X.copy(), dt, steps=3), dt, steps=3)
        ref = j(j(X.copy(), dt, steps=3), dt, steps=3)
        assert _rel(got, ref) <= 1e-12


def test_interleave_variable_is_bit_equal(monkeypatch):
    """QUFLOW_SHEAR_INTERLEAVE on 'shear' solves the interleaved real view
    (the real-lane entry), bit-equal to the complex solve, as in
    quflow_tpu (tests/test_shear_layout.py:204-228); it acts when a step
    or solve is built."""
    N = 16
    for dtype in (np.complex64, np.complex128):
        W = torch.from_numpy(_skewh(N, 6).astype(dtype))
        z = torch.zeros_like(W)
        monkeypatch.delenv("QUFLOW_SHEAR_INTERLEAVE", raising=False)
        plain = tst.build_step_fn(N, _dt(N), steps=3, dtype=dtype,
                                  device="cpu")(W, z, z)[0]
        P0 = tst.build_poisson_fn(N, dtype, device="cpu")(W)
        monkeypatch.setenv("QUFLOW_SHEAR_INTERLEAVE", "1")
        il = tst.build_step_fn(N, _dt(N), steps=3, dtype=dtype,
                               device="cpu")(W, z, z)[0]
        P1 = tst.build_poisson_fn(N, dtype, device="cpu")(W)
        for refine in (0, "m0", 1):
            w, binv, u, op = tst._real_factors(N, dtype, device="cpu",
                                               with_op=True)
            a = tst._poisson_core(W, w, binv, u, refine=refine, op=op)
            monkeypatch.setenv("QUFLOW_SHEAR_INTERLEAVE", "0")
            b = tst._poisson_core(W, w, binv, u, refine=refine, op=op)
            monkeypatch.setenv("QUFLOW_SHEAR_INTERLEAVE", "1")
            assert torch.equal(a, b)
        assert torch.equal(il, plain) and torch.equal(P1, P0)


def test_pallas_redirects_to_shear_at_4096():
    """layout='pallas' at N >= 4096 warns and runs the shear layout, as
    quflow_tpu redirects it (tests/test_shear_layout.py:280-294); below,
    the request is honoured silently."""
    with pytest.warns(UserWarning, match="shear_pallas"):
        assert tst._resolve_layout(4096, None, "pallas") == "shear"
    with pytest.warns(UserWarning, match="shear_pallas"):
        assert tst._resolve_layout(8192, None, "pallas") == "shear"
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert tst._resolve_layout(2048, None, "pallas") == "pallas"


def test_mesh_resolutions():
    """Under a mesh the row layouts resolve as quflow_tpu's do ('shard'
    where 'tp' divides N, else 'scatter'), the shear ones to 'shear_shard'
    ('tp' > 1) or stay single-device ('tp' = 1); 'scatter' pads the skewh
    rows to a multiple of 'tp'."""
    for tp in (1, 2, 3, 4):
        mesh = Mesh(dp=1, tp=tp, rank=0, ranks=list(range(tp)))
        for N in (12, 13):
            for layout in ROW_LAYOUTS + ["shard"]:
                got = tst._resolve_layout(N, mesh, layout)
                assert got == ("shard" if N % tp == 0 else "scatter")
            for layout in ("auto", "shear", "shear_pallas", "shear_shard"):
                assert tst._resolve_layout(N, mesh, layout) == (
                    "shear_shard" if tp > 1 else "shear")
            assert tst._mesh_pad_rows(N, mesh, "scatter") == (
                -(N // 2 + 1)) % tp
            assert tst._mesh_pad_rows(N, None, "scatter") == 0
    for layout in ("wrapped", "rolls", "pallas", "scatter",
                   "shear_pallas_il"):
        assert tst._resolve_layout(16, None, layout) == layout
    with pytest.raises(ValueError, match="unknown layout"):
        tst._resolve_layout(16, None, "diagonal")


# --- on the card ---------------------------------------------------------------

def _row_kernel_exact(w, binv, u, d):
    before = row_thomas.launches
    x = row_thomas(w, binv, u, d)
    assert row_thomas.launches == before + 1
    assert torch.equal(x, row_thomas_reference(w, binv, u, d))


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 3, 16])
@pytest.mark.parametrize("N", [1, 6, 7, 100, 257, 514, 1000])
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_row_kernel_matches_reference_on_card(cuda, dtype, N, B):
    """``row_thomas`` against its plain version at R = N and N//2+1 (ragged
    chunks, rows and factor rows off the 16-byte lines at odd N and
    N = 2 mod 4, one-row blocks, batches): bit-equal, one launch a
    solve."""
    for layout in ("wrapped", "rolls"):
        w, binv, u = tst._real_factors(N, dtype, device=cuda, layout=layout)
        g = torch.Generator(device=cuda).manual_seed(N)
        d = torch.randn(B, w.shape[0], N, dtype=dtype, device=cuda,
                        generator=g)
        _row_kernel_exact(w, binv, u, d)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["resident", "through_out"])
@pytest.mark.parametrize("N", [6, 7, 257, 514, 1000])
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_row_kernel_offsets_and_modes_on_card(cuda, monkeypatch, dtype, N,
                                              mode):
    """``row_thomas`` on a d whose storage starts one complex value into
    its buffer (in complex64 a base off the 16-byte lines, so x leaves one
    value aside of y) and on a contiguous one, with y resident and with the
    plan forced to send y through the output: bit-equal, one launch a
    solve."""
    if mode == "through_out":
        plan = crs.plan
        monkeypatch.setattr(crs, "plan",
                            lambda *a, **k: plan(*a, through_out=True))
    for layout in ("wrapped", "rolls"):
        w, binv, u = tst._real_factors(N, dtype, device=cuda, layout=layout)
        R = w.shape[0]
        g = torch.Generator(device=cuda).manual_seed(N)
        buf = torch.randn(3 * R * N + 1, dtype=dtype, device=cuda,
                          generator=g)
        shifted = buf[1:].view(3, R, N)
        assert shifted.is_contiguous()
        _row_kernel_exact(w, binv, u, shifted)
        _row_kernel_exact(w, binv, u, buf[:-1].view(3, R, N))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_row_kernel_long_rows_on_card(cuda, dtype):
    """Rows too long for shared memory (32768 complex64, 16384 complex128
    values): the plan's own rule sends y through the output; bit-equal to
    the plain version on bounded factors."""
    N = 32768 if dtype == torch.complex64 else 16384
    assert not crs.plan(2, 3, N, dtype, crs._sms(cuda.index or 0)).resident
    rd = torch.float32 if dtype == torch.complex64 else torch.float64
    rng = np.random.RandomState(N)
    w, binv, u = (torch.from_numpy(a).to(cuda, rd) for a in (
        rng.uniform(-0.4, 0.4, (3, N)), rng.uniform(0.2, 0.6, (3, N)),
        rng.uniform(-0.4, 0.4, (3, N))))
    d = torch.from_numpy(rng.randn(2, 3, N) + 1j * rng.randn(2, 3, N)).to(
        cuda, dtype)
    _row_kernel_exact(w, binv, u, d)


@pytest.mark.cuda
@pytest.mark.parametrize("B,R,N", [(1, 1024, 1024), (1, 513, 1024),
                                   (4, 1024, 1024), (1, 3, 32768)])
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_row_geometry_reports_the_plan_on_card(cuda, dtype, B, R, N):
    """The built library's own layout of a plan: the same rows, chunk,
    residence, shared bytes and blocks as ``plan``."""
    index = cuda.index or 0
    p = crs.plan(B, R, N, dtype, crs._sms(index))
    geo = crs.geometry(B, R, N, dtype, index)
    assert geo == {**p._asdict(), "resident": int(p.resident),
                   "sms": crs._sms(index)}


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["thomas", "scan"])
@pytest.mark.parametrize("N", [7, 100, 1000])
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_real_lanes_match_on_card(cuda, dtype, N, kernel):
    """The real-lane entries against their plain versions (planes, B = 2),
    and on the interleaved view bit-equal to the complex entry on the same
    bytes; their launches counted apart."""
    fn, plain = ((shear_thomas, shear_thomas_reference) if kernel == "thomas"
                 else (shear_scan, shear_scan_reference))
    w, binv, u = tst._real_factors(N, dtype, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(N)
    d = torch.randn(1, N, N + 1, dtype=dtype, device=cuda, generator=g)
    planes = torch.view_as_real(d)[0].movedim(-1, 0).contiguous()
    before = (fn.launches, fn.real_launches)
    assert torch.equal(fn(w, binv, u, planes), plain(w, binv, u, planes))
    w2, b2, u2 = (f.repeat_interleave(2, dim=-1) for f in (w, binv, u))
    di = torch.view_as_real(d).reshape(1, N, 2 * (N + 1))
    xi = fn(w2, b2, u2, di)
    assert torch.equal(xi, plain(w2, b2, u2, di))
    xc = fn(w, binv, u, d)
    assert torch.equal(xi, torch.view_as_real(xc).reshape(1, N, -1))
    assert (fn.launches, fn.real_launches) == (before[0] + 1, before[1] + 2)


NEW_RUNNERS = {
    "wrapped": (tst.build_step_fn, dict(layout="wrapped"), row_thomas),
    "pallas_theta": (tst.build_step_fn, dict(
        layout="pallas", strang_splitting=("viscdamp", {"theta": 0.5})),
        row_thomas),
    "rolls_tol": (tst.build_step_fn, dict(layout="rolls", tol=1e-6,
                                          maxit=10), row_thomas),
    "scatter_mhd": (tst.build_mhd_step_fn, dict(layout="scatter"),
                    row_thomas),
    "shear_pallas_il": (tst.build_step_fn, dict(layout="shear_pallas_il"),
                        shear_thomas),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(NEW_RUNNERS))
def test_layout_runners_replay_bit_equal_on_card(cuda, name):
    """Each new runner replays (CUDA graphs) bit-equal to its eager twin
    built inside ``config.eager()``, launching its kernel as often."""
    from quflow_tpu_torch.models import EulerFlow, MHDFlow

    build, kw, kernel = NEW_RUNNERS[name]
    n = 64
    flow = (EulerFlow if build is tst.build_step_fn else MHDFlow)(
        n, np.complex64)
    S = torch.from_numpy(flow.random_initial(lmax=6, seed=1)).to(cuda)
    z = torch.zeros_like(S)
    run = build(n, _dt(n), steps=3, device=cuda, **kw)
    with config.eager():
        eager = build(n, _dt(n), steps=3, device=cuda, **kw)
    assert run.captured or run.captured_iteration
    counter = "real_launches" if name == "shear_pallas_il" else "launches"
    a, b = run(S, z, z), eager(S, z, z)
    before = getattr(kernel, counter)
    a = run(*a[:3])
    mid = getattr(kernel, counter)
    b = eager(*b[:3])
    for x, y in zip(a, b):
        assert torch.equal(x, y), name
    assert mid - before == getattr(kernel, counter) - mid > 0


@pytest.mark.cuda
def test_planes_runner_replays_bit_equal_on_card(cuda):
    """build_planes_step_fn replayed against its eager twin: bit-equal,
    one real-lane launch of both planes an iteration."""
    from quflow_tpu_torch.models import EulerFlow

    n = 64
    W = EulerFlow(n, np.complex64).random_initial(lmax=6, seed=1)
    Wp = torch.from_numpy(np.stack([W.real, W.imag])).to(cuda)
    z = torch.zeros_like(Wp)
    run = tst.build_planes_step_fn(n, _dt(n), steps=3, device=cuda)
    with config.eager():
        eager = tst.build_planes_step_fn(n, _dt(n), steps=3, device=cuda)
    assert run.captured and not eager.captured
    a, b = run(Wp, z, z), eager(Wp, z, z)
    before = shear_thomas.real_launches
    a = run(*a)
    assert shear_thomas.real_launches - before == 15
    b = eager(*b)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
