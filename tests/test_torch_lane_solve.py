"""The real-lane column solves' launch plans and kernels.

``ops.cuda_solve.lane_plan`` (``shear_thomas`` on a real rhs) and
``ops.cuda_scan_solve.lane_plan`` (``shear_scan`` on a real rhs) are plain
Python, so the CPU tests hold them to what csrc/shear_thomas.cu and
csrc/shear_scan.cu take: the shared bytes of their layouts, the threads of a
block, one wave where the panels fit, y resident exactly where a tile's rows
fit, a refused shape raising.  The plain versions of both entries are held
against quflow_tpu's ``pallas_base_cols``/``scan_base_cols`` in
tests/test_torch_layouts.py; here, at small N on the CPU, the wrappers run
them on both views and launch nothing.  The tests marked ``cuda``
hold the kernels bit-equal to their plain versions at the plans' edges, on a
d that starts one value into its buffer, with y forced through the output,
and on the interleaved view to the complex entry on the same bytes; and a
plan the library does not take raising.  This file imports nothing of JAX.
"""

import ctypes

import pytest
import torch

from quflow_tpu_torch.ops import cuda_scan_solve as css
from quflow_tpu_torch.ops import cuda_solve as cs
from quflow_tpu_torch.ops.cuda_scan_solve import shear_scan, shear_scan_reference
from quflow_tpu_torch.ops.cuda_solve import shear_thomas, shear_thomas_reference
from quflow_tpu_torch.parallel import stepper as tst

LIMIT = 232448
DTYPES = [torch.float32, torch.float64]
VIEWS = {"planes": lambda N: (2, N + 1), "interleaved": lambda N: (1, 2 * (N + 1))}
PLAN_NS = [1, 2, 7, 15, 16, 17, 100, 512, 1000, 1024, 1025, 1500, 2048, 2049,
           2777, 3000, 4096, 8192, 16384]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def real_of(dtype):
    return 4 if dtype == torch.float32 else 8


# --- shear_thomas's real lanes ---------------------------------------------

@pytest.mark.parametrize("sms", [1, 132])
@pytest.mark.parametrize("view", sorted(VIEWS))
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("N", PLAN_NS)
def test_thomas_lane_plan(N, dtype, view, sms):
    """The plan of every shape, with and without y sent through the output:
    shared bytes within the card's 232 448 and equal to the kernel's layout;
    a tile of 8, 16 or 32 lanes (one chain warp); a
    chunk of whole groups of 16 rows, no longer than N needs; every lane in
    one block of each batch entry; y resident exactly where the tile's rows
    fit beside the shortest ring."""
    B, L = VIEWS[view](N)
    for through_out in (False, True):
        p = cs.lane_plan(B, N, L, dtype, sms, through_out)
        assert p.shared_bytes == cs.lane_shared_bytes(
            p.lanes, p.chunk, p.resident, N, dtype) <= LIMIT
        assert p.lanes in (8, 16, 32)
        assert p.chunk % 16 == 0 and 16 <= p.chunk <= max(16, -(-N // 16) * 16)
        assert p.blocks == -(-L // p.lanes) * B
        fits = cs.lane_shared_bytes(p.lanes, 16, True, N, dtype) <= LIMIT
        assert p.resident == (fits and not through_out)
        if p.resident:
            assert p.shared_bytes >= N * p.lanes * real_of(dtype)


def test_thomas_lane_plan_main_shapes():
    """At N=1024 on 132 SMs: 16-lane tiles with y resident, 130 blocks for
    the float32 planes and 129 for the interleaved view, one a SM: one
    wave; float64 interleaved N=512 resident in one wave; float32 planes
    at N=2048 resident (two waves beat y through the output) and at
    N=4096 through the output."""
    for B, L, blocks in ((2, 1025, 130), (1, 2050, 129)):
        p = cs.lane_plan(B, 1024, L, torch.float32, 132)
        assert (p.lanes, p.resident, p.blocks) == (16, True, blocks)
        assert 2 * (p.shared_bytes + 1024) > cs.SM_SHARED >= p.shared_bytes
    p = cs.lane_plan(1, 512, 1026, torch.float64, 132)
    assert p.resident and p.blocks <= 132
    assert cs.lane_plan(2, 2048, 2049, torch.float32, 132).resident
    assert not cs.lane_plan(2, 4096, 4097, torch.float32, 132).resident


@pytest.mark.parametrize("view", sorted(VIEWS))
@pytest.mark.parametrize("dtype", DTYPES)
def test_thomas_residency_switch(dtype, view):
    """For each dtype and view, y stops being resident at the first N whose
    tile no longer fits beside the shortest ring (4 slots of 2 panels of 16
    rows): below it every plan keeps y; the switch lies between 1024 and
    4096 for float32 and float64 alike, and no later than the last
    resident tile's lanes, N values each, alone would fill the block's
    232 448 bytes."""
    def plan(N):
        B, L = VIEWS[view](N)
        return cs.lane_plan(B, N, L, dtype, 132)
    switch = next(N for N in range(1000, 4097) if not plan(N).resident)
    lanes = plan(switch).lanes
    assert cs.lane_shared_bytes(lanes, 16, True, switch, dtype) > LIMIT
    low = plan(switch - 1)
    assert low.lanes * real_of(dtype) * (switch - 16) <= LIMIT
    assert cs.lane_shared_bytes(low.lanes, 16, True, switch - 1,
                                dtype) <= LIMIT
    assert all(plan(N).resident for N in (1, 7, 100, 512, 1000, switch - 1))
    assert not plan(4096).resident


def test_thomas_lane_plan_refuses():
    """No plan for an empty shape or for more tiles than the grid's 65535
    (8-lane tiles)."""
    for B, N, L in ((0, 8, 9), (1, 0, 1), (1, 8, 0), (1, 8, 8 * 65535 + 1)):
        with pytest.raises(ValueError, match="no plan"):
            cs.lane_plan(B, N, L, torch.float32, 132)


# --- shear_scan's real lanes -----------------------------------------------

@pytest.mark.parametrize("sms", [16, 132])
@pytest.mark.parametrize("view", sorted(VIEWS))
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("N", PLAN_NS)
def test_scan_lane_plan(N, dtype, view, sms):
    """The plan of every shape: shared bytes within 232 448 and equal to
    the kernel's layout; at most 16 chunks and 256 threads a block; the
    cluster's blocks hold every chunk; pairs of entries only for a batch,
    lane pairs only for an even L; clusters sharing a tile's entries no
    more than there are entries; the waves the reckoning counts hold every
    cluster; the plan the first of every launch the reckoning weighed."""
    for B in (VIEWS[view](N)[0], 3):
        L = VIEWS[view](N)[1]
        p = css.lane_plan(B, N, L, dtype, sms)
        assert p == css.lane_plans(B, N, L, dtype, sms)[0]
        K = -(-N // css.chunk_rows(N))
        assert p.shared_bytes == css.lane_shared_bytes(
            N, p.tile, p.block_chunks, p.mode, p.late, dtype) <= LIMIT
        assert p.tile in (1, 2, 4, 8, 16, 32) and p.cluster in (1, 2, 4, 8)
        assert p.block_chunks <= 16 and p.tile * p.block_chunks <= 256
        assert p.cluster * p.block_chunks >= K
        assert p.mode != css.ENTRIES or B >= 2
        assert p.mode != css.LANES or (L % 2 == 0 and dtype == torch.float32)
        columns = L // 2 if p.mode == css.LANES else L
        entries = -(-B // 2) if p.mode == css.ENTRIES else B
        assert 1 <= p.groups <= entries
        assert p.waves * p.active >= -(-columns // p.tile) * p.groups > 0


def test_scan_lane_plan_one_wave():
    """At N=1024 float32 on 132 SMs: the planes in one wave of 65 clusters
    of 2, a thread running both planes' chains (as the complex entry runs
    re and im); the interleaved view in one wave of 65 clusters of 2, a
    thread running a lane pair, binv landing late; float64 interleaved
    N=512 in one wave of single lanes (lane pairs only in float32)."""
    p = css.lane_plan(2, 1024, 1025, torch.float32, 132)
    assert (p.tile, p.cluster, p.block_chunks, p.mode, p.waves) == (
        16, 2, 16, css.ENTRIES, 1)
    assert -(-1025 // p.tile) * p.groups <= p.active == 66
    p = css.lane_plan(1, 1024, 2050, torch.float32, 132)
    assert (p.tile, p.cluster, p.mode, p.late, p.waves) == (
        16, 2, css.LANES, True, 1)
    assert -(-1025 // p.tile) * p.groups <= p.active
    p = css.lane_plan(1, 512, 1026, torch.float64, 132)
    assert (p.mode, p.waves) == (css.SINGLE, 1)
    assert all(q.mode != css.LANES
               for q in css.lane_plans(1, 512, 1026, torch.float64, 132))


def test_scan_active_clusters():
    """The reckoning's clusters at once on the H100's 132 SMs at one block
    an SM, as cudaOccupancyMaxActiveClusters gave them: 132 of 1, 66 of 2,
    30 of 4, 15 of 8; twice that at two blocks an SM for clusters of 2."""
    assert [css._active(c, 1, 132) for c in (1, 2, 4, 8)] == [132, 66, 30, 15]
    assert css._active(2, 2, 132) == 132


def test_scan_lane_plan_refuses():
    """No plan for an empty shape."""
    for B, N, L in ((0, 8, 9), (1, 0, 1), (1, 8, 0)):
        with pytest.raises(ValueError, match="no plan"):
            css.lane_plan(B, N, L, torch.float32, 132)


def test_lane_entries_bind_their_plans():
    """The C entries' argument lists: the real lanes take the plan after
    (B, N, L) (Thomas 8 ints, the scan 12, the chunk rule's rows first),
    the complex entries as before; the geometry entries likewise."""
    class Fn:
        pass

    class Lib:
        def __getattr__(self, name):
            fn = Fn()
            setattr(self, name, fn)
            return fn
    lib = Lib()
    cs._bind(lib)
    css._bind(lib)
    P, I = ctypes.c_void_p, ctypes.c_int
    assert lib.shear_thomas_f32.argtypes == [P] * 5 + [I] * 4 + [P]
    assert lib.shear_thomas_real_f64.argtypes == [P] * 5 + [I] * 8 + [P]
    assert lib.shear_thomas_real_geometry_f32.argtypes[:7] == [I] * 7
    assert lib.shear_scan_f64.argtypes == [P] * 5 + [I] * 5 + [P]
    assert lib.shear_scan_real_f32.argtypes == [P] * 5 + [I] * 12 + [P]
    assert lib.shear_scan_real_geometry_f64.argtypes[:12] == [I] * 12
    p = css.lane_plan(1, 1024, 2050, torch.float32, 132)
    assert css._plan_args(p) == (p.tile, p.cluster, p.block_chunks, p.groups,
                                 css.LANES, 1, p.shared_bytes)


@pytest.mark.parametrize("N", [1, 7, 33])
def test_plain_versions_take_both_views(N):
    """On the CPU both entries run their plain versions on either view and
    launch nothing: float planes (B = 2) and the interleaved view, there
    equal to the complex solve of the same bytes."""
    w, binv, u = tst._real_factors(N, torch.complex128, device="cpu")
    g = torch.Generator().manual_seed(N)
    d = torch.randn(1, N, N + 1, dtype=torch.complex128, generator=g)
    il = tuple(f.repeat_interleave(2, dim=-1) for f in (w, binv, u))
    for fn, plain in ((shear_thomas, shear_thomas_reference),
                      (shear_scan, shear_scan_reference)):
        before = (fn.launches, fn.real_launches)
        planes = torch.view_as_real(d)[0].movedim(-1, 0).contiguous()
        assert torch.equal(fn(w, binv, u, planes), plain(w, binv, u, planes))
        di = torch.view_as_real(d).reshape(1, N, -1)
        xc = torch.view_as_real(plain(w, binv, u, d)).reshape(1, N, -1)
        assert torch.equal(fn(*il, di), xc)
        assert (fn.launches, fn.real_launches) == before


# --- on the card -------------------------------------------------------------

def _views(N, dtype, device, offset=False):
    cplx = torch.complex64 if dtype == torch.float32 else torch.complex128
    w, binv, u = tst._real_factors(N, cplx, device=device)
    il = tuple(f.repeat_interleave(2, dim=-1) for f in (w, binv, u))
    g = torch.Generator(device=device).manual_seed(N)
    for view, fac in (("planes", (w, binv, u)), ("interleaved", il)):
        B, L = VIEWS[view](N)
        buf = torch.randn(B * N * L + int(offset), dtype=dtype, device=device,
                          generator=g)
        yield view, fac, buf[int(offset):].view(B, N, L)


def _edges(kernel, dtype, view, sms):
    """N - 1 and N at the first change of the plan above N = 1024."""
    def key(N):
        B, L = VIEWS[view](N)
        if kernel == "thomas":
            return cs.lane_plan(B, N, L, dtype, sms).resident
        p = css.lane_plan(B, N, L, dtype, sms)
        return p.mode, p.late, p.cluster
    N = next(N for N in range(1025, 4097) if key(N) != key(1024))
    return N - 1, N


def _check(kernel, fac, d):
    fn, plain = ((shear_thomas, shear_thomas_reference) if kernel == "thomas"
                 else (shear_scan, shear_scan_reference))
    before = fn.real_launches
    x = fn(*fac, d)
    assert torch.equal(x, plain(*fac, d))
    assert fn.real_launches == before + 1
    if d.shape[0] == 1:  # the interleaved view: the complex entry's bytes
        N = d.shape[1]
        xc = fn(*(f[:, ::2].contiguous() for f in fac),
                torch.view_as_complex(d.clone().view(1, N, -1, 2)))
        assert torch.equal(x, torch.view_as_real(xc).reshape(1, N, -1))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["thomas", "scan"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("N", [7, 100, 1000, 4096])
def test_lane_kernels_bit_equal_on_card(cuda, N, dtype, kernel):
    """Both views bit-equal to the plain version, one launch a solve."""
    for view, fac, d in _views(N, dtype, cuda):
        _check(kernel, fac, d)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["thomas", "scan"])
@pytest.mark.parametrize("view", sorted(VIEWS))
@pytest.mark.parametrize("dtype", DTYPES)
def test_lane_kernels_at_plan_edges_on_card(cuda, dtype, view, kernel):
    """Each side of the first edge of the plan above N = 1024 (Thomas: y
    resident; the scan: mode, late or cluster size) bit-equal."""
    sms = cs.sms(cuda.index or 0)
    for N in _edges(kernel, dtype, view, sms):
        for v, fac, d in _views(N, dtype, cuda):
            if v == view:
                _check(kernel, fac, d)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["thomas", "scan"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("N", [6, 100, 1000])
def test_lane_kernels_offset_d_on_card(cuda, N, dtype, kernel):
    """A d that starts one value into its buffer (the scan's lane pairs off
    their alignment take another mode): bit-equal."""
    for view, fac, d in _views(N, dtype, cuda, offset=True):
        assert d.data_ptr() % (2 * d.element_size())
        _check(kernel, fac, d)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("N", [7, 100, 1024])
def test_thomas_through_out_on_card(cuda, monkeypatch, dtype, N):
    """The plan forced to send y through the output, at shapes where it
    would stay resident: bit-equal."""
    plan = cs.lane_plan
    monkeypatch.setattr(cs, "lane_plan",
                        lambda *a, **k: plan(*a, through_out=True))
    for view, fac, d in _views(N, dtype, cuda):
        _check("thomas", fac, d)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_lane_geometry_reports_the_plan_on_card(cuda, dtype):
    """The libraries read the plans from their own layouts: Thomas's
    geometry equals its plan, the scan's clusters at once are at least the
    clusters it launches in a wave."""
    index = cuda.index or 0
    for N in (512, 1024):
        for view in sorted(VIEWS):
            B, L = VIEWS[view](N)
            p = cs.lane_plan(B, N, L, dtype, cs.sms(index))
            assert cs.lane_geometry(B, N, L, dtype, index) == {
                "lanes": p.lanes, "chunk": p.chunk,
                "resident": int(p.resident), "shared_bytes": p.shared_bytes,
                "blocks": p.blocks, "sms": cs.sms(index)}
            geo = css.lane_geometry(B, N, L, dtype, index)
            columns = L // 2 if geo["mode"] == css.LANES else L
            assert geo["active_clusters"] >= 1
            assert geo["active_clusters"] * geo["waves"] >= \
                -(-columns // geo["tile"]) * geo["groups"]


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["thomas", "scan"])
def test_refused_lane_plan_raises_on_card(cuda, kernel):
    """A plan whose shared bytes do not match the library's layout is
    refused: the launch raises and nothing runs."""
    N = 64
    fac, d = next((f, x) for v, f, x in _views(N, torch.float32, cuda)
                  if v == "planes")
    B, L = d.shape[0], d.shape[-1]
    if kernel == "thomas":
        p = cs.lane_plan(B, N, L, torch.float32, cs.sms(cuda.index or 0))
        extra = (p.lanes, p.chunk, int(p.resident), p.shared_bytes + 16)
        lib, name = cs.LIBRARY, "shear_thomas"
    else:
        p = css.lane_plan(B, N, L, torch.float32, cs.sms(cuda.index or 0))
        extra = (css.chunk_rows(N), *css._plan_args(p)[:-1],
                 p.shared_bytes + 16)
        lib, name = css.LIBRARY, "shear_scan"
    with pytest.raises(RuntimeError, match="launch failed"):
        cs.launch_solve(name, lib, *fac, d, *extra)
