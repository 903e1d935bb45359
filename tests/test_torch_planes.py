"""``build_planes_step_fn``, the planes-native float32 stepper, against
quflow_tpu's on the same seeded numpy planes: the trajectory within 1e-5 of
the largest entry (float32 products in another order), the diagnostics,
full refinement, the warm schedule bit-equal to the pure one on the CPU
(the twin of tests/test_parallel.py::test_stepper_mixed_precision_schedule),
one solve of both planes an iteration, and the layouts it refuses.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quflow_tpu.parallel import stepper as jst

from quflow_tpu_torch.ops.cuda_solve import shear_thomas
from quflow_tpu_torch.parallel import stepper as tst

torch.set_num_threads(1)

N = 32


def _planes(seed=3):
    rng = np.random.RandomState(seed)
    W = rng.randn(N, N) + 1j * rng.randn(N, N)
    W = W - W.conj().T
    W = W - np.eye(N) * np.trace(W) / N
    W = (W / np.abs(W).max()).astype(np.complex64)
    return np.stack([W.real, W.imag]).astype(np.float32)


def _dt():
    return 0.25 * (2.0 / np.sqrt(N ** 2 - 1))


def _run_jax(Wp, **kw):
    fn = jst.build_planes_step_fn(N, _dt(), **kw)
    z = jnp.zeros_like(jnp.asarray(Wp))
    return [np.asarray(a) for a in fn(jnp.asarray(Wp), z, z)]


def _run_port(Wp, **kw):
    fn = tst.build_planes_step_fn(N, _dt(), device="cpu", **kw)
    Wt = torch.from_numpy(Wp)
    z = torch.zeros_like(Wt)
    return [a.numpy() for a in fn(Wt, z, z)]


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("kw", [
    {}, {"precision": "highest"}, {"refine": 1}, {"refine": 0},
    {"with_diagnostics": True, "compsum": False},
], ids=["default", "highest", "refine1", "refine0", "diagnostics"])
def test_planes_stepper_matches_quflow_tpu(kw):
    """5 steps of maxit 5 from the same planes: the state within 1e-5 of
    the largest entry, dW too; float32 planes out."""
    Wp = _planes()
    ref = _run_jax(Wp, steps=5, maxit=5, **kw)
    got = _run_port(Wp, steps=5, maxit=5, **kw)
    assert got[0].dtype == np.float32 and got[0].shape == (2, N, N)
    assert _rel(got[0], ref[0]) <= 1e-5
    assert _rel(got[1], ref[1]) <= 1e-5
    if kw.get("with_diagnostics"):
        np.testing.assert_allclose(got[3], ref[3], rtol=1e-5)


def test_warm_schedule_bit_equal_on_cpu():
    """On the CPU every precision name is a full float32 product, so the
    warm schedule reproduces the pure one exactly (quflow_tpu's test)."""
    Wp = _planes()
    pure = _run_port(Wp, steps=5, maxit=5)
    warm = _run_port(Wp, steps=5, maxit=5, warm_precision="high_karatsuba",
                     warm_iters=3)
    for a, b in zip(pure, warm):
        np.testing.assert_array_equal(a, b)
    ref = _run_jax(Wp, steps=5, maxit=5, warm_precision="high_karatsuba",
                   warm_iters=3)
    assert _rel(warm[0], ref[0]) <= 1e-5


def test_one_solve_of_both_planes_an_iteration():
    """Each iteration solves both planes in one call of the column solve,
    on a real (2, N, N+1) float32 rhs (the real-lane entry on a card); the
    diagnostics add one."""
    seen = []

    def spy(w, binv, u, d):
        seen.append((tuple(d.shape), d.dtype))
        return shear_thomas(w, binv, u, d)

    _run_port(_planes(), steps=2, maxit=4, solver=spy, with_diagnostics=True)
    assert seen == [((2, N, N + 1), torch.float32)] * (2 * 4 + 1)


def test_planes_stepper_refuses_row_layouts():
    """Shear layouts only, as in quflow_tpu: any other raises ValueError
    (quflow_tpu's message); 'auto', 'shear' and 'shear_pallas' build."""
    for layout in ("wrapped", "rolls", "pallas", "scatter", "shear_pallas_il"):
        with pytest.raises(ValueError, match="shear layouts only"):
            tst.build_planes_step_fn(N, _dt(), layout=layout, device="cpu")
        with pytest.raises(ValueError, match="shear layouts only"):
            jst.build_planes_step_fn(N, _dt(), layout=layout)
    for layout in ("auto", "shear", "shear_pallas"):
        tst.build_planes_step_fn(N, _dt(), layout=layout, device="cpu")
    with pytest.raises(ValueError, match="precision"):
        tst.build_planes_step_fn(N, _dt(), precision="tf32", device="cpu")
