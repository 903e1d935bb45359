"""Eigenspace projections, initial-data helpers, and the legacy solve loop.

Counterpart of quflow_tpu/dynamics.py (reference quflow/dynamics.py:
``project_el`` :20-124, ``solve`` :131-237, ``blob``/``north_blob``
:244-304).  ``project_el`` runs on the host (a tensor comes back as a
tensor on its device) and keeps quflow_tpu's 1/N normalization: the true
orthogonal projection, where the reference returns N times it.  The heat
smoothing of ``north_blob`` and ``blob`` solves on ``device`` (the card
by default); the legacy ``solve`` steps with the port's ``isomp``, whose
options, ``device=`` among them, pass through.
"""

from __future__ import annotations

import numpy as np
import torch

from .integrators import isomp
from .ops.geometry import rotate
from .ops.laplacian import solve_heat
from .quantization import get_basis
from .quantization.transforms import _block
from .utils import seconds2qtime

__all__ = ["project_el", "solve", "blob", "north_blob"]


def project_el(W, el=1, complement=False):
    """Project W onto (or, with ``complement``, off) the el-eigenspace of
    the quantized Laplacian, span{T_elm : |m| <= el}; ``el`` an int or a
    list.  The orthogonal projection, normalized by 1/||column||^2 = 1/N
    (the reference omits it and returns N times the projection)."""
    if isinstance(W, torch.Tensor):
        out = project_el(W.cpu().numpy(), el=el, complement=complement)
        return torch.from_numpy(out).to(W.device)
    W = np.asarray(W)
    N = W.shape[-1]
    basis = get_basis(N)
    W_out = W.copy() if complement else np.zeros_like(W)
    mult = -1.0 if complement else 1.0
    for eli in ([el] if np.isscalar(el) else el):
        if eli < 0:
            eli = N + eli
        for m in range(eli + 1):
            col = _block(basis, N, m)[:, eli - m]
            rows = np.arange(N - m)
            # lower diagonal m, then (m > 0) the upper one, sign (-1)^m
            a = (np.diagonal(W, -m) @ col) * mult / (col @ col)
            W_out[rows + m, rows] += a * col
            if m != 0:
                colu = (1.0 if m % 2 == 0 else -1.0) * col
                a = (np.diagonal(W, m) @ colu) * mult / (colu @ colu)
                W_out[rows, rows + m] += a * colu
    return W_out


def solve(
    W,
    stepsize=0.1,
    steps=None,
    time=None,
    inner_steps=None,
    inner_time=None,
    method=isomp,
    method_kwargs=None,
    callback=None,
    callback_kwargs=None,
    progress_bar=True,
    progress_file=None,
    **kwargs,
):
    """The legacy solve loop in qtime units (reference dynamics.py:131-237):
    exactly one of ``steps`` and ``time`` (seconds), ``inner_steps`` (or
    ``inner_time``) steps between callbacks, which get
    ``(W, inner_time=, inner_steps=)``.  The modern entry point is
    ``quflow_tpu_torch.solve``."""
    N = W.shape[-1]
    method_kwargs = {**(method_kwargs or {}), **kwargs}
    if sum(x is not None for x in (steps, time)) != 1:
        raise ValueError("One, and only one, of steps or time should be "
                         "specified.")
    if time is not None:
        steps = round(seconds2qtime(time, N) / abs(stepsize))
    if callback is not None and not isinstance(callback, tuple):
        callback = (callback,)
    callback_kwargs = callback_kwargs or {}
    if inner_steps is None:
        inner_steps = (round(seconds2qtime(inner_time, N) / abs(stepsize))
                       if inner_time is not None else 100)
    inner_steps = min(inner_steps, steps)

    pbar = None
    if progress_bar:
        try:
            from tqdm.auto import tqdm

            pbar = tqdm(total=steps, unit=" steps", file=progress_file)
        except ModuleNotFoundError:
            pbar = None

    for k in range(0, steps, inner_steps):
        no_steps = min(inner_steps, steps - k)
        W = method(W, stepsize, steps=no_steps, **method_kwargs)
        delta_time = seconds2qtime(no_steps * abs(stepsize), N=N)
        if pbar is not None:
            pbar.update(no_steps)
        for cfun in callback or ():
            cfun(W, inner_time=delta_time, inner_steps=no_steps,
                 **callback_kwargs)

    if pbar is not None:
        pbar.close()
    return W


def north_blob(N, sigma=0, *, device=None):
    """Point vortex at the north pole (W = i E_NN), smoothed by the heat
    flow exp((sigma/4) Delta) when ``sigma`` != 0 (numpy)."""
    W = np.zeros((N, N), dtype=complex)
    W[-1, -1] = 1.0j
    if sigma != 0:
        W = solve_heat(sigma / 4.0, W, device=device)
    return W


def blob(N, pos=np.array([0.0, 0.0, 1.0]), sigma=0, *, device=None):
    """Vorticity blob at ``pos`` on the sphere: the north-pole blob rotated
    there (numpy)."""
    from scipy.spatial.transform import Rotation

    a = np.zeros((3, 3))
    a[:, 0] = pos
    q, _ = np.linalg.qr(a)
    if np.dot(q[:, 0], pos) < 0:
        q[:, 0] *= -1
    if np.linalg.det(q) < 0:
        q[:, -1] *= -1
    q = np.roll(q, 2, axis=-1)
    xi = Rotation.from_matrix(q).as_rotvec()
    return rotate(xi, north_blob(N, sigma, device=device))
