"""Device and precision configuration for quflow_tpu_torch.

Two precision tiers, chosen per builder by its complex ``dtype``:

* ``complex128`` - float64 factors, ZGEMM; the tier of the conservation
  gates (refinement off: the base solve is already at roundoff);
* ``complex64``  - float32 factors, CGEMM, with the float64-residual
  correction of the m=0 system on by default (``refine='m0'``).

Both tiers run full-precision GEMMs unless a step builder is told
otherwise.  TF32 would silently cut float32 products to about three
decimal digits, so importing this module turns it off for cuBLAS and
cuDNN:

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

This is process-wide, like every torch backend flag.  The steppers'
precision names 'high' and 'default' (quflow_tpu's warm schedule) turn
cuBLAS's TF32 on around their complex64 GEMMs only, through
:func:`tf32_matmul`, which restores the flag afterwards.  Nothing else
global is touched: torch's default dtype stays float32 (unlike quflow_tpu,
which enables x64 on import), and every builder takes an explicit
``dtype`` and ``device``.

On a card the step runners replay CUDA graphs (parallel/capture.py, the
port's counterpart of ``jax.jit``).  :func:`eager`, the counterpart of
``jax.disable_jit()``, makes runners built or first called inside it run
every kernel from Python instead, so that a replay can be held to the
eager run.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__all__ = ["device", "to_tensor", "like_input", "torch_dtype", "numpy_dtype",
           "tf32_matmul", "eager", "is_eager", "TIERS"]

#: complex state dtype -> real working dtype of its solve
TIERS = {
    np.dtype(np.complex64): np.dtype(np.float32),
    np.dtype(np.complex128): np.dtype(np.float64),
}

_TORCH_OF = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.complex64): torch.complex64,
    np.dtype(np.complex128): torch.complex128,
}


def device(dev=None):
    """``torch.device`` for ``dev``; None means the first CUDA device.

    Without a CUDA device, None raises RuntimeError: the port never moves
    to the CPU unasked.  Pass ``device="cpu"`` to run the plain PyTorch
    versions of the kernels there."""
    if dev is not None:
        return torch.device(dev)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run "
            "quflow_tpu_torch on the CPU")
    return torch.device("cuda")


def to_tensor(x, dev=None):
    """The tensor boundary of the reference-semantics API: a tensor stays
    as it is, on its own device; a numpy array becomes a tensor on
    :func:`device` ``(dev)`` (the card by default)."""
    if isinstance(x, torch.Tensor):
        return x
    a = np.asarray(x)
    if not (a.flags.writeable and a.flags.c_contiguous):
        a = np.array(a)  # torch.from_numpy takes writeable, dense arrays
    return torch.from_numpy(a).to(device(dev))


def like_input(t, x):
    """``t`` as the kind of ``x`` came in: a tensor for a tensor, numpy
    (copied to the host) for anything else."""
    return t if isinstance(x, torch.Tensor) else t.cpu().numpy()


def torch_dtype(dtype):
    """numpy dtype (or torch dtype) -> torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return _TORCH_OF[np.dtype(dtype)]


def numpy_dtype(dtype):
    """torch dtype (or numpy dtype) -> numpy dtype."""
    if isinstance(dtype, torch.dtype):
        return next(k for k, v in _TORCH_OF.items() if v == dtype)
    return np.dtype(dtype)


@contextlib.contextmanager
def tf32_matmul():
    """cuBLAS float32 and complex64 products run on TF32 tensor cores
    inside the block (``torch.backends.cuda.matmul.allow_tf32``); the
    flag's previous value comes back when the block ends, however it
    ends.  CPU products are unaffected."""
    previous = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = previous


_eager_depth = 0


@contextlib.contextmanager
def eager():
    """Runners built or first called inside the block run eagerly, as
    ``jax.disable_jit()`` makes quflow_tpu's run: no CUDA graph is captured
    or replayed (parallel/capture.py).  The choice sticks to a runner after
    its first call.  It is for holding replays to eager runs (tests, the
    smoke), and for running a hook that a capture cannot hold (one that
    returns numpy, or reads or copies host memory), not a per-call
    switch."""
    global _eager_depth
    _eager_depth += 1
    try:
        yield
    finally:
        _eager_depth -= 1


def is_eager():
    """Whether an :func:`eager` block is open."""
    return _eager_depth > 0
