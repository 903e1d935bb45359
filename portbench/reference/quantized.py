"""The quantized Laplacian on the sphere and its Poisson solve, plainly.

On su(N) with spin s = (N-1)/2 and the spin generators S_x, S_y, S_z, the
Laplacian is

    Delta W = -sum_a [S_a, [S_a, W]]
            = -(2 s(s+1) W - 2 S_z W S_z - S_+ W S_- - S_- W S_+),

whose eigenvalues are -l(l+1).  With the basis |j>, mu_j = s - j and
S_+|j> = c_j |j-1>, c_j = sqrt(s(s+1) - mu_j(mu_j+1)), it maps each
diagonal of W to itself: entry i of diagonal m, x_i = W[i+m, i] (or
W[i, i+m] above the diagonal), goes to

    -(2 s(s+1) - 2 mu_{i+m} mu_i) x_i + c_{i+1} c_{i+m+1} x_{i+1}
                                      + c_i c_{i+m} x_{i-1},

a symmetric tridiagonal system of N-m unknowns.  The Poisson solve takes
the lower diagonals of a skew-Hermitian W, removes its trace, solves each
system by parallel cyclic reduction in float64 (the m=0 system, singular
on the identity, with its last unknown fixed and the mean removed after),
and mirrors the result: P[i, i+m] = -conj(P[i+m, i]).  Every system is
negative definite after that fix, so the reduction needs no pivoting.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["hbar", "coefficients", "Laplacian"]


def hbar(N):
    """The quantization constant 2 / sqrt(N^2 - 1)."""
    return 2.0 / math.sqrt(N * N - 1.0)


def coefficients(N):
    """(d, e), float64 numpy (N, N): d[m, i] the diagonal entry of unknown
    i on diagonal m and e[m, i] its coupling to unknown i+1, zero past the
    end of the system (i >= N-m-1) and on padding (i >= N-m)."""
    s = (N - 1) / 2.0
    mu = s - np.arange(N, dtype=np.float64)
    c = np.sqrt(np.maximum(s * (s + 1) - mu * (mu + 1), 0.0))
    m = np.arange(N)[:, None]
    i = np.arange(N)[None, :]
    n = N - m
    valid = i < n
    d = np.where(valid, -(2 * s * (s + 1)
                          - 2 * mu[np.minimum(i + m, N - 1)] * mu[i]), 0.0)
    coupled = i + 1 < n
    e = np.where(coupled, c[np.minimum(i + 1, N - 1)]
                 * c[np.minimum(i + m + 1, N - 1)], 0.0)
    return d, e


class Laplacian:
    """The quantized Laplacian of N x N matrices on ``device``: its action
    (:meth:`apply`) and the Poisson solve (:meth:`solve`), in ``dtype``
    (float64 unless told)."""

    def __init__(self, N, device="cpu", dtype=torch.float64):
        self.N = N
        self.device = torch.device(device)
        self.dtype = dtype
        d, e = coefficients(N)
        m = np.arange(N)[:, None]
        i = np.arange(N)[None, :]
        valid = i < N - m
        rows = np.where(valid, i + m, 0)
        cols = np.where(valid, i, 0)

        def put(a, dt=dtype):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                                   device=self.device)

        self.valid = put(valid)
        self.lower = put(rows * N + cols, torch.int64)  # W[i+m, i]
        self.upper = put(cols * N + rows, torch.int64)  # W[i, i+m]
        self.d, self.e = put(d), put(e)
        # the reduction's factors: sub a, diagonal b, super c; padding
        # rows are b = 1 and uncoupled, and the m=0 system drops its last
        # unknown (its equation follows from the others on a traceless rhs)
        a = np.zeros((N, N))
        a[:, 1:] = e[:, :-1]
        b = np.where(valid, d, 1.0)
        c = e.copy()
        b[0, N - 1] = 1.0
        a[0, N - 1] = 0.0
        c[0, N - 2] = 0.0
        self.levels = []
        stride = 1
        while stride < N:
            bd = np.ones((N, N))
            bd[:, stride:] = b[:, :-stride]  # b_{i-s}
            bu = np.ones((N, N))
            bu[:, :-stride] = b[:, stride:]  # b_{i+s}
            alpha = -a / bd
            gamma = -c / bu
            ad = np.zeros((N, N))
            ad[:, stride:] = a[:, :-stride]
            cd = np.zeros((N, N))
            cd[:, stride:] = c[:, :-stride]
            au = np.zeros((N, N))
            au[:, :-stride] = a[:, stride:]
            cu = np.zeros((N, N))
            cu[:, :-stride] = c[:, stride:]
            a, b, c = alpha * ad, b + alpha * cd + gamma * au, gamma * cu
            self.levels.append((stride, put(alpha), put(gamma)))
            stride *= 2
        self.inv_b = put(1.0 / b)

    def diagonals(self, W, upper=False):
        """(..., N, N): row m holds diagonal m of W below (or above) the
        main diagonal, zero past its end."""
        flat = W.reshape(*W.shape[:-2], self.N * self.N)
        X = flat[..., (self.upper if upper else self.lower).reshape(-1)]
        return X.reshape(*W.shape[:-2], self.N, self.N) * self.valid

    def matrix(self, X):
        """The skew-Hermitian matrix whose lower diagonals are ``X``."""
        N = self.N
        L = torch.zeros(*X.shape[:-2], N * N, dtype=X.dtype, device=X.device)
        keep = self.valid.reshape(-1).bool()
        L[..., self.lower.reshape(-1)[keep]] = X.reshape(
            *X.shape[:-2], N * N)[..., keep]
        L = L.reshape(*X.shape[:-2], N, N)
        return L.tril() - L.tril(-1).mH

    def _tridiag(self, X):
        """The tridiagonal action on diagonals ``X``."""
        Y = self.d * X
        Y[..., :-1] += self.e[:, :-1] * X[..., 1:]
        Y[..., 1:] += self.e[:, :-1] * X[..., :-1]
        return Y

    def apply(self, W):
        """Delta W of any square W (both triangles)."""
        N = self.N
        out = torch.zeros(*W.shape[:-2], N * N, dtype=W.dtype,
                          device=W.device)
        keep = self.valid.reshape(-1).bool()
        for upper in (False, True):
            Y = self._tridiag(self.diagonals(W, upper))
            idx = (self.upper if upper else self.lower).reshape(-1)[keep]
            out[..., idx] = Y.reshape(*W.shape[:-2], N * N)[..., keep]
        return out.reshape(W.shape)

    def solve(self, W):
        """P with Delta P = W - tr(W)/N I and tr P = 0, W skew-Hermitian
        (its lower triangle is read)."""
        X = self.diagonals(W).clone()
        X[..., 0, :] -= X[..., 0, :].mean(dim=-1, keepdim=True)
        X[..., 0, self.N - 1] = 0
        for stride, alpha, gamma in self.levels:
            Y = X.clone()
            Y[..., stride:] += alpha[:, stride:] * X[..., :-stride]
            Y[..., :-stride] += gamma[:, :-stride] * X[..., stride:]
            X = Y
        X = X * self.inv_b
        X[..., 0, :] -= X[..., 0, :].mean(dim=-1, keepdim=True)
        return self.matrix(X * self.valid)
