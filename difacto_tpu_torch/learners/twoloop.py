"""Vector-free L-BFGS two-loop recursion (Chen et al., NIPS'15), on the
host in float64 (counterpart of difacto_tpu/learners/twoloop.py; the
reference's ``lbfgs::Twoloop``, src/lbfgs/lbfgs_twoloop.h).

The two-loop runs in the (2m+1)-dim basis b = [s_0..s_{m-1},
y_0..y_{m-1}, grad] using only the Gram matrix B[i][j] = <b_i, b_j>, so
the O(N) work is the Gram matrix and one linear combination, both on the
device in the learner; the O(m^2) coefficients are solved here. B is
recomputed from the basis each epoch, instead of the reference's
incremental CalcIncreB/ApplyIncreB bookkeeping (twoloop.h:19-66), with
the same values.
"""

from __future__ import annotations

from typing import List

import numpy as np


def calc_delta(B: np.ndarray) -> np.ndarray:
    """Two-loop in the Gram basis (CalcDelta, lbfgs_twoloop.h:98-125).

    B is (2m+1, 2m+1) float64 with basis order [s..., y..., grad];
    returns delta (2m+1,) such that the direction p = sum_i delta_i b_i.
    """
    m = (B.shape[0] - 1) // 2
    d = np.zeros(2 * m + 1, dtype=np.float64)
    d[2 * m] = -1.0
    alpha = np.zeros(m, dtype=np.float64)
    for i in range(m - 1, -1, -1):
        alpha[i] = float(d @ B[:, i]) / (B[i, m + i] + 1e-10)
        d[m + i] -= alpha[i]
    d *= B[m - 1, 2 * m - 1] / (B[2 * m - 1, 2 * m - 1] + 1e-10)
    for i in range(m):
        beta = float(d @ B[m + i, :]) / (B[i, m + i] + 1e-10)
        d[i] += alpha[i] - beta
    return d


def calc_direction(s: List[np.ndarray], y: List[np.ndarray],
                   grad: np.ndarray) -> np.ndarray:
    """The direction p from the history and the gradient (CalcDirection,
    twoloop.h:77-96), on the host in float64."""
    assert len(s) == len(y)
    if not s:
        return -grad
    basis = np.stack([*s, *y, grad]).astype(np.float64)
    return calc_delta(basis @ basis.T) @ basis


def naive_two_loop(s: List[np.ndarray], y: List[np.ndarray],
                   grad: np.ndarray) -> np.ndarray:
    """The textbook O(mN) two-loop (the reference's test oracle,
    tests/cpp/lbfgs_twoloop_test.cc)."""
    q = grad.astype(np.float64).copy()
    m = len(s)
    alpha = np.zeros(m)
    for i in range(m - 1, -1, -1):
        alpha[i] = (s[i] @ q) / (y[i] @ s[i] + 1e-10)
        q -= alpha[i] * y[i]
    q *= (s[-1] @ y[-1]) / (y[-1] @ y[-1] + 1e-10)
    for i in range(m):
        beta = (y[i] @ q) / (y[i] @ s[i] + 1e-10)
        q += (alpha[i] - beta) * s[i]
    return -q
