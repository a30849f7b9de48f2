"""Bordered-block rank-1 inverse update; a copy of
``graphdot_tpu/linalg/block.py`` (numpy only)."""
import numpy as np


def binvh1(A_inv, v, d):
    r"""Inverse of ``B = [[A, v], [v^T, d]]`` from ``A_inv`` via the Schur
    complement."""
    v = np.ascontiguousarray(v)
    w = A_inv @ v
    schur = d - v @ w
    B_inv = np.empty((A_inv.shape[0] + 1, A_inv.shape[1] + 1))
    B_inv[:-1, :-1] = A_inv + np.outer(w, w) / schur
    B_inv[-1, :-1] = B_inv[:-1, -1] = -w / schur
    B_inv[-1, -1] = 1 / schur
    return B_inv
