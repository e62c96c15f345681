"""Batched 2x2-block tridiagonal solver by parallel cyclic reduction.

The exact Jacobian of the coupled (N, P) system with E eliminated
(models/newton.py) is block tridiagonal with 2x2 blocks.  Blocks are
carried as four separate (batch, L) component tensors, so every operation
is elementwise over the batch and the spatial axis.

System: A[i] x[i-1] + B[i] x[i] + C[i] x[i+1] = r[i], with A[0] = C[L-1] = 0
(blockwise), x[i] and r[i] 2-vectors.  Each expression keeps the operation
order of the JAX package's block_tridiag.py, so the two agree to rounding.
"""
from __future__ import annotations

import torch

from .tridiag import shift_left, shift_right

# A 2x2 block M is the tuple (m11, m12, m21, m22); a 2-vector v is (v1, v2).


def b_mul(A, B):
    a11, a12, a21, a22 = A
    b11, b12, b21, b22 = B
    return (a11 * b11 + a12 * b21, a11 * b12 + a12 * b22,
            a21 * b11 + a22 * b21, a21 * b12 + a22 * b22)


def b_mulvec(A, v):
    a11, a12, a21, a22 = A
    v1, v2 = v
    return (a11 * v1 + a12 * v2, a21 * v1 + a22 * v2)


def b_inv(A, recip=None):
    a11, a12, a21, a22 = A
    det = a11 * a22 - a12 * a21
    inv = (1.0 / det) if recip is None else recip(det)
    return (a22 * inv, -a12 * inv, -a21 * inv, a11 * inv)


def b_sub(A, B):
    return tuple(a - b for a, b in zip(A, B))


def b_neg(A):
    return tuple(-a for a in A)


def _shift_block(M, rf, direction, diag_fill=0.0):
    """Shift all components along the spatial axis; diagonal components
    fill with diag_fill (1 for identity when shifting the diagonal blocks)."""
    sh = shift_right if direction > 0 else shift_left
    m11, m12, m21, m22 = M
    return (sh(m11, rf, diag_fill), sh(m12, rf, 0.0),
            sh(m21, rf, 0.0), sh(m22, rf, diag_fill))


def _shift_vec(v, rf, direction):
    sh = shift_right if direction > 0 else shift_left
    return (sh(v[0], rf, 0.0), sh(v[1], rf, 0.0))


def block_pcr_reduce(A, B, C, recip=None):
    """Factorization half of :func:`block_pcr_solve`: the cyclic reduction
    of the MATRIX only, returning the coefficient cache that
    :func:`block_pcr_apply` needs to solve any right-hand side.

    Returns ``(k1s, k2s, fin)``: ``k1s[s]``/``k2s[s]`` are the sweep-s
    elimination multipliers (2x2 blocks, full width) and ``fin`` =
    ``(k, inv_lhs, inv_B_hi, A_hi)`` the final pair-solve blocks (half
    width).  This cache is what chord Newton keeps across steps
    (ops/horizon_kernel.py): the reduce holds all the divides, the apply
    none.
    """
    L = B[0].shape[-1]
    if L & (L - 1):
        raise ValueError(f"block_pcr_reduce requires power-of-two L, got {L}")
    k1s = []
    k2s = []
    rf = 1
    while L > 2 * rf:
        Bm = _shift_block(B, rf, +1, diag_fill=1.0)
        Bp = _shift_block(B, rf, -1, diag_fill=1.0)
        k1 = b_mul(A, b_inv(Bm, recip))
        k2 = b_mul(C, b_inv(Bp, recip))
        B = b_sub(B, b_mul(k1, _shift_block(C, rf, +1)))
        B = b_sub(B, b_mul(k2, _shift_block(A, rf, -1)))
        A = b_neg(b_mul(k1, _shift_block(A, rf, +1)))
        C = b_neg(b_mul(k2, _shift_block(C, rf, -1)))
        k1s.append(k1)
        k2s.append(k2)
        rf *= 2

    def lo(M):
        return tuple(m[..., :rf] for m in M)

    def hi(M):
        return tuple(m[..., rf:] for m in M)

    B_lo, B_hi = lo(B), hi(B)
    A_hi = hi(A)
    C_lo = lo(C)
    inv_B_hi = b_inv(B_hi, recip)
    k = b_mul(C_lo, inv_B_hi)
    lhs = b_sub(B_lo, b_mul(k, A_hi))
    fin = (k, b_inv(lhs, recip), inv_B_hi, A_hi)
    return tuple(k1s), tuple(k2s), fin


def block_pcr_apply(cache, r):
    """Solve for one right-hand side using a :func:`block_pcr_reduce`
    cache.  No divides; two block mul-vecs per sweep per row."""
    k1s, k2s, fin = cache
    rf = 1
    for k1, k2 in zip(k1s, k2s):
        t1 = b_mulvec(k1, _shift_vec(r, rf, +1))
        t2 = b_mulvec(k2, _shift_vec(r, rf, -1))
        r = (r[0] - t1[0] - t2[0], r[1] - t1[1] - t2[1])
        rf *= 2
    k, inv_lhs, inv_B_hi, A_hi = fin
    r_lo = tuple(x[..., :rf] for x in r)
    r_hi = tuple(x[..., rf:] for x in r)
    kv = b_mulvec(k, r_hi)
    rhs = (r_lo[0] - kv[0], r_lo[1] - kv[1])
    x_lo = b_mulvec(inv_lhs, rhs)
    av = b_mulvec(A_hi, x_lo)
    rhs_hi = (r_hi[0] - av[0], r_hi[1] - av[1])
    x_hi = b_mulvec(inv_B_hi, rhs_hi)
    return (torch.cat([x_lo[0], x_hi[0]], dim=-1),
            torch.cat([x_lo[1], x_hi[1]], dim=-1))


def block_pcr_solve(A, B, C, r, recip=None):
    """Solve the block tridiagonal system; L (last axis) a power of two.

    Rows i < rf carry A == 0 and rows i >= L-rf carry C == 0 by induction,
    so the sweep is unconditional (shifted diagonal blocks fill with the
    identity to stay invertible).  ``recip``: optional reciprocal function
    for the block inverses.
    """
    return block_pcr_apply(block_pcr_reduce(A, B, C, recip=recip), r)


def block_matvec(A, B, C, x):
    """Residual helper: y[i] = A[i] x[i-1] + B[i] x[i] + C[i] x[i+1]."""
    xm = _shift_vec(x, 1, +1)
    xp = _shift_vec(x, 1, -1)
    ya = b_mulvec(A, xm)
    yb = b_mulvec(B, x)
    yc = b_mulvec(C, xp)
    return (ya[0] + yb[0] + yc[0], ya[1] + yb[1] + yc[1])
