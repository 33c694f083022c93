"""EM abundance solver with SQUAREM acceleration.

Faithful port of the reference's single_abundance / next_prob / prob_diff
(hisatgenotype_typing_common.py:1267-1410): read-class EM over
equivalence-class counts, SQUAREM step (Varadhan & Roland 2008, as in
Sailfish), convergence diff < 1e-4, <=1000 iterations, optional length
normalization and low-abundance pruning.

The shipped solver (`single_abundance`) runs vectorized NumPy over a
dense [C, A] class-membership matrix; `em_solve_dense` is the
jit-compiled jax twin used by the device path (psum-friendly for
multi-chip).  The reference's dict-literal SQUAREM lives in
`tests/reference_em.py` as the parity oracle.
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np


def prob_diff(prob1: dict, prob2: dict) -> float:
    diff = 0.0
    for allele in prob1:
        if allele in prob2:
            diff += abs(prob1[allele] - prob2[allele])
        else:
            diff += prob1[allele]
    return diff


def _single_abundance_np(cmpt_counts: dict, remove_low: bool,
                         lengths: dict):
    """Vectorized float64 re-expression of the dict EM below: same
    initialization, SQUAREM step, pruning schedule, and tie ordering
    (allele first-appearance order; stable sort).  Differences are
    limited to float summation order (<1e-15/step)."""
    alleles = []
    index = {}
    rows, cols = [], []
    counts = []
    for ci, (cmpt, count) in enumerate(cmpt_counts.items()):
        for a in cmpt.split("-"):
            i = index.get(a)
            if i is None:
                i = len(alleles)
                index[a] = i
                alleles.append(a)
            rows.append(ci)
            cols.append(i)
        counts.append(float(count))
    A, C = len(alleles), len(counts)
    M = np.zeros((C, A), dtype=np.float64)
    M[rows, cols] = 1.0
    cnt = np.asarray(counts)
    use_len = bool(lengths)
    inv_len = (np.array([1.0 / lengths[a] for a in alleles])
               if use_len else None)

    def norm(p):
        if use_len:
            p = p * inv_len
        return p / p.sum()

    def nxt_of(p):
        denom = M @ p
        with np.errstate(divide="ignore", invalid="ignore"):
            w = np.where(denom > 0.0, cnt / np.where(denom > 0.0, denom, 1.0),
                         0.0)
        return norm((M.T @ w) * p)

    active = np.ones(A, dtype=bool)
    p = norm(M.T @ (cnt / M.sum(axis=1)))
    diff, it = 1.0, 0
    while diff > 0.0001 and it < 1000:
        n1 = nxt_of(p)
        n2 = nxt_of(n1)
        r = n1 - p
        v = n2 - n1 - r
        ssv = float(v @ v)
        if ssv > 0.0:
            gamma = -math.sqrt(float(r @ r) / ssv)
            accel = np.maximum(0.0, p - 2 * gamma * r + gamma * gamma * v)
            n1 = nxt_of(accel)
        diff = float(np.abs(p - n1).sum())
        p = n1
        if it >= 10 and remove_low and p.any():
            active &= p >= p.max() / 10.0
            p = np.where(active, p, 0.0)
        it += 1
    if remove_low and p.any():
        active &= p >= p.max() / 10.0
        p = np.where(active, p, 0.0)
    p = norm(p)
    out = [[alleles[i], float(p[i])] for i in np.flatnonzero(active)]
    out.sort(key=lambda x: x[1], reverse=True)
    return out


def single_abundance(cmpt_counts: dict,
                     remove_low_abundance_allele: bool = False,
                     lengths: dict = None):
    """cmpt_counts: {'A1-A2-A3': count} (allele names joined by '-').
    Returns [[allele, prob], ...] sorted by prob desc.

    The shipped solver is the vectorized float64 re-expression; the
    reference-literal dict implementation lives in tests/reference_em.py
    as the parity oracle (tests/test_em.py pins them within 1e-6)."""
    if not cmpt_counts:
        return []
    return _single_abundance_np(cmpt_counts, remove_low_abundance_allele,
                                lengths or {})


# --------------------------------------------------------------------------- #
# Dense device EM
# --------------------------------------------------------------------------- #
# f32 products with real-valued operands: pinned to full f32 so a GPU
# does not run them in TF32 (about three decimal digits)
_HI = jax.lax.Precision.HIGHEST


@jax.jit
def _em_dense(M, counts, inv_len, use_len):
    """M: [C, A] bool membership, counts: [C] f32, inv_len: [A] f32,
    use_len: scalar bool.  Returns final prob [A]."""
    Mf = M.astype(jnp.float32)
    sizes = jnp.maximum(Mf.sum(axis=1), 1.0)

    def norm(p):
        p_len = jnp.where(use_len, p * inv_len, p)
        return p_len / jnp.maximum(p_len.sum(), 1e-30)

    def nxt(p):
        denom = jnp.dot(Mf, p, precision=_HI)                # [C]
        w = jnp.where(denom > 0, counts / jnp.maximum(denom, 1e-30), 0.0)
        return norm(jnp.dot(Mf.T, w, precision=_HI) * p)

    p0 = norm(jnp.dot(Mf.T, counts / sizes, precision=_HI))

    def body(state):
        p, diff, it = state
        p1 = nxt(p)
        p2 = nxt(p1)
        r = p1 - p
        v = p2 - p1 - r
        ssv = jnp.sum(v * v)
        gamma = -jnp.sqrt(jnp.sum(r * r) / jnp.maximum(ssv, 1e-30))
        accel = jnp.maximum(0.0, p - 2 * gamma * r + gamma * gamma * v)
        p_acc = nxt(accel)
        p_new = jnp.where(ssv > 0.0, p_acc, p1)
        diff = jnp.sum(jnp.abs(p_new - p))
        return p_new, diff, it + 1

    def cond(state):
        _, diff, it = state
        return (diff > 1e-4) & (it < 1000)

    p, _, _ = jax.lax.while_loop(cond, body, (p0, jnp.float32(1.0), 0))
    return norm(p)


def em_solve_dense(membership: np.ndarray, counts: np.ndarray,
                   lengths: np.ndarray = None):
    """Dense EM: membership [C, A] bool, counts [C].  Returns prob [A]."""
    A = membership.shape[1]
    if lengths is None:
        inv_len = np.ones(A, np.float32)
        use_len = False
    else:
        inv_len = (1.0 / np.asarray(lengths, np.float64)).astype(np.float32)
        use_len = True
    return np.asarray(_em_dense(jnp.asarray(membership),
                                jnp.asarray(counts, jnp.float32),
                                jnp.asarray(inv_len),
                                jnp.asarray(use_len)))
