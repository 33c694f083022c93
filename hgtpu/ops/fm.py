"""FM-index with batched backward search on device.

The device-native counterpart of the reference's HISAT2 FM machinery
(components #1/#3: `hisat2-build` linear index + `-k` search).  The index
is built natively (SA-IS, hgtpu.native) on host; queries run as a jitted
`lax.scan` over query positions with per-step rank queries expressed as
gathers into the occurrence table, vmapped across the read batch.

Occurrence layout: full-resolution occ[i, c] (int32) — 24 B/base, sized
for locus panels and genotype-genome regions (up to tens of Mbp).  For
full-genome scale the table checkpoints per 128-base block with in-block
popcounts (planned; see SURVEY.md §7, FM-index rank on device).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..native import build_suffix_array, bwt_from_sa


CKPT_BLOCK = 64


class FMIndex:
    """FM-index over int8 base codes (A..T=0..3, N=4; sentinel 5).

    checkpoint=False keeps the full occ table (24 B/base — fastest rank,
    fine for locus panels); checkpoint=True stores occ every CKPT_BLOCK
    positions plus the BWT (≈1.5 B/base) and counts within blocks at
    query time — the genome-scale layout (SURVEY.md §7, FM-index rank on
    device: checkpointed occ sized for memory, batched queries).
    """

    def __init__(self, codes: np.ndarray, checkpoint: bool = False):
        codes = np.ascontiguousarray(codes, dtype=np.int8)
        self.n = len(codes)
        self.checkpoint = checkpoint
        self.sa = build_suffix_array(codes)          # [n+1]
        bwt = bwt_from_sa(codes, self.sa)            # [n+1], codes 0..5
        counts = np.bincount(bwt, minlength=6)
        # C[c] = number of symbols strictly smaller (sentinel smallest)
        order = [5, 0, 1, 2, 3, 4]  # sentinel first
        c_arr = np.zeros(6, np.int64)
        total = 0
        for sym in order:
            c_arr[sym] = total
            total += counts[sym]
        self.C = c_arr.astype(np.int32)
        self._C_dev = jnp.asarray(self.C)
        if checkpoint:
            B = CKPT_BLOCK
            n1 = len(bwt)
            nblk = (n1 + B - 1) // B
            pad = nblk * B - n1
            bwt_p = np.concatenate([bwt, np.full(pad, 5, np.int8)]) \
                if pad else bwt
            onehot = np.eye(6, dtype=np.int32)[bwt_p].reshape(nblk, B, 6)
            ckpt = np.zeros((nblk + 1, 6), np.int32)
            np.cumsum(onehot.sum(axis=1), axis=0, out=ckpt[1:])
            self._ckpt_dev = jnp.asarray(ckpt)
            self._bwt_dev = jnp.asarray(bwt_p.reshape(nblk, B))
            self._occ_dev = None
        else:
            onehot = np.eye(6, dtype=np.int32)[bwt]
            occ = np.concatenate(
                [np.zeros((1, 6), np.int32), np.cumsum(onehot, axis=0)],
                axis=0)
            self._occ_dev = jnp.asarray(occ)

    # ------------------------------------------------------------------ #
    def search_batch(self, queries: np.ndarray):
        """Exact backward search.

        queries: int8 [N, L] (pad with code 4/N on the LEFT — padding
        collapses the range to empty only if mid-query, so put real bases
        at the right end; use `pack_queries`).
        Returns (lo, hi) int32 [N]: SA interval of each full query.
        """
        if self.checkpoint:
            return _search_ckpt(self._ckpt_dev, self._bwt_dev, self._C_dev,
                                jnp.asarray(queries), self.n + 1)
        return _search(self._occ_dev, self._C_dev, jnp.asarray(queries))

    def locate(self, lo: int, hi: int, max_hits: int = 64):
        return self.sa[lo:min(hi, lo + max_hits)]

    def count(self, query_codes: np.ndarray) -> int:
        lo, hi = self.search_batch(query_codes[None])
        return int(hi[0] - lo[0])


@functools.partial(jax.jit)
def _search(occ, C, queries):
    n1 = occ.shape[0] - 1

    def step(state, c):
        lo, hi, alive = state
        # mask: padding (code >= 4) keeps the current range
        is_pad = c >= 4
        new_lo = C[c] + occ[lo, c]
        new_hi = C[c] + occ[hi, c]
        lo = jnp.where(is_pad | ~alive, lo, new_lo)
        hi = jnp.where(is_pad | ~alive, hi, new_hi)
        alive = alive & (lo < hi)
        return (lo, hi, alive), None

    def one(q):
        init = (jnp.int32(0), jnp.int32(n1), True)
        (lo, hi, alive), _ = jax.lax.scan(step, init, q[::-1])
        lo = jnp.where(alive, lo, 0)
        hi = jnp.where(alive, hi, 0)
        return lo, hi

    return jax.vmap(one)(queries)


@functools.partial(jax.jit, static_argnames=("n1",))
def _search_ckpt(ckpt, bwt_blocks, C, queries, n1):
    B = bwt_blocks.shape[1]
    lane = jnp.arange(B, dtype=jnp.int32)

    def rank(c, i):
        blk = i // B
        within = jnp.sum(
            (jax.lax.dynamic_index_in_dim(bwt_blocks, blk, 0,
                                          keepdims=False) == c)
            & (lane < i - blk * B))
        return ckpt[blk, c] + within.astype(jnp.int32)

    def step(state, c):
        lo, hi, alive = state
        is_pad = c >= 4
        c32 = jnp.minimum(c, 5).astype(jnp.int8)
        new_lo = C[c32] + rank(c32, lo)
        new_hi = C[c32] + rank(c32, hi)
        lo = jnp.where(is_pad | ~alive, lo, new_lo)
        hi = jnp.where(is_pad | ~alive, hi, new_hi)
        alive = alive & (lo < hi)
        return (lo, hi, alive), None

    def one(q):
        init = (jnp.int32(0), jnp.int32(n1), True)
        (lo, hi, alive), _ = jax.lax.scan(step, init, q[::-1])
        return jnp.where(alive, lo, 0), jnp.where(alive, hi, 0)

    return jax.vmap(one)(queries)


def pack_queries(seqs, length: int) -> np.ndarray:
    """Left-pad with N so real bases sit at the right end (processed
    first by the backward scan)."""
    from ..utils.dna import encode_seq

    out = np.full((len(seqs), length), 4, dtype=np.int8)
    for i, s in enumerate(seqs):
        codes = encode_seq(s[-length:]) if len(s) > length else encode_seq(s)
        out[i, length - len(codes):] = codes
    return out
