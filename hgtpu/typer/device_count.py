"""Device-side read->allele compatibility counting.

The device port of GeneCounter.alleles_for_ht (the reference's add_count set
algebra, typing_core.py:626-677) over whole haplotype batches:

    incl[h]  = AND over the ht's known variants of links[v]      (bitsets)
    excl[h]  = any extra allele variant overlapping [left,right]
               (prefix-sum range count minus the ht's own in-range vars)
    count[r] = sum over the read's hts of (incl & ~excl)

Everything is static-shape jax: variant lists padded to MAX_HT_VARS, ht
batches padded to a bucket size.  The bitset AND-reduce is a chain of
plain jnp gathers that XLA fuses into one loop kernel.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..db.catalog import GeneRef, VT_DELETION

MAX_HT_VARS = 16


class DeviceCounter:
    """Precomputed device tables for one gene."""

    def __init__(self, gene: GeneRef):
        self.gene = gene
        A = gene.n_alleles
        self.A = A
        self.W = (A + 31) // 32
        # bitpacked link rows [V+1, W]; row V is all-ones (padding var)
        packed = np.zeros((gene.n_vars + 1, self.W), dtype=np.uint32)
        for v in range(gene.n_vars):
            bits = np.flatnonzero(gene.links[v])
            np.bitwise_or.at(packed[v], bits // 32,
                             np.uint32(1) << (bits % 32).astype(np.uint32))
        packed[gene.n_vars] = 0xFFFFFFFF
        self.links_packed = jnp.asarray(packed)

        nondel = gene.var_type != VT_DELETION
        self.nd_pos = jnp.asarray(gene.var_pos[nondel].astype(np.int32))
        ndp = np.zeros((int(nondel.sum()) + 1, A), dtype=np.int32)
        np.cumsum(gene.links[nondel].astype(np.int32), axis=0, out=ndp[1:])
        self.nd_prefix = jnp.asarray(ndp)
        deli = np.flatnonzero(gene.var_type == VT_DELETION)
        self.del_pos = jnp.asarray(gene.var_pos[deli].astype(np.int32))
        self.del_right = jnp.asarray(gene.var_right[deli].astype(np.int32))
        self.del_links = jnp.asarray(gene.links[deli].astype(np.int32))
        # per-variant (pos, right, is_del) for the kv computation
        self.var_pos_d = jnp.asarray(
            np.concatenate([gene.var_pos.astype(np.int32), [0]]))
        self.var_right_d = jnp.asarray(
            np.concatenate([gene.var_right.astype(np.int32), [0]]))

    # ------------------------------------------------------------------ #
    def pack_hts(self, hts, k: int = MAX_HT_VARS):
        """hts: [(left, right, [var idx (>=0 known only)])] ->
        (lefts, rights, vars [H, k]) padded with the all-ones
        sentinel variant.  k must cover the widest ht (IMGT-scale reads
        carry ~40+ catalog variants; callers bucket k to a power of two
        so XLA compiles a handful of shapes)."""
        H = len(hts)
        lefts = np.zeros(H, np.int32)
        rights = np.zeros(H, np.int32)
        vars_ = np.full((H, k), self.gene.n_vars, np.int32)
        for i, (l, r, vs) in enumerate(hts):
            lefts[i] = l
            rights[i] = r
            ks = [v for v in vs if v >= 0][:k]
            vars_[i, :len(ks)] = ks
        return lefts, rights, vars_

    def compat_masks(self, lefts, rights, vars_):
        """[H, A] bool compatibility — device computation."""
        bits = _compat(self.links_packed, self.nd_pos, self.nd_prefix,
                       self.del_pos, self.del_right, self.del_links,
                       self.var_pos_d, self.var_right_d,
                       jnp.asarray(lefts), jnp.asarray(rights),
                       jnp.asarray(vars_))
        return np.asarray(bits)[:, : self.A]


@jax.jit
def _compat(links_packed, nd_pos, nd_prefix, del_pos, del_right, del_links,
            var_pos, var_right, lefts, rights, vars_):
    H = lefts.shape[0]
    W = links_packed.shape[1]
    n_sentinel = links_packed.shape[0] - 1

    # ---- incl: AND-reduce of link bitsets ---- #
    rows = links_packed[vars_]                                 # [H, K, W]
    incl = rows[:, 0]
    for k in range(1, vars_.shape[1]):
        incl = incl & rows[:, k]

    # ---- excl: range counts per allele ---- #
    i0 = jnp.searchsorted(nd_pos, lefts, side="left")
    i1 = jnp.searchsorted(nd_pos, rights, side="right")
    cnt = nd_prefix[i1] - nd_prefix[i0]                        # [H, A]
    dmask = (((del_pos[None, :] >= lefts[:, None])
              & (del_pos[None, :] <= rights[:, None]))
             | ((del_right[None, :] >= lefts[:, None])
                & (del_right[None, :] <= rights[:, None])))
    # int32 x int32 product with int32 accumulation: exact (0/1 operands,
    # sums bounded by the deletion count)
    cnt = cnt + jnp.dot(dmask.astype(jnp.int32), del_links,
                        preferred_element_type=jnp.int32)

    # ---- kv: the ht's own known vars inside the range ---- #
    vp = var_pos[vars_]                                        # [H, K]
    vr = var_right[vars_]
    known = vars_ < n_sentinel
    in_range = (((vp >= lefts[:, None]) & (vp <= rights[:, None]))
                | ((vr >= lefts[:, None]) & (vr <= rights[:, None])))
    kv = jnp.sum((known & in_range).astype(jnp.int32), axis=1)  # [H]

    excl = (cnt - kv[:, None]) > 0                             # [H, A]
    # unpack incl bits to [H, A_padded]
    bit_idx = jnp.arange(W * 32, dtype=jnp.uint32)
    incl_bits = (incl[:, bit_idx // 32] >> (bit_idx % 32)) & 1
    A = excl.shape[1]
    return (incl_bits[:, :A] == 1) & ~excl
