"""Whole-gene compatibility counting + class fold on device.

The reference's per-read hot spot is add_count / add_stat
(typing_core.py:626-677, 1171-1236): per read, intersect allele sets
over the read's variants, take the alleles at max compatibility, and
accumulate the resulting equivalence class.  The host twin here
(engine.type_gene's stats fold over GeneCounter masks) is memory-bound
at IMGT scale — [F, A] int32 gathers and reduceats over a 3,600-allele
axis dominate wall time on a 2-vCPU host.

This module runs the entire chain as ONE jitted device program:

    sub-ht compat masks  [S, A]   (_compat — bitset AND + range counts)
    per-ht level masks   [3U, A]  (segment-sum over sub-ht projections)
    per-group counts     [G, A]   (gather + segment-sum over read groups)
    class rows           [G, A]   (counts == max over include mask)
    packed class keys    [G, W]   (bit-pack along A: 32 alleles / word)
    per-allele totals    [A]      (weighted column sum)

and fetches only the packed keys + totals (~A/8 bytes per read group),
so the device->host transfer is 32x smaller than the bool rows.  Shapes are
bucketed to powers of two so XLA compiles a handful of programs.

Results are bit-identical to the host path (tests/test_device_count.py
asserts equality of cmpt dicts and ranked counts).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .device_count import MAX_HT_VARS, DeviceCounter, _compat

# widest variant slot the fold will compile for (beyond this a single
# pathological haplotype sends the whole gene to the host path)
MAX_FOLD_VARS = 256


def _pow2(n, lo=64):
    p = lo
    while p < n:
        p *= 2
    return p


class DeviceFold:
    """Per-gene device state for the fused counting/fold program."""

    def __init__(self, typer):
        self.typer = typer
        self.gene = typer.gene
        from .engine import shared_device_counter
        self.dc = shared_device_counter(self.gene)

    def run(self, hts_sorted, novel, grouped):
        """hts_sorted: sorted unique ht strings; grouped: the engine's
        {frozenset(ht): [weight, positive_hts]} fold.

        Returns per-level [(packed_rows [G, W] uint32, totals [A])]
        in level order (full, exon, primary), or None when a ht exceeds
        the device variant budget (host fallback).
        """
        import time as _time

        from .exons import get_exon_haplotypes
        from ..utils.trace import TRACE

        _t_prep0 = _time.perf_counter()
        typer = self.typer
        gene = self.gene
        U = len(hts_sorted)
        A = gene.n_alleles

        # ---- sub-ht prep: full + exon + primary projections ---- #
        # catalog-only hts project identically across runs of one gene;
        # novel-var hts ('nv' tokens) depend on the run's registry and
        # are never cached.  The cache lives on the gene's shared typing
        # state so repeat runs (and fresh GeneTyper instances) reuse it.
        from .engine import _gene_shared_state
        proj_cache = _gene_shared_state(self.gene).setdefault(
            "fold_proj_cache", {})
        sub_hts = []
        ht_seg_l = []
        kmax = 1
        for u, ht_str in enumerate(hts_sorted):
            packs = None if "nv" in ht_str else proj_cache.get(ht_str)
            if packs is None:
                left, right, ops = typer.count_ht(ht_str, novel)
                packs = [(0, left, right,
                          [op.var_idx for op in ops])]
                packs += [(1, l, r, [op.var_idx for op in o]) for l, r, o in
                          get_exon_haplotypes((left, right, ops),
                                              gene.exons)]
                packs += [(2, l, r, [op.var_idx for op in o]) for l, r, o in
                          get_exon_haplotypes((left, right, ops),
                                              gene.primary_exons)]
                if "nv" not in ht_str and len(proj_cache) < 200_000:
                    proj_cache[ht_str] = packs
            for level, l, r, vs in packs:
                kmax = max(kmax, sum(1 for v in vs if v >= 0))
                sub_hts.append((l, r, vs))
                ht_seg_l.append(level * U + u)
        if kmax > MAX_FOLD_VARS:
            return None        # pathological ht; host fallback
        K = _pow2(kmax, lo=MAX_HT_VARS)
        S = len(sub_hts)
        Sp = _pow2(S)
        lefts, rights, vars_ = self.dc.pack_hts(sub_hts, k=K)
        lefts = np.pad(lefts, (0, Sp - S))
        rights = np.pad(rights, (0, Sp - S))
        vars_ = np.pad(vars_, ((0, Sp - S), (0, 0)),
                       constant_values=gene.n_vars)
        ht_seg = np.full(Sp, 3 * U, np.int32)    # padding segment
        ht_seg[:S] = ht_seg_l

        # ---- read-group flat rows (per level the row offset differs,
        # so flat carries the ht index; the level offset is added in
        # the jitted program via flat_rows per level... simpler: emit
        # one flat per level stacked, sharing group ids) ---- #
        ht_idx = {h: i for i, h in enumerate(hts_sorted)}
        flat = []
        gseg = []
        weights = np.fromiter((g[0] for g in grouped.values()),
                              np.int64, len(grouped))
        G = len(grouped)
        for gi, (_w, positive_hts) in enumerate(grouped.values()):
            for h in positive_hts:
                flat.append(ht_idx[h])
                gseg.append(gi)
        F = len(flat)
        Fp = _pow2(F)
        flat = np.pad(np.asarray(flat, np.int32), (0, Fp - F))
        gseg_np = np.full(Fp, G, np.int32)       # padding group
        gseg_np[:F] = gseg

        levels = [0, 1, 2] if typer.opts.family == "hla" else [0]
        include = np.zeros((len(levels), A), dtype=bool)
        include[0] = True
        if len(levels) > 1:
            include[1] = typer.allele_rep_mask
            include[2] = typer.primary_rep_mask

        # all levels share one gather + segment-sum: concatenate each
        # level's flat rows (offset into the stacked level-mask matrix)
        # and give each level its own group-id range
        nlev = len(levels)
        flat_all = np.concatenate(
            [flat[:F] + li * U for li in levels]
            + [np.full(Fp * nlev - F * nlev, 3 * U, np.int32)])
        gseg_all = np.concatenate(
            [gseg_np[:F] + li * G for li in levels]
            + [np.full(Fp * nlev - F * nlev, G * nlev, np.int32)])

        TRACE.add("type.count_fold.prep", _time.perf_counter() - _t_prep0)

        dc = self.dc
        LG = nlev * G
        W32 = (A + 31) // 32
        # budget-adaptive fetch cap: the fetch pays per buffer word, so
        # wide rows (large A) bound the cap at ~64k fetched words (the
        # bench scale panel's rescue folds ~170 unique rows) while small-A
        # panels keep full depth; the two-step path below covers the rare
        # overflow exactly (cap chosen before the H100; not yet measured
        # there)
        cap = min(LG, max(512, 65536 // max(W32, 1)))
        with TRACE.stage("type.count_fold.exec"):
            buf, fs, is_first, uw, min_idx = _fold_levels(
                dc.links_packed, dc.nd_pos, dc.nd_prefix, dc.del_pos,
                dc.del_right, dc.del_links, dc.var_pos_d, dc.var_right_d,
                jnp.asarray(lefts), jnp.asarray(rights), jnp.asarray(vars_),
                jnp.asarray(ht_seg), jnp.asarray(flat_all),
                jnp.asarray(gseg_all), jnp.asarray(weights.astype(np.int32)),
                jnp.asarray(include),
                n_ht_segments=3 * U + 1, n_group_segments=G * nlev + 1,
                n_groups=G, n_levels=nlev, n_cap=cap)
            # single fetch: unique class rows, per-class weights, order
            # keys, totals and the unique count packed into ONE uint32
            # buffer — every fetched leaf pays a device round trip, so
            # one leaf beats three
            buf_h = np.asarray(buf)
            at = cap * W32
            rows_h = buf_h[:at].reshape(cap, W32)
            uw_h = buf_h[at:at + cap].astype(np.int64)
            min_idx_h = buf_h[at + cap:at + 2 * cap].astype(np.int64)
            at += 2 * cap
            tt_h = buf_h[at:at + nlev * A].astype(np.int64).reshape(nlev, A)
            Un = int(buf_h[-1])
            if Un > cap:
                # overflow: re-fetch through the exact two-step path
                is_first_h, uw_f, min_idx_f = jax.device_get(
                    (is_first, uw, min_idx))
                first_rows = np.flatnonzero(is_first_h)
                Un = len(first_rows)
                Up = _pow2(Un, lo=16)
                idx_pad = np.zeros(Up, np.int32)
                idx_pad[:Un] = first_rows
                rows_h = np.asarray(_gather_rows(fs, jnp.asarray(idx_pad)))
                uw_h = uw_f[:Un].astype(np.int64)
                min_idx_h = min_idx_f[:Un].astype(np.int64)
            else:
                rows_h = rows_h[:Un]
                uw_h = uw_h[:Un]
                min_idx_h = min_idx_h[:Un]
        out = []
        for li in range(nlev):
            # reassemble per level, restoring first-seen (group) order via
            # the minimum original row index so cmpt_order stays identical
            # to the host path
            sel = np.flatnonzero((min_idx_h[:Un] // G) == li)
            order = sel[np.argsort(min_idx_h[sel], kind="stable")]
            out.append((rows_h[order],
                        uw_h[order],
                        tt_h[li]))
        return out


@functools.partial(jax.jit, static_argnames=("n_ht_segments",
                                              "n_group_segments",
                                              "n_groups", "n_levels",
                                              "n_cap"))
def _fold_levels(links_packed, nd_pos, nd_prefix, del_pos, del_right,
                 del_links, var_pos, var_right,
                 lefts, rights, vars_, ht_seg,
                 flat_rows, group_seg, weights, include_levels,
                 n_ht_segments, n_group_segments, n_groups, n_levels,
                 n_cap):
    """Fused program over all levels at once (full/exon/primary counts
    share the gather + segment-sum; class extraction per level), ending
    with an EXACT on-device class dedup (hash sort + adjacent full-row
    compare) so the host fetches only unique class rows + per-class
    aggregated weights instead of the [L*G, W] matrix."""
    compat = _compat(links_packed, nd_pos, nd_prefix, del_pos, del_right,
                     del_links, var_pos, var_right, lefts, rights, vars_)
    compat = compat.astype(jnp.int32)                         # [S, A]
    level_masks = jax.ops.segment_sum(
        compat, ht_seg, num_segments=n_ht_segments)           # [3U+1, A]
    per_read = level_masks[flat_rows]                         # [F*, A]
    counts_all = jax.ops.segment_sum(
        per_read, group_seg, num_segments=n_group_segments)   # [G*L+1, A]

    A = counts_all.shape[1]
    W = (A + 31) // 32
    pad_A = W * 32 - A
    bitw = (jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32))

    packed_all, totals_all = [], []
    for li in range(n_levels):
        counts = jax.lax.dynamic_slice_in_dim(
            counts_all, li * n_groups, n_groups, axis=0)      # [G, A]
        inc = include_levels[li]
        mx = jnp.max(jnp.where(inc[None, :], counts, -1), axis=1)
        cur = (counts == mx[:, None]) & inc[None, :]
        cur_pad = jnp.pad(cur, ((0, 0), (0, pad_A)))
        packed = jnp.sum(
            cur_pad.reshape(n_groups, W, 32).astype(jnp.uint32)
            * bitw[None, None, :], axis=2, dtype=jnp.uint32)
        totals = jnp.sum(cur.astype(jnp.int32) * weights[:, None],
                         axis=0, dtype=jnp.int32)
        packed_all.append(packed)
        totals_all.append(totals)

    LG = n_levels * n_groups
    flat = jnp.concatenate(packed_all, axis=0)                # [LG, W]
    # 30-bit row hash with the level in the top 2 bits so levels never
    # interleave in the sort.  Collisions are HARMLESS two ways: equal
    # rows always share a key (so they sort adjacent, up to interleaved
    # colliders), and any falsely-split class is re-merged by the host's
    # np.unique in add_packed_batch — correctness never depends on the
    # hash, only transfer size does.
    mixer = (jnp.arange(flat.shape[1], dtype=jnp.uint32)
             * jnp.uint32(0x9E3779B9) + jnp.uint32(0x85EBCA77))
    h = jnp.sum(flat * mixer[None, :], axis=1, dtype=jnp.uint32)
    h = (h ^ (h >> 15)) * jnp.uint32(0x2C1B3C6D)
    lev = jnp.repeat(jnp.arange(n_levels, dtype=jnp.uint32), n_groups)
    key = (lev << jnp.uint32(30)) | (h >> jnp.uint32(2))
    order = jnp.argsort(key, stable=True)
    fs = flat[order]                                          # [LG, W]
    key_s = key[order]
    neq = (key_s[1:] != key_s[:-1]) | jnp.any(fs[1:] != fs[:-1], axis=1)
    is_first = jnp.concatenate(
        [jnp.ones(1, dtype=bool), neq])                       # [LG]
    uniq_rank = jnp.cumsum(is_first.astype(jnp.int32)) - 1    # [LG]
    w_rows = jnp.tile(weights, n_levels)[order]
    uw = jax.ops.segment_sum(w_rows, uniq_rank, num_segments=LG)
    # first-seen order restoration: min original row id per unique class
    min_idx = jax.ops.segment_min(order.astype(jnp.int32), uniq_rank,
                                  num_segments=LG)
    totals = jnp.stack(totals_all)

    # single-fetch packing: the first n_cap unique rows (in unique-rank
    # order) + per-class weights + order keys + totals + unique count as
    # ONE uint32 buffer
    up = jnp.nonzero(is_first, size=n_cap, fill_value=LG)[0]
    rows_c = fs[jnp.clip(up, 0, LG - 1)]                      # [cap, W]
    n_uniq = jnp.sum(is_first.astype(jnp.uint32))
    buf = jnp.concatenate([
        rows_c.reshape(-1),
        uw[:n_cap].astype(jnp.uint32),
        min_idx[:n_cap].astype(jnp.uint32),
        totals.reshape(-1).astype(jnp.uint32),
        n_uniq[None],
    ])
    return buf, fs, is_first, uw, min_idx


@jax.jit
def _gather_rows(fs, idx):
    return fs[idx]
