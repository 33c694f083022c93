"""Connected end-to-end multi-chip typing: one jitted shard_map program.

The reference's typing data flow (typing_core.py:249-1789) is
    align -> per-read variant haplotype -> allele compatibility counts
    -> EM abundance
with reads streamed through SAM text between stages.  Here the same flow
is ONE device program over a `jax.sharding.Mesh`: reads are sharded over
the "dp" axis, every reference table (backbone PWM, SNP lookup, indel
catalog, link bitsets) is replicated, and the only cross-chip traffic is
`psum` of per-allele evidence across devices — once for the pileup, once for
the totals and three times per SQUAREM iteration (the M-step
numerators), exactly the collective structure the reference approximates
with multiprocessing + file merges (hisatgenotype:613-665).

Stages, all inside a single shard_map region so XLA can fuse and overlap:

1. placement    — matmul correlation against the variant-aware PWM for both
                  orientations (ops/placement.py); best diagonal per read.
2. extraction   — hypothesis-select the read's spelling against the
                  catalog:
                    * the straight diagonal (matches + known SNPs +
                      novel point edits — the MD+Zs information,
                      typing_core.py:899-1124), and
                    * for each of the MAX_INDEL_CAND catalog indels near
                      the placed span, a split-diagonal hypothesis: the
                      read follows diagonal s up to the indel, then
                      diagonal s+len (deletion) or s-len with the
                      inserted bases spelled in between (insertion) —
                      both prefix- and suffix-anchored, since the argmax
                      diagonal is whichever side of the indel is longer.
                  The winner (max matched bases; straight diagonal on
                  ties) yields the read's variant list, exactly the
                  haplotype the host engine derives from the aligner's
                  edit script (typer/engine.py read_hts).
2b. pileup gate — (production programs) a device mpileup: every placed
                  read's winner spelling scatter-adds its bases (and
                  claimed-deletion span) into a [P, 6] count table,
                  psum-merged over the mesh; the representative-base
                  rule (cov >= 20, >= 20% or >= 7 —
                  typing_common.py:1124-1134) then re-gates the winner's
                  per-base classification exactly as the host's
                  error_correct (typing_core.py:119-243): an unsupported
                  base is corrected toward the pileup (to the backbone:
                  neutral; to a catalog alt: that variant; ambiguous:
                  neutral), counted against the correction budget
                  max(1, editdist).
3. verify gate  — reads whose novel-edit count exceeds the edit budget,
                  whose correction count exceeds the correction budget,
                  or whose score falls below the placement floor are
                  zero-weighted (the NM <= num_editdist filter,
                  typing_core.py:966-973, and the error_correct
                  rejection).  Reads the device cannot spell are flagged
                  in the returned punt mask so the host engine (the
                  bit-exact reference path) can rescue them — reads
                  crossing two or more indels are the only in-gene class
                  left behind.
4. pairing      — in paired mode, mate concordance (opposite
                  orientation, fragment span <= 1000 — the hisat2
                  -X 1000 / flag 0x2 check, typing_core.py:826-852) and
                  the per-pair compatibility-count argmax class of
                  add_stat (typing_core.py:1171-1236): count vector =
                  sum of both mates' per-allele compatibility, class =
                  alleles at the max count.
5. counting     — per-read haplotype -> allele compatibility bitsets via
                  the link matrix (typer/device_count.py, the add_count
                  set algebra of typing_core.py:626-677); psum of
                  per-allele class totals over the mesh.  The production
                  programs additionally dedup the per-pair equivalence
                  classes ON DEVICE (hash sort + adjacent compare, as
                  typer/device_fold.py) and export packed unique class
                  rows at the full / exon(/primary-exon) levels plus the
                  pileup and the punt mask in ONE fetch buffer — the
                  host merges them with rescued punt reads and runs the
                  reference's staged EM (typer/staging.py).
6. EM           — data-parallel SQUAREM (Varadhan & Roland 2008, as the
                  reference's single_abundance, typing_common.py:
                  1282-1410): E-step on the local read shard (an
                  [n_local, A] matmul), M-step numerators
                  psum-reduced, convergence at L1 diff < 1e-4 with a
                  1000-iteration cap; abundances replicated.

The same compiled program runs on 1 chip, an 8-device host, or a
multi-host slice.
"""
from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..db.catalog import GeneRef, VT_DELETION, VT_INSERTION, VT_SINGLE
from ..ops.placement import backbone_pwm, correlate_scores, encode_reads
from ..typer.device_count import DeviceCounter
from ..utils.trace import TRACE
from .sharded import shard_map

MAX_SNP_ALTS = 3    # catalog alts per backbone position (A/C/G/T minus ref)
MAX_INDEL_CAND = 4  # catalog indels probed per read (2 anchors each)
MAX_INS_LEN = 16    # longest insertion spellable on-device
MAX_FRAG = 1000     # hisat2 -X 1000 concordance bound


def _snp_tables(gene: GeneRef, length: int):
    """Per-position catalog SNP lookup: snp_alt [L, MAX_SNP_ALTS] int8
    (7 = no entry) and snp_var [L, MAX_SNP_ALTS] int32 (sentinel =
    n_vars).  One gather per read base answers "is this mismatch a known
    variant, and which" — the device form of the Zs tag."""
    alt = np.full((length, MAX_SNP_ALTS), 7, np.int8)
    var = np.full((length, MAX_SNP_ALTS), gene.n_vars, np.int32)
    fill = np.zeros(length, np.int8)
    for vi in np.flatnonzero(gene.var_type == VT_SINGLE):
        p = int(gene.var_pos[vi])
        k = int(fill[p])
        if k < MAX_SNP_ALTS:
            alt[p, k] = "ACGT".index(gene.var_data[vi])
            var[p, k] = vi
            fill[p] = k + 1
    return alt, var


def _indel_tables(gene: GeneRef):
    """Sorted catalog indel table + a sentinel row (index D): position
    (2^30 — never in any read window), length 0, var id = n_vars (the
    all-ones padding row of the link bitsets)."""
    idx = np.flatnonzero((gene.var_type == VT_DELETION)
                         | (gene.var_type == VT_INSERTION))
    D = len(idx)
    pos = np.full(D + 1, 1 << 30, np.int32)
    ln = np.zeros(D + 1, np.int32)
    is_ins = np.zeros(D + 1, np.int8)
    ivar = np.full(D + 1, gene.n_vars, np.int32)
    ins_enc = np.full((D + 1, MAX_INS_LEN), 7, np.int8)
    for k, vi in enumerate(idx):
        pos[k] = gene.var_pos[vi]
        ivar[k] = vi
        if gene.var_type[vi] == VT_INSERTION:
            is_ins[k] = 1
            seq = gene.var_data[vi]
            if len(seq) <= MAX_INS_LEN:
                ln[k] = len(seq)
                for j, b in enumerate(seq):
                    ins_enc[k, j] = "ACGT".index(b)
            # longer insertions stay length 0: the hypothesis degenerates
            # to the straight diagonal and the read punts to the host
        else:
            ln[k] = gene.var_len[vi]
    order = np.argsort(pos[:D], kind="stable")
    for arr in (pos, ln, is_ins, ivar):
        arr[:D] = arr[order]
    ins_enc[:D] = ins_enc[order]
    return pos, ln, is_ins, ivar, ins_enc


def _pow2(n, lo=64):
    p = lo
    while p < n:
        p *= 2
    return p


class ShardedTyper:
    """One gene's typing pipeline compiled over a device mesh.

    Reads are data-parallel over `axis`.  Single-end: call the object
    with an [N, read_len] int8 code batch (pad code 4); returns
    (prob [A], totals [A], n_used, punt [N]) with prob/totals identical
    on every chip (psum-merged).  Paired: `call_pairs(r1, r2)` with two
    [Npair, read_len] mate batches.

    The production front door is `count_classes(r1[, r2])`: the
    pileup-gated program that exports packed per-level equivalence
    classes + totals + pileup + punt mask in one fetch, for the host to
    merge with rescued reads and run the reference's staged EM
    (parallel/production.py).
    """

    def __init__(self, gene: GeneRef, mesh: Mesh, read_len: int = 100,
                 max_novel: int = 2, em_iters: int = 1000,
                 min_score_frac: float = 0.9, axis: str = "dp",
                 max_ht_vars: int = 16, family: str = "hla",
                 max_indel_cand: int = MAX_INDEL_CAND,
                 with_primary: bool = False, class_cap: int = 2048):
        # class_cap bounds the per-shard fetch buffer of unique class
        # rows; the effective cap (count_classes) is budget-adaptive:
        # the fetch pays per word, so wide-row panels (large A: the
        # bench's 3,600-allele het pair dedups to 48 full + 122 exon
        # classes) shrink the cap to ~64k fetched words while small-A
        # panels (which dedup far less: the toy's 693 rows) keep the
        # full depth.  The rare overflow re-fetches through the exact
        # full-resolution leaves.  (Cap chosen before the H100; not yet
        # measured there.)
        self.gene = gene
        self.mesh = mesh
        self.read_len = read_len
        self.axis = axis
        self.family = family
        self.max_novel = max_novel
        self.n_devices = int(np.prod(mesh.devices.shape))
        ipos_np, ilen_np, iins_np, _, _ = _indel_tables(gene)
        max_shift = int(ilen_np.max()) if len(ilen_np) else 0
        # gene-level hypothesis ceiling: the densest WIDE window
        # ([s0 - 2*max_shift, s0 + W + max_shift], place_mates) any read
        # can see bounds every read's candidate count, so a gene whose
        # ceiling is small can spell its whole batch in ONE fused
        # place+spell dispatch at that ceiling — dropping only
        # hypotheses built on sentinel candidates (invalid in the full
        # program), the same argument that makes tiered == full.
        D_real = len(ipos_np) - 1
        if D_real > 0:
            _p = ipos_np[:D_real].astype(np.int64)
            _hi = np.searchsorted(_p, _p + read_len + 3 * max_shift,
                                  side="right")
            max_cw = int((_hi - np.arange(D_real)).max())
        else:
            max_cw = 0
        self._fused_ns = min(max_cw, max_indel_cand)
        ins_lens = ilen_np[iins_np == 1]
        ins_cap = int(ins_lens.max()) if len(ins_lens) else 0
        del_lens = ilen_np[(iins_np == 0)]
        del_cap = int(del_lens.max()) if len(del_lens) else 0
        pad = read_len + max_shift
        pwm = backbone_pwm(gene)
        pwm_ext = np.concatenate(
            [pwm, np.zeros((read_len, 5), np.float32)])
        bb_ext = np.concatenate(
            [gene.backbone_enc, np.full(pad, 4, np.int8)]).astype(np.int8)
        snp_alt, snp_var = _snp_tables(gene, len(bb_ext))
        ind_pos, ind_len, ind_ins, ind_var, ins_enc = _indel_tables(gene)
        # packed per-position match mask: bit b (0-3) = base b matches
        # the backbone or a catalog SNP alt there; bit 4 = in-backbone.
        # ONE uint8 gather answers match|known + validity for a whole
        # [n, H, W] hypothesis plane (one gather instead of one per
        # table: gathers dominate the spelling stage)
        mask_np = np.zeros(len(bb_ext), np.uint8)
        inb = bb_ext < 4
        mask_np[inb] = (np.uint8(16)
                        | (np.uint8(1) << bb_ext[inb].astype(np.uint8)))
        for k in range(MAX_SNP_ALTS):
            hasalt = snp_alt[:, k] < 4
            mask_np[hasalt] |= (np.uint8(1)
                                << snp_alt[hasalt, k].astype(np.uint8))
        # sliding-window ROW tables: rows[b, t] = table[b - OFF_LO + t].
        # The spelling/gate lookups index the reference at
        # base + j + off(j) where off(j) is the piecewise indel shift
        # (|off| bounded by the stacked indel lengths), so ONE
        # contiguous row fetch per (read, hypothesis) plus a short
        # static-shift select sweep replaces the [n, H, W] per-element
        # gather (contiguous row fetches stream at memory bandwidth where
        # per-element gathers do not).  Chosen before the H100; the A/B
        # against the plain gather there is not yet measured.
        OFF_LO = 2 * ins_cap
        OFF_HI = 2 * max_shift
        Wrow = read_len + OFF_LO + OFF_HI + 1
        self._offs = (OFF_LO, OFF_HI, Wrow)
        # NOTE: the sweep covers the dense contiguous shift range rather
        # than the sparse catalog-achievable shift set (sums of two net
        # indel shifts), which lowered worse when tried; not yet
        # measured on the H100.
        SHIFTS = range(-OFF_LO, OFF_HI + 1)

        def _rows_of(tbl_1d, dtype, fill=0):
            padded = np.concatenate([
                np.full(OFF_LO, fill, dtype), tbl_1d.astype(dtype),
                np.full(Wrow, fill, dtype)])
            return np.lib.stride_tricks.sliding_window_view(
                padded, Wrow)[:len(bb_ext)].copy()

        mask_rows = _rows_of(mask_np, np.uint8)
        bb_rows = _rows_of(bb_ext, np.int8, fill=4)
        dc = DeviceCounter(gene)
        # matmul counting tables: the add_count set algebra as two matmuls
        # (see _compat_mxu) — links as a dense bf16 [V, A] matrix (0/1
        # entries, exact in bf16; counts < 256 exact under f32
        # accumulation)
        links_f = jnp.asarray(gene.links.astype(np.float32),
                              dtype=jnp.bfloat16)
        # per-(position, base) catalog SNP id (sentinel = none): ONE
        # int32 gather answers "is this base a catalog alt here, and
        # which variant" — replacing the 3x snp_alt + 3x snp_var
        # gathers in the winner planes and the pileup gate
        av_np = np.full((len(bb_ext), 4), gene.n_vars, np.int32)
        for k in range(MAX_SNP_ALTS):
            hasalt = snp_alt[:, k] < 4
            av_np[hasalt, snp_alt[hasalt, k]] = snp_var[hasalt, k]
        # u16-packed per-(pos, base) SNP ids for the ROW lookup (two
        # bases per u32 word; sentinel = n_vars)
        assert gene.n_vars < (1 << 16) - 1, \
            "catalog too large for packed av rows"
        avu = av_np.astype(np.uint32)
        av01_np = avu[:, 0] | (avu[:, 1] << 16)
        av23_np = avu[:, 2] | (avu[:, 3] << 16)
        sent_pack = np.uint32(gene.n_vars | (gene.n_vars << 16))
        self._tables = tuple(
            jnp.asarray(t) for t in (
                pwm_ext, bb_ext, snp_alt, snp_var,
                ind_pos, ind_len, ind_ins, ind_var, ins_enc,
                dc.links_packed, dc.nd_pos, dc.nd_prefix, dc.del_pos,
                dc.del_right, dc.del_links, dc.var_pos_d, dc.var_right_d,
                mask_np, links_f, av_np, mask_rows, bb_rows,
                _rows_of(av01_np, np.uint32, fill=int(sent_pack)),
                _rows_of(av23_np, np.uint32, fill=int(sent_pack))))
        n_tables = len(self._tables)

        sentinel = gene.n_vars
        # the packed gate word carries the correction variant id in
        # bits 12-31 (rep_of) — ample for any real catalog (IMGT HLA-A
        # carries ~10^3-10^4 variants)
        assert gene.n_vars < (1 << 19), "catalog too large for gate word"
        A = gene.n_alleles
        self.A = A
        P_bb = len(gene.backbone)
        self.P_bb = P_bb
        D = len(ind_pos) - 1
        lens = gene.allele_lengths()
        inv_len_d = jnp.asarray(np.array(
            [1.0 / lens[a] for a in gene.allele_names], np.float32))
        # ht variant-slot width: sized from the catalog's densest
        # read-window (IMGT reads carry ~40+ catalog variants,
        # typer/device_count.py) so device haplotypes never silently
        # truncate; an overflowing read (>= K real vars) punts to the
        # host rescue (mate_flags)
        K = max_ht_vars
        if gene.n_vars:
            vp_sorted = np.sort(gene.var_pos.astype(np.int64))
            hi = np.searchsorted(vp_sorted, vp_sorted + read_len
                                 + max_shift + 1, side="left")
            k_need = int((hi - np.arange(len(vp_sorted))).max()) + 3
            K = max(max_ht_vars, ((k_need + 7) // 8) * 8)
        self._K = K
        corr_cap = max(1, max_novel)   # error_correct rejection budget
        is_hla = family == "hla"

        # hierarchical exon staging state (typing_core.py:1679-1789):
        # representative alleles grouped by identical exonic variant
        # sets, exon intervals for on-device ht clipping
        staged = is_hla and bool(gene.exons) and A > 1
        self._staged = staged
        self._rep_mask_np = np.zeros(A, bool)
        self._primary_mask_np = np.zeros(A, bool)
        if staged:
            from ..typer.engine import get_rep_alleles
            exon_vars = gene.exonic_var_mask(gene.exons)
            rep_mask, rep_groups = get_rep_alleles(gene, exon_vars)
            staged = bool(rep_mask.any())
            self._staged = staged
            self._rep_mask = jnp.asarray(rep_mask)
            self._rep_mask_np = rep_mask
            self._rep_groups = rep_groups
            if with_primary and gene.primary_exons:
                primary_vars = gene.exonic_var_mask(gene.primary_exons)
                pmask, pgroups = get_rep_alleles(gene, primary_vars,
                                                 rep_mask)
                self._primary_mask_np = pmask
                self._primary_groups = pgroups
        self._with_primary = (with_primary and self._staged
                              and self._primary_mask_np.any())
        n_exons = len(gene.exons)
        ex_l = jnp.asarray(np.array(
            [e[0] for e in gene.exons] or [0], np.int32))
        ex_r = jnp.asarray(np.array(
            [e[1] for e in gene.exons] or [-1], np.int32))
        n_pexons = len(gene.primary_exons)
        px_l = jnp.asarray(np.array(
            [e[0] for e in gene.primary_exons] or [0], np.int32))
        px_r = jnp.asarray(np.array(
            [e[1] for e in gene.primary_exons] or [-1], np.int32))
        var_isdel_d = jnp.asarray(np.concatenate(
            [gene.var_type == VT_DELETION, [False]]))
        self._ones = jnp.ones(A, bool)

        # alternative-haplotype end-trim gate for the production path
        # (VERDICT r3 missing #4): the host's may_trim reach test
        # (typer/engine.py) as device RMQ tables — a read whose span
        # contains an anchor whose equivalence reaches a read edge MAY
        # be end-trimmed by identify_ambiguous_diffs, a transformation
        # the device does not model, so the production program punts it
        # to the host rescue.  Sparse min/max tables packed [K, N].
        from ..typer.engine import ensure_alt_gate
        La, Lt, Ra, Rt = ensure_alt_gate(gene)

        def _pack_rmq(tabs, fill):
            Kt = len(tabs)
            N = max(len(tabs[0]), 1)
            out = np.full((Kt, N), fill, np.int64)
            for kk, t in enumerate(tabs):
                out[kk, :len(t)] = t
            return jnp.asarray(out.astype(np.int32))

        self._gate_n = (len(La), len(Ra))
        La_d = jnp.asarray(La.astype(np.int32))
        Ra_d = jnp.asarray(Ra.astype(np.int32))
        Lt_d = _pack_rmq(Lt, (1 << 30)) if len(La) else None
        Rt_d = _pack_rmq(Rt, -(1 << 30)) if len(Ra) else None

        def may_trim_dev(l, r):
            """Device twin of GeneTyper.may_trim over winner spans."""
            out = jnp.zeros(l.shape, bool)

            def rmq(tab, a_pos, side_val, op, cmp):
                i0 = jnp.searchsorted(a_pos, l, side="left")
                i1 = jnp.searchsorted(a_pos, r, side="right")
                ln = i1 - i0
                kq = jnp.floor(jnp.log2(jnp.maximum(ln, 1)
                                        .astype(jnp.float32))
                               ).astype(jnp.int32)
                w = jnp.left_shift(jnp.int32(1), kq)
                q = op(tab[kq, i0],
                       tab[kq, jnp.maximum(i1 - w, 0)])
                return (ln > 0) & cmp(q, side_val)

            if self._gate_n[0]:
                out = out | rmq(Lt_d, La_d, l, jnp.minimum,
                                lambda q, v: q <= v)
            if self._gate_n[1]:
                out = out | rmq(Rt_d, Ra_d, r, jnp.maximum,
                                lambda q, v: q >= v)
            return out

        # production class levels: full always; exon / primary-exon when
        # the staged hierarchy applies (host StatAccumulator include
        # masks, typer/engine.type_gene)
        self._levels = [("full", np.ones(A, bool))]
        if self._staged:
            self._levels.append(("exon", self._rep_mask_np))
        if self._with_primary:
            self._levels.append(("primary", self._primary_mask_np))
        NLEV = len(self._levels)
        include_np = np.stack([m for _, m in self._levels])
        include_d = jnp.asarray(include_np)

        # static pair-hypothesis combos over the sorted candidate slots:
        # each pair (u, v), u < v (so pos_u < pos_v), is probed with 3
        # anchor modes — prefix (segment A on the argmax diagonal),
        # middle (segment B between the indels), suffix (segment C).
        # Empty while the production programs spell one indel per read;
        # Step 3 enables them (two-indel chains are ~40% of scale punts,
        # the host decodes arbitrary chains in one pass,
        # typing_core.py:899-1124).
        PAIR_COMBOS = tuple((u, v)
                            for u in range(max_indel_cand)
                            for v in range(u + 1, max_indel_cand))

        def place_mates(tabs, reads):
            """Stage 1: matmul placement correlation, both orientations.
            Returns (s0, use_r, uniq_diag, cand_wide) — the argmax
            diagonal per read, the placement-uniqueness bit the tier-1
            rescue needs, and the candidate count in the WIDE window
            [s0 - 2*max_shift, s0 + W + max_shift] that assigns the
            read's spelling tier (the wide window contains the slot
            window, so a low tier implies the dropped hypotheses were
            invalid in the full program — tiered == full per read)."""
            pwm_ext = tabs[0]
            ind_pos_t = tabs[4]
            W = reads.shape[1]
            rc = jnp.where(reads[:, ::-1] < 4, 3 - reads[:, ::-1],
                           jnp.int8(4))
            s_f = correlate_scores(pwm_ext, reads)
            s_r = correlate_scores(pwm_ext, rc)

            # top-2 via max/argmax + masked second max: three cheap
            # row reductions instead of lax.top_k's per-row sort (the
            # sort dominated the place pass on hardware).  Tie
            # semantics identical: argmax picks the lowest index, and a
            # duplicated max makes second == best.
            def top2(s):
                bst = jnp.max(s, 1)
                arg = jnp.argmax(s, 1).astype(jnp.int32)
                P1 = s.shape[1]
                iota = jnp.arange(P1, dtype=jnp.int32)[None, :]
                sec = jnp.max(jnp.where(iota == arg[:, None],
                                        -jnp.inf, s), 1)
                return bst, arg, sec

            best_f, arg_f, sec_f = top2(s_f)
            best_r, arg_r, sec_r = top2(s_r)
            use_r = best_r > best_f
            s0 = jnp.where(use_r, arg_r, arg_f).astype(jnp.int32)
            # unique best placement across diagonals AND orientations:
            # the tier-1 rescue (production._reconstruct_aln) may only
            # reconstruct the host alignment when no equal-score
            # placement exists for the aligner to tie-break differently
            best = jnp.maximum(best_f, best_r)
            second = jnp.maximum(jnp.where(use_r, sec_r, sec_f),
                                 jnp.where(use_r, best_f, best_r))
            lo = jnp.searchsorted(ind_pos_t[:D], s0 - 2 * max_shift)
            hi = jnp.searchsorted(ind_pos_t[:D], s0 + W + max_shift,
                                  side="right")
            return s0, use_r, second < best, hi - lo

        def mate_spell(tabs, reads, placed=None, pair_combos=(),
                       n_single=max_indel_cand):
            """Stage 2 for one mate batch, PRE-gating: hypothesis
            scoring, winner/tie per-base planes.  Returns a dict of
            per-read arrays consumed by `mate_counts` (counting) and
            `pile_contrib` (the device mpileup).

            Every hypothesis claims up to TWO catalog indels (ca, cb)
            with pos_a < pos_b; singles carry the sentinel row D for cb
            (break beyond any read: the b-terms vanish, reproducing the
            single-indel map exactly).  The unified coordinate map for
            read offset j, with net shift sh = dl - il per claimed
            candidate and breaks b_a / b_b:

                bbpos(j) = s_a + j + (j>=b_a)*dl_a - (j>=b_a+il_a)*il_a
                                   + (j>=b_b)*dl_b - (j>=b_b+il_b)*il_b

            anchored at s_a = s0 (prefix), s0 - sh_a (middle), or
            s0 - sh_a - sh_b (suffix) — whichever read segment the
            argmax diagonal belongs to.  b_a = pos_a - s_a and
            b_b = pos_b - s_a - sh_a."""
            (pwm_ext, bb_ext, snp_alt, snp_var, ind_pos, ind_len,
             ind_ins, ind_var, ins_enc) = tabs[:9]
            n, W = reads.shape
            Lbb = bb_ext.shape[0]
            if placed is None:
                s0, use_r, uniq_diag, _cw = place_mates(tabs, reads)
            else:
                s0, use_r, uniq_diag = placed
            rc = jnp.where(reads[:, ::-1] < 4, 3 - reads[:, ::-1],
                           jnp.int8(4))
            oriented = jnp.where(use_r[:, None], rc, reads)

            # -- 2. spelling hypotheses --------------------------------- #
            # straight-diagonal pre-scan for the perfect-read rule: a
            # read whose straight diagonal scores its FULL length is
            # resolved as the straight spelling by the host too
            # (_fast_exact_batch, align/aligner.py:946-975: sc0 >= lens
            # fully in-backbone) — equal-cost indel ties never surface
            mask_rows_t = tabs[20]
            mk0 = mask_rows_t[jnp.clip(s0, 0, Lbb - 1),
                              OFF_LO:OFF_LO + W]
            cu0 = jnp.minimum(oriented, 4).astype(jnp.uint8)
            ok0 = ((mk0 >> cu0) & 1) == 1
            valid0 = (oriented < 4) & (((mk0 >> 4) & 1) == 1)
            score0 = jnp.sum(ok0 & valid0, 1)
            rl_all = jnp.sum(oriented < 4, 1)
            straight_perfect = ((score0 == rl_all) & (rl_all == W)
                                & (s0 >= 0) & (s0 + W <= P_bb))

            # candidates: the max_indel_cand catalog indels at/after
            # s0 - max_shift (window covers suffix-anchored frames;
            # break-anchoring was tried and MISSES suffix-anchored
            # indels whose novel run starts late by lucky matches)
            c0 = jnp.searchsorted(ind_pos[:D], s0 - max_shift)
            cand = jnp.minimum(c0[:, None]
                               + jnp.arange(max_indel_cand)[None, :], D)
            cand = jnp.where(ind_pos[cand] <= s0[:, None] + W + max_shift,
                             cand, D)                            # [n, C]
            # hypothesis columns: straight, then (prefix, suffix) per
            # single candidate, then 3 anchor modes per pair combo.
            # anchor codes: 0 = s0, 1 = s0 - sh_a, 2 = s0 - sh_a - sh_b
            sent_col = jnp.full((n, 1), D, jnp.int32)
            ca_cols = [sent_col]
            cb_cols = [sent_col]
            anc_codes = [0]
            is_pair = [False]
            for c in range(n_single):
                ca_cols.append(cand[:, c:c + 1])
                cb_cols.append(sent_col)
                anc_codes.append(0)
                is_pair.append(False)
            for c in range(n_single):
                ca_cols.append(cand[:, c:c + 1])
                cb_cols.append(sent_col)
                anc_codes.append(2)
                is_pair.append(False)
            for (u, v) in pair_combos:
                for anc in (0, 1, 2):
                    ca_cols.append(cand[:, u:u + 1])
                    cb_cols.append(cand[:, v:v + 1])
                    anc_codes.append(anc)
                    is_pair.append(True)
            if len(ca_cols) == 1:
                # keep H >= 2 so top_k(score, 2) is well-formed: one
                # dud column (invalid, score -1, never ties)
                ca_cols.append(sent_col)
                cb_cols.append(sent_col)
                anc_codes.append(0)
                is_pair.append(True)
            ca = jnp.concatenate(ca_cols, 1)                     # [n, H]
            cb = jnp.concatenate(cb_cols, 1)
            anc = jnp.asarray(np.array(anc_codes, np.int32))[None, :]
            pair_col = jnp.asarray(np.array(is_pair, bool))[None, :]
            H = ca.shape[1]

            dl_a = jnp.where(ind_ins[ca] == 0, ind_len[ca], 0)
            il_a = jnp.where(ind_ins[ca] == 1, ind_len[ca], 0)
            dl_b = jnp.where(ind_ins[cb] == 0, ind_len[cb], 0)
            il_b = jnp.where(ind_ins[cb] == 1, ind_len[cb], 0)
            sh_a = dl_a - il_a
            sh_b = dl_b - il_b
            s_a = (s0[:, None]
                   - jnp.where(anc >= 1, sh_a, 0)
                   - jnp.where(anc == 2, sh_b, 0))               # [n, H]
            p_a = ind_pos[ca]
            p_b = ind_pos[cb]
            b_a = p_a - s_a
            b_b = p_b - s_a - sh_a

            jj = jnp.arange(W, dtype=jnp.int32)[None, None, :]
            ba3, bb3 = b_a[..., None], b_b[..., None]
            ila3, ilb3 = il_a[..., None], il_b[..., None]
            dla3, dlb3 = dl_a[..., None], dl_b[..., None]
            after_a = jj >= ba3
            after_ai = jj >= ba3 + ila3
            after_b = jj >= bb3
            after_bi = jj >= bb3 + ilb3
            in_ins_a = (ila3 > 0) & after_a & ~after_ai
            in_ins_b = (ilb3 > 0) & after_b & ~after_bi
            in_ins = in_ins_a | in_ins_b
            # mask value at s_a + j + off(j): ONE contiguous row fetch
            # per hypothesis + a static-shift select sweep over the
            # bounded indel offsets (no [n, H, W] element gather).
            # bit c = base matches backbone-or-catalog-SNP (the
            # aligner's "free" bases), bit 4 = in-backbone.  A scored
            # hypothesis has s_a >= 0 and bbpos >= 0 everywhere (ok_a),
            # and positions past the backbone land in the rows' zero
            # padding (bit4 = 0), matching the padded mask table.
            off = (jnp.where(after_a, dla3, 0)
                   - jnp.where(after_ai, ila3, 0)
                   + jnp.where(after_b, dlb3, 0)
                   - jnp.where(after_bi, ilb3, 0))              # [n, H, W]
            mrow = mask_rows_t[jnp.clip(s_a, 0, Lbb - 1)]   # [n, H, Wrow]
            mk = jnp.zeros((n, H, W), jnp.uint8)
            for o in SHIFTS:
                mk = jnp.where(off == o,
                               mrow[:, :, OFF_LO + o:OFF_LO + o + W], mk)
            c = oriented[:, None, :]
            cu = jnp.minimum(c, 4).astype(jnp.uint8)
            ok_bb = ((mk >> cu) & 1) == 1
            exp_valid = ((mk >> 4) & 1) == 1
            # inserted bases: compare against each candidate's spelled
            # insertion via fused selects (no [n,H,W] gather), looped
            # only to the catalog's LONGEST spellable insertion — the
            # select chain is pure elementwise work and scales linearly
            ins_row_a = ins_enc[ca]                           # [n, H, 16]
            ins_row_b = ins_enc[cb]
            ok_ins = jnp.zeros(in_ins.shape, bool)
            for t in range(ins_cap):
                ok_ins = ok_ins | (in_ins_a & (jj == ba3 + t)
                                   & (c == ins_row_a[:, :, t][..., None]))
                ok_ins = ok_ins | (in_ins_b & (jj == bb3 + t)
                                   & (c == ins_row_b[:, :, t][..., None]))
            valid = (c < 4) & (exp_valid | in_ins)
            okall = jnp.where(in_ins, ok_ins, ok_bb) & valid
            score = jnp.sum(okall, 2).astype(jnp.float32)       # [n, H]
            n_novel = jnp.sum(valid & ~okall, 2, dtype=jnp.int32)
            n_valid = jnp.sum(valid, 2, dtype=jnp.int32)

            # hypothesis validity: real candidate(s), in-backbone start,
            # every break strictly inside the read (>=1 anchored base on
            # each side, >=1 base of segment B between a pair's breaks);
            # insertions must fit MAX_INS_LEN (len 0 rows are
            # real-candidate duds -> invalid).  A pair column whose cb
            # degenerated to the sentinel is INVALID — it would
            # duplicate the single hypothesis and fake an equal-cost tie
            rl = jnp.sum(oriented < 4, 1).astype(jnp.int32)[:, None]
            real_a = ca < D
            real_b = cb < D
            ok_a = ((s_a >= 0) & (b_a >= 1) & (b_a + il_a <= rl - 1)
                    & (b_a <= rl - 1) & ((dl_a > 0) | (il_a > 0)))
            # b_b == b_a + il_a (no intervening base) is a COMBINED
            # chain — adjacent catalog deletions with gap == dl_a, the
            # reference's combinable-indel class; the unified map
            # stacks both shifts at the shared break exactly as the
            # host DFS chains the ops
            ok_b = ((b_b >= b_a + il_a) & (b_b + il_b <= rl - 1)
                    & (b_b <= rl - 1) & ((dl_b > 0) | (il_b > 0)))
            ok_h = (real_a & ok_a
                    & jnp.where(pair_col, real_b & ok_b, ~real_b))
            straight = jnp.concatenate(
                [jnp.ones((n, 1), bool),
                 jnp.zeros((n, H - 1), bool)], 1)
            score = jnp.where(straight | ok_h, score, -1.0)

            # top-2 hypotheses: the winner spells the read; an EQUAL-cost
            # runner-up is an alternative spelling whose class unions in
            # (the device form of the reference's equal-cost alt
            # haplotypes, typing_common.py:1663-1955 — add_stat's argmax
            # class over summed per-ht counts takes the union when the
            # two spellings conflict).  argmax/top_k break ties toward
            # the straight diagonal (index 0), then single-indel
            # spellings before pairs (the host prefers fewer ops at
            # equal cost; divergent equal-cost spellings punt anyway).
            top_v, top_i = jax.lax.top_k(score, 2)                # [n, 2]
            tie2 = (top_v[:, 1] == top_v[:, 0]) & (top_v[:, 1] >= 0.0)

            def take(a, w):
                return jnp.take_along_axis(a, w[:, None], 1)[:, 0]

            def planes_of(w):
                """Per-base [n, W] planes of hypothesis column w [n],
                recomputed arithmetically from the hypothesis scalars
                (no 3D takes) with [n, W] gathers only for the base and
                SNP-id lookups the downstream stages need."""
                s_w = take(s_a, w)
                ba_w = take(b_a, w)
                bb_w = take(b_b, w)
                dla_w = take(dl_a, w)
                ila_w = take(il_a, w)
                dlb_w = take(dl_b, w)
                ilb_w = take(il_b, w)
                pa_w = take(p_a, w)
                pb_w = take(p_b, w)
                ca_w = take(ca, w)
                cb_w = take(cb, w)
                j = jnp.arange(W, dtype=jnp.int32)[None, :]
                aft_a = j >= ba_w[:, None]
                aft_ai = j >= (ba_w + ila_w)[:, None]
                aft_b = j >= bb_w[:, None]
                aft_bi = j >= (bb_w + ilb_w)[:, None]
                ins_a_w = (ila_w[:, None] > 0) & aft_a & ~aft_ai
                ins_b_w = (ilb_w[:, None] > 0) & aft_b & ~aft_bi
                in_ins_w = ins_a_w | ins_b_w
                off_w = (jnp.where(aft_a, dla_w[:, None], 0)
                         - jnp.where(aft_ai, ila_w[:, None], 0)
                         + jnp.where(aft_b, dlb_w[:, None], 0)
                         - jnp.where(aft_bi, ilb_w[:, None], 0))
                bbpos_w = s_w[:, None] + j + off_w
                gp_w = jnp.clip(bbpos_w, 0, Lbb - 1)
                # row lookups (one contiguous fetch per read + static-
                # shift sweep) for the backbone base and the packed
                # per-(pos, base) SNP ids — no [n, W] element gathers
                base = jnp.clip(s_w, 0, Lbb - 1)
                brow = tabs[21][base]
                a01r = tabs[22][base]
                a23r = tabs[23][base]
                bb_w_base = jnp.full((brow.shape[0], W), 4, jnp.int8)
                a01 = jnp.full((brow.shape[0], W), sent_pack, jnp.uint32)
                a23 = jnp.full((brow.shape[0], W), sent_pack, jnp.uint32)
                for o in SHIFTS:
                    hit = off_w == o
                    sl = slice(OFF_LO + o, OFF_LO + o + W)
                    bb_w_base = jnp.where(hit, brow[:, sl], bb_w_base)
                    a01 = jnp.where(hit, a01r[:, sl], a01)
                    a23 = jnp.where(hit, a23r[:, sl], a23)
                cc = oriented
                valid_w = (cc < 4) & ((bb_w_base < 4) | in_ins_w)
                match_w = valid_w & ~in_ins_w & (cc == bb_w_base)
                mism_w = valid_w & ~match_w & ~in_ins_w
                avv = jnp.where(cc < 2, a01, a23)
                var16 = ((avv >> (16 * (cc & 1).astype(jnp.uint32)))
                         & jnp.uint32(0xFFFF)).astype(jnp.int32)
                var_w = jnp.where(mism_w, var16, sentinel)
                span = jnp.where(
                    ins_a_w, pa_w[:, None],
                    jnp.where(ins_b_w, pb_w[:, None], bbpos_w))
                l = jnp.min(jnp.where(valid_w, span, 1 << 30), 1)
                r = jnp.max(jnp.where(valid_w, span, -1), 1)
                return dict(
                    gp=gp_w, in_ins=in_ins_w, valid=valid_w,
                    var=var_w, match=match_w,
                    l=l, r=r, sa=s_w,
                    iva=ind_var[ca_w], ivb=ind_var[cb_w],
                    pa=pa_w, pb=pb_w, dla=dla_w, dlb=dlb_w)

            win = top_i[:, 0]
            return dict(
                oriented=oriented, use_r=use_r, cand=cand, tie2=tie2,
                uniq_diag=uniq_diag, straight_perfect=straight_perfect,
                score_w=take(score, win), n_novel_w=take(n_novel, win),
                n_valid_w=take(n_valid, win),
                W=planes_of(win), T=planes_of(top_i[:, 1]))

        def pile_contrib(sp, include):
            """Device mpileup contribution of one mate batch's winner
            spellings (get_mpileup, typing_common.py:1059-1184): aligned
            bases into the A/C/G/T columns, the claimed catalog
            deletion's span into the D column.  `include` [n] bool: the
            pair-concordance + placement-sanity gate (the host pileup
            sees concordant alignments with no NM filter).  Returns a
            flat [P_bb * 6] int32 per-shard count vector (caller psums).
            """
            h = sp["W"]
            gp, c = h["gp"], sp["oriented"]
            pos_ok = (h["valid"] & ~h["in_ins"]
                      & (gp < P_bb) & include[:, None])
            idx = jnp.clip(gp, 0, P_bb - 1) * 6 + jnp.clip(c, 0, 3)
            pile = jnp.zeros(P_bb * 6, jnp.int32).at[
                idx.reshape(-1)].add(pos_ok.reshape(-1).astype(jnp.int32))
            if del_cap > 0:
                k = jnp.arange(del_cap, dtype=jnp.int32)
                for pv, dl in ((h["pa"], h["dla"]), (h["pb"], h["dlb"])):
                    claims = (dl > 0) & include
                    didx = jnp.clip(pv, 0, P_bb - 1)[:, None] + k[None, :]
                    dmask = (claims[:, None] & (k[None, :] < dl[:, None])
                             & (didx < P_bb))
                    pile = pile.at[
                        jnp.clip(didx, 0, P_bb - 1).reshape(-1) * 6
                        + 5].add(dmask.reshape(-1).astype(jnp.int32))
            return pile

        def rep_of(tabs, pile_flat):
            """Per-position gate words from the final pileup
            (Mpileup.finalize; ref thresholds typing_common.py:1124-1134)
            packed so the error_correct gate pays ONE i32 gather per
            plane instead of three (rep byte + backbone base + catalog
            alt id were separate gathers):
              bits 0-7  rep_pack (bit b = base b is representative)
              bit 8     single (exactly one representative base)
              bit 9     the single rep base equals the backbone base
              bits 12+  catalog SNP id of the single rep base
                        (sentinel = n_vars)"""
            bb_ext_t = tabs[1]
            av_tbl = tabs[19]
            pile = pile_flat.reshape(P_bb, 6)
            total = pile.sum(1)
            acgt = pile[:, :4]
            keep = ((total >= 20)[:, None]
                    & ((acgt * 5 >= total[:, None]) | (acgt >= 7)))
            bitw = (jnp.uint8(1) << jnp.arange(4, dtype=jnp.uint8))
            rep_pack = jnp.sum(keep.astype(jnp.uint8) * bitw[None, :], 1,
                               dtype=jnp.uint8)
            n1 = keep.sum(1)
            single = n1 == 1
            b = jnp.argmax(keep, 1).astype(jnp.int32)
            bbv = bb_ext_t[:P_bb].astype(jnp.int32)
            corr = jnp.where(
                single,
                av_tbl[jnp.arange(P_bb), jnp.clip(b, 0, 3)],
                sentinel)
            gate_tbl = (rep_pack.astype(jnp.int32)
                        | (single.astype(jnp.int32) << 8)
                        | ((single & (b == bbv)).astype(jnp.int32) << 9)
                        | (corr.astype(jnp.int32) << 12))
            # sliding-window rows (built once per count pass, ~1.5 MB):
            # the gate then pays one contiguous row fetch per plane
            # (zero pad rows -> rp == 0 -> never flagged out of range)
            gpad = jnp.concatenate([
                jnp.zeros(OFF_LO, jnp.int32), gate_tbl,
                jnp.zeros(Wrow, jnp.int32)])
            gate_rows = jnp.stack(
                [gpad[t:t + P_bb] for t in range(Wrow)], 1)
            return rep_pack, pile, gate_rows

        def gate_hyp(tabs, sp, h, rep):
            """Pileup re-gating of one hypothesis's per-base
            classification — the device twin of error_correct
            (typing_core.py:119-243).  Returns (gated var plane [n, W],
            corrections counted [n], supported-novel count [n]).
            ONE packed-gate-word gather per plane (rep_of)."""
            _rp, _pile, gate_rows = rep
            gp, c = h["gp"], sp["oriented"]
            n_g, W_g = gp.shape
            pos_ok = h["valid"] & ~h["in_ins"]
            in_bb = gp < P_bb
            # row lookup: off(j) recovered from the stored absolute
            # positions; out-of-sweep offsets (clipped positions past
            # the backbone) resolve to tv == 0 -> never flagged
            jg = jnp.arange(W_g, dtype=jnp.int32)[None, :]
            off_w = gp - h["sa"][:, None] - jg
            grow = gate_rows[jnp.clip(h["sa"], 0, P_bb - 1)]
            tv = jnp.zeros((n_g, W_g), jnp.int32)
            for o in SHIFTS:
                tv = jnp.where(off_w == o,
                               grow[:, OFF_LO + o:OFF_LO + o + W_g], tv)
            rp = tv & 0xFF
            cu = jnp.clip(c, 0, 3).astype(jnp.int32)
            sup = ((rp >> cu) & 1) == 1
            ra = (rp != 0) & in_bb
            flagged = pos_ok & ra & ~sup
            single = ((tv >> 8) & 1) == 1
            single_is_bb = ((tv >> 9) & 1) == 1
            # correction target: the single representative base — to the
            # backbone (neutral: av sentinel), a catalog alt (that
            # variant), or N / multi-rep (neutral unknown)
            corr_var = jnp.where(flagged & single, tv >> 12, sentinel)
            var_new = jnp.where(flagged, corr_var, h["var"])
            # reference num_correction bookkeeping: every flagged base in
            # a match run counts; a flagged mismatch counts only when
            # corrected back to the backbone base
            # (typing_core.py:119-243 match vs mismatch branches)
            corr_counted = flagged & (
                h["match"] | (single & single_is_bb))
            known_new = var_new < sentinel
            novel_new = pos_ok & ~h["match"] & ~known_new & ~flagged
            return (var_new,
                    jnp.sum(corr_counted, 1, dtype=jnp.int32),
                    jnp.sum(novel_new, 1, dtype=jnp.int32))

        def clip_ht_w(var_pos_d, var_right_d, l, r, vars_, k,
                      win_l, win_r, n_win):
            """Intersect an ht with its k-th overlapping window from
            (win_l, win_r) (get_exon_haplotypes, typer/exons.py; ref
            typing_core.py exon clipping).  Non-overlapping windows
            degenerate to the all-compatible uniform row, which shifts
            every allele's count equally and leaves the argmax class
            unchanged — so no masking is needed downstream."""
            first = jnp.searchsorted(win_r, l)
            wi = jnp.minimum(first + k, max(n_win - 1, 0))
            el, er = win_l[wi], win_r[wi]
            ok = (first + k < n_win) & (el <= r) & (er >= l)
            lc = jnp.where(ok, jnp.maximum(l, el), 1 << 30)
            rc = jnp.where(ok, jnp.minimum(r, er), -1)
            vp = var_pos_d[vars_]
            vr = var_right_d[vars_]
            isd = var_isdel_d[vars_]
            # host deletion-edge rule (get_exon_haplotypes, typer/
            # exons.py; ref typing_core.py:718-792): a deletion
            # straddling the clipped left edge advances the edge to one
            # past the deletion; straddling the right edge pulls it to
            # one before — so the straddler stops constraining exactly
            # as the host drops the op and re-spans
            stl = isd & (vp - 1 < lc[:, None]) & (vr >= lc[:, None])
            lc = jnp.maximum(
                lc, jnp.max(jnp.where(stl, vr + 1, -(1 << 30)), 1))
            stri = isd & (vr + 1 > rc[:, None]) & (vp - 1 <= rc[:, None])
            rc = jnp.minimum(
                rc, jnp.min(jnp.where(stri, vp - 1, 1 << 30), 1))
            ok = ok & (lc <= rc)
            lc = jnp.where(ok, lc, 1 << 30)
            rc = jnp.where(ok, rc, -1)
            keep = jnp.where(
                isd,
                (vp - 1 >= lc[:, None]) & (vr + 1 <= rc[:, None]),
                (vp >= lc[:, None]) & (vp <= rc[:, None]))
            vc = jnp.where(ok[:, None] & keep, vars_, sentinel)
            return lc, rc, vc

        def mate_flags(tabs, sp):
            """Ungated punt predictor, computable BEFORE the pileup.

            Production reads this mask twice: pre-punted reads are
            EXCLUDED from the device pileup (their winner spelling may
            be mis-framed — e.g. a multi-indel chain spelled with one
            indel pollutes downstream frames), because the host rescue
            adds their HOST alignments to the pileup instead
            (production._rescue_punts) — making the merged pileup agree
            with the host-full run's.  Returns (passed_u, amb_all)."""
            (ind_pos_t, ind_var_t) = (tabs[4], tabs[7])
            Wh, Th = sp["W"], sp["T"]
            tie2 = sp["tie2"]
            n_valid_w = sp["n_valid_w"]
            nv = n_valid_w.astype(jnp.float32)
            passed_u = ((sp["n_novel_w"] <= max_novel) & (n_valid_w > 0)
                        & (sp["score_w"] >= min_score_frac * nv))
            cand = sp["cand"]
            cv = ind_var_t[cand]
            claimed = ((cv == Wh["iva"][:, None])
                       | (cv == Wh["ivb"][:, None])
                       | (tie2[:, None]
                          & ((cv == Th["iva"][:, None])
                             | (cv == Th["ivb"][:, None]))))
            in_span = ((cand < D)
                       & (ind_pos_t[cand] >= Wh["l"][:, None] - max_shift)
                       & (ind_pos_t[cand] <= Wh["r"][:, None]))
            # ambiguous when (A) residual novels remain next to an
            # unclaimed in-span candidate, or (B) the winner claims
            # indels and an unclaimed candidate could combine into an
            # equal-cost multi-indel spelling the hypothesis set CANNOT
            # represent — combos it CAN represent need no punt: an
            # equal-cost pair surfaces as a top-2 tie (tie_div punts),
            # a better pair wins outright.  Unrepresentable combos:
            #   * the candidate's pair-break would fall within the
            #     validity margin of a span edge (no anchored base on
            #     the far side — the zero-evidence lucky-tail class,
            #     1M4D7M1D92M reads; margin = frame shift + spelled
            #     insertion length + 2),
            #   * the candidate sits too close to an already-claimed
            #     indel (pair breaks must be >= 1 base apart),
            #   * the winner already claims TWO indels (3-chains are
            #     outside the hypothesis space; keep the wide window).
            (ind_len_t, ind_ins_t) = (tabs[5], tabs[6])
            claims2 = ((Wh["ivb"] < sentinel)
                       | (tie2 & (Th["ivb"] < sentinel)))
            claims1 = (((Wh["iva"] < sentinel)
                        | (tie2 & (Th["iva"] < sentinel)))
                       & ~claims2)
            cpos = ind_pos_t[cand]
            dl_c = jnp.where(ind_ins_t[cand] == 0, ind_len_t[cand], 0)
            il_c = jnp.where(ind_ins_t[cand] == 1, ind_len_t[cand], 0)
            # exact representability of the combined spelling (claimed
            # chain + unclaimed candidate Y), from the pair-validity
            # algebra: the break of Y in the winner frame is
            # b_Y = pos_Y - l - Σ_{claimed X before Y} (dl_X - il_X);
            # Y is spellable iff b_Y keeps >= 1 anchored base to each
            # read edge (plus its insertion) and >= 1 base from every
            # claimed break (gap p_Y - p_X >= dl_X + 1 after,
            # p_X - p_Y >= dl_Y + 1 before).  +-2 edge slack / +1 gap
            # slack absorb the l ~ s_a approximation at clipped spans.
            sh_c = (dl_c - il_c) * claimed
            before = pos_c_lt = cpos[:, :, None] < cpos[:, None, :]
            shift_before = jnp.sum(sh_c[:, :, None] * before, 1)
            rl_f = jnp.sum(sp["oriented"] < 4, 1)[:, None]
            b_est = cpos - Wh["l"][:, None] - shift_before
            unrep = (b_est <= 2) | (b_est >= rl_f - 2 - il_c)
            # a chain (X, Y) is representable whenever the breaks keep
            # order: p_Y - p_X >= dl_X (zero-gap combined chains
            # included) — only geometrically OVERLAPPING combos are
            # unrepresentable
            for h in (Wh, Th):
                gate = (tie2 if h is Th else
                        jnp.ones_like(tie2))[:, None]
                for pk, dk in (("pa", "dla"), ("pb", "dlb")):
                    gap_a = cpos - h[pk][:, None]
                    unrep = unrep | (gate & (gap_a >= 1)
                                     & (gap_a <= h[dk][:, None] - 1))
                    gap_b = h[pk][:, None] - cpos
                    unrep = unrep | (gate & (gap_b >= 1)
                                     & (gap_b <= dl_c - 1))
            # 3-chains are outside the hypothesis space: a winner that
            # already claims TWO indels keeps the wide combinability
            # window for any further unclaimed candidate
            EDGE_L = max_shift + 32
            near_edge_l = ((cpos <= Wh["l"][:, None] + EDGE_L)
                           | (cpos >= Wh["r"][:, None] - EDGE_L))
            amb_u = ((jnp.any(in_span & ~claimed, 1)
                      & (sp["n_novel_w"] > 0))
                     | (claims1
                        & jnp.any(in_span & ~claimed & unrep, 1))
                     | (claims2
                        & jnp.any(in_span & ~claimed & near_edge_l, 1)))

            def htv(h):
                cat = jnp.concatenate(
                    [h["var"], h["iva"][:, None], h["ivb"][:, None]], 1)
                # K smallest ascending == -top_k(-x, K): cheaper than a
                # full [n, W+2] sort
                return -jax.lax.top_k(-cat, K)[0]

            v1u, v2u = htv(Wh), htv(Th)
            # alt-haplotype end-trim ambiguity (host: may_trim ->
            # identify_ambiguous_diffs) — handed to the host rescue
            trimmy = may_trim_dev(Wh["l"], Wh["r"])
            if self._gate_n[0] or self._gate_n[1]:
                trimmy = trimmy | (tie2 & may_trim_dev(Th["l"], Th["r"]))
            # equal-cost DIVERGENT spellings (two catalog indel
            # placements spell the read at the same cost): the host
            # reports the aligner's single tie-broken alignment, so the
            # production path defers to it instead of unioning
            tie_div = (tie2 & ~sp["straight_perfect"]
                       & (jnp.any(v1u != v2u, 1)
                          | (Wh["l"] != Th["l"])
                          | (Wh["r"] != Th["r"])))
            # variant-slot overflow: a read whose span holds >= K
            # catalog variants could truncate its device haplotype —
            # hand it to the host rescue instead of miscounting
            trunc = v1u[:, K - 1] < sentinel
            # tier-1 rescue eligibility: the device winner IS the host
            # aligner's unique best alignment (strictly-best placement,
            # no equal-cost spelling, no unclaimed in-span indel), so a
            # punted read can be reconstructed host-side without
            # realignment (production._rescue_punts tier 1)
            tier1 = (passed_u & ~amb_u & ~tie_div & sp["uniq_diag"])
            causes = (amb_u.astype(jnp.uint32)
                      | (trimmy.astype(jnp.uint32) << 1)
                      | (tie_div.astype(jnp.uint32) << 2)
                      | (trunc.astype(jnp.uint32) << 3))
            return passed_u, amb_u | trimmy | tie_div | trunc, tier1, causes

        def compat_mxu(tabs, lefts, rights, vars_):
            """[Hn, A] bool compatibility — the add_count set algebra
            (typing_core.py:626-677) as TWO MATMULS instead of
            per-variant bitset gathers (which move ~K*W32 words per row
            and were the scale program's bottleneck):

                cnt(h,a) = Σ_v in_range(h,v) * links[v,a]
                own(h,a) = Σ_{v ∈ ht_h}      * links[v,a]
                incl = (own == n_own);  excl = (cnt - kv) > 0

            in_range uses the reference's overlap rule per variant
            ((pos ∈ [l,r]) | (right ∈ [l,r]); right==pos except
            deletions).  Exact: links ∈ {0,1} in bf16, every count
            < 256, f32 accumulation.  Row-identical to
            device_count._compat (tests pin the production result to
            the host engine bit-for-bit)."""
            (var_pos_d, var_right_d) = tabs[15:17]
            links_f = tabs[18]
            V = links_f.shape[0]
            Hn = lefts.shape[0]
            l = lefts[:, None]
            r = rights[:, None]
            vp = var_pos_d[:V][None, :]
            vr = var_right_d[:V][None, :]
            in_r = (((vp >= l) & (vp <= r))
                    | ((vr >= l) & (vr <= r)))                 # [Hn, V]
            M1 = in_r.astype(jnp.bfloat16)
            Kq = vars_.shape[1]
            # one-hot accumulate via a K-slot compare sweep instead of
            # the equivalent scatter-add (.at[rowi, cols].add, a
            # read-modify-write lowering): a dense (vars_[:, k] ==
            # iota_V) compare per slot is pure elementwise work (not yet
            # measured against the scatter on the H100).  Sentinel slots
            # (== V) never match iota < V, exactly the old wv = (cols < V)
            # masking.
            iota_v = jnp.arange(V, dtype=jnp.int32)[None, :]
            M2 = jnp.zeros((Hn, V), jnp.bfloat16)
            for k in range(Kq):
                M2 = M2 + (vars_[:, k:k + 1] == iota_v).astype(
                    jnp.bfloat16)
            prod = jnp.dot(jnp.concatenate([M1, M2], 0), links_f,
                           preferred_element_type=jnp.float32)
            cnt, own = prod[:Hn], prod[Hn:]
            real = vars_ < V
            n_own = jnp.sum(real, 1).astype(jnp.float32)
            kvp = var_pos_d[vars_]
            kvr = var_right_d[vars_]
            k_in = ((((kvp >= l) & (kvp <= r))
                     | ((kvr >= l) & (kvr <= r))) & real)
            kv = jnp.sum(k_in, 1).astype(jnp.float32)
            incl = own >= n_own[:, None] - 0.5
            excl = (cnt - kv[:, None]) > 0.5
            return incl & ~excl

        def mate_counts(tabs, sp, rep, want_px, pre_amb=None):
            """Stages 2b-3 + counting masks for one spelled mate batch.
            rep None disables the pileup gate (the legacy programs);
            pre_amb (production) is mate_flags' ungated ambiguity, OR'd
            in so the final punt is a superset of the pileup exclusion.
            Returns (cnt, cnt_ex, cnt_px, passed, needs_host)."""
            (links_packed, nd_pos, nd_prefix, del_pos, del_right,
             del_links, var_pos_d, var_right_d) = tabs[9:17]
            n = sp["oriented"].shape[0]
            Wh, Th = sp["W"], sp["T"]
            tie2 = sp["tie2"]
            score_w = sp["score_w"]
            n_novel_w = sp["n_novel_w"]
            n_valid_w = sp["n_valid_w"]
            if rep is None:
                varW, varT = Wh["var"], Th["var"]
                n_corr = jnp.zeros(n, jnp.int32)
                novel_resid = n_novel_w
            else:
                varW, n_corrW, novelW = gate_hyp(tabs, sp, Wh, rep)
                varT, _, _ = gate_hyp(tabs, sp, Th, rep)
                n_corr = n_corrW
                novel_resid = novelW

            def ht_of(h, var_pl):
                cat = jnp.concatenate(
                    [var_pl, h["iva"][:, None], h["ivb"][:, None]], 1)
                vars_ = -jax.lax.top_k(-cat, K)[0]   # K smallest, ascending
                return h["l"], h["r"], vars_

            l1, r1, v1 = ht_of(Wh, varW)
            l2, r2, v2 = ht_of(Th, varT)

            # -- 3. verify gate ------------------------------------------ #
            nv = n_valid_w.astype(jnp.float32)
            passed = ((n_novel_w <= max_novel) & (n_valid_w > 0)
                      & (score_w >= min_score_frac * nv)
                      & (n_corr <= corr_cap))
            if rep is not None and is_hla:
                # deletion-plausibility misalignment heuristic
                # (typing_core.py:1064-1077): a claimed deletion with
                # del_count * 6 < nt_count rejects the mate, exactly as
                # the host read_hts returns None — checked for BOTH
                # claimed indels of a pair spelling
                _rp, pile, _gt = rep
                for pv, dl in ((Wh["pa"], Wh["dla"]),
                               (Wh["pb"], Wh["dlb"])):
                    pvc = jnp.clip(pv, 0, P_bb - 1)
                    delp_ok = pile[pvc, 5] * 6 >= pile[pvc, :5].sum(1)
                    passed = passed & ((dl == 0) | delp_ok)
            # residual novel edits next to a catalog indel the spelling
            # does not claim: the read may cross a second indel (the
            # host engine spells multi-indel chains; the device does
            # not) — punt it (typer/engine.py read_hts is the rescue).
            # Under the pileup gate, corrected bases also signal the
            # unclaimed-indel frame shift (they read as unsupported),
            # so corrections count toward the ambiguity trigger.
            cand = sp["cand"]
            (ind_pos_t, ind_var_t) = (tabs[4], tabs[7])
            cv = ind_var_t[cand]
            claimed = ((cv == Wh["iva"][:, None])
                       | (cv == Wh["ivb"][:, None])
                       | (tie2[:, None]
                          & ((cv == Th["iva"][:, None])
                             | (cv == Th["ivb"][:, None]))))
            in_span = ((cand < D)
                       & (ind_pos_t[cand] >= l1[:, None] - max_shift)
                       & (ind_pos_t[cand] <= r1[:, None]))
            ambiguous = (jnp.any(in_span & ~claimed, 1)
                         & ((novel_resid + n_corr) > 0))
            if pre_amb is not None:
                ambiguous = ambiguous | pre_amb
            needs_host = (~passed | ambiguous) & (n_valid_w > 0)
            passed = passed & ~ambiguous

            # -- 5. per-read compatibility masks (winner + tied alt, at
            # the full level plus up to 2 exon-clipped windows for the
            # hierarchical exon stage, + 2 primary-exon windows for the
            # primary level) -- #
            groups = [(l1, r1, v1), (l2, r2, v2)]
            if staged:
                for k in (0, 1):
                    groups.append(clip_ht_w(var_pos_d, var_right_d,
                                            l1, r1, v1, k, ex_l, ex_r,
                                            n_exons))
                    groups.append(clip_ht_w(var_pos_d, var_right_d,
                                            l2, r2, v2, k, ex_l, ex_r,
                                            n_exons))
            if want_px:
                for k in (0, 1):
                    groups.append(clip_ht_w(var_pos_d, var_right_d,
                                            l1, r1, v1, k, px_l, px_r,
                                            n_pexons))
                    groups.append(clip_ht_w(var_pos_d, var_right_d,
                                            l2, r2, v2, k, px_l, px_r,
                                            n_pexons))
            masks = compat_mxu(tabs,
                               jnp.concatenate([g[0] for g in groups]),
                               jnp.concatenate([g[1] for g in groups]),
                               jnp.concatenate([g[2] for g in groups]))
            m = [masks[i * n:(i + 1) * n].astype(jnp.int32)
                 for i in range(len(groups))]
            # equal-cost tie union — but a perfect-straight read is
            # resolved as the straight spelling alone by the host
            # (_fast_exact_batch), so the production path must not
            # union its tie (the legacy device-EM path keeps the union)
            tie_cnt = tie2 if rep is None \
                else (tie2 & ~sp["straight_perfect"])
            cnt = m[0] + m[1] * tie_cnt[:, None]
            at = 2
            if staged:
                cnt_ex = (m[at] + m[at + 2]
                          + (m[at + 1] + m[at + 3]) * tie_cnt[:, None])
                at += 4
            else:
                cnt_ex = cnt
            if want_px:
                cnt_px = (m[at] + m[at + 2]
                          + (m[at + 1] + m[at + 3]) * tie_cnt[:, None])
            else:
                cnt_px = cnt
            return cnt, cnt_ex, cnt_px, passed, needs_host

        def mate_pipeline(tabs, reads):
            """Legacy single-dispatch path (ungated), kept bit-identical
            for the pure-device EM programs and their tests."""
            sp = mate_spell(tabs, reads)
            cnt, cnt_ex, _, passed, needs_host = mate_counts(
                tabs, sp, None, False)
            return (cnt, cnt_ex, passed, sp["use_r"], sp["W"]["l"],
                    sp["W"]["r"], needs_host)

        def finish(cnt, cnt_ex, w, punt):
            """Stage-5 epilogue: weighted full-level class totals.
            cnt/cnt_ex [n, A] int compatibility counts, w [n] f32."""
            w = w * (1.0 - punt.astype(jnp.float32))
            mx = jnp.max(cnt, 1)
            cls = ((cnt == mx[:, None])
                   & (w > 0)[:, None]).astype(jnp.float32)
            # exact at any matmul precision, TF32 included: cls and w are
            # 0/1 (both callers pass a bool mask as w), so every product
            # is 0 or 1 and the f32 sums are integers below 2^24
            totals = jax.lax.psum(cls.T @ w, axis)
            n_used = jax.lax.psum(jnp.sum(w), axis)
            return cnt, cnt_ex, w, totals, n_used, punt

        def shard_single(*args):
            tabs, reads = args[:n_tables], args[n_tables]
            cnt, cnt_ex, passed, _, _, _, needs_host = \
                mate_pipeline(tabs, reads)
            p = passed[:, None]
            return finish(cnt * p, cnt_ex * p,
                          passed.astype(jnp.float32), needs_host)

        def shard_pairs(*args):
            tabs, r1, r2 = args[:n_tables], args[n_tables], \
                args[n_tables + 1]
            c1, ce1, ok1, o1, l1, rr1, nh1 = mate_pipeline(tabs, r1)
            c2, ce2, ok2, o2, l2, rr2, nh2 = mate_pipeline(tabs, r2)
            # -- 4. concordance (typing_core.py:826-852) ----------------- #
            span = (jnp.maximum(rr1, rr2) - jnp.minimum(l1, l2))
            conc = (o1 != o2) & (span <= MAX_FRAG)
            used = conc & (ok1 | ok2)
            cnt = c1 * ok1[:, None] + c2 * ok2[:, None]
            cnt_ex = ce1 * ok1[:, None] + ce2 * ok2[:, None]
            punt = conc & (nh1 | nh2)
            return finish(cnt, cnt_ex, used.astype(jnp.float32), punt)

        # ------------------------------------------------------------- #
        # production class-packing programs (pileup-gated)
        # ------------------------------------------------------------- #
        W32 = (A + 31) // 32
        self._W32 = W32
        self._class_cap = class_cap
        self._NLEV = NLEV

        def pack_classes(cnts, w_used, punt, excl, n_reads_m, n_loc):
            """On-device class dedup + single-buffer packing (the
            device_fold._fold_levels scheme, typer/device_fold.py):
            per level, the argmax-count class row of every used pair is
            bit-packed along A; rows of all levels hash-sort together
            (level in the top 2 key bits) and adjacent-compare dedup
            yields unique rows + aggregated weights.  Output: one uint32
            buffer [BUF] per shard + full-resolution leaves for the rare
            cap overflow."""
            wi = w_used.astype(jnp.int32)
            bitw = (jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32))
            pad_A = W32 * 32 - A
            packed_all, totals_all = [], []
            for li in range(NLEV):
                inc = include_d[li]
                mx = jnp.max(jnp.where(inc[None, :], cnts[li], -1), 1)
                cur = ((cnts[li] == mx[:, None]) & inc[None, :]
                       & (wi > 0)[:, None])
                cur_pad = jnp.pad(cur, ((0, 0), (0, pad_A)))
                packed = jnp.sum(
                    cur_pad.reshape(n_loc, W32, 32).astype(jnp.uint32)
                    * bitw[None, None, :], axis=2, dtype=jnp.uint32)
                totals = jax.lax.psum(
                    jnp.sum(cur.astype(jnp.int32) * wi[:, None], 0), axis)
                packed_all.append(packed)
                totals_all.append(totals)
            LG = NLEV * n_loc
            flat = jnp.concatenate(packed_all, 0)              # [LG, W32]
            mixer = (jnp.arange(W32, dtype=jnp.uint32)
                     * jnp.uint32(0x9E3779B9) + jnp.uint32(0x85EBCA77))
            h = jnp.sum(flat * mixer[None, :], axis=1, dtype=jnp.uint32)
            h = (h ^ (h >> 15)) * jnp.uint32(0x2C1B3C6D)
            lev = jnp.repeat(jnp.arange(NLEV, dtype=jnp.uint32), n_loc)
            key = (lev << jnp.uint32(30)) | (h >> jnp.uint32(2))
            order = jnp.argsort(key, stable=True)
            fs = flat[order]
            key_s = key[order]
            neq = (key_s[1:] != key_s[:-1]) \
                | jnp.any(fs[1:] != fs[:-1], axis=1)
            is_first = jnp.concatenate([jnp.ones(1, bool), neq])
            uniq_rank = jnp.cumsum(is_first.astype(jnp.int32)) - 1
            w_rows = jnp.tile(wi, NLEV)[order]
            uw = jax.ops.segment_sum(w_rows, uniq_rank, num_segments=LG)
            min_idx = jax.ops.segment_min(order.astype(jnp.int32),
                                          uniq_rank, num_segments=LG)
            # budget-adaptive fetch cap — must mirror count_classes'
            # unpack formula exactly (buffer layout contract)
            cap = min(class_cap, LG, max(512, 65536 // max(W32, 1)))
            up = jnp.nonzero(is_first, size=cap, fill_value=LG)[0]
            rows_c = fs[jnp.clip(up, 0, LG - 1)]
            n_uniq = jnp.sum(is_first.astype(jnp.uint32))
            # punt + pileup-exclusion masks bit-packed 32 reads per word
            # (excl = reads whose device spelling was EXCLUDED from the
            # device pileup — the rescue adds host alignments to the
            # pileup for exactly these, never for rep-gate-only punts
            # whose device contribution is already in it)
            npw = (n_loc + 31) // 32

            def bitpack(m):
                pad = jnp.pad(m.astype(jnp.uint32), (0, npw * 32 - n_loc))
                return jnp.sum(pad.reshape(npw, 32) * bitw[None, :],
                               axis=1, dtype=jnp.uint32)

            punt_words = bitpack(punt)
            excl_words = bitpack(excl)
            counters = jnp.stack([
                n_uniq,
                n_reads_m.astype(jnp.uint32),
                jnp.sum(wi).astype(jnp.uint32),
                jnp.sum(punt.astype(jnp.uint32))])
            return (rows_c, uw[:cap], min_idx[:cap],
                    jnp.stack(totals_all), punt_words, excl_words,
                    counters, fs, is_first, uw, min_idx)

        def winner_info(sp, tier1, causes):
            """Per-read tier-1 rescue words: punt causes in the top
            nibble (bit28 amb, 29 trim, 30 tie, 31 trunc), then
            (span_l << 2) | (rc << 1) | tier1; plus the two claimed
            catalog indel ids (sentinel = none)."""
            info = ((causes << jnp.uint32(28))
                    | (jnp.maximum(sp["W"]["l"], 0).astype(jnp.uint32)
                       << jnp.uint32(2))
                    | (sp["use_r"].astype(jnp.uint32) << jnp.uint32(1))
                    | tier1.astype(jnp.uint32))
            return [info, sp["W"]["iva"].astype(jnp.uint32),
                    sp["W"]["ivb"].astype(jnp.uint32)]

        def assemble_buf_b(packed):
            """Count-pass output: one uint32 buffer per shard (class
            rows + weights + first-seen + totals + punt/excl words +
            counters) plus the full-resolution overflow leaves."""
            (rows_c, uw_c, min_c, totals, punt_words, excl_words,
             counters, fs, is_first, uw, min_idx) = packed
            buf = jnp.concatenate([
                rows_c.reshape(-1),
                uw_c.astype(jnp.uint32),
                min_c.astype(jnp.uint32),
                totals.reshape(-1).astype(jnp.uint32),
                punt_words,
                excl_words,
                counters,
            ])
            return buf, fs, is_first, uw, min_idx

        # ---- production two-pass protocol -------------------------- #
        # Pass A (spell): placement + hypothesis spelling + the
        # rep-INdependent flags + the device pileup (pre-punts
        # excluded).  Fetches only the pileup, the exclusion mask and
        # the tier-1 winner words; the spelling state stays DEVICE
        # RESIDENT.  The host then aligns the excluded pairs and merges
        # their alignments into the pileup — producing the host-full
        # (final) pileup.  Pass B (count) gates and counts against that
        # injected final pileup, so every error-correction /
        # deletion-plausibility decision equals the host-full run's in
        # a single pass (no re-gate loop, no stale rep sets).
        def bitpack32(m, n_loc):
            npw = (n_loc + 31) // 32
            bw = (jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32))
            pad = jnp.pad(m.astype(jnp.uint32), (0, npw * 32 - n_loc))
            return jnp.sum(pad.reshape(npw, 32) * bw[None, :], axis=1,
                           dtype=jnp.uint32)

        SP_SCALARS = ("oriented", "use_r", "cand", "tie2", "uniq_diag",
                      "straight_perfect", "score_w", "n_novel_w",
                      "n_valid_w")
        PLANE_KEYS = ("gp", "in_ins", "valid", "var", "match", "l", "r",
                      "sa", "iva", "ivb", "pa", "pb", "dla", "dlb")

        def sp_flatten(sp):
            return ([sp[k] for k in SP_SCALARS]
                    + [sp["W"][k] for k in PLANE_KEYS]
                    + [sp["T"][k] for k in PLANE_KEYS])

        def sp_unflatten(flat):
            ns = len(SP_SCALARS)
            npk = len(PLANE_KEYS)
            sp = dict(zip(SP_SCALARS, flat[:ns]))
            sp["W"] = dict(zip(PLANE_KEYS, flat[ns:ns + npk]))
            sp["T"] = dict(zip(PLANE_KEYS, flat[ns + npk:ns + 2 * npk]))
            return sp

        NSP = len(SP_SCALARS) + 2 * len(PLANE_KEYS)
        self._NSTATE = {1: NSP + 2, 2: 2 * NSP + 5}

        def place_single(*args):
            tabs, reads = args[:n_tables], args[n_tables]
            s0, use_r, uniq, cw = place_mates(tabs, reads)
            # read-major [n, 4] so the fetch is one contiguous
            # shard-local copy (a [4, n] layout pays a transpose pass)
            return jnp.stack([s0, use_r.astype(jnp.int32),
                              uniq.astype(jnp.int32), cw], axis=1)

        def place_pairs(*args):
            tabs, r1, r2 = args[:n_tables], args[n_tables], \
                args[n_tables + 1]
            rows = []
            for r in (r1, r2):
                s0, use_r, uniq, cw = place_mates(tabs, r)
                rows += [s0, use_r.astype(jnp.int32),
                         uniq.astype(jnp.int32), cw]
            return jnp.stack(rows, axis=1)

        def spell_single_tail(tabs, sp, n_loc):
            passed_u, amb_all, tier1, causes = mate_flags(tabs, sp)
            pre_punt = (~passed_u | amb_all) & (sp["n_valid_w"] > 0)
            pile = jax.lax.psum(
                pile_contrib(sp, passed_u & ~pre_punt), axis)
            abuf = jnp.concatenate(
                [pile.astype(jnp.uint32), bitpack32(pre_punt, n_loc)]
                + winner_info(sp, tier1, causes))
            return ((abuf,) + tuple(sp_flatten(sp))
                    + (amb_all, pre_punt))

        def make_spell_single(ns, prs):
            def f(*args):
                tabs = args[:n_tables]
                reads, s0, use_r, uniq = args[n_tables:n_tables + 4]
                sp = mate_spell(
                    tabs, reads,
                    placed=(s0, use_r.astype(bool), uniq.astype(bool)),
                    pair_combos=prs, n_single=ns)
                return spell_single_tail(tabs, sp, reads.shape[0])
            return f

        def count_single_body(tabs, pile_in, rest):
            sp = sp_unflatten(rest[:NSP])
            amb_all, pre_punt = rest[NSP], rest[NSP + 1]
            n_loc = sp["oriented"].shape[0]
            rep = rep_of(tabs, pile_in)
            cnt, cnt_ex, cnt_px, passed, needs_host = mate_counts(
                tabs, sp, rep, self._with_primary, amb_all)
            w_used = passed & ~needs_host
            # punted reads are re-counted by the host rescue; count here
            # only what the device keeps (the host counts mates with
            # nm <= editdist, type_gene's n_counted)
            n_reads_m = jnp.sum(
                ((sp["n_novel_w"] <= max_novel) & (sp["n_valid_w"] > 0)
                 & ~needs_host).astype(jnp.int32))
            cnts = [cnt * w_used[:, None].astype(jnp.int32)]
            if NLEV > 1:
                cnts.append(cnt_ex * w_used[:, None].astype(jnp.int32))
            if NLEV > 2:
                cnts.append(cnt_px * w_used[:, None].astype(jnp.int32))
            return assemble_buf_b(pack_classes(
                cnts, w_used, needs_host, pre_punt, n_reads_m, n_loc))

        def spell_pairs_tail(tabs, sp1, sp2, n_loc):
            # -- 4. concordance before the pileup: the host pileup sees
            # concordant pairs only (type_gene pass 1 over conc_alns) -- #
            l1, rr1 = sp1["W"]["l"], sp1["W"]["r"]
            l2, rr2 = sp2["W"]["l"], sp2["W"]["r"]
            span = (jnp.maximum(rr1, rr2) - jnp.minimum(l1, l2))
            conc = (sp1["use_r"] != sp2["use_r"]) & (span <= MAX_FRAG)

            pu1, amb1, t1_1, cz1 = mate_flags(tabs, sp1)
            pu2, amb2, t1_2, cz2 = mate_flags(tabs, sp2)
            # the PAIR pre-punts when either mate does: the rescue adds
            # BOTH mates' host alignments to the pileup, so neither may
            # contribute its device spelling here
            pre_punt = conc & (((~pu1 | amb1) & (sp1["n_valid_w"] > 0))
                               | ((~pu2 | amb2) & (sp2["n_valid_w"] > 0)))
            # a pair the device frames DISCORDANT (same orientation or
            # span > MAX_FRAG) while either mate carries an ambiguity
            # signal (placement tie, equal-cost spelling, failed budget)
            # may be concordant under the host aligner's tie-break —
            # punt it to the rescue instead of silently dropping it
            # (the host counts it iff its own alignments concord,
            # typing_core.py:826-852)
            v1 = sp1["n_valid_w"] > 0
            v2 = sp2["n_valid_w"] > 0
            disc_susp = (~conc & v1 & v2
                         & (~sp1["uniq_diag"] | ~sp2["uniq_diag"]
                            | amb1 | amb2 | ~pu1 | ~pu2))
            excl = pre_punt | disc_susp
            inc1 = conc & pu1 & ~pre_punt
            inc2 = conc & pu2 & ~pre_punt
            pile = jax.lax.psum(
                pile_contrib(sp1, inc1) + pile_contrib(sp2, inc2), axis)
            abuf = jnp.concatenate(
                [pile.astype(jnp.uint32), bitpack32(excl, n_loc)]
                + winner_info(sp1, t1_1, cz1)
                + winner_info(sp2, t1_2, cz2))
            return ((abuf,) + tuple(sp_flatten(sp1))
                    + tuple(sp_flatten(sp2))
                    + (amb1, amb2, conc, pre_punt, disc_susp))

        def make_spell_pairs(ns, prs):
            def f(*args):
                tabs = args[:n_tables]
                r1, r2 = args[n_tables], args[n_tables + 1]
                pl = args[n_tables + 2:n_tables + 8]
                sp1 = mate_spell(
                    tabs, r1,
                    placed=(pl[0], pl[1].astype(bool),
                            pl[2].astype(bool)),
                    pair_combos=prs, n_single=ns)
                sp2 = mate_spell(
                    tabs, r2,
                    placed=(pl[3], pl[4].astype(bool),
                            pl[5].astype(bool)),
                    pair_combos=prs, n_single=ns)
                return spell_pairs_tail(tabs, sp1, sp2, r1.shape[0])
            return f

        def count_pairs_body(tabs, pile_in, rest):
            sp1 = sp_unflatten(rest[:NSP])
            sp2 = sp_unflatten(rest[NSP:2 * NSP])
            amb1, amb2, conc, pre_punt, disc_susp = rest[2 * NSP:]
            n_loc = sp1["oriented"].shape[0]
            rep = rep_of(tabs, pile_in)
            c1, ce1, cp1, ok1, nh1 = mate_counts(tabs, sp1, rep,
                                                 self._with_primary, amb1)
            c2, ce2, cp2, ok2, nh2 = mate_counts(tabs, sp2, rep,
                                                 self._with_primary, amb2)
            punt = (conc & (nh1 | nh2)) | disc_susp
            excl = pre_punt | disc_susp
            used = conc & (ok1 | ok2) & ~punt
            o1 = ok1 & used
            o2 = ok2 & used
            cnt = c1 * o1[:, None] + c2 * o2[:, None]
            cnt_ex = ce1 * o1[:, None] + ce2 * o2[:, None]
            cnt_px = cp1 * o1[:, None] + cp2 * o2[:, None]
            # punted pairs are re-counted by the host rescue
            n_reads_m = jnp.sum(((conc & ~punt)[:, None] & jnp.stack([
                (sp1["n_novel_w"] <= max_novel) & (sp1["n_valid_w"] > 0),
                (sp2["n_novel_w"] <= max_novel) & (sp2["n_valid_w"] > 0),
            ], 1)).astype(jnp.int32))
            cnts = [cnt]
            if NLEV > 1:
                cnts.append(cnt_ex)
            if NLEV > 2:
                cnts.append(cnt_px)
            return assemble_buf_b(pack_classes(
                cnts, used, punt, excl, n_reads_m, n_loc))

        def make_count_multi(m, T):
            """Count pass over T spelling tiers in ONE dispatch: each
            shard concatenates its per-tier local rows (row-independent
            gate/count; only the psum'd totals are global), so the
            whole batch pays one roundtrip instead of T."""
            NS = self._NSTATE[m]
            body = count_single_body if m == 1 else count_pairs_body

            def f(*args):
                tabs = args[:n_tables]
                pile_in = args[n_tables]
                rest = args[n_tables + 1:]
                parts = [rest[t * NS:(t + 1) * NS] for t in range(T)]
                cat = parts[0] if T == 1 else tuple(
                    jnp.concatenate([p[k] for p in parts], 0)
                    for k in range(NS))
                return body(tabs, pile_in, cat)
            return f

        # -- 6. staged SQUAREM EM over the device-resident class shard -- #
        def em_shard(remove_low, use_len, cnt, w, include, restrict):
            """One EM level (the reference's single_abundance,
            typing_common.py:1282-1410): per-read class = argmax of the
            compatibility counts over `include`d alleles (add_stat,
            typing_core.py:1171-1236), intersected with the `restrict`
            set from the previous stage (the hierarchical staging of
            typing_core.py:1679-1789); SQUAREM with L1 diff < 1e-4,
            1000-iteration cap, optional low-abundance pruning and
            length normalization."""
            mxv = jnp.max(jnp.where(include[None, :], cnt, -1), 1)
            cls = ((cnt == mxv[:, None]) & include[None, :]
                   & restrict[None, :] & (w > 0)[:, None])
            M = cls.astype(jnp.float32)
            wl = w * cls.any(1)

            def norm(p):
                if use_len:
                    p = p * inv_len_d
                return p / jnp.maximum(p.sum(), 1e-30)

            # real-valued f32 products: full f32, never TF32 on a GPU
            hi = jax.lax.Precision.HIGHEST

            def nxt(p):
                denom = jnp.dot(M, p, precision=hi)
                qv = jnp.where(denom > 0, wl / jnp.maximum(denom, 1e-30),
                               0.0)
                return norm(jax.lax.psum(jnp.dot(M.T, qv, precision=hi),
                                         axis) * p)

            sizes = jnp.maximum(M.sum(1), 1.0)
            p0 = norm(jax.lax.psum(jnp.dot(M.T, wl / sizes, precision=hi),
                                   axis))

            def body(state):
                p, _, it = state
                p1 = nxt(p)
                p2 = nxt(p1)
                r = p1 - p
                v = p2 - p1 - r
                ssv = jnp.sum(v * v)
                gamma = -jnp.sqrt(jnp.sum(r * r)
                                  / jnp.maximum(ssv, 1e-30))
                accel = jnp.maximum(
                    0.0, p - 2 * gamma * r + gamma * gamma * v)
                p_new = jnp.where(ssv > 0.0, nxt(accel), p1)
                diff = jnp.sum(jnp.abs(p_new - p))
                if remove_low:
                    p_new = jnp.where(
                        it >= 10,
                        jnp.where(p_new >= p_new.max() / 10.0, p_new, 0.0),
                        p_new)
                return p_new, diff, it + 1

            def cond(state):
                _, diff, it = state
                return (diff > 1e-4) & (it < em_iters)

            p, _, _ = jax.lax.while_loop(
                cond, body, (p0, jnp.float32(1.0), jnp.int32(0)))
            if remove_low:
                p = jnp.where(p >= p.max() / 10.0, p, 0.0)
            return norm(p)

        specs_t = tuple([P()] * n_tables)
        outs = (P(axis), P(axis), P(axis), P(), P(), P(axis))
        self._count_single = jax.jit(shard_map(
            shard_single, mesh, in_specs=specs_t + (P(axis),),
            out_specs=outs, check_rep=False))
        self._count_pairs = jax.jit(shard_map(
            shard_pairs, mesh, in_specs=specs_t + (P(axis), P(axis)),
            out_specs=outs, check_rep=False))
        cls_outs = (P(axis), P(axis), P(axis), P(axis), P(axis))
        # spelling tiers: reads are partitioned by their pair's WIDE
        # candidate count (place pass) so the hypothesis budget matches
        # the local indel density — H=2 far from any indel (the common
        # case on small genes), H=3 near one, the full single+pair set
        # near clusters.  The wide window contains the slot window, so
        # a low tier drops only hypotheses the full program would have
        # scored invalid: tiered == full, read for read.
        self._tier_cfg = ((0, ()), (1, ()),
                          (max_indel_cand, PAIR_COMBOS))
        self._place_single_p = jax.jit(shard_map(
            place_single, mesh, in_specs=specs_t + (P(axis),),
            out_specs=P(axis), check_rep=False))
        self._place_pairs_p = jax.jit(shard_map(
            place_pairs, mesh, in_specs=specs_t + (P(axis), P(axis)),
            out_specs=P(axis), check_rep=False))
        self._spell_single_t = [jax.jit(shard_map(
            make_spell_single(ns, prs), mesh,
            in_specs=specs_t + (P(axis),) * 4,
            out_specs=(P(axis),) * (1 + self._NSTATE[1]),
            check_rep=False)) for ns, prs in self._tier_cfg]
        self._spell_pairs_t = [jax.jit(shard_map(
            make_spell_pairs(ns, prs), mesh,
            in_specs=specs_t + (P(axis),) * 8,
            out_specs=(P(axis),) * (1 + self._NSTATE[2]),
            check_rep=False)) for ns, prs in self._tier_cfg]
        # fused place+spell at the gene's hypothesis ceiling: one
        # dispatch for the whole batch (no place fetch, no tier
        # partition roundtrip) — engaged by count_classes when the
        # ceiling keeps H small (low-indel-density genes, where the
        # saved roundtrips outweigh the extra hypothesis planes)
        fused_ns = self._fused_ns
        fused_prs = tuple((u, v) for u in range(fused_ns)
                          for v in range(u + 1, fused_ns))
        self._fused_H = 1 + 2 * fused_ns + 3 * len(fused_prs)

        def spell_fused_single(*args):
            tabs = args[:n_tables]
            reads = args[n_tables]
            sp = mate_spell(tabs, reads, pair_combos=fused_prs,
                            n_single=fused_ns)
            return spell_single_tail(tabs, sp, reads.shape[0])

        def spell_fused_pairs(*args):
            tabs = args[:n_tables]
            r1, r2 = args[n_tables], args[n_tables + 1]
            sp1 = mate_spell(tabs, r1, pair_combos=fused_prs,
                             n_single=fused_ns)
            sp2 = mate_spell(tabs, r2, pair_combos=fused_prs,
                             n_single=fused_ns)
            return spell_pairs_tail(tabs, sp1, sp2, r1.shape[0])

        self._spell_fused = {
            1: jax.jit(shard_map(
                spell_fused_single, mesh, in_specs=specs_t + (P(axis),),
                out_specs=(P(axis),) * (1 + self._NSTATE[1]),
                check_rep=False)),
            2: jax.jit(shard_map(
                spell_fused_pairs, mesh,
                in_specs=specs_t + (P(axis), P(axis)),
                out_specs=(P(axis),) * (1 + self._NSTATE[2]),
                check_rep=False))}
        self._count_multi = {
            (m, T): jax.jit(shard_map(
                make_count_multi(m, T), mesh,
                in_specs=(specs_t + (P(),)
                          + (P(axis),) * (T * self._NSTATE[m])),
                out_specs=cls_outs, check_rep=False))
            for m in (1, 2) for T in (1, 2, 3)}

        # device-side concat of the per-tier spell buffers: the spell
        # pass fetches ONE array instead of one per tier — each fetch
        # pays a device roundtrip
        ndev_c = self.n_devices

        def _combine(*bufs):
            return jnp.concatenate(
                [b.reshape(ndev_c, -1) for b in bufs], axis=1)

        self._combine_bufs = jax.jit(_combine)
        self._em_steps = {
            key: jax.jit(shard_map(
                functools.partial(em_shard, *key), mesh,
                in_specs=(P(axis), P(axis), P(), P()), out_specs=P(),
                check_rep=False))
            for key in ((False, False), (True, False), (True, True))}

        def shard_debug(*args):
            tabs, reads = args[:n_tables], args[n_tables]
            cnt, _, passed, use_r, lefts, rights, needs_host = \
                mate_pipeline(tabs, reads)
            return (cnt, passed, use_r, lefts, rights, needs_host)

        self._debug = jax.jit(shard_map(
            shard_debug, mesh, in_specs=specs_t + (P(axis),),
            out_specs=(P(axis),) * 6, check_rep=False))

    # ------------------------------------------------------------------ #
    def encode(self, seqs):
        return encode_reads(seqs, self.read_len)

    def _pad(self, codes, bucket=False):
        n, d = codes.shape[0], self.n_devices
        target = n
        if bucket:
            # eighth-of-octave bucketing bounds compiled program shapes
            # to ~8 per size octave at <= 12.5% padding overhead (pad
            # rows are code 4 = all-N: n_valid 0, weight 0, no punt)
            step = max(_pow2(max(n, 1), lo=256) // 8, 32)
            target = ((max(n, 1) + step - 1) // step) * step
        target = ((target + d - 1) // d) * d
        if n < target:
            pad = np.full((target - n, codes.shape[1]), 4, np.int8)
            codes = np.concatenate([codes, pad])
        return codes

    # ------------------------------------------------------------------ #
    # production front door: spell pass -> host pileup merge -> count
    # pass against the final pileup
    # ------------------------------------------------------------------ #
    @staticmethod
    def _unpack_bits(words, n_loc):
        return ((words[:, None] >> np.arange(32, dtype=np.uint32))
                & 1).astype(bool).reshape(-1)[:n_loc]

    def count_classes(self, r1_codes: np.ndarray, r2_codes=None,
                      bucket: bool = True, merge_pileup=None,
                      overlap=None):
        """Run the two-pass production program.  Returns a dict:
          levels: {"full"|"exon"|"primary":
                      (rows uint32 [U, W32], weights int64 [U],
                       totals int64 [A])}
          pileup: int32 [P, 6]      (the FINAL pileup every gate
                                     decision was taken against)
          punt:   bool [n]          (reads/pairs for the host rescue)
          excl:   bool [n]          (reads whose device spelling was
                                     excluded from the device pileup —
                                     only THEIR host alignments belong
                                     in the merged pileup)
          n_reads, n_pairs: int     (report accounting)

        `merge_pileup(pile_dev, excl, winner) -> [P, 6]` is called
        between the passes: the caller aligns the excluded pairs
        host-side and returns the merged (host-full) pileup; the count
        pass then gates and counts against it, so device-kept reads see
        exactly the representative sets the host-full run would
        (no stale-pileup drift, no re-gate loop).  When None, the count
        pass gates against the device pileup unchanged."""
        n = r1_codes.shape[0]
        ndev = self.n_devices
        n_mates = 1 if r2_codes is None else 2
        NLEV, W32, A = self._NLEV, self._W32, self.A
        P6 = self.P_bb * 6

        # fused place+spell when the gene's hypothesis ceiling is small
        # (H <= 8: every read's wide window holds <= 2 catalog indels):
        # one dispatch for the whole batch instead of place -> fetch ->
        # per-tier spell, trading the roundtrips for extra hypothesis
        # planes (threshold chosen before the H100; not yet measured
        # there)
        fuse = (self._fused_H <= 8
                and os.environ.get("HGTPU_FUSED_SPELL", "auto") != "off")
        if fuse:
            _t_spell = TRACE.stage("device.spell")
            _t_spell.__enter__()
            c1t = self._pad(r1_codes, bucket)
            n_pad_t = c1t.shape[0]
            if n_mates == 1:
                aout = self._spell_fused[1](
                    *self._tables, jnp.asarray(c1t))
            else:
                c2t = self._pad(r2_codes, bucket)
                aout = self._spell_fused[2](
                    *self._tables, jnp.asarray(c1t), jnp.asarray(c2t))
            tinfo = [(0, np.arange(n), n_pad_t, aout)]
        else:
            # -- place pass over the full batch: tier assignment ------ #
            _t_place = TRACE.stage("device.place")
            _t_place.__enter__()
            p1f = self._pad(r1_codes, bucket)
            if n_mates == 1:
                pl = np.asarray(self._place_single_p(
                    *self._tables, jnp.asarray(p1f)))
            else:
                p2f = self._pad(r2_codes, bucket)
                pl = np.asarray(self._place_pairs_p(
                    *self._tables, jnp.asarray(p1f), jnp.asarray(p2f)))
            pl = pl[:n].T
            _t_place.__exit__(None, None, None)
            _t_spell = TRACE.stage("device.spell")
            _t_spell.__enter__()
            tier = np.clip(pl[3], 0, 2)
            if n_mates == 2:
                tier = np.maximum(tier, np.clip(pl[7], 0, 2))
            idx_t = [np.flatnonzero(tier == t) for t in range(3)]

            # -- per-tier pass A: all dispatched, then fetched -------- #
            tinfo = []
            for t, idx in enumerate(idx_t):
                if len(idx) == 0:
                    continue
                c1t = self._pad(r1_codes[idx], bucket)
                n_pad_t = c1t.shape[0]

                def padi(row, n_pad_t=n_pad_t, idx=idx):
                    out = np.zeros(n_pad_t, np.int32)
                    out[:len(idx)] = row[idx]
                    return jnp.asarray(out)

                if n_mates == 1:
                    aout = self._spell_single_t[t](
                        *self._tables, jnp.asarray(c1t),
                        padi(pl[0]), padi(pl[1]), padi(pl[2]))
                else:
                    c2t = self._pad(r2_codes[idx], bucket)
                    aout = self._spell_pairs_t[t](
                        *self._tables, jnp.asarray(c1t), jnp.asarray(c2t),
                        padi(pl[0]), padi(pl[1]), padi(pl[2]),
                        padi(pl[4]), padi(pl[5]), padi(pl[6]))
                tinfo.append((t, idx, n_pad_t, aout))

        pile_dev = np.zeros((self.P_bb, 6), np.int64)
        excl = np.zeros(n, bool)
        winner = [dict(l=np.zeros(n, np.int64),
                       rc=np.zeros(n, bool),
                       tier1=np.zeros(n, bool),
                       causes=np.zeros(n, np.int64),
                       iva=np.zeros(n, np.int64),
                       ivb=np.zeros(n, np.int64))
                  for _ in range(n_mates)]
        # ONE fetch for every tier's spell buffer (device-side concat)
        if len(tinfo) > 1:
            widths = [int(a[0].shape[0]) // ndev
                      for (_t, _i, _np_, a) in tinfo]
            comb = np.asarray(self._combine_bufs(
                *[a[0] for (_t, _i, _np_, a) in tinfo]))
            offs = np.concatenate([[0], np.cumsum(widths)])
            abufs = [comb[:, offs[k]:offs[k + 1]]
                     for k in range(len(tinfo))]
        else:
            abufs = [np.asarray(tinfo[0][3][0]).reshape(ndev, -1)]
        for ti, (t, idx, n_pad_t, aout) in enumerate(tinfo):
            abuf = abufs[ti]
            n_loc_t = n_pad_t // ndev
            npw_t = (n_loc_t + 31) // 32
            pile_dev += abuf[0, :P6].astype(np.int64).reshape(
                self.P_bb, 6)
            excl_t = np.zeros(n_pad_t, bool)
            wt = [dict() for _ in range(n_mates)]
            for mi in range(n_mates):
                for k in ("info", "iva", "ivb"):
                    wt[mi][k] = np.zeros(n_pad_t, np.uint32)
            for s in range(ndev):
                b = abuf[s]
                at = P6
                sl = slice(s * n_loc_t, (s + 1) * n_loc_t)
                excl_t[sl] = self._unpack_bits(b[at:at + npw_t], n_loc_t)
                at += npw_t
                for mi in range(n_mates):
                    for k in ("info", "iva", "ivb"):
                        wt[mi][k][sl] = b[at:at + n_loc_t]
                        at += n_loc_t
            m = len(idx)
            excl[idx] = excl_t[:m]
            for mi in range(n_mates):
                info = wt[mi]["info"][:m]
                winner[mi]["l"][idx] = ((info >> 2)
                                        & ((1 << 26) - 1)).astype(np.int64)
                winner[mi]["causes"][idx] = (info >> 28).astype(np.int64)
                winner[mi]["rc"][idx] = ((info >> 1) & 1).astype(bool)
                winner[mi]["tier1"][idx] = (info & 1).astype(bool)
                winner[mi]["iva"][idx] = wt[mi]["iva"][:m].astype(np.int64)
                winner[mi]["ivb"][idx] = wt[mi]["ivb"][:m].astype(np.int64)
        pile_dev = pile_dev.astype(np.int32)
        _t_spell.__exit__(None, None, None)

        # -- host merge: the final (host-full) pileup ----------------- #
        final_pile = pile_dev
        if merge_pileup is not None:
            final_pile = merge_pileup(pile_dev, excl, winner)

        # -- pass B: ONE dispatch gates + counts + packs every tier's
        # rows (per-shard concat inside the program) vs the final
        # pileup -- #
        _t_cnt = TRACE.stage("device.countB")
        _t_cnt.__enter__()
        pin = jnp.asarray(np.ascontiguousarray(
            final_pile, dtype=np.int32).reshape(-1))
        T = len(tinfo)
        flat_state = [a for (_t, _i, _np_, aout) in tinfo
                      for a in aout[1:]]
        out = self._count_multi[(n_mates, T)](*self._tables, pin,
                                              *flat_state)
        n_loc_list = [n_pad_t // ndev for (_t, _i, n_pad_t, _a) in tinfo]
        n_loc = sum(n_loc_list)
        cap = min(self._class_cap, NLEV * n_loc,
                  max(512, 65536 // max(W32, 1)))
        npw = (n_loc + 31) // 32
        BUF = cap * W32 + 2 * cap + NLEV * A + 2 * npw + 4
        # per-shard local row -> original read index (concat layout:
        # tier-0 local rows, then tier-1, then tier-2 per shard) —
        # built BEFORE the blocking fetch so host prep overlaps the
        # device count pass
        orig_shard = np.full((ndev, n_loc), n, np.int64)
        off_t = np.concatenate([[0], np.cumsum(n_loc_list)])
        for ti, (_t, idx, n_pad_t, _a) in enumerate(tinfo):
            nl = n_loc_list[ti]
            om = np.full(n_pad_t, n, np.int64)
            om[:len(idx)] = idx
            orig_shard[:, off_t[ti]:off_t[ti] + nl] = \
                om.reshape(ndev, nl)
        if overlap is not None:
            # host work independent of the count-pass output (e.g. the
            # punt rescue's fast-path memo prefill) runs while the
            # dispatched program executes on device
            overlap()
        buf = np.asarray(out[0]).reshape(ndev, BUF)

        rows_parts, uw_parts, ord_parts = [], [], []
        punt = np.zeros(n + 1, bool)
        n_reads = 0
        n_pairs = 0
        totals = None
        overflow_fetch = None
        for s in range(ndev):
            b = buf[s]
            at = cap * W32
            rows_s = b[:at].reshape(cap, W32)
            uw_s = b[at:at + cap].astype(np.int64)
            min_s = b[at + cap:at + 2 * cap].astype(np.int64)
            at += 2 * cap
            tt = b[at:at + NLEV * A].astype(np.int64).reshape(NLEV, A)
            at += NLEV * A
            pw = b[at:at + npw]
            at += 2 * npw     # punt words + excl words
            n_uniq, nr, npair, _np_ = (int(x) for x in b[at:at + 4])
            if s == 0:
                totals = tt           # psum-replicated
            n_reads += nr
            n_pairs += npair
            bits = self._unpack_bits(pw, n_loc)
            punt[orig_shard[s][bits]] = True
            if n_uniq > cap:
                # rare overflow: fetch the full sorted rows for this
                # shard through the exact secondary leaves
                if overflow_fetch is None:
                    overflow_fetch = [np.asarray(x) for x in out[1:5]]
                fs_all, first_all, uw_all, min_all = overflow_fetch
                blk = NLEV * n_loc
                fs_s = fs_all[s * blk:(s + 1) * blk]
                first_s = first_all[s * blk:(s + 1) * blk]
                uwf = uw_all[s * blk:(s + 1) * blk]
                minf = min_all[s * blk:(s + 1) * blk]
                fr = np.flatnonzero(first_s)
                rows_s = fs_s[fr]
                uw_s = uwf[:len(fr)].astype(np.int64)
                min_s = minf[:len(fr)].astype(np.int64)
                n_uniq = len(fr)
            rows_s = rows_s[:n_uniq]
            uw_s = uw_s[:n_uniq]
            min_s = min_s[:n_uniq]
            keep = uw_s > 0
            rows_parts.append(rows_s[keep])
            uw_parts.append(uw_s[keep])
            # global first-seen order: (level, original read index)
            m = min_s[keep]
            ord_parts.append((m // n_loc) * np.int64(n + 1)
                             + orig_shard[s][m % n_loc])
        punt = punt[:n]
        rows = np.concatenate(rows_parts) if rows_parts else \
            np.zeros((0, W32), np.uint32)
        uws = np.concatenate(uw_parts) if uw_parts else \
            np.zeros(0, np.int64)
        order_key = np.concatenate(ord_parts) if ord_parts else \
            np.zeros(0, np.int64)

        levels = {}
        order = {}
        for li, (name, _inc) in enumerate(self._levels):
            sel = np.flatnonzero((order_key // (n + 1)) == li)
            sub = sel[np.argsort(order_key[sel], kind="stable")]
            levels[name] = (rows[sub], uws[sub], totals[li])
            # first-seen original read index per row — the multi-host
            # merge interleaves processes' rows by GLOBAL read index so
            # accumulation order equals a single-process run
            order[name] = order_key[sub] % (n + 1)
        _t_cnt.__exit__(None, None, None)
        return dict(levels=levels, order=order, pileup=final_pile,
                    punt=punt, excl=excl, n_reads=n_reads,
                    n_pairs=n_pairs, winner=winner)

    # ------------------------------------------------------------------ #
    def _solve(self, counted):
        """Staged EM over the device-resident class counts (the host
        hierarchy of typer/engine.py:809-874): exon-level EM over rep
        alleles, expansion of winning groups, full-level EM restricted
        to the expanded set with length normalization."""
        cnt, cnt_ex, w, totals, n_used, punt = counted
        if not self._staged:
            prob = np.asarray(
                self._em_steps[(False, False)](cnt, w, self._ones,
                                               self._ones))
            return prob, totals, n_used, punt
        exon_prob = np.asarray(
            self._em_steps[(True, False)](cnt_ex, w, self._rep_mask,
                                          self._ones))
        sel, prob_sum = self._exon_winners(exon_prob)
        if sel.any():
            full = np.asarray(
                self._em_steps[(True, True)](cnt, w, self._ones,
                                             jnp.asarray(sel)))
            prob = np.where(sel, full * prob_sum, exon_prob)
        else:
            prob = exon_prob
        return prob, totals, n_used, punt

    def _exon_winners(self, exon_prob: np.ndarray):
        """Expandable exon-stage winners: the shared staging policy
        (typer/staging.expansion_winners — same constants and selection
        rule as the host engine) over the device EM's abundance vector.
        Zero-probability alleles never appear in the host's ranked list
        (single_abundance emits positives only), so they are filtered
        before ranking here too."""
        from ..typer.staging import expansion_winners

        order = np.argsort(-exon_prob, kind="stable")
        ranked = [(int(i), float(exon_prob[i])) for i in order
                  if exon_prob[i] > 0.0]
        idx_set, prob_sum = expansion_winners(ranked, self._rep_groups)
        sel = np.zeros(self.A, bool)
        sel[sorted(idx_set)] = True
        return sel, prob_sum

    def count_em_global(self, global_codes):
        """Public single-dispatch EM entry over an already-sharded
        GLOBAL code array (multi-host device-EM path: every process
        passes the same global array built from its local shard).
        Returns (prob, totals, n_used, punt_local) — punt_local is this
        process's addressable slice of the punt mask; the caller MUST
        rescue or account for it (never drop it silently)."""
        counted = self._count_single(*self._tables, global_codes)
        prob, totals, n_used, punt = self._solve(counted)
        punt_local = np.concatenate(
            [np.asarray(s.data).reshape(-1)
             for s in punt.addressable_shards]) \
            if hasattr(punt, "addressable_shards") else np.asarray(punt)
        return (np.asarray(prob), np.asarray(totals), float(n_used),
                punt_local)

    def __call__(self, read_codes: np.ndarray):
        n = read_codes.shape[0]
        counted = self._count_single(
            *self._tables, jnp.asarray(self._pad(read_codes)))
        prob, totals, n_used, punt = self._solve(counted)
        return (np.asarray(prob), np.asarray(totals), float(n_used),
                np.asarray(punt)[:n])

    def call_pairs(self, r1_codes: np.ndarray, r2_codes: np.ndarray):
        n = r1_codes.shape[0]
        counted = self._count_pairs(
            *self._tables, jnp.asarray(self._pad(r1_codes)),
            jnp.asarray(self._pad(r2_codes)))
        prob, totals, n_used, punt = self._solve(counted)
        return (np.asarray(prob), np.asarray(totals), float(n_used),
                np.asarray(punt)[:n])

    def call_allele(self, read_codes: np.ndarray):
        prob, totals, n_used, _ = self(read_codes)
        top = int(np.argmax(prob))
        return self.gene.allele_names[top], float(prob[top]), totals, n_used
