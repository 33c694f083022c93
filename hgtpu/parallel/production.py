"""The production typing path: the sharded device program IS the
pipeline, the host engine rescues the punt mask.

The reference's production path is its parallel path — typing_process
fans genotyping_locus over a pool and that is what every user runs
(hisatgenotype:321-686, 613-665).  Here the equivalent holds on device:
`type_reads_device` runs the connected shard_map program
(parallel/e2e.ShardedTyper) — placement, pileup-gated spelling,
compatibility counting, on-device class dedup — in ONE dispatch + ONE
fetch, then:

1. merges the packed per-level equivalence classes into the host
   StatAccumulators (typer/counting.py — identical class identity,
   weights, totals),
2. rescues the punt mask through the host engine (the bit-exact
   reference path: GeneAligner + GeneTyper.read_hts) using the DEVICE
   pileup for error correction, so punted reads see the same
   representative-base sets the device gated with, and merges their
   class counts in before EM — no read is ever dropped
   (the reference never drops in-budget reads,
   typing_core.py:800-1543),
3. runs the reference's staged EM hierarchy (typer/staging.py) on the
   merged cmpt dicts.

A 1-device mesh on a single chip is the same compiled program as an
8-device slice; `pipeline.type_reads` routes here whenever the options
are device-compatible (see `device_typing_supported`).
"""
from __future__ import annotations

import numpy as np

from ..db.catalog import GeneRef
from ..typer.counting import StatAccumulator
from ..typer.engine import (GeneTyper, GeneTypingResult, NovelVars,
                            TypingOptions, _concordant, _gene_shared_state)
from ..utils.trace import TRACE

_MESH_CACHE = {}


def default_mesh():
    """One data-parallel mesh over every local device (a single real
    chip in production; 8 virtual CPU devices under the test env)."""
    import jax

    from .sharded import make_mesh

    n = len(jax.devices())
    if n not in _MESH_CACHE:
        _MESH_CACHE[n] = make_mesh(n)
    return _MESH_CACHE[n]


def device_typing_supported(opts: TypingOptions, paired: bool) -> bool:
    """Options the device program covers.  Anything else falls back to
    the host engine (the same result, computed the reference way):
    assembly needs per-read ht strings, the linear path bypasses the
    graph, CODIS needs the pair-interdistance disambiguation, and the
    device gate IS error correction (so error_correction off must run
    host).  Discordant paired mode skips the concordance the paired
    program hardwires."""
    if opts.assembly or opts.linear_typing:
        return False
    if not opts.error_correction or not opts.use_alts:
        return False
    if opts.family == "codis":
        return False
    if paired and opts.allow_discordant:
        return False
    return True


def _mesh_key(mesh):
    """Stable identity for a Mesh: axis names + the device ids in mesh
    order.  Never key on id(mesh) — a GC'd mesh's id can be reused by a
    different mesh of the same shape (the stale-id bug class)."""
    return (mesh.axis_names,
            tuple(d.id for d in mesh.devices.flat))


def _shared_sharded_typer(gene: GeneRef, opts: TypingOptions, mesh,
                          read_len: int):
    from .e2e import ShardedTyper

    st = _gene_shared_state(gene)
    key = ("sharded_typer", _mesh_key(mesh), read_len, opts.family,
           opts.num_editdist, bool(opts.type_primary_exons))
    hit = st.get(key)
    if hit is None:
        hit = ShardedTyper(gene, mesh, read_len=read_len,
                           max_novel=opts.num_editdist,
                           family=opts.family,
                           with_primary=opts.type_primary_exons)
        st[key] = hit
    return hit


def _snp_lookup(gene: GeneRef):
    """(backbone pos, base char) -> catalog SNP index, cached on the
    gene's shared typing state."""
    from ..db.catalog import VT_SINGLE

    st = _gene_shared_state(gene)
    lk = st.get("snp_char_lookup")
    if lk is None:
        lk = {}
        for vi in np.flatnonzero(gene.var_type == VT_SINGLE):
            lk[(int(gene.var_pos[vi]), gene.var_data[vi])] = int(vi)
        st["snp_char_lookup"] = lk
    return lk


def _reconstruct_aln(gene, rid, mate, seq, l, rc_flag, ivar_a, ivar_b,
                     snp_lookup):
    """Tier-1 rescue: rebuild the host aligner's ReadAln from the device
    winner (span start, orientation, up to two claimed catalog indels
    in backbone order) — valid only when the device certified the
    winner as the unique best alignment (e2e.mate_flags tier1).
    Returns None when the read falls outside the backbone (those pairs
    realign through tier 2)."""
    from ..align.types import ReadAln
    from ..align.verify import GeneVerifier
    from ..db.catalog import VT_DELETION
    from ..utils.dna import encode_seq, revcomp

    oriented = revcomp(seq) if rc_flag else seq
    codes = encode_seq(oriented)
    L = len(oriented)
    bb = gene.backbone_enc
    P = len(bb)
    n_vars = gene.n_vars
    claimed = [int(v) for v in (ivar_a, ivar_b) if v < n_vars]
    claimed.sort(key=lambda v: int(gene.var_pos[v]))
    nm = 0
    ops = []
    # walk the claimed chain left-to-right: read cursor rp, backbone
    # cursor bp; each claimed indel closes the preceding match segment
    segs = []
    rp, bp = 0, l
    if l < 0:
        return None
    for vi in claimed:
        vt = int(gene.var_type[vi])
        p = int(gene.var_pos[vi])
        q = rp + (p - bp)
        if vt == VT_DELETION:
            dlen = int(gene.var_len[vi])
            if not (rp < q < L):
                return None
            segs.append((rp, q - rp, bp))
            ops.append(("deletion", p, dlen, vi, gene.var_data[vi]))
            rp, bp = q, p + dlen
        else:
            iseq = gene.var_data[vi]
            il = len(iseq)
            if not (rp < q < L - il):
                return None
            segs.append((rp, q - rp, bp))
            ops.append(("insertion", p, il, vi, iseq))
            for a, b2 in zip(oriented[q:q + il], iseq):
                if a != b2:
                    nm += 1
            rp, bp = q + il, p
    segs.append((rp, L - rp, bp))
    if bp + (L - rp) > P:
        return None
    has_indel = bool(claimed)
    for rs, ln, bs in segs:
        if ln <= 0:
            continue
        sub = codes[rs:rs + ln]
        ref = bb[bs:bs + ln]
        for j in np.flatnonzero(sub != ref):
            base = oriented[rs + int(j)]
            vidx = snp_lookup.get((bs + int(j), base), -1)
            if vidx < 0:
                nm += 1
            ops.append(("mismatch", bs + int(j), 1, vidx, base))
    ops.sort(key=lambda e: (e[1], 0 if e[0] == "insertion" else 1))
    cmp_list, right = GeneVerifier.ops_to_cmp_list(ops, l, L)
    return ReadAln(read_id=rid, mate=mate, pos=int(l), right=int(right),
                   cmp=cmp_list, nm=int(nm), is_rc=bool(rc_flag),
                   seq=oriented, codes=codes, catalog=(nm == 0),
                   has_indel=has_indel)


def _align_punts(gene, opts, reads_1, reads_2, idx, winner, aligner=None):
    """Host alignment of the punted pairs' mates: tier 1 reconstructs
    the certified device winner without realignment (e2e.mate_flags
    tier1), tier 2 realigns through GeneAligner.  Returns
    {pair index -> [ReadAln, ...]} (both mates together)."""
    by_pair = {int(i): [] for i in idx}
    if len(idx) == 0:
        return by_pair
    from ..align import GeneAligner

    snp_lk = _snp_lookup(gene) if winner is not None else None
    mate_reads = [reads_1] + ([reads_2] if reads_2 is not None else [])
    mate_tag = ["L", "R"]
    need_align = [[] for _ in mate_reads]
    for i in idx:
        for mi, reads in enumerate(mate_reads):
            a = None
            if winner is not None and winner[mi]["tier1"][i]:
                nm_i, sq = reads[i]
                a = _reconstruct_aln(gene, nm_i, mate_tag[mi], sq,
                                     int(winner[mi]["l"][i]),
                                     bool(winner[mi]["rc"][i]),
                                     int(winner[mi]["iva"][i]),
                                     int(winner[mi]["ivb"][i]), snp_lk)
            if a is None:
                need_align[mi].append(i)
            else:
                by_pair[int(i)].append(a)
    if any(need_align):
        aligner = aligner or GeneAligner(
            gene, num_editdist=opts.num_editdist,
            leftmost=opts.family == "codis")
        groups = []
        group_rows = []
        for mi, rows in enumerate(need_align):
            if rows:
                sub = [mate_reads[mi][i] for i in rows]
                groups.append(([n for n, _ in sub],
                               [s for _, s in sub], mate_tag[mi]))
                group_rows.append(rows)
        with TRACE.stage("rescue.align"):
            batches = aligner.align_batches(groups)
        for rows, alns in zip(group_rows, batches):
            for i, a in zip(rows, alns):
                if a is not None:
                    by_pair[int(i)].append(a)
    return by_pair


def _merge_pileup(gene, opts, pileup_counts, by_pair, excl_idx):
    """The final (host-full) pileup: the device pileup — which EXCLUDES
    the `excl` pairs' possibly mis-framed device spellings
    (e2e.mate_flags) — plus exactly those pairs' HOST alignments.
    Rep-gate-only punts are NOT re-added: their device winner
    contribution (identical to the host alignment's bases) is already
    in the device counts, so adding the host alignment again would
    double-count them (get_mpileup adds each concordant alignment once,
    typing_common.py:1059-1184)."""
    from ..typer.mpileup import Mpileup

    mpileup = Mpileup(gene)
    mpileup.counts = np.ascontiguousarray(pileup_counts.astype(np.int32))
    bulk = []
    for i in excl_idx:
        alns = by_pair.get(int(i))
        if not alns:
            continue
        conc = _concordant(alns, opts)
        if conc is not None:
            bulk.extend(conc)
    mpileup.add_alignments_bulk(bulk)
    mpileup.finalize()
    return mpileup


def _rescued_fragment_rows(gene, opts, reads_1, by_pair, idx, mpileup,
                           pre=None):
    """Per-fragment compatibility-count rows for the punted pairs —
    the multi-host export form of `_count_rescued`: instead of folding
    into the local accumulators, emit (read-id sort keys, per-fragment
    [G, A] count rows at the full/exon/primary levels, n_reads, novel)
    so the caller can merge fragments from every process in global
    sorted-read-id order and feed ONE add_reads_batch per level —
    accumulating exactly as a single-process rescue over the
    concatenated punt set would.  `pre` is _prepare_rescue's
    (typer, memo) when the fast-path prefill overlapped the count
    pass."""
    from ..align.types import aln_key

    novel = NovelVars()
    A = gene.n_alleles
    empty = (np.zeros((0, 64), np.uint8),) + \
        tuple(np.zeros((0, A), np.int32) for _ in range(3)) + (0,)
    if len(idx) == 0:
        return empty + (novel,)
    if pre is not None:
        typer_h, hts_memo = pre
    else:
        typer_h = GeneTyper(gene, opts)
        hts_memo = {}
    by_read = {}
    for i in idx:
        alns = by_pair.get(int(i))
        if alns:
            by_read.setdefault(
                reads_1[i][0].split("|")[0], []).extend(alns)
    if not by_read:
        return empty + (novel,)
    # the read_hts fast paths (bit-identical, per-alignment
    # deterministic) prefill the memo exactly as the single-process
    # rescue does
    _fast_path_fill(typer_h, opts, by_read.values(), mpileup, hts_memo)
    n_reads = 0
    frag_ids = []
    frag_hts = []
    for read_id in sorted(by_read):
        alns = _concordant(by_read[read_id], opts)
        if alns is None:
            continue
        left_hts, right_hts = set(), set()
        for a in alns:
            if a.nm > opts.num_editdist:
                continue
            n_reads += 1
            key = aln_key(a)
            hit = hts_memo.get(key, False)
            if hit is False:
                hit = typer_h.read_hts(a, novel, mpileup)
                hts_memo[key] = hit
            if hit is not None:
                (left_hts if a.mate == "L" else right_hts).update(hit)
            for alt in (a.alts or ()):
                alt_hts = typer_h.read_hts(alt, novel, mpileup)
                if alt_hts is not None:
                    (left_hts if a.mate == "L"
                     else right_hts).update(alt_hts)
        positive_hts = left_hts | right_hts
        if not positive_hts:
            continue
        frag_ids.append(read_id)
        frag_hts.append(positive_hts)
    if not frag_ids:
        return empty + (novel,)
    ht_cache = {}
    unique_hts = sorted(set().union(*frag_hts))
    typer_h.ht_masks_batch_host(unique_hts, novel, ht_cache)
    ht_idx = {h: k for k, h in enumerate(unique_hts)}
    U = len(unique_hts)
    mask_f = np.empty((U, A), np.int32)
    mask_e = np.empty((U, A), np.int32)
    mask_p = np.empty((U, A), np.int32)
    for k, h in enumerate(unique_hts):
        full, exon, primary = ht_cache[h]
        mask_f[k] = full
        mask_e[k] = exon
        mask_p[k] = primary
    G = len(frag_ids)
    rows_f = np.zeros((G, A), np.int32)
    rows_e = np.zeros((G, A), np.int32)
    rows_p = np.zeros((G, A), np.int32)
    for g, hts in enumerate(frag_hts):
        ks = [ht_idx[h] for h in hts]
        rows_f[g] = mask_f[ks].sum(0)
        rows_e[g] = mask_e[ks].sum(0)
        rows_p[g] = mask_p[ks].sum(0)
    L = max(len(r.encode()) for r in frag_ids)
    keys = np.zeros((G, L), np.uint8)
    for g, r in enumerate(frag_ids):
        b = r.encode()
        keys[g, :len(b)] = np.frombuffer(b, np.uint8)
    return keys, rows_f, rows_e, rows_p, n_reads, novel


def _fast_path_fill(typer_h, opts, alns_groups, mpileup, hts_memo):
    """Batch the read_hts fast paths (the vectorized twins type_gene
    uses) over every unique nm==0 all-catalog alignment in the given
    groups, prefilling `hts_memo`.  Keys already resolved in the memo
    are skipped, so the fill can run in two phases (overlap prefill of
    the excl set + the post-fetch remainder) with identical results —
    the fast paths are per-alignment deterministic and never register
    novel variants."""
    from ..align.types import aln_key

    uniq_clean, uniq_indel = {}, {}
    for alns0 in alns_groups:
        for a in alns0:
            if a.nm != 0:
                continue
            k = aln_key(a)
            if k in hts_memo or k in uniq_clean or k in uniq_indel:
                continue
            catalog, has_indel = a.catalog, a.has_indel
            if catalog is None:
                catalog = True
                has_indel = False
                for e in a.cmp:
                    if e[0] == "match":
                        continue
                    if e[3] is None or e[3] < 0:
                        catalog = False
                        break
                    if e[0] != "mismatch":
                        has_indel = True
            if not catalog:
                continue
            (uniq_indel if has_indel else uniq_clean)[k] = a
    with TRACE.stage("rescue.fast_path"):
        typer_h.clean_hts_batch(list(uniq_clean.values()), mpileup,
                                opts.error_correction, hts_memo)
        typer_h.indel_clean_hts_batch(list(uniq_indel.values()), mpileup,
                                      opts.error_correction, hts_memo)


def _prepare_rescue(gene, opts, reads_1, by_pair, idx, mpileup):
    """Rescue prep that is independent of the count-pass output, safe
    to run while the device count pass is in flight (count_classes'
    `overlap` hook): the GeneTyper construction and the fast-path memo
    prefill over the excl pairs' alignments.  Pure w.r.t. novel-variant
    state (the fast paths never register novels), and excl ⊆ punt (a
    pre-punting mate stays needs_host in the count pass; disc_susp
    punts directly), so no prefilled work is wasted on unpunted pairs."""
    typer_h = GeneTyper(gene, opts)
    hts_memo = {}
    _fast_path_fill(typer_h, opts,
                    (by_pair.get(int(i)) or () for i in idx),
                    mpileup, hts_memo)
    return typer_h, hts_memo


def _count_rescued(gene, opts, reads_1, by_pair, idx, mpileup, stats,
                   pre=None):
    """read_hts + count the punted pairs exactly as type_gene would,
    merging their classes into the device accumulators before EM.
    Corrections run against the merged (final) pileup.  `pre` is the
    (typer, memo) pair from _prepare_rescue when the prefill overlapped
    the device count pass.  Returns (n_reads, n_pairs, novel) added."""
    novel = NovelVars()
    if len(idx) == 0:
        return 0, 0, novel
    if pre is not None:
        typer_h, hts_memo = pre
    else:
        typer_h = GeneTyper(gene, opts)
        hts_memo = {}
    # iterate pairs in read-id order (the host engine's sorted-SAM
    # order) for identical accumulation order
    by_read = {}
    for i in idx:
        alns = by_pair.get(int(i))
        if alns:
            # pairs sharing a fragment-id prefix merge into ONE fragment
            # (the host engine's read-id-change grouping over sorted SAM)
            by_read.setdefault(
                reads_1[i][0].split("|")[0], []).extend(alns)

    from ..align.types import aln_key

    _fast_path_fill(typer_h, opts, by_read.values(), mpileup, hts_memo)

    full_stats, exon_stats, primary_stats = stats
    n_reads = 0
    n_pairs = 0
    ht_cache = {}
    grouped = {}
    A = gene.n_alleles
    _t_loop = TRACE.stage("rescue.hts_loop")
    _t_loop.__enter__()
    for read_id in sorted(by_read):
        alns = _concordant(by_read[read_id], opts)
        if alns is None:
            continue
        left_hts, right_hts = set(), set()
        for a in alns:
            if a.nm > opts.num_editdist:
                continue
            n_reads += 1
            key = aln_key(a)
            hit = hts_memo.get(key, False)
            if hit is False:
                hit = typer_h.read_hts(a, novel, mpileup)
                hts_memo[key] = hit
            if hit is not None:
                (left_hts if a.mate == "L" else right_hts).update(hit)
            for alt in (a.alts or ()):
                alt_hts = typer_h.read_hts(alt, novel, mpileup)
                if alt_hts is not None:
                    (left_hts if a.mate == "L"
                     else right_hts).update(alt_hts)
        positive_hts = left_hts | right_hts
        if not positive_hts:
            continue
        n_pairs += 1
        key = frozenset(positive_hts)
        hit = grouped.get(key)
        if hit is None:
            grouped[key] = [1, positive_hts]
        else:
            hit[0] += 1

    _t_loop.__exit__(None, None, None)
    # one vectorized mask batch + reduceat fold over all rescued pairs
    # (the type_gene stats fold, typer/engine.py) instead of per-pair
    # python
    if grouped:
        _t = TRACE.stage("rescue.fold")
        _t.__enter__()
        unique_hts = sorted(set().union(*(g[1] for g in grouped.values())))
        # same counting/fold selection as type_gene: the fused device
        # fold at scale / on an accelerator (bit-identical,
        # tests/test_device_count.py), the host reduceat fold otherwise
        from ..typer.engine import use_device_fold

        folded = None
        if use_device_fold(opts, A):
            folded = typer_h.device_fold_run(unique_hts, novel, grouped)
        if folded is not None:
            stats_levels = [full_stats, exon_stats, primary_stats] \
                if opts.family == "hla" else [full_stats]
            for packed, stx in zip(folded, stats_levels):
                if stx is not None:
                    stx.add_packed_batch(*packed)
        else:
            typer_h.ht_masks_batch_host(unique_hts, novel, ht_cache)
            ht_idx = {h: i for i, h in enumerate(unique_hts)}
            U = len(unique_hts)
            mask_f = np.empty((U, A), np.int32)
            mask_e = np.empty((U, A), np.int32)
            mask_p = np.empty((U, A), np.int32)
            for i, h in enumerate(unique_hts):
                full, exon, primary = ht_cache[h]
                mask_f[i] = full
                mask_e[i] = exon
                mask_p[i] = primary
            weights = np.fromiter((g[0] for g in grouped.values()),
                                  np.int64, len(grouped))
            flat = []
            starts = np.empty(len(grouped), np.int64)
            at = 0
            for gi, (_w, hts) in enumerate(grouped.values()):
                starts[gi] = at
                flat.extend(ht_idx[h] for h in hts)
                at += len(hts)
            flat = np.asarray(flat, np.int64)
            full_stats.add_reads_batch(
                np.add.reduceat(mask_f[flat], starts, axis=0), weights)
            if exon_stats is not None:
                exon_stats.add_reads_batch(
                    np.add.reduceat(mask_e[flat], starts, axis=0), weights)
            if primary_stats is not None:
                primary_stats.add_reads_batch(
                    np.add.reduceat(mask_p[flat], starts, axis=0), weights)
        _t.__exit__(None, None, None)
    return n_reads, n_pairs, novel


def type_reads_device(gene: GeneRef, reads_1, reads_2=None,
                      opts: TypingOptions = None, aligner=None, mesh=None):
    """Device-program typing of one gene's read set.

    reads_*: [(name, seq)].  Returns GeneTypingResult — the same
    contract as pipeline.type_reads, computed by the sharded device
    program with host rescue of the punt mask.
    """
    from .. import enable_compilation_cache

    enable_compilation_cache()
    opts = opts or TypingOptions()
    mesh = mesh or default_mesh()
    seqs_1 = [s for _, s in reads_1]
    seqs_2 = [s for _, s in (reads_2 or [])]
    max_len = max((len(s) for s in seqs_1 + seqs_2), default=100)
    read_len = max(100, ((max_len + 9) // 10) * 10)
    st = _shared_sharded_typer(gene, opts, mesh, read_len)

    with TRACE.stage("device.encode"):
        c1 = st.encode(seqs_1)
        c2 = st.encode(seqs_2) if reads_2 is not None else None

    # Two-pass protocol (e2e.count_classes): the spell pass returns the
    # device pileup + the exclusion mask; this callback aligns exactly
    # the excluded pairs host-side and merges their alignments into the
    # pileup (= the host-full pileup); the count pass then gates and
    # counts EVERY read against that final pileup — device-kept reads
    # and rescued reads see identical representative sets.
    holder = {}

    def _merge_cb(pile_dev, excl_mask, winner):
        idx = np.flatnonzero(excl_mask)
        bp = _align_punts(gene, opts, reads_1, reads_2, idx, winner,
                          aligner)
        with TRACE.stage("rescue.pileup"):
            mp = _merge_pileup(gene, opts, pile_dev, bp, idx)
        holder["by_pair"] = bp
        holder["mpileup"] = mp
        holder["excl_idx"] = idx
        return mp.counts

    def _overlap_cb():
        # rescue prep independent of the count-pass output runs while
        # the dispatched count program executes on device: the
        # GeneTyper build + the fast-path memo prefill over the excl
        # pairs (excl ⊆ punt, so none of this work is wasted)
        with TRACE.stage("rescue.prefill"):
            holder["pre"] = _prepare_rescue(
                gene, opts, reads_1, holder["by_pair"],
                holder["excl_idx"], holder["mpileup"])

    out = st.count_classes(c1, c2, merge_pileup=_merge_cb,
                           overlap=_overlap_cb)
    by_pair = holder["by_pair"]
    mpileup = holder["mpileup"]

    with TRACE.stage("device.rescue"):
        # rep-gated punts (punt \ excl) were counted against the final
        # pileup on device and STILL failed — align them now; their
        # alignments never enter the pileup (their device contribution
        # is already in it)
        punt_idx = np.flatnonzero(out["punt"])
        extra = punt_idx[~out["excl"][punt_idx]]
        if len(extra):
            by_pair.update(_align_punts(gene, opts, reads_1, reads_2,
                                        extra, out["winner"], aligner))

    with TRACE.stage("device.merge"):
        full_stats = StatAccumulator(gene.allele_names)
        exon_stats = None
        primary_stats = None
        lv = out["levels"]
        full_stats.add_packed_batch(*lv["full"])
        if "exon" in lv:
            exon_stats = StatAccumulator(gene.allele_names,
                                         st._rep_mask_np)
            exon_stats.add_packed_batch(*lv["exon"])
        if "primary" in lv:
            primary_stats = StatAccumulator(gene.allele_names,
                                            st._primary_mask_np)
            primary_stats.add_packed_batch(*lv["primary"])

    n_reads = out["n_reads"]
    n_pairs = out["n_pairs"]
    with TRACE.stage("device.rescue"):
        r_reads, r_pairs, novel = _count_rescued(
            gene, opts, reads_1, by_pair, punt_idx, mpileup,
            (full_stats, exon_stats, primary_stats),
            pre=holder.get("pre"))
    n_reads += r_reads
    n_pairs += r_pairs

    with TRACE.stage("type.em"):
        from ..typer.staging import staged_abundance

        full_cmpt = full_stats.cmpt_names()
        exon_cmpt = exon_stats.cmpt_names() if exon_stats else {}
        primary_cmpt = primary_stats.cmpt_names() if primary_stats else {}
        rep_groups = getattr(st, "_rep_groups", {})
        primary_groups = getattr(st, "_primary_groups", {})
        prob = staged_abundance(gene, opts, full_cmpt, exon_cmpt,
                                primary_cmpt, rep_groups, primary_groups,
                                gene.allele_lengths())

    return GeneTypingResult(
        gene=gene.gene,
        num_reads=int(n_reads),
        num_pairs=int(n_pairs),
        counts=full_stats.ranked_counts(),
        prob=prob,
        cmpt=full_cmpt,
        exon_cmpt=exon_cmpt,
        primary_exon_cmpt=primary_cmpt,
        novel_vars=dict(novel.meta),
    )
