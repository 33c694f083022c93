"""End-to-end genotyping orchestration.

Equivalent of the reference's genotyping_locus/typing drivers
(typing_core.py:2278-2691): align read batches with the device aligner,
group mates, run the typing engine, and (for simulations) sweep random
allele draws checking that the truth ranks #1 — the reference's built-in
self-test (`--debug basic,test_size:N,set_seed:S`).
"""
from __future__ import annotations

import random
from collections import defaultdict

from ..align import GeneAligner
from ..db.catalog import GeneRef
from ..sim import simulate_reads
from ..typer.engine import TypingOptions, type_gene


def type_reads_linear(gene: GeneRef, reads_1, reads_2=None, opts=None):
    """Linear-index typing (--aligner bowtie2 / --linear-index): exact
    full-read matches against the concatenated allele panel feed the
    compatibility classes straight into the EM, with no variant-graph
    alignment (ref typing_core.py:1597-1648 consuming the -k 10 linear
    hisat2/bowtie2 run of typing_common.py:995-1027)."""
    from ..align.linear import LinearAligner
    from ..typer.em import single_abundance
    from ..typer.engine import GeneTypingResult

    opts = opts or TypingOptions()
    seqs = [s for _, s in reads_1] + [s for _, s in (reads_2 or [])]
    la = LinearAligner(gene)
    ranked, cmpt = la.type_linear(
        seqs, max_mm=opts.num_mismatch if opts.num_mismatch > 0 else None)
    prob = single_abundance(
        cmpt, remove_low_abundance_allele=opts.remove_low_abundance_alleles)
    return GeneTypingResult(
        gene=gene.gene, num_reads=sum(n for _, n in cmpt.items()),
        num_pairs=len(reads_1), counts=ranked, prob=prob, cmpt=cmpt,
        exon_cmpt={}, primary_exon_cmpt={})


def _take_device_path(opts, paired) -> bool:
    """Route typing through the sharded device program (the production
    path, VERDICT r3 item 1)?  "on" forces it, "auto" takes it on an
    accelerator whenever the options are device-compatible."""
    if opts.device_typing == "off":
        return False
    from ..parallel.production import device_typing_supported

    if not device_typing_supported(opts, paired):
        return False
    if opts.device_typing == "on":
        return True
    from ..backend import on_accelerator

    return on_accelerator()


def type_reads(gene: GeneRef, reads_1, reads_2=None, opts=None,
               aligner: GeneAligner = None):
    """reads_*: [(name, seq)].  Returns GeneTypingResult."""
    opts = opts or TypingOptions()
    if opts.linear_typing:
        return type_reads_linear(gene, reads_1, reads_2, opts)
    if _take_device_path(opts, reads_2 is not None):
        from ..parallel.production import type_reads_device

        return type_reads_device(gene, reads_1, reads_2, opts,
                                 aligner=aligner)
    aligner = aligner or GeneAligner(gene, num_editdist=opts.num_editdist,
                                     leftmost=opts.family == "codis")
    by_read = defaultdict(list)
    groups = [([n for n, _ in reads_1], [s for _, s in reads_1], "L")]
    if reads_2:
        groups.append(([n for n, _ in reads_2],
                       [s for _, s in reads_2], "R"))
    batches = aligner.align_batches(groups)
    for alns in batches:
        for a in alns:
            if a is None:
                continue
            read_id = a.read_id.split("|")[0]
            by_read[read_id].append(a)
    return type_gene(gene, sorted(by_read.items(), key=lambda kv: kv[0]),
                     opts)


def type_from_sam(gene: GeneRef, sam_path, opts=None):
    """Type a gene from an existing SAM alignment file (the reference's
    --alignment path, typing() with alignment_fname)."""
    from ..align.sam import read_sam

    opts = opts or TypingOptions()
    groups = read_sam(gene, sam_path, opts.num_editdist)
    return type_gene(gene, groups, opts)


def type_family(catalog, reads_1, reads_2=None, locus_list=None, opts=None,
                sam_out=None, threads=1, runlog=None):
    """Type every gene of a family from one read set.

    Reads are assigned cross-gene by the NH==1 uniqueness rule
    (FamilyAligner); each gene in locus_list is then typed independently.
    A one-gene family goes through type_reads, so it reaches the device
    program; a multi-gene family types each gene's reads on the host
    engine.
    Ref: typing() per-gene loop (typing_core.py:370-1789).
    Returns {gene: GeneTypingResult}.

    When `runlog` (utils.runlog.RunLog) is given, a gene whose typing
    raises is logged with its traceback and mapped to None instead of
    aborting the family — the reference's per-sample error-log behavior
    (hisatgenotype:670-680).
    """
    from ..align.family import FamilyAligner

    opts = opts or TypingOptions()
    if opts.linear_typing:
        # linear path has no cross-gene routing stage: each gene's panel
        # is matched exactly (multi-gene hits stay ambiguous and drop)
        return {g: type_reads_linear(catalog.genes[g], reads_1, reads_2,
                                     opts)
                for g in (locus_list or list(catalog.genes))}
    genes = locus_list or list(catalog.genes)
    if len(catalog.genes) == 1 and not sam_out:
        # a one-gene family keeps every aligned read under the NH==1 rule
        # (FamilyAligner with one gene is GeneAligner), so its run is
        # type_reads over all reads: the device program or the host
        # engine, as type_reads chooses
        def type_one(g):
            return type_reads(catalog.genes[g], reads_1, reads_2 or None,
                              opts)
    else:
        fa = FamilyAligner(catalog, num_editdist=opts.num_editdist,
                           leftmost=opts.family == "codis")
        per_gene_1 = fa.align_batch([n for n, _ in reads_1],
                                    [s for _, s in reads_1], "L")
        per_gene_2 = None
        if reads_2:
            per_gene_2 = fa.align_batch([n for n, _ in reads_2],
                                        [s for _, s in reads_2], "R")

        def type_one(g):
            by_read = defaultdict(list)
            batches = [per_gene_1[g]]
            if per_gene_2:
                batches.append(per_gene_2[g])
            for alns in batches:
                for a in alns:
                    if a is None:
                        continue
                    by_read[a.read_id.split("|")[0]].append(a)
            groups = sorted(by_read.items(), key=lambda kv: kv[0])
            if sam_out:
                from ..align.sam import write_sam
                write_sam("%s.%s.sam" % (sam_out, g), catalog.genes[g],
                          groups)
            return type_gene(catalog.genes[g], groups, opts)

    def run_gene(g):
        try:
            return g, type_one(g)
        except Exception:
            if runlog is None:
                raise
            runlog.exception("%s %s" % (catalog.family, g))
            return g, None

    if threads > 1 and len(genes) > 1:
        # per-gene threading mirrors the reference's per-locus Pool fan-out
        # (hisatgenotype:613-665); numpy/native stages release the GIL
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=threads) as ex:
            results = dict(ex.map(run_gene, genes))
    else:
        results = dict(run_gene(g) for g in genes)
    return results


def simulation_sweep(gene: GeneRef, test_size=5, seed=None, paired=True,
                     allele_count=1, simulate_interval=1, read_len=100,
                     fragment_len=250, perbase_errorrate=0.0,
                     perbase_snprate=0.0, skip_fragment_regions=(),
                     opts=None, aligner=None, verbose=False,
                     report_base_fn=None, test_list=None, test_ids=None,
                     sim_gene=None):
    """Reference self-test: draw random alleles, simulate, type, and check
    the truth ranks #1 (typing_core.py:2488-2648).

    Returns (n_passed, results list of (true alleles, GeneTypingResult)).
    """
    opts = opts or TypingOptions(simulation=True,
                                 allow_discordant=not paired)
    aligner = aligner or GeneAligner(gene, num_editdist=opts.num_editdist,
                                     leftmost=opts.family == "codis")
    rng = random.Random(seed)
    if test_list:
        # explicit allele draws (ref: --debug test_list, hisatgenotype:381)
        tests = [sorted(t) for t in test_list]
    else:
        draws = rng.sample(range(len(gene.allele_names)),
                           test_size * allele_count)
        tests = [sorted(gene.allele_names[draws[t * allele_count + j]]
                        for j in range(allele_count))
                 for t in range(test_size)]
    results = []
    n_passed = 0
    for t in range(len(tests)):
        if test_ids and (t + 1) not in test_ids:
            continue  # ref: --debug test_id filter (hisatgenotype:383)
        alleles = tests[t]
        # sim_gene lets excluded alleles remain simulation truth
        # (novel-allele experiments, --exclude-allele-list)
        r1, r2, _ = simulate_reads(
            sim_gene or gene, alleles, simulate_interval=simulate_interval,
            read_len=read_len, frag_len=fragment_len,
            perbase_errorrate=perbase_errorrate,
            perbase_snprate=perbase_snprate,
            skip_fragment_regions=skip_fragment_regions, seed=rng.random())
        if report_base_fn is not None:
            opts.report_base = report_base_fn(t)
        res = type_reads(
            gene,
            [(r.name, r.seq) for r in r1],
            [(r.name, r.seq) for r in r2] if paired else None,
            opts, aligner)
        ranks = {}
        for i, (allele, prob) in enumerate(res.prob):
            if allele in alleles:
                ranks[allele] = i
        # per-allele pass tally, as in the reference (typing_core.py:2133-2142
        # counts each correctly-ranked allele separately)
        n_correct = sum(ranks.get(a, 99) < allele_count for a in alleles)
        passed = n_correct == allele_count
        n_passed += n_correct
        if verbose:
            top = res.prob[0] if res.prob else ("-", 0)
            print("test %d: true=%s top=%s %.2f%% %s"
                  % (t + 1, alleles, top[0], top[1] * 100,
                     "PASS" if passed else "FAIL"))
        results.append((alleles, res))
    return n_passed, results
