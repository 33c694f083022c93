"""Toolkit CLI — the `hisatgenotype_toolkit` equivalent
(ref: hisatgenotype_toolkit:37-103 dispatches subcommands by name).

Subcommands:
  extract-vars    build a database from MSF alignments
                  (ref: hisatgenotype_tools/hisatgenotype_extract_vars.py)
  extract-reads   route raw reads into per-family read files
                  (ref: .../hisatgenotype_extract_reads.py)
  locus           type one family from extracted reads
                  (ref: .../hisatgenotype_locus.py)
  parse-results   collapse .report files into final calls
                  (ref: .../hisatgenotype_parse_results.py)
"""
from __future__ import annotations

import argparse
import os
import sys

from . import args as A


def cmd_extract_vars(argv):
    p = argparse.ArgumentParser(prog="hgtpu extract-vars")
    A.args_common(p)
    A.args_databases(p)
    A.args_var_gaps(p)
    A.args_extract_vars(p)
    p.add_argument("--msf-dir", dest="msf_dir", required=True,
                   help="directory of <gene>_gen.msf files")
    args = p.parse_args(argv)
    if args.ext_seq_len:
        # ref extract_vars pads backbones with genomic flanks fetched from
        # the reference genome; no genome is available in MSF-only builds
        print("Error: --ext-seq requires genomic flanking sequence; build "
              "a genotype genome (`toolkit build-genome`) and type flanked "
              "regions with --reference-type genome instead",
              file=sys.stderr)
        return 1

    from ..db.build import build_gene_ref
    from ..db.catalog import Catalog, export_text
    from ..db.msf import read_msf

    genes = {}
    next_id = 0
    locus_list = [g for g in args.locus_list.split(",") if g]
    for fname in sorted(os.listdir(args.msf_dir)):
        if not fname.endswith("_gen.msf"):
            continue
        gene = fname[:-len("_gen.msf")]
        if locus_list and gene not in locus_list:
            continue
        names, rows = read_msf(os.path.join(args.msf_dir, fname))
        name_list = list(names.keys())
        ref, next_id = build_gene_ref(
            gene, name_list, rows, name_list[0],
            min_var_freq=args.min_var_freq, inter_gap=args.inter_gap,
            intra_gap=args.intra_gap, whole_haplotype=args.whole_haplotype,
            leftshift=args.leftshift, base_var_id=next_id)
        genes[gene] = ref
        print("%s: %d alleles, %d variants" % (gene, ref.n_alleles,
                                               ref.n_vars), file=sys.stderr)
    cat = Catalog(family=args.base_fname, genes=genes)
    export_text(cat, os.path.join(args.ix_dir, args.base_fname))
    print("Database written to %s/%s.*" % (args.ix_dir, args.base_fname),
          file=sys.stderr)
    return 0


def _find_read_samples(read_dir, suffix, paired):
    """{sample: (path1, path2|None)} scanned like the reference's
    extract_reads sample discovery (typing_process.py:1302-1345): paired
    files end -1.<suffix>/-2.<suffix> (or .1./.2.), single-ended files
    end .<suffix>."""
    out = {}
    tail1 = ".1." + suffix
    dash1 = "-1." + suffix
    plain = "." + suffix
    for fname in sorted(os.listdir(read_dir)):
        if paired and (fname.endswith(tail1) or fname.endswith(dash1)):
            sep = tail1 if fname.endswith(tail1) else dash1
            sample = fname[:-len(sep)]
            p2 = os.path.join(read_dir,
                              fname[:-len(sep)] + sep.replace("1", "2"))
            out[sample] = (os.path.join(read_dir, fname),
                           p2 if os.path.exists(p2) else None)
        elif not paired and fname.endswith(plain):
            out[fname[:-len(plain)]] = (os.path.join(read_dir, fname), None)
    return out


def cmd_extract_reads(argv):
    p = argparse.ArgumentParser(prog="hgtpu extract-reads")
    A.args_common(p)
    A.args_input(p)
    A.args_single_end(p)
    A.args_extract_reads(p)
    A.args_set_aligner(p)
    p.add_argument("--database-list", dest="database_list", type=str,
                   default="hla")
    p.add_argument("--ix-dir", dest="ix_dir", type=str, default=".")
    p.add_argument("-x", "--ref-genome", dest="genotype_genome", type=str,
                   default="",
                   help="genotype-genome prefix (toolkit build-genome): "
                        "route by spliced-genome placement instead of "
                        "per-family panels; with --extract-whole, bin "
                        "every uniquely-placed read into 20-Mbp blocks "
                        "(typing_process.py:1534-1594)")
    p.add_argument("--read-dir", dest="read_dir", type=str, default="",
                   help="directory of per-sample read files to extract "
                        "(scanned by --suffix; the reference's --in-dir, "
                        "typing_process.py:1302-1345)")
    args = p.parse_args(argv)

    from ..db.catalog import import_text
    from ..pipeline.extract import ReadExtractor
    from ..utils.io import read_fastx, write_fastq

    catalogs = {}
    for fam in args.database_list.split(","):
        catalogs[fam] = import_text(fam, os.path.join(args.ix_dir, fam))
    genome_mode = bool(args.genotype_genome)
    if genome_mode:
        from ..db.catalog import _read_fasta
        from ..pipeline.extract_genome import GenomeExtractor

        genome = _read_fasta(args.genotype_genome + ".fa")
        offsets = {}
        for line in open(args.genotype_genome + ".locus"):
            fam, bbname = line.split("\t")[:2]
            base = int(line.split("\t")[3])
            offsets[(fam, bbname.split("*")[0])] = base
        ex = GenomeExtractor(genome, offsets, catalogs,
                             max_mm=args.num_mismatch or 8)
    else:
        # --num-mismatch>0 overrides the routing edit budget
        # (ref args.py:102)
        ex = ReadExtractor(catalogs, num_editdist=args.num_mismatch or 2)

    if args.read_dir:
        samples = _find_read_samples(args.read_dir, args.suffix,
                                     args.paired)
        offset, stride = (int(x) for x in args.job_range.split(","))
        names = sorted(samples)[offset::max(1, stride)][:args.max_sample]
        samples = {s: samples[s] for s in names}
    else:
        path1 = args.read_fname_1 or args.read_fname_U
        samples = {os.path.basename(path1).split(".")[0]:
                   (path1, args.read_fname_2 or None)}

    def work(item):
        sample, (p1, p2) = item
        reads_1 = read_fastx(p1)
        reads_2 = read_fastx(p2) if p2 else None
        lines = []
        if genome_mode and args.extract_whole:
            # whole-genome 20-Mbp block binning
            # (typing_process.py:1534-1594)
            from ..pipeline.extract_genome import write_block_fastqs

            routed, blocks = ex.extract(reads_1, reads_2,
                                        block_size=20_000_000)
            paths = write_block_fastqs(args.out_dir, sample, blocks,
                                       20_000_000, paired=bool(reads_2))
            lines.append("%s: %d block files" % (sample, len(paths)))
        elif args.extract_whole:
            # --extract-whole without a genome: no routing, every family
            # gets all reads
            routed = {fam: (reads_1, reads_2 or [])
                      for fam in catalogs}
        else:
            routed = ex.extract(reads_1, reads_2)
        for fam, (r1, r2) in routed.items():
            out1 = os.path.join(args.out_dir, "%s-%s-extracted-1.%s"
                                % (sample, fam, args.suffix))
            write_fastq(r1, out1)
            lines.append("%s %s: %d reads -> %s"
                         % (sample, fam, len(r1), out1))
            if r2:
                out2 = out1.replace("-extracted-1.", "-extracted-2.")
                write_fastq(r2, out2)
        return lines

    if args.threads_aprocess > 1 and len(samples) > 1:
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=args.threads_aprocess) as tp:
            for lines in tp.map(work, samples.items()):
                for line in lines:
                    print(line, file=sys.stderr)
    else:
        for item in samples.items():
            for line in work(item):
                print(line, file=sys.stderr)
    return 0


def cmd_locus(argv):
    from .main import main as genotype_main
    return genotype_main(argv)


def cmd_parse_results(argv):
    p = argparse.ArgumentParser(prog="hgtpu parse-results")
    p.add_argument("--in-dir", dest="in_dir", type=str, default=".")
    p.add_argument("--csv", dest="csv", type=str, default="")
    args = p.parse_args(argv)

    from ..tools.results import parse_report_dir, to_csv

    calls = parse_report_dir(args.in_dir)
    if args.csv:
        to_csv(calls, args.csv)
    for sample, genes in sorted(calls.items()):
        for gene, alleles in sorted(genes.items()):
            print("%s\t%s\t%s" % (sample, gene, "\t".join(alleles)))
    return 0


def cmd_inspect(argv):
    p = argparse.ArgumentParser(prog="hgtpu inspect")
    p.add_argument("prefix", help="database prefix (e.g. DB/hla)")
    p.add_argument("-o", "--out", type=str, default="")
    args = p.parse_args(argv)
    from ..db.manage import inspect
    inspect(args.prefix, args.out or None)
    return 0


def cmd_build_genome(argv):
    p = argparse.ArgumentParser(prog="hgtpu build-genome")
    A.args_common(p)
    p.add_argument("--genome", required=True, help="host genome FASTA")
    p.add_argument("--database-list", dest="database_list", type=str,
                   default="hla")
    p.add_argument("--ix-dir", dest="ix_dir", type=str, default=".")
    p.add_argument("--out-prefix", dest="out_prefix", type=str,
                   default="genotype_genome")
    p.add_argument("--clinvar", dest="clinvar", type=str, default="",
                   help="ClinVar-style VCF(.gz) of external variants to "
                        "splice in (writes <out>.clnsig)")
    p.add_argument("--commonvar", dest="commonvar", type=str, default="",
                   help="UCSC snpNNNCommon.txt(.gz) dbSNP table to splice in")
    args = p.parse_args(argv)
    if args.clinvar and args.commonvar:
        # mutually exclusive, as in the reference (build_genome.py:554-556)
        print("Error: both --clinvar and --commonvar cannot be used "
              "together.", file=sys.stderr)
        return 1
    from ..db.catalog import import_text, _read_fasta
    from ..db.genome import build_genotype_genome
    external_vars, clnsig = None, None
    if args.clinvar:
        from ..db.clinvar import read_vcf_variants
        external_vars, clnsig = read_vcf_variants(args.clinvar)
    elif args.commonvar:
        from ..db.clinvar import read_ucsc_common
        external_vars = read_ucsc_common(args.commonvar)
    genome = _read_fasta(args.genome)
    catalogs = {fam: import_text(fam, os.path.join(args.ix_dir, fam))
                for fam in args.database_list.split(",")}
    build_genotype_genome(genome, catalogs,
                          os.path.join(args.out_dir, args.out_prefix),
                          external_vars=external_vars, clnsig=clnsig)
    print("genotype genome written to %s/%s.*"
          % (args.out_dir, args.out_prefix), file=sys.stderr)
    return 0


def cmd_extract_codis_data(argv):
    p = argparse.ArgumentParser(prog="hgtpu extract-codis-data")
    p.add_argument("--base", dest="base_fname", type=str, default="codis")
    p.add_argument("--locus-list", dest="locus_list", type=str, default="")
    p.add_argument("--html-dir", dest="html_dir", type=str, default="",
                   help="directory of saved STRBase str_<locus>.htm pages")
    p.add_argument("--download", action="store_true",
                   help="fetch pages over the network (needs egress)")
    p.add_argument("--verbose", action="store_true")
    args = p.parse_args(argv)

    from ..tools.codis_fetch import (dir_source, extract_codis_data,
                                     url_source)
    if args.html_dir:
        source = dir_source(args.html_dir)
    elif args.download:
        source = url_source()
    else:
        print("extract-codis-data: pass --html-dir DIR (offline pages) "
              "or --download", file=sys.stderr)
        return 1
    loci = [x for x in args.locus_list.split(",") if x]
    n = extract_codis_data(args.base_fname + ".dat", source, loci or None,
                           verbose=args.verbose)
    print("%d alleles -> %s.dat" % (n, args.base_fname), file=sys.stderr)
    return 0


def cmd_samples(argv):
    """Batch sample runner — the reference's hisatgenotype_locus_samples
    (locus_samples.py:120-340): type every extracted sample in a
    directory, print per-sample calls, optionally check platinum-trio
    concordance."""
    p = argparse.ArgumentParser(prog="hgtpu samples")
    A.args_common(p)
    A.args_databases(p)
    A.args_locus_samples(p)
    A.args_genotyping_pgs(p)
    p.add_argument("--read-dir", dest="read_dir", required=True,
                   help="directory of <sample>.extracted.1.fq.gz files")
    p.add_argument("--suffix", dest="suffix", type=str,
                   default="extracted.1.fq.gz")
    p.add_argument("--pp", "--threads-aprocess", dest="threads_aprocess",
                   type=int, default=1)
    args = p.parse_args(argv)

    from ..db.catalog import import_text
    from ..tools.batch import find_samples, run_batch, top_two, \
        trio_concordant
    from ..typer.engine import TypingOptions

    catalog = import_text(args.base_fname,
                          os.path.join(args.ix_dir, args.base_fname))
    samples = find_samples(args.read_dir, suffix=args.suffix)
    wanted = {s for s in args.genome_list.split(",") if s}
    if wanted:
        samples = {s: v for s, v in samples.items() if s in wanted}
    samples = {s: samples[s]
               for s in sorted(samples)[:args.max_sample]}
    locus_list = [g for g in args.locus_list.split(",") if g] or \
        [g for g in args.hla_list.split(",") if g in catalog.genes] or None
    opts = TypingOptions(family=args.base_fname,
                         num_editdist=args.num_editdist)
    calls = run_batch(catalog, samples, locus_list=locus_list, opts=opts,
                      threads=args.threads_aprocess)
    for sample in sorted(calls):
        for gene in sorted(calls[sample]):
            print("%s\t%s\t%s" % (sample, gene,
                                  "\t".join(top_two(calls[sample][gene]))))
    if args.platinum_check:
        # CEPH1463 trio: NA12878 = NA12891 x NA12892
        # (ref locus_samples.py:288-329)
        trio = ("NA12878", "NA12891", "NA12892")
        if not all(s in calls for s in trio):
            print("platinum-check: trio %s not all present" % (trio,),
                  file=sys.stderr)
            return 1
        ok = total = 0
        for gene in sorted(calls[trio[0]]):
            if not all(gene in calls[s] for s in trio):
                continue
            total += 1
            good = trio_concordant(calls[trio[0]][gene],
                                   calls[trio[1]][gene],
                                   calls[trio[2]][gene])
            ok += good
            print("platinum-check %s: %s"
                  % (gene, "concordant" if good else "DISCORDANT"))
        print("platinum-check: %d/%d concordant" % (ok, total))
        return 0 if ok == total else 1
    return 0


def cmd_hla_cyp(argv):
    """Legacy randomized typing test harness — the reference's
    etc/hisatgenotype_hla_cyp.py: simulate reads per allele, type with
    each aligner variant, and report accuracy; with
    --novel_allele_detection, exclude N random alleles and report
    sensitivity/specificity of novel-allele flagging."""
    p = argparse.ArgumentParser(prog="hgtpu hla-cyp")
    A.args_common(p)
    A.args_databases(p)
    A.args_set_aligner(p)
    A.args_hla_cyp(p)
    p.add_argument("--exclude-allele-list", dest="exclude_allele_list",
                   type=str, default="",
                   help="alleles to exclude, or a number N to exclude N "
                        "random alleles (and test N kept ones too)")
    p.add_argument("--simulate-interval", dest="simulate_interval",
                   type=int, default=1)
    p.add_argument("--best-alleles", dest="best_alleles",
                   action="store_true")
    p.add_argument("--random-seed", dest="random_seed", type=int, default=1)
    args = p.parse_args(argv)

    if args.coverage:
        print("Error: --coverage (coverage-based read assignment) is an "
              "experimental path in the reference and is not implemented",
              file=sys.stderr)
        return 1

    import random as _random

    from ..db.catalog import import_text
    from ..pipeline.genotype import type_reads
    from ..sim import simulate_reads
    from ..typer.engine import TypingOptions
    from ..utils.io import read_fastx

    catalog = import_text(args.base_fname,
                          os.path.join(args.ix_dir, args.base_fname))
    locus_list = [g for g in args.locus_list.split(",") if g] or \
        list(catalog.genes)
    aligners = [a for a in args.aligners.split(",") if a] or \
        ["%s.%s" % (args.aligner,
                    "graph" if args.graph_index else "linear")]
    rng = _random.Random(args.random_seed)

    if args.read_fname:
        reads = read_fastx(args.read_fname)
        for gene in locus_list:
            for al in aligners:
                opts = TypingOptions(family=args.base_fname,
                                     linear_typing=al.endswith(".linear"),
                                     allow_discordant=True)
                res = type_reads(catalog.genes[gene], reads, None, opts)
                top = res.prob[0] if res.prob else ("-", 0.0)
                print("%s %s: %s (%.2f%%)"
                      % (gene, al, top[0], top[1] * 100.0))
        return 0

    rc = 0
    for gene in locus_list:
        ref = catalog.genes[gene]
        excl = []
        if args.novel_allele_detection or \
                args.exclude_allele_list.isdigit():
            n = int(args.exclude_allele_list or "1")
            excl = rng.sample(list(ref.allele_names), n)
        elif args.exclude_allele_list:
            excl = [a for a in args.exclude_allele_list.split(",") if a]
        panel = ref.exclude_alleles(excl) if excl else ref
        test_alleles = [a for a in args.default_allele_list.split(",")
                        if a] or \
            excl + rng.sample([a for a in ref.allele_names
                               if a not in excl], max(1, len(excl)))
        tp = fp = tn = fn = passed = 0
        for allele in test_alleles:
            r1, r2, _ = simulate_reads(
                ref, [allele], simulate_interval=args.simulate_interval)
            for al in aligners:
                opts = TypingOptions(
                    family=args.base_fname, simulation=True,
                    linear_typing=al.endswith(".linear"))
                res = type_reads(panel, [(r.name, r.seq) for r in r1],
                                 [(r.name, r.seq) for r in r2], opts)
                is_novel_truth = allele in excl
                flagged = bool(res.novel_vars)
                if args.novel_allele_detection:
                    tp += is_novel_truth and flagged
                    fn += is_novel_truth and not flagged
                    fp += (not is_novel_truth) and flagged
                    tn += (not is_novel_truth) and not flagged
                else:
                    hit = bool(res.prob) and res.prob[0][0] == allele
                    passed += hit
                    print("%s %s %s: %s" % (gene, al, allele,
                                            "PASS" if hit else "FAIL"))
        if args.novel_allele_detection:
            sens = tp / max(1, tp + fn)
            spec = tn / max(1, tn + fp)
            print("%s: novel-allele sensitivity %.2f specificity %.2f"
                  % (gene, sens, spec))
            rc |= 0 if (tp + fn == 0 or sens > 0) else 1
        else:
            total = len(test_alleles) * len(aligners)
            print("%s: %d/%d passed" % (gene, passed, total))
            rc |= 0 if passed == total else 1
    return rc


def cmd_convert_codis(argv):
    """CODIS .dat -> typable database — the reference's
    hisatgenotype_convert_codis (convert_codis.py:402-686), with
    --min-freq filtering against a frequency table (the offline analog of
    the NIST-US1036 allele-frequency sheet, :413-433)."""
    p = argparse.ArgumentParser(prog="hgtpu convert-codis")
    A.args_common(p)
    A.args_databases(p)
    A.args_convert_codis(p)
    p.add_argument("--dat", dest="dat", type=str, default="codis.dat",
                   help="locus/allele/structure TSV from "
                        "extract-codis-data")
    p.add_argument("--freq-table", dest="freq_table", type=str, default="",
                   help="TSV locus<TAB>allele<TAB>frequency used by "
                        "--min-freq")
    p.add_argument("--flank5", type=str, default="")
    p.add_argument("--flank3", type=str, default="")
    args = p.parse_args(argv)

    from ..db import build_catalog_from_msa
    from ..db.catalog import export_text
    from ..tools.codis import codis_msa
    from ..tools.codis_fetch import read_codis_dat

    table = read_codis_dat(args.dat)
    freq = {}
    if args.min_freq > 0.0:
        if not args.freq_table:
            print("Error: --min-freq needs --freq-table "
                  "(locus\\tallele\\tfrequency TSV)", file=sys.stderr)
            return 1
        for line in open(args.freq_table):
            locus, allele, f = line.rstrip("\n").split("\t")
            freq.setdefault(locus, {})[allele] = float(f)

    locus_list = [g for g in args.locus_list.split(",") if g]
    specs = {}
    for locus, alleles in sorted(table.items()):
        if locus_list and locus not in locus_list:
            continue
        if args.min_freq > 0.0:
            alleles = [(a, s) for a, s in alleles
                       if freq.get(locus, {}).get(a, 0.0) >= args.min_freq]
        if not alleles:
            continue
        names, rows = codis_msa(alleles, args.flank5, args.flank3)
        names = ["%s*%s" % (locus, n) for n in names]
        # exon span in reference-allele (gap-stripped) coordinates
        ref_len = len(rows[0].replace(".", ""))
        specs[locus] = dict(names=names, rows=rows, ref_allele=names[0],
                            exons=[(0, ref_len - 1)])
        print("%s: %d alleles" % (locus, len(names)), file=sys.stderr)
    cat = build_catalog_from_msa(args.base_fname, specs, min_var_freq=0.0)
    export_text(cat, os.path.join(args.ix_dir, args.base_fname))
    print("Database written to %s/%s.*" % (args.ix_dir, args.base_fname),
          file=sys.stderr)
    return 0


def cmd_extract_rbg(argv):
    """Blood-group DB from GenBank flat files — the reference's
    hisatgenotype_extract_RBG (extract_RBG.py:41-198 fetches NCBI
    records per allele accession; here they come from local files)."""
    p = argparse.ArgumentParser(prog="hgtpu extract-rbg")
    A.args_common(p)
    A.args_databases(p)
    p.add_argument("--genbank", dest="genbank", required=True,
                   help="comma-separated GenBank flat files (multi-record "
                        "OK); record 0 per gene is the reference allele")
    args = p.parse_args(argv)

    from ..db import build_catalog_from_msa
    from ..db.catalog import export_text
    from ..tools.rbg import convert_rbg_genbank, parse_record, \
        split_records

    paths = [f for f in args.genbank.split(",") if f]
    genes = set()
    for path in paths:
        for rec in split_records(open(path).read()):
            genes.update(parse_record(rec)["genes"])
    locus_list = [g for g in args.locus_list.split(",") if g]
    if locus_list:
        genes &= set(locus_list)
    specs = {}
    for gene in sorted(genes):
        names, rows, exons = convert_rbg_genbank(paths, gene)
        ref_len = len(rows[0].replace(".", ""))
        specs[gene] = dict(names=names, rows=rows, ref_allele=names[0],
                           exons=exons or [(0, ref_len - 1)])
        print("%s: %d alleles" % (gene, len(names)), file=sys.stderr)
    if not specs:
        print("Error: no genes found in %s" % args.genbank,
              file=sys.stderr)
        return 1
    cat = build_catalog_from_msa(args.base_fname, specs, min_var_freq=0.0)
    export_text(cat, os.path.join(args.ix_dir, args.base_fname))
    print("Database written to %s/%s.*" % (args.ix_dir, args.base_fname),
          file=sys.stderr)
    return 0


def cmd_compare(argv):
    """Concordance of our typing calls against an external truth table
    (the reference's etc/compare_HLA.py harness, offline)."""
    p = argparse.ArgumentParser(prog="hgtpu compare")
    p.add_argument("calls", help="our typing table (sample\\tGENE*allele"
                                 "[\\tabundance])")
    p.add_argument("truth", help="external truth table (same format; "
                                 "e.g. UTSW / Omixon / Platinum gold)")
    p.add_argument("--genes", type=str, default="",
                   help="comma-separated gene list (default: HLA core)")
    args = p.parse_args(argv)

    from ..tools.compare import HLA_GENES, compare_tables, format_report

    genes = tuple(g for g in args.genes.split(",") if g) or HLA_GENES
    print(format_report(compare_tables(args.calls, args.truth,
                                       genes=genes)))
    return 0


COMMANDS = {
    "compare": cmd_compare,
    "extract-vars": cmd_extract_vars,
    "extract-rbg": cmd_extract_rbg,
    "extract-codis-data": cmd_extract_codis_data,
    "extract-reads": cmd_extract_reads,
    "locus": cmd_locus,
    "parse-results": cmd_parse_results,
    "inspect": cmd_inspect,
    "build-genome": cmd_build_genome,
    "samples": cmd_samples,
    "hla-cyp": cmd_hla_cyp,
    "convert-codis": cmd_convert_codis,
}


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m hgtpu.cli.toolkit <command> [options]\n"
              "commands: %s" % ", ".join(sorted(COMMANDS)))
        return 0
    cmd = argv[0]
    if cmd not in COMMANDS:
        print("unknown command: %s" % cmd, file=sys.stderr)
        return 1
    return COMMANDS[cmd](argv[1:])


if __name__ == "__main__":
    sys.exit(main())
