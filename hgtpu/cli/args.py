"""Shared argument registry.

Mirror of the reference's composable argparse groups
(hisatgenotype_modules/hisatgenotype_args.py:33-469) so the devel test
command lines translate 1:1.
"""
from __future__ import annotations


def args_common(parser):
    parser.add_argument("-v", "--verbose", action="store_true")
    parser.add_argument("--verbose-level", dest="verbose_level", type=int,
                        default=0,
                        help="also print some statistics to stderr; >=2 "
                             "adds the per-stage timing table "
                             "(ref args.py:319-323)")
    parser.add_argument("--out-dir", dest="out_dir", type=str, default=".")


def args_databases(parser, genome=False):
    if genome:
        parser.add_argument("-x", "--ref-genome", dest="genotype_genome",
                            type=str, default="",
                            help="genotype-genome index prefix (built by "
                                 "`toolkit build-genome`); used with "
                                 "--reference-type genome "
                                 "(ref args.py:59-64)")
    parser.add_argument("--base", "--base-fname", dest="base_fname",
                        type=str, default="hla",
                        help="base filename of the family database")
    parser.add_argument("--region-list", dest="region_list", type=str,
                        default="",
                        help="comma-separated family.gene regions; "
                             "overrides --base/--locus-list "
                             "(ref args.py:366-371)")
    parser.add_argument("--locus-list", dest="locus_list", type=str,
                        default="", help="comma-separated gene list")
    parser.add_argument("-z", "--index_dir", "--ix-dir", "--in-dir",
                        dest="ix_dir", type=str, default=".",
                        help="directory holding the database files "
                             "(follows hg_ix.link indirection, "
                             "ref args.py:83-87)")


def args_set_aligner(parser, mismatch=True):
    """Ref args_set_aligner (args.py:89-107)."""
    parser.add_argument("--aligner", dest="aligner", type=str,
                        default="hisat2",
                        help="aligner backend: hisat2 (graph) or bowtie2 "
                             "(linear) (default: hisat2)")
    # hgtpu extension (no reference twin): the sharded device typing
    # program with host punt rescue (parallel/production.py)
    parser.add_argument("--device-typing", dest="device_typing", type=str,
                        default="auto", choices=("auto", "on", "off"),
                        help="route typing through the device program "
                             "(auto: on GPU backends when the options "
                             "are device-compatible)")
    parser.add_argument("--linear-index", dest="graph_index",
                        action="store_false",
                        help="use the linear (exact-match allele panel) "
                             "index instead of the variant graph")
    if mismatch:
        parser.add_argument("--num-mismatch", dest="num_mismatch",
                            type=int, default=0,
                            help="maximum mismatches per read during "
                                 "extraction routing (default: 0 = use "
                                 "--num-editdist)")


def args_reference_type(parser):
    parser.add_argument("--reference-type", dest="reference_type", type=str,
                        default="gene", choices=("gene", "chromosome",
                                                 "genome"),
                        help="reference type (ref args.py:176-183); "
                             "'genome' types arbitrary chrom:left-right "
                             "regions of a genotype genome (-x)")


def args_no_partial(parser):
    parser.add_argument("--no-partial", dest="partial",
                        action="store_false",
                        help="exclude partial alleles (e.g. A_nuc-only) "
                             "from the typing panel (ref args.py:184-188)")


def args_single_end(parser):
    parser.add_argument("--single-end", dest="paired",
                        action="store_false",
                        help="treat input read files as single-ended "
                             "(ref args.py:190-195)")


def args_var_gaps(parser):
    parser.add_argument("--inter-gap", dest="inter_gap", type=int,
                        default=30,
                        help="maximum distance for variants to share a "
                             "haplotype window")
    parser.add_argument("--intra-gap", dest="intra_gap", type=int,
                        default=50,
                        help="break a haplotype into several haplotypes")


def args_extract_reads(parser):
    """Ref args_extract_reads (args.py:214-244)."""
    import sys as _sys
    parser.add_argument("--suffix", dest="suffix", type=str,
                        default="fq.gz",
                        help="read file suffix (default: fq.gz)")
    parser.add_argument("--simulation", dest="simulation",
                        action="store_true",
                        help="input reads are simulated (sample names "
                             "carry truth alleles)")
    parser.add_argument("--pp", "--threads-aprocess",
                        dest="threads_aprocess", type=int, default=1,
                        help="number of threads a process")
    parser.add_argument("--max-sample", dest="max_sample", type=int,
                        default=_sys.maxsize,
                        help="number of samples to be extracted")
    parser.add_argument("--job-range", dest="job_range", type=str,
                        default="0,1",
                        help="two numbers 'offset,stride' striping samples "
                             "across concurrent jobs (e.g. 1,3)")
    parser.add_argument("--extract-whole", dest="extract_whole",
                        action="store_true",
                        help="extract all reads (no per-family routing)")


def args_extract_vars(parser):
    """Ref args_extract_vars (args.py:246-266)."""
    parser.add_argument("--whole-haplotype", dest="whole_haplotype",
                        action="store_true",
                        help="one haplotype window per allele instead of "
                             "inter/intra-gap clustering")
    parser.add_argument("--min-var-freq", dest="min_var_freq", type=float,
                        default=0.0,
                        help="exclude variants below this %% frequency")
    parser.add_argument("--ext-seq", dest="ext_seq_len", type=int,
                        default=0,
                        help="length of extra genomic sequence flanking "
                             "backbones (requires genome flanks)")
    parser.add_argument("--leftshift", dest="leftshift",
                        action="store_true", default=True,
                        help="shift deletions to the leftmost equivalent "
                             "position (default: on)")


def args_locus_samples(parser):
    """Ref args_locus_samples (args.py:365-387): batch sample runner."""
    import sys as _sys
    parser.add_argument("--num-editdist", dest="num_editdist", type=int,
                        default=2)
    parser.add_argument("--max-sample", dest="max_sample", type=int,
                        default=_sys.maxsize,
                        help="number of samples to be analyzed")
    parser.add_argument("--platinum-check", dest="platinum_check",
                        action="store_true",
                        help="check trio concordance of platinum genomes "
                             "(NA12878 = NA12891 x NA12892)")


def args_genotyping_pgs(parser):
    """Ref args_HLA_genotyping_PGs (args.py:389-408)."""
    parser.add_argument("--hla-list", dest="hla_list", type=str,
                        default="A,B,C,DQA1,DQB1,DRB1",
                        help="comma-separated HLA gene list")
    parser.add_argument("--genome-list", dest="genome_list", type=str,
                        default="",
                        help="comma-separated sample (genome) names to "
                             "include (default: all found)")


def args_hla_cyp(parser):
    """Ref args_hla_cyp (args.py:410-461): the legacy randomized typing
    test harness flags."""
    parser.add_argument("--reads", dest="read_fname", type=str, default="",
                        help="fastq read file name (single-ended)")
    parser.add_argument("--allele-list", dest="default_allele_list",
                        type=str, default="",
                        help="comma-separated alleles to be tested")
    parser.add_argument("--partial", dest="partial", action="store_true",
                        help="include partial alleles")
    parser.add_argument("--aligner-list", dest="aligners", type=str,
                        default="",
                        help="comma-separated aligner variants, e.g. "
                             "hisat2.graph,hisat2.linear,bowtie2.linear "
                             "(overwrites --aligner)")
    parser.add_argument("--coverage", dest="coverage", action="store_true",
                        help="assign reads based on coverage (experimental "
                             "in the reference; rejected here)")
    parser.add_argument("--novel_allele_detection",
                        dest="novel_allele_detection",
                        action="store_true",
                        help="exclude N random alleles and report novel-"
                             "allele sensitivity/specificity")


def args_convert_codis(parser):
    parser.add_argument("--min-freq", dest="min_freq", type=float,
                        default=0.0,
                        help="minimum allele frequency (default: 0.0)")


def args_input(parser):
    parser.add_argument("-1", dest="read_fname_1", type=str, default="")
    parser.add_argument("-2", dest="read_fname_2", type=str, default="")
    parser.add_argument("-U", dest="read_fname_U", type=str, default="")
    parser.add_argument("-f", "--fasta", dest="fasta", action="store_true")
    parser.add_argument("--bamfile", dest="bamfile", type=str, default="",
                        help="coordinate BAM of host-genome alignments; "
                             "reads overlapping each locus are extracted "
                             "(ref hisatgenotype:114-241, args.py:170)")
    parser.add_argument("--alignment-file", dest="alignment_fname", type=str,
                        default="", help="type from an existing SAM file")


def args_aligner(parser):
    parser.add_argument("--num-editdist", dest="num_editdist", type=int,
                        default=2)
    parser.add_argument("-p", "--threads", dest="threads", type=int,
                        default=1)
    parser.add_argument("--no-error-correction", dest="error_correction",
                        action="store_false")
    parser.add_argument("--type-primary-exons", dest="type_primary_exons",
                        action="store_true",
                        help="EM stage on primary-exon representatives "
                             "first (ref args.py:338-341)")
    parser.add_argument("--keep-low-abundance-alleles",
                        dest="remove_low_abundance_alleles",
                        action="store_false",
                        help="do not prune low-abundance alleles during "
                             "EM (ref args.py:342-346)")
    parser.add_argument("--exclude-allele-list", dest="exclude_allele_list",
                        type=str, default="",
                        help="comma-separated alleles removed from the "
                             "panel before typing (ref args.py:388-393)")
    parser.add_argument("--discordant", dest="discordant",
                        action="store_true")
    parser.add_argument("--keep-alignment", dest="keep_alignment",
                        action="store_true")
    parser.add_argument("--only-locus-list", dest="only_locus_list",
                        type=str, default="",
                        help="restrict typing to these genes while still "
                             "extracting against the full database "
                             "(ref args.py:328-333)")
    parser.add_argument("--display-alleles", dest="display_alleles",
                        type=str, default="",
                        help="comma-separated alleles whose variant tracks "
                             "are drawn in the assembly plot "
                             "(ref args.py:347-352)")
    parser.add_argument("--strict-pair-distance",
                        dest="strict_pair_distance", action="store_true",
                        help="measure CODIS mate gaps in raw backbone "
                             "coordinates exactly as the reference does "
                             "(typing_core.py:686-716), disabling the "
                             "deletion-aware correction")


def args_assembly(parser):
    parser.add_argument("--assembly", dest="assembly", action="store_true")
    parser.add_argument("--assembly-base", "--assembly-name",
                        dest="assembly_base", type=str,
                        default="assembly_graph")
    parser.add_argument("--assembly-verbose", dest="assembly_verbose",
                        action="store_true")


def args_simulation(parser):
    parser.add_argument("--debug", dest="debug", type=str, default="",
                        help="e.g. basic,test_size:5,set_seed:101")
    parser.add_argument("--simulate-interval", dest="simulate_interval",
                        type=int, default=10)
    parser.add_argument("--read-len", dest="read_len", type=int, default=100)
    parser.add_argument("--fragment-len", dest="fragment_len", type=int,
                        default=350)
    parser.add_argument("--perbase-snprate", dest="perbase_snprate",
                        type=float, default=0.0,
                        help="%% chance per base of a germline SNP "
                             "injected into the simulated allele "
                             "(ref typing_common.py:726-745)")
    parser.add_argument("--skip-fragment-regions",
                        dest="skip_fragment_regions", type=str, default="",
                        help="comma-separated left-right backbone ranges "
                             "excluded from simulation "
                             "(ref args.py:311-316)")
    parser.add_argument("--random-seed", dest="random_seed", type=int,
                        default=None,
                        help="simulation seed (same as --debug set_seed:N)")
    parser.add_argument("--perbase-errorrate", dest="perbase_errorrate",
                        type=float, default=0.0)


def args_output(parser):
    parser.add_argument("--output-base", dest="output_base", type=str,
                        default="assembly_graph")
    parser.add_argument("--best-alleles", dest="best_alleles",
                        action="store_true")
    parser.add_argument("--output-allele-counts",
                        dest="output_allele_counts", action="store_true")


def parse_debug(debug_str):
    """Ref: hisatgenotype:371-393."""
    debug = {}
    if not debug_str:
        return debug
    for item in debug_str.split(","):
        if ":" in item:
            key, value = item.split(":", 1)
            debug[key] = value
        else:
            debug[item] = True
    return debug
