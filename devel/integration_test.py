"""Golden integration runs.

Equivalent of devel/pre-int_test.sh + etc/integraton_test.py in the
reference: run the five devel configurations end to end through the CLI
and assert the marker strings the reference asserts
(integraton_test.py:30-112): the pass tally, the abundance line, the
Viterbi call line, and the PDF trailer.

  hg_test1  basic simulation (single-allele draws)
  hg_test2  paired (heterozygous) simulation
  hg_test3  simulation + assembly (+fasta +pdf)
  hg_test4  "real" reads (pre-simulated fastq) basic
  hg_test5  "real" reads + assembly
"""
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
DB = os.path.join(HERE, "testdb")
# The CLI runs on the platform JAX picks (the GPU where one is present,
# so the golden configs exercise the device path there); set
# JAX_PLATFORMS=cpu to run them on the host engine.  The CLI runs one
# process at a time, so only one JAX process ever holds the card.
ENV = dict(os.environ)


def run_cli(args, check=True):
    r = subprocess.run([sys.executable, "-m", "hgtpu"] + args,
                       capture_output=True, text=True, cwd=REPO, env=ENV,
                       timeout=1200)
    if check and r.returncode != 0:
        raise SystemExit("CLI failed: %s\n%s" % (args, r.stderr[-3000:]))
    return r


def ensure_db():
    if not os.path.exists(os.path.join(DB, "hla.snp")):
        subprocess.run([sys.executable, os.path.join(HERE, "make_testdb.py"),
                        DB], check=True, cwd=REPO, env=ENV)


def make_real_reads(out_dir):
    """Simulate a 'real' sample into fastq files."""
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from hgtpu.db.catalog import import_text
    from hgtpu.sim import simulate_reads
    from hgtpu.utils.io import write_fastq

    cat = import_text("hla", os.path.join(DB, "hla"))
    ref = cat.gene("A")
    allele = ref.allele_names[7]
    r1, r2, _ = simulate_reads(ref, [allele], simulate_interval=3, seed=42)
    os.makedirs(out_dir, exist_ok=True)
    p1 = os.path.join(out_dir, "NA00001.extracted.1.fq")
    p2 = os.path.join(out_dir, "NA00001.extracted.2.fq")
    write_fastq([(r.name, r.seq) for r in r1], p1)
    write_fastq([(r.name, r.seq) for r in r2], p2)
    return p1, p2, allele


EXPECTED = os.path.join(HERE, "expected")


def normalize(text):
    """Strip the machine-dependent provenance header (absolute command
    path) so report content diffs exactly across checkouts."""
    return "\n".join(
        l for l in text.splitlines()
        if not l.startswith("#") and "__main__.py" not in l) + "\n"


def main(out_root=None, test_size=2):
    ensure_db()
    out_root = out_root or os.path.join(HERE, "out")
    shutil.rmtree(out_root, ignore_errors=True)
    failures = []
    update = bool(os.environ.get("HGTPU_UPDATE_EXPECTED"))

    def check(name, cond, detail=""):
        status = "OK" if cond else "FAIL"
        print("  [%s] %s %s" % (status, name, detail))
        if not cond:
            failures.append(name)

    def check_expected(name, path):
        """Full-content golden diff (normalized): counts, abundance
        digits, assembly calls — not just the grep markers."""
        exp = os.path.join(EXPECTED, name)
        got = normalize(open(path).read())
        if update:
            os.makedirs(EXPECTED, exist_ok=True)
            open(exp, "w").write(got)
            print("  [GEN] expected/%s" % name)
            return
        if not os.path.exists(exp):
            check("expected %s present" % name, False, "(run with "
                  "HGTPU_UPDATE_EXPECTED=1 to generate)")
            return
        want = open(exp).read()
        check("expected %s" % name, got == want,
              "" if got == want else "(content drifted)")

    # hg_test1: basic simulation
    out1 = os.path.join(out_root, "hg_test1_basic")
    r = run_cli(["--base", "hla", "--ix-dir", DB, "--locus-list", "A",
                 "--debug", "basic,test_size:%d,set_seed:101" % test_size,
                 "--simulate-interval", "4", "--out-dir", out1])
    print("hg_test1 basic:")
    check("pass tally", "Passed so far: %d/%d (100.00%%)"
          % (test_size, test_size) in r.stderr)
    rep = open(os.path.join(out1, "assembly_graph-hla.test-1.report")).read()
    check("count line", "*** 1 ranked" in rep and "(count:" in rep)
    check("abundance 100", "(abundance: 100.00%)" in rep)
    check_expected("hg_test1.test-1.report",
                   os.path.join(out1, "assembly_graph-hla.test-1.report"))
    check_expected("hg_test1.test-2.report",
                   os.path.join(out1, "assembly_graph-hla.test-2.report"))

    # hg_test2: paired simulation
    out2 = os.path.join(out_root, "hg_test2_paired")
    r = run_cli(["--base", "hla", "--ix-dir", DB, "--locus-list", "A",
                 "--debug", "pair,test_size:%d,set_seed:101" % test_size,
                 "--simulate-interval", "4", "--out-dir", out2])
    print("hg_test2 paired:")
    check("pass tally", "(100.00%)" in r.stderr.splitlines()[-1])
    check_expected("hg_test2.test-1.report",
                   os.path.join(out2, "assembly_graph-hla.test-1.report"))

    # hg_test3: simulation + assembly
    out3 = os.path.join(out_root, "hg_test3_assembly")
    r = run_cli(["--base", "hla", "--ix-dir", DB, "--locus-list", "A",
                 "--debug", "basic,test_size:1,set_seed:101",
                 "--simulate-interval", "4", "--assembly",
                 "--out-dir", out3])
    print("hg_test3 assembly:")
    rep = open(os.path.join(out3, "assembly_graph-hla.test-1.report")).read()
    check("viterbi call", "(Group score:" in rep)
    check("fasta", os.path.exists(
        os.path.join(out3, "assembly_graph-hla.test-1.fasta")))
    pdf = os.path.join(out3, "assembly_graph-hla.test-1.A.pdf")
    check("pdf trailer", os.path.exists(pdf)
          and open(pdf, "rb").read().rstrip().endswith(b"%%EOF"))
    check_expected("hg_test3.test-1.report",
                   os.path.join(out3, "assembly_graph-hla.test-1.report"))
    check_expected("hg_test3.test-1.fasta",
                   os.path.join(out3, "assembly_graph-hla.test-1.fasta"))

    # hg_test4/5: pre-simulated "real" reads
    reads_dir = os.path.join(out_root, "reads")
    p1, p2, true_allele = make_real_reads(reads_dir)
    out4 = os.path.join(out_root, "hg_test4_realbasic")
    run_cli(["--base", "hla", "--ix-dir", DB, "-1", p1, "-2", p2,
             "--out-dir", out4])
    print("hg_test4 real basic:")
    rep4 = open(os.path.join(
        out4, "assembly_graph-hla.NA00001.report")).read()
    check("reads aligned", "reads and" in rep4)
    check("true allele ranked", "1 ranked %s" % true_allele in rep4)
    check_expected("hg_test4.report",
                   os.path.join(out4, "assembly_graph-hla.NA00001.report"))

    out5 = os.path.join(out_root, "hg_test5_realassembly")
    run_cli(["--base", "hla", "--ix-dir", DB, "-1", p1, "-2", p2,
             "--assembly", "--out-dir", out5])
    print("hg_test5 real assembly:")
    rep5 = open(os.path.join(
        out5, "assembly_graph-hla.NA00001.report")).read()
    check("viterbi call", "%s : %s" % (true_allele, true_allele) in rep5)
    check_expected("hg_test5.report",
                   os.path.join(out5, "assembly_graph-hla.NA00001.report"))

    print("\n%d checks failed" % len(failures))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
