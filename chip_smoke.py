"""Smoke run of the production typing path on the GPU.

    python chip_smoke.py               # one card (the default phases)
    python chip_smoke.py --four-cards  # production over four cards only

Run from the repository root, in one process that holds the card or
cards; the CLI runs in this process too, never as a second JAX process.
The script stops at the first failure with a non-zero exit code.  Its
last line of standard output is one JSON object:

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

where ``count`` is the number of devices the production mesh spanned.

Default phases, on one card (a machine with several cards is restricted
to its first, so the run never spreads over them):

1. device       the JAX platform must be "gpu"; prints the device kind,
                the JAX version and the card's name and power limit.
2. native       ``make -C native`` builds the C++ runtime.
3. cli          the devel test database (24 alleles, 1.8 kb) and a paired
                FASTQ of one allele, typed by ``hgtpu.cli.main.main`` with
                the default ``--device-typing auto``: the report ranks the
                truth #1 and the trace shows the device program ran.
4. parity       the 3,600-allele / 3.5 kb panel with a heterozygous truth
                pair at full simulation depth (13,022 reads), typed by
                ``pipeline.type_reads`` on the device path ("auto")
                against the host engine ("off"), error-free and at 2 %
                per-base error: class-count dicts and read/pair counts
                equal, abundances within 1e-9, the truth pair on top.
5. em           the device EM solvers on the scale run's classes (the
                richer of its full and exon levels) against float64
                references (tolerances above ``phase_em``).

``--four-cards`` runs only production over a 4-device mesh against a
1-device mesh on the scale configuration, in this one process; the two
results must agree in the sense of phase 4.

Times are wall times on the host clock around work that ends in a fetch;
each timing line names the card.  They are first-light numbers of one
run, not a benchmark.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(REPO, "smoke_out")

# the scale configuration (bench.py, tests/test_production.py)
SCALE_ALLELES, SCALE_LENGTH = 3600, 3500
SCALE_TRUTHS = (123, 2047)
SCALE_READS = 13022


class SmokeError(RuntimeError):
    pass


def _say(msg):
    print("[smoke] %s" % msg, flush=True)


def _check(cond, what):
    if not cond:
        raise SmokeError(what)


# --------------------------------------------------------------------- #
# phase 1: device
# --------------------------------------------------------------------- #
def card_names():
    """`nvidia-smi` name and power limit of every card, one per line."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, check=True)
    return [l.strip() for l in r.stdout.splitlines() if l.strip()]


def phase_device(n_cards):
    import jax

    devs = jax.devices()
    dev = devs[0]
    _check(dev.platform == "gpu",
           "JAX found no GPU (platform %r)" % dev.platform)
    _check(len(devs) >= n_cards,
           "%d cards needed, JAX sees %d" % (n_cards, len(devs)))
    cards = card_names()
    _say("device: %s x%d, jax %s" % (dev.device_kind, len(devs),
                                     jax.__version__))
    for c in cards:
        _say("card: %s" % c)
    return dev, cards[0]


# --------------------------------------------------------------------- #
# phase 2: native build
# --------------------------------------------------------------------- #
def phase_native(card):
    from hgtpu.native import NATIVE_DIR, have_native

    t0 = time.perf_counter()
    r = subprocess.run(["make", "-C", NATIVE_DIR], capture_output=True,
                       text=True)
    _check(r.returncode == 0, "make -C native failed:\n%s%s"
           % (r.stdout, r.stderr))
    _check(have_native(), "native library does not load")
    _say("native: built in %.3f s (host; %s)"
         % (time.perf_counter() - t0, card))


# --------------------------------------------------------------------- #
# phase 3: the CLI on the devel test database
# --------------------------------------------------------------------- #
def build_cli_gene(seed=11, n_alleles=24, length=1800):
    """The devel test DB's one gene (devel/make_testdb.py)."""
    from synth import make_gene_msa

    from hgtpu.db import build_gene_ref

    spec = make_gene_msa(seed=seed, n_alleles=n_alleles, length=length)
    ref, _ = build_gene_ref(
        "A", spec["names"], spec["rows"], spec["ref_allele"],
        exons_ref_coords=spec["exons"],
        primary_exon_idx=spec["primary_exon_idx"], min_var_freq=0.0)
    return ref


def phase_cli(out_dir, card):
    """Build the devel test DB (devel/make_testdb.py), simulate a paired
    FASTQ of one allele and type it through the CLI's main in this
    process.  Returns the truth allele."""
    from hgtpu.cli.main import main as cli_main
    from hgtpu.db import Catalog
    from hgtpu.db.catalog import export_text, import_text
    from hgtpu.sim import simulate_reads
    from hgtpu.utils.io import write_fastq
    from hgtpu.utils.trace import TRACE

    ref = build_cli_gene()
    db = os.path.join(out_dir, "testdb")
    os.makedirs(db, exist_ok=True)
    export_text(Catalog(family="hla", genes={"A": ref}),
                os.path.join(db, "hla"))
    gene = import_text("hla", os.path.join(db, "hla")).gene("A")
    truth = gene.allele_names[7]
    r1, r2, _ = simulate_reads(gene, [truth], simulate_interval=3, seed=42)
    p1 = os.path.join(out_dir, "NA00001.extracted.1.fq")
    p2 = os.path.join(out_dir, "NA00001.extracted.2.fq")
    write_fastq([(r.name, r.seq) for r in r1], p1)
    write_fastq([(r.name, r.seq) for r in r2], p2)

    report_dir = os.path.join(out_dir, "cli")
    TRACE.reset()
    t0 = time.perf_counter()
    rc = cli_main(["--base", "hla", "--ix-dir", db, "-1", p1, "-2", p2,
                   "--out-dir", report_dir])
    dt = time.perf_counter() - t0
    _check(rc == 0, "CLI exited %r" % rc)
    stages = TRACE.summary()
    _check("device.spell" in stages and "device.countB" in stages,
           "the CLI did not take the device path (stages: %s)"
           % sorted(stages))
    report = open(os.path.join(
        report_dir, "assembly_graph-hla.NA00001.report")).read()
    _check("1 ranked %s (abundance" % truth in report,
           "the CLI report does not rank the truth %s #1" % truth)
    _say("cli: %d pairs, truth %s ranked #1 on the device path; "
         "%.3f s including compilation (%s)" % (len(r1), truth, dt, card))
    return truth


# --------------------------------------------------------------------- #
# phase 4: scale parity, device path against the host engine
# --------------------------------------------------------------------- #
def build_scale_gene(n_alleles=SCALE_ALLELES, length=SCALE_LENGTH):
    from synth import make_hla_scale_msa

    from hgtpu.db import build_gene_ref

    spec = make_hla_scale_msa(n_alleles=n_alleles, length=length)
    ref, _ = build_gene_ref(
        "A", spec["names"], spec["rows"], spec["ref_allele"],
        exons_ref_coords=spec["exons"],
        primary_exon_idx=spec["primary_exon_idx"], min_var_freq=0.0)
    return ref


def simulate(ref, truths, interval=1, err=0.0, seed=1):
    from hgtpu.sim import simulate_reads

    r1, r2, _ = simulate_reads(ref, list(truths), simulate_interval=interval,
                               read_len=100, frag_len=250, seed=seed,
                               perbase_errorrate=err)
    return [(r.name, r.seq) for r in r1], [(r.name, r.seq) for r in r2]


def check_equal(dev, host, truths, what):
    """The production contract (tests/test_production.py): identical
    class-count dicts and read/pair counts, abundances within 1e-9 (the
    host and device runs feed identical classes to the same float64 EM;
    1e-9 leaves room only for summation order), the truths on top."""
    _check(dev.cmpt == host.cmpt, "%s: full cmpt differs" % what)
    _check(dev.exon_cmpt == host.exon_cmpt, "%s: exon cmpt differs" % what)
    _check(dev.num_reads == host.num_reads,
           "%s: num_reads %d != %d" % (what, dev.num_reads, host.num_reads))
    _check(dev.num_pairs == host.num_pairs,
           "%s: num_pairs %d != %d" % (what, dev.num_pairs, host.num_pairs))
    pd, ph = dict(dev.prob), dict(host.prob)
    _check(set(pd) == set(ph), "%s: called allele sets differ" % what)
    worst = max((abs(pd[a] - ph[a]) for a in pd), default=0.0)
    _check(worst < 1e-9, "%s: abundance differs by %r" % (what, worst))
    k = len(truths)
    _check({a for a, _ in dev.prob[:k]} == set(truths),
           "%s: top %d %s is not the truth %s"
           % (what, k, [a for a, _ in dev.prob[:k]], sorted(truths)))
    return worst


def _typed(ref, reads, opts):
    from hgtpu.pipeline import type_reads
    from hgtpu.utils.trace import TRACE

    TRACE.reset()
    t0 = time.perf_counter()
    res = type_reads(ref, reads[0], reads[1], opts)
    return res, time.perf_counter() - t0, TRACE.summary()


def _peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats()
    return stats.get("peak_bytes_in_use") if stats else None


def phase_parity(ref, truths, card, runs=((1, 0.0), (2, 0.02)), seed=1,
                 expect_reads=None):
    """Type each (interval, error) read set on the device path ("auto")
    and on the host engine ("off"); the first set also gets a warm repeat
    for the timings.  Returns the host result of the first set."""
    from hgtpu.typer.engine import TypingOptions

    auto = TypingOptions(simulation=True, device_typing="auto")
    host_opts = TypingOptions(simulation=True, device_typing="off",
                              device_counting="off")
    first_host = None
    for i, (interval, err) in enumerate(runs):
        what = "parity interval=%d err=%g" % (interval, err)
        reads = simulate(ref, truths, interval=interval, err=err, seed=seed)
        n = len(reads[0]) + len(reads[1])
        if i == 0 and expect_reads is not None:
            _check(n == expect_reads, "%d reads simulated, expected %d"
                   % (n, expect_reads))
        dev, cold, stages = _typed(ref, reads, auto)
        _check(any(k.startswith("device.") for k in stages),
               "%s: auto did not take the device path" % what)
        host, host_dt, _ = _typed(ref, reads, host_opts)
        worst = check_equal(dev, host, truths, what)
        _say("%s: %d reads, %d alleles, device == host (max abundance "
             "diff %r); device run %.3f s cold (includes compilation), "
             "host engine %.3f s (%s)"
             % (what, n, ref.n_alleles, worst, cold, host_dt, card))
        if i == 0:
            first_host = host
            warm, warm_dt, wstages = _typed(ref, reads, auto)
            check_equal(warm, host, truths, what + " (warm)")
            _say("%s: warm device run %.3f s = %.1f reads/s; compile "
                 "(cold - warm) %.3f s, counted as set-up (%s)"
                 % (what, warm_dt, n / warm_dt, cold - warm_dt, card))
            for k in ("device.place", "device.spell", "device.countB"):
                v = wstages.get(k)
                _say("  stage %s: %s (%s)" % (
                    k, "%.4f s" % v["s"] if v else "not run", card))
            for k, v in sorted(wstages.items(), key=lambda kv: -kv[1]["s"]):
                _say("  stage %-28s %.4f s x%d" % (k, v["s"], v["n"]))
            _say("%s: peak device memory %s bytes (%s)"
                 % (what, _peak_bytes(), card))
    return first_host


# --------------------------------------------------------------------- #
# phase 5: device EM precision
# --------------------------------------------------------------------- #
def _classes(cmpt):
    import numpy as np

    names, index, rows = [], {}, []
    for key in cmpt:
        row = []
        for a in key.split("-"):
            if a not in index:
                index[a] = len(names)
                names.append(a)
            row.append(index[a])
        rows.append(row)
    M = np.zeros((len(rows), len(names)), bool)
    for c, row in enumerate(rows):
        M[c, row] = True
    return names, M, np.array([float(v) for v in cmpt.values()])


def _plain_em_f64(M, counts, iters=100):
    """float64 twin of parallel/sharded._em_iterations."""
    import numpy as np

    Mf = M.astype(np.float64)
    p = Mf.T @ (counts / np.maximum(Mf.sum(1), 1.0))
    p = p / max(p.sum(), 1e-30)
    for _ in range(iters):
        denom = Mf @ p
        w = np.where(denom > 0, counts / np.where(denom > 0, denom, 1.0), 0.0)
        p = (Mf.T @ w) * p
        p = p / max(p.sum(), 1e-30)
    return p


# Tolerances, absolute per allele on abundances in [0, 1].  Both EMs run
# the float64 reference's arithmetic in f32 with full-f32 (HIGHEST)
# products, so they differ from it by f32 rounding only: on the scale
# run's 120 exon classes, 6.0e-8 (SQUAREM) and 5.6e-17 (100-step EM) on
# an H100 at 400 W.  The SQUAREM runs then cross their L1 < 1e-4 stop on
# the same step.  Products on operands rounded to TF32's 10-bit mantissa miss
# both limits: 3.9e-5 (SQUAREM) and 2.8e-5 (100-step EM) on the same
# classes.
SQUAREM_TOL = 1e-6
PLAIN_TOL = 1e-6


def phase_em(ref, host, card):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from hgtpu.parallel.production import _shared_sharded_typer, default_mesh
    from hgtpu.parallel.sharded import _em_iterations
    from hgtpu.typer.em import em_solve_dense, single_abundance
    from hgtpu.typer.engine import TypingOptions

    # the richer of the run's two class sets (at full depth the full
    # level can collapse to one class per truth allele)
    cmpt = max(host.cmpt, host.exon_cmpt, key=len)
    names, M, counts = _classes(cmpt)
    want = dict(single_abundance(cmpt))
    want_v = np.array([want.get(a, 0.0) for a in names])

    t0 = time.perf_counter()
    dense = em_solve_dense(M, counts)
    d_dense = float(np.abs(dense - want_v).max())

    # the production program's device EM (parallel/e2e em_shard): class
    # rows as 0/1 count rows over the gene's alleles, weights = counts
    typer = _shared_sharded_typer(ref, TypingOptions(), default_mesh(), 100)
    at = {a: i for i, a in enumerate(ref.allele_names)}
    col = np.array([at[a] for a in names])
    nd = typer.n_devices
    C = ((len(counts) + nd - 1) // nd) * nd
    cnt = np.zeros((C, ref.n_alleles), np.int32)
    cnt[:len(counts)][:, col] = M
    w = np.zeros(C, np.float32)
    w[:len(counts)] = counts
    e2e = np.asarray(typer._em_steps[(False, False)](
        jnp.asarray(cnt), jnp.asarray(w), typer._ones, typer._ones))[col]
    d_e2e = float(np.abs(e2e - want_v).max())

    plain = np.asarray(jax.jit(_em_iterations)(jnp.asarray(M),
                                                jnp.asarray(counts,
                                                            jnp.float32)))
    d_plain = float(np.abs(plain - _plain_em_f64(M, counts)).max())
    dt = time.perf_counter() - t0

    _say("em: %d classes over %d alleles; max |device - float64|: "
         "em_solve_dense %r, e2e SQUAREM %r (tol %g), 100-step EM %r "
         "(tol %g); %.3f s (%s)"
         % (len(counts), len(names), d_dense, d_e2e, SQUAREM_TOL,
            d_plain, PLAIN_TOL, dt, card))
    _check(d_dense < SQUAREM_TOL, "em_solve_dense off by %r" % d_dense)
    _check(d_e2e < SQUAREM_TOL, "e2e device EM off by %r" % d_e2e)
    _check(d_plain < PLAIN_TOL, "100-step device EM off by %r" % d_plain)


# --------------------------------------------------------------------- #
# --four-cards: production over a 4-device mesh against a 1-device mesh
# --------------------------------------------------------------------- #
def phase_four_cards(ref, truths, card, n_cards=4, seed=1):
    from hgtpu.parallel.production import type_reads_device
    from hgtpu.parallel.sharded import make_mesh
    from hgtpu.typer.engine import TypingOptions

    reads = simulate(ref, truths, interval=1, seed=seed)
    opts = TypingOptions(simulation=True)
    out = {}
    for n in (n_cards, 1):
        mesh = make_mesh(n)
        _check(mesh.devices.size == n, "mesh spans %d devices, not %d"
               % (mesh.devices.size, n))
        times = []
        for _ in range(2):
            t0 = time.perf_counter()
            out[n] = type_reads_device(ref, reads[0], reads[1], opts,
                                       mesh=mesh)
            times.append(time.perf_counter() - t0)
        _say("four-cards: %d-device mesh, %d reads: %.3f s cold "
             "(includes compilation), %.3f s warm (%s)"
             % (n, len(reads[0]) + len(reads[1]), times[0], times[1], card))
    worst = check_equal(out[n_cards], out[1], truths,
                        "%d-card vs 1-card" % n_cards)
    _say("four-cards: %d-card result == 1-card result (max abundance diff "
         "%r)" % (n_cards, worst))
    return n_cards


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only production over four cards against one")
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import hgtpu  # noqa: F401  (fails outside a checkout)
    import jax

    if not args.four_cards:
        # the default phases use exactly one card
        jax.config.update("jax_cuda_visible_devices", "0")
    dev, card = phase_device(4 if args.four_cards else 1)
    os.makedirs(OUT, exist_ok=True)
    if args.four_cards:
        ref = build_scale_gene()
        truths = [ref.allele_names[i] for i in SCALE_TRUTHS]
        count = phase_four_cards(ref, truths, card)
    else:
        phase_native(card)
        phase_cli(OUT, card)
        ref = build_scale_gene()
        truths = [ref.allele_names[i] for i in SCALE_TRUTHS]
        host = phase_parity(ref, truths, card, expect_reads=SCALE_READS)
        phase_em(ref, host, card)
        from hgtpu.parallel.production import default_mesh
        count = int(default_mesh().devices.size)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
