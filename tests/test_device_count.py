"""Device compatibility counting must equal the host reference path."""
import numpy as np
import pytest

from hgtpu.db import build_gene_ref
from hgtpu.typer.counting import GeneCounter, HtOp
from hgtpu.typer.device_count import DeviceCounter
from tests.synth import make_gene_msa


@pytest.fixture(scope="module")
def generef():
    spec = make_gene_msa(seed=11, n_alleles=32, length=2000)
    ref, _ = build_gene_ref("A", spec["names"], spec["rows"],
                            spec["ref_allele"], min_var_freq=0.0)
    return ref


def _sample_hts(gene, n=200, seed=3):
    rng = np.random.default_rng(seed)
    hts = []
    for _ in range(n):
        a = rng.integers(0, gene.n_alleles)
        avars = np.flatnonzero(gene.links[:, a])
        left = int(rng.integers(0, len(gene.backbone) - 120))
        right = left + 99
        vs = [int(v) for v in avars
              if left <= gene.var_pos[v] and gene.var_right[v] <= right]
        hts.append((left, right, vs))
    return hts


def _host_mask(gene, counter, ht):
    left, right, vs = ht
    ops = []
    for v in vs:
        kind = ("mismatch", "deletion", "insertion")[int(gene.var_type[v])]
        ops.append(HtOp(kind, int(gene.var_pos[v]), int(gene.var_len[v]),
                        v, gene.var_data[v]))
    return counter.alleles_for_ht(left, right, ops)


def test_device_matches_host(generef):
    counter = GeneCounter(generef)
    dc = DeviceCounter(generef)
    hts = _sample_hts(generef)
    lefts, rights, vars_ = dc.pack_hts(hts)
    dev = dc.compat_masks(lefts, rights, vars_)
    for i, ht in enumerate(hts):
        host = _host_mask(generef, counter, ht)
        assert np.array_equal(dev[i], host), (i, ht)


def test_host_batch_masks_match_single(generef):
    """alleles_for_hts_batch rows must be identical to alleles_for_ht."""
    import numpy as np
    from hgtpu.typer.counting import GeneCounter, HtOp

    g = generef
    counter = GeneCounter(g)
    rng = np.random.default_rng(3)
    sub_hts = []
    for _ in range(50):
        left = int(rng.integers(0, len(g.backbone) - 120))
        right = left + int(rng.integers(30, 120))
        n = int(rng.integers(0, 4))
        vis = [int(v) for v in rng.integers(0, g.n_vars, n)]
        ops = [HtOp(("mismatch", "deletion", "insertion")[int(g.var_type[v])],
                    int(g.var_pos[v]), int(g.var_len[v]), v, g.var_data[v])
               for v in vis]
        if rng.random() < 0.3:
            ops.append(HtOp("mismatch", left + 5, 1, -1, "A"))  # novel
        sub_hts.append((left, right, ops))
    batch = counter.alleles_for_hts_batch(
        [(l, r, [o.var_idx for o in ops]) for l, r, ops in sub_hts])
    for h, (l, r, ops) in enumerate(sub_hts):
        single = counter.alleles_for_ht(l, r, ops).astype(np.int32)
        assert (batch[h] == single).all(), h


def test_device_fold_end_to_end_identical(generef):
    """type_gene with device_counting='on' (fused device fold) must be
    bit-identical to the host path: cmpt dicts at all three levels,
    ranked counts, and abundance."""
    from hgtpu.pipeline import type_reads
    from hgtpu.sim import simulate_reads
    from hgtpu.typer.engine import TypingOptions

    alleles = [generef.allele_names[3], generef.allele_names[17]]
    r1, r2, _ = simulate_reads(generef, alleles, simulate_interval=3,
                               seed=5)
    reads_1 = [(r.name, r.seq) for r in r1]
    reads_2 = [(r.name, r.seq) for r in r2]
    res_host = type_reads(generef, reads_1, reads_2,
                          TypingOptions(simulation=True,
                                        device_counting="off"))
    res_dev = type_reads(generef, reads_1, reads_2,
                         TypingOptions(simulation=True,
                                       device_counting="on"))
    assert res_dev.cmpt == res_host.cmpt
    assert res_dev.exon_cmpt == res_host.exon_cmpt
    assert res_dev.primary_exon_cmpt == res_host.primary_exon_cmpt
    assert res_dev.counts == res_host.counts
    assert res_dev.prob == res_host.prob


def test_device_fold_with_errors_identical(generef):
    """Error-corrected + novel-variant haplotypes through the device
    fold (exercises sentinel padding and in-range kv logic)."""
    from hgtpu.pipeline import type_reads
    from hgtpu.sim import simulate_reads
    from hgtpu.typer.engine import TypingOptions

    allele = generef.allele_names[9]
    r1, r2, _ = simulate_reads(generef, [allele], simulate_interval=4,
                               perbase_errorrate=0.3, seed=11)
    reads_1 = [(r.name, r.seq) for r in r1]
    reads_2 = [(r.name, r.seq) for r in r2]
    res_host = type_reads(generef, reads_1, reads_2,
                          TypingOptions(simulation=True,
                                        device_counting="off"))
    res_dev = type_reads(generef, reads_1, reads_2,
                         TypingOptions(simulation=True,
                                       device_counting="on"))
    assert res_dev.cmpt == res_host.cmpt
    assert res_dev.counts == res_host.counts
    assert res_dev.prob == res_host.prob


def test_gene_shared_state_cache(generef):
    """Per-gene typing state (counter, alts index, device tables) is
    cached ON the GeneRef — repeat GeneTyper construction is ~free and
    results are unchanged; a derived panel (exclude_alleles) starts a
    fresh cache."""
    gene = generef
    from hgtpu.pipeline import type_reads
    from hgtpu.sim import simulate_reads
    from hgtpu.typer.engine import (GeneTyper, TypingOptions,
                                    shared_device_counter)

    t1 = GeneTyper(gene)
    t2 = GeneTyper(gene)
    assert t1.counter is t2.counter
    assert t1.alts_left is t2.alts_left
    assert shared_device_counter(gene) is shared_device_counter(gene)

    allele = gene.allele_names[2]
    r1, r2, _ = simulate_reads(gene, [allele], simulate_interval=6)
    reads_1 = [(r.name, r.seq) for r in r1]
    reads_2 = [(r.name, r.seq) for r in r2]
    a = type_reads(gene, reads_1, reads_2, TypingOptions(simulation=True))
    b = type_reads(gene, reads_1, reads_2, TypingOptions(simulation=True))
    assert a.prob == b.prob and a.cmpt == b.cmpt

    sub = gene.exclude_alleles([gene.allele_names[5]])
    assert "_typer_shared" not in sub.__dict__
    t3 = GeneTyper(sub)
    assert t3.counter is not t1.counter
