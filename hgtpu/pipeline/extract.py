"""Read extraction: route raw (e.g. WGS) reads to families/genes.

Functional equivalent of the reference's extract_reads
(typing_process.py:1266-1784): align every read against the catalog of
family references, keep uniquely-best (NH==1) assignments, and emit
per-family read sets.  The reference does this by aligning to ONE
spliced genotype_genome index with HISAT2 and routing by locus interval;
the device-native equivalent is one concatenated-panel placement matmul
(align.panel.PanelRouter) that scores every (read, gene) pair in a
single matmul dispatch, followed by full variant-graph alignment only on
each read's candidate genes.
"""
from __future__ import annotations

from collections import defaultdict

import numpy as np

from ..align.aligner import GeneAligner
from ..align.panel import PanelRouter


class ReadExtractor:
    def __init__(self, catalogs, num_editdist: int = 2,
                 min_seed_frac: float = 0.3, **kw):
        """catalogs: {family: Catalog}."""
        self.entries = []  # (family, gene, GeneAligner)
        refs = []
        for family, cat in catalogs.items():
            for g, ref in cat.genes.items():
                self.entries.append((family, g, GeneAligner(
                    ref, num_editdist=num_editdist, **kw)))
                refs.append(((family, g), ref))
        self.router = PanelRouter(refs)
        self.min_seed_frac = min_seed_frac
        # candidate window below the global best panel score: a cost-c
        # alignment without indels places at score >= m - c, so
        # 2*editdist + margin keeps every mismatch-only tie; alignments
        # hidden behind a large indel may fall below the window — the
        # same class of seed heuristic HISAT2 itself applies
        # (--max-altstried 64, typing_common.py:1006)
        self.slack = max(2 * num_editdist + 8, 16)

    def _assign(self, read_ids, seqs, mate):
        """Per-read unique winning entry index (or None): route via the
        panel matmul, verify only candidate genes, keep NH==1."""
        n = len(seqs)
        out = [None] * n
        if n == 0:
            return out
        gm, lens = self.router.gene_max(seqs)            # [N, G]
        best = gm.max(axis=1)
        floor = self.min_seed_frac * lens
        cand = gm >= np.maximum(best - self.slack, floor)[:, None]
        per_read = defaultdict(list)                     # i -> [(nm, e)]
        for e, (_fam, _g, al) in enumerate(self.entries):
            rows = np.flatnonzero(cand[:, e])
            if not len(rows):
                continue
            alns = al.align_batch([read_ids[i] for i in rows],
                                  [seqs[i] for i in rows], mate)
            for i, aln in zip(rows.tolist(), alns):
                if aln is not None:
                    per_read[i].append((aln.nm, e))
        for i, costs in per_read.items():
            bc = min(c for c, _ in costs)
            best_entries = [e for c, e in costs if c == bc]
            if len(best_entries) == 1:
                out[i] = best_entries[0]
        return out

    def extract(self, reads_1, reads_2=None):
        """reads_*: [(name, seq)].  Returns
        {family: ([(name, seq)], [(name, seq)])} — a pair is routed to a
        family when at least one mate maps uniquely into it and the mates
        don't disagree."""
        ids1 = [n for n, _ in reads_1]
        a1 = self._assign(ids1, [s for _, s in reads_1], "L")
        if reads_2:
            a2 = self._assign([n for n, _ in reads_2],
                              [s for _, s in reads_2], "R")
        else:
            a2 = [None] * len(reads_1)
        out = defaultdict(lambda: ([], []))
        for i in range(len(reads_1)):
            e1, e2 = a1[i], (a2[i] if i < len(a2) else None)
            fams = {self.entries[e][0] for e in (e1, e2) if e is not None}
            if len(fams) != 1:
                continue
            fam = next(iter(fams))
            out[fam][0].append(reads_1[i])
            if reads_2:
                out[fam][1].append(reads_2[i])
        return dict(out)
