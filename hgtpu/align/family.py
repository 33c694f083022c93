"""Family-level alignment: assign reads across a multi-gene catalog.

The reference aligns each family's extracted reads against one graph
index containing all of that family's genes, and downstream drops NH>1
(multi-gene) alignments (typing_core.py:846-848).  Device-native equivalent:
one concatenated-panel placement matmul scores every (read, gene) pair
(align.panel.PanelRouter), full variant-graph alignment runs on each
read's candidate genes only, and a read is kept only when exactly one
gene attains its best cost — the NH==1 uniqueness rule.

For small families (< 3 genes) the exhaustive per-gene path is used —
the panel dispatch saves nothing there.
"""
from __future__ import annotations

import numpy as np

from ..db.catalog import Catalog
from .aligner import GeneAligner
from .panel import PanelRouter


class FamilyAligner:
    def __init__(self, catalog: Catalog, num_editdist: int = 2,
                 route: str = "auto", min_seed_frac: float = 0.3, **kw):
        self.catalog = catalog
        self.aligners = {g: GeneAligner(ref, num_editdist=num_editdist, **kw)
                         for g, ref in catalog.genes.items()}
        self.genes = list(catalog.genes)
        self.min_seed_frac = min_seed_frac
        self.router = None
        if route == "on" or (route == "auto" and len(self.genes) >= 3):
            self.router = PanelRouter(
                [(g, catalog.genes[g]) for g in self.genes])
            # see pipeline.extract.ReadExtractor for the window rationale
            self.slack = max(2 * num_editdist + 8, 16)

    def align_batch(self, read_ids, seqs, mate: str):
        """Returns {gene: [ReadAln | None]} keeping only reads uniquely
        best in that gene (others set to None)."""
        n = len(seqs)
        if self.router is None:
            per_gene = {g: al.align_batch(read_ids, seqs, mate)
                        for g, al in self.aligners.items()}
        else:
            gm, lens = self.router.gene_max(seqs)
            best = gm.max(axis=1) if n else np.zeros(0)
            floor = self.min_seed_frac * lens
            cand = gm >= np.maximum(best - self.slack, floor)[:, None]
            per_gene = {g: [None] * n for g in self.genes}
            for e, g in enumerate(self.genes):
                rows = np.flatnonzero(cand[:, e])
                if not len(rows):
                    continue
                alns = self.aligners[g].align_batch(
                    [read_ids[i] for i in rows],
                    [seqs[i] for i in rows], mate)
                res = per_gene[g]
                for i, aln in zip(rows.tolist(), alns):
                    res[i] = aln
        genes = list(per_gene)
        for i in range(n):
            costs = {}
            for g in genes:
                a = per_gene[g][i]
                if a is not None:
                    costs[g] = a.nm
            if not costs:
                continue
            best_c = min(costs.values())
            best_genes = [g for g, c in costs.items() if c == best_c]
            keep = best_genes[0] if len(best_genes) == 1 else None
            for g in genes:
                if g != keep:
                    per_gene[g][i] = None
        return per_gene
