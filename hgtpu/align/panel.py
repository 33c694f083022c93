"""One-matmul routing of a read batch across a multi-gene panel.

The reference extracts/routes reads by aligning them against ONE spliced
index (genotype_genome or a family graph index) and binning by locus
interval (typing_process.py:1604-1716); round-1's ReadExtractor instead
ran a FULL placement per gene per family — O(genes) placement dispatches per
read batch.  This router restores the one-index design on device:

  * all genes' PWMs are concatenated with a zero spacer wide enough that
    no diagonal window straddles two genes,
  * one im2col matmul scores every (read, diagonal) pair over the whole
    panel (both orientations stacked),
  * a segment-max over the window axis reduces to per-gene best scores
    [N, G] — the only thing fetched.

Downstream, full alignment runs only on each read's candidate genes.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.placement import correlate_scores, backbone_pwm, encode_reads

# spacer rows between genes; reads longer than this are clipped for
# routing (typing reads are 100-300 bp)
SPACER = 512


@functools.partial(jax.jit, static_argnames=("n_genes",))
def _panel_max(pwm_concat, seg_ids, reads, n_genes):
    scores = correlate_scores(pwm_concat, reads)        # [N, P1]
    # windows in the trailing spacer map to segment n_genes (all-zero
    # content); computed then dropped
    gm = jax.ops.segment_max(scores.T, seg_ids,
                             num_segments=n_genes + 1)  # [G+1, N]
    return gm[:n_genes].T                               # [N, G]


class PanelRouter:
    def __init__(self, refs, pad_len: int = 128):
        """refs: ordered [(key, GeneRef)]."""
        self.keys = [k for k, _ in refs]
        self.pad_len = pad_len
        rows = []
        self.row_ends = []        # per gene: last row + 1 (segment bound)
        at = 0
        for _key, ref in refs:
            rows.append(np.zeros((SPACER, 5), np.float32))
            pwm = backbone_pwm(ref)
            at += SPACER
            rows.append(pwm)
            at += len(pwm)
            self.row_ends.append(at)
        rows.append(np.zeros((SPACER, 5), np.float32))
        self.pwm_concat = jnp.asarray(np.concatenate(rows, axis=0))
        self._row_ends = np.asarray(self.row_ends, np.int64)
        self._seg_cache = {}      # read length -> device seg_ids

    def _seg_ids(self, m):
        ids = self._seg_cache.get(m)
        if ids is None:
            P1 = self.pwm_concat.shape[0] - m + 1
            # window p covers rows p..p+m-1; with SPACER >= m a window
            # sees content of exactly one gene: the one whose row range
            # it reaches (searchsorted over gene end offsets)
            ids = jnp.asarray(np.searchsorted(
                self._row_ends, np.arange(P1), side="right").astype(
                    np.int32))
            self._seg_cache[m] = ids
        return ids

    _COMP = np.array([3, 2, 1, 0, 4, 5], dtype=np.int8)

    def gene_max(self, seqs):
        """Per-gene best diagonal score over both orientations.

        Returns (gene_max [N, G] float32, m [N] routed lengths).
        """
        n = len(seqs)
        clip = [s[:SPACER] for s in seqs]
        m = max(len(s) for s in clip)
        m = ((m + self.pad_len - 1) // self.pad_len) * self.pad_len
        m = min(m, SPACER)
        fwd = encode_reads(clip, m)
        lens = np.fromiter((min(len(s), m) for s in clip), np.int64, n)
        j = np.arange(m)
        rev = fwd[:, ::-1]
        idx = np.minimum(j[None, :] + (m - lens)[:, None], m - 1)
        rc = self._COMP[rev[np.arange(n)[:, None], idx]]
        rc[j[None, :] >= lens[:, None]] = 4
        both = np.concatenate([fwd, rc], axis=0)
        gm = _panel_max(self.pwm_concat, self._seg_ids(m),
                        jnp.asarray(both), n_genes=len(self.keys))
        gm = np.asarray(gm)
        return np.maximum(gm[:n], gm[n:]), lens
