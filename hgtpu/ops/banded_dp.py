"""Banded variant-aware extension DP — the device verify stage.

Computes, entirely on device, the exact minimum novel-edit cost of
aligning a read at a proposed backbone start through the variant graph —
the same quantity the host DFS (hgtpu.align.verify.GeneVerifier /
native/verifier.cpp) minimizes, replacing HISAT2's extension stage
(SURVEY.md §7 "graph-aware banded extension DP"; the reference invokes it
via `hisat2 --max-altstried 64`, typing_common.py:995-1036).

State space: (read chars consumed i, diagonal offset d) with backbone
position pos = start + i + d.  Catalog deletions shift d by +len at their
position for free; catalog insertions consume len read chars at fixed pos
for free (sequence-matched); novel edits follow the DFS rules exactly —
mismatch +1 at non-free chars, novel del/ins of length 1-2 at +length,
indels only after the first consumed char.  The band covers
d in [-DNEG, +DPOS]; paths needing more drift, positions with more
catalog indel alternatives than the packed slots, or deletion chains
longer than the closure depth raise the per-proposal `overflow` flag and
the caller falls back to the host DFS for those entries.

Device mapping: every transition is a *static diagonal shift*.  The gene's
distinct catalog deletion/insertion lengths are compile-time constants,
so each relaxation is a masked elementwise min over a shifted [E, D]
plane — no data-dependent scatters, which serialize on an accelerator (the
first version used `.at[].min` scatters).

The DP is exact *modulo the haplotype-window constraint* (which is
path-dependent): its cost can only be lower than the constrained DFS's,
so callers that enable the constraint must confirm the winning proposal
with the DFS and fall back when costs disagree.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..db.catalog import GeneRef, VT_SINGLE, VT_DELETION

DNEG = 8          # max leftward drift (catalog/novel insertions)
DPOS = 24         # max rightward drift (catalog/novel deletions)
D = DNEG + DPOS + 1
NI = 2            # catalog insertion slots per position
IL = 4            # max catalog insertion length handled on device
NITER = 4         # intra-layer closure depth (catalog/novel del chains)
OFF = DNEG + 2    # gather offset so pos + OFF >= 0 inside the band
INF = 1 << 20


class BandedDPTables:
    """Per-gene device tables for the banded DP."""

    def __init__(self, gene: GeneRef):
        self.gene = gene
        P = len(gene.backbone)
        self.P = P
        rows = P + OFF + DPOS + 4096   # tail headroom for start+i+d
        free = np.zeros((rows, 8), dtype=bool)
        free[OFF + np.arange(P), gene.backbone_enc] = True
        over = np.zeros(rows, dtype=bool)
        # distinct catalog deletion lengths representable in the band
        # become static shift amounts; one boolean plane per length
        dlens = sorted({int(gene.var_len[vi])
                        for vi in range(gene.n_vars)
                        if int(gene.var_type[vi]) == VT_DELETION
                        and int(gene.var_len[vi]) <= DPOS})
        self.del_lens = tuple(dlens)
        dl_slot = {l: k for k, l in enumerate(dlens)}
        del_has = np.zeros((rows, max(1, len(dlens))), dtype=bool)
        ins_len = np.zeros((rows, NI), dtype=np.int32)
        ins_seq = np.full((rows, NI, IL), 7, dtype=np.int8)  # never matches
        ilens = set()
        i_fill = {}
        for vi in range(gene.n_vars):
            vt = int(gene.var_type[vi])
            pos = int(gene.var_pos[vi])
            r = OFF + pos
            if vt == VT_SINGLE:
                free[r, "ACGT".index(gene.var_data[vi])] = True
            elif vt == VT_DELETION:
                dlen = int(gene.var_len[vi])
                if dlen > DPOS:
                    over[r] = True
                else:
                    del_has[r, dl_slot[dlen]] = True
            else:
                k = i_fill.get(pos, 0)
                seq = gene.var_data[vi]
                if k >= NI or len(seq) > min(IL, DNEG):
                    over[r] = True
                else:
                    ins_len[r, k] = len(seq)
                    for j, ch in enumerate(seq):
                        ins_seq[r, k, j] = "ACGT".index(ch)
                    i_fill[pos] = k + 1
                    ilens.add(len(seq))
        self.ins_lens = tuple(sorted(ilens))
        self.arrays = (jnp.asarray(free), jnp.asarray(del_has),
                       jnp.asarray(ins_len), jnp.asarray(ins_seq),
                       jnp.asarray(over))

    def costs(self, reads: np.ndarray, lens: np.ndarray,
              starts: np.ndarray, max_novel: int = 2):
        """reads [E, W] int8 (pad anything), lens [E], starts [E] ->
        (cost [E] int32, overflow [E] bool).  cost >= INF means no
        alignment exists within `max_novel` novel edits inside the band
        (costs above the budget saturate — they can never win, and
        saturation is what lets the deletion-chain closure converge)."""
        return _banded_costs(self.arrays,
                             jnp.asarray(reads, jnp.int8),
                             jnp.asarray(lens, jnp.int32),
                             jnp.asarray(starts, jnp.int32),
                             self.P, jnp.int32(max_novel),
                             self.del_lens, self.ins_lens)


def _shift_min(dst, src, mask, shift, add=0):
    """dst = min(dst, (src + add) shifted `shift` diagonals right where
    mask) — the scatter-free transition.  shift > 0 moves mass toward
    larger d (deletions); shift < 0 toward smaller d (insertions)."""
    E = dst.shape[0]
    vals = jnp.where(mask, src + add, INF)
    if shift > 0:
        return dst.at[:, shift:].min(vals[:, : D - shift])
    if shift < 0:
        return dst.at[:, : D + shift].min(vals[:, -shift:])
    return jnp.minimum(dst, vals)


@functools.partial(jax.jit,
                   static_argnames=("P", "del_lens", "ins_lens"))
def _banded_costs(tables, reads, lens, starts, P, max_novel,
                  del_lens=(), ins_lens=()):
    free_tbl, del_has_tbl, ins_len_tbl, ins_seq_tbl, pos_over_tbl = tables
    E, W = reads.shape

    def sat(x):
        return jnp.where(x > max_novel, INF, x)
    d_idx = jnp.arange(D, dtype=jnp.int32)          # [D]
    d_val = d_idx - DNEG

    cur0 = jnp.full((E, D), INF, jnp.int32).at[:, DNEG].set(0)
    pend0 = jnp.full((IL, E, D), INF, jnp.int32)
    final0 = jnp.full((E,), INF, jnp.int32)
    over0 = jnp.zeros((E,), bool)

    def body(carry, i):
        cur, pend, final, over = carry
        cur = jnp.minimum(cur, pend[0])
        pend = jnp.concatenate(
            [pend[1:], jnp.full((1, E, D), INF, jnp.int32)], axis=0)
        final = jnp.where(lens == i, jnp.minimum(final, cur.min(axis=1)),
                          final)
        live = i < lens                                     # [E]
        pos = starts[:, None] + i + d_val[None, :]          # [E, D]
        pidx = jnp.clip(pos + OFF, 0, free_tbl.shape[0] - 1)
        ch = reads[:, jnp.minimum(i, W - 1)]                # [E]
        free = free_tbl[pidx, jnp.clip(ch, 0, 7)[:, None]]  # [E, D]
        pos_ok = (pos >= 0) & (pos < P)
        finite = cur < INF
        indels_on = (i > 0) & live                          # scalar & [E]
        # positions whose catalog indels exceed the packed slots poison
        # any finite state that touches them
        over = over | (finite & pos_ok & pos_over_tbl[pidx]
                       & indels_on[:, None]).any(axis=1)

        # ---- intra-layer closure: catalog + novel deletions ---- #
        # all transitions are static right-shifts of the diagonal plane
        dl_any = del_has_tbl[pidx]                          # [E, D, nLd]
        over_acc = []

        def relax(c):
            new = c
            gate = (c < INF) & pos_ok & indels_on[:, None]
            for k, L in enumerate(del_lens):                # catalog, free
                has = gate & dl_any[:, :, k]
                new = _shift_min(new, c, has, L)
                over_acc.append(has[:, D - L:].any(axis=1))
            ngate = gate & ~free          # novel deletions cost their len
            for L in (1, 2):
                new = _shift_min(new, c, ngate, L, add=L)
                over_acc.append((ngate[:, D - L:]
                                 & (c[:, D - L:] < INF)).any(axis=1))
            return sat(new)

        c = cur
        for _ in range(NITER):
            c = relax(c)
        c_extra = relax(c)
        # closure did not converge -> chains deeper than NITER
        over = over | ((c_extra < c).any(axis=1))
        for ob in over_acc:
            over = over | ob
        cur = c

        # ---- catalog insertions (free, consume il chars at fixed pos) #
        il_tbl = ins_len_tbl[pidx]                          # [E, D, NI]
        win = jax.lax.dynamic_slice(
            jnp.pad(reads, ((0, 0), (0, IL)), constant_values=6),
            (0, i), (E, IL))                                # [E, IL]
        gate_i = (cur < INF) & pos_ok & indels_on[:, None]
        for slot in range(NI):
            il = il_tbl[:, :, slot]                         # [E, D]
            seq = ins_seq_tbl[pidx, slot, :]                # [E, D, IL]
            k = jnp.arange(IL, dtype=jnp.int32)
            match = jnp.where(k[None, None, :] < il[:, :, None],
                              win[:, None, :] == seq, True).all(axis=2)
            for L in ins_lens:                              # static shifts
                has = (gate_i & (il == L) & match
                       & (i + L <= lens[:, None]))
                pend = pend.at[L - 1].set(_shift_min(
                    pend[L - 1], cur, has, -L))
                over = over | has[:, :L].any(axis=1)

        # ---- consume char i ---- #
        step = jnp.where(free & pos_ok, 0,
                         jnp.where(pos_ok, 1, INF))
        nxt = sat(jnp.minimum(cur + step, INF))
        # novel insertions (consume 1-2 chars at fixed pos, +length)
        ngate = (cur < INF) & pos_ok & ~free & indels_on[:, None]
        for L in (1, 2):
            fits = i + L <= lens                            # [E]
            has = ngate & fits[:, None]
            pend = pend.at[L - 1].set(
                sat(_shift_min(pend[L - 1], cur, has, -L, add=L)))
            over = over | (has[:, :L] & (cur[:, :L] < INF)).any(axis=1)
        cur = jnp.where(live[:, None], nxt, cur)
        return (cur, pend, final, over), None

    (cur, pend, final, over), _ = jax.lax.scan(
        body, (cur0, pend0, final0, over0),
        jnp.arange(W + 1, dtype=jnp.int32))
    return final, over
