"""Whole-genome read extraction against the spliced genotype genome.

This is the reference's actual WGS design (extract_reads,
typing_process.py:1330-1784): align the sample to the genotype genome,
keep uniquely-mapped reads (NH==1, typing_process.py:1683-1690), route
reads whose placement lands inside a family locus into that family's
read set (:1691-1699), and optionally bin every uniquely-mapped read
into 20-Mbp whole-genome blocks (block_size, :1534-1594, 1700-1702).

Device-native: a checkpointed FM index over the spliced genome places
fixed-length seeds from both read ends (batched backward search on
device); candidate start positions are then VERIFIED by vectorized
Hamming comparison against the genome, and NH is the count of distinct
verified placements — seed votes alone never route a read.  Reads whose
catalog indel defeats the Hamming check fall back to a both-ends-unique
consistent-seed rule (the same class of heuristic the graph aligner's
seed chaining applies).
"""
from __future__ import annotations

import gzip
import os
from collections import defaultdict

import numpy as np

from ..ops.fm import FMIndex


class GenomeExtractor:
    def __init__(self, spliced_genome: dict, offsets: dict, catalogs: dict,
                 seed_len: int = 32, checkpoint: bool = True,
                 max_mm: int = 8, max_hits: int = 8):
        """spliced_genome: {chrom: seq} from build_genotype_genome;
        offsets: {(family, gene): spliced-coordinate left};
        catalogs: {family: Catalog}.

        max_mm: Hamming budget for placement verification — generous
        enough for catalog SNPs between a non-reference allele and the
        spliced backbone (the reference's hisat2 scores those through
        the graph, so its NM stays low; here they cost mismatches).
        """
        from ..utils.dna import encode_seq

        self.seed_len = seed_len
        self.max_mm = max_mm
        self.max_hits = max_hits
        parts = []
        self.chrom_starts = []        # (concat start, chrom)
        pos = 0
        for chrom, seq in spliced_genome.items():
            self.chrom_starts.append((pos, chrom))
            parts.append(encode_seq(seq))
            parts.append(np.array([4], np.int8))
            pos += len(seq) + 1
        self.codes = np.concatenate(parts) if parts \
            else np.zeros(0, np.int8)
        self.fm = FMIndex(self.codes, checkpoint=checkpoint)
        self._cs = np.array([c for c, _ in self.chrom_starts], np.int64)
        self._cnames = [n for _, n in self.chrom_starts]
        # locus intervals in concatenated coordinates
        self.intervals = []  # (start, end, family)
        for (family, gene), left in offsets.items():
            g = catalogs[family].genes[gene]
            base = self._cs[self._cnames.index(g.chrom)] + left
            self.intervals.append((base, base + len(g.backbone), family))
        self.intervals.sort()
        self.iv_starts = np.array([iv[0] for iv in self.intervals], np.int64)
        self.iv_ends = np.array([iv[1] for iv in self.intervals], np.int64)
        self._fams = sorted({iv[2] for iv in self.intervals})
        fam_code = {f: c for c, f in enumerate(self._fams)}
        self._iv_fam = np.array([fam_code[iv[2]] for iv in self.intervals],
                                np.int64) if self.intervals else \
            np.zeros(0, np.int64)

    def _locus_of(self, pos):
        i = int(np.searchsorted(self.iv_starts, pos, "right")) - 1
        if i < 0:
            return None
        start, end, family = self.intervals[i]
        return family if pos < end else None

    def _chrom_of(self, pos):
        i = int(np.searchsorted(self._cs, pos, "right")) - 1
        return self._cnames[i], int(pos - self._cs[i])

    # ------------------------------------------------------------------ #
    def _place_unique(self, seqs):
        """Verified unique placement per sequence, fully vectorized
        (ref analog: the multithreaded C++ hisat2 alignment of
        typing_process.py:1467-1489; this path replaces per-read loops
        with one bulk encode, one batched FM search, one SA gather and
        one Hamming matrix per call).

        Returns [start | None] in concatenated coordinates: the single
        verified placement when NH==1 over both orientations, else None.
        """
        k = self.seed_len
        n = len(seqs)
        G = len(self.codes)
        if n == 0:
            return []
        # ---- bulk encode: one LUT pass over the joined byte buffer
        lens = np.fromiter((len(s) for s in seqs), np.int64, n)
        Lmax = int(lens.max()) if n else 0
        if Lmax < k:
            return [None] * n
        lut = np.full(256, 4, np.int8)
        for b, c in zip(b"ACGT", range(4)):
            lut[b] = c
        for b, c in zip(b"acgt", range(4)):
            lut[b] = c
        enc = lut[np.frombuffer("".join(seqs).encode(), np.uint8)]
        starts0 = np.zeros(n, np.int64)
        np.cumsum(lens[:-1], out=starts0[1:])
        rows = np.repeat(np.arange(n), lens)
        cols = np.arange(int(lens.sum())) - np.repeat(starts0, lens)
        codes_f = np.full((n, Lmax), 4, np.int8)
        codes_f[rows, cols] = enc
        codes_r = np.full((n, Lmax), 4, np.int8)
        codes_r[rows, lens[rows] - 1 - cols] = \
            np.where(enc < 4, 3 - enc, np.int8(4))
        stacked = np.stack([codes_f, codes_r])          # [2, n, Lmax]

        # ---- batched seed search: front/mid/back seeds, both
        # orientations (three seeds so one catalog indel can defeat at
        # most one of them)
        offs = np.stack([np.zeros(n, np.int64), (lens - k) // 2,
                         lens - k], 1)                  # [n, 3]
        ok_len = lens >= k
        jj = np.arange(k)
        sidx = offs[:, :, None] + jj[None, None, :]     # [n, 3, k]
        sidx = np.clip(sidx, 0, Lmax - 1)
        ii = np.arange(n)[:, None, None]
        queries = np.concatenate(
            [codes_f[ii, sidx], codes_r[ii, sidx]], 0)  # [2n, 3, k]
        queries = queries.reshape(2 * n * 3, k)
        lo, hi = self.fm.search_batch(queries)
        lo = np.asarray(lo).astype(np.int64)
        hi = np.asarray(hi).astype(np.int64)
        # per seed row: read, orientation, offset
        s_read = np.tile(np.repeat(np.arange(n), 3), 2)
        s_or = np.repeat(np.arange(2), n * 3)
        s_off = np.tile(offs.reshape(-1), 2)
        nh = hi - lo
        ok_seed = (nh >= 1) & (nh <= self.max_hits) & ok_len[s_read]
        # dedup duplicate offsets per read (short reads where front/mid/
        # back coincide — keep the first occurrence)
        key = (s_or.astype(np.int64) * n + s_read) * (Lmax + 1) + s_off
        order = np.argsort(key, kind="stable")
        kd = key[order]
        dmask = np.zeros(len(key), bool)
        dmask[order[1:]] = kd[1:] == kd[:-1]
        ok_seed &= ~dmask

        # ---- batched SA locate of every surviving seed hit ---------- #
        cnt = np.where(ok_seed, np.minimum(nh, self.max_hits), 0)
        total = int(cnt.sum())
        if total == 0:
            return [None] * n
        rep = np.repeat(np.arange(len(cnt)), cnt)
        cstart = np.zeros(len(cnt), np.int64)
        np.cumsum(cnt[:-1], out=cstart[1:])
        t = np.arange(total) - np.repeat(cstart, cnt)
        pos = np.asarray(self.fm.sa[lo[rep] + t]).astype(np.int64)
        h_read = s_read[rep]
        h_or = s_or[rep]
        h_start = pos - s_off[rep]
        h_uniq = (nh[rep] == 1)
        in_g = (h_start >= 0) & (h_start + lens[h_read] <= G)

        # ---- candidate dedup + vectorized Hamming verification ------ #
        ckey = (h_or.astype(np.int64) * n + h_read) * np.int64(G + 1) \
            + h_start
        cu = np.unique(ckey[in_g])
        v_or = (cu // (G + 1)) // n
        v_read = (cu // (G + 1)) % n
        v_start = cu % (G + 1)
        m = len(cu)
        verified_read = np.zeros(0, np.int64)
        verified_start = np.zeros(0, np.int64)
        if m:
            jL = np.arange(Lmax)
            gidx = np.minimum(v_start[:, None] + jL[None, :], G - 1)
            gcodes = self.codes[gidx]
            rcodes = stacked[v_or, v_read]
            valid = jL[None, :] < lens[v_read][:, None]
            mm = ((gcodes != rcodes) & valid).sum(axis=1)
            okv = mm <= self.max_mm
            verified_read = v_read[okv]
            verified_start = v_start[okv]
        vcnt = np.bincount(verified_read, minlength=n)
        out = [None] * n
        one = np.flatnonzero(vcnt == 1)
        first = np.full(n, -1, np.int64)
        first[verified_read[::-1]] = verified_start[::-1]
        for i in one:
            out[i] = int(first[i])

        # ---- indel fallback for reads with NO verified candidate:
        # an alignment through a catalog indel fails the Hamming check
        # but its unique-hit seeds still agree on one placement (within
        # the indel drift).  Accept when one orientation has >= 1
        # unique seed, all its unique seeds are mutually consistent,
        # and the other orientation has none.
        need = np.flatnonzero(vcnt == 0)
        if len(need):
            un = ok_seed[rep] & h_uniq
            useed_read = h_read[un]
            useed_or = h_or[un]
            useed_off = s_off[rep][un]
            useed_pos = pos[un]
            sel = np.isin(useed_read, need)
            ur, uo = useed_read[sel], useed_or[sel]
            uoff, upos = useed_off[sel], useed_pos[sel]
            hits_by = defaultdict(list)
            for r_, o_, off_, p_ in zip(ur, uo, uoff, upos):
                hits_by[(int(r_), int(o_))].append((int(off_), int(p_)))
            for i in need:
                pick = None
                ambiguous = False
                for o in (0, 1):
                    hits = hits_by.get((int(i), o), [])
                    if not hits:
                        continue
                    ss = [p - off for off, p in hits]
                    if max(ss) - min(ss) > 32:
                        continue
                    if pick is not None:   # both orientations: ambiguous
                        ambiguous = True
                        break
                    off0, p0 = min(hits)   # front-most unique seed
                    pick = p0 - off0
                out[i] = None if ambiguous else pick
        return out

    # ------------------------------------------------------------------ #
    def extract(self, reads_1, reads_2=None, block_size: int = 0):
        """Route read (pairs) by verified unique placement.

        Returns {family: ([(name, seq)], [(name, seq)])}.  With
        block_size > 0 returns (families, blocks) where blocks maps
        (chrom, block_index) -> the same pair-of-lists structure — the
        reference's whole-genome 20-Mbp binning
        (typing_process.py:1534-1594; block key `chr-pos/block_size`
        at :1700-1702).
        """
        out = {}
        blocks = {}
        n = len(reads_1)
        seqs = [s for _, s in reads_1]
        starts_1 = self._place_unique(seqs)
        starts_2 = [None] * n
        if reads_2:
            starts_2 = self._place_unique([s for _, s in reads_2])

        # vectorized routing: per-mate family/block codes, then one
        # index pass per family/block (the pair goes to every region
        # any mate hit uniquely, ref typing_process.py:1638-1651)
        s1 = np.array([-1 if s is None else s for s in starts_1],
                      np.int64)
        s2 = np.array([-1 if s is None else s for s in starts_2],
                      np.int64)

        def fam_codes(s):
            if not len(self.iv_starts):
                return np.full(len(s), -1, np.int64)
            iv = np.searchsorted(self.iv_starts, s, "right") - 1
            ivc = np.clip(iv, 0, len(self.iv_starts) - 1)
            okf = (s >= 0) & (iv >= 0) & (s < self.iv_ends[ivc])
            return np.where(okf, self._iv_fam[ivc], -1)

        f1, f2 = fam_codes(s1), fam_codes(s2)
        for c, fam in enumerate(self._fams):
            idx = np.flatnonzero((f1 == c) | (f2 == c))
            if len(idx):
                out[fam] = ([reads_1[i] for i in idx],
                            [reads_2[i] for i in idx] if reads_2 else [])
        if block_size > 0:
            def block_keys(s):
                ci = np.searchsorted(self._cs, s, "right") - 1
                cic = np.clip(ci, 0, len(self._cs) - 1)
                local = s - self._cs[cic]
                key = cic * (1 << 40) + local // block_size
                return np.where(s >= 0, key, -1)

            b1, b2 = block_keys(s1), block_keys(s2)
            for key in np.unique(np.concatenate([b1, b2])):
                if key < 0:
                    continue
                idx = np.flatnonzero((b1 == key) | (b2 == key))
                chrom = self._cnames[int(key >> 40)]
                bk = (chrom, int(key & ((1 << 40) - 1)))
                blocks[bk] = ([reads_1[i] for i in idx],
                              [reads_2[i] for i in idx]
                              if reads_2 else [])
            return out, blocks
        return out


def write_block_fastqs(out_dir, base, blocks, block_size, paired=True):
    """Write per-block gzipped FASTQs with the reference's filename
    convention `<base>-<chr>-<start>_<end>M-extracted-{1,2}.fq.gz`
    (typing_process.py:1553-1594).  Returns the written paths."""
    mult = block_size // 1000000 if block_size >= 1000000 else block_size
    paths = []
    for (chrom, bi), (r1, r2) in sorted(blocks.items()):
        stem = "%s-%s-%d_%dM-extracted" % (base, chrom, bi * mult,
                                           (bi + 1) * mult)
        names = ["%s-1.fq.gz" % stem, "%s-2.fq.gz" % stem] if paired \
            else ["%s.fq.gz" % stem]
        for fname, reads in zip(names, [r1, r2][:len(names)]):
            path = os.path.join(out_dir, fname)
            with gzip.open(path, "wt") as f:
                for name, seq in reads:
                    f.write("@%s\n%s\n+\n%s\n" % (name, seq, "I" * len(seq)))
            paths.append(path)
    return paths
