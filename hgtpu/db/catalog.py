"""Graph-reference catalog: the in-memory / on-disk database for one family.

This is the device-native replacement for the reference's 10 per-family text
files (``base_backbone.fa``, ``base.snp``, ``base.index.snp``, ``base.link``,
``base.haplotype``, ``base.locus``, ``base.allele``, ``base.partial``,
``base_sequences.fa``, ``base.snp.freq`` — written at
hisatgenotype_typing_process.py:576-595,1001-1255).  Instead of text files
round-tripped through subprocesses, everything lives as packed numpy arrays
(host) that upload directly as device arrays, plus exact text exporters for
parity debugging against the reference formats.

Variant model (ref: typing_common.py:339-368 read_variants):
  type in {single, deletion, insertion}; pos is a 0-based backbone
  coordinate; data is the alternative base (single), deletion length
  (deletion) or inserted sequence (insertion).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..utils.dna import encode_seq

VT_SINGLE = 0
VT_DELETION = 1
VT_INSERTION = 2

_VT_NAME = {VT_SINGLE: "single", VT_DELETION: "deletion", VT_INSERTION: "insertion"}
_VT_CODE = {v: k for k, v in _VT_NAME.items()}


@dataclasses.dataclass
class GeneRef:
    """All reference data for one gene (locus) of a family."""

    gene: str                      # e.g. "A"
    backbone_name: str             # e.g. "A*BACKBONE"
    backbone: str                  # consensus sequence, no gaps
    allele_names: list             # allele names (no backbone), DB order
    # --- variant table (sorted by key_varKey; ids "hv<N>" family-global) ---
    var_ids: list                  # "hv0", "hv1", ...
    var_type: np.ndarray           # int8 [V]
    var_pos: np.ndarray            # int32 [V] 0-based backbone coordinate
    var_len: np.ndarray            # int32 [V] 1 / del len / ins len
    var_data: list                 # str: alt base / str(len) / inserted seq
    var_freq: np.ndarray           # float32 [V] percentage 0..100
    links: np.ndarray              # bool [V, A] allele<->variant membership
    # --- annotations ---
    exons: list                    # [(left, right)] inclusive backbone coords
    primary_exons: list            # subset of exons
    haplotypes: list               # [(left, right, [var index, ...])]
    partial: set = dataclasses.field(default_factory=set)
    # locus placement on the host genome (chromosome coordinates)
    chrom: str = "chrU"
    chrom_left: int = 0
    chrom_right: int = 0
    strand: str = "+"
    min_var_freq: float = 0.0

    # ------------------------------------------------------------------ #
    # derived, cached
    # ------------------------------------------------------------------ #
    def __post_init__(self):
        self._id2idx = {v: i for i, v in enumerate(self.var_ids)}
        self._allele_idx = {a: i for i, a in enumerate(self.allele_names)}
        self.backbone_enc = encode_seq(self.backbone)
        # position-sorted order == storage order (sorted by key_varKey which
        # leads with pos); var_pos is non-decreasing.
        assert np.all(np.diff(self.var_pos) >= 0), "variants must be pos-sorted"
        # right ends (inclusive): pos for single/ins, pos+len-1 for deletions
        self.var_right = self.var_pos + np.where(
            self.var_type == VT_DELETION, self.var_len - 1, 0
        ).astype(np.int32)
        # running max of right end, used for overlap scans
        # (ref: gene_var_maxrights, typing_core.py:393-401)
        self.var_maxright = (
            np.maximum.accumulate(self.var_right)
            if len(self.var_pos)
            else np.zeros(0, np.int32)
        )

    # ------------------------------------------------------------------ #
    @property
    def n_vars(self) -> int:
        return len(self.var_ids)

    @property
    def n_alleles(self) -> int:
        return len(self.allele_names)

    def var_index(self, var_id: str) -> int:
        return self._id2idx[var_id]

    def allele_index(self, name: str) -> int:
        return self._allele_idx[name]

    def allele_var_indices(self, name: str) -> np.ndarray:
        """Sorted variant indices belonging to an allele."""
        return np.flatnonzero(self.links[:, self._allele_idx[name]])

    # ------------------------------------------------------------------ #
    def allele_seq(self, name: str) -> str:
        """Reconstruct an allele's sequence from backbone + its variants.

        Ref: read_Gene_alleles_from_vars (typing_core.py:2199-2237).
        """
        if name == self.backbone_name:
            return self.backbone
        out = []
        cur = 0
        for vi in self.allele_var_indices(name):
            pos = int(self.var_pos[vi])
            vt = int(self.var_type[vi])
            if pos > cur:
                out.append(self.backbone[cur:pos])
                cur = pos
            if vt == VT_SINGLE:
                out.append(self.var_data[vi])
                cur = pos + 1
            elif vt == VT_DELETION:
                cur = pos + int(self.var_len[vi])
            else:  # insertion attaches before backbone[pos]
                out.append(self.var_data[vi])
        out.append(self.backbone[cur:])
        return "".join(out)

    def exclude_alleles(self, names) -> "GeneRef":
        """Panel with the given alleles removed (variant table intact —
        the aligner still knows every catalog variant, as the reference
        keeps its index when excluding alleles for novel-allele
        experiments, etc/hisatgenotype_hla_cyp.py:552,1154)."""
        drop = set(names)
        keep = [i for i, a in enumerate(self.allele_names)
                if a not in drop]
        return dataclasses.replace(
            self,
            allele_names=[self.allele_names[i] for i in keep],
            links=self.links[:, keep],
            partial={a for a in self.partial if a not in drop})

    def allele_lengths(self) -> dict:
        """Allele sequence lengths, vectorized from the link matrix:
        len(backbone) + sum(insertion lens) - sum(deletion lens)."""
        if getattr(self, "_lengths", None) is None:
            delta = np.where(
                self.var_type == VT_INSERTION, self.var_len,
                np.where(self.var_type == VT_DELETION, -self.var_len, 0),
            ).astype(np.int64)
            lens = len(self.backbone) + delta @ self.links
            self._lengths = {name: int(lens[i])
                             for i, name in enumerate(self.allele_names)}
            self._lengths[self.backbone_name] = len(self.backbone)
        return self._lengths

    # ------------------------------------------------------------------ #
    def exonic_var_mask(self, exons) -> np.ndarray:
        """Boolean mask of variants fully inside any of `exons`.

        Ref: get_exonic_vars (typing_core.py:67-78).
        """
        mask = np.zeros(self.n_vars, dtype=bool)
        for left, right in exons:
            mask |= (self.var_pos >= left) & (self.var_right <= right)
        return mask


@dataclasses.dataclass
class Catalog:
    """A family database: a set of genes plus family-level metadata."""

    family: str                    # "hla", "cyp", "codis", ...
    genes: dict                    # gene -> GeneRef
    version: str = "NONE"

    def gene(self, g: str) -> GeneRef:
        return self.genes[g]


# ---------------------------------------------------------------------- #
# Text export / import in the exact reference formats, for parity checks
# (formats documented at typing_common.py:277-403 and written at
#  typing_process.py:1001-1255).
# ---------------------------------------------------------------------- #
def export_text(cat: Catalog, out_prefix: str) -> None:
    import os

    os.makedirs(os.path.dirname(out_prefix) or ".", exist_ok=True)
    bb = open(out_prefix + "_backbone.fa", "w")
    seqf = open(out_prefix + "_sequences.fa", "w")
    snp = open(out_prefix + ".snp", "w")
    isnp = open(out_prefix + ".index.snp", "w")
    freq = open(out_prefix + ".snp.freq", "w")
    link = open(out_prefix + ".link", "w")
    hap = open(out_prefix + ".haplotype", "w")
    locus = open(out_prefix + ".locus", "w")
    allelef = open(out_prefix + ".allele", "w")
    partialf = open(out_prefix + ".partial", "w")
    nh = 0
    for g in cat.genes.values():
        print(">%s" % g.backbone_name, file=bb)
        for s in range(0, len(g.backbone), 60):
            print(g.backbone[s:s + 60], file=bb)
        exon_str = ",".join(
            "%d-%d%s" % (l, r, "p" if (l, r) in [tuple(e) for e in g.primary_exons] else "")
            for l, r in g.exons
        )
        print(
            "%s\t%s\t%d\t%d\t%d\t%s\t%s"
            % (g.backbone_name, g.chrom, g.chrom_left, g.chrom_right,
               len(g.backbone), exon_str, g.strand),
            file=locus,
        )
        for i, vid in enumerate(g.var_ids):
            line = "%s\t%s\t%s\t%d\t%s" % (
                vid, _VT_NAME[int(g.var_type[i])], g.backbone_name,
                int(g.var_pos[i]), g.var_data[i],
            )
            print(line, file=snp)
            if g.var_freq[i] >= g.min_var_freq:
                print(line, file=isnp)
            print("%s\t%.2f" % (vid, g.var_freq[i]), file=freq)
            members = [g.allele_names[a] for a in np.flatnonzero(g.links[i])]
            print("%s\t%s" % (vid, " ".join(sorted(members))), file=link)
        for left, right, vidxs in g.haplotypes:
            print(
                "ht%d\t%s\t%d\t%d\t%s"
                % (nh, g.backbone_name, left, right,
                   ",".join(g.var_ids[v] for v in vidxs)),
                file=hap,
            )
            nh += 1
        for name in g.allele_names:
            print(">%s" % name, file=seqf)
            s = g.allele_seq(name)
            for i in range(0, len(s), 60):
                print(s[i:i + 60], file=seqf)
            print(name, file=allelef)
            if name in g.partial:
                print(name, file=partialf)
    for f in (bb, seqf, snp, isnp, freq, link, hap, locus, allelef, partialf):
        f.close()


def import_text(family: str, prefix: str) -> Catalog:
    """Load a reference-format database directory into a Catalog."""
    import os
    from collections import defaultdict

    # backbone sequences
    backbones = _read_fasta(prefix + "_backbone.fa")
    # locus
    loci = {}
    for line in open(prefix + ".locus"):
        name, chrom, left, right, _blen, exon_str, strand = line.split()
        gene = name.split("*")[0]
        exons, primary = [], []
        for ex in exon_str.split(","):
            p = ex.endswith("p")
            if p:
                ex = ex[:-1]
            l, r = map(int, ex.split("-"))
            exons.append((l, r))
            if p:
                primary.append((l, r))
        loci[gene] = (name, chrom, int(left), int(right), exons, primary, strand)
    # variants per gene
    pergene = defaultdict(lambda: {"ids": [], "type": [], "pos": [], "data": []})
    for line in open(prefix + ".snp"):
        vid, vt, name, pos, data = line.rstrip("\n").split("\t")
        gene = name.split("*")[0]
        d = pergene[gene]
        d["ids"].append(vid)
        d["type"].append(_VT_CODE[vt])
        d["pos"].append(int(pos))
        d["data"].append(data)
    freqs = {}
    if os.path.exists(prefix + ".snp.freq"):
        for line in open(prefix + ".snp.freq"):
            vid, f = line.split()
            freqs[vid] = float(f)
    links_raw = {}
    for line in open(prefix + ".link"):
        parts = line.split()
        links_raw[parts[0]] = parts[1:]
    alleles_by_gene = defaultdict(list)
    for line in open(prefix + ".allele"):
        name = line.strip()
        alleles_by_gene[name.split("*")[0]].append(name)
    partial = set()
    if os.path.exists(prefix + ".partial"):
        partial = {l.strip() for l in open(prefix + ".partial")}
    haps_by_gene = defaultdict(list)
    if os.path.exists(prefix + ".haplotype"):
        for line in open(prefix + ".haplotype"):
            _hid, name, left, right, vids = line.split()
            haps_by_gene[name.split("*")[0]].append(
                (int(left), int(right), vids.split(","))
            )

    genes = {}
    for gene, (bname, chrom, left, right, exons, primary, strand) in loci.items():
        d = pergene[gene]
        names = alleles_by_gene[gene]
        aidx = {a: i for i, a in enumerate(names)}
        V = len(d["ids"])
        links = np.zeros((V, len(names)), dtype=bool)
        for i, vid in enumerate(d["ids"]):
            for a in links_raw.get(vid, []):
                if a in aidx:
                    links[i, aidx[a]] = True
        vtype = np.array(d["type"], dtype=np.int8)
        vlen = np.array(
            [int(dd) if t == VT_DELETION else len(dd)
             for dd, t in zip(d["data"], d["type"])],
            dtype=np.int32,
        )
        id2i = {v: i for i, v in enumerate(d["ids"])}
        genes[gene] = GeneRef(
            gene=gene,
            backbone_name=bname,
            backbone=backbones[bname],
            allele_names=names,
            var_ids=d["ids"],
            var_type=vtype,
            var_pos=np.array(d["pos"], dtype=np.int32),
            var_len=vlen,
            var_data=d["data"],
            var_freq=np.array([freqs.get(v, 100.0) for v in d["ids"]],
                              dtype=np.float32),
            links=links,
            exons=exons,
            primary_exons=primary,
            haplotypes=[(l, r, [id2i[v] for v in vs])
                        for l, r, vs in haps_by_gene[gene]],
            partial=partial & set(names),
            chrom=chrom,
            chrom_left=left,
            chrom_right=right,
            strand=strand,
        )
    return Catalog(family=family, genes=genes)


def save_npz(cat: Catalog, path: str) -> None:
    """Single packed binary artifact (SURVEY.md §7 layer 1): all genes'
    arrays in one npz, loadable straight into device memory."""
    import io as _io
    import json

    blobs = {}
    meta = {"family": cat.family, "version": cat.version, "genes": {}}
    for g, ref in cat.genes.items():
        meta["genes"][g] = {
            "backbone_name": ref.backbone_name,
            "backbone": ref.backbone,
            "allele_names": ref.allele_names,
            "var_ids": ref.var_ids,
            "var_data": ref.var_data,
            "exons": [list(e) for e in ref.exons],
            "primary_exons": [list(e) for e in ref.primary_exons],
            "haplotypes": [[l, r, list(v)] for l, r, v in ref.haplotypes],
            "partial": sorted(ref.partial),
            "chrom": ref.chrom,
            "chrom_left": ref.chrom_left,
            "chrom_right": ref.chrom_right,
            "strand": ref.strand,
            "min_var_freq": ref.min_var_freq,
        }
        blobs["%s/var_type" % g] = ref.var_type
        blobs["%s/var_pos" % g] = ref.var_pos
        blobs["%s/var_len" % g] = ref.var_len
        blobs["%s/var_freq" % g] = ref.var_freq
        blobs["%s/links" % g] = np.packbits(ref.links, axis=1)
    blobs["__meta__"] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8)
    np.savez_compressed(path, **blobs)


def load_npz(path: str) -> Catalog:
    import json

    z = np.load(path)
    meta = json.loads(bytes(z["__meta__"]).decode())
    genes = {}
    for g, m in meta["genes"].items():
        A = len(m["allele_names"])
        links = np.unpackbits(z["%s/links" % g], axis=1)[:, :A].astype(bool)
        genes[g] = GeneRef(
            gene=g,
            backbone_name=m["backbone_name"],
            backbone=m["backbone"],
            allele_names=m["allele_names"],
            var_ids=m["var_ids"],
            var_type=z["%s/var_type" % g],
            var_pos=z["%s/var_pos" % g],
            var_len=z["%s/var_len" % g],
            var_data=m["var_data"],
            var_freq=z["%s/var_freq" % g],
            links=links,
            exons=[tuple(e) for e in m["exons"]],
            primary_exons=[tuple(e) for e in m["primary_exons"]],
            haplotypes=[(l, r, list(v)) for l, r, v in m["haplotypes"]],
            partial=set(m["partial"]),
            chrom=m["chrom"],
            chrom_left=m["chrom_left"],
            chrom_right=m["chrom_right"],
            strand=m["strand"],
            min_var_freq=m["min_var_freq"],
        )
    return Catalog(family=meta["family"], genes=genes,
                   version=meta["version"])


def _read_fasta(path: str) -> dict:
    seqs = {}
    name = None
    parts = []
    for line in open(path):
        line = line.strip()
        if line.startswith(">"):
            if name is not None:
                seqs[name] = "".join(parts)
            name = line[1:].split()[0]
            parts = []
        else:
            parts.append(line)
    if name is not None:
        seqs[name] = "".join(parts)
    return seqs
