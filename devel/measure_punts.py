"""Punt/excl rates and tier distribution on the bench scale panel
(CPU backend, 8 virtual devices) — evaluates the pair-hypothesis and
tiering payoff without an accelerator."""
import os
import sys
import time

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")
sys.path.insert(0, ".")
sys.path.insert(0, "tests")
import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np

from synth import make_hla_scale_msa, make_gene_msa
from hgtpu.db import build_gene_ref
from hgtpu.sim import simulate_reads
from hgtpu.parallel.e2e import ShardedTyper
from hgtpu.parallel.sharded import make_mesh

which = sys.argv[1] if len(sys.argv) > 1 else "scale"
if which == "scale":
    spec = make_hla_scale_msa(n_alleles=3600, length=3500)
else:
    spec = make_gene_msa(seed=0, n_alleles=60, length=3000)
ref, _ = build_gene_ref("A", spec["names"], spec["rows"],
                        spec["ref_allele"],
                        exons_ref_coords=spec.get("exons"),
                        min_var_freq=0.1)
truths = [ref.allele_names[123 % ref.n_alleles],
          ref.allele_names[2047 % ref.n_alleles]]
r1, r2, _ = simulate_reads(ref, truths, simulate_interval=1, seed=1)
print(f"{which}: {ref.n_alleles} alleles, {len(r1)} pairs")

st = ShardedTyper(ref, make_mesh(8))
c1 = st.encode([r.seq for r in r1])
c2 = st.encode([r.seq for r in r2])
t0 = time.perf_counter()
out = st.count_classes(c1, c2)
dt = time.perf_counter() - t0
n = len(r1)
punt = out["punt"].sum()
excl = out["excl"].sum()
print(f"punt {punt}/{n} = {punt/n:.3%}  excl {excl}/{n} = {excl/n:.3%}"
      f"  (wall {dt:.1f}s cpu)")
causes = np.zeros(4, np.int64)
for mi in range(2):
    cz = out["winner"][mi]["causes"][out["punt"]]
    for b in range(4):
        causes[b] += int(((cz >> b) & 1).sum())
print("punt mate-causes [amb, trim, tie, trunc]:", causes.tolist())
t1 = out["winner"][0]["tier1"][out["punt"]].sum() \
    + out["winner"][1]["tier1"][out["punt"]].sum()
print(f"tier1-certified punt mates: {t1} / {2*punt}")

# tier distribution (wide candidate window, per mate)
from hgtpu.db.catalog import VT_DELETION, VT_INSERTION
idx = np.flatnonzero((ref.var_type == VT_DELETION)
                     | (ref.var_type == VT_INSERTION))
pos = np.sort(ref.var_pos[idx])
ms = int(ref.var_len[idx].max()) if len(idx) else 0
W = 100
# approximate s0 by truth positions: uniform over backbone
P = len(ref.backbone)
s = np.arange(P - W)
lo = np.searchsorted(pos, s - 2 * ms)
hi = np.searchsorted(pos, s + W + ms, side="right")
cnt = hi - lo
frac0 = (cnt == 0).mean()
frac1 = (cnt == 1).mean()
print(f"indels={len(idx)} max_shift={ms}; window cand count: "
      f"0:{frac0:.2%} 1:{frac1:.2%} 2+:{1-frac0-frac1:.2%}")

# punted-read truth anatomy: how many catalog indels does each punted
# mate's TRUTH spelling cross, and which punt cause fired?
from hgtpu.sim import parse_truth_name
from collections import Counter

vt = ref.var_type
anat = Counter()
for mi, reads in enumerate((r1, r2)):
    cz = out["winner"][mi]["causes"]
    for i in np.flatnonzero(out["punt"]):
        t = parse_truth_name(reads[i].name)
        nind = sum(1 for v in t["vars"]
                   if v.startswith(("del", "ins", "D", "I"))
                   or "D" in t["cigar"] or "I" in t["cigar"])
        cig = t["cigar"]
        nd = cig.count("D") + cig.count("I")
        cause = int(cz[i])
        anat[(nd, cause)] += 1
for (nd, cause), c in sorted(anat.items()):
    tags = [t for b, t in enumerate(("amb", "trim", "tie", "trunc"))
            if (cause >> b) & 1] or ["none"]
    print(f"  truth_indel_ops={nd} cause={'+'.join(tags)}: {c}")
