"""Multi-host scaffolding: `jax.distributed` init + cross-host read-shard
distribution.

The reference scales across hosts by running independent processes over
manually-striped sample lists (`--job-range`, hisatgenotype_args.py:235)
and merging text output.  The device-native equivalent: every host joins one
`jax.distributed` job, loads only its contiguous shard of the global read
set (the host-side distribution — reads never cross hosts), contributes it
to a global array over the full-slice mesh, and the same shard_map typing
program (`parallel.e2e.ShardedTyper`) runs unchanged — per-allele
evidence and EM numerators ride the interconnect through the `psum`s already in
the program.

Validated structurally by tests/test_multihost.py: 2 processes x 4
virtual CPU devices call the same genotype as single-process, bit-equal.
"""
from __future__ import annotations

import os

import numpy as np


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None):
    """Join (or start) the distributed job.  Arguments fall back to
    HGTPU_COORDINATOR / HGTPU_NUM_PROCESSES / HGTPU_PROCESS_ID, then to
    jax's own auto-detection (cluster environment variables)."""
    import jax

    coordinator_address = coordinator_address or \
        os.environ.get("HGTPU_COORDINATOR")
    if num_processes is None and "HGTPU_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["HGTPU_NUM_PROCESSES"])
    if process_id is None and "HGTPU_PROCESS_ID" in os.environ:
        process_id = int(os.environ["HGTPU_PROCESS_ID"])
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)
    return jax.process_index(), jax.process_count()


def global_mesh(axis: str = "dp"):
    """1-D mesh over every device of every process."""
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()), (axis,))


def process_read_shard(n_total: int, process_index=None,
                       process_count=None):
    """[start, stop) of this process's contiguous block of the global
    read set.  n_total must divide evenly (pad first — the typing weights
    zero out pad reads)."""
    import jax

    pi = jax.process_index() if process_index is None else process_index
    pc = jax.process_count() if process_count is None else process_count
    assert n_total % pc == 0, \
        "pad the global read count to a multiple of %d" % pc
    per = n_total // pc
    return pi * per, (pi + 1) * per


def pad_reads(codes: np.ndarray, multiple: int):
    """Pad read codes with all-N rows up to `multiple` (pad reads carry
    zero weight through the verify gate)."""
    n = codes.shape[0]
    extra = (-n) % multiple
    if extra:
        codes = np.concatenate(
            [codes, np.full((extra, codes.shape[1]), 4, np.int8)])
    return codes


def distributed_call(typer, local_codes: np.ndarray):
    """Run a `ShardedTyper` device-EM step with this process
    contributing only its local read shard; returns the replicated
    (prob, totals, n_used, punt_local).  punt_local is THIS process's
    slice of the punt mask — the caller must rescue those reads (the
    production path `type_reads_device_distributed` does all of this,
    losslessly; this entry is the bare device-EM building block)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    axis = typer.mesh.axis_names[0]
    sharding = NamedSharding(typer.mesh, P(axis))
    global_codes = jax.make_array_from_process_local_data(
        sharding, np.ascontiguousarray(local_codes))
    return typer.count_em_global(global_codes)


# ------------------------------------------------------------------------- #
# lossless multi-host production typing
# ------------------------------------------------------------------------- #
def _gather_parts(arr):
    """Allgather a variable-leading-length array across processes:
    returns one trimmed array per process.  (process_allgather needs
    equal shapes, so lengths travel first and rows pad to the max.)"""
    import numpy as np
    from jax.experimental import multihost_utils

    arr = np.asarray(arr)
    lens = multihost_utils.process_allgather(
        np.array([arr.shape[0]], np.int64))
    lens = np.asarray(lens).reshape(-1)
    mx = max(int(lens.max()), 1)
    buf = np.zeros((mx,) + arr.shape[1:], arr.dtype)
    buf[:arr.shape[0]] = arr
    out = np.asarray(multihost_utils.process_allgather(buf))
    return [out[p, :int(lens[p])] for p in range(out.shape[0])]


def _allsum(arr):
    import numpy as np
    from jax.experimental import multihost_utils

    out = np.asarray(multihost_utils.process_allgather(np.asarray(arr)))
    return out.sum(axis=0)


def type_reads_device_distributed(gene, reads_1, reads_2=None, opts=None,
                                  global_start: int = 0,
                                  n_global: int = None, mesh=None):
    """Lossless multi-host production typing (the reference's merge
    semantics, hisatgenotype:613-665, with device programs).

    Each process passes ONLY its local shard of the global read set
    (`reads_*`; `global_start` = the shard's offset, `n_global` = total
    reads across processes).  The process types its shard on its LOCAL
    mesh — placement, tiered spelling, gate, counting — and three small
    host-level merges ride jax.distributed collectives:

      1. the device pileups sum across processes, and each process's
         excluded pairs' host alignments merge in, so EVERY gate
         decision on every process uses the same host-full pileup;
      2. the packed class rows + totals allgather and accumulate in
         global first-seen read order;
      3. each process rescues ITS punt mask (never dropped) and exports
         per-fragment count rows, merged in global sorted-read-id
         order.

    Every process therefore computes a result identical to a
    single-process `type_reads_device` over the concatenated reads —
    including num_reads / num_pairs and the cmpt dicts — and the staged
    EM runs replicated on the merged classes."""
    import numpy as np

    from ..typer.counting import StatAccumulator
    from ..typer.engine import GeneTypingResult, TypingOptions
    from ..typer.mpileup import Mpileup
    from ..typer.staging import staged_abundance
    from ..utils.trace import TRACE
    from .production import (_align_punts, _rescued_fragment_rows,
                             _shared_sharded_typer, default_mesh)
    from .. import enable_compilation_cache

    import jax
    from jax.sharding import Mesh

    enable_compilation_cache()
    opts = opts or TypingOptions()
    if mesh is None:
        # the device programs run on THIS process's local devices; the
        # cross-process merges ride the host-level collectives above
        mesh = Mesh(np.array(jax.local_devices()), ("dp",))
    from jax.experimental import multihost_utils

    seqs_1 = [s for _, s in reads_1]
    seqs_2 = [s for _, s in (reads_2 or [])]
    max_len = max((len(s) for s in seqs_1 + seqs_2), default=100)
    # every process must compile the same read_len program
    max_len = int(np.asarray(multihost_utils.process_allgather(
        np.array([max_len], np.int64))).max())
    read_len = max(100, ((max_len + 9) // 10) * 10)
    st = _shared_sharded_typer(gene, opts, mesh, read_len)
    c1 = st.encode(seqs_1)
    c2 = st.encode(seqs_2) if reads_2 is not None else None

    holder = {}

    def _merge_cb(pile_dev_local, excl_mask, winner):
        # 1. global device pileup
        gp = _allsum(pile_dev_local.astype(np.int64))
        # 2. local excluded pairs' host alignments -> local delta
        idx = np.flatnonzero(excl_mask)
        bp = _align_punts(gene, opts, reads_1, reads_2, idx, winner)
        mp0 = Mpileup(gene)
        bulk = []
        from ..typer.engine import _concordant
        for i in idx:
            alns = bp.get(int(i))
            if alns:
                conc = _concordant(alns, opts)
                if conc is not None:
                    bulk.extend(conc)
        mp0.add_alignments_bulk(bulk)
        delta = _allsum(mp0.counts.astype(np.int64))
        final = (gp + delta).astype(np.int32)
        mp = Mpileup(gene)
        mp.counts = np.ascontiguousarray(final)
        mp.finalize()
        holder["by_pair"] = bp
        holder["mpileup"] = mp
        holder["excl_idx"] = idx
        return final

    def _overlap_cb():
        # process-local rescue prep (GeneTyper build + fast-path memo
        # prefill over the excl pairs) runs while the count pass
        # executes on device — same overlap as the single-process path
        from .production import _prepare_rescue

        holder["pre"] = _prepare_rescue(
            gene, opts, reads_1, holder["by_pair"],
            holder["excl_idx"], holder["mpileup"])

    out = st.count_classes(c1, c2, merge_pileup=_merge_cb,
                           overlap=_overlap_cb)
    by_pair = holder["by_pair"]
    mpileup = holder["mpileup"]

    # 2. merge packed class rows in global first-seen read order
    full_stats = StatAccumulator(gene.allele_names)
    exon_stats = None
    primary_stats = None
    accs = {"full": full_stats}
    if "exon" in out["levels"]:
        exon_stats = StatAccumulator(gene.allele_names, st._rep_mask_np)
        accs["exon"] = exon_stats
    if "primary" in out["levels"]:
        primary_stats = StatAccumulator(gene.allele_names,
                                        st._primary_mask_np)
        accs["primary"] = primary_stats
    for name, acc in accs.items():
        rows, uws, totals = out["levels"][name]
        keys = out["order"][name] + global_start
        rows_all = _gather_parts(rows.astype(np.uint32))
        uws_all = _gather_parts(uws.astype(np.int64))
        keys_all = _gather_parts(keys.astype(np.int64))
        rows_g = np.concatenate(rows_all)
        uws_g = np.concatenate(uws_all)
        keys_g = np.concatenate(keys_all)
        order = np.argsort(keys_g, kind="stable")
        totals_g = _allsum(np.asarray(totals, np.int64))
        acc.add_packed_batch(rows_g[order], uws_g[order], totals_g)

    n_reads = int(_allsum(np.array([out["n_reads"]], np.int64))[0])
    n_pairs = int(_allsum(np.array([out["n_pairs"]], np.int64))[0])

    # 3. local punt rescue -> per-fragment rows -> global merge
    punt_idx = np.flatnonzero(out["punt"])
    extra = punt_idx[~out["excl"][punt_idx]]
    if len(extra):
        by_pair.update(_align_punts(gene, opts, reads_1, reads_2,
                                    extra, out["winner"]))
    keys, rf, re_, rp, r_reads, novel = _rescued_fragment_rows(
        gene, opts, reads_1, by_pair, punt_idx, mpileup,
        pre=holder.get("pre"))
    kw = _gather_parts(keys.astype(np.uint8))
    kl = max(k.shape[1] if k.size else 0 for k in kw)
    kpad = [np.pad(k, ((0, 0), (0, kl - k.shape[1])))
            if k.size else np.zeros((len(k), kl), np.uint8) for k in kw]
    keys_g = np.concatenate([k for k in kpad]) if kl else \
        np.zeros((0, 0), np.uint8)
    rf_g = np.concatenate(_gather_parts(rf))
    re_g = np.concatenate(_gather_parts(re_))
    rp_g = np.concatenate(_gather_parts(rp))
    if len(keys_g):
        order = np.lexsort(keys_g.T[::-1])
        w1 = np.ones(len(order), np.int64)
        full_stats.add_reads_batch(rf_g[order], w1)
        if exon_stats is not None:
            exon_stats.add_reads_batch(re_g[order], w1)
        if primary_stats is not None:
            primary_stats.add_reads_batch(rp_g[order], w1)
    n_reads += int(_allsum(np.array([r_reads], np.int64))[0])
    n_pairs += len(keys_g)

    # merge novel-variant provenance across processes (report parity)
    import pickle

    blob = np.frombuffer(pickle.dumps(dict(novel.meta)), np.uint8)
    novel_meta = {}
    for part in _gather_parts(blob):
        novel_meta.update(pickle.loads(part.tobytes()))

    full_cmpt = full_stats.cmpt_names()
    exon_cmpt = exon_stats.cmpt_names() if exon_stats else {}
    primary_cmpt = primary_stats.cmpt_names() if primary_stats else {}
    prob = staged_abundance(gene, opts, full_cmpt, exon_cmpt,
                            primary_cmpt,
                            getattr(st, "_rep_groups", {}),
                            getattr(st, "_primary_groups", {}),
                            gene.allele_lengths())
    return GeneTypingResult(
        gene=gene.gene,
        num_reads=int(n_reads),
        num_pairs=int(n_pairs),
        counts=full_stats.ranked_counts(),
        prob=prob,
        cmpt=full_cmpt,
        exon_cmpt=exon_cmpt,
        primary_exon_cmpt=primary_cmpt,
        novel_vars=novel_meta,
    )
