"""Multi-chip sharding of the typing pipeline.

The reference parallelizes with multiprocessing.Pool over samples and
`hisat2 -p N` threads (SURVEY.md §2 parallelism inventory); the device-native
equivalent is data parallelism over reads/haplotypes on a device mesh:

- reads are sharded over the "dp" mesh axis (each chip places its shard
  against the replicated backbone PWM),
- haplotype batches are sharded likewise; each chip computes its
  compatibility masks against the replicated link tables and the
  per-allele evidence is merged with `psum` across devices,
- the EM abundance solver runs replicated on the reduced counts.

Everything compiles under `jit` + `shard_map`, so the same program runs
on 1 chip, an 8-device host, or several hosts (cross-host traffic handled by jax).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

try:                                    # jax >= 0.8 (check_rep renamed)
    from jax import shard_map as _shard_map

    def shard_map(f, mesh, in_specs, out_specs, check_rep=False):
        return _shard_map(f, mesh=mesh, in_specs=in_specs,
                          out_specs=out_specs, check_vma=check_rep)
except ImportError:                     # pragma: no cover - older jax
    from jax.experimental.shard_map import shard_map


def make_mesh(n_devices=None, axis="dp"):
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


from ..ops.placement import correlate_scores as _place_scores


def _em_iterations(M, counts, iters=100):
    # full f32 products: a GPU would otherwise run them in TF32
    hi = jax.lax.Precision.HIGHEST
    Mf = M.astype(jnp.float32)
    p = jnp.dot(Mf.T, counts / jnp.maximum(Mf.sum(axis=1), 1.0),
                precision=hi)
    p = p / jnp.maximum(p.sum(), 1e-30)

    def body(_, p):
        denom = jnp.dot(Mf, p, precision=hi)
        w = jnp.where(denom > 0, counts / jnp.maximum(denom, 1e-30), 0.0)
        p = jnp.dot(Mf.T, w, precision=hi) * p
        return p / jnp.maximum(p.sum(), 1e-30)

    return jax.lax.fori_loop(0, iters, body, p)


def sharded_place(mesh: Mesh, axis: str = "dp", top_k: int = 4):
    """Data-parallel placement: reads sharded, PWM replicated."""

    @functools.partial(shard_map, mesh=mesh,
                       in_specs=(P(), P(axis)), out_specs=(P(axis), P(axis)),
                       check_rep=False)
    def step(pwm_ext, reads):
        scores = _place_scores(pwm_ext, reads)
        s, p = jax.lax.top_k(scores, top_k)
        return s, p

    return jax.jit(step)


def sharded_verify_filter(mesh: Mesh, axis: str = "dp", lb_pad: int = 4):
    """Data-parallel verify-stage proposal filter (device twin of
    GeneAligner._lb_keep): per (read, start) proposal, count read bases
    that match neither backbone nor a catalog SNP on any diagonal within
    the novel-indel budget — a provable lower bound on the proposal's
    novel-edit cost.  Proposals sharded over the mesh; the dilated match
    table replicated.

    step(tbl_dil [R, 6] bool, reads [E, W] int8 (pad code 5),
         starts [E] i32, w_eff [E] i32) -> lb [E] i32 sharded.
    """

    @functools.partial(shard_map, mesh=mesh,
                       in_specs=(P(), P(axis), P(axis), P(axis)),
                       out_specs=P(axis), check_rep=False)
    def step(tbl_dil, reads, starts, w_eff):
        W = reads.shape[1]
        j = jnp.arange(W, dtype=jnp.int32)
        idx = starts[:, None] + j[None, :] + lb_pad
        ok = tbl_dil[idx, reads]
        in_win = j[None, :] < w_eff[:, None]
        return jnp.sum(in_win & ~ok, axis=1, dtype=jnp.int32)

    return jax.jit(step)


def sharded_banded_dp(mesh: Mesh, axis: str = "dp", max_novel: int = 2):
    """Data-parallel banded variant-aware DP (hgtpu.ops.banded_dp):
    proposals sharded over the mesh, gene tables replicated.  Each chip
    computes exact novel-edit costs for its proposal shard — the full
    verify scoring stage on device.

    step(free, del_len, ins_len, ins_seq, pos_over  (replicated tables),
         reads [E, W] i8, lens [E] i32, starts [E] i32  (sharded), P)
    -> (cost [E] i32, overflow [E] bool) sharded.
    """
    from ..ops.banded_dp import _banded_costs

    def make(backbone_len, del_lens=(), ins_lens=()):
        @functools.partial(shard_map, mesh=mesh,
                           in_specs=(P(), P(axis), P(axis), P(axis)),
                           out_specs=(P(axis), P(axis)),
                           check_rep=False)
        def step(tables, reads, lens, starts):
            return _banded_costs(tables, reads, lens, starts,
                                 backbone_len, jnp.int32(max_novel),
                                 del_lens, ins_lens)
        return jax.jit(step)

    return make


def sharded_count(mesh: Mesh, axis: str = "dp"):
    """Data-parallel compatibility counting + psum-reduced allele totals.

    step(links_packed [V+1,W] u32 repl, nd_pos [Vnd] repl,
         nd_prefix [Vnd+1,A] repl, del_pos/del_right [D] repl,
         del_links [D,A] repl, var_pos/var_right [V+1] repl,
         lefts/rights [H] sharded, vars [H,K] sharded,
         class_mask [C,A] repl, class_counts [C] repl)
    -> (masks [H,A] sharded, allele_totals [A] psum-reduced, prob [A])
    """
    from ..typer.device_count import _compat

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(), P(), P(), P(),
                  P(axis), P(axis), P(axis), P(), P()),
        out_specs=(P(axis), P(), P()),
        check_rep=False)
    def step(links_packed, nd_pos, nd_prefix, del_pos, del_right, del_links,
             var_pos, var_right, lefts, rights, vars_, class_mask,
             class_counts):
        masks = _compat(links_packed, nd_pos, nd_prefix, del_pos, del_right,
                        del_links, var_pos, var_right, lefts, rights, vars_)
        totals = jax.lax.psum(
            jnp.sum(masks.astype(jnp.int32), axis=0), axis)   # cross-device reduce
        prob = _em_iterations(class_mask, class_counts)        # replicated
        return masks, totals, prob

    return jax.jit(step)


def sharded_typing_step(mesh: Mesh, axis: str = "dp"):
    """Combined demo step for the multi-chip dry run: placement + verify
    filter + counting + EM, each stage a jitted shard_map program."""
    place = sharded_place(mesh, axis)
    filt = sharded_verify_filter(mesh, axis)
    count = sharded_count(mesh, axis)

    def step(pwm_ext, reads, tbl_dil, starts, w_eff, dc_tables, lefts,
             rights, vars_, class_mask, class_counts):
        top_scores, top_pos = place(pwm_ext, reads)
        lb = filt(tbl_dil, reads, starts, w_eff)
        masks, totals, prob = count(*dc_tables, lefts, rights, vars_,
                                    class_mask, class_counts)
        return top_pos, lb, totals, prob

    return step


def device_tables(dc):
    """Pack a DeviceCounter's tables for sharded_count."""
    return (dc.links_packed, dc.nd_pos, dc.nd_prefix, dc.del_pos,
            dc.del_right, dc.del_links, dc.var_pos_d, dc.var_right_d)
