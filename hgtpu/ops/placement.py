"""Diagonal placement of read batches on the backbone — alignment as
convolution as one matrix product.

The reference delegates placement to the HISAT2 graph FM index (invoked at
typing_common.py:995-1036).  The device-native formulation: one-hot encode the
read batch and correlate it against a variant-aware position-weight matrix
of the backbone (1.0 where a base matches the backbone *or* a known SNP
variant).  The correlation over all diagonals is a single convolution that
XLA lowers onto a matmul; `top_k` then yields candidate start diagonals per
read.  Known SNPs therefore never cost placement score, mirroring the
graph aligner's behavior of not charging known variants to NM.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..db.catalog import GeneRef, VT_SINGLE


def backbone_pwm(gene: GeneRef) -> np.ndarray:
    """[P, 5] float: 1 where base matches backbone or a known single-nt
    variant at that position; N (code 4) scores 0 everywhere."""
    P = len(gene.backbone)
    pwm = np.zeros((P, 5), dtype=np.float32)
    pwm[np.arange(P), gene.backbone_enc] = 1.0
    singles = gene.var_type == VT_SINGLE
    for vi in np.flatnonzero(singles):
        base = "ACGT".index(gene.var_data[vi])
        pwm[int(gene.var_pos[vi]), base] = 1.0
    pwm[:, 4] = 0.0
    return pwm


def encode_reads(seqs, read_len: int) -> np.ndarray:
    """Pad/truncate reads to read_len; returns int8 [N, read_len] codes
    (pad code 4 = N, which scores 0).

    One table lookup over the joined byte buffer plus one fancy scatter —
    no per-read Python."""
    from ..utils.dna import _ENC

    n = len(seqs)
    out = np.full((n, read_len), 4, dtype=np.int8)
    if n == 0:
        return out
    clipped = [s[:read_len] for s in seqs]
    lens = np.fromiter((len(s) for s in clipped), np.int64, n)
    flat = _ENC[np.frombuffer("".join(clipped).encode("ascii"), np.uint8)]
    L0 = int(lens[0])
    if int(lens.min()) == L0 == int(lens.max()):
        # uniform-length batch (the common case): one reshape instead
        # of the ragged fancy scatter
        out[:, :L0] = flat.reshape(n, L0)
        return out
    tot = int(lens.sum())
    rows = np.repeat(np.arange(n, dtype=np.int64), lens)
    cols = np.arange(tot, dtype=np.int64) \
        - np.repeat(np.cumsum(lens) - lens, lens)
    out[rows, cols] = flat
    return out


def correlate_scores(pwm_ext, reads):
    """All-diagonal placement scores [N, P+1].

    Lowered as an im2col matmul — reads one-hot [N, m*5] against backbone
    windows [P+1, m*5] — which XLA hands to its GEMM library (the
    equivalent conv formulation lowers poorly for wide filters).  Exact:
    0/1 bf16 operands, integer sums <= m accumulated in f32.
    """
    n, m = reads.shape
    P1 = pwm_ext.shape[0] - m + 1
    onehot = jax.nn.one_hot(reads, 5, dtype=jnp.bfloat16)        # [N, m, 5]
    lhs = onehot.reshape(n, m * 5)
    # windows[p, j, b] = pwm_ext[p + j, b]
    idx = jnp.arange(P1)[:, None] + jnp.arange(m)[None, :]
    windows = pwm_ext.astype(jnp.bfloat16)[idx].reshape(P1, m * 5)
    # materialize both operands before the product: with the one-hot and
    # window producers fused into it, XLA's Triton GEMM emitter for the
    # H100 (sm_90a) aborts the process ("Dimensions must match" in its
    # layout pass, jax 0.9.0)
    lhs, windows = jax.lax.optimization_barrier((lhs, windows))
    return jnp.dot(lhs, windows.T,
                   preferred_element_type=jnp.float32)            # [N, P1]


@functools.partial(jax.jit, static_argnames=("top_k",))
def place_batch(pwm_ext: jax.Array, reads: jax.Array, top_k: int = 4):
    """Score every start diagonal for every read.

    pwm_ext: [P + m, 5] backbone PWM padded with m zero rows.
    reads:   [N, m] int8 codes.
    Returns (scores [N, top_k], positions [N, top_k]).
    """
    top_scores, top_pos = jax.lax.top_k(correlate_scores(pwm_ext, reads),
                                        top_k)
    return top_scores, top_pos


def _fetch_dtype(pwm_ext, m):
    """int16 when every packed value (scores <= m, window indices < P1,
    read offsets <= m) fits; int32 for very long backbones."""
    P1 = pwm_ext.shape[0] - m + 1
    return jnp.int16 if max(P1, m) + 2 < 32767 else jnp.int32


@functools.partial(jax.jit, static_argnames=("top_k",))
def place_batch_packed(pwm_ext: jax.Array, reads: jax.Array,
                       top_k: int = 4):
    """place_batch with (scores, positions) packed into ONE integer
    array [N, 2*top_k] — a device->host fetch pays per leaf and per
    byte, so one int16 leaf beats two f32/int32 leaves.
    Scores are exact small integers (sums of 1.0 matches in f32)."""
    n, m = reads.shape
    top_scores, top_pos = jax.lax.top_k(correlate_scores(pwm_ext, reads),
                                        top_k)
    dt = _fetch_dtype(pwm_ext, m)
    return jnp.concatenate([top_scores.astype(dt), top_pos.astype(dt)],
                           axis=1)


@functools.partial(jax.jit, static_argnames=("top_k", "shifts", "k_mm",
                                             "lb_pad"))
def place_scan_batch(pwm_ext: jax.Array, match_flat: jax.Array,
                     bb_pad: jax.Array, reads: jax.Array, lens: jax.Array,
                     top_k: int, shifts: tuple, k_mm: int, lb_pad: int):
    """Placement + the fast-path scan planes, fused in one program.

    On top of place_batch's diagonal scores this computes, per row, on
    the row's TOP-1 diagonal:
      * first/last novel-mismatch read index per shifted diagonal
        (`shifts`, the gene's catalog indel lengths) — exactly the
        planes GeneAligner._fast_indel_batch builds on the host, moved
        onto the device so they ride the placement dispatch/fetch;
      * the first `k_mm` mismatch-vs-backbone read positions and the
        total count on the plain diagonal — what _fast_exact_batch's
        [R, L] compare extracts.

    match_flat: flattened [T * 6] bool free-base table (row-major
      match_ok6: backbone match or catalog SNP), T = P + 2*lb_pad + tail.
    bb_pad:     [T] int8 backbone codes padded like match_ok6 (sentinel 6).
    lens:       [N] int32 real read lengths (pad code 4 scores 0 but the
      planes must ignore bases past the read end).

    Returns ONE packed integer array [N, X] (int16 when the backbone
    fits, see _fetch_dtype) with columns
      [scores(top_k) | top_pos(top_k) | first(S) | last(S)
       | mm_pos(k_mm) | mm_cnt]
    so the fetch pays one leaf, never six.
    """
    n, m = reads.shape
    scores = correlate_scores(pwm_ext, reads)
    top_scores, top_pos = jax.lax.top_k(scores, top_k)

    T = bb_pad.shape[0]
    start = top_pos[:, 0] - m                          # window -> read start
    j = jnp.arange(m, dtype=jnp.int32)
    base = (start[:, None] + lb_pad) + j[None, :]      # [N, m]
    in_len = j[None, :] < lens[:, None]
    codes = reads.astype(jnp.int32)

    firsts, lasts = [], []
    for d in shifts:
        idx = jnp.clip(base + d, 0, T - 1)
        ok = match_flat[idx * 6 + codes]
        mis = ~ok & in_len
        any_ = mis.any(axis=1)
        firsts.append(jnp.where(any_, jnp.argmax(mis, axis=1),
                                lens).astype(jnp.int32))
        lasts.append(jnp.where(any_,
                               m - 1 - jnp.argmax(mis[:, ::-1], axis=1),
                               -1).astype(jnp.int32))
    first = jnp.stack(firsts, axis=1)                  # [N, S]
    last = jnp.stack(lasts, axis=1)                    # [N, S]

    idx0 = jnp.clip(base, 0, T - 1)
    mm = (codes != bb_pad[idx0].astype(jnp.int32)) & in_len
    sentinel = jnp.int32(-(m + 1))
    vals = jnp.where(mm, -j[None, :], sentinel)
    negpos, _ = jax.lax.top_k(vals, k_mm)              # ascending j order
    mm_pos = jnp.where(negpos == sentinel, -1, -negpos)
    mm_cnt = mm.sum(axis=1, dtype=jnp.int32)

    dt = _fetch_dtype(pwm_ext, m)
    # mm_cnt can reach m (< 32767) and every other column is a score,
    # window index, or read offset — all within the packed dtype
    return jnp.concatenate(
        [top_scores.astype(dt), top_pos.astype(dt), first.astype(dt),
         last.astype(dt), mm_pos.astype(dt), mm_cnt[:, None].astype(dt)],
        axis=1)


def place_with_orientation(pwm, fwd: np.ndarray, rc: np.ndarray,
                           top_k: int = 4, block: bool = True,
                           ext_cache=None):
    """Place both orientations.

    With block=True returns (scores_f, pos_f, scores_r, pos_r) each
    [N, top_k] plus use_rc [N].  With block=False returns the device
    (scores, positions) handles without synchronizing — resolve later
    with `resolve_placement` so host work overlaps the device queue.
    `ext_cache` (owned by the caller, keyed by read length) holds the
    zero-padded device PWM — the cache must be per-PWM, never global
    (id()-keyed globals go stale when array ids are recycled).
    """
    m = fwd.shape[1]
    _ext_cache = ext_cache if ext_cache is not None else {}
    key = m
    pwm_ext = _ext_cache.get(key)
    if pwm_ext is None:
        # zero padding on BOTH sides: window index p corresponds to read
        # start p - m, so overhanging (soft-clippable) placements at both
        # backbone ends score their overlapping parts
        pwm_ext = jnp.asarray(
            np.concatenate([np.zeros((m, 5), np.float32), pwm,
                            np.zeros((m, 5), np.float32)], axis=0))
        if len(_ext_cache) > 64:
            _ext_cache.clear()
        _ext_cache[key] = pwm_ext
    both = np.concatenate([fwd, rc], axis=0)
    handles = place_batch(pwm_ext, jnp.asarray(both), top_k=top_k)
    if not block:
        return handles
    return resolve_placement(handles, fwd.shape[0], m)


def resolve_placement(handles, n, m):
    s, p = handles
    s = np.asarray(s)
    p = np.asarray(p) - m   # window index -> read start (may be negative)
    use_rc = s[n:, 0] > s[:n, 0]
    return s[:n], p[:n], s[n:], p[n:], use_rc
