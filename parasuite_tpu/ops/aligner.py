"""Jittable batch aligner (jnp reference path).

The device-side equivalent of the reference's native aligner stack (upstream
bwa_aln/bwt_match_gap per SURVEY.md §3.2), re-designed for XLA: fixed shapes
everywhere, no data-dependent control flow, integer-only scoring, and every
tie-break identical to oracle/align.py (the parity tests in
tests/test_jnp_aligner.py enforce bit-equality).

Stages (all fused under one jit):
  1. orient      — forward + reverse-complement views of each read
  2. seed        — k-mer lookups in the dense index -> candidate diagonals
  3. select      — per-strand top-C candidates by (votes desc, diag asc)
                   via a 2-key lax.sort (no host round-trip)
  4. extend      — banded glocal affine-gap DP over all (read, candidate)
                   pairs, lax.scan over read positions, band on the minor
                   axis; also tracks the ungapped diagonal score (gapless
                   fast path: CIGAR is "{Lr}M" whenever ug == dp)
  5. finalize    — dedupe by (strand, pos), pick best by
                   (score desc, strand asc, pos asc), X0/X1 counts,
                   integer MAPQ, chromosome-boundary policy, ungapped NM

Every stage is plain jnp/lax left to XLA. A hand-written extension kernel
(Pallas, Triton route) was measured 3.6x faster per device step on an H100
but tied end to end, where the host bounds the pipeline, and was removed;
PERF.md keeps the measurement.

Everything stays in int32: positions (< 2^31 per shard by construction,
ops/device_index.py), scores (|s| <= 64 per base * L <= 100), and sort keys —
no reliance on x64 mode.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from parasuite_tpu.config import AlignConfig
from parasuite_tpu.ops.device_index import DeviceIndex, ScoreParams
from parasuite_tpu.ops.packed_ref import BASES_PER_WORD

NEG = -(1 << 28)
I32MAX = np.iinfo(np.int32).max
_COMP = np.array([3, 2, 1, 0, 4], dtype=np.int32)


class AlignResult(NamedTuple):
    """Per-read alignment outputs (all [B])."""

    mapped: jnp.ndarray      # bool
    strand: jnp.ndarray      # int32 0/1
    pos: jnp.ndarray         # int32 packed start (ungapped key position)
    score: jnp.ndarray       # int32 DP score
    mapq: jnp.ndarray        # int32
    x0: jnp.ndarray          # int32 best-score hit count
    x1: jnp.ndarray          # int32 suboptimal hit count
    ug_equal: jnp.ndarray    # bool: gapless fast path valid
    nm: jnp.ndarray          # int32 ungapped edit distance (valid iff ug_equal)
    diag: jnp.ndarray        # int32 winning candidate diagonal (for traceback)
    n_candidates: jnp.ndarray  # int32 candidates extended (stats/logging)
    tc_count: jnp.ndarray    # int32 machine-frame T->C conversions (valid iff
                             # ug_equal; gapped winners recount on host via
                             # the CIGAR walk — pipeline.align.to_host)


# ---------------------------------------------------------------------------
# stage 1: orientation
# ---------------------------------------------------------------------------

_COMP_XOR = sum(3 << (3 * g) for g in range(10))   # 0b011 per 3-bit group
_NFILL = sum(7 << (3 * g) for g in range(10))      # all-groups-7 (N sentinel)
_WMASK = (1 << 30) - 1


def orient_reads(codes: jnp.ndarray, lengths: jnp.ndarray) -> jnp.ndarray:
    """[B, L] machine-frame codes -> [B, 2, L] (forward, revcomp) views.

    Revcomp rows are N-padded past each read's true length, mirroring how
    ReadBatch pads forward rows.

    The variable-length reversal rc[i] = comp(fwd[len-1-i]) is computed
    entirely in 3-bit-packed registers: pack 10 bases/int32 word, complement
    by XOR 0b011 per group (maps ACGT correctly; N 100->111, fixed at
    unpack), reverse groups with static shifts, then shift left by
    (Lp - len) bases with a per-read VARIABLE funnel shift (vector shift
    amounts are elementwise). This formulation is pure integer ALU work on
    [B, L/10] words, with no element gather.
    """
    c32 = codes.astype(jnp.int32)
    B, L = codes.shape
    nw = (L + BASES_PER_WORD - 1) // BASES_PER_WORD
    Lp = nw * BASES_PER_WORD
    i = jnp.arange(L)

    cp = jnp.pad(c32, ((0, 0), (0, Lp - L)), constant_values=4)
    shifts3 = (jnp.arange(BASES_PER_WORD, dtype=jnp.int32) * 3)
    words = jnp.sum(cp.reshape(B, nw, BASES_PER_WORD) << shifts3[None, None],
                    axis=2)                                   # [B, nw]
    cw = words ^ _COMP_XOR
    rw = jnp.zeros_like(cw)
    for g in range(BASES_PER_WORD):                           # group reverse
        rw = rw | (((cw >> (3 * g)) & 7) << (3 * (9 - g)))
    rev = rw[:, ::-1]                                         # packed, base
    #                                      rev_codes[j] = comp(cp[Lp-1-j])
    # rc[i] = rev_codes[t + i] with t = Lp - len: variable funnel shift
    t = Lp - lengths
    tq = t // BASES_PER_WORD                                  # [B] word part
    tr = (t - tq * BASES_PER_WORD) * 3                        # [B] bit part
    nfill = jnp.full((B,), _NFILL, dtype=jnp.int32)
    out_cols = []
    for w in range(nw):
        a = nfill
        b = nfill
        for q in range(nw + 1):
            if w + q < nw:
                a = jnp.where(tq == q, rev[:, w + q], a)
            if w + q + 1 < nw:
                b = jnp.where(tq == q, rev[:, w + q + 1], b)
        out_cols.append(((a >> tr) | (b << (30 - tr))) & _WMASK)
    ow = jnp.stack(out_cols, axis=1)                          # [B, nw]
    exp = jnp.repeat(ow, BASES_PER_WORD, axis=1)[:, :L]       # static repeat
    u = (exp >> ((i % BASES_PER_WORD) * 3)[None, :]) & 7
    rc = jnp.where(i[None, :] < lengths[:, None], jnp.minimum(u, 4), 4)
    return jnp.stack([c32, rc], axis=1)


# ---------------------------------------------------------------------------
# stages 2-3: seeding + candidate selection
# ---------------------------------------------------------------------------

def seed_diagonals(oriented: jnp.ndarray, lengths: jnp.ndarray,
                   didx: DeviceIndex, cfg: AlignConfig) -> jnp.ndarray:
    """[B, 2, L] -> candidate diagonals [B*2, max_seeds*max_occ] (I32MAX =
    invalid). Seeds at offsets s * seed_stride_for(len) — per-READ adaptive
    spread by default, so 36bp and 100bp reads place their max_seeds
    windows across the whole read (oracle.seed_candidates semantics);
    k-mers containing N, absent from the index, or with more than max_occ
    occurrences are skipped (repeat policy)."""
    B = oriented.shape[0]
    L = oriented.shape[2]
    k, S, M = cfg.kmer_size, cfg.max_seeds, cfg.max_occ
    reads2 = oriented.reshape(B * 2, L)
    len2 = jnp.repeat(lengths, 2)
    pow4 = jnp.asarray((4 ** np.arange(k - 1, -1, -1)).astype(np.int32))
    j = jnp.arange(M)

    adaptive = cfg.seed_placement == "adaptive" and S > 1
    if adaptive:
        stride2 = jnp.maximum(1, (len2 - k) // (S - 1))
        # k-mer code + N flag at EVERY offset once (k shifted multiply-adds
        # on [B2, L]), then one 1-element row gather per seed;
        # per-read offsets defeat the static-slice window of the fixed path
        r32 = jnp.pad(reads2.astype(jnp.int32), ((0, 0), (0, k)),
                      constant_values=4)
        code_all = jnp.zeros((B * 2, L), dtype=jnp.int32)
        nflag_all = jnp.zeros((B * 2, L), dtype=bool)
        for i in range(k):
            c = r32[:, i : i + L]
            nflag_all = nflag_all | (c == 4)
            code_all = code_all + jnp.where(c == 4, 0, c) * (4 ** (k - 1 - i))

    # positions fetched as aligned 16-element ROW gathers (one row covers
    # [lo & ~15, +16); ceil((15 + M) / 16) more rows cover any M-run); the
    # in-row realignment is a compare-chain select
    rw = 16
    n_pos = didx.positions.shape[0]
    n_rows = 1 + (rw - 1 + M - 1) // rw
    # n_rows spare rows: the r0 clip below can then never shift a legit lo
    nr_pad = n_pos // rw + 1 + n_rows
    p2 = jnp.pad(didx.positions, (0, nr_pad * rw - n_pos)).reshape(nr_pad, rw)

    chunks = []
    for s in range(S):
        if adaptive:
            off = jnp.minimum(s * stride2, L - 1)
            oc = off[:, None]
            code = jnp.take_along_axis(code_all, oc, axis=1)[:, 0]
            has_n = jnp.take_along_axis(nflag_all, oc, axis=1)[:, 0]
        else:
            off = s * cfg.stride
            win = reads2[:, off : off + k]
            has_n = jnp.any(win == 4, axis=1)
            code = jnp.sum(jnp.where(win == 4, 0, win) * pow4[None, :],
                           axis=1)
        fits = (off + k) <= len2
        code = jnp.where(has_n, 0, code)
        lo = didx.bucket_starts[code]
        cnt = didx.bucket_starts[code + 1] - lo
        ok = fits & (~has_n) & (cnt > 0) & (cnt <= M)
        r0 = jnp.clip(lo >> 4, 0, nr_pad - n_rows)
        ridx = r0[None, :] + jnp.arange(n_rows)[:, None]
        f = jnp.take(p2, ridx, axis=0)                 # [n_rows, B2, 16]
        f = f.transpose(1, 0, 2).reshape(-1, n_rows * rw)  # [B2, n_rows*16]
        # in-fetch slot of occ j is (lo & 15) + j — 16 possible offsets, so
        # realign with 16 [B2, M]-shaped selects over static slices
        # f[:, r : r + M] (column j of that slice IS slot j + r)
        qr = (lo - (r0 << 4))[:, None]                 # [B2, 1] in 0..15
        fp = jnp.pad(f, ((0, 0), (0, M)))  # slices r+M stay in bounds
        pos = jnp.zeros((lo.shape[0], M), dtype=jnp.int32)
        for r in range(rw):
            pos = jnp.where(qr == r, fp[:, r : r + M], pos)
        valid = ok[:, None] & (j[None, :] < cnt[:, None])
        off_b = off[:, None] if adaptive else off
        chunks.append(jnp.where(valid, pos - off_b, I32MAX))
    return jnp.concatenate(chunks, axis=1)


def select_candidates(diags: jnp.ndarray, cfg: AlignConfig):
    """Top-C unique diagonals per oriented read by (votes desc, diag asc).

    Votes = number of seeds hitting the same diagonal (ungapped support).
    Returns (cand_diag [B2, C] int32, cand_valid [B2, C] bool)."""
    with jax.named_scope("select"):
        n = diags.shape[1]
        d = jnp.sort(diags, axis=1)
        t = jnp.arange(n, dtype=jnp.int32)
        # run-starts + run lengths via prefix/suffix scans (no searchsorted)
        first = jnp.concatenate(
            [jnp.ones((d.shape[0], 1), dtype=bool), d[:, 1:] != d[:, :-1]],
            axis=1)
        fidx = jnp.where(first, t[None, :], n)
        next_first = jnp.concatenate(
            [jnp.flip(jax.lax.cummin(jnp.flip(fidx[:, 1:], 1), axis=1), 1),
             jnp.full((d.shape[0], 1), n, dtype=jnp.int32)], axis=1)
        votes = next_first - t[None, :]  # run length, valid at run starts
        firstv = first & (d != I32MAX)
        negv = jnp.where(firstv, -votes, 1)
        dd = jnp.where(firstv, d, I32MAX)
        negv_s, dd_s = jax.lax.sort((negv, dd), dimension=1, num_keys=2)
        C = cfg.max_candidates
        return dd_s[:, :C], (negv_s[:, :C] < 1)


# ---------------------------------------------------------------------------
# stage 4: banded affine-gap extension
# ---------------------------------------------------------------------------

def extend_candidates(oriented: jnp.ndarray, lengths: jnp.ndarray,
                      cand_diag: jnp.ndarray, didx: DeviceIndex,
                      sprof: ScoreParams, cfg: AlignConfig):
    """Banded glocal affine-gap DP for every (oriented read, candidate) pair.

    Returns dp_score, dp_j, ug_score, ug_j, each [B2, C] int32. Semantics are
    oracle.banded_dp exactly: band j in [0, 2W], read base i sits at packed
    position diag - W + i + j; leading insertions disallowed; alignments end
    in the M state; argmax returns the smallest optimal j.
    """
    with jax.named_scope("extend"):
        B, _, L = oriented.shape
        C = cand_diag.shape[1]
        W = cfg.band_width
        BAND = 2 * W + 1
        WIN = L + 2 * W
        G = didx.ref_seq.shape[0]
        B2 = B * 2
        P = B2 * C

        diag = jnp.clip(cand_diag, -(WIN + 1), G).reshape(P)
        base = diag - W
        t = jnp.arange(WIN)
        widx = base[:, None] + t[None, :]
        inr = (widx >= 0) & (widx < G)
        refwin = jnp.where(inr, didx.ref_seq[jnp.clip(widx, 0, G - 1)],
                           4).astype(jnp.int32)

        reads2 = oriented.reshape(B2, L)
        strand = jnp.tile(jnp.repeat(jnp.arange(2), C), B)             # [P]
        Lr = jnp.repeat(lengths, 2 * C)                                # [P]
        s_all = jnp.stack([sprof.s_fwd, sprof.s_comp]).reshape(-1)  # [2L*25]

        go, ge = cfg.gap_open, cfg.gap_extend
        tj = jnp.arange(BAND)
        neg_col = jnp.full((P, 1), NEG, dtype=jnp.int32)

        def step(carry, xs):
            m_prev, ix_prev, iy_prev, ug = carry
            i, read_i = xs
            # sub[p, j] = S[strand][prof(i)][refwin[i+j]][read[i]], built
            # inside the step so no [P, L, BAND] array is ever materialised
            rb = jax.lax.dynamic_slice_in_dim(refwin, i, BAND, axis=1)
            prof = jnp.where(strand == 0, i, jnp.clip(Lr - 1 - i, 0, L - 1))
            rd = jnp.repeat(read_i, C)                                 # [P]
            sub_i = s_all[((strand * L + prof)[:, None] * 5 + rb) * 5
                          + rd[:, None]]
            act_i = i < Lr
            first_i = i == 0
            sub_i = jnp.where(act_i[:, None], sub_i, 0)
            best_prev = jnp.maximum(m_prev, jnp.maximum(ix_prev, iy_prev))
            m_new = sub_i + jnp.where(first_i, 0, best_prev)
            m_shift = jnp.concatenate([m_prev[:, 1:], neg_col], axis=1)
            ix_shift = jnp.concatenate([ix_prev[:, 1:], neg_col], axis=1)
            ix_new = jnp.where(first_i, NEG,
                               jnp.maximum(m_shift - go, ix_shift - ge))
            # Iy[j] = max_{u<j} (M[u] - go - (j-1-u)*ge)  via prefix cummax
            a = m_new - go + tj[None, :] * ge
            cm = jax.lax.cummax(a, axis=1)
            iy_new = jnp.concatenate(
                [neg_col, cm[:, :-1] - tj[None, :-1] * ge], axis=1)
            actb = act_i[:, None]
            m_out = jnp.where(actb, m_new, m_prev)
            ix_out = jnp.where(actb, ix_new, NEG)
            iy_out = jnp.where(actb, iy_new, NEG)
            return (m_out, ix_out, iy_out, ug + sub_i), None

        # carry inits derive from the per-pair inputs (0 * refwin) so their
        # sharding/varying type matches the scan outputs under shard_map (vma
        # typing)
        zero = refwin[:, :BAND] * 0 + Lr[:, None] * 0
        init = (zero + NEG, zero + NEG, zero + NEG, zero)
        xs = (jnp.arange(L, dtype=jnp.int32), reads2.T)   # [L], [L, B2]
        (m_fin, _ix, _iy, ug), _ = jax.lax.scan(step, init, xs)

        dp_j = jnp.argmax(m_fin, axis=1).astype(jnp.int32)
        dp_score = jnp.max(m_fin, axis=1)
        ug_j = jnp.argmax(ug, axis=1).astype(jnp.int32)
        ug_score = jnp.max(ug, axis=1)
        shape = (B2, C)
        return (dp_score.reshape(shape), dp_j.reshape(shape),
                ug_score.reshape(shape), ug_j.reshape(shape))


# ---------------------------------------------------------------------------
# stage 5: finalize
# ---------------------------------------------------------------------------

def finalize(oriented, lengths, min_scores, cand_diag, cand_valid,
             dp_score, dp_j, ug_score, ug_j, didx: DeviceIndex,
             sprof: ScoreParams, cfg: AlignConfig) -> AlignResult:
    """Dedupe, select, count hits, MAPQ, boundary policy, ungapped NM.

    All inputs at [B2, C]; outputs at [B]. Semantics mirror oracle.align_read
    line for line.
    """
    B = oriented.shape[0]
    L = oriented.shape[2]
    C = cand_diag.shape[1]
    n = 2 * C
    W = cfg.band_width
    G = didx.ref_seq.shape[0]

    def per_read(x):
        return x.reshape(B, n)

    diag = per_read(jnp.clip(cand_diag, -(L + 2 * W + 1), G))
    valid0 = per_read(cand_valid)
    dps = per_read(dp_score)
    dpj = per_read(dp_j)
    ugs = per_read(ug_score)
    ugj = per_read(ug_j)
    strand = jnp.tile(jnp.repeat(jnp.arange(2), C)[None, :], (B, 1))

    ug_eq = ugs == dps
    j_sel = jnp.where(ug_eq, ugj, dpj)
    pos_key = diag - W + j_sel
    valid = valid0 & (dps >= min_scores[:, None])
    n_candidates = jnp.sum(valid0, axis=1).astype(jnp.int32)
    return finalize_core(oriented, lengths, valid, strand, pos_key, dps,
                         ug_eq, diag, n_candidates, didx, sprof, cfg)[0]


def finalize_core(oriented, lengths, valid, strand, pos_key, dps, ug_eq,
                  diag, n_candidates, didx: DeviceIndex, sprof: ScoreParams,
                  cfg: AlignConfig, src=None, nm_pos=None, nm_strand=None):
    """Selection half of finalize over per-entry [B, n] arrays.
    -> (AlignResult, best_idx [B] int32).

    Factored out so combined mode can re-run the identical selection on
    GENOME-PROJECTED entry (strand, pos_key) values (device-side projection
    of transcript candidates, align_batch_combined_packed):

      * src (optional, [B, n] int32 0/1): dedupe tie-break tier between
        equal-score same-key twins — genome-source (0) entries survive over
        transcript (1) ones, matching the host slow path's preference (the
        surviving twin decides the emitted CIGAR for junction hits);
      * nm_pos / nm_strand (optional): the window used for the winner's
        NM / T->C counts. Junction winners' GENOME window is discontiguous,
        so their counts use the original combined-space (transcript) window
        — the same bases the genome M segments cover, frame-invariant.
    """
    B, n = valid.shape
    L = oriented.shape[2]
    G = didx.ref_seq.shape[0]
    if nm_pos is None:
        nm_pos = pos_key
    if nm_strand is None:
        nm_strand = strand

    # dedupe by (strand, pos_key): an entry is a duplicate if a strictly
    # better twin exists — higher score, or equal score and lower (src,
    # index) tier
    same = (strand[:, :, None] == strand[:, None, :]) & \
           (pos_key[:, :, None] == pos_key[:, None, :])
    idx_tier = (jnp.arange(n)[None, :] < jnp.arange(n)[:, None])[None]
    if src is not None:
        tie = (src[:, None, :] < src[:, :, None]) | \
              ((src[:, None, :] == src[:, :, None]) & idx_tier)
    else:
        tie = idx_tier
    better = (dps[:, None, :] > dps[:, :, None]) | \
             ((dps[:, None, :] == dps[:, :, None]) & tie)
    dup = jnp.any(same & better & valid[:, None, :], axis=2)
    uv = valid & ~dup

    best_score = jnp.max(jnp.where(uv, dps, NEG), axis=1)
    at_best = uv & (dps == best_score[:, None])
    best_strand = jnp.min(jnp.where(at_best, strand, 2), axis=1)
    at_bs = at_best & (strand == best_strand[:, None])
    best_pos = jnp.min(jnp.where(at_bs, pos_key, I32MAX), axis=1)
    chosen = at_bs & (pos_key == best_pos[:, None])
    best_idx = jnp.argmax(chosen, axis=1)

    has = jnp.any(uv, axis=1)
    x0 = jnp.sum(at_best, axis=1).astype(jnp.int32)
    x1 = jnp.sum(uv & (dps < best_score[:, None]), axis=1).astype(jnp.int32)
    mapq = jnp.where(
        x0 > 1, 0,
        jnp.where(x1 == 0, 37,
                  jnp.maximum(0, 23 - sprof.mapq_sub[jnp.clip(x1, 0, 255)])))

    def pick(x):
        return jnp.take_along_axis(x, best_idx[:, None], axis=1)[:, 0]

    sel_strand = pick(strand)
    sel_pos = pick(pos_key)
    sel_diag = pick(diag)
    sel_ug_eq = pick(ug_eq)
    sel_score = pick(dps)
    sel_nm_pos = pick(nm_pos)
    sel_nm_strand = pick(nm_strand)

    # chromosome-boundary policy (oracle: whole ungapped span in one chrom)
    ci = jnp.clip(
        jnp.searchsorted(didx.chrom_starts, sel_pos, side="right") - 1,
        0, didx.chrom_starts.shape[0] - 1)
    within = (sel_pos >= didx.chrom_starts[ci]) & \
             (sel_pos + lengths - 1 < didx.chrom_ends[ci]) & (lengths > 0)
    mapped = has & within

    # ungapped NM at the selected position — ref bases fetched as 3-bit
    # packed words (ops/packed_ref.py): ~L/10 gathered rows per read instead
    # of L int8 elements
    from parasuite_tpu.ops.packed_ref import (gather_window_rows,
                                              pack_reference, split_base,
                                              unpack_positions)
    i = jnp.arange(L)
    ridx = sel_nm_pos[:, None] + i[None, :]
    words = pack_reference(didx.ref_seq)
    base_q, base_r = split_base(jnp.clip(sel_nm_pos, -(L + 1), G))
    n_rows = (L + 8) // 10 + 1
    wrows = gather_window_rows(words, base_q, n_rows)          # [n_rows, B]
    codes_ref = unpack_positions(wrows.T, base_r, i)           # [B, L]
    rb = jnp.where((ridx >= 0) & (ridx < G), codes_ref, 4).astype(jnp.int32)
    sel_read = jnp.take_along_axis(
        oriented, sel_nm_strand[:, None, None].astype(jnp.int32),
        axis=1)[:, 0]
    mm = (rb != sel_read) | (rb == 4) | (sel_read == 4)
    in_len = i[None, :] < lengths[:, None]
    nm = jnp.sum(jnp.where(in_len, mm, False), axis=1).astype(jnp.int32)

    # machine-frame T->C over the ungapped span (same ref window as NM);
    # genome-strand view:
    # fwd (ref T, read C), rev (ref A, read G) — oracle align_read _tc_from_cigar
    tc_hit = jnp.where(sel_nm_strand[:, None] == 1,
                       (rb == 0) & (sel_read == 2),
                       (rb == 3) & (sel_read == 1))
    tc = jnp.sum(jnp.where(in_len, tc_hit, False), axis=1).astype(jnp.int32)

    return AlignResult(
        mapped=mapped,
        strand=jnp.where(mapped, sel_strand, 0).astype(jnp.int32),
        pos=jnp.where(mapped, sel_pos, -1),
        score=jnp.where(mapped, sel_score, NEG),
        mapq=jnp.where(mapped, mapq, 0).astype(jnp.int32),
        x0=jnp.where(mapped, x0, 0),
        x1=jnp.where(mapped, x1, 0),
        ug_equal=jnp.where(mapped, sel_ug_eq, True),
        nm=jnp.where(mapped, nm, 0),
        diag=jnp.where(mapped, sel_diag, 0),
        n_candidates=n_candidates,
        tc_count=jnp.where(mapped & sel_ug_eq, tc, 0),
    ), best_idx.astype(jnp.int32)


class PackedResult(NamedTuple):
    """AlignResult packed for the host<->device wire (SURVEY.md §7 hard
    part 3): 13 B/read down instead of the 48 B/read of int32 result fields,
    and 20 B/read of codes up instead of 50. Wire layout v2:

      u8  [B, 7]  col0 = mapped | strand<<1 | ug_equal<<2 | (diag-pos+W)<<3
                  cols 1..6 = mapq, nm, x0, x1, n_candidates, tc_count
      i16 [B, 1]  score   (|score| <= 127/base * 255 bases = 32385 < 2^15;
                  unmapped rows store 0 and unpack to NEG via the flag)
      i32 [B, 1]  pos     (full coordinate range)

    diag rides as its band offset: pos = diag - W + j with j in [0, 2W], so
    diag - pos = W - j fits 5 bits for W <= 15. Codes go up 2-bit packed
    plus an N-position bitmask (20 B/read at L=50, was 25 nibble-packed).
    unpack_result_host restores a bit-identical AlignResult; range bounds
    are enforced by AlignerEngine.supports_packed (L <= 255,
    2*max_candidates <= 255, band_width <= 15).
    """

    u8: jnp.ndarray    # [B, 7] see layout above
    i16: jnp.ndarray   # [B, 1] score
    i32: jnp.ndarray   # [B, 1] pos


def pack_codes_host(codes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """[B, L] int8 codes (0..4) -> (two-bit [B, ceil(L/4)] uint8,
    n-mask [B, ceil(L/8)] uint8 little-bit-order)."""
    B, L = codes.shape
    u = codes.astype(np.uint8)
    isn = u >= 4
    v = np.where(isn, 0, u)
    pad = (-L) % 4
    if pad:
        v = np.concatenate([v, np.zeros((B, pad), np.uint8)], axis=1)
    two = (v[:, 0::4] | (v[:, 1::4] << 2) | (v[:, 2::4] << 4)
           | (v[:, 3::4] << 6))
    nmask = np.packbits(isn, axis=1, bitorder="little")
    return two, nmask


def unpack_codes(two: jnp.ndarray, nmask: jnp.ndarray, L: int) -> jnp.ndarray:
    """Device-side inverse of pack_codes_host."""
    B = two.shape[0]
    sh2 = jnp.arange(4, dtype=jnp.uint8) * 2
    bases = ((two[:, :, None] >> sh2[None, None]) & 3).reshape(B, -1)[:, :L]
    sh1 = jnp.arange(8, dtype=jnp.uint8)
    bits = ((nmask[:, :, None] >> sh1[None, None]) & 1).reshape(B, -1)[:, :L]
    return jnp.where(bits == 1, jnp.uint8(4), bases).astype(jnp.int8)


def pack_result(res: AlignResult, band_width: int) -> PackedResult:
    dposw = jnp.where(res.mapped, res.diag - res.pos + band_width, 0)
    flags = (res.mapped.astype(jnp.uint8)
             | (res.strand << 1).astype(jnp.uint8)
             | (res.ug_equal.astype(jnp.uint8) << 2)
             | (dposw << 3).astype(jnp.uint8))
    u8 = jnp.stack([
        flags, res.mapq, res.nm, res.x0, res.x1, res.n_candidates,
        res.tc_count,
    ], axis=1).astype(jnp.uint8)
    i16 = jnp.where(res.mapped, res.score, 0).astype(jnp.int16)[:, None]
    return PackedResult(u8=u8, i16=i16, i32=res.pos[:, None])


def unpack_result_host(packed: PackedResult,
                       band_width: int) -> AlignResult:
    u8 = np.asarray(packed.u8)
    i = u8.astype(np.int32)
    flags = i[:, 0]
    mapped = (flags & 1).astype(bool)
    pos = np.asarray(packed.i32)[:, 0]
    score = np.where(mapped, np.asarray(packed.i16)[:, 0].astype(np.int32),
                     NEG)
    diag = np.where(mapped, pos + (flags >> 3) - band_width, 0)
    return AlignResult(
        mapped=mapped, strand=(flags >> 1) & 1,
        pos=pos, score=score, mapq=i[:, 1],
        x0=i[:, 3], x1=i[:, 4], ug_equal=((flags >> 2) & 1).astype(bool),
        nm=i[:, 2], diag=diag, n_candidates=i[:, 5],
        tc_count=i[:, 6])


def min_score_table(cfg: AlignConfig) -> np.ndarray:
    """int32 [L+1] lookup so per-batch min_scores need no host upload."""
    from parasuite_tpu.ops.device_index import min_scores_host

    return min_scores_host(np.arange(cfg.max_read_len + 1), cfg)


def align_batch_packed(didx: DeviceIndex, sprof: ScoreParams,
                       packed_codes: jnp.ndarray, nmask: jnp.ndarray,
                       lengths_u16: jnp.ndarray, ms_table: jnp.ndarray,
                       cfg: AlignConfig, with_counts: bool = False):
    """Wire-packed align step: 2-bit codes + N bitmask + uint16 lengths in,
    PackedResult (and optionally the [L, 4, 4] profile count matrix,
    fused so profile passes pay no second upload) out."""
    from parasuite_tpu.ops.profile_update import profile_counts_batch

    codes = unpack_codes(packed_codes, nmask, cfg.max_read_len)
    lengths = lengths_u16.astype(jnp.int32)
    min_scores = ms_table[jnp.clip(lengths, 0, ms_table.shape[0] - 1)]
    res = align_batch(didx, sprof, codes, lengths, min_scores, cfg)
    out = pack_result(res, cfg.band_width)
    if not with_counts:
        return out
    counts = profile_counts_batch(didx, codes, lengths, res.mapped,
                                  res.strand, res.pos, res.ug_equal, cfg)
    return out, counts


class PackedJunctions(NamedTuple):
    """Junction winners of device-finalized rows (combined packed wire):
    row index + spliced-table offset q0 — the host assembles the N CIGAR
    from gpos_tab[q0 : q0+len] (one window gather + a diff); every other
    field of the record is already final in the PackedResult. n_jun beyond
    the cap falls back to the unpacked step, like PackedCandidates."""

    n_jun: jnp.ndarray   # int32 []
    row: jnp.ndarray     # int32 [K]
    q0: jnp.ndarray      # int32 [K]


class PackedCandidates(NamedTuple):
    """Entry-compacted CandidateTable for the wire (combined mode; VERDICT
    r3 missing #2 / next-round #1).

    Only reads with >= 1 valid TRANSCRIPT-space candidate need host-side
    genome re-finalization; for those rows, only their VALID entries matter
    (typically 2-4: the true locus, its genomic twin, stray repeats). So the
    wire carries the batch's valid tx-row entries compacted front-first in
    flat (row, candidate) order — the exact entry order the host slow path
    dedupes/ranks in — padded to a static cap:

      row    i32 [K]  batch row of the entry
      pos    i32 [K]  ungapped-key packed position
      score  i16 [K]  DP score (valid entries pass min_score >= 0, and
                       max <= 127 * 255 < 2^15 — same bound as PackedResult)
      flags  u8  [K]  bit0 = 1 (valid), bit1 strand, bit2 ug_equal,
                       bits 3..7 diag-pos+band_width (in [0, 2W], W <= 15)
      n_sel  i32 []   TRUE number of such entries in the batch; if it
                       exceeds K the host falls back to the unpacked step
                       (correctness never depends on the cap)

    11 B/entry vs the 384 B/read of the full CandidateTable transfer; at
    cap_entries = 4 * batch the combined wire is <= 57 B/read total (13 B
    PackedResult + 44 B entries).
    """

    n_sel: jnp.ndarray   # int32 []
    row: jnp.ndarray     # int32 [K]
    pos: jnp.ndarray     # int32 [K]
    score: jnp.ndarray   # int16 [K]
    flags: jnp.ndarray   # uint8 [K]


class TxDeviceTables(NamedTuple):
    """Transcript/projection lookup tables resident on device (int32
    pytree) for the in-step genome projection of transcript candidates
    (combined mode). Everything is O(1) gathers, with no binary search
    over [B, 2C] queries:

      * page_lut[pos >> page_shift] + one compare -> chromosome index
        (exact because page_shift is chosen so no page holds more than one
        chromosome boundary — CombinedEngine derives it from the minimum
        inter-chromosome gap);
      * gpos_tab[spliced_offset + s] -> chrom-local genomic position of
        every spliced base (plus frame); single-exon-ness is then just a
        CONTIGUITY check of the window's two endpoints — no exon search.

    Memory: 4 B per spliced transcript base + 4 B per 256 packed bases —
    int32-safe and HBM-cheap for any transcriptome under 2 Gbp spliced
    (guarded in CombinedEngine)."""

    minus: jnp.ndarray         # bool  [T]  '-' strand transcript
    tlen: jnp.ndarray          # int32 [T]  spliced length
    gchrom_start: jnp.ndarray  # int32 [T]  packed start of the genome chrom
    sp_off: jnp.ndarray        # int32 [T]  offset into gpos_tab
    gpos_tab: jnp.ndarray      # int32 [S]  spliced-plus -> chrom-local gpos
    page_lut: jnp.ndarray      # int32 [G/256 + 1] page -> chrom index
    starts_ext: jnp.ndarray    # int32 [n_chroms + 1] chrom starts, +inf tail


def project_candidates_device(table: CandidateTable, lengths: jnp.ndarray,
                              didx: DeviceIndex, txt: TxDeviceTables,
                              n_genome: int, tx_boundary: int,
                              page_shift: int):
    """Per-entry genome projection for the combined packed step.

    -> (proj_pos, proj_strand, is_tx, simple, q0, noncontig), all [B, n].
    An entry is `simple` when the device can finalize its SELECTION
    (dedupe/rank/X0/MAPQ and genomic start) exactly as the host slow path
    would: genome-direct ungapped entries inside one chromosome, or
    transcript ungapped entries fully inside their transcript — including
    JUNCTION-spanning ones, whose genomic start is gpos_tab[q0] and whose
    only host-side need is assembling the N CIGAR. noncontig marks the
    junction case (projected window not genomically contiguous); q0 is the
    entry's offset into the spliced->genomic table, which is all the host
    needs to build that CIGAR. Rows whose valid entries are all simple
    never ship their candidate list."""
    pos = table.pos
    L = lengths[:, None]
    G = didx.ref_seq.shape[0]
    T = txt.tlen.shape[0]
    S = txt.gpos_tab.shape[0]
    page = jnp.clip(pos, 0, G - 1) >> page_shift
    ci0 = txt.page_lut[page]
    ci = ci0 + (pos >= txt.starts_ext[ci0 + 1])
    is_tx = pos >= tx_boundary
    txi = jnp.clip(ci - n_genome, 0, max(T - 1, 0))
    local = pos - didx.chrom_starts[jnp.clip(ci, 0,
                                             didx.chrom_starts.shape[0] - 1)]
    tl = txt.tlen[txi]
    minus = txt.minus[txi]
    s0 = jnp.where(minus, tl - (local + L), local)
    ok_p = (local >= 0) & (local + L <= tl) & (s0 >= 0)
    q0 = jnp.clip(s0, 0, None) + txt.sp_off[txi]
    gpos = txt.gpos_tab[jnp.clip(q0, 0, S - 1)]
    gend = txt.gpos_tab[jnp.clip(q0 + L - 1, 0, S - 1)]
    contig = gend == gpos + L - 1
    gpacked = txt.gchrom_start[txi] + gpos
    proj_pos = jnp.where(is_tx, gpacked, pos)
    proj_strand = jnp.where(is_tx & minus, 1 - table.strand, table.strand)
    g_inb = (local >= 0) & \
        (pos + L - 1 < didx.chrom_ends[jnp.clip(
            ci, 0, didx.chrom_ends.shape[0] - 1)])
    simple = table.ug_equal & jnp.where(is_tx, ok_p, g_inb)
    noncontig = is_tx & table.ug_equal & ok_p & ~contig
    return proj_pos, proj_strand, is_tx, simple, q0, noncontig


def align_batch_combined_packed(didx: DeviceIndex, sprof: ScoreParams,
                                txt: TxDeviceTables,
                                packed_codes: jnp.ndarray,
                                nmask: jnp.ndarray,
                                lengths_u16: jnp.ndarray,
                                ms_table: jnp.ndarray, cfg: AlignConfig,
                                n_genome: int, tx_boundary: int,
                                page_shift: int, cap_entries: int,
                                cap_junctions: int):
    """Wire-packed combined-mode align step.

    The device projects every single-exon ungapped transcript candidate to
    genome coordinates and re-runs the finalize selection on the PROJECTED
    (strand, pos) — so the typical exonic read (transcript hit + its
    genomic twin) is deduped, ranked, and MAPQ'd entirely on device,
    bit-identically to the host slow path (parity-tested). Only rows with a
    junction-spanning, gapped, or out-of-bounds candidate ship their entry
    list to the host (PackedCandidates over needs_host rows — typically a
    few percent of reads instead of every exonic read).

    tx_boundary is the packed position where transcript pseudo-chromosomes
    start; n_genome the genome chromosome count (both static per engine)."""
    codes = unpack_codes(packed_codes, nmask, cfg.max_read_len)
    lengths = lengths_u16.astype(jnp.int32)
    min_scores = ms_table[jnp.clip(lengths, 0, ms_table.shape[0] - 1)]

    oriented = orient_reads(codes, lengths)
    diags = seed_diagonals(oriented, lengths, didx, cfg)
    cand_diag, cand_valid = select_candidates(diags, cfg)
    dp_score, dp_j, ug_score, ug_j = extend_candidates(
        oriented, lengths, cand_diag, didx, sprof, cfg)
    table = candidate_table(oriented, lengths, min_scores, cand_diag,
                            cand_valid, dp_score, dp_j, ug_score, ug_j, cfg,
                            didx.ref_seq.shape[0])
    B, n = table.valid.shape
    proj_pos, proj_strand, is_tx, simple, q0, noncontig = \
        project_candidates_device(table, lengths, didx, txt, n_genome,
                                  tx_boundary, page_shift)
    n_cands = jnp.sum(cand_valid.reshape(B, n), axis=1).astype(jnp.int32)
    # junction winners' NM/T->C windows read the ORIGINAL combined-space
    # (transcript) frame — their genome window is discontiguous
    nm_pos = jnp.where(noncontig, table.pos, proj_pos)
    nm_strand = jnp.where(noncontig, table.strand, proj_strand)
    res, best_idx = finalize_core(
        oriented, lengths, table.valid, proj_strand, proj_pos, table.score,
        table.ug_equal, table.diag, n_cands, didx, sprof, cfg,
        src=is_tx.astype(jnp.int32), nm_pos=nm_pos, nm_strand=nm_strand)
    out = pack_result(res, cfg.band_width)

    any_tx = (table.valid & is_tx).any(axis=1)
    row_simple = ~jnp.any(table.valid & ~simple, axis=1)
    needs_host = any_tx & ~row_simple
    mask = (table.valid & needs_host[:, None]).reshape(-1)
    idx = jnp.arange(B * n, dtype=jnp.int32)
    # stable compaction: selected entries keep flat (row, candidate) order —
    # the host dedupe/rank tie-break order — unselected sort past them
    key = jnp.where(mask, idx, idx + B * n)
    order = jnp.sort(key)[:cap_entries]
    sel = jnp.where(order < B * n, order, 0)
    e_pos = table.pos.reshape(-1)[sel]
    e_score = table.score.reshape(-1)[sel].astype(jnp.int16)
    e_st = table.strand.reshape(-1)[sel]
    e_ug = table.ug_equal.reshape(-1)[sel].astype(jnp.int32)
    e_diag = table.diag.reshape(-1)[sel]
    dposw = e_diag - e_pos + cfg.band_width
    flags = (1 | (e_st << 1) | (e_ug << 2) | (dposw << 3)).astype(jnp.uint8)
    pc = PackedCandidates(
        n_sel=jnp.sum(mask).astype(jnp.int32),
        row=(sel // n).astype(jnp.int32),
        pos=e_pos, score=e_score, flags=flags)

    # junction winners of device-finalized rows: ship (row, q0) so the host
    # can assemble the N CIGAR from its spliced->genomic table — everything
    # else about the record is already final in `res`
    win_nc = (jnp.take_along_axis(noncontig, best_idx[:, None],
                                  axis=1)[:, 0]
              & res.mapped & ~needs_host)
    win_q0 = jnp.take_along_axis(q0, best_idx[:, None], axis=1)[:, 0]
    jkey = jnp.where(win_nc, jnp.arange(B, dtype=jnp.int32),
                     jnp.arange(B, dtype=jnp.int32) + B)
    jorder = jnp.sort(jkey)[:cap_junctions]
    jsel = jnp.where(jorder < B, jorder, 0)
    pj = PackedJunctions(
        n_jun=jnp.sum(win_nc).astype(jnp.int32),
        row=jsel.astype(jnp.int32),
        q0=win_q0[jsel])
    return out, pc, pj


class CandidateTable(NamedTuple):
    """Per-candidate outputs [B, 2C] for host-side re-finalization (combined
    genome+transcriptome mode: candidates must be projected to genome space
    before uniqueness/X0/MAPQ are meaningful — pipeline/combined.py)."""

    valid: jnp.ndarray     # bool: passed min-score (pre-dedupe)
    strand: jnp.ndarray    # int32
    pos: jnp.ndarray       # int32 packed ungapped-key position
    score: jnp.ndarray     # int32 DP score
    ug_equal: jnp.ndarray  # bool
    diag: jnp.ndarray      # int32


def candidate_table(oriented, lengths, min_scores, cand_diag, cand_valid,
                    dp_score, dp_j, ug_score, ug_j, cfg: AlignConfig,
                    G: int) -> CandidateTable:
    B = oriented.shape[0]
    L = oriented.shape[2]
    C = cand_diag.shape[1]
    n = 2 * C
    W = cfg.band_width

    def per_read(x):
        return x.reshape(B, n)

    diag = per_read(jnp.clip(cand_diag, -(L + 2 * W + 1), G))
    dps = per_read(dp_score)
    ug_eq = per_read(ug_score) == dps
    j_sel = jnp.where(ug_eq, per_read(ug_j), per_read(dp_j))
    return CandidateTable(
        valid=per_read(cand_valid) & (dps >= min_scores[:, None]),
        strand=jnp.tile(jnp.repeat(jnp.arange(2), C)[None, :], (B, 1)),
        pos=diag - W + j_sel,
        score=dps,
        ug_equal=ug_eq,
        diag=diag,
    )


# ---------------------------------------------------------------------------
# full pipeline
# ---------------------------------------------------------------------------

def align_batch(didx: DeviceIndex, sprof: ScoreParams, codes: jnp.ndarray,
                lengths: jnp.ndarray, min_scores: jnp.ndarray,
                cfg: AlignConfig) -> AlignResult:
    """End-to-end batch alignment (jit this with cfg static)."""
    oriented = orient_reads(codes, lengths)
    diags = seed_diagonals(oriented, lengths, didx, cfg)
    cand_diag, cand_valid = select_candidates(diags, cfg)
    dp_score, dp_j, ug_score, ug_j = extend_candidates(
        oriented, lengths, cand_diag, didx, sprof, cfg)
    return finalize(oriented, lengths, min_scores, cand_diag, cand_valid,
                    dp_score, dp_j, ug_score, ug_j, didx, sprof, cfg)


def align_batch_with_candidates(didx: DeviceIndex, sprof: ScoreParams,
                                codes: jnp.ndarray, lengths: jnp.ndarray,
                                min_scores: jnp.ndarray, cfg: AlignConfig):
    """align_batch + the per-candidate table (combined-reference mode)."""
    oriented = orient_reads(codes, lengths)
    diags = seed_diagonals(oriented, lengths, didx, cfg)
    cand_diag, cand_valid = select_candidates(diags, cfg)
    dp_score, dp_j, ug_score, ug_j = extend_candidates(
        oriented, lengths, cand_diag, didx, sprof, cfg)
    res = finalize(oriented, lengths, min_scores, cand_diag, cand_valid,
                   dp_score, dp_j, ug_score, ug_j, didx, sprof, cfg)
    table = candidate_table(oriented, lengths, min_scores, cand_diag,
                            cand_valid, dp_score, dp_j, ug_score, ug_j, cfg,
                            didx.ref_seq.shape[0])
    return res, table
