"""Extension stage: the jnp banded-DP scan vs the numpy oracle, pair by pair
— bit-equal contract (SURVEY.md §4.1).

The CPU cases are tiny. The full-width cases (C=8, W=5, L in {36, 50, 100})
compile the same scan for the card and are marked `gpu`
(PARASUITE_TEST_GPU=1 pytest -m gpu).
"""

import functools

import jax
import numpy as np
import pytest

from parasuite_tpu.config import AlignConfig
from parasuite_tpu.errormodel import (complement_score_tensor,
                                      counts_to_profile, flat_score_tensor)
from parasuite_tpu.errormodel.infer import ErrorProfile
from parasuite_tpu.index import KmerIndex, PackedReference
from parasuite_tpu.ops import DeviceIndex, ScoreParams, align_batch
from parasuite_tpu.ops.aligner import (extend_candidates, orient_reads,
                                       seed_diagonals, select_candidates)
from parasuite_tpu.ops.device_index import min_scores_host
from parasuite_tpu.oracle import align_batch_oracle
from parasuite_tpu.oracle.align import _ref_window, _score_rows, banded_dp

from conftest import sample_reads

FIELDS = ("dp_score", "dp_j", "ug_score", "ug_j")


def _oracle_extend(oriented, lengths, cand_diag, ref_seq, s_tensor, cfg):
    """oracle.banded_dp per (read, strand, candidate) pair; rows of
    zero-length reads are left at -1 (the oracle has no such read)."""
    oriented = np.asarray(oriented)
    cand_diag = np.asarray(cand_diag)
    B, _, L = oriented.shape
    C = cand_diag.shape[1]
    W = cfg.band_width
    G = ref_seq.shape[0]
    s_comp = complement_score_tensor(s_tensor)
    out = np.full((4, B * 2, C), -1, dtype=np.int64)
    for b in range(B):
        ln = int(lengths[b])
        if ln == 0:
            continue
        for st in (0, 1):
            read = oriented[b, st, :ln]
            rows = _score_rows(s_tensor if st == 0 else s_comp, read, ln, st)
            for c in range(C):
                diag = int(np.clip(cand_diag[b * 2 + st, c],
                                   -(L + 2 * W + 1), G))
                win = _ref_window(ref_seq, diag, ln, W)
                out[:, b * 2 + st, c] = banded_dp(rows, win, ln, cfg)
    return out


def _assert_extend_parity(ref, didx, s_tensor, cfg, codes, lengths):
    sprof = ScoreParams.from_tensor(s_tensor, cfg)
    oriented = orient_reads(codes, lengths)
    cand_diag, _ = select_candidates(
        seed_diagonals(oriented, lengths, didx, cfg), cfg)
    got = jax.jit(functools.partial(extend_candidates, cfg=cfg))(
        oriented, lengths, cand_diag, didx, sprof)
    want = _oracle_extend(oriented, lengths, cand_diag, ref.seq, s_tensor,
                          cfg)
    live = np.repeat(np.asarray(lengths) > 0, 2)
    for k, (name, g) in enumerate(zip(FIELDS, got)):
        np.testing.assert_array_equal(np.asarray(g)[live], want[k][live],
                                      err_msg=name)


def _learned_tensor(rng, cfg):
    counts = rng.integers(0, 50, size=(cfg.max_read_len, 4, 4))
    counts = counts.astype(np.int64) + np.eye(4, dtype=np.int64)[None] * 5000
    counts[:, 3, 1] += 600                       # heavy T->C
    return counts_to_profile(ErrorProfile(counts=counts), cfg)


@pytest.mark.parametrize("case", ["band2", "band3", "band5", "zero_length",
                                  "n_runs", "learned_scores",
                                  "odd_candidates"])
def test_extend_stage_parity(case):
    """jnp scan == oracle.banded_dp for every (read, strand, candidate)."""
    band_width = {"band3": 3, "band5": 5}.get(case, 2)
    C = 3 if case == "odd_candidates" else 2
    cfg = AlignConfig(max_read_len=24, kmer_size=6, max_seeds=4, max_occ=8,
                      max_candidates=C, band_width=band_width,
                      chrom_spacer=40)
    rng = np.random.default_rng(510 + band_width + C)
    ref = PackedReference.from_dict(
        {"c": rng.integers(0, 4, 3000).astype(np.int8)}, spacer=40)
    didx = DeviceIndex.from_host(ref, KmerIndex.build(ref.seq, 6))
    codes, lengths, _ = sample_reads(rng, ref, 13 if C == 3 else 16, 24,
                                     mutate=2, indel=True)
    s = flat_score_tensor(cfg, cfg.max_read_len)
    if case == "zero_length":
        lengths[[0, 5, 9]] = 0
        codes[[0, 5, 9]] = 4
    elif case == "n_runs":
        codes[2, 4:12] = 4
        codes[7, :6] = 4
        codes[11, 18:] = 4
    elif case == "learned_scores":
        s = _learned_tensor(rng, cfg)
        conv = (codes == 3) & (rng.random(codes.shape) < 0.15)
        codes = np.where(conv, 1, codes).astype(np.int8)
    _assert_extend_parity(ref, didx, s, cfg, codes, lengths)


@pytest.mark.gpu
class TestOnGpu:
    """The scan as XLA compiles it for the card, at real widths (C=8,
    W=5), against the oracle."""

    @pytest.fixture(scope="class")
    def world(self):
        rng = np.random.default_rng(4040)
        ref = PackedReference.from_dict(
            {"c1": rng.integers(0, 4, 1_500_000).astype(np.int8),
             "c2": rng.integers(0, 4, 500_000).astype(np.int8)}, spacer=256)
        return ref, KmerIndex.build(ref.seq, 12)

    @pytest.mark.parametrize("L", [36, 50, 100])
    def test_extend_parity_compiled(self, world, L):
        ref, index = world
        cfg = AlignConfig(max_read_len=L, kmer_size=12, max_candidates=8,
                          max_occ=16)
        didx = DeviceIndex.from_host(ref, index)
        rng = np.random.default_rng(400 + L)
        codes, lengths, _ = sample_reads(rng, ref, 192, L, mutate=3,
                                         indel=True)
        lengths[5] = 0
        codes[6, :20] = 4
        lengths[7] = L - 9
        codes[7, L - 9:] = 4
        _assert_extend_parity(ref, didx, _learned_tensor(rng, cfg), cfg,
                              codes, lengths)

    def test_full_align_compiled(self, world):
        ref, index = world
        cfg = AlignConfig(max_read_len=50, kmer_size=12, max_candidates=8,
                          max_occ=16)
        didx = DeviceIndex.from_host(ref, index)
        s = flat_score_tensor(cfg, 50)
        rng = np.random.default_rng(403)
        codes, lengths, _ = sample_reads(rng, ref, 256, 50, mutate=3,
                                         indel=True)
        res = jax.jit(functools.partial(align_batch, cfg=cfg))(
            didx, ScoreParams.from_tensor(s, cfg), codes, lengths,
            min_scores_host(lengths, cfg))
        alns = align_batch_oracle(codes, lengths, ref, index, s, cfg)
        for b, a in enumerate(alns):
            assert bool(res.mapped[b]) == a.mapped, b
            if not a.mapped:
                continue
            for f, o in (("strand", "strand"), ("score", "score"),
                         ("x0", "x0"), ("x1", "x1"), ("mapq", "mapq"),
                         ("ug_equal", "ug_equal"), ("diag", "diag")):
                assert int(getattr(res, f)[b]) == int(getattr(a, o)), (b, f)
            if a.ug_equal:
                assert int(res.pos[b]) == a.packed_pos, b
                assert int(res.nm[b]) == a.nm, b
