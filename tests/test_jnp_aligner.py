"""Device aligner vs oracle parity (SURVEY.md §4.1: kernels must match the
numpy spec exactly on randomized batches)."""

import functools

import jax
import numpy as np
import pytest

from parasuite_tpu.errormodel import counts_to_profile, flat_score_tensor
from parasuite_tpu.errormodel.infer import ErrorProfile
from parasuite_tpu.ops import DeviceIndex, ScoreParams, align_batch
from parasuite_tpu.ops.device_index import min_scores_host
from parasuite_tpu.oracle import align_batch_oracle

from conftest import sample_reads


@pytest.fixture(scope="module")
def device_state(tiny_ref, tiny_index, small_cfg):
    didx = DeviceIndex.from_host(tiny_ref, tiny_index)
    s = flat_score_tensor(small_cfg, small_cfg.max_read_len)
    sprof = ScoreParams.from_tensor(s, small_cfg)
    fn = jax.jit(functools.partial(align_batch, cfg=small_cfg))
    return didx, sprof, s, fn


def _compare(res, alns, cfg, ctx=""):
    mapped = np.asarray(res.mapped)
    for b, a in enumerate(alns):
        where = f"{ctx} read {b}"
        assert bool(mapped[b]) == a.mapped, where
        if not a.mapped:
            continue
        assert int(res.strand[b]) == a.strand, where
        assert int(res.score[b]) == a.score, where
        assert int(res.x0[b]) == a.x0, where
        assert int(res.x1[b]) == a.x1, where
        assert int(res.mapq[b]) == a.mapq, where
        assert bool(res.ug_equal[b]) == a.ug_equal, where
        if a.ug_equal:
            assert int(res.pos[b]) == a.packed_pos, where
            assert int(res.nm[b]) == a.nm, where
            assert int(res.tc_count[b]) == a.tc, where


def _run(device_state, tiny_ref, tiny_index, small_cfg, codes, lengths):
    didx, sprof, s, fn = device_state
    res = fn(didx, sprof, codes, lengths, min_scores_host(lengths, small_cfg))
    alns = align_batch_oracle(codes, lengths, tiny_ref, tiny_index, s,
                              small_cfg)
    return res, alns


def test_parity_exact(device_state, tiny_ref, tiny_index, small_cfg):
    rng = np.random.default_rng(100)
    codes, lengths, _ = sample_reads(rng, tiny_ref, 64, 50, mutate=0)
    res, alns = _run(device_state, tiny_ref, tiny_index, small_cfg, codes, lengths)
    assert sum(a.mapped for a in alns) == 64
    _compare(res, alns, small_cfg, "exact")


def test_parity_mutated(device_state, tiny_ref, tiny_index, small_cfg):
    rng = np.random.default_rng(101)
    codes, lengths, _ = sample_reads(rng, tiny_ref, 64, 50, mutate=4)
    res, alns = _run(device_state, tiny_ref, tiny_index, small_cfg, codes, lengths)
    _compare(res, alns, small_cfg, "mutated")


def test_parity_indels(device_state, tiny_ref, tiny_index, small_cfg):
    rng = np.random.default_rng(102)
    codes, lengths, _ = sample_reads(rng, tiny_ref, 64, 50, mutate=1,
                                     indel=True)
    res, alns = _run(device_state, tiny_ref, tiny_index, small_cfg, codes, lengths)
    assert any(not a.ug_equal for a in alns if a.mapped)  # some gapped
    _compare(res, alns, small_cfg, "indel")


def test_parity_garbage_and_padding(device_state, tiny_ref, tiny_index, small_cfg):
    rng = np.random.default_rng(103)
    codes = rng.integers(0, 4, size=(16, 50)).astype(np.int8)
    lengths = np.full(16, 50, dtype=np.int32)
    lengths[10:] = 0  # padding rows
    codes[5, :25] = 4  # half-N read
    lengths[6] = 20    # short read
    res, alns = _run(device_state, tiny_ref, tiny_index, small_cfg, codes, lengths)
    _compare(res, alns, small_cfg, "garbage")


def test_parity_mixed_lengths(device_state, tiny_ref, tiny_index, small_cfg):
    rng = np.random.default_rng(104)
    codes, lengths, _ = sample_reads(rng, tiny_ref, 48, 50, mutate=2)
    # truncate a third of reads to odd lengths (36..49)
    for b in range(0, 48, 3):
        ln = int(rng.integers(36, 50))
        lengths[b] = ln
        codes[b, ln:] = 4
    res, alns = _run(device_state, tiny_ref, tiny_index, small_cfg, codes, lengths)
    _compare(res, alns, small_cfg, "mixedlen")


def test_parity_learned_profile(device_state, tiny_ref, tiny_index, small_cfg):
    """Parity must hold for an arbitrary (learned, asymmetric) score tensor."""
    rng = np.random.default_rng(105)
    counts = rng.integers(0, 50, size=(50, 4, 4)).astype(np.int64)
    counts += np.eye(4, dtype=np.int64)[None] * 5000  # diagonal-dominant
    counts[:, 3, 1] += 600  # heavy T->C
    s = counts_to_profile(ErrorProfile(counts=counts), small_cfg)
    sprof = ScoreParams.from_tensor(s, small_cfg)
    didx, _, _, _ = device_state
    fn = jax.jit(functools.partial(align_batch, cfg=small_cfg))

    codes, lengths, _ = sample_reads(rng, tiny_ref, 48, 50, mutate=2)
    # sprinkle T->C conversions
    conv = (codes == 3) & (rng.random(codes.shape) < 0.15)
    codes = np.where(conv, 1, codes).astype(np.int8)

    res = fn(didx, sprof, codes, lengths, min_scores_host(lengths, small_cfg))
    alns = align_batch_oracle(codes, lengths, tiny_ref, tiny_index, s,
                              small_cfg)
    _compare(res, alns, small_cfg, "learned")


def test_batch_size_independence(device_state, tiny_ref, tiny_index, small_cfg):
    """Same read, any batch composition -> identical outputs (SURVEY.md §4.5)."""
    rng = np.random.default_rng(106)
    codes, lengths, _ = sample_reads(rng, tiny_ref, 32, 50, mutate=3)
    didx, sprof, s, fn = device_state
    full = fn(didx, sprof, codes, lengths, min_scores_host(lengths, small_cfg))
    half1 = fn(didx, sprof, codes[:16], lengths[:16],
               min_scores_host(lengths[:16], small_cfg))
    for f in ["mapped", "strand", "pos", "score", "mapq", "x0", "x1", "nm"]:
        np.testing.assert_array_equal(np.asarray(getattr(full, f))[:16],
                                      np.asarray(getattr(half1, f)),
                                      err_msg=f)


def test_packed_wire_path_bit_identical(device_state, tiny_ref, tiny_index,
                                        small_cfg):
    """align_device_packed (2-bit codes + N bitmask up, PackedResult v2
    down — the streaming fast path) must reproduce align_batch
    bit-exactly, including the fused profile-count matrix."""
    from conftest import sample_reads

    from parasuite_tpu.ops.aligner import unpack_result_host
    from parasuite_tpu.pipeline import AlignerEngine

    rng = np.random.default_rng(900)
    codes, lengths, _ = sample_reads(rng, tiny_ref, 64, 50, mutate=3)
    codes[60:] = rng.integers(0, 4, size=(4, 50)).astype(np.int8)
    lengths[62] = 37  # a short read exercises the uint16 length path
    codes[59, 7] = 4  # in-read Ns exercise the wire N-bitmask
    codes[59, 31] = 4

    engine = AlignerEngine(tiny_ref, tiny_index, small_cfg)
    assert engine.supports_packed
    ref_res = engine.align_device(codes, lengths)
    ref_counts = engine.profile_counts_device(codes, lengths, ref_res)
    packed, counts = engine.align_device_packed(codes, lengths,
                                                with_counts=True)
    got = unpack_result_host(jax.device_get(packed), small_cfg.band_width)
    for f in ref_res._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(got, f)), np.asarray(getattr(ref_res, f)),
            err_msg=f)
    np.testing.assert_array_equal(np.asarray(counts), np.asarray(ref_counts))


def test_parity_overlapping_seed_stride(tiny_ref, tiny_index, small_cfg):
    """seed_stride < k (overlapping seeds) must stay bit-exact vs the oracle
    and rescue reads whose every non-overlapping seed carries a mutation."""
    import dataclasses

    cfg = dataclasses.replace(small_cfg, max_seeds=7, seed_stride=6)
    didx = DeviceIndex.from_host(tiny_ref, tiny_index)
    s = flat_score_tensor(cfg, cfg.max_read_len)
    sprof = ScoreParams.from_tensor(s, cfg)
    fn = jax.jit(functools.partial(align_batch, cfg=cfg))

    rng = np.random.default_rng(104)
    codes, lengths, truth = sample_reads(rng, tiny_ref, 64, 50, mutate=0)
    # dirty every NON-overlapping seed window: mutations at 4, 16, 28, 40
    # hit all of [0,8), [8,16), [16,24), [24,32) for k=8... place one inside
    # each stride-8 window so the default config would lose every seed
    for b in range(0, 64, 2):
        for p in (4, 12, 20, 28):
            codes[b, p] = (codes[b, p] + 1) % 4
    res = fn(didx, sprof, codes, lengths, min_scores_host(lengths, cfg))
    alns = align_batch_oracle(codes, lengths, tiny_ref, tiny_index, s, cfg)
    _compare(res, alns, cfg, "stride6")
    # the overlapping-stride config must still map the dirtied reads
    assert all(alns[b].mapped for b in range(0, 64, 2))


def test_mixed_length_parity_adaptive_seeds(tiny_ref, tiny_index):
    """BASELINE spec range 36-100bp in ONE batch: adaptive per-read seed
    placement must match the oracle bit-for-bit at every length (VERDICT r3
    missing #6 — no mixed-length batch had ever been tested)."""
    from parasuite_tpu.config import AlignConfig
    from parasuite_tpu.utils.dna import revcomp_codes

    cfg = AlignConfig(max_read_len=100, batch_size=64, kmer_size=8,
                      max_seeds=5, seed_stride=6, max_occ=32,
                      max_candidates=8, band_width=3, chrom_spacer=128)
    assert cfg.seed_placement == "adaptive"
    rng = np.random.default_rng(606)
    L = 100
    n = 48
    codes = np.full((n, L), 4, dtype=np.int8)
    lengths = np.zeros(n, dtype=np.int32)
    for i in range(n):
        ln = int(rng.choice([36, 50, 75, 100]))
        p = int(rng.integers(0, 4800 - ln))
        frag = tiny_ref.seq[p : p + ln].copy()
        while np.any(frag == 4):
            p = int(rng.integers(0, 4800 - ln))
            frag = tiny_ref.seq[p : p + ln].copy()
        for _ in range(int(rng.integers(0, 3))):
            q = int(rng.integers(0, ln))
            frag[q] = rng.integers(0, 4)
        if rng.random() < 0.5:
            frag = revcomp_codes(frag)
        codes[i, :ln] = frag
        lengths[i] = ln
    didx = DeviceIndex.from_host(tiny_ref, tiny_index)
    s = flat_score_tensor(cfg, cfg.max_read_len)
    sprof = ScoreParams.from_tensor(s, cfg)
    fn = jax.jit(functools.partial(align_batch, cfg=cfg))
    res = fn(didx, sprof, codes, lengths, min_scores_host(lengths, cfg))
    alns = align_batch_oracle(codes, lengths, tiny_ref, tiny_index, s, cfg)
    _compare(res, alns, cfg, ctx="mixed-length")
    assert sum(a.mapped for a in alns) > 40

    # per-read strides actually differ across lengths
    assert cfg.seed_stride_for(36) != cfg.seed_stride_for(100)
