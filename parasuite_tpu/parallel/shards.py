"""Chromosome-sharded reference index (SURVEY.md §2 component 12, §5
"long-context analogue"; BASELINE.json: "replicated (or sharded by
chromosome) across hosts").

For references too large for one chip (3 Gbp human genome: ~int32 overflow +
HBM pressure), chromosomes are partitioned across an 'index' mesh axis; every
read batch is broadcast along that axis, each shard aligns against its
sub-reference, and the per-read best hit is reduced across shards:

  * winner  = (score desc, strand asc, ORIGINAL global position asc) — the
    same tie-break order as the replicated path, using original-packing
    coordinates so shard assignment cannot change the choice;
  * x0/x1 merge exactly: x0_g = sum of shard x0 at the winning score,
    x1_g = sum of all shard uniques - x0_g; MAPQ recomputed from the merged
    counts (integer table, ops/device_index._mapq_table).

Repeat filtering (cfg.max_occ) is GLOBAL: build_sharded_index sums per-shard
bucket counts (exact — spacer Ns mean no k-mer spans a chromosome boundary,
so shard counts partition the replicated count) and empties every shard's
bucket for any k-mer whose GLOBAL occurrence count exceeds cfg.max_occ. The
seeding kernel's per-shard `cnt <= max_occ` check is then always consistent
with the replicated path, so a globally-repetitive k-mer can never survive
on a shard where it is locally rare (tests/test_shards.py covers a
repeat-rich reference). Build-time and align-time cfg.max_occ must match;
ShardedIndex.slabs(cfg) enforces it (raises on mismatch).

The shard axis composes with the data axis: a 2-D ('data', 'index') mesh runs
read-batch parallelism and index parallelism together (make_sharded_step).

Equality contract: bit-equality with the replicated path holds while the
replicated per-strand candidate lists have headroom (tests/test_shards.py
pins it). On repeat-crowded references a strand's list fills up (C
candidates) and top-C selection evicts diagonals; each shard keeps its own
top-C, so
the sharded union holds up to S*C candidates and strictly DOMINATES the
replicated result: a superset of mapped reads, never a lower score, X0/X1
counts that can only grow (slightly lower — more accurate — MAPQ on reads
with newly-retained equal hits), and the same winner wherever score and X0
agree (a newly retained equal-score twin can win the position tie-break).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from parasuite_tpu.config import AlignConfig
from parasuite_tpu.index.kmer import KmerIndex
from parasuite_tpu.index.reference import PackedReference
from parasuite_tpu.ops.aligner import NEG, align_batch
from parasuite_tpu.ops.device_index import DeviceIndex, ScoreParams


@dataclass
class ShardedIndex:
    """Stacked per-shard device arrays (leading axis = shard)."""

    ref_seq: np.ndarray        # int8  [S, G_pad]
    bucket_starts: np.ndarray  # int32 [S, 4^k + 1]
    positions: np.ndarray      # int32 [S, n_pad]
    chrom_starts: np.ndarray   # int32 [S, C_pad]  local packed starts
    chrom_ends: np.ndarray     # int32 [S, C_pad]
    orig_chrom: np.ndarray     # int32 [S, C_pad]  chrom index in the original
                               #                    (replicated) packing
    n_chroms: np.ndarray       # int32 [S]
    n_shards: int
    max_occ: int = 0           # global repeat filter baked in at build time
                               # (0 = unfiltered legacy index)

    def slabs(self, cfg: AlignConfig):
        """Validated slab tuple for make_sharded_step.

        The global repeat filter is baked in at build time, so aligning with
        a different cfg.max_occ would silently reintroduce per-shard
        divergence (a smaller align-time max_occ re-decides on per-shard
        counts; a larger one cannot resurrect emptied buckets) — fail loudly
        instead."""
        if self.max_occ and cfg.max_occ != self.max_occ:
            raise ValueError(
                f"align-time cfg.max_occ={cfg.max_occ} != build-time "
                f"max_occ={self.max_occ}; rebuild the sharded index or use "
                f"the matching config")
        return (self.ref_seq, self.bucket_starts, self.positions,
                self.chrom_starts, self.chrom_ends)

    def local_device_index(self, s: int) -> DeviceIndex:
        """Single-shard view (host-side debugging)."""
        c = int(self.n_chroms[s])
        return DeviceIndex(
            ref_seq=jnp.asarray(self.ref_seq[s]),
            bucket_starts=jnp.asarray(self.bucket_starts[s]),
            positions=jnp.asarray(self.positions[s]),
            chrom_starts=jnp.asarray(self.chrom_starts[s, :c]),
            chrom_ends=jnp.asarray(self.chrom_ends[s, :c]),
        )


def assign_chroms(sizes: list[int], n_shards: int) -> list[int]:
    """Greedy balanced assignment (largest first) -> shard id per chrom."""
    order = np.argsort(-np.asarray(sizes), kind="stable")
    load = np.zeros(n_shards, dtype=np.int64)
    out = [0] * len(sizes)
    for ci in order:
        s = int(np.argmin(load))
        out[int(ci)] = s
        load[s] += sizes[int(ci)]
    return out


def build_sharded_index(seqs: dict[str, np.ndarray], n_shards: int,
                        cfg: AlignConfig) -> tuple[ShardedIndex, PackedReference]:
    """Partition chromosomes across n_shards; returns (ShardedIndex, the
    ORIGINAL single packing) — the latter defines global coordinates and SAM
    emission."""
    full = PackedReference.from_dict(seqs, spacer=cfg.chrom_spacer)
    names = list(seqs.keys())
    sizes = [len(seqs[n]) for n in names]
    owner = assign_chroms(sizes, n_shards)

    refs, indexes, origs = [], [], []
    for s in range(n_shards):
        mine = {n: seqs[n] for i, n in enumerate(names) if owner[i] == s}
        if not mine:  # empty shard: minimal dummy chrom of Ns
            mine = {f"__empty{s}": np.full(1, 4, dtype=np.int8)}
            orig = [0]
        else:
            orig = [names.index(n) for n in mine]
        ref = PackedReference.from_dict(mine, spacer=cfg.chrom_spacer)
        refs.append(ref)
        indexes.append(KmerIndex.build(ref.seq, cfg.kmer_size))
        origs.append(orig)

    # Global repeat masking (VERDICT r1 #10): per-shard bucket counts sum to
    # the replicated index's count exactly (spacer Ns forbid cross-chromosome
    # k-mers), so k-mers globally over cfg.max_occ get their buckets emptied
    # in EVERY shard — the seeding filter then matches the replicated path
    # bit-for-bit instead of re-deciding on per-shard counts.
    # int32 accumulator: counts are bounded by int32 positions, and the
    # int64 transient was 8.6 GB at kmer_size=15 (ADVICE r2)
    global_cnt = np.zeros(4 ** cfg.kmer_size, dtype=np.int32)
    for ix in indexes:
        global_cnt += np.diff(ix.bucket_starts)
    keep_code = global_cnt <= cfg.max_occ
    for s, ix in enumerate(indexes):
        cnt = np.diff(ix.bucket_starts.astype(np.int64))
        new_cnt = np.where(keep_code, cnt, 0)
        new_starts = np.concatenate([[0], np.cumsum(new_cnt)]).astype(np.int32)
        indexes[s] = KmerIndex(
            k=ix.k, bucket_starts=new_starts,
            positions=ix.positions[np.repeat(keep_code, cnt)])

    g_pad = max(r.total_len for r in refs)
    n_pad = max(ix.n_kmers for ix in indexes)
    c_pad = max(len(r.names) for r in refs)
    S = n_shards
    ref_seq = np.full((S, g_pad), 4, dtype=np.int8)
    bucket_starts = np.zeros((S, indexes[0].bucket_starts.shape[0]),
                             dtype=np.int32)
    positions = np.zeros((S, max(n_pad, 1)), dtype=np.int32)
    chrom_starts = np.full((S, c_pad), np.iinfo(np.int32).max, dtype=np.int32)
    chrom_ends = np.full((S, c_pad), np.iinfo(np.int32).max, dtype=np.int32)
    orig_chrom = np.zeros((S, c_pad), dtype=np.int32)
    n_chroms = np.zeros(S, dtype=np.int32)
    for s in range(S):
        r, ix = refs[s], indexes[s]
        ref_seq[s, : r.total_len] = r.seq
        bucket_starts[s] = ix.bucket_starts
        positions[s, : ix.n_kmers] = ix.positions
        nc = len(r.names)
        chrom_starts[s, :nc] = r.starts
        chrom_ends[s, :nc] = r.ends
        orig_chrom[s, :nc] = origs[s]
        n_chroms[s] = nc
    return (ShardedIndex(ref_seq=ref_seq, bucket_starts=bucket_starts,
                         positions=positions, chrom_starts=chrom_starts,
                         chrom_ends=chrom_ends, orig_chrom=orig_chrom,
                         n_chroms=n_chroms, n_shards=S,
                         max_occ=cfg.max_occ), full)


def _shard_align(didx_slab, orig_chrom, sprof, codes, lengths, min_scores,
                 cfg: AlignConfig):
    """Inside shard_map: align against the local shard and convert the
    winner's position to (original chrom index, 0-based local position)."""
    didx = DeviceIndex(
        ref_seq=didx_slab[0][0],
        bucket_starts=didx_slab[1][0],
        positions=didx_slab[2][0],
        chrom_starts=didx_slab[3][0],
        chrom_ends=didx_slab[4][0],
    )
    res = align_batch(didx, sprof, codes, lengths, min_scores, cfg)
    ci = jnp.clip(jnp.searchsorted(didx.chrom_starts, res.pos, side="right")
                  - 1, 0, didx.chrom_starts.shape[0] - 1)
    chrom_g = jnp.where(res.mapped, orig_chrom[0][ci], jnp.int32(2**30))
    local_g = jnp.where(res.mapped, res.pos - didx.chrom_starts[ci], -1)
    return res, chrom_g, local_g


def make_sharded_step(cfg: AlignConfig, mesh: Mesh, data_axis: str = "data",
                      index_axis: str = "index"):
    """-> jitted step(sharded_arrays, orig_starts, sprof, codes, lengths,
    min_scores) returning per-read merged results in original coordinates.

    codes/lengths/min_scores are sharded over data_axis and replicated over
    index_axis; the ShardedIndex slabs are sharded over index_axis.
    """

    def step(slabs, orig_chrom, sprof, codes, lengths, min_scores):
        res, chrom_g, local_g = _shard_align(slabs, orig_chrom, sprof, codes,
                                             lengths, min_scores, cfg)
        # gather per-shard winners for the merge: [S, B] each
        score = jax.lax.all_gather(jnp.where(res.mapped, res.score, NEG),
                                   index_axis)
        strand = jax.lax.all_gather(res.strand, index_axis)
        chrom = jax.lax.all_gather(chrom_g, index_axis)
        local = jax.lax.all_gather(local_g, index_axis)
        x0 = jax.lax.all_gather(res.x0, index_axis)
        x1 = jax.lax.all_gather(res.x1, index_axis)
        mapped = jax.lax.all_gather(res.mapped, index_axis)
        ug_eq = jax.lax.all_gather(res.ug_equal, index_axis)
        nm = jax.lax.all_gather(res.nm, index_axis)

        best_score = jnp.max(score, axis=0)
        at_best = mapped & (score == best_score[None])
        bstrand = jnp.min(jnp.where(at_best, strand, 2), axis=0)
        at_bs = at_best & (strand == bstrand[None])
        bchrom = jnp.min(jnp.where(at_bs, chrom, 2**30), axis=0)
        at_bc = at_bs & (chrom == bchrom[None])
        blocal = jnp.min(jnp.where(at_bc, local, 2**30), axis=0)
        winner = at_bc & (local == blocal[None])
        widx = jnp.argmax(winner, axis=0)

        x0_g = jnp.sum(jnp.where(at_best, x0, 0), axis=0)
        uniq_total = jnp.sum(jnp.where(mapped, x0 + x1, 0), axis=0)
        x1_g = uniq_total - x0_g
        mapq = jnp.where(
            x0_g > 1, 0,
            jnp.where(x1_g == 0, 37,
                      jnp.maximum(0, 23 - sprof.mapq_sub[
                          jnp.clip(x1_g, 0, 255)])))

        def pick(x):
            return jnp.take_along_axis(x, widx[None, :], axis=0)[0]

        any_mapped = jnp.any(mapped, axis=0)
        return {
            "mapped": any_mapped,
            "strand": jnp.where(any_mapped, pick(strand), 0),
            "chrom": jnp.where(any_mapped, pick(chrom), -1),
            "local_pos": jnp.where(any_mapped, pick(local), -1),
            "score": jnp.where(any_mapped, best_score, NEG),
            "mapq": jnp.where(any_mapped, mapq, 0).astype(jnp.int32),
            "x0": jnp.where(any_mapped, x0_g, 0).astype(jnp.int32),
            "x1": jnp.where(any_mapped, x1_g, 0).astype(jnp.int32),
            "ug_equal": jnp.where(any_mapped, pick(ug_eq), True),
            "nm": jnp.where(any_mapped, pick(nm), 0),
            "shard": jnp.where(any_mapped, widx, -1).astype(jnp.int32),
        }

    data = P(data_axis)
    idx = P(index_axis)
    slab_spec = (idx, idx, idx, idx, idx)
    # check_vma=False: the outputs ARE replicated over index_axis (they are
    # pure reductions of all_gather'ed values) but the vma inference cannot
    # prove it through the argmax/take_along_axis chain
    sharded = jax.shard_map(
        step, mesh=mesh,
        in_specs=(slab_spec, idx, P(), data, data, data),
        out_specs=data, check_vma=False)
    return jax.jit(sharded)
