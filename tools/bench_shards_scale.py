"""2-D chromosome-sharded path at non-toy index sizes (VERDICT r4
next-round #1c: "the 2-D chromosome-sharded path at >=2x100 Mbp on the
virtual mesh (CPU), proving the cross-shard merge at non-toy index sizes
and documenting the projected 3 Gbp/8-chip footprint").

Builds a 200 Mbp repeat-structured 2-chromosome genome (sim/genome.py),
shards it 2-ways over the 'index' axis of a (data x index) CPU mesh, runs
the sharded step, and pins the cross-shard merge contract against the
replicated single-index path at 10,000x the index size tests/test_shards.py
uses. Records per-shard slab bytes and the projected per-chip budget at
3 Gbp / 8 shards.

THE CONTRACT AT SCALE IS DOMINANCE, NOT BIT-EQUALITY (measured r05): on a
repeat-crowded reference the replicated path's per-read candidate list
saturates (n_candidates == 2C for 99% of reads here) and top-C selection
evicts true diagonals; each shard keeps its own top-C, so the sharded
union holds up to S*C candidates and maps a superset (here +20/2048 reads,
never fewer; 1 read improves its score; X1 counts a few more suboptimal
hits -> slightly lower MAPQ, which is MORE accurate). The checks below
therefore assert: (a) every replicated-mapped read is sharded-mapped with
score >=; (b) equal-score winners are identical (strand/chrom/local/X0);
(c) extra mapped reads exist only on the sharded side. Bit-equality in the
UNSATURATED regime stays pinned by tests/test_shards.py.

CPU-heavy: do not run it beside a GPU benchmark (they share host cores).

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        timeout 3600 python tools/bench_shards_scale.py
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import numpy as np

TOTAL_LEN = int(os.environ.get("PARASUITE_SHARDS_LEN", 200_000_000))
N_READS = int(os.environ.get("PARASUITE_SHARDS_READS", 2048))
READ_LEN = 50


def main() -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from jax.sharding import Mesh

    from parasuite_tpu.config import AlignConfig
    from parasuite_tpu.errormodel.scoring import flat_score_tensor
    from parasuite_tpu.index import KmerIndex
    from parasuite_tpu.ops.aligner import align_batch
    from parasuite_tpu.ops.device_index import (DeviceIndex, ScoreParams,
                                                min_scores_host)
    from parasuite_tpu.parallel.shards import (build_sharded_index,
                                               make_sharded_step)
    from parasuite_tpu.sim import simulate_reads
    from parasuite_tpu.sim.genome import multi_chrom

    n_index = 2
    n_data = 2
    batch = N_READS
    # k=13 per the round-5 genome-scale rule (BASELINE.md: G/4^k <~ 3 at
    # 100 Mbp/shard)
    cfg = AlignConfig(max_read_len=READ_LEN, kmer_size=13, batch_size=batch,
                      max_candidates=8, max_occ=16)

    t0 = time.perf_counter()
    seqs, stats = multi_chrom(TOTAL_LEN, n_index, seed=9)
    synth_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    sharded, full = build_sharded_index(seqs, n_index, cfg)
    build_s = time.perf_counter() - t0

    codes, lengths, truth = simulate_reads(full, batch, READ_LEN, cfg,
                                           seed=6, tc_rate=0.12)
    codes, lengths = np.asarray(codes), np.asarray(lengths)
    ms = min_scores_host(lengths, cfg)

    # --- replicated single-index baseline (the semantics oracle) ---
    import functools

    index_full = KmerIndex.build(full.seq, cfg.kmer_size)
    didx = DeviceIndex.from_host(full, index_full)
    sprof = ScoreParams.from_tensor(
        flat_score_tensor(cfg, cfg.max_read_len), cfg)
    rep = jax.device_get(jax.jit(functools.partial(align_batch, cfg=cfg))(
        didx, sprof, codes, lengths, ms))

    # --- 2-D sharded run ---
    devs = np.asarray(jax.devices()[: n_data * n_index]).reshape(
        n_data, n_index)
    mesh = Mesh(devs, ("data", "index"))
    step = make_sharded_step(cfg, mesh)
    slabs = sharded.slabs(cfg)
    orig = sharded.orig_chrom
    t0 = time.perf_counter()
    out = jax.device_get(step(slabs, orig, sprof, codes, lengths, ms))
    step_first_s = time.perf_counter() - t0  # includes compile
    t0 = time.perf_counter()
    out = jax.device_get(step(slabs, orig, sprof, codes, lengths, ms))
    step_s = time.perf_counter() - t0

    # --- cross-shard merge dominance contract (see module docstring) ---
    ci_rep = np.searchsorted(np.asarray(didx.chrom_starts),
                             rep.pos, side="right") - 1
    local_rep = rep.pos - np.asarray(didx.chrom_starts)[ci_rep]
    rm = np.asarray(rep.mapped)
    sm = np.asarray(out["mapped"])
    rs = np.asarray(rep.score)
    ss = np.asarray(out["score"])
    lost = int((rm & ~sm).sum())          # must be 0
    extra = int((sm & ~rm).sum())         # sharded-only rescues
    both = rm & sm
    worse = int((ss[both] < rs[both]).sum())   # must be 0
    better = int((ss[both] > rs[both]).sum())
    eqs = both & (ss == rs)
    checked = int(eqs.sum())
    mism = 0
    for f_rep, f_sh in ((rep.strand, out["strand"]),
                        (ci_rep, out["chrom"]),
                        (local_rep, out["local_pos"]),
                        (rep.nm, out["nm"])):
        mism += int((np.asarray(f_rep)[eqs] != np.asarray(f_sh)[eqs]).sum())
    # hit counts may only grow (extra retained candidates): x0/x1 >= rep's
    x0r, x0s = np.asarray(rep.x0), np.asarray(out["x0"])
    x0_shrunk = int((x0s[eqs] < x0r[eqs]).sum())      # must be 0
    x0_grew = int((x0s[eqs] > x0r[eqs]).sum())
    nc = np.asarray(rep.n_candidates)
    sat = int((nc >= 2 * cfg.max_candidates).sum())
    dominance_ok = (lost == 0 and worse == 0 and mism == 0
                    and x0_shrunk == 0)

    slab_bytes = {
        "ref_seq": int(sharded.ref_seq[0].nbytes),
        "positions": int(sharded.positions[0].nbytes),
        "bucket_starts": int(sharded.bucket_starts[0].nbytes),
    }
    per_shard = sum(slab_bytes.values())
    # 3 Gbp / 8 chips projection: 375 Mbp/chip, same dtypes + the in-jit
    # 3-bit packed words temp (0.4 B/base)
    G8 = 3_000_000_000 // 8
    proj = {
        "ref_seq": G8,
        "positions_upper_bound": 4 * G8,
        "bucket_starts": int(sharded.bucket_starts[0].nbytes),
        "packed_words_temp": 4 * ((G8 + 9) // 10),
    }
    sens = float((out["mapped"]
                  & (out["strand"] == truth.strand)
                  & (out["chrom"] == truth.chrom_idx)
                  & (out["local_pos"] == truth.local_pos)).sum()
                 / batch)

    print(json.dumps({
        "total_ref_len": int(full.total_len),
        "n_chroms": len(full.names),
        "repeat_fraction": round(stats.repeat_fraction, 4),
        "mesh": f"{n_data}x{n_index} data x index",
        "n_reads": batch,
        "synth_seconds": round(synth_s, 1),
        "sharded_build_seconds": round(build_s, 1),
        "step_first_seconds": round(step_first_s, 1),
        "step_steady_seconds": round(step_s, 2),
        "dominance_ok": dominance_ok,
        "reads_lost_vs_replicated": lost,
        "reads_rescued_by_sharding": extra,
        "scores_worse": worse, "scores_better": better,
        "equal_score_reads_checked": checked,
        "equal_score_winner_mismatches": mism,
        "x0_shrunk": x0_shrunk, "x0_grew": x0_grew,
        "replicated_candidate_saturated": sat,
        "sensitivity_vs_truth": round(sens, 4),
        "per_shard_slab_bytes": slab_bytes,
        "per_shard_total_bytes": per_shard,
        "projected_3gbp_8chip_per_chip_bytes": proj,
        "projected_3gbp_8chip_total_per_chip": sum(proj.values()),
        "note": "CPU virtual mesh; step timings are compile/semantics "
                "evidence, not throughput (jnp kernels, 2-core host)",
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
