"""Genome-scale proof bench (VERDICT r4 next-round #1; BASELINE configs 1/5).

Three measured claims that toy/uniform references cannot support:

  (a) chr22-class: a 51 Mbp repeat-structured chromosome (sim/genome.py —
      ~25% interspersed repeats, satellite, segdups, 10.3 Mbp N gap) —
      index build time, bucket-occupancy/max_occ census, seed-drop
      accounting against the repeat policy, sensitivity/precision overall
      AND on the unique (X0==1) subset, device + e2e throughput.
  (b) >=200 Mbp multi-chromosome genome single-chip: HBM footprint of the
      resident index + per-batch temps, device throughput, sensitivity.
  (c) is tools/bench_shards_scale.py (2-D chromosome-sharded path on the
      virtual CPU mesh at 2x100 Mbp).

Writes one JSON line on stdout.

    timeout 7200 python tools/bench_genome.py            # both worlds
    PARASUITE_GENOME_PART=a|b                            # one world
    PARASUITE_GENOME_SCALE=0.02                          # shrink for tests
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
from parasuite_tpu.utils.jaxcache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np

READ_LEN = 50
N_READS = int(os.environ.get("PARASUITE_GENOME_READS", 16 * 65536))
SCALE = float(os.environ.get("PARASUITE_GENOME_SCALE", 1.0))


def make_cfg(batch):
    from parasuite_tpu.config import AlignConfig

    # bench.py's operating point (kmer 12, 7 seeds, max_occ 16) — the whole
    # point here is measuring THAT config against repeat structure.
    # PARASUITE_GENOME_K / PARASUITE_GENOME_MAXOCC probe the >=200 Mbp
    # operating point: at G=200M and k=12 the MEAN bucket holds ~12 entries,
    # so max_occ=16 sits inside the Poisson bulk and drops 16.5% of k-mer
    # mass (measured r05) — the fix is more buckets (k=13) or a higher cap.
    return AlignConfig(
        max_read_len=READ_LEN,
        kmer_size=int(os.environ.get("PARASUITE_GENOME_K", 12)),
        batch_size=batch, max_candidates=8,
        max_occ=int(os.environ.get("PARASUITE_GENOME_MAXOCC", 16)))


def index_census(index, cfg) -> dict:
    """Bucket-occupancy stats: how much k-mer mass the max_occ repeat
    policy actually drops on this reference."""
    occ = np.diff(index.bucket_starts.astype(np.int64))
    nz = occ[occ > 0]
    over = occ > cfg.max_occ
    return {
        "kmers_total": int(occ.sum()),
        "buckets_nonzero": int(nz.shape[0]),
        "bucket_p99": int(np.percentile(nz, 99)) if nz.size else 0,
        "bucket_max": int(occ.max()) if occ.size else 0,
        "buckets_over_max_occ": int(over.sum()),
        "kmer_mass_over_max_occ_frac": round(
            float(occ[over].sum()) / max(int(occ.sum()), 1), 5),
    }


def seed_drop_census(ref, index, truth, lengths, cfg) -> dict:
    """Repeat-policy seed accounting on the CLEAN reference windows of the
    simulated reads: a seed is dropped when its (error-free) k-mer bucket
    holds > max_occ positions or spans an N. Reads with ALL seeds dropped
    are seeding-blind — the structural sensitivity ceiling the repeat
    policy imposes (errors/conversions only lower it further)."""
    k, S, M = cfg.kmer_size, cfg.max_seeds, cfg.max_occ
    n = truth.packed_pos.shape[0]
    L = int(lengths.max())
    win_idx = truth.packed_pos[:, None] + np.arange(L)[None, :]
    win = ref.seq[np.clip(win_idx, 0, ref.seq.shape[0] - 1)].astype(np.int64)
    stride = np.maximum(1, (lengths.astype(np.int64) - k) // max(S - 1, 1))
    pow4 = 4 ** np.arange(k - 1, -1, -1)
    starts = index.bucket_starts.astype(np.int64)
    dropped = np.zeros((n, S), dtype=bool)
    for s in range(S):
        off = np.minimum(s * stride, lengths.astype(np.int64) - k)
        sl = win[np.arange(n)[:, None], off[:, None] + np.arange(k)[None, :]]
        has_n = (sl == 4).any(axis=1)
        code = np.where(has_n[:, None], 0, sl).dot(pow4)
        cnt = starts[code + 1] - starts[code]
        dropped[:, s] = has_n | (cnt > M)
    all_dropped = dropped.all(axis=1)
    return {
        "seeds_per_read": S,
        "seed_dropped_frac": round(float(dropped.mean()), 5),
        "reads_all_seeds_dropped": int(all_dropped.sum()),
        "reads_all_seeds_dropped_frac": round(float(all_dropped.mean()), 5),
    }


def device_pass(didx, sprof, cfg, codes, lengths, rounds=3):
    """Best-of-N pipelined device throughput + full per-read outputs
    (mapq/x0 kept for the unique-subset accuracy split)."""
    import functools

    import jax

    from parasuite_tpu.ops.aligner import (align_batch_packed,
                                           min_score_table, pack_codes_host,
                                           unpack_result_host)

    B = cfg.batch_size
    n = codes.shape[0] - codes.shape[0] % B
    lengths16 = lengths.astype(np.uint16)
    ms_table = jax.device_put(min_score_table(cfg))
    fn = jax.jit(functools.partial(align_batch_packed, cfg=cfg))
    wt, wn = pack_codes_host(codes[:B])
    jax.device_get(fn(didx, sprof, wt, wn, lengths16[:B], ms_table))
    rates, results = [], None
    for _ in range(rounds):
        t0 = time.perf_counter()
        outs = []
        for i in range(0, n, B):
            two, nmask = pack_codes_host(codes[i:i + B])
            o = fn(didx, sprof, two, nmask, lengths16[i:i + B], ms_table)
            jax.tree.map(lambda x: x.copy_to_host_async(), o)
            outs.append(o)
        outs = [jax.device_get(o) for o in outs]
        rates.append(n / (time.perf_counter() - t0))
        results = outs
    res = [unpack_result_host(r, cfg.band_width) for r in results]
    cat = lambda f: np.concatenate([np.asarray(getattr(r, f)) for r in res])
    return max(rates), rates, {f: cat(f) for f in
                               ("mapped", "strand", "pos", "mapq", "x0")}, n


def accuracy_split(truth, out, n) -> dict:
    """Overall + unique-subset accuracy. On a repeat-rich reference a read
    from a near-perfect repeat copy legitimately maps to a twin (X0>1,
    MAPQ 0, placement arbitrary per BWA convention) — so the honest
    precision claim is on the X0==1 subset, with the multi-mapped mass
    reported separately, not hidden in 'mismapped'."""
    mapped = out["mapped"][:n]
    ok = (mapped & (out["strand"][:n] == truth.strand[:n])
          & (out["pos"][:n].astype(np.int64) == truth.packed_pos[:n]))
    uniq = mapped & (out["x0"][:n] == 1)
    multi = mapped & ~uniq
    return {
        "sensitivity": round(float(ok.sum() / n), 4),
        "precision": round(float(ok.sum() / max(mapped.sum(), 1)), 4),
        "mapped_frac": round(float(mapped.mean()), 4),
        "multi_mapped_frac": round(float(multi.mean()), 4),
        "unique_frac": round(float(uniq.mean()), 4),
        "sensitivity_unique": round(
            float((ok & uniq).sum() / max(uniq.sum(), 1)), 4),
        "mapq0_frac": round(float((mapped & (out["mapq"][:n] == 0)).mean()),
                            4),
    }


def hbm_footprint(didx, sprof, cfg) -> dict:
    import jax

    resident = int(sum(np.asarray(x).nbytes for x in
                       list(didx) + list(sprof)))
    G = int(didx.ref_seq.shape[0])
    entry = {
        "resident_index_bytes": resident,
        "ref_seq_bytes": int(didx.ref_seq.nbytes),
        "positions_bytes": int(didx.positions.nbytes),
        "bucket_starts_bytes": int(didx.bucket_starts.nbytes),
        "packed_words_live_bytes": 4 * ((G + 9) // 10),  # in-jit temp
    }
    try:
        stats = jax.local_devices()[0].memory_stats()
        if stats:
            entry["device_bytes_in_use"] = int(stats.get("bytes_in_use", 0))
            entry["device_peak_bytes"] = int(
                stats.get("peak_bytes_in_use", 0))
    except Exception:
        pass
    return entry


def e2e_stream(ref, index, cfg, codes, lengths, tmpdir, rounds=3):
    import statistics

    from parasuite_tpu.io.fastq import write_fastq
    from parasuite_tpu.pipeline.align import AlignerEngine
    from parasuite_tpu.pipeline.stream import streaming_align

    n = codes.shape[0]
    fq = Path(tmpdir) / "genome_bench.fastq"
    write_fastq(fq, [f"g{i}" for i in range(n)], np.asarray(codes),
                np.asarray(lengths))
    engine = AlignerEngine(ref, index, cfg)
    rates = []
    for r in range(rounds + 1):
        out = Path(tmpdir) / "genome_bench.sam"
        t0 = time.perf_counter()
        n_rec, _c, _p = streaming_align(engine, fq, out)
        dt = time.perf_counter() - t0
        out.unlink(missing_ok=True)
        Path(str(out) + ".progress.json").unlink(missing_ok=True)
        assert n_rec == n
        if r > 0:
            rates.append(n / dt)
    return statistics.median(rates), rates


def run_world(name, seqs, stats, cfg, n_reads, with_e2e) -> dict:
    import tempfile

    import jax

    from parasuite_tpu.errormodel.scoring import flat_score_tensor
    from parasuite_tpu.index import KmerIndex, PackedReference
    from parasuite_tpu.ops.device_index import DeviceIndex, ScoreParams
    from parasuite_tpu.sim import simulate_reads

    ref = PackedReference.from_dict(seqs, spacer=cfg.chrom_spacer)
    t0 = time.perf_counter()
    index = KmerIndex.build(ref.seq, cfg.kmer_size)
    build_s = time.perf_counter() - t0

    codes, lengths, truth = simulate_reads(ref, n_reads, READ_LEN, cfg,
                                           seed=5, tc_rate=0.12)
    codes, lengths = np.asarray(codes), np.asarray(lengths)

    didx = DeviceIndex.from_host(ref, index)
    sprof = ScoreParams.from_tensor(
        flat_score_tensor(cfg, cfg.max_read_len), cfg)
    best, rates, out_cols, n_timed = device_pass(didx, sprof, cfg, codes,
                                                 lengths)
    entry = {
        "world": name,
        "ref_len": int(ref.total_len),
        "n_chroms": len(ref.names),
        "repeat_fraction": round(stats.repeat_fraction, 4),
        "n_gap_bases": int(stats.n_bases),
        "index_build_seconds": round(build_s, 2),
        "n_reads": int(n_timed),
        "device_reads_per_s": round(best, 0),
        "device_rounds": [round(r, 0) for r in rates],
        **index_census(index, cfg),
        **seed_drop_census(ref, index, truth, lengths, cfg),
        **accuracy_split(truth, out_cols, n_timed),
        **hbm_footprint(didx, sprof, cfg),
    }
    if with_e2e:
        with tempfile.TemporaryDirectory(prefix="parasuite_genome_") as td:
            med, e2e_rounds = e2e_stream(ref, index, cfg, codes, lengths, td)
        entry["e2e_reads_per_s"] = round(med, 0)
        entry["e2e_rounds"] = [round(r, 0) for r in e2e_rounds]
    # free device state before the next (bigger) world loads
    del didx, sprof
    return entry


def main() -> int:
    if os.environ.get("JAX_PLATFORMS") == "cpu":
        import jax

        jax.config.update("jax_platforms", "cpu")
    from parasuite_tpu.sim.genome import chr22_like, multi_chrom

    part = os.environ.get("PARASUITE_GENOME_PART", "ab")
    batch = int(os.environ.get("PARASUITE_BENCH_BATCH", 65536))
    n_reads = max(batch, int(N_READS * min(SCALE * 4, 1.0)))
    cfg = make_cfg(batch)
    worlds = []
    if "a" in part:
        seqs, stats = chr22_like(scale=SCALE)
        worlds.append(run_world("chr22_class_51Mbp", seqs, stats, cfg,
                                n_reads, with_e2e=True))
    if "b" in part:
        seqs, stats = multi_chrom(int(200_000_000 * SCALE), 5)
        worlds.append(run_world(
            "multi_chrom_200Mbp", seqs, stats, cfg, n_reads,
            with_e2e=os.environ.get("PARASUITE_GENOME_E2E") == "1"))
    print(json.dumps({"read_len": READ_LEN, "batch": batch,
                      "scale": SCALE, "worlds": worlds}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
