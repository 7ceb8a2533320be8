"""Combined genome+transcriptome throughput vs plain mode (VERDICT r3
next-round #1: "record combined STREAMING throughput ... >= 0.5x plain e2e
on the 400-transcript world, median-of-5").

Builds a synthetic exon-dense genome (hundreds of multi-exon transcripts),
simulates reads drawn from BOTH genomic loci and spliced transcripts
(junction-spanning), writes them to a FASTQ, and measures:

  * plain_stream / combined_stream — reads/s through the FULL production
    path (streaming_align: FASTQ -> threaded pipeline -> wire-packed device
    step -> SAM), median of 5 runs after a compile warmup; the headline.
  * loop legs (the round-2 unpacked align_device+to_host micro-loop) are a
    DIAGNOSTIC only, behind PARASUITE_BENCH_LOOP=1: they measure the
    latency of unpipelined calls — never quote them; the default output
    contains no loop numbers.

    timeout 3000 python tools/bench_combined.py [n_reads]
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
GENOME_LEN = int(os.environ.get("PARASUITE_COMBINED_GENOME", 8_000_000))
N_TX = int(os.environ.get("PARASUITE_COMBINED_NTX", 400))


def build_world(cfg):
    from parasuite_tpu.pipeline.combined import CombinedReference, Transcript

    rng = np.random.default_rng(11)
    genome = {"chr1": rng.integers(0, 4, GENOME_LEN).astype(np.int8)}
    txs = []
    for t in range(N_TX):
        # 3-exon transcripts, exons 120-400bp, introns 200-2000bp
        start = int(rng.integers(0, GENOME_LEN - 10_000))
        starts, ends, p = [], [], start
        for _ in range(3):
            e = int(rng.integers(120, 400))
            starts.append(p)
            ends.append(p + e)
            p += e + int(rng.integers(200, 2000))
        txs.append(Transcript(f"t{t}", "chr1", "+" if t % 2 else "-",
                              np.asarray(starts, dtype=np.int64),
                              np.asarray(ends, dtype=np.int64)))
    combined = CombinedReference.build(genome, txs, cfg.chrom_spacer)
    return genome, txs, combined


def make_reads(combined, txs, n_reads, cfg):
    """Half genomic reads, half spliced-transcript reads (many junction-
    spanning), all sampled from the combined packing so both engines see the
    identical read set."""
    rng = np.random.default_rng(12)
    ref = combined.ref
    tx_start = int(ref.starts[1]) if len(ref.names) > 1 else 0
    # genome reads: inside chr1
    g_lo, g_hi = int(ref.starts[0]), int(ref.ends[0]) - READ_LEN
    n_g = n_reads // 2
    gpos = rng.integers(g_lo, g_hi, n_g)
    # transcript reads: uniformly over tx pseudo-chroms
    n_t = n_reads - n_g
    ti = rng.integers(0, len(txs), n_t)
    names = [f"tx::{t.tx_id}" for t in txs]
    name_to_ci = {nm: i for i, nm in enumerate(ref.names)}
    tstart = np.asarray([ref.starts[name_to_ci[nm]] for nm in names])
    tlen = np.asarray([t.spliced_len for t in txs])
    toff = (rng.random(n_t) * np.maximum(tlen[ti] - READ_LEN, 1)).astype(int)
    tpos = tstart[ti] + toff
    pos = np.concatenate([gpos, tpos])
    idx = pos[:, None] + np.arange(READ_LEN)[None, :]
    codes = ref.seq[idx].astype(np.int8)
    # sprinkle T->C conversions like a PAR-CLIP library
    is_t = codes == 3
    conv = is_t & (rng.random(codes.shape) < 0.12)
    codes = np.where(conv, 1, codes).astype(np.int8)
    ok = ~np.any(codes == 4, axis=1)  # drop reads that straddle spacers
    codes = codes[ok]
    # interleave genomic and transcript reads so every device batch sees the
    # mixed workload (unshuffled, batch 0 would be all-genomic and the tail
    # batches all-transcript — unrepresentative wire/entry pressure)
    codes = codes[rng.permutation(codes.shape[0])]
    return codes, np.full(codes.shape[0], READ_LEN, dtype=np.int32)


def time_engine(engine, codes, lengths, batch, label):
    import jax

    from parasuite_tpu.io.batch import ReadBatch

    n = codes.shape[0] - codes.shape[0] % batch

    def mk(i):
        return ReadBatch(codes=codes[i:i + batch],
                         lengths=lengths[i:i + batch])

    # warm up / compile
    jax.block_until_ready(engine.align_device(codes[:batch], lengths[:batch]))
    best = 0.0
    for _ in range(3):
        t0 = time.perf_counter()
        pend = []
        for i in range(0, n, batch):
            pend.append((mk(i), engine.align_device(codes[i:i + batch],
                                                    lengths[i:i + batch])))
            if len(pend) >= 4:
                b, r = pend.pop(0)
                engine.to_host(b, r)
        for b, r in pend:
            engine.to_host(b, r)
        best = max(best, n / (time.perf_counter() - t0))
    return best


def stream_engine(engine, fq_path, workdir, n_reads, rounds=5):
    """Median-of-`rounds` e2e reads/s through streaming_align (the
    production path), after one warmup run that pays the compile."""
    import statistics

    from parasuite_tpu.pipeline.stream import streaming_align

    rates = []
    for r in range(rounds + 1):
        out = Path(workdir) / "bench_out.sam"
        t0 = time.perf_counter()
        n, _, _ = streaming_align(engine, fq_path, out)
        dt = time.perf_counter() - t0
        out.unlink(missing_ok=True)
        Path(str(out) + ".progress.json").unlink(missing_ok=True)
        assert n == n_reads
        if r > 0:  # round 0 is the compile warmup
            rates.append(n / dt)
    return statistics.median(rates), rates


def main() -> int:
    if os.environ.get("JAX_PLATFORMS") == "cpu":
        # honor an explicit CPU request even after jax is imported
        import jax

        jax.config.update("jax_platforms", "cpu")
    import tempfile

    from parasuite_tpu.config import AlignConfig
    from parasuite_tpu.index.kmer import KmerIndex
    from parasuite_tpu.io.fastq import write_fastq
    from parasuite_tpu.pipeline.align import AlignerEngine
    from parasuite_tpu.pipeline.combined import CombinedEngine

    n_reads = int(sys.argv[1]) if len(sys.argv) > 1 else 131072
    batch = int(os.environ.get("PARASUITE_BENCH_BATCH", 16384))
    cfg = AlignConfig(max_read_len=READ_LEN, kmer_size=12, batch_size=batch,
                      max_candidates=8, max_occ=16)
    genome, txs, combined = build_world(cfg)
    codes, lengths = make_reads(combined, txs, n_reads, cfg)
    n_reads = int(codes.shape[0])

    cidx = KmerIndex.build(combined.ref.seq, cfg.kmer_size)
    ceng = CombinedEngine(combined, cidx, cfg)
    gref = ceng.genome_ref
    gidx = KmerIndex.build(gref.seq, cfg.kmer_size)
    geng = AlignerEngine(gref, gidx, cfg)

    with tempfile.TemporaryDirectory() as td:
        fq = Path(td) / "bench_reads.fastq"
        write_fastq(fq, [f"b{i}" for i in range(n_reads)], codes, lengths)

        # wire-entry pressure: how full is the PackedCandidates cap?
        import jax
        pc = jax.device_get(
            ceng.align_device_packed(codes[:batch], lengths[:batch])[1])
        entries_per_read = int(pc.n_sel) / batch

        plain_s, plain_all = stream_engine(geng, fq, td, n_reads)
        comb_s, comb_all = stream_engine(ceng, fq, td, n_reads)

    spread = max(abs(a - b) / min(a, b)
                 for a, b in zip(comb_all, comb_all[1:]))
    out = {
        "n_reads": n_reads, "batch": batch,
        "plain_stream_reads_per_s": round(plain_s, 0),
        "combined_stream_reads_per_s": round(comb_s, 0),
        "combined_stream_frac_of_plain": round(comb_s / plain_s, 3),
        "wire_entries_per_read": round(entries_per_read, 3),
        "wire_cap_per_read": cfg.combined_wire_cap,
        "plain_stream_rounds": [round(r, 0) for r in plain_all],
        "stream_rounds": [round(r, 0) for r in comb_all],
        "max_consecutive_spread": round(spread, 3),
        "n_transcripts": N_TX,
    }
    if os.environ.get("PARASUITE_BENCH_LOOP") == "1":
        # diagnostic only — unpipelined latency probe, not a ratio to
        # quote
        out["diag_plain_loop_reads_per_s"] = round(
            time_engine(geng, codes, lengths, batch, "plain"), 0)
        out["diag_combined_loop_reads_per_s"] = round(
            time_engine(ceng, codes, lengths, batch, "combined"), 0)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
