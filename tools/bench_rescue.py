"""Two-tier seeding rescue measurement at 36 bp (VERDICT r4 weak #5 /
next-round #8): the iid-conversion stress model at L=36 measured 0.9771
sensitivity in the round-4 length sweep against a measured seeding-information
ceiling of 0.9898 (1.02% of reads have no error-free 12-mer). This bench
answers: does config.rescue_kmer=10 recover that tail, and at what e2e
cost? Done criterion: >=0.985 at <10% e2e cost, or a committed negative
result.

    timeout 3600 python tools/bench_rescue.py
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
from parasuite_tpu.utils.jaxcache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np

import bench

READ_LEN = 36
RESCUE_K = int(os.environ.get("PARASUITE_RESCUE_K", 10))


def engine_accuracy(engine, codes, lengths, truth):
    from parasuite_tpu.io.batch import ReadBatch

    B = engine.cfg.batch_size
    n = codes.shape[0] - codes.shape[0] % B
    mapped, strand, pos = [], [], []
    for i in range(0, n, B):
        b = ReadBatch(codes=codes[i:i + B], lengths=lengths[i:i + B])
        host = engine.to_host(b, engine.align_device_packed(b.codes,
                                                            b.lengths))
        mapped.append(host.mapped)
        strand.append(host.strand)
        pos.append(host.pos)
    mapped = np.concatenate(mapped)[:n]
    strand = np.concatenate(strand)[:n]
    pos = np.concatenate(pos)[:n].astype(np.int64)
    ok = (mapped & (strand == truth.strand[:n])
          & (pos == truth.packed_pos[:n]))
    return {"sensitivity": round(float(ok.sum() / n), 4),
            "precision": round(float(ok.sum() / max(mapped.sum(), 1)), 4),
            "mapped_frac": round(float(mapped.mean()), 4)}, n


def stream_rate(engine, fq, n_reads, td, rounds=3):
    from parasuite_tpu.pipeline.stream import streaming_align

    rates = []
    for r in range(rounds + 1):
        out = Path(td) / "rescue_out.sam"
        t0 = time.perf_counter()
        n_rec, _c, _p = streaming_align(engine, fq, out)
        dt = time.perf_counter() - t0
        out.unlink(missing_ok=True)
        Path(str(out) + ".progress.json").unlink(missing_ok=True)
        assert n_rec == n_reads
        if r > 0:
            rates.append(n_reads / dt)
    return statistics.median(rates), rates


def main() -> int:
    if os.environ.get("JAX_PLATFORMS") == "cpu":
        import jax

        jax.config.update("jax_platforms", "cpu")
    from parasuite_tpu.io.fastq import write_fastq
    from parasuite_tpu.pipeline.align import AlignerEngine
    from parasuite_tpu.sim import simulate_reads

    base = bench.make_cfg()
    cfg_off = base.replace(max_read_len=READ_LEN)
    cfg_on = cfg_off.replace(rescue_kmer=RESCUE_K)
    n_reads = int(os.environ.get("PARASUITE_RESCUE_READS",
                                 8 * base.batch_size))

    ref, index, _didx, _sprof = bench.build_state(cfg_off, bench.REF_LEN)
    # the SWEEP_LENGTHS iid stress model: every T converts i.i.d. at 12%
    codes, lengths, truth = simulate_reads(ref, n_reads, READ_LEN, cfg_off,
                                           seed=2, tc_rate=0.12)
    codes, lengths = np.asarray(codes), np.asarray(lengths)

    eng_off = AlignerEngine(ref, index, cfg_off)
    eng_on = AlignerEngine(ref, index, cfg_on)

    acc_off, n = engine_accuracy(eng_off, codes, lengths, truth)
    acc_on, _ = engine_accuracy(eng_on, codes, lengths, truth)
    rescued_acc_pass = eng_on.rescue_mapped  # before the streaming rounds
    overflow_acc_pass = eng_on.rescue_overflow

    with tempfile.TemporaryDirectory(prefix="parasuite_rescue_") as td:
        fq = Path(td) / "rescue.fastq"
        write_fastq(fq, [f"r{i}" for i in range(codes.shape[0])], codes,
                    lengths)
        e2e_off, r_off = stream_rate(eng_off, fq, codes.shape[0], td)
        e2e_on, r_on = stream_rate(eng_on, fq, codes.shape[0], td)

    cost = 1.0 - e2e_on / e2e_off
    print(json.dumps({
        "read_len": READ_LEN, "rescue_kmer": RESCUE_K, "n_reads": n,
        "model": "iid conversions tc=0.12 (stress model)",
        "seeding_ceiling_r04": 0.9898,
        "off": acc_off, "on": acc_on,
        "rescued_reads": rescued_acc_pass,
        "rescue_overflow": overflow_acc_pass,
        "e2e_off_reads_per_s": round(e2e_off, 0),
        "e2e_on_reads_per_s": round(e2e_on, 0),
        "e2e_rounds_off": [round(x, 0) for x in r_off],
        "e2e_rounds_on": [round(x, 0) for x in r_on],
        "e2e_cost_frac": round(cost, 4),
        "meets_bar": bool(acc_on["sensitivity"] >= 0.985 and cost < 0.10),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
