"""Benchmark driver: reads/s/chip on 50bp PAR-CLIP reads (BASELINE.json:metric).

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...extras}.

vs_baseline semantics: BASELINE.md's north star is >=10x reads/s over the
reference CPU aligner; the reference binary is unavailable in this
environment (empty mount — BASELINE.md provenance note), so the denominator
is 10x the throughput of THIS engine's identical algorithm on the CPU XLA
backend (all host cores, measured in a subprocess each run).
vs_baseline >= 1.0 therefore means "at least 10x a full-machine CPU run of
the same pipeline". Replace with the real reference number per SURVEY.md §8.4
once the mount appears.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

# benchmark scale (uniform random synthetic reference; deterministic);
# batch size is overridable for tuning (PARASUITE_BENCH_BATCH).
REF_LEN = 20_000_000
READ_LEN = 50
BATCH_GPU = int(os.environ.get("PARASUITE_BENCH_BATCH", 65536))
N_READS_GPU = 16 * BATCH_GPU
# CPU leg: 4096 reads x 3 best-of rounds
N_READS_CPU = 4096
BATCH_CPU = 1024
TIMED_ROUNDS = 3
E2E_ROUNDS = 5


def build_state(cfg, ref_len, seed=1):
    from parasuite_tpu.errormodel.scoring import flat_score_tensor
    from parasuite_tpu.index import KmerIndex, PackedReference
    from parasuite_tpu.ops.device_index import DeviceIndex, ScoreParams

    rng = np.random.default_rng(seed)
    seqs = {"chr_bench": rng.integers(0, 4, ref_len).astype(np.int8)}
    ref = PackedReference.from_dict(seqs, spacer=cfg.chrom_spacer)
    index = KmerIndex.build(ref.seq, cfg.kmer_size)
    return ref, index, DeviceIndex.from_host(ref, index), ScoreParams.from_tensor(
        flat_score_tensor(cfg, cfg.max_read_len), cfg)


def run_throughput(cfg, n_reads, batch_size, ref_len, check_accuracy=False,
                   state=None, read_len=READ_LEN):
    import functools

    import jax

    from parasuite_tpu.ops.aligner import (align_batch_packed,
                                           min_score_table, pack_codes_host,
                                           unpack_result_host)
    from parasuite_tpu.sim import simulate_reads

    ref, _index, didx, sprof = state if state else build_state(cfg, ref_len)
    codes, lengths, truth = simulate_reads(ref, n_reads, read_len, cfg,
                                           seed=2, tc_rate=0.12)
    lengths16 = lengths.astype(np.uint16)
    ms_table = jax.device_put(min_score_table(cfg))
    # wire-packed step (2-bit codes + N mask up, PackedResult v2 down);
    # host packing is INSIDE the timed loop — it is part of the per-batch
    # cost
    fn = jax.jit(functools.partial(align_batch_packed, cfg=cfg))

    wt, wn = pack_codes_host(codes[:batch_size])   # compile + warm up
    jax.block_until_ready(fn(didx, sprof, wt, wn, lengths16[:batch_size],
                             ms_table))

    rates = []
    results = None
    for _round in range(TIMED_ROUNDS):
        t0 = time.perf_counter()
        outs = []
        for i in range(0, n_reads, batch_size):
            two, nmask = pack_codes_host(codes[i:i + batch_size])
            o = fn(didx, sprof, two, nmask,
                   lengths16[i:i + batch_size], ms_table)
            # start the device->host copy now so downloads of batch k
            # overlap uploads/compute of batch k+1
            jax.tree.map(lambda x: x.copy_to_host_async(), o)
            outs.append(o)
        jax.block_until_ready(outs)
        outs = [jax.device_get(o) for o in outs]
        dt = time.perf_counter() - t0
        rates.append(n_reads / dt)
        results = outs
    best = max(rates)
    extras = {}
    if check_accuracy:
        from parasuite_tpu.benchkit import evaluate_against_truth

        results = [unpack_result_host(r, cfg.band_width) for r in results]
        mapped = np.concatenate([np.asarray(r.mapped) for r in results])
        strand = np.concatenate([np.asarray(r.strand) for r in results])
        pos = np.concatenate([np.asarray(r.pos) for r in results])
        rep = evaluate_against_truth(truth, mapped, strand, pos)
        # attribution split (VERDICT r1 weak #8): a sensitivity gap is either
        # reads the engine dropped (unmapped) or placed wrong (mismapped)
        extras = {"sensitivity": round(rep.sensitivity, 4),
                  "precision": round(rep.precision, 4),
                  "n_unmapped": rep.n_reads - rep.n_mapped,
                  "n_mismapped": rep.n_mapped - rep.n_correct}
    return best, extras, rates


def run_end_to_end(cfg, state, n_reads, tmpdir):
    """FASTQ-file-in, SAM-file-out throughput through pipeline.streaming_align
    (host I/O + tracebacks + SAM formatting included — the number that was
    missing from round 1's device-only headline; VERDICT r1 missing #4)."""
    import jax

    from parasuite_tpu.io.fastq import write_fastq
    from parasuite_tpu.pipeline.align import AlignerEngine
    from parasuite_tpu.pipeline.stream import streaming_align
    from parasuite_tpu.sim import simulate_reads

    ref, index, _didx, _sprof = state
    codes, lengths, _truth = simulate_reads(ref, n_reads, READ_LEN, cfg,
                                            seed=3, tc_rate=0.12)
    fastq = tmpdir / "bench_e2e.fastq"
    write_fastq(fastq, [f"r{i}" for i in range(n_reads)],
                np.asarray(codes), np.asarray(lengths))

    engine = AlignerEngine(ref, index, cfg)
    # compile + warmup outside the timed region. streaming_align takes the
    # PACKED step (supports_packed) — warming the unpacked align_device left
    # the packed compile/cache-load inside round 0's timed region and made
    # the recorded number a coin flip (VERDICT r2 weak #1); warm what runs.
    wcodes = np.asarray(codes[:cfg.batch_size])
    wlens = np.asarray(lengths[:cfg.batch_size])
    if engine.supports_packed:
        jax.block_until_ready(engine.align_device_packed(wcodes, wlens))
    else:
        jax.block_until_ready(engine.align_device(wcodes, wlens))

    rates = []
    for _round in range(E2E_ROUNDS):
        out_sam = tmpdir / f"bench_e2e_{_round}.sam"
        t0 = time.perf_counter()
        n_rec, _counts, _np_ = streaming_align(engine, fastq, out_sam)
        dt = time.perf_counter() - t0
        assert n_rec == n_reads
        rates.append(n_reads / dt)
    raw = list(rates)
    rates.sort()
    median = rates[len(rates) // 2]
    return max(rates), median, raw


def cpu_subprocess_throughput() -> float:
    """Measure the same pipeline on the CPU XLA backend in a subprocess
    that sees no GPU (the parent holds the card)."""
    code = (
        "import os,sys,json\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "os.environ['JAX_PLATFORMS']='cpu'\n"
        "import bench\n"
        "cfg = bench.make_cfg()\n"
        f"r,_,_ = bench.run_throughput(cfg, {N_READS_CPU}, {BATCH_CPU}, "
        f"{REF_LEN})\n"
        "print(json.dumps({'cpu_reads_per_s': r}))\n"
    )
    env = {k: v for k, v in os.environ.items()}
    env["JAX_PLATFORMS"] = "cpu"
    env["CUDA_VISIBLE_DEVICES"] = ""
    env["PYTHONPATH"] = str(REPO)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=1800)
    if p.returncode != 0:
        sys.stderr.write("cpu leg failed:\n" + p.stderr[-2000:] + "\n")
        return 0.0
    return float(json.loads(p.stdout.strip().splitlines()[-1])["cpu_reads_per_s"])


def make_cfg():
    from parasuite_tpu.config import AlignConfig

    # max_occ=16: on this 20Mbp reference P(bucket count > 16) ~ 2e-14 for
    # k=12, so results are identical to max_occ=32 with half the seeding
    # position gathers; sensitivity is re-verified against simulation truth
    # on every bench run. Seed geometry inherits the decided 7/6 operating
    # point (config.py / BASELINE.md "Sensitivity operating point").
    return AlignConfig(max_read_len=READ_LEN, kmer_size=12, batch_size=BATCH_GPU,
                       max_candidates=8, max_occ=16)


def device_fields() -> dict:
    """Platform, device kind and count as JAX reports them, and the card's
    nvidia-smi name and power limit; exits when JAX found no GPU."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"bench.py measures a GPU; JAX found "
                         f"{devs[0].platform}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    return {"platform": devs[0].platform, "device_kind": devs[0].device_kind,
            "device_count": len(devs), "card": smi[0] if smi else None}


def main() -> int:
    import tempfile

    from parasuite_tpu.utils.jaxcache import enable_compile_cache

    enable_compile_cache()
    device = device_fields()
    cfg = make_cfg()
    state = build_state(cfg, REF_LEN)

    def spread_of(rates):
        return (max(rates) - min(rates)) / min(rates)

    # Variance guard: record every raw round; when the device best-of-N
    # spread exceeds 15% or e2e lands ABOVE the device-only loop (physically
    # incoherent), re-run the device leg once and judge on the fresh rounds.
    dev_rps, extras, dev_rounds = run_throughput(
        cfg, N_READS_GPU, BATCH_GPU, REF_LEN, check_accuracy=True,
        state=state)
    with tempfile.TemporaryDirectory(prefix="parasuite_bench_") as td:
        e2e_rps, e2e_med, e2e_rounds = run_end_to_end(cfg, state, N_READS_GPU,
                                                      Path(td))
    dev_spread = spread_of(dev_rounds)
    rerun = dev_spread > 0.15 or e2e_med > max(dev_rounds)
    if rerun:
        rps2, _ex2, rounds2 = run_throughput(
            cfg, N_READS_GPU, BATCH_GPU, REF_LEN, state=state)
        dev_rounds = dev_rounds + rounds2
        dev_rps = max(dev_rps, rps2)
        dev_spread = spread_of(rounds2)  # judge variance on the fresh run
    suspect = dev_spread > 0.15 or e2e_med > dev_rps

    cpu_rps = cpu_subprocess_throughput()
    denom = 10.0 * cpu_rps if cpu_rps > 0 else float("nan")
    out = {
        "metric": "reads_per_second_per_chip",
        "value": round(dev_rps, 1),
        "unit": "reads/s/chip (50bp PAR-CLIP, 20Mbp ref)",
        **device,
        "vs_baseline": round(dev_rps / denom, 3) if denom == denom else None,
        "vs_baseline_e2e": (round(e2e_med / denom, 3)
                            if denom == denom else None),
        "end_to_end_reads_per_s": round(e2e_med, 1),
        "e2e_best_reads_per_s": round(e2e_rps, 1),
        "e2e_frac": round(e2e_med / dev_rps, 3),
        "cpu_reads_per_s": round(cpu_rps, 1),
        "device_rounds": [round(r, 1) for r in dev_rounds],
        "device_spread": round(dev_spread, 3),
        "e2e_rounds": [round(r, 1) for r in e2e_rounds],
        "e2e_spread": round(spread_of(e2e_rounds), 3),
        "rerun_triggered": rerun,
        "suspect": suspect,
        "baseline_note": "vs_baseline = gpu/(10x same-pipeline CPU backend); "
                         "reference binary unavailable (BASELINE.md); "
                         "end_to_end = FASTQ->SAM through streaming_align, "
                         f"median of {E2E_ROUNDS} runs; suspect=true means "
                         "device spread >15% or e2e>device even after one "
                         "re-run — treat the capture as noisy",
        **extras,
    }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
