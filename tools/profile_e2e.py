"""End-to-end streaming profiler: where does FASTQ->SAM wall time go?

Wraps the stage functions used by pipeline.stream.streaming_align with
accumulating timers and runs a real streaming pass on the current backend.
Per-stage numbers are per-THREAD busy time (the pipeline overlaps stages, so
the slowest stage bounds throughput — not the sum). Run on the GPU:

    timeout 1200 python tools/profile_e2e.py [n_reads]
"""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
from parasuite_tpu.utils.jaxcache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np


class Acc:
    def __init__(self):
        self.t = {}

    def wrap(self, name, fn):
        self.t[name] = 0.0

        def inner(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            self.t[name] += time.perf_counter() - t0
            return out

        return inner


def main() -> int:
    import tempfile

    import jax

    import bench
    from parasuite_tpu.io import fastq as fq
    from parasuite_tpu.io.fastq import write_fastq
    from parasuite_tpu.pipeline import align as palign
    from parasuite_tpu.pipeline.align import AlignerEngine
    from parasuite_tpu.pipeline.stream import streaming_align
    from parasuite_tpu.sim import simulate_reads

    n_reads = int(sys.argv[1]) if len(sys.argv) > 1 else 16 * 32768
    cfg = bench.make_cfg()
    state = bench.build_state(cfg, bench.REF_LEN)
    ref, index, _didx, _sprof = state
    codes, lengths, _ = simulate_reads(ref, n_reads, bench.READ_LEN, cfg,
                                       seed=3, tc_rate=0.12)

    with tempfile.TemporaryDirectory(prefix="ps_e2e_prof_") as td:
        td = Path(td)
        fastq = td / "reads.fastq"
        write_fastq(fastq, [f"r{i}" for i in range(n_reads)],
                    np.asarray(codes), np.asarray(lengths))

        engine = AlignerEngine(ref, index, cfg)
        # warm up the PACKED path streaming_align actually uses (warming the
        # unpacked path leaves the compile inside the timed region)
        jax.block_until_ready(engine.align_device_packed(
            np.asarray(codes[: cfg.batch_size]),
            np.asarray(lengths[: cfg.batch_size])))

        acc = Acc()
        # reader thread
        fq_iter = fq.iter_fastq_batches

        def timed_iter(*a, **kw):
            it = fq_iter(*a, **kw)
            while True:
                t0 = time.perf_counter()
                try:
                    b = next(it)
                except StopIteration:
                    return
                acc.t["reader.next_batch"] = acc.t.get(
                    "reader.next_batch", 0.0) + time.perf_counter() - t0
                yield b

        import parasuite_tpu.pipeline.stream as stream_mod

        stream_mod.iter_fastq_batches = timed_iter
        # main thread
        engine.align_device_packed = acc.wrap("main.dispatch_packed",
                                              engine.align_device_packed)
        engine.to_host = acc.wrap("main.to_host", engine.to_host)
        # writer thread
        engine.emit_sam = acc.wrap("writer.emit_sam", engine.emit_sam)

        # also split to_host: device_get vs host post-processing
        dg = jax.device_get
        acc.t["main.device_get"] = 0.0

        def timed_dg(x):
            t0 = time.perf_counter()
            out = dg(x)
            acc.t["main.device_get"] += time.perf_counter() - t0
            return out

        palign.jax.device_get = timed_dg

        best = None
        for r in range(2):  # round 0 flushes residual compiles; report best
            for v in acc.t:
                acc.t[v] = 0.0
            t0 = time.perf_counter()
            n_rec, _c, _p = streaming_align(engine, fastq,
                                            td / f"out_{r}.sam")
            wall = time.perf_counter() - t0
            if best is None or wall < best[0]:
                best = (wall, dict(acc.t))
        wall, acc.t = best
        palign.jax.device_get = dg
        stream_mod.iter_fastq_batches = fq_iter

        assert n_rec == n_reads
        print(f"reads={n_reads} wall={wall:.3f}s "
              f"e2e={n_reads / wall:,.0f} reads/s")
        for k in sorted(acc.t):
            v = acc.t[k]
            print(f"  {k:24s} {v:7.3f}s  ({v / wall * 100:5.1f}% of wall)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
