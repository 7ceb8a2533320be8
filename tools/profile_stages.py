"""Stage-level timing of the align pipeline on the current backend.

Usage: python tools/profile_stages.py [n_reads]
Times each pipeline stage separately (jitted, block_until_ready'd) to direct
kernel optimization (SURVEY.md §5 tracing).
"""

import functools
import os
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
from parasuite_tpu.utils.jaxcache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import jax

import bench
from parasuite_tpu.ops import aligner as A
from parasuite_tpu.ops.device_index import min_scores_host
from parasuite_tpu.sim import simulate_reads


def timeit(fn, *args, rounds=5):
    out = fn(*args)
    jax.block_until_ready(out)
    best = 1e9
    for _ in range(rounds):
        t0 = time.perf_counter()
        out = fn(*args)
        jax.block_until_ready(out)
        best = min(best, time.perf_counter() - t0)
    return best, out


def main():
    n_reads = int(sys.argv[1]) if len(sys.argv) > 1 else 4096
    cfg = bench.make_cfg().replace(batch_size=n_reads)
    ref, _index, didx, sprof = bench.build_state(cfg, bench.REF_LEN)
    codes, lengths, _ = simulate_reads(ref, n_reads, bench.READ_LEN, cfg,
                                       seed=2, tc_rate=0.12)
    ms = min_scores_host(lengths, cfg)

    stages = {}

    @jax.jit
    def s_orient(codes, lengths):
        return A.orient_reads(codes, lengths)

    @jax.jit
    def s_seed(oriented, lengths):
        return A.seed_diagonals(oriented, lengths, didx, cfg)

    @jax.jit
    def s_select(diags):
        return A.select_candidates(diags, cfg)

    ext_fn = jax.jit(functools.partial(A.extend_candidates, cfg=cfg))

    @jax.jit
    def s_finalize(oriented, lengths, ms, cand_diag, cand_valid, ext):
        return A.finalize(oriented, lengths, ms, cand_diag, cand_valid,
                          *ext, didx, sprof, cfg)

    stages["orient"], oriented = timeit(s_orient, codes, lengths)
    stages["seed_lookup"], diags = timeit(s_seed, oriented, lengths)
    stages["select"], (cand_diag, cand_valid) = timeit(s_select, diags)
    stages["extend"], ext = timeit(ext_fn, oriented, lengths, cand_diag,
                                   didx, sprof)
    stages["finalize"], _ = timeit(s_finalize, oriented, lengths, ms,
                                   cand_diag, cand_valid, ext)
    full = jax.jit(functools.partial(A.align_batch, cfg=cfg))
    stages["full"], _ = timeit(full, didx, sprof, codes, lengths, ms)

    trace_dir = os.environ.get("PARASUITE_TRACE_DIR")
    if trace_dir:
        # Perfetto/XPlane trace of one full-pipeline step (SURVEY.md §5)
        full = jax.jit(functools.partial(A.align_batch, cfg=cfg))
        with jax.profiler.trace(trace_dir):
            jax.block_until_ready(full(didx, sprof, codes, lengths, ms))
        print(f"trace written to {trace_dir}")

    print(f"backend={jax.default_backend()} reads={n_reads} "
          f"pairs={n_reads * 2 * cfg.max_candidates}")
    for k, v in stages.items():
        print(f"{k:24s}: {v*1e3:8.2f} ms")
    print(f"full throughput         : {n_reads / stages['full']:,.0f} reads/s")


if __name__ == "__main__":
    main()
