"""Production-flow sensitivity: flat pass 1 vs profile-aware pass 2.

The bench's recorded sensitivity is a PASS-1 number (flat scoring), which
prices T->C conversions like any mismatch — but the entire point of the
reference pipeline is that pass 2 rescores with the learned profile
(BASELINE configs 1+2 composed). This tool measures both on the same
simulated truth so the sensitivity operating-point decision (VERDICT r2
missing #5) is made on the production number, and sweeps seed geometries
including a k=11 full-coverage layout:

    timeout 3000 python tools/sweep_twopass.py
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
from parasuite_tpu.utils.jaxcache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import bench

# (kmer_size, max_seeds, seed_stride); (12, 4, 12) = today's default layout.
# k=11 @ stride 13: seeds at 0/13/26/39 cover bases 0..49 — every base of a
# 50bp read sits in exactly one seed, and a shorter k survives more errors.
GRID = [(12, 4, 12), (11, 4, 13), (12, 7, 6)]


def main() -> int:
    import jax

    from parasuite_tpu.benchkit import evaluate_against_truth
    from parasuite_tpu.errormodel.infer import ErrorProfile, counts_to_profile
    from parasuite_tpu.errormodel.scoring import flat_score_tensor
    from parasuite_tpu.ops.aligner import (align_batch_packed,
                                           min_score_table, pack_codes_host,
                                           unpack_result_host)
    from parasuite_tpu.ops.device_index import ScoreParams
    from parasuite_tpu.sim import simulate_reads

    base = bench.make_cfg()
    n_reads = 8 * base.batch_size
    for k, ms, stride in GRID:
        cfg = dataclasses.replace(base, kmer_size=k, max_seeds=ms,
                                  seed_stride=stride)
        ref, _index, didx, sprof_flat = bench.build_state(cfg, bench.REF_LEN)
        codes, lengths, truth = simulate_reads(ref, n_reads, bench.READ_LEN,
                                               cfg, seed=2, tc_rate=0.12)
        lengths16 = lengths.astype(np.uint16)
        ms_table = jax.device_put(min_score_table(cfg))
        fn = jax.jit(functools.partial(align_batch_packed, cfg=cfg),
                     static_argnames=("with_counts",))

        def run_pass(sprof, with_counts):
            outs = []
            csum = None
            for i in range(0, n_reads, cfg.batch_size):
                two, nm = pack_codes_host(codes[i:i + cfg.batch_size])
                o = fn(didx, sprof, two, nm, lengths16[i:i + cfg.batch_size],
                       ms_table, with_counts=with_counts)
                if with_counts:
                    o, c = o
                    csum = c if csum is None else csum + c
                outs.append(unpack_result_host(jax.device_get(o),
                                               cfg.band_width))
            cat = lambda f: np.concatenate([np.asarray(getattr(r, f))
                                            for r in outs])
            rep = evaluate_against_truth(truth, cat("mapped"), cat("strand"),
                                         cat("pos"))
            n_prof = int(cat("mapped").sum())
            return rep, (np.asarray(csum) if csum is not None else None), n_prof

        rep1, counts, n_prof = run_pass(sprof_flat, True)
        profile = ErrorProfile(counts=counts.astype(np.int64),
                               n_reads=n_prof)
        sprof_learned = ScoreParams.from_tensor(
            counts_to_profile(profile, cfg), cfg)
        rep2, _c, _n = run_pass(sprof_learned, False)
        print(json.dumps({
            "kmer_size": k, "max_seeds": ms, "stride": stride,
            "pass1_sensitivity": round(rep1.sensitivity, 4),
            "pass1_unmapped": rep1.n_reads - rep1.n_mapped,
            "pass1_mismapped": rep1.n_mapped - rep1.n_correct,
            "pass2_sensitivity": round(rep2.sensitivity, 4),
            "pass2_unmapped": rep2.n_reads - rep2.n_mapped,
            "pass2_mismapped": rep2.n_mapped - rep2.n_correct,
            "precision2": round(rep2.precision, 4),
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
