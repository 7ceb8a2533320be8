"""Scaling-efficiency measurement (BASELINE.json config 5: reads/s at
1 chip / 1 host / N hosts, efficiency = rps(N) / (N * rps(1))).

Runs the distributed align step (parallel.dist_align) over meshes of
increasing size with a fixed per-device batch (weak scaling — the production
regime for a bounded read-sharding job) and reports a JSON table. Across
processes the same harness runs with jax.distributed initialized by the
caller; on CPU it still exercises the full collective path over virtual
devices.
"""

from __future__ import annotations

import functools
import time

import jax
import numpy as np

from parasuite_tpu.config import AlignConfig
from parasuite_tpu.ops.device_index import min_scores_host
from parasuite_tpu.parallel.dist_align import make_dist_align_step, shard_batch
from parasuite_tpu.parallel.mesh import make_mesh


def measure_scaling(didx, sprof, codes, lengths, cfg: AlignConfig,
                    device_counts: list[int], per_device_reads: int,
                    rounds: int = 3) -> dict:
    """-> {"points": [{n_devices, reads_per_s, efficiency}], ...}.

    codes/lengths must hold at least max(device_counts) * per_device_reads
    reads (weak scaling: every device processes per_device_reads each step).
    """
    ms_all = min_scores_host(lengths, cfg)
    points = []
    base_rps = None
    for n in device_counts:
        mesh = make_mesh(n)
        step = make_dist_align_step(cfg, mesh, with_counts=True)
        n_reads = per_device_reads * n
        c, l, m = shard_batch(codes[:n_reads], lengths[:n_reads],
                              ms_all[:n_reads], n)
        out = step(didx, sprof, c, l, m)
        jax.block_until_ready(out)
        best = 0.0
        for _ in range(rounds):
            t0 = time.perf_counter()
            out = step(didx, sprof, c, l, m)
            jax.block_until_ready(out)
            best = max(best, n_reads / (time.perf_counter() - t0))
        if base_rps is None:
            base_rps = best / n  # per-device at the first (smallest) count
        eff = best / (n * base_rps)
        points.append({"n_devices": n, "reads_per_s": round(best, 1),
                       "per_device": round(best / n, 1),
                       "efficiency": round(eff, 4)})
    return {"mode": "weak", "per_device_reads": per_device_reads,
            "backend": jax.default_backend(),
            "device_kind": jax.devices()[0].device_kind, "points": points}
