"""Seed-geometry sweep on the real chip: sensitivity vs reads/s/chip.

For each (max_seeds, seed_stride) candidate, run the bench device loop with
accuracy checking and print one JSON line. Used to pick the operating point
(VERDICT r1 #9: explain/reduce the sensitivity gap).

    timeout 3000 python tools/sweep_seeds.py
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
from parasuite_tpu.utils.jaxcache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import bench

# (max_seeds, seed_stride): 4/12 = today's non-overlapping layout
GRID = [(4, 12), (5, 9), (6, 7), (7, 6)]


def main() -> int:
    base = bench.make_cfg()
    n_reads = 8 * base.batch_size
    for ms, stride in GRID:
        cfg = dataclasses.replace(base, max_seeds=ms, seed_stride=stride)
        state = bench.build_state(cfg, bench.REF_LEN)
        rps, extras, _rounds = bench.run_throughput(cfg, n_reads, cfg.batch_size,
                                           bench.REF_LEN, check_accuracy=True,
                                           state=state)
        print(json.dumps({"max_seeds": ms, "stride": stride,
                          "reads_per_s": round(rps, 0), **extras}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
