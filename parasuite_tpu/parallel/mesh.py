"""Device mesh construction (SURVEY.md §2 component 12, §5 backend).

The workload's parallel structure: reads are embarrassingly data-parallel,
the index is replicated (or chromosome-sharded for >int32 genomes —
parallel/shards.py), and the only cross-device traffic is a psum of the tiny
[L, 4, 4] profile count matrix plus final gathers. A 1-D 'data' mesh over all
devices (across hosts via jax.distributed) is therefore the whole story; there is no TP/PP/SP analogue in this non-neural pipeline
(SURVEY.md §2 component 12 spells this out).
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh


def local_device_count() -> int:
    return len(jax.devices())


def make_mesh2(n_data: int, n_index: int, data_axis: str = "data",
               index_axis: str = "index") -> Mesh:
    """2-D mesh: read-batch parallelism x chromosome-sharded index
    (parallel/shards.py). The cards of one host are joined all to all, so
    the layout follows the algorithm alone: index is the minor axis because
    the per-read cross-shard merge all_gathers tiny tuples every batch,
    while the data axis only psums profile matrices at the end."""
    devs = jax.devices()
    need = n_data * n_index
    if need > len(devs):
        raise ValueError(f"mesh {n_data}x{n_index} needs {need} devices, "
                         f"have {len(devs)}")
    arr = np.asarray(devs[:need]).reshape(n_data, n_index)
    return Mesh(arr, (data_axis, index_axis))


def make_mesh(n_devices: int | None = None, axis_name: str = "data") -> Mesh:
    """1-D data-parallel mesh over the first n devices (default: all).

    Multi-process: call jax.distributed.initialize() first; jax.devices()
    then spans every process's devices and the same mesh covers them all.
    """
    devs = jax.devices()
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(f"requested {n_devices} devices, have {len(devs)}")
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis_name,))
