"""Real multi-process execution: jax.distributed + in-step collectives.

SURVEY.md §4.4 prescribes "N local processes, jax.distributed.initialize with
local coordinator" as the 2-host test vehicle; BASELINE.json config 5 requires
>=2-host measurement points. parallel/multihost.py simulates hosts with
independent subprocesses and merges count matrices file-side; THIS module is
the genuine article: one SPMD process per host (or per card), a global mesh
over every process's devices, and the error-profile count matrix psum'd
IN-STEP across the 'data' axis (NCCL between GPUs, Gloo on the CPU backend —
tests/test_distributed.py runs 2 real processes and pins the psum'd counts
and merged SAM to the 1-process run).

Lockstep contract: every process must execute the same number of global
steps, so the driver first counts records (one cheap newline pass), derives
the global batch count, and processes past their last local batch feed
all-padding batches (lengths 0 -> zero counts, zero records).

Shard files and .done.json manifests use the same layout as
multihost.run_host_shard, so multihost.merge_host_outputs works unchanged.
"""

from __future__ import annotations

import json
import math
import os
import socket
from pathlib import Path

import numpy as np

from parasuite_tpu.io.batch import ReadBatch
from parasuite_tpu.io.fastq import count_fastq_records, iter_fastq_batches
from parasuite_tpu.parallel.dist_align import make_dist_align_step
from parasuite_tpu.utils.runlog import NULL_LOG


def local_device_ids(coordinator: str, num_processes: int,
                     process_id: int) -> list[int] | None:
    """Card of this process when all processes share this host: process i
    takes GPU i, since a JAX process that saw every card would reserve
    memory on each. None (JAX's default) for one process, the CPU backend,
    a launcher that already pinned CUDA_VISIBLE_DEVICES, or a remote
    coordinator."""
    if (num_processes < 2
            or os.environ.get("JAX_PLATFORMS", "").startswith("cpu")
            or "CUDA_VISIBLE_DEVICES" in os.environ):
        return None
    host = coordinator.rsplit(":", 1)[0]
    if host not in ("localhost", "127.0.0.1", socket.gethostname()):
        return None
    return [process_id]


def initialize(coordinator: str, num_processes: int, process_id: int) -> None:
    """jax.distributed.initialize wrapper (call before any device use)."""
    import jax

    jax.distributed.initialize(
        coordinator_address=coordinator, num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids(coordinator, num_processes,
                                          process_id))


def _local_view(arr) -> np.ndarray:
    """This process's contiguous block of a 'data'-sharded global array."""
    shards = sorted(arr.addressable_shards,
                    key=lambda s: s.index[0].start or 0)
    return np.concatenate([np.asarray(s.data) for s in shards], axis=0)


def _replicated_view(arr) -> np.ndarray:
    return np.asarray(arr.addressable_data(0))


def run_distributed_host(engine, fastq, out_prefix, *,
                         with_profile_counts: bool = True,
                         log=NULL_LOG):
    """One process's share of a jax.distributed multi-host run.

    Requires jax.distributed.initialize() to have been called. Writes this
    process's headerless SAM shard + .done.json (multihost layout) and
    returns (n_records, psum'd counts or None, n_profiled). The counts
    matrix is identical on every process (it is the in-step psum over the
    full mesh), so any one process can save the profile.
    """
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from parasuite_tpu.errormodel.infer import count_indels_from_cigar
    from parasuite_tpu.ops.device_index import min_scores_host
    from parasuite_tpu.parallel.multihost import shard_paths

    nproc = jax.process_count()
    pid = jax.process_index()
    cfg = engine.cfg
    B, L = cfg.batch_size, cfg.max_read_len

    n_total = count_fastq_records(fastq)
    n_batches = max(1, math.ceil(n_total / B))
    n_steps = math.ceil(n_batches / nproc)

    devs = jax.devices()
    if (B * nproc) % len(devs):
        raise ValueError(f"batch_size*n_processes ({B}*{nproc}) must divide "
                         f"by the global device count ({len(devs)})")
    mesh = Mesh(np.asarray(devs), ("data",))
    data_sh = NamedSharding(mesh, P("data"))
    repl_sh = NamedSharding(mesh, P())

    def to_global(x, sharding, gdim0):
        x = np.asarray(x)
        return jax.make_array_from_process_local_data(
            sharding, x, (gdim0, *x.shape[1:]))

    didx_g = jax.tree.map(
        lambda x: to_global(x, repl_sh, np.asarray(x).shape[0]), engine.didx)
    sprof_g = jax.tree.map(
        lambda x: to_global(x, repl_sh, np.asarray(x).shape[0]), engine.sprof)

    # Combined genome+transcriptome engines re-finalize host-side from the
    # per-candidate table (data-sharded alongside the reads) and count
    # profiles from the EMITTED records — no in-step psum (VERDICT r4
    # missing #4: the coordinator path previously rejected combined indexes).
    combined = bool(getattr(engine, "counts_from_host", False))
    step = make_dist_align_step(
        cfg, mesh, with_counts=with_profile_counts and not combined,
        with_candidates=combined)

    shard = shard_paths(out_prefix, nproc)[pid]
    counts = (np.zeros((L, 4, 4), dtype=np.int64)
              if with_profile_counts else None)
    ins = np.zeros(L, dtype=np.int64)
    dels = np.zeros(L, dtype=np.int64)
    gsub = np.zeros((L, 4, 4), dtype=np.int64)  # local gapped M-segment subs
    n_gapped = 0
    n_records = 0
    n_profiled = 0
    batch_records: list[int] = []

    empty = ReadBatch(codes=np.full((B, L), 4, dtype=np.int8),
                      lengths=np.zeros(B, dtype=np.int32))
    # lockstep warmup: every process compiles the step on an all-padding
    # batch so the timed loop below measures the collectives, not the
    # compile (the scaling-efficiency point in tools/bench_distributed.py
    # needs steady-state numbers)
    import time

    jax.block_until_ready(step(
        didx_g, sprof_g,
        to_global(empty.codes, data_sh, B * nproc),
        to_global(empty.lengths, data_sh, B * nproc),
        to_global(min_scores_host(empty.lengths, cfg), data_sh, B * nproc)))
    t0 = time.perf_counter()
    it = iter_fastq_batches(fastq, B, L, stride_shards=nproc, shard_index=pid)
    with open(shard, "wb") as fh:
        class _W:
            def write(self, line):
                fh.write(line.encode("ascii") + b"\n")

            def write_block(self, data):
                fh.write(data if isinstance(data, bytes)
                         else data.encode("ascii"))

        writer = _W()

        def drain(pend):
            """Host half of one step: fetch, finalize, count, emit."""
            nonlocal n_records, n_profiled, n_gapped, counts
            batch, out, real, g = pend
            if combined:
                res, table = out
                if not real:
                    return
                # this process's rows of both data-sharded outputs; to_host
                # projects/re-finalizes them exactly like single-process mode
                local = (type(res)(*[_local_view(x) for x in res]),
                         type(table)(*[_local_view(x) for x in table]))
                host = engine.to_host(batch, local)
                if with_profile_counts:
                    np_inc, ng_inc = engine.accumulate_profile_host(
                        batch, host, counts, ins, dels)
                    n_profiled += np_inc
                    n_gapped += ng_inc
                engine.emit_sam(batch, host, writer)
                n_records += batch.n_real
                batch_records.append(batch.n_real)
                log.event("dist.batch", step=g, reads=batch.n_real,
                          records=n_records)
                return
            res, c = out if with_profile_counts else (out, None)
            if with_profile_counts:
                counts += _replicated_view(c).astype(np.int64)
            # this process's rows of the global sharded AlignResult
            local_res = type(res)(*[_local_view(x) for x in res])
            if not real:
                return
            host = engine.to_host(batch, local_res)
            if with_profile_counts:
                from parasuite_tpu.errormodel.infer import (
                    count_substitutions_from_cigar)
                from parasuite_tpu.utils.dna import revcomp_codes

                n_profiled += int((host.mapped & (batch.lengths > 0)).sum())
                for b in range(batch.n_real):
                    if host.mapped[b] and not host.ug_equal[b]:
                        ln = int(batch.lengths[b])
                        st = int(host.strand[b])
                        count_indels_from_cigar(
                            host.cigars[b], ln, st, ins, dels)
                        # gapped substitution counts are LOCAL host work —
                        # the in-step psum carries only the device's
                        # ungapped matrix, so they ride the per-shard indels
                        # file (merge_host_outputs sums them), NOT `counts`
                        # (which is global and saved by process 0 alone)
                        oriented = (batch.codes[b, :ln] if st == 0 else
                                    revcomp_codes(batch.codes[b, :ln]))
                        count_substitutions_from_cigar(
                            engine.sam_ref.seq, int(host.pos[b]), oriented,
                            ln, st, host.cigars[b], gsub)
                        n_gapped += 1
                # ungapped rescued rows (config.rescue_kmer) are local host
                # work outside the in-step psum, like the gapped subs above
                r_rows = getattr(engine, "last_rescue_rows", None)
                if r_rows is not None:
                    for b in r_rows:
                        b = int(b)
                        if host.mapped[b] and host.ug_equal[b]:
                            ln = int(batch.lengths[b])
                            st = int(host.strand[b])
                            oriented = (batch.codes[b, :ln] if st == 0 else
                                        revcomp_codes(batch.codes[b, :ln]))
                            count_substitutions_from_cigar(
                                engine.sam_ref.seq, int(host.pos[b]),
                                oriented, ln, st, host.cigars[b], gsub)
            engine.emit_sam(batch, host, writer)
            n_records += batch.n_real
            batch_records.append(batch.n_real)
            log.event("dist.batch", step=g, reads=batch.n_real,
                      records=n_records)

        # double-buffered loop: dispatch step g+1 before draining step g so
        # the host half (to_host/emit_sam/counts) overlaps the device step —
        # dispatch order stays identical on every process (lockstep
        # collectives contract), only the host work shifts one step later
        pend = None
        for _g in range(n_steps):
            batch = next(it, None)
            real = batch is not None
            if not real:
                batch = empty
            codes_g = to_global(batch.codes, data_sh, B * nproc)
            lens_g = to_global(batch.lengths, data_sh, B * nproc)
            ms_g = to_global(min_scores_host(batch.lengths, cfg), data_sh,
                             B * nproc)
            out = step(didx_g, sprof_g, codes_g, lens_g, ms_g)
            if pend is not None:
                drain(pend)
            pend = (batch, out, real, _g)
        if pend is not None:
            drain(pend)

    if with_profile_counts:
        if combined:
            # combined counts are LOCAL (accumulated from this shard's
            # emitted records, gapped subs already folded in): every shard
            # saves its own matrix and merge_host_outputs sums them —
            # exactly the file-side multihost layout
            np.save(shard + ".counts.npy", counts)
            np.savez(shard + ".indels.npz", ins=ins, dels=dels,
                     n_gapped=np.int64(n_gapped))
        else:
            # the in-step psum already folded every process's contribution,
            # so the matrix is GLOBAL and identical on all processes: only
            # process 0 saves it (multihost.merge_host_outputs sums whatever
            # shard count files exist — a per-shard copy would overcount
            # x nproc). Indel counts come from LOCAL host tracebacks, so
            # every shard saves its own and the merge sums them.
            if pid == 0:
                np.save(shard + ".counts.npy", counts)
            # returned counts = the global psum'd ungapped matrix; each
            # shard's local gapped contributions live in its indels file
            # until the merge
            np.savez(shard + ".indels.npz", ins=ins, dels=dels,
                     n_gapped=np.int64(n_gapped), gsub=gsub)
    elapsed = time.perf_counter() - t0
    Path(shard + ".done.json").write_text(json.dumps(
        {"records": n_records, "profiled": n_profiled,
         "batch_records": batch_records}))
    log.event("dist.done", records=n_records, steps=n_steps,
              seconds=round(elapsed, 3))
    return n_records, counts, n_profiled, elapsed
