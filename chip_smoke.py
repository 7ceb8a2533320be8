"""Smoke run of the PAR-CLIP pipeline on one NVIDIA GPU, at full size.

    python chip_smoke.py               # one card: the main path (below)
    python chip_smoke.py --four-cards  # four cards: the multi-card paths only

The main path is what users run, in ONE process through cli.main so that
compiles are shared and only one process holds the card:

  0. the `gpu`-marked pytest tests, in a child process, before this process
     imports JAX (the step as compiled for the card vs the numpy oracle at
     L in {36, 50, 100});
  1. index:    sim.genome.chr22_like() (51 Mbp, repeat-structured) as FASTA
               -> `cli index --kmer-size 13`;
  2. simulate: `cli simulate`, 1,048,576 reads of 50 bp, fixed seed;
  3. twopass:  `cli twopass` -> BAM, batch 65,536 (the hot path:
               streaming_align -> align_batch_packed -> banded DP, with the
               profile counts fused into pass 1);
  4. sort + cluster: `cli sort --min-mapq 1`, `cli cluster`;
  5. checks:   sensitivity/precision against the simulation truth, and
               bit-exact parity of every oracle field with the numpy oracle
               (oracle/align.py) on 4,096 reads of the run's FASTQ. Scoring
               is int32 and no matrix product is on the device path, so the
               tolerance is zero and TF32 cannot arise;
  6. device step: align_batch_packed alone, warm, median of 7 timed calls
               ending in block_until_ready, with its memory_analysis(),
               peak_bytes_in_use and the select/extend shares of a trace.

Every number is printed beside the card's `nvidia-smi` name and power
limit. The last line of stdout is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
Without a GPU the script exits non-zero before printing it.

Each phase is a function of its sizes, so tests/test_chip_smoke.py can
drive it on the CPU at tiny size. No phase runs a hand-written kernel:
every device operation is XLA's.
Work files go to <repo>/.smoke/ (git-ignored) and are removed at the end.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import socket
import statistics
import struct
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
WORK = REPO / ".smoke"

SCALE = 1.0            # chr22_like scale: 51 Mbp
KMER = 13              # k-rule for <= ~200 Mbp (README)
N_READS = 1 << 20
READ_LEN = 50
BATCH = 65536
SEED = 7
N_ORACLE = 4096
TIMED_CALLS = 7


def log(msg: str) -> None:
    print(msg, flush=True)


def card_label() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` of the first card, or ''
    when there is none (asks no JAX)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return ""
    lines = [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]
    return lines[0] if out.returncode == 0 and lines else ""


def cfg_flags(batch: int, read_len: int, k: int) -> list[str]:
    return ["--kmer-size", str(k), "--batch-size", str(batch),
            "--max-read-len", str(read_len)]


def cli(*argv) -> dict:
    """Run one CLI tool in this process; -> its JSON summary line."""
    import contextlib
    import io

    from parasuite_tpu import cli as _cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = _cli.main([str(a) for a in argv])
    if rc != 0:
        raise RuntimeError(f"cli {argv[0]} exited {rc}")
    return json.loads(buf.getvalue().strip().splitlines()[-1])


# ---------------------------------------------------------------------------
# phase 0: chip-marked tests, in a child, before this process imports JAX
# ---------------------------------------------------------------------------

def gpu_tests(work: Path, timeout: int = 900) -> dict:
    """`pytest -m gpu` in a child process; every selected test must pass
    (a skip means the child found no GPU)."""
    xml = work / "gpu_tests.xml"
    env = dict(os.environ, PARASUITE_TEST_GPU="1",
               PYTHONPATH=str(REPO))
    p = subprocess.run(
        [sys.executable, "-m", "pytest", str(REPO / "tests"), "-q", "-m",
         "gpu", "-p", "no:cacheprovider", f"--junitxml={xml}"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=timeout)
    import xml.etree.ElementTree as ET

    suite = ET.parse(xml).getroot()
    suite = suite if suite.tag == "testsuite" else suite.find("testsuite")
    n = {k: int(suite.get(k, 0)) for k in ("tests", "failures", "errors",
                                           "skipped")}
    ok = (p.returncode == 0 and n["tests"] > 0 and n["skipped"] == 0
          and n["failures"] == 0 and n["errors"] == 0)
    if not ok:
        log(p.stdout[-4000:] + p.stderr[-4000:])
    return {"ok": ok, **n}


# ---------------------------------------------------------------------------
# phases 1-4: the CLI pipeline
# ---------------------------------------------------------------------------

def build_reference(work: Path, scale: float, k: int) -> dict:
    from parasuite_tpu.io.fasta import write_fasta
    from parasuite_tpu.sim.genome import chr22_like

    t0 = time.perf_counter()
    seqs, _stats = chr22_like(scale=scale)
    write_fasta(work / "ref.fa", seqs)
    t1 = time.perf_counter()
    out = cli("index", work / "ref.fa", work / "idx", "--kmer-size", k)
    return {"synth_s": t1 - t0, "index_s": time.perf_counter() - t1,
            "packed_len": out["packed_len"]}


def simulate(work: Path, n_reads: int, read_len: int, seed: int) -> dict:
    t0 = time.perf_counter()
    out = cli("simulate", work / "idx", work / "reads.fastq",
              "--n-reads", n_reads, "--read-len", read_len, "--seed", seed)
    return {"reads": out["reads"], "simulate_s": time.perf_counter() - t0}


def twopass(work: Path, batch: int, read_len: int, k: int,
            tag: str = "out") -> dict:
    """`cli twopass` to BAM. Per-pass reads/s on the host clock from the
    run log: whole pass (its compile included), and steady state between
    the first and last batch it wrote."""
    logf = work / f"{tag}.log.jsonl"
    logf.unlink(missing_ok=True)
    t0 = time.perf_counter()
    out = cli("twopass", work / "idx", work / "reads.fastq",
              work / f"{tag}.bam", "--log", logf, "--pg-cl", "smoke",
              *cfg_flags(batch, read_len, k))
    res = {"reads": out["reads"], "wall_s": time.perf_counter() - t0}
    ev = [json.loads(x) for x in logf.read_text().splitlines()]
    cut = next(i for i, e in enumerate(ev) if e["stage"] == "twopass.profile")
    for name, part, start in (("pass1", ev[:cut], 0.0),
                              ("pass2", ev[cut:], ev[cut]["ts"])):
        ts = [e["ts"] for e in part if e["stage"] == "align.batch"]
        reads = [e["reads"] for e in part if e["stage"] == "align.batch"]
        done = next(e["ts"] for e in part if e["stage"] == "align.done")
        res[f"{name}_reads_per_s"] = sum(reads) / max(done - start, 1e-9)
        res[f"{name}_steady_reads_per_s"] = (
            sum(reads[1:]) / max(ts[-1] - ts[0], 1e-9) if len(ts) > 1
            else None)
    return res


def sort_and_cluster(work: Path, tag: str = "out") -> dict:
    t0 = time.perf_counter()
    s = cli("sort", work / f"{tag}.bam", work / f"{tag}.sorted.bam",
            "--min-mapq", 1)
    t1 = time.perf_counter()
    c = cli("cluster", work / "idx", work / f"{tag}.sorted.bam",
            work / f"{tag}.clusters.tsv")
    return {"sorted_records": s["records"], "sort_s": t1 - t0,
            "clusters": c["clusters"], "cluster_s": time.perf_counter() - t1}


# ---------------------------------------------------------------------------
# phase 5: correctness
# ---------------------------------------------------------------------------

def bam_columns(bam_path) -> tuple:
    """-> (names, mapped, strand, ref_id, pos0) per record, file order."""
    import numpy as np

    from parasuite_tpu.io.bam import iter_bam_records

    _t, _names, _lens, recs = iter_bam_records(bam_path)
    names, flag, rid, pos = [], [], [], []
    for body in recs:
        r, p, l_name = struct.unpack_from("<iiB", body, 0)
        names.append(body[32:32 + l_name - 1].decode())
        flag.append(struct.unpack_from("<H", body, 14)[0])
        rid.append(r)
        pos.append(p)
    flag = np.asarray(flag)
    return (names, (flag & 4) == 0, ((flag & 16) != 0).astype(np.int8),
            np.asarray(rid), np.asarray(pos, dtype=np.int64))


def accuracy(work: Path, tag: str = "out") -> dict:
    """Sensitivity/precision of the final BAM against the truth that the
    simulator wrote into every read name."""
    import numpy as np

    from parasuite_tpu.benchkit import evaluate_against_truth
    from parasuite_tpu.index import PackedReference
    from parasuite_tpu.sim.generate import SimTruth

    ref = PackedReference.load(work / "idx")
    names, mapped, strand, rid, pos = bam_columns(work / f"{tag}.bam")
    t = np.asarray([SimTruth.parse_name(n) for n in names], dtype=np.int64)
    starts = np.asarray(ref.starts, dtype=np.int64)
    truth = SimTruth(packed_pos=starts[t[:, 0]] + t[:, 1],
                     chrom_idx=t[:, 0].astype(np.int32), local_pos=t[:, 1],
                     strand=t[:, 2].astype(np.int8),
                     n_conversions=np.zeros(len(t), np.int32),
                     n_errors=np.zeros(len(t), np.int32))
    packed = np.where(mapped, starts[np.clip(rid, 0, None)] + pos, -1)
    rep = evaluate_against_truth(truth, mapped, strand, packed)
    return {"reads": rep.n_reads, "sensitivity": rep.sensitivity,
            "precision": rep.precision}


def _oracle_chunk(args) -> list:
    """Worker: oracle alignments for one chunk of reads (numpy only)."""
    prefix, codes, lengths, s_tensor, cfg_json = args
    from parasuite_tpu.config import AlignConfig
    from parasuite_tpu.index import KmerIndex, PackedReference
    from parasuite_tpu.oracle import align_batch_oracle

    cfg = AlignConfig.from_json(cfg_json)
    ref = PackedReference.load(prefix)
    idx = KmerIndex.load(prefix)
    return align_batch_oracle(codes, lengths, ref, idx, s_tensor, cfg)


ORACLE_FIELDS = (("mapped", "mapped"), ("n_candidates", "n_candidates"),
                 ("strand", "strand"), ("score", "score"), ("mapq", "mapq"),
                 ("x0", "x0"), ("x1", "x1"), ("ug_equal", "ug_equal"),
                 ("diag", "diag"))
UNGAPPED_FIELDS = (("pos", "packed_pos"), ("nm", "nm"), ("tc_count", "tc"))


def oracle_parity(work: Path, n_reads: int, batch: int, read_len: int,
                  k: int, workers: int, tag: str = "out") -> dict:
    """Device AlignResult (pass-2 scoring, the packed streaming step) ==
    oracle.align_read on the first n_reads of the run's FASTQ, every field
    the oracle defines, exactly (tolerance zero)."""
    import concurrent.futures as cf
    import multiprocessing as mp

    import jax
    import numpy as np

    from parasuite_tpu.errormodel.infer import ErrorProfile, counts_to_profile
    from parasuite_tpu.index import KmerIndex, PackedReference
    from parasuite_tpu.io.fastq import iter_fastq_batches
    from parasuite_tpu.ops.aligner import unpack_result_host
    from parasuite_tpu.pipeline import AlignerEngine

    cfg = _cli_cfg(batch, read_len, k)
    ref = PackedReference.load(work / "idx")
    idx = KmerIndex.load(work / "idx")
    s = counts_to_profile(ErrorProfile.load(work / f"{tag}.bam.errorprofile"),
                          cfg)
    engine = AlignerEngine(ref, idx, cfg, s_tensor=s)
    b = next(iter_fastq_batches(work / "reads.fastq", batch, read_len))
    res = unpack_result_host(jax.device_get(
        engine.align_device_packed(b.codes, b.lengths)), cfg.band_width)
    codes, lengths = b.codes[:n_reads], b.lengths[:n_reads]
    chunks = np.array_split(np.arange(n_reads), workers)
    env_platforms = os.environ.get("JAX_PLATFORMS")
    os.environ["JAX_PLATFORMS"] = "cpu"   # workers never touch the card
    try:
        with cf.ProcessPoolExecutor(
                workers, mp_context=mp.get_context("spawn")) as ex:
            parts = list(ex.map(_oracle_chunk, [
                (str(work / "idx"), codes[c], lengths[c], s, cfg.to_json())
                for c in chunks]))
    finally:
        if env_platforms is None:
            os.environ.pop("JAX_PLATFORMS")
        else:
            os.environ["JAX_PLATFORMS"] = env_platforms
    alns = [a for p in parts for a in p]
    bad = 0
    for r, a in enumerate(alns):
        got = {f: np.asarray(getattr(res, f))[r] for f, _ in
               ORACLE_FIELDS + UNGAPPED_FIELDS}
        # unmapped: mapped + n_candidates; gapped winners: the device keeps
        # the ungapped key, the host traceback fixes pos/nm/tc
        fields = ((ORACLE_FIELDS if a.mapped else ORACLE_FIELDS[:2])
                  + (UNGAPPED_FIELDS if a.mapped and a.ug_equal else ()))
        if any(int(got[f]) != int(getattr(a, o)) for f, o in fields):
            bad += 1
    return {"reads": len(alns), "mismatches": bad,
            "mapped": int(sum(a.mapped for a in alns)),
            "gapped": int(sum(a.mapped and not a.ug_equal for a in alns))}


def _cli_cfg(batch: int, read_len: int, k: int):
    from parasuite_tpu.config import AlignConfig

    return AlignConfig(kmer_size=k, batch_size=batch, max_read_len=read_len)


# ---------------------------------------------------------------------------
# phase 6: the device step alone
# ---------------------------------------------------------------------------

def trace_shares(compiled, args, trace_dir: Path,
                 scopes=("select", "extend")) -> dict:
    """One warm call of `compiled` under jax.profiler: each named scope's
    share of the summed device kernel time, and the longest kernels. A
    kernel is attributed through its HLO instruction's op_name metadata."""
    import glob
    import re

    import jax

    op_name = dict(re.findall(r'%?([\w.\-]+) = .*?op_name="([^"]*)"',
                              compiled.as_text()))
    jax.block_until_ready(compiled(*args))
    jax.profiler.start_trace(str(trace_dir))
    jax.block_until_ready(compiled(*args))
    jax.profiler.stop_trace()
    path = sorted(glob.glob(f"{trace_dir}/**/*.xplane.pb", recursive=True))
    pd = jax.profiler.ProfileData.from_file(path[-1])
    per_op: dict = {}
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                hlo = dict(ev.stats).get("hlo_op")
                if hlo:
                    per_op[hlo] = per_op.get(hlo, 0.0) + ev.duration_ns
    total = sum(per_op.values())
    out = {"device_kernel_ms": total / 1e6}
    for sc in scopes:
        t = sum(v for k, v in per_op.items()
                if f"/{sc}/" in op_name.get(k, ""))
        out[f"{sc}_share"] = t / total if total else None
    out["top"] = [(k, round(v / 1e6, 4), op_name.get(k, "")[-80:])
                  for k, v in sorted(per_op.items(), key=lambda kv: -kv[1])
                  [:12]]
    return out


def device_step(work: Path, batch: int, read_len: int, k: int,
                timed_calls: int = TIMED_CALLS, tag: str = "out") -> dict:
    """align_batch_packed on one FASTQ batch with the run's learned
    profile: warm device time (median of timed_calls, each ending in
    block_until_ready), memory_analysis() of the compiled step,
    peak_bytes_in_use, and the select/extend shares of one traced call."""
    import functools

    import jax
    import numpy as np

    from parasuite_tpu.errormodel.infer import ErrorProfile, counts_to_profile
    from parasuite_tpu.index import KmerIndex, PackedReference
    from parasuite_tpu.io.fastq import iter_fastq_batches
    from parasuite_tpu.ops import DeviceIndex, ScoreParams
    from parasuite_tpu.ops.aligner import (align_batch_packed,
                                           min_score_table, pack_codes_host)

    cfg = _cli_cfg(batch, read_len, k)
    ref = PackedReference.load(work / "idx")
    didx = DeviceIndex.from_host(ref, KmerIndex.load(work / "idx"))
    s = counts_to_profile(ErrorProfile.load(work / f"{tag}.bam.errorprofile"),
                          cfg)
    sprof = ScoreParams.from_tensor(s, cfg)
    b = next(iter_fastq_batches(work / "reads.fastq", batch, read_len))
    two, nmask = pack_codes_host(b.codes)
    args = (didx, sprof, jax.device_put(two), jax.device_put(nmask),
            jax.device_put(b.lengths.astype(np.uint16)),
            jax.device_put(min_score_table(cfg)))
    lowered = jax.jit(functools.partial(align_batch_packed, cfg=cfg)).lower(
        *args)
    t0 = time.perf_counter()
    compiled = lowered.compile()
    compile_s = time.perf_counter() - t0
    mem = compiled.memory_analysis()
    jax.block_until_ready(compiled(*args))
    ts = []
    for _ in range(timed_calls):
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(*args))
        ts.append(time.perf_counter() - t0)
    med = statistics.median(ts)
    try:
        # one CUDA graph hides the kernels from the trace: trace a copy
        # compiled without command buffers
        traced = lowered.compile({"xla_gpu_enable_command_buffer": ""})
    except Exception as e:  # noqa: BLE001 - reported, the step still ran
        log(f"no command-buffer-free compile ({type(e).__name__}); tracing "
            "the step as compiled")
        traced = compiled
    shares = trace_shares(traced, args, work / "trace")
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    return {
        "batch": batch, "compile_s": compile_s,
        "step_ms_median": med * 1e3, "step_ms": [t * 1e3 for t in ts],
        "reads_per_s_device": batch / med,
        "temp_bytes": mem.temp_size_in_bytes,
        "argument_bytes": mem.argument_size_in_bytes,
        "output_bytes": mem.output_size_in_bytes,
        "peak_bytes_in_use": peak,
        **shares,
    }


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

def require_gpu_env() -> str:
    """Fail before any JAX import when this machine has no GPU to offer."""
    plat = os.environ.get("JAX_PLATFORMS", "")
    if plat and not any(p in plat for p in ("cuda", "gpu")):
        raise SystemExit(f"chip_smoke: JAX_PLATFORMS={plat!r} excludes the "
                         "GPU; this script runs on a GPU only")
    label = card_label()
    if not label:
        raise SystemExit("chip_smoke: no NVIDIA GPU found (nvidia-smi); "
                         "this script runs on a GPU only")
    return label


def _child(argv, env_extra: dict):
    env = dict(os.environ, PYTHONPATH=str(REPO), **env_extra)
    return subprocess.Popen([sys.executable, *map(str, argv)], cwd=REPO,
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _wait(procs, timeout: int = 900) -> list[dict]:
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            if p.returncode != 0:
                raise RuntimeError(f"child {p.args[2:4]} exited "
                                   f"{p.returncode}:\n{err[-3000:]}")
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def _free_port() -> int:
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        return sk.getsockname()[1]


def dist_cli_run(work: Path, n_procs: int, batch: int, read_len: int,
                 k: int, gpu: bool) -> dict:
    """Phase (c): `cli dist-align --coordinator` over n_procs processes,
    each on its own card (distributed.local_device_ids), merged; against
    the one-card file-side run, merged the same way. This process stays
    off JAX until every child has exited."""
    flags = cfg_flags(batch, read_len, k)
    mod = ["-m", "parasuite_tpu.cli"]
    cpu = {} if gpu else {"JAX_PLATFORMS": "cpu"}
    port = _free_port()
    t0 = time.perf_counter()
    outs = _wait([_child(
        [*mod, "dist-align", work / "idx", work / "reads.fastq", work / "d4",
         "--coordinator", f"localhost:{port}", "--num-processes", n_procs,
         "--process-id", i, *flags], cpu) for i in range(n_procs)])
    multi_s = time.perf_counter() - t0
    one = {"CUDA_VISIBLE_DEVICES": "0"} if gpu else cpu
    _wait([_child([*mod, "dist-align", work / "idx", work / "reads.fastq",
                   work / "d1", "--host-index", 0, "--n-hosts", 1, *flags],
                  one)])
    host = {"JAX_PLATFORMS": "cpu"}   # merging touches no card
    for tag, n in (("d4", n_procs), ("d1", 1)):
        _wait([_child([*mod, "merge-shards", work / "idx", work / tag,
                       work / f"{tag}.sam", "--n-hosts", n, "--profile-out",
                       work / f"{tag}.errorprofile", "--pg-cl", "merge",
                       *flags], host)])
    import numpy as np

    from parasuite_tpu.errormodel.infer import ErrorProfile

    p4 = ErrorProfile.load(work / "d4.errorprofile")
    p1 = ErrorProfile.load(work / "d1.errorprofile")
    return {"records": sum(o["records"] for o in outs),
            "seconds": multi_s,
            "sam_identical": (work / "d4.sam").read_bytes()
            == (work / "d1.sam").read_bytes(),
            "counts_equal": bool(np.array_equal(p4.counts, p1.counts)
                                 and p4.n_reads == p1.n_reads)}


def dist_step_parity(work: Path, n_dev: int, batch: int, read_len: int,
                     k: int) -> dict:
    """Phase (a): make_dist_align_step on a 1-D data mesh of n_dev devices
    over n_dev * batch reads == one-device align_batch on the same reads
    (every AlignResult field) and the summed profile counts."""
    import functools

    import jax
    import numpy as np

    from parasuite_tpu.errormodel.scoring import flat_score_tensor
    from parasuite_tpu.index import KmerIndex, PackedReference
    from parasuite_tpu.io.fastq import iter_fastq_batches
    from parasuite_tpu.ops import DeviceIndex, ScoreParams, align_batch
    from parasuite_tpu.ops.device_index import min_scores_host
    from parasuite_tpu.ops.profile_update import profile_counts_batch
    from parasuite_tpu.parallel import make_dist_align_step, make_mesh
    from parasuite_tpu.parallel.dist_align import shard_batch

    cfg = _cli_cfg(batch, read_len, k)
    ref = PackedReference.load(work / "idx")
    idx = KmerIndex.load(work / "idx")
    # uncommitted arrays: the mesh step replicates them, the one-device
    # step runs where they are (device 0)
    didx = DeviceIndex.from_host(ref, idx)
    sprof = ScoreParams.from_tensor(flat_score_tensor(cfg, read_len), cfg)
    b = next(iter_fastq_batches(work / "reads.fastq", n_dev * batch,
                                read_len))
    ms = min_scores_host(b.lengths, cfg)
    step = make_dist_align_step(cfg, make_mesh(n_dev), with_counts=True)
    c, ln, m = shard_batch(b.codes, b.lengths, ms, n_dev)
    t0 = time.perf_counter()
    res, counts = jax.block_until_ready(step(didx, sprof, c, ln, m))
    mesh_s = time.perf_counter() - t0
    one = jax.jit(functools.partial(align_batch, cfg=cfg))
    cnt = jax.jit(functools.partial(profile_counts_batch, cfg=cfg))
    parts, ref_counts = [], 0
    for i in range(n_dev):
        sl = slice(i * batch, (i + 1) * batch)
        args = [jax.numpy.asarray(x) for x in
                (b.codes[sl], b.lengths[sl], ms[sl])]
        r = one(didx, sprof, *args)
        ref_counts = ref_counts + np.asarray(cnt(
            didx, args[0], args[1], r.mapped, r.strand, r.pos, r.ug_equal),
            dtype=np.int64)
        parts.append(jax.device_get(r))
    exact = all(np.array_equal(np.asarray(getattr(res, f)),
                               np.concatenate([getattr(p, f) for p in parts]))
                for f in res._fields)
    return {"reads": n_dev * batch, "fields_exact": bool(exact),
            "counts_equal": bool(np.array_equal(np.asarray(counts,
                                                           dtype=np.int64),
                                                ref_counts)),
            "first_call_s": mesh_s, "peak_bytes_per_device": _peaks()}


def _peaks() -> list:
    import jax

    return [(d.memory_stats() or {}).get("peak_bytes_in_use")
            for d in jax.devices()]


def sharded_parity(total_len: int, n_chroms: int, n_data: int,
                   n_index: int, n_reads: int, read_len: int, k: int) -> dict:
    """Phase (b): make_sharded_step on an n_data x n_index mesh over a
    multi-chromosome genome against the unsharded one-device align_batch,
    under the equality contract of parallel/shards.py: on reads whose
    replicated candidate lists have headroom, mapped is equal and chrom,
    local_pos, strand, score, nm, x0, mapq are equal on uniquely mapped
    reads (the fields tests/test_shards.py pins); on saturated reads the
    sharded result maps them too at no lower score."""
    import functools

    import jax
    import numpy as np

    from parasuite_tpu.errormodel.scoring import flat_score_tensor
    from parasuite_tpu.index import KmerIndex
    from parasuite_tpu.ops import DeviceIndex, ScoreParams, align_batch
    from parasuite_tpu.ops.device_index import min_scores_host
    from parasuite_tpu.parallel.mesh import make_mesh2
    from parasuite_tpu.parallel.shards import (build_sharded_index,
                                               make_sharded_step)
    from parasuite_tpu.sim import simulate_reads
    from parasuite_tpu.sim.genome import multi_chrom

    cfg = _cli_cfg(n_reads, read_len, k)
    t0 = time.perf_counter()
    seqs, _ = multi_chrom(total_len, n_chroms)
    sharded, full = build_sharded_index(seqs, n_index, cfg)
    full_idx = KmerIndex.build(full.seq, k)
    build_s = time.perf_counter() - t0
    sprof = ScoreParams.from_tensor(flat_score_tensor(cfg, read_len), cfg)
    codes, lengths, _truth = simulate_reads(full, n_reads, read_len, cfg,
                                            seed=SEED)
    ms = min_scores_host(lengths, cfg)
    dev0 = jax.devices()[0]
    didx = jax.device_put(DeviceIndex.from_host(full, full_idx), dev0)
    rep = jax.device_get(jax.jit(functools.partial(align_batch, cfg=cfg))(
        didx, jax.device_put(sprof, dev0), *[jax.device_put(x, dev0) for x
                                             in (codes, lengths, ms)]))
    del didx
    rep_ci, rep_local = full.locate(np.asarray(rep.pos))
    step = make_sharded_step(cfg, make_mesh2(n_data, n_index))
    out = jax.device_get(step(sharded.slabs(cfg), sharded.orig_chrom, sprof,
                              codes, lengths, ms))
    # the contract (parallel/shards.py): exact while neither strand's
    # replicated candidate list is full (C entries; n_candidates < C
    # guarantees it); otherwise the sharded union of per-shard top-C lists
    # dominates
    head = rep.n_candidates < cfg.max_candidates
    mapped_eq = bool(np.array_equal(out["mapped"][head], rep.mapped[head]))
    uniq = head & rep.mapped & (rep.x0 == 1)
    exact = all(np.array_equal(np.asarray(out[f])[uniq], r[uniq]) for f, r in
                (("chrom", rep_ci), ("local_pos", rep_local),
                 ("strand", rep.strand), ("score", rep.score),
                 ("nm", rep.nm), ("x0", rep.x0), ("mapq", rep.mapq)))
    # dominance: no read lost, no score lower, x0 never shrinks; where the
    # scores and x0 tie, the same winner (strand, chrom, local_pos, nm) —
    # an extra equal-score twin may win the position tie-break
    sat = ~head & rep.mapped
    eq = sat & out["mapped"] & (out["score"] == rep.score)
    same = eq & (out["x0"] == rep.x0)
    dominates = bool(
        np.all(out["mapped"][sat]) and np.all(out["score"][sat]
                                              >= rep.score[sat])
        and np.all(out["x0"][eq] >= rep.x0[eq])
        and all(np.array_equal(np.asarray(out[f])[same], r[same]) for f, r
                in (("strand", rep.strand), ("chrom", rep_ci),
                    ("local_pos", rep_local), ("nm", rep.nm))))
    return {"genome_bp": int(sum(len(v) for v in seqs.values())),
            "reads": n_reads, "headroom": int(head.sum()),
            "unique": int(uniq.sum()), "mapped_equal": mapped_eq,
            "unique_fields_exact": bool(exact),
            "saturated": int(sat.sum()), "saturated_equal_score": int(eq.sum()),
            "saturated_dominated": dominates,
            "build_s": build_s, "peak_bytes_per_device": _peaks()}


def four_cards(work: Path, card: str, n_dev: int = 4, batch: int = BATCH,
               scale: float = SCALE, k: int = KMER,
               shard_total: int = 200_000_000, shard_reads: int = BATCH,
               gpu: bool = True) -> dict:
    """The multi-card paths only: (c) coordinator processes, one card each,
    while this process stays off JAX; then (a) the data mesh and (b) the
    2x2 data x index mesh in this process."""
    t0 = time.perf_counter()
    prep = {"JAX_PLATFORMS": "cpu"}
    from parasuite_tpu.io.fasta import write_fasta
    from parasuite_tpu.sim.genome import chr22_like

    seqs, _ = chr22_like(scale=scale)
    write_fasta(work / "ref.fa", seqs)
    mod = ["-m", "parasuite_tpu.cli"]
    _wait([_child([*mod, "index", work / "ref.fa", work / "idx",
                   "--kmer-size", k], prep)])
    _wait([_child([*mod, "simulate", work / "idx", work / "reads.fastq",
                   "--n-reads", n_dev * batch, "--read-len", READ_LEN,
                   "--seed", SEED], prep)])
    log(f"[{card}] four-card set-up s: {time.perf_counter() - t0:.3f}")
    results = {}

    def phase(name, fn, *a):
        # a failed phase is reported and the next one still runs
        try:
            results[name] = fn(*a)
        except Exception as e:  # noqa: BLE001 - reported, then exit 1
            results[name] = {"error": f"{type(e).__name__}: {e}"[-3000:]}
        log(f"[{card}] {name}: {results[name]}")

    phase(f"(c) dist-align --coordinator x{n_dev} vs one card",
          dist_cli_run, work, n_dev, batch, READ_LEN, k, gpu)

    from parasuite_tpu.utils.jaxcache import enable_compile_cache

    enable_compile_cache()
    dev = device_info(n_dev) if gpu else None
    phase(f"(a) data mesh x{n_dev} vs one card", dist_step_parity, work,
          n_dev, batch, READ_LEN, k)
    phase(f"(b) 2x{n_dev // 2} data x index mesh vs unsharded",
          sharded_parity, shard_total, 8, 2, n_dev // 2, shard_reads,
          READ_LEN, k)
    c, a, b = results.values()
    ok = (c.get("sam_identical") and c.get("counts_equal")
          and c.get("records") == n_dev * batch and a.get("fields_exact")
          and a.get("counts_equal") and b.get("mapped_equal")
          and b.get("unique_fields_exact") and b.get("saturated_dominated"))
    if not ok:
        raise SystemExit("chip_smoke: a four-card check failed (see above)")
    return dev


def device_info(n_want: int) -> dict:
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke: JAX found {devs[0].platform}, not a "
                         "GPU")
    if len(devs) < n_want:
        raise SystemExit(f"chip_smoke: needs {n_want} GPUs, JAX found "
                         f"{len(devs)}")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def main_path(card: str) -> dict:
    from parasuite_tpu.utils.jaxcache import enable_compile_cache

    t_start = time.perf_counter()
    g = gpu_tests(WORK)
    log(f"[{card}] gpu-marked tests: {g}")
    if not g["ok"]:
        raise SystemExit("chip_smoke: gpu-marked tests failed")

    cache = enable_compile_cache()
    dev = device_info(1)
    from parasuite_tpu import native

    log(f"[{card}] device: {dev}; host cores: {os.cpu_count()}; "
        f"compile cache: {cache}")
    log(f"[{card}] native C++ host library built: {native.available()}")

    r = build_reference(WORK, SCALE, KMER)
    log(f"[{card}] reference: {r}")
    s = simulate(WORK, N_READS, READ_LEN, SEED)
    log(f"[{card}] simulate: {s}")
    setup_s = time.perf_counter() - t_start
    tp = twopass(WORK, BATCH, READ_LEN, KMER)
    log(f"[{card}] twopass (host clock, pass 1 includes its compile): {tp}")
    sc = sort_and_cluster(WORK)
    log(f"[{card}] sort + cluster: {sc}")
    acc = accuracy(WORK)
    log(f"[{card}] accuracy vs simulation truth: {acc}")
    par = oracle_parity(WORK, N_ORACLE, BATCH, READ_LEN, KMER,
                        workers=min(16, os.cpu_count() or 1))
    log(f"[{card}] oracle parity (int32 scoring, tolerance 0, no matmul so "
        f"no TF32): {par}")
    ds = device_step(WORK, BATCH, READ_LEN, KMER)
    log(f"[{card}] device step align_batch_packed: {ds}")
    log(f"[{card}] set-up s (tests+index+simulate): {setup_s:.3f}; "
        f"total s: {time.perf_counter() - t_start:.3f}")

    ok = (par["mismatches"] == 0 and par["reads"] >= N_ORACLE
          and acc["sensitivity"] > 0.9
          and acc["precision"] > 0.9 and sc["clusters"] > 0
          and tp["reads"] == N_READS)
    if not ok:
        raise SystemExit("chip_smoke: a check failed (see above)")
    return dev


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-card paths (needs 4 GPUs)")
    args = ap.parse_args(argv)
    card = require_gpu_env()
    log(card)
    shutil.rmtree(WORK, ignore_errors=True)
    WORK.mkdir(parents=True)
    try:
        if args.four_cards:
            dev = four_cards(WORK, card)
        else:
            dev = main_path(card)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    log(card)
    print(json.dumps({"ok": True, "device": dev}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
