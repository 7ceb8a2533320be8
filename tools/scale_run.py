"""Config-5 scale run (BASELINE.json configs[4]; VERDICT r3 next-round #2,
r4 next-round #1/#3/#4): one recorded end-to-end production run at tens of
millions of reads — simulate -> twopass (profile -> realign, direct .bam
out) -> coordinate sort (C++ external sort) -> binding-site clusters — with
a mid-run kill + --resume continuation verified byte-identical against an
uninterrupted control, and per-stage wall clock + peak RSS printed as one
JSON line (and kept in .scale_run/stats.json).

Design:
  * the reference is the repeat-structured chr22-class 51 Mbp chromosome
    (sim/genome.py), not a uniform 20 Mbp string — max_occ/uniqueness are
    real effects here (VERDICT r4 missing #2);
  * reads are simulated in BINDING-SITE mode around PARASUITE_SCALE_SITES
    crosslink sites, so the cluster stage emits a real cluster set
    (clusters >> 1), with a 1M-record parity spot-check of the native BAM
    cluster scan against the Python oracle (VERDICT r4 weak #6);
  * the sort stage exercises the native C++ external sort (weak #3's fix);
    its timing here is the >=3x "Done" evidence.

Defaults to 50M reads (PARASUITE_SCALE_READS to override); everything runs
through the real CLI in subprocesses, on the real chip.

    timeout 7200 python tools/scale_run.py
"""

from __future__ import annotations

import json
import os
import resource
import signal
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
from parasuite_tpu.utils.jaxcache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np

N_READS = int(os.environ.get("PARASUITE_SCALE_READS", 50_000_000))
READ_LEN = 50
N_SITES = int(os.environ.get("PARASUITE_SCALE_SITES", 30_000))
SCALE = float(os.environ.get("PARASUITE_SCALE_REFSCALE", 1.0))
BATCH = int(os.environ.get("PARASUITE_BENCH_BATCH", 65536))
SIM_CHUNK = 2_000_000
WORK = Path(os.environ.get("PARASUITE_SCALE_DIR", REPO / ".scale_run"))
KILL_AFTER = float(os.environ.get("PARASUITE_SCALE_KILL_AFTER", 30.0))

CFG_FLAGS = ["--kmer-size", "12", "--max-read-len", str(READ_LEN),
             "--batch-size", str(BATCH), "--max-candidates", "8",
             "--max-occ", "16"]


def run_stage(name, argv, stats, kill_after=None, expect_fail=False,
              cwd=None):
    """Run a CLI stage in a subprocess; record wall seconds + peak child
    RSS. kill_after sends SIGKILL after that many seconds (crash drill)."""
    env = dict(os.environ)
    # PREPEND the repo: keep whatever PYTHONPATH the caller set
    env["PYTHONPATH"] = str(REPO) + (
        (":" + env["PYTHONPATH"]) if env.get("PYTHONPATH") else "")
    t0 = time.perf_counter()
    rss0 = resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss
    p = subprocess.Popen([sys.executable, "-m", "parasuite_tpu.cli"] + argv,
                         env=env, cwd=cwd or WORK, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True)
    killed = False
    if kill_after is not None:
        try:
            p.wait(timeout=kill_after)
        except subprocess.TimeoutExpired:
            p.send_signal(signal.SIGKILL)
            p.wait()
            killed = True
    out, err = p.communicate()
    dt = time.perf_counter() - t0
    rss1 = resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss
    if not killed and not expect_fail and p.returncode != 0:
        sys.stderr.write(err[-4000:])
        raise SystemExit(f"stage {name} failed rc={p.returncode}")
    rec = {"seconds": round(dt, 1),
           "peak_rss_mb": round(max(rss0, rss1) / 1024, 0)}
    if killed:
        rec["killed_after_s"] = kill_after
    if out.strip():
        try:
            rec["result"] = json.loads(out.strip().splitlines()[-1])
        except json.JSONDecodeError:
            pass
    stats[name] = rec
    print(json.dumps({name: rec}), flush=True)
    return killed


def make_sites(ref) -> np.ndarray:
    """Deterministic crosslink-site positions: N_SITES packed coordinates
    whose +-READ_LEN window is N-free (binding-site mode reads always cover
    their site; a site near an N gap would only make unmappable reads)."""
    rng = np.random.default_rng(404)
    seq = ref.seq
    ok = np.ones(seq.shape[0], dtype=bool)
    isn = seq == 4
    # a site at p needs [p - L, p + L] N-free; dilate the N mask by L
    W = READ_LEN
    bad = np.convolve(isn.astype(np.int8), np.ones(2 * W + 1, np.int8),
                      "same") > 0
    ok &= ~bad
    ok[:W] = False
    ok[-W:] = False
    cand = np.flatnonzero(ok)
    return np.sort(rng.choice(cand, size=N_SITES, replace=False))


def simulate_fastq(path, stats):
    """Chunked simulation (10M+ reads in one simulate_reads call would hold
    several full-size copies in RAM) with the decay-model quality strings.
    Binding-site mode: every read overlaps one of the N_SITES crosslink
    sites, conversions +-2 around it — the cluster stage's real workload."""
    from parasuite_tpu.config import AlignConfig
    from parasuite_tpu.index import PackedReference
    from parasuite_tpu.sim import simulate_reads
    from parasuite_tpu.sim.generate import simulate_quality

    cfg = AlignConfig(max_read_len=READ_LEN, kmer_size=12, batch_size=BATCH,
                      max_candidates=8, max_occ=16)
    ref = PackedReference.load(WORK / "idx")
    sites = make_sites(ref)
    stats["n_sites"] = int(sites.shape[0])
    t0 = time.perf_counter()
    with open(path, "wb") as out:
        done = 0
        chunk_i = 0
        while done < N_READS:
            n = min(SIM_CHUNK, N_READS - done)
            codes, lengths, _truth = simulate_reads(
                ref, n, READ_LEN, cfg, seed=1000 + chunk_i, tc_rate=0.12,
                site_positions=sites)
            quals = simulate_quality(n, READ_LEN, seed=chunk_i)
            # fully vectorized fixed-width record assembly (a per-record
            # Python loop measured ~100 min for 50M reads on this host):
            # "@r<9 digits>\n<seq 50>\n+\n<qual 50>\n"
            L = READ_LEN
            R = 2 + 9 + 1 + L + 3 + L + 1
            rec = np.empty((n, R), dtype=np.uint8)
            rec[:, 0] = ord("@")
            rec[:, 1] = ord("r")
            idx = np.arange(done, done + n, dtype=np.int64)
            for p in range(9):
                rec[:, 2 + p] = (idx // 10 ** (8 - p)) % 10 + 48
            rec[:, 11] = 10
            base_lut = np.frombuffer(b"ACGTN", dtype=np.uint8)
            rec[:, 12 : 12 + L] = base_lut[np.clip(codes, 0, 4)]
            rec[:, 12 + L] = 10
            rec[:, 13 + L] = ord("+")
            rec[:, 14 + L] = 10
            rec[:, 15 + L : 15 + 2 * L] = quals
            rec[:, 15 + 2 * L] = 10
            out.write(rec.tobytes())
            done += n
            chunk_i += 1
            print(json.dumps({"simulate_progress": done}), flush=True)
    dt = time.perf_counter() - t0
    stats["simulate"] = {
        "seconds": round(dt, 1), "reads": N_READS,
        "peak_rss_mb": round(
            resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024, 0)}
    print(json.dumps({"simulate": stats["simulate"]}), flush=True)


def _files_equal(a: Path, b: Path, chunk: int = 64 << 20) -> bool:
    if a.stat().st_size != b.stat().st_size:
        return False
    with open(a, "rb") as fa, open(b, "rb") as fb:
        while True:
            ca = fa.read(chunk)
            cb = fb.read(chunk)
            if ca != cb:
                return False
            if not ca:
                return True


def cluster_parity_spotcheck(sorted_bam, stats, n_check=1_000_000):
    """Native BAM cluster-scan columns vs the Python oracle on the first
    n_check records of the real sorted artifact (VERDICT r4 weak #6 "Done"
    criterion: spot-check parity vs the Python oracle scan at scale)."""
    from parasuite_tpu import native
    from parasuite_tpu.cli import cluster_columns_python
    from parasuite_tpu.index import PackedReference
    from parasuite_tpu.io.bam import decode_bam_record, iter_bam_records

    ref = PackedReference.load(WORK / "idx")
    t0 = time.perf_counter()
    pos_n, span_n, tc_n, _sk = native.bam_cluster_columns(sorted_bam, ref)
    text, names, _lens, recs = iter_bam_records(sorted_bam)
    tmp_sam = WORK / "spotcheck.sam"
    n_written = 0
    with open(tmp_sam, "w") as out:
        out.write(text)
        for body in recs:
            out.write(decode_bam_record(body, names) + "\n")
            n_written += 1
            if n_written >= n_check:
                break
    pos_p, span_p, tc_p = cluster_columns_python(tmp_sam, ref)
    tmp_sam.unlink()
    m = pos_p.shape[0]  # oracle skips unmapped; native columns align 1:1
    same = (np.array_equal(pos_n[:m], pos_p)
            and np.array_equal(span_n[:m], span_p)
            and np.array_equal(tc_n[:m], tc_p))
    stats["cluster_spotcheck"] = {
        "records_checked": int(m), "parity": bool(same),
        "seconds": round(time.perf_counter() - t0, 1)}
    print(json.dumps({"cluster_spotcheck": stats["cluster_spotcheck"]}),
          flush=True)
    if not same:
        raise SystemExit("cluster column spot-check FAILED")


def main() -> int:
    WORK.mkdir(exist_ok=True)
    stats: dict = {"n_reads": N_READS, "batch": BATCH,
                   "world": "chr22_class_repeat_structured"}

    # reference + index: repeat-structured chr22-class chromosome
    fa = WORK / "ref.fa"
    if not (WORK / "idx.ref.json").exists():
        from parasuite_tpu.io.fasta import write_fasta
        from parasuite_tpu.sim.genome import chr22_like

        seqs, gstats = chr22_like(scale=SCALE)
        stats["repeat_fraction"] = round(gstats.repeat_fraction, 4)
        write_fasta(fa, seqs)
        run_stage("index", ["index", str(fa), str(WORK / "idx")] + CFG_FLAGS,
                  stats)

    fq = WORK / "reads.fastq"
    if not fq.exists() or fq.stat().st_size < N_READS * 100:
        simulate_fastq(fq, stats)

    # --- control twopass (uninterrupted) ---
    # identical RELATIVE argv per run (only --resume differs on the
    # continuation, and a resumed run never rewrites the header) so the
    # @PG CL: header line cannot differ between control and drill
    cdir = WORK / "ctrl"
    rdir = WORK / "run"
    for d in (cdir, rdir):
        d.mkdir(exist_ok=True)
        for f in d.glob("out.bam*"):
            f.unlink()
    argv = (["twopass", "../idx", "../reads.fastq", "out.bam",
             "--pg-cl", "scale_r05"] + CFG_FLAGS)
    run_stage("twopass_control", argv, stats, cwd=cdir)
    ctrl = cdir / "out.bam"

    # --- crash drill: kill mid-run, then --resume; bytes must match ---
    out = rdir / "out.bam"
    killed = run_stage("twopass_killed", argv, stats, kill_after=KILL_AFTER,
                       cwd=rdir)
    if not killed:
        raise SystemExit("kill drill did not trigger — raise "
                         "PARASUITE_SCALE_KILL_AFTER resolution")
    run_stage("twopass_resumed", argv + ["--resume"], stats, cwd=rdir)
    same_bam = _files_equal(out, ctrl)
    same_prof = ((Path(str(out) + ".errorprofile").read_bytes())
                 == Path(str(ctrl) + ".errorprofile").read_bytes())
    stats["resume_byte_identical"] = bool(same_bam and same_prof)
    print(json.dumps({"resume_byte_identical": stats["resume_byte_identical"],
                      "bam": same_bam, "profile": same_prof}), flush=True)

    # --- sort (external merge) + cluster (BGZF scan, no temp SAM) ---
    sortd = WORK / "sorted.bam"
    run_stage("sort", ["sort", str(out), str(sortd), "--min-mapq", "1"],
              stats)
    run_stage("cluster", ["cluster", str(WORK / "idx"), str(sortd),
                          str(WORK / "clusters.tsv")] + CFG_FLAGS
              + ["--cluster-min-reads", "2"], stats)
    cluster_parity_spotcheck(sortd, stats)

    stats["artifacts_bytes"] = {
        "fastq": fq.stat().st_size, "bam": out.stat().st_size,
        "sorted_bam": sortd.stat().st_size,
        "clusters_tsv": (WORK / "clusters.tsv").stat().st_size}
    e2e = (stats["twopass_control"]["seconds"] + stats["sort"]["seconds"]
           + stats["cluster"]["seconds"])
    stats["pipeline_seconds_ex_sim"] = round(e2e, 1)
    stats["pipeline_reads_per_s"] = round(N_READS / e2e, 0)
    (WORK / "stats.json").write_text(json.dumps(stats, indent=2))
    print(json.dumps(stats), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
