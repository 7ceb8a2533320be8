"""PAR-CLIP read simulator (SURVEY.md §2 component 8, §3.4).

Reference mechanism: per-read Java sampling loop — sample position, copy
bases, inject T->C conversions at crosslink sites plus sequencing errors per
learned profile, write FASTQ + ground truth. Here the whole batch is drawn
with jax.random (counter-based threefry): the same (seed, read index) pair
produces the same read at any batch size or shard count, which is what makes
the distributed benchmark configs reproducible (SURVEY.md §2 component 8
"reproducible across shard counts").

Error model: conversions first (every machine-frame T converts i.i.d. with
tc_rate — or only inside a crosslink window in site mode), then sequencing
errors: either a learned profile's conditional table P(obs | true, cycle) or
a flat uniform error rate.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from parasuite_tpu.config import AlignConfig
from parasuite_tpu.index.reference import PackedReference
from parasuite_tpu.utils.dna import C, N, T


@dataclass
class SimTruth:
    """Ground truth for simulated reads (all [n])."""

    packed_pos: np.ndarray   # int64 packed start of the source fragment
    chrom_idx: np.ndarray    # int32
    local_pos: np.ndarray    # int64 0-based within chromosome
    strand: np.ndarray       # int8
    n_conversions: np.ndarray  # int32 injected T->C count
    n_errors: np.ndarray     # int32 injected sequencing errors
    indel_kind: np.ndarray | None = None  # int8: 0 none, 1 ins, 2 del
    indel_pos: np.ndarray | None = None   # int32 machine cycle of the event

    def names(self, prefix: str = "sim") -> list[str]:
        return [f"{prefix}_{i}:{int(self.chrom_idx[i])}:"
                f"{int(self.local_pos[i])}:{int(self.strand[i])}"
                for i in range(self.packed_pos.shape[0])]

    @staticmethod
    def parse_name(name: str) -> tuple[int, int, int]:
        """-> (chrom_idx, local_pos, strand)."""
        _, ci, pos, strand = name.rsplit(":", 3)
        return int(ci), int(pos), int(strand)


def _valid_starts(ref: PackedReference, read_len: int) -> np.ndarray:
    """Packed positions whose read_len window contains no N (host, once)."""
    is_n = (ref.seq == N).astype(np.int64)
    cum = np.concatenate([[0], np.cumsum(is_n)])
    n = ref.total_len - read_len + 1
    ok = (cum[read_len:] - cum[:-read_len]) == 0
    return np.nonzero(ok)[0].astype(np.int64)


def _indel_rate_vec(rate, read_len: int, lo: int, hi: int) -> np.ndarray:
    """Scalar-or-per-cycle rate -> per-cycle vector masked to the interior."""
    out = np.zeros(read_len, dtype=np.float64)
    if rate is None:
        return out
    r = np.asarray(rate, dtype=np.float64)
    v = np.full(read_len, float(r)) if r.ndim == 0 else np.pad(
        r[:read_len], (0, max(0, read_len - r.shape[0])))
    out[lo:hi] = v[lo:hi]
    return out


def simulate_reads(ref: PackedReference, n: int, read_len: int,
                   cfg: AlignConfig, seed: int | None = None,
                   profile_probs: np.ndarray | None = None,
                   tc_rate: float | None = None,
                   site_positions: np.ndarray | None = None,
                   ins_rate=None, del_rate=None
                   ) -> tuple[np.ndarray, np.ndarray, SimTruth]:
    """-> (codes int8 [n, read_len], lengths int32 [n], SimTruth).

    site_positions: optional packed coordinates of crosslink sites; when
    given, reads are sampled to overlap a site and conversions only occur at
    machine-frame Ts within +-2 of the site (binding-site mode for the
    cluster-calling config); otherwise positions are uniform over N-free
    windows and every T converts i.i.d.

    ins_rate/del_rate (SURVEY.md §3.4 "sequencing errors per profile"):
    scalar per-cycle probability or a per-cycle array (ErrorProfile.
    indel_rates()). At most one indel per read — events are <<1%/cycle so
    doubles are O(rate^2) — drawn over interior cycles [4, L-4) so the
    alignment's genome START is unchanged by the event and truth comparison
    stays exact (the CIGAR gains a 1I/1D in the middle).

    Runs on the CPU backend when one exists, so the simulated data is the
    same array on every backend (threefry streams are platform-
    deterministic, and the CPU pin also keeps every op's lowering fixed).
    Simulation is benchmark set-up, not device work.
    """
    import contextlib

    try:
        ctx = jax.default_device(jax.devices("cpu")[0])
    except RuntimeError:
        ctx = contextlib.nullcontext()
    with ctx:
        return _simulate_impl(ref, n, read_len, cfg, seed, profile_probs,
                              tc_rate, site_positions, ins_rate, del_rate)


def _simulate_impl(ref, n, read_len, cfg, seed, profile_probs, tc_rate,
                   site_positions, ins_rate, del_rate):
    tc_rate = cfg.sim_tc_rate if tc_rate is None else tc_rate
    seed = cfg.seed if seed is None else seed
    key = jax.random.PRNGKey(seed)
    k_pos, k_strand, k_tc, k_err, k_errbase = jax.random.split(key, 5)
    # fold_in (not a 6-way split): keeps the no-indel random stream identical
    # to earlier versions, so indel-free datasets are bit-stable across seeds
    k_indel = jax.random.fold_in(key, 0x1D3)

    # one optional indel per read: kind (0/1/2) + machine cycle, positioned
    # per the per-cycle rate vectors restricted to the interior
    L = read_len
    lo = min(4, max(1, L // 4))
    hi = max(L - lo, lo + 1)
    ins_v = _indel_rate_vec(ins_rate, L, lo, hi)
    del_v = _indel_rate_vec(del_rate, L, lo, hi)
    p_ins, p_del = float(ins_v.sum()), float(del_v.sum())
    if p_ins + p_del > 0.9:
        raise ValueError(
            f"per-read indel probability {p_ins + p_del:.3f} too high for "
            "the one-event model (sum of per-cycle rates must be << 1)")
    # a deletion reads one base past the window: size the N-free window for it
    win = read_len + (1 if p_del > 0 else 0)

    if site_positions is not None:
        sites = np.asarray(site_positions, dtype=np.int64)
        k_site, k_off = jax.random.split(k_pos)
        si = jax.random.randint(k_site, (n,), 0, sites.shape[0])
        # read must cover the site: offset of site within read in [2, L-3]
        off = jax.random.randint(k_off, (n,), 2, read_len - 2)
        pos = jnp.asarray(sites)[si] - off
        site_off = off
    else:
        starts = _valid_starts(ref, win)
        idx = jax.random.randint(k_pos, (n,), 0, starts.shape[0])
        pos = jnp.asarray(starts)[idx]
        site_off = None

    strand = jax.random.bernoulli(k_strand, 0.5, (n,)).astype(jnp.int8)

    seq_dev = jnp.asarray(ref.seq)
    G = ref.total_len
    i = jnp.arange(L)
    if p_ins + p_del > 0:
        k_kind, k_ipos, k_dpos, k_ibase = jax.random.split(k_indel, 4)
        u = jax.random.uniform(k_kind, (n,))
        kind = jnp.where(u < p_ins, 1,
                         jnp.where(u < p_ins + p_del, 2, 0)).astype(jnp.int32)
        jpos_i = jax.random.categorical(
            k_ipos, jnp.log(jnp.asarray(ins_v) + 1e-30), shape=(n,))
        jpos_d = jax.random.categorical(
            k_dpos, jnp.log(jnp.asarray(del_v) + 1e-30), shape=(n,))
        jpos = jnp.where(kind == 1, jpos_i, jpos_d).astype(jnp.int32)
        ibase = jax.random.randint(k_ibase, (n,), 0, 4)
    else:
        kind = jnp.zeros(n, dtype=jnp.int32)
        jpos = jnp.zeros(n, dtype=jnp.int32)
        ibase = jnp.zeros(n, dtype=jnp.int32)

    # machine cycle i -> genome offset within the source window. A deletion
    # skips one genome base after cycle j; an insertion repeats none (cycle j
    # is a random base); reverse-strand reads walk the window top-down.
    after_d = (i[None, :] >= jpos[:, None]).astype(jnp.int32)
    after_i = (i[None, :] > jpos[:, None]).astype(jnp.int32)
    g_fwd = jnp.where(kind[:, None] == 2, i[None, :] + after_d,
                      jnp.where(kind[:, None] == 1, i[None, :] - after_i,
                                i[None, :]))
    span = (L + (kind == 2).astype(jnp.int32)
            - (kind == 1).astype(jnp.int32))
    g = jnp.where(strand[:, None] == 1, span[:, None] - 1 - g_fwd, g_fwd)
    ridx = jnp.clip(pos[:, None] + g, 0, G - 1)
    frag = seq_dev[ridx].astype(jnp.int32)
    comp = jnp.asarray([3, 2, 1, 0, 4])
    machine = jnp.where(strand[:, None] == 1, comp[frag], frag)
    machine = jnp.where((kind[:, None] == 1) & (i[None, :] == jpos[:, None]),
                        ibase[:, None], machine)

    # T->C conversions (machine frame: PAR-CLIP conversions always read T->C)
    u_tc = jax.random.uniform(k_tc, (n, read_len))
    conv_ok = (machine == T) & (u_tc < tc_rate)
    if site_off is not None:
        # restrict to +-2 around the crosslink site, in machine coordinates
        m_off = jnp.where(strand == 1, read_len - 1 - site_off, site_off)
        near = jnp.abs(i[None, :] - m_off[:, None]) <= 2
        conv_ok = conv_ok & near
    converted = jnp.where(conv_ok, C, machine)

    # sequencing errors
    if profile_probs is not None:
        p = np.asarray(profile_probs, dtype=np.float64)[:read_len]
        logits = jnp.log(jnp.asarray(p, dtype=jnp.float32) + 1e-12)
        row = logits[i[None, :], converted]          # [n, L, 4]
        drawn = jax.random.categorical(k_err, row, axis=-1)
        final = drawn.astype(jnp.int32)
    else:
        u_err = jax.random.uniform(k_err, (n, read_len))
        shift = jax.random.randint(k_errbase, (n, read_len), 1, 4)
        err = u_err < cfg.sim_error_rate
        final = jnp.where(err, (converted + shift) % 4, converted)

    n_conv = jnp.sum(conv_ok, axis=1).astype(jnp.int32)
    n_err = jnp.sum(final != converted, axis=1).astype(jnp.int32)

    codes = np.asarray(final, dtype=np.int8)
    pos_np = np.asarray(pos, dtype=np.int64)
    ci, local = ref.locate(pos_np)
    truth = SimTruth(packed_pos=pos_np, chrom_idx=ci.astype(np.int32),
                     local_pos=local, strand=np.asarray(strand, dtype=np.int8),
                     n_conversions=np.asarray(n_conv),
                     n_errors=np.asarray(n_err),
                     indel_kind=np.asarray(kind, dtype=np.int8),
                     indel_pos=np.asarray(jpos, dtype=np.int32))
    lengths = np.full(n, read_len, dtype=np.int32)
    return codes, lengths, truth


def simulate_quality(n: int, read_len: int, seed: int = 0) -> np.ndarray:
    """Plausible per-cycle phred+33 quality strings (VERDICT r3 weak #8:
    benchmark FASTQs were uniform 'III…', leaving qual-aware features with
    no test substrate and SAM QUAL reversal untested on realistic data).

    Model: Illumina-shaped decay — mean quality starts ~Q38 and falls ~Q12
    by the last cycle, with per-base Gaussian jitter (sigma 3), clipped to
    [2, 40]. Deterministic in (n, read_len, seed); the aligner ignores
    QUAL for scoring (as bwa aln does), so this only shapes I/O surfaces.

    -> uint8 [n, read_len] ASCII (phred+33).
    """
    rng = np.random.default_rng(seed + 0x51AC)
    i = np.arange(read_len, dtype=np.float64)
    mean = 38.0 - 12.0 * i / max(read_len - 1, 1)
    q = mean[None, :] + rng.normal(0.0, 3.0, size=(n, read_len))
    q = np.clip(np.rint(q), 2, 40).astype(np.uint8)
    return q + 33


def simulate_binding_sites(ref: PackedReference, n_sites: int, read_len: int,
                           seed: int = 0) -> np.ndarray:
    """Sample crosslink-site packed coordinates (machine-frame T positions
    are not enforced; conversion masking handles that)."""
    rng = np.random.default_rng(seed)
    starts = _valid_starts(ref, read_len)
    # keep sites far enough from window edges for any offset
    ok = starts[(starts > read_len) & (starts < ref.total_len - 2 * read_len)]
    return np.sort(rng.choice(ok, size=n_sites, replace=False))
