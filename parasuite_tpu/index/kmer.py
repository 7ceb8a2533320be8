"""Dense k-mer hash index — the device seeding structure.

Replaces BWA's BWT/FM-index + occ tables (upstream bwtindex.c / bwt.c;
SURVEY.md §2 components 5-6). Rationale (SURVEY.md §7 "Design stance"): FM
backward search is a pointer-chasing DFS, hostile to XLA; a dense k-mer
bucket table turns seeding into two flat gathers:

    hits(code) = positions[bucket_starts[code] : bucket_starts[code + 1]]

Layout:
    bucket_starts: int32 [4^k + 1]   prefix sums of per-code occurrence counts
    positions:     int32 [n_kmers]   packed-reference positions, sorted by
                                     (code, position) — the position-ascending
                                     order inside each bucket is what makes
                                     candidate enumeration deterministic.

Construction is a counting sort (numpy; the C++ native fast path in
native/parasuite_native implements the same sort for large genomes).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from parasuite_tpu.index.reference import PackedReference
from parasuite_tpu.utils.dna import N


def kmer_codes(seq: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Rolling k-mer codes over an int8 code sequence.

    Returns (codes int64 [len-k+1], valid bool [len-k+1]); windows containing
    N are invalid. Code = base-4 big-endian over the window.
    """
    seq = np.asarray(seq)
    n = seq.shape[0] - k + 1
    if n <= 0:
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=bool)
    codes = np.zeros(n, dtype=np.int64)
    base = np.where(seq == N, 0, seq).astype(np.int64)
    is_n = (seq == N).astype(np.int64)
    n_cum = np.concatenate([[0], np.cumsum(is_n)])
    for t in range(k):
        codes = codes * 4 + base[t : t + n]
    valid = (n_cum[k:] - n_cum[:-k]) == 0
    return codes, valid


@dataclass
class KmerIndex:
    k: int
    bucket_starts: np.ndarray  # int32 [4^k + 1]
    positions: np.ndarray      # int32 [n_kmers]

    @classmethod
    def build(cls, seq: np.ndarray, k: int, use_native: str = "auto") -> "KmerIndex":
        """Counting sort: native C++ path when built (bit-identical contract
        enforced by tests/test_native.py), numpy otherwise."""
        if use_native != "never":
            from parasuite_tpu import native

            if native.available():
                starts_n, pos_n = native.kmer_index_build(seq, k)
                return cls(k=k, bucket_starts=starts_n, positions=pos_n)
            if use_native == "always":
                raise RuntimeError("native library requested but unavailable")
        codes, valid = kmer_codes(seq, k)
        pos = np.nonzero(valid)[0].astype(np.int64)
        vcodes = codes[pos]
        order = np.argsort(vcodes, kind="stable")  # (code, position) order
        sorted_pos = pos[order].astype(np.int32)
        counts = np.bincount(vcodes, minlength=4**k).astype(np.int64)
        starts = np.concatenate([[0], np.cumsum(counts)])
        if starts[-1] > np.iinfo(np.int32).max:
            raise ValueError("reference too large for int32 position index; shard it")
        return cls(k=k, bucket_starts=starts.astype(np.int32), positions=sorted_pos)

    @property
    def n_kmers(self) -> int:
        return int(self.positions.shape[0])

    def lookup(self, code: int) -> np.ndarray:
        """All packed positions of a k-mer code (ascending). Host-side helper."""
        s, e = int(self.bucket_starts[code]), int(self.bucket_starts[code + 1])
        return self.positions[s:e]

    # --- serialization ---
    def save(self, prefix) -> None:
        np.savez(str(prefix) + ".kidx.npz",
                 k=np.int64(self.k),
                 bucket_starts=self.bucket_starts,
                 positions=self.positions)

    @classmethod
    def load(cls, prefix) -> "KmerIndex":
        z = np.load(str(prefix) + ".kidx.npz")
        return cls(k=int(z["k"]), bucket_starts=z["bucket_starts"],
                   positions=z["positions"])


def build_index(ref: PackedReference, k: int):
    """Build the seeding index over a packed reference (spacers carry N and are
    therefore never indexed)."""
    return KmerIndex.build(ref.seq, k)
