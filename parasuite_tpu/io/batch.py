"""Fixed-shape read batches.

XLA requires static shapes (SURVEY.md §7): reads are padded to
cfg.max_read_len and batches to cfg.batch_size. Padding reads have length 0
and are masked out everywhere downstream. Names stay host-side (they never
touch the device; SAM emission re-joins them by read index).

quals is a FIXED-SHAPE uint8 matrix, not a list of bytes: the C++ FASTQ
scanner writes it directly and the C++ SAM formatter consumes it directly,
so the hot path never loops over records in Python. A list[bytes] passed to
the constructor or from_arrays is converted (convenience for tests/tools).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

_PAD_QUAL = ord("I")


class NameBlock:
    """Lazy read-name store: one ASCII bytes blob + int64 record offsets.

    The C++ FASTQ scanner emits names in exactly this layout and the C++ SAM
    formatter consumes it unchanged, so the hot path never materializes
    per-record Python strings (measured ~0.45us/record of GIL-held Python —
    the GIL is the whole-pipeline budget since reader/main/writer threads
    share it). Behaves like a read-only list[str] for the slow paths.
    """

    __slots__ = ("blob", "off")

    def __init__(self, blob: bytes, off: np.ndarray):
        self.blob = blob
        self.off = off  # int64 [n + 1]

    def __len__(self) -> int:
        return int(self.off.shape[0]) - 1

    def __getitem__(self, i):
        if isinstance(i, slice):
            start, stop, step = i.indices(len(self))
            if step != 1:
                raise ValueError("NameBlock slices must be contiguous")
            return [self[j] for j in range(start, stop)]
        return self.blob[int(self.off[i]) : int(self.off[i + 1])].decode(
            "ascii")

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __eq__(self, other):
        if isinstance(other, NameBlock):
            return self.blob == other.blob and np.array_equal(self.off,
                                                              other.off)
        if isinstance(other, list):
            return list(self) == other
        return NotImplemented

    def raw(self, b: int = 0, e: int | None = None) -> tuple[bytes, np.ndarray]:
        """(blob, offsets) rebased to records [b, e) — the native formatter's
        input layout, produced with zero per-record work."""
        if e is None:
            e = len(self)
        o = self.off[b : e + 1]
        return self.blob[int(o[0]) : int(o[-1])], o - o[0]

    @classmethod
    def concat(cls, parts: list["NameBlock"]) -> "NameBlock":
        if len(parts) == 1:
            return parts[0]
        blob = b"".join(p.blob for p in parts)
        offs = [parts[0].off]
        base = int(parts[0].off[-1])
        for p in parts[1:]:
            offs.append(p.off[1:] + base)
            base += int(p.off[-1])
        return cls(blob, np.concatenate(offs))

    @classmethod
    def from_list(cls, names: list[str]) -> "NameBlock":
        off = np.zeros(len(names) + 1, dtype=np.int64)
        np.cumsum([len(s) for s in names], out=off[1:])
        return cls("".join(names).encode("ascii"), off)


def _quals_matrix(quals, lengths: np.ndarray, b: int, max_len: int) -> np.ndarray:
    mat = np.full((b, max_len), _PAD_QUAL, dtype=np.uint8)
    for i, q in enumerate(quals):
        ln = min(len(q), max_len)
        if ln:
            mat[i, :ln] = np.frombuffer(q[:ln], dtype=np.uint8)
    return mat


@dataclass
class ReadBatch:
    """A fixed-shape batch of reads.

    codes:   int8  [B, L]  base codes 0..4; positions >= length are N(4)
    lengths: int32 [B]     true read lengths (0 for padding rows)
    names:   list[str]     length n_real (host-side only)
    quals:   uint8 [B, L]  phred+33 ASCII, 'I'-padded (host-side only)
    """

    codes: np.ndarray
    lengths: np.ndarray
    names: list = field(default_factory=list)
    quals: np.ndarray | list | None = None

    def __post_init__(self):
        if self.quals is None:
            self.quals = np.full(self.codes.shape, _PAD_QUAL, dtype=np.uint8)
        elif isinstance(self.quals, list):
            self.quals = _quals_matrix(self.quals, self.lengths,
                                       self.codes.shape[0],
                                       self.codes.shape[1])

    @property
    def n_total(self) -> int:
        return int(self.codes.shape[0])

    @property
    def n_real(self) -> int:
        return len(self.names)

    @property
    def max_len(self) -> int:
        return int(self.codes.shape[1])

    def qual_bytes(self, i: int) -> bytes:
        """Quality string for read i (true length), as phred+33 bytes."""
        return self.quals[i, : int(self.lengths[i])].tobytes()

    @classmethod
    def from_arrays(cls, seq_codes: list[np.ndarray], names: list[str],
                    quals, max_len: int,
                    pad_to: int | None = None) -> "ReadBatch":
        n = len(seq_codes)
        b = pad_to if pad_to is not None else n
        assert b >= n
        codes = np.full((b, max_len), 4, dtype=np.int8)  # N padding
        lengths = np.zeros(b, dtype=np.int32)
        for i, sc in enumerate(seq_codes):
            ln = min(len(sc), max_len)
            codes[i, :ln] = sc[:ln]
            lengths[i] = ln
        return cls(codes=codes, lengths=lengths, names=list(names),
                   quals=quals)
