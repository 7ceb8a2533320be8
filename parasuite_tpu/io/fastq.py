"""FASTQ reader/writer + fixed-shape batch iterator.

Reference equivalent: htsjdk FASTQ parsing inside the Java toolkit
(SURVEY.md §2 component 9). Here parsing is a host-side streaming pass that
emits ReadBatch objects sized for the device (pad-to-L, pad-to-B), which is
the contract the device pipeline needs.

A C++ fast path (native/parasuite_native) can replace the Python tokenizer;
the Python version is the always-available fallback with identical output.
"""

from __future__ import annotations

import gzip
from pathlib import Path
from typing import Iterator

import numpy as np

from parasuite_tpu.io.batch import ReadBatch
from parasuite_tpu.utils.dna import decode_seq, encode_seq


def _open(path, mode="rb"):
    path = Path(path)
    if path.suffix == ".gz":
        return gzip.open(path, mode)
    return open(path, mode)


def _iter_records(path) -> Iterator[tuple[str, bytes, bytes]]:
    """Yield (name, seq_ascii, qual_ascii) triples."""
    with _open(path) as fh:
        while True:
            hdr = fh.readline()
            if not hdr:
                return
            hdr = hdr.strip()
            if not hdr:
                continue
            if not hdr.startswith(b"@"):
                raise ValueError(f"bad FASTQ header line: {hdr[:50]!r}")
            seq = fh.readline().strip()
            plus = fh.readline()
            if not plus.startswith(b"+"):
                raise ValueError("bad FASTQ separator line")
            qual = fh.readline().strip()
            name = hdr[1:].split()[0].decode("ascii")
            yield name, seq, qual


def iter_fastq_batches(path, batch_size: int, max_len: int,
                       stride_shards: int = 1,
                       shard_index: int = 0,
                       use_native: bool | None = None) -> Iterator[ReadBatch]:
    """Stream FASTQ as fixed-shape ReadBatches.

    Multi-host sharding (SURVEY.md §2 component 12): host h of H takes records
    with (record_index // batch_size) % H == h, i.e. whole batches round-robin,
    so every shard count yields the same set of (read, global index) pairs and
    merged output order is derivable from read indices alone (determinism test
    SURVEY.md §4.5).

    The hot path is the C++ chunk scanner (ps_fastq_scan — tokenize + 2-bit
    encode straight into the fixed-shape batch arrays); the Python tokenizer
    is the always-available fallback with bit-identical batches
    (tests/test_io.py::test_iter_batches_native_parity).
    """
    if use_native is None:
        from parasuite_tpu import native
        use_native = native.available()
    it = (_iter_groups_native(path, batch_size, max_len) if use_native
          else _iter_groups_python(path, batch_size, max_len))
    for group_idx, group in enumerate(it):
        if group_idx % stride_shards != shard_index:
            continue
        codes, lengths, names, quals = group
        yield ReadBatch(codes=codes, lengths=lengths, names=names, quals=quals)


def _iter_groups_python(path, batch_size: int, max_len: int):
    """Yield (codes, lengths, names, quals) groups of <= batch_size records
    in file order (fixed-shape arrays padded to batch_size)."""
    names: list[str] = []
    seqs: list[np.ndarray] = []
    quals: list[bytes] = []

    def flush():
        b = ReadBatch.from_arrays(seqs, names, quals, max_len,
                                  pad_to=batch_size)
        out = (b.codes, b.lengths, b.names, b.quals)
        names.clear(), seqs.clear(), quals.clear()
        return out

    for name, seq, qual in _iter_records(path):
        names.append(name)
        seqs.append(encode_seq(seq))
        quals.append(qual[:max_len])
        if len(names) == batch_size:
            yield flush()
    if names:
        yield flush()


_NATIVE_CHUNK = 4 << 20


def _iter_groups_native(path, batch_size: int, max_len: int):
    """C++ scanner-backed group iterator (same contract as the Python one).

    Chunked file reads; only line-complete prefixes are handed to the
    scanner mid-file (a chunk boundary inside the quality line must not
    commit a truncated record), the raw tail goes to the scanner only at
    EOF."""
    from parasuite_tpu import native
    from parasuite_tpu.io.batch import NameBlock

    codes = np.full((batch_size, max_len), 4, dtype=np.int8)
    lengths = np.zeros(batch_size, dtype=np.int32)
    quals = np.full((batch_size, max_len), ord("I"), dtype=np.uint8)
    name_parts: list[NameBlock] = []
    nfill = 0
    buf = bytearray()
    with _open(path) as fh:
        eof = False
        while True:
            if not eof:
                chunk = fh.read(_NATIVE_CHUNK)
                if not chunk:
                    eof = True
                else:
                    buf += chunk
            scan_end = len(buf) if eof else buf.rfind(b"\n") + 1
            while scan_end > 0:
                # in-place scan of the line-complete prefix (no copy)
                n, consumed, c, ln, nm, q = native.fastq_scan_chunk(
                    buf, batch_size - nfill, max_len, length=scan_end)
                if n == 0:
                    break
                del buf[:consumed]
                scan_end -= consumed
                if nfill == 0 and n == batch_size:
                    codes, lengths, quals = c, ln, q  # whole batch: no copy
                else:
                    codes[nfill:nfill + n] = c[:n]
                    lengths[nfill:nfill + n] = ln[:n]
                    quals[nfill:nfill + n] = q[:n]
                name_parts.append(nm)
                nfill += n
                if nfill == batch_size:
                    yield codes, lengths, NameBlock.concat(name_parts), quals
                    codes = np.full((batch_size, max_len), 4, dtype=np.int8)
                    lengths = np.zeros(batch_size, dtype=np.int32)
                    quals = np.full((batch_size, max_len), ord("I"),
                                    dtype=np.uint8)
                    name_parts, nfill = [], 0
            if eof:
                if buf.strip():
                    raise ValueError(
                        f"trailing unparseable FASTQ bytes: {bytes(buf[:50])!r}")
                if nfill:
                    yield codes, lengths, NameBlock.concat(name_parts), quals
                return


def count_fastq_records(path) -> int:
    """Record count in one cheap newline pass (4-line FASTQ records — the
    format both tokenizers assume). Used by the jax.distributed driver to
    agree on the global step count before any collective runs."""
    lines = 0
    last = b"\n"
    with _open(path) as fh:
        while True:
            chunk = fh.read(8 << 20)
            if not chunk:
                break
            lines += chunk.count(b"\n")
            last = chunk[-1:]
    if last != b"\n":
        lines += 1  # final record without trailing newline
    return lines // 4


def read_fastq(path, max_len: int, batch_size: int | None = None) -> ReadBatch:
    """Read an entire FASTQ into one ReadBatch (pad count to batch multiple)."""
    names, seqs, quals = [], [], []
    for name, seq, qual in _iter_records(path):
        names.append(name)
        seqs.append(encode_seq(seq))
        quals.append(qual)
    n = len(names)
    if batch_size:
        pad = ((n + batch_size - 1) // batch_size) * batch_size
    else:
        pad = n
    return ReadBatch.from_arrays(seqs, names, quals, max_len, pad_to=max(pad, 1))


def write_fastq(path, names: list[str], codes: np.ndarray,
                lengths: np.ndarray, quals=None) -> None:
    """quals: list[bytes], a uint8 [n, L] phred+33 matrix
    (sim.simulate_quality's layout), or None for constant 'I'."""
    with _open(path, "wb") as fh:
        for i, name in enumerate(names):
            ln = int(lengths[i])
            seq = decode_seq(codes[i, :ln]).encode("ascii")
            if quals is None:
                q = b"I" * ln
            elif isinstance(quals, np.ndarray):
                q = quals[i, :ln].tobytes()
            else:
                q = quals[i]
            fh.write(b"@" + name.encode("ascii") + b"\n" + seq + b"\n+\n" + q + b"\n")
