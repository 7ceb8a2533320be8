"""3-bit packed reference words — a gather-minimizing reference layout.

Random access into the reference (ungapped-NM re-checks in finalize) is done
by element gathers. Packing 10 bases at 3 bits each (codes 0-3 = ACGT, 4 = N)
into one int32 word cuts the gathered element count 10x vs int8 bases and
needs a single gather stream (a 2-bit + N-mask split would need two).
Whether this pays on a GPU is not measured yet.

Unpacking is integer arithmetic (variable shifts); the only non-shift cost
is the base//10 decomposition, done once per window.
"""

from __future__ import annotations

import jax.numpy as jnp

BASES_PER_WORD = 10  # 3 bits per base; 30 of 32 bits used


def pack_reference(ref_seq: jnp.ndarray) -> jnp.ndarray:
    """int8 codes [G] -> int32 words [ceil(G/10)], 10 bases x 3 bits (N=4).

    Recomputed inside the jit per batch: it is a reshape + shifted add over
    G/10 words, microseconds next to the gathers it feeds, and keeps
    DeviceIndex's layout unchanged everywhere. XLA CSEs the computation across
    pipeline stages under one jit.
    """
    G = ref_seq.shape[0]
    Gp = ((G + BASES_PER_WORD - 1) // BASES_PER_WORD) * BASES_PER_WORD
    seq_p = jnp.pad(ref_seq, (0, Gp - G), constant_values=4)
    s = seq_p.reshape(Gp // BASES_PER_WORD, BASES_PER_WORD).astype(jnp.int32)
    shifts = (jnp.arange(BASES_PER_WORD, dtype=jnp.int32) * 3)[None, :]
    return jnp.sum(s << shifts, axis=1)


def split_base(pos: jnp.ndarray):
    """pos -> (word index, in-word base offset), floor semantics for pos < 0."""
    q = jnp.floor_divide(pos, BASES_PER_WORD)
    return q, pos - q * BASES_PER_WORD


def gather_window_rows(words: jnp.ndarray, base_q: jnp.ndarray, n_rows: int):
    """words[clip(base_q + r)] for r in [0, n_rows) -> [n_rows, *base_q.shape].

    Rows whose true index falls outside [0, NW) are clipped; callers mask the
    corresponding absolute positions (off < 0 or off >= G) to N themselves —
    for any in-range position the row index is in range by construction.
    """
    nw = words.shape[0]
    r = jnp.arange(n_rows, dtype=jnp.int32)
    widx = jnp.clip(base_q[None, ...] + r.reshape((n_rows,) + (1,) * base_q.ndim),
                    0, nw - 1)
    return words[widx]


def unpack_positions(window_rows: jnp.ndarray, base_r: jnp.ndarray,
                     offsets: jnp.ndarray) -> jnp.ndarray:
    """Decode codes at (base + offsets) from gathered window rows.

    window_rows: [B, n_rows] int32 (from gather_window_rows, transposed)
    base_r:      [B] in-word offset of the window base
    offsets:     [L] positions relative to the base
    Returns codes [B, L] in 0..4. Row selection is an arithmetic select chain
    (n_rows terms), not a gather — n_rows is tiny and static.
    """
    x = base_r[:, None] + offsets[None, :]
    rel = x // BASES_PER_WORD
    xm = x - rel * BASES_PER_WORD
    word = jnp.zeros(x.shape, dtype=jnp.int32)
    for r in range(window_rows.shape[1]):
        word = jnp.where(rel == r, window_rows[:, r : r + 1], word)
    return (word >> (xm * 3)) & 7
