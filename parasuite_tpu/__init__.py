"""parasuite_tpu — a PAR-CLIP read-analysis engine on JAX.

A from-scratch re-design of the capabilities of akloetgen/PARA-suite
(error-profile-aware short-read alignment for PAR-CLIP data, plus the
surrounding toolkit: error-profile inference, combined genome+transcriptome
references, read simulation, benchmarking, and binding-site cluster calling)
built on JAX / XLA for one GPU or several.

Reference provenance: at build time /root/reference was an empty mount (see
SURVEY.md header); the capability spec comes from BASELINE.json:north_star and
SURVEY.md §2. Upstream-file citations in docstrings use the upstream names
(e.g. BWA bwtgap.c) pending the mount, per SURVEY.md §8.

Layering (SURVEY.md §1):
    io       -- FASTA/FASTQ/SAM codecs, fixed-shape read batching
    index    -- 2-bit packed reference + k-mer seeding index
    oracle   -- slow, obviously-correct numpy aligner (the executable spec)
    ops      -- jnp device stages: seeding, banded affine-gap DP
    errormodel -- error-profile inference + log-odds scoring tensors
    sim      -- PAR-CLIP read simulator
    pipeline -- single-pass align, two-pass, combined ref, cluster calling
    parallel -- device mesh, shard_map data parallelism, collectives
    benchkit -- sensitivity/precision evaluation + throughput harness
    cli      -- subcommand dispatcher (PARA-suite toolkit equivalent)
"""

__version__ = "0.1.0"

from parasuite_tpu.config import AlignConfig  # noqa: F401
