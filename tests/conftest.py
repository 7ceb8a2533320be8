"""Test env: CPU backend with 8 virtual devices (SURVEY.md §4.4).

Must run before jax is imported anywhere — pytest imports conftest first.
Set PARASUITE_TEST_GPU=1 to run against the GPU instead (`pytest -m gpu`
runs the tests that need one; chip_smoke.py does so in its first phase).
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
if not os.environ.get("PARASUITE_TEST_GPU"):
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    # CPU test runs write no persistent compile cache (cli.main enables it)
    jax.config.update("jax_enable_compilation_cache", False)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from parasuite_tpu.config import AlignConfig  # noqa: E402
from parasuite_tpu.index import KmerIndex, PackedReference  # noqa: E402
from parasuite_tpu.utils.dna import encode_seq  # noqa: E402


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Tests marked `gpu` run only where JAX's default backend is a GPU."""
    if request.node.get_closest_marker("gpu") is not None:
        import jax

        if jax.default_backend() != "gpu":
            pytest.skip("needs a GPU: PARASUITE_TEST_GPU=1 pytest -m gpu")


@pytest.fixture(scope="session")
def small_cfg() -> AlignConfig:
    """Config sized for tiny test references."""
    return AlignConfig(max_read_len=50, batch_size=64, kmer_size=8,
                       max_seeds=4, max_occ=32, max_candidates=8,
                       band_width=3, chrom_spacer=64)


def _random_ref(rng: np.random.Generator, sizes: dict[str, int]) -> dict[str, np.ndarray]:
    return {name: rng.integers(0, 4, size=n).astype(np.int8)
            for name, n in sizes.items()}


@pytest.fixture(scope="session")
def tiny_ref(small_cfg) -> PackedReference:
    rng = np.random.default_rng(1234)
    seqs = _random_ref(rng, {"chrA": 5000, "chrB": 3000})
    # embed an N run to exercise N handling
    seqs["chrA"][1000:1010] = 4
    return PackedReference.from_dict(seqs, spacer=small_cfg.chrom_spacer)


@pytest.fixture(scope="session")
def tiny_index(tiny_ref, small_cfg) -> KmerIndex:
    return KmerIndex.build(tiny_ref.seq, small_cfg.kmer_size)


def sample_reads(rng: np.random.Generator, ref: PackedReference, n: int,
                 read_len: int, mutate: int = 0, revcomp_frac: float = 0.5,
                 indel: bool = False):
    """Extract reads from the reference with optional mutations.

    Returns (codes [n, read_len] int8, lengths [n], truth list of
    (chrom_idx, local_pos, strand)).
    """
    from parasuite_tpu.utils.dna import revcomp_codes

    codes = np.zeros((n, read_len), dtype=np.int8)
    lengths = np.full(n, read_len, dtype=np.int32)
    truth = []
    n_chrom = len(ref.names)
    for i in range(n):
        ci = int(rng.integers(0, n_chrom))
        start, end = int(ref.starts[ci]), int(ref.ends[ci])
        while True:
            p = int(rng.integers(start, end - read_len))
            frag = ref.seq[p : p + read_len].copy()
            if not np.any(frag == 4):
                break
        for _ in range(mutate):
            q = int(rng.integers(0, read_len))
            frag[q] = (frag[q] + 1 + rng.integers(0, 3)) % 4
        if indel and rng.random() < 0.5:
            # single-base deletion from the middle of the fragment, refilled
            # at the end so the read keeps its length
            q = int(rng.integers(5, read_len - 5))
            frag = np.concatenate([frag[:q], frag[q + 1 :],
                                   ref.seq[p + read_len : p + read_len + 1]])
        strand = 1 if rng.random() < revcomp_frac else 0
        if strand:
            frag = revcomp_codes(frag)
        codes[i] = frag
        truth.append((ci, p - start, strand))
    return codes, lengths, truth
