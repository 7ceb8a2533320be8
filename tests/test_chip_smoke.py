"""chip_smoke.py's phases at tiny size on the CPU, its refusal to run without a GPU, and the per-process device
plumbing it relies on: the compile-cache helper and one card per child."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402

BATCH, L, K = 256, 50, 10


@pytest.fixture(scope="module")
def smoke_run(tmp_path_factory):
    """index -> simulate -> twopass at tiny size through chip_smoke's phase
    functions (cli.main in-process, as on the card)."""
    work = tmp_path_factory.mktemp("smoke")
    ref = chip_smoke.build_reference(work, scale=0.004, k=K)
    sim = chip_smoke.simulate(work, n_reads=1000, read_len=L, seed=3)
    tp = chip_smoke.twopass(work, BATCH, L, K)
    return work, ref, sim, tp


def test_pipeline_phases(smoke_run):
    work, ref, sim, tp = smoke_run
    assert ref["packed_len"] > 200_000
    assert sim["reads"] == tp["reads"] == 1000
    for p in ("pass1", "pass2"):
        assert tp[f"{p}_reads_per_s"] > 0
        assert tp[f"{p}_steady_reads_per_s"] > 0
    sc = chip_smoke.sort_and_cluster(work)
    assert 0 < sc["sorted_records"] <= 1000
    assert sc["clusters"] >= 0
    acc = chip_smoke.accuracy(work)
    assert acc["reads"] == 1000
    assert acc["sensitivity"] > 0.9 and acc["precision"] > 0.95


def test_oracle_parity_phase(smoke_run):
    work = smoke_run[0]
    par = chip_smoke.oracle_parity(work, 96, BATCH, L, K, workers=2)
    assert par["reads"] == 96 and par["mapped"] > 80
    assert par["mismatches"] == 0


def test_device_step_phase(smoke_run):
    work = smoke_run[0]
    ds = chip_smoke.device_step(work, BATCH, L, K, timed_calls=1)
    assert len(ds["step_ms"]) == 1 and ds["step_ms_median"] > 0
    assert ds["compile_s"] > 0 and ds["temp_bytes"] > 0
    assert "select_share" in ds and "top" in ds


def test_exits_nonzero_without_gpu(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                       cwd=tmp_path, env=env, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout


def test_compile_cache_helper_env_set(monkeypatch, tmp_path):
    from parasuite_tpu.utils import jaxcache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert jaxcache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # nothing set


def test_compile_cache_helper_env_unset(monkeypatch):
    from parasuite_tpu.utils import jaxcache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        got = jaxcache.enable_compile_cache()
        assert got == str(REPO / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == got
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


@pytest.mark.parametrize("n_cards,n_hosts", [(4, 4), (4, 2), (2, 3), (0, 2)])
def test_host_envs_one_card_each(monkeypatch, n_cards, n_hosts):
    from parasuite_tpu.parallel import multihost

    monkeypatch.setattr(multihost, "_gpu_ids",
                        lambda: [str(i) for i in range(n_cards)])
    base = {"PATH": "/bin"}
    if 0 < n_cards < n_hosts:
        with pytest.raises(RuntimeError, match="need one GPU each"):
            multihost.host_envs(n_hosts, base)
        return
    envs = multihost.host_envs(n_hosts, base)
    assert len(envs) == n_hosts and all(e["PATH"] == "/bin" for e in envs)
    vis = [e.get("CUDA_VISIBLE_DEVICES") for e in envs]
    assert vis == ([str(h) for h in range(n_hosts)] if n_cards
                   else [None] * n_hosts)
    cpu = multihost.host_envs(n_hosts, {"JAX_PLATFORMS": "cpu"})
    assert all("CUDA_VISIBLE_DEVICES" not in e for e in cpu)


def test_local_device_ids(monkeypatch):
    from parasuite_tpu.parallel.distributed import local_device_ids

    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    assert local_device_ids("localhost:1234", 4, 2) == [2]
    assert local_device_ids("127.0.0.1:1", 2, 1) == [1]
    assert local_device_ids("localhost:1234", 1, 0) is None
    assert local_device_ids("10.1.2.3:99", 4, 2) is None
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "3")
    assert local_device_ids("localhost:1234", 4, 2) is None
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES")
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    assert local_device_ids("localhost:1234", 4, 2) is None
