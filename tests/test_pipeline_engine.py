"""Engine selection around the device leg: a failing device raises (no
silent host fallback), and the persistent compile cache lands where the
environment says, or at the fixed in-checkout path."""

import io
import os

import pytest

import mtr.pipeline as P
from mtr.config import MTRConfig

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def test_failing_device_leg_raises(monkeypatch):
    # every counts job "big", engagement gate off: the device leg runs
    monkeypatch.setenv("MTR_MIN_DEVICE_CELLS", "0")
    batcher = P.HybridDPBatcher(cell_threshold=1)

    def broken(self, jobs):
        raise RuntimeError("synthetic device failure")

    monkeypatch.setattr(P.WrapDPBatcher, "_run", broken)
    monkeypatch.setattr(P, "make_batcher", lambda cfg: batcher)
    with pytest.raises(RuntimeError, match="synthetic device failure"):
        P.run_file(os.path.join(GOLDEN, "multi20_100x10.fasta"),
                   MTRConfig(backend="hybrid"), io.StringIO())


@pytest.mark.parametrize("env_set", [True, False], ids=["env", "default"])
def test_compile_cache_dir(monkeypatch, tmp_path, env_set):
    import jax

    before = jax.config.jax_compilation_cache_dir
    try:
        if env_set:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
            assert P.enable_compile_cache() == str(tmp_path)
            # JAX reads the variable itself; nothing else is set
            assert jax.config.jax_compilation_cache_dir == before
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            want = os.path.join(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))), ".jax_cache")
            assert P.enable_compile_cache() == want
            assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
