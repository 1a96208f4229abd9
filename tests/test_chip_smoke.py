"""chip_smoke.py refuses to run without a GPU, and the helpers it shares
with bench.py (compile cache, decoder settings) behave on the CPU."""
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_smoke(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_exits_nonzero_without_gpu():
    r = _run_smoke(REPO, os.path.join(REPO, "chip_smoke.py"))
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    assert '"ok"' not in r.stdout


def test_chip_smoke_alone_prints_no_result(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run_smoke(str(tmp_path), "chip_smoke.py")
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.parametrize("env_dir", [None, "custom"])
def test_compile_cache_dir(monkeypatch, tmp_path, env_dir):
    import jax
    from openair4g_tpu.utils import compile_cache
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    if env_dir is None:
        monkeypatch.delenv(compile_cache.ENV, raising=False)
        assert compile_cache.enable_compile_cache() == \
            os.path.join(REPO, ".jax_cache")
        assert calls == [("jax_compilation_cache_dir",
                          os.path.join(REPO, ".jax_cache"))]
    else:
        path = str(tmp_path / env_dir)
        monkeypatch.setenv(compile_cache.ENV, path)
        assert compile_cache.enable_compile_cache() == path
        assert calls == []          # JAX reads the variable itself


def test_compile_cache_dir_is_git_ignored():
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_decoder_settings_cpu_entry():
    from openair4g_tpu.ops.decoder_settings import decoder_settings
    s = decoder_settings("cpu")
    assert (s.window, s.warmup, s.unroll, s.half_iter) == (96, 24, 2, "xla")
    assert decoder_settings() == s      # the tests run on the CPU


def test_decoder_settings_gpu_entry_uses_the_kernel():
    from openair4g_tpu.ops.decoder_settings import decoder_settings
    s = decoder_settings("gpu")
    assert s.half_iter in ("triton", "xla")
    assert s.warmup <= s.window and s.lanes % 32 == 0


@pytest.mark.parametrize("platform", ["rocm", "metal", "neuron"])
def test_decoder_settings_unknown_platform_raises(platform):
    from openair4g_tpu.ops.decoder_settings import decoder_settings
    with pytest.raises(ValueError, match=platform):
        decoder_settings(platform)
