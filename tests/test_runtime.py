"""Run-time setup shared by the entry points (cfd_tpu.runtime) and the
entry points' refusal to run without a GPU: the compile cache's placement,
the device report, and chip_smoke.py / bench.py exiting non-zero on a
CPU-only host without printing a result."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest

from cfd_tpu import runtime

ROOT = Path(__file__).resolve().parent.parent


def _python(code_or_args, env_extra=None, env_drop=(), cwd=ROOT):
    env = {k: v for k, v in os.environ.items() if k not in env_drop}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = str(ROOT)
    env.update(env_extra or {})
    args = (["-c", code_or_args] if isinstance(code_or_args, str)
            else code_or_args)
    return subprocess.run([sys.executable, *args], capture_output=True,
                          text=True, env=env, cwd=cwd, timeout=300)


CACHE_PROBE = ("import jax; from cfd_tpu.runtime import enable_compile_cache;"
               " print(enable_compile_cache());"
               " print(jax.config.jax_compilation_cache_dir)")


def test_compile_cache_honours_env_dir(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, the cache goes there, read by
    JAX itself."""
    out = _python(CACHE_PROBE,
                  env_extra={"JAX_COMPILATION_CACHE_DIR": str(tmp_path)})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == [str(tmp_path), str(tmp_path)]


def test_compile_cache_defaults_into_the_checkout():
    """Without the variable, the cache goes to <repo>/.jax_cache, which git
    ignores."""
    out = _python(CACHE_PROBE, env_drop=("JAX_COMPILATION_CACHE_DIR",))
    assert out.returncode == 0, out.stderr[-2000:]
    want = str(ROOT / ".jax_cache")
    assert out.stdout.split() == [want, want]
    assert runtime.REPO_CACHE_DIR == ROOT / ".jax_cache"
    assert ".jax_cache/" in (ROOT / ".gitignore").read_text().splitlines()


def test_device_info_on_cpu():
    info = runtime.device_info()
    assert info == {"platform": "cpu", "kind": jax.devices()[0].device_kind,
                    "count": len(jax.devices()), "card": None}


def test_card_is_none_without_nvidia_smi(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    assert runtime.card() is None


@pytest.mark.parametrize("args", [[], ["--four-cards"]],
                         ids=["one-card", "four-cards"])
def test_chip_smoke_fails_without_gpu(args):
    out = _python([str(ROOT / "chip_smoke.py"), *args])
    assert out.returncode != 0
    assert "no GPU" in out.stderr
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    """Copied into a directory without the package, the script refuses to
    run rather than import some other installation."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, str(lone)], capture_output=True,
                         text=True, env=env, cwd=tmp_path, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_bench_fails_without_gpu():
    out = _python([str(ROOT / "bench.py")])
    assert out.returncode != 0
    assert "GPU" in out.stderr
    assert out.stdout.strip() == ""


@pytest.mark.parametrize("mg,match", [
    ("pre_sweeps=two", "not a number"),
    ("coarse_dtype=bfloat16", "unknown MGConfig field"),
], ids=["not-a-number", "removed-field"])
def test_cli_rejects_bad_mg_override(mg, match):
    from cfd_tpu import cli

    with pytest.raises(SystemExit, match=match):
        cli.main(["cavity", "--poisson", "multigrid", "--Nx", "32",
                  "--Ny", "32", "--mg", mg, "--steps", "1", "--no-vtk",
                  "--no-color"])
