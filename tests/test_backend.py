"""Backend independence: where the compile cache lives, that the package
carries no accelerator-specific kernel imports or platform branches, and
that chip_smoke.py refuses to report a result without a GPU."""

import os
import pathlib
import re
import shutil
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "rankfm_tpu"


def _run(code, env_update, unset=()):
    env = dict(os.environ, **env_update)
    for k in unset:
        env.pop(k, None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=str(REPO), timeout=240)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip().splitlines()[-1]


_PRINT_CACHE = ("import jax, rankfm_tpu; print(rankfm_tpu.compile_cache_dir(),"
                " jax.config.jax_compilation_cache_dir,"
                " jax.config.jax_persistent_cache_min_compile_time_secs)")


def test_compile_cache_follows_env_when_set(tmp_path):
    """JAX_COMPILATION_CACHE_DIR set: that directory, and the package sets
    nothing of its own (the env's thresholds stay JAX's defaults)"""
    want = str(tmp_path / "cache")
    ours, jax_dir, min_secs = _run(
        _PRINT_CACHE, {"JAX_COMPILATION_CACHE_DIR": want}).split()
    assert ours == jax_dir == want
    assert float(min_secs) == 1.0          # JAX's default, untouched
    assert not any(p.name.startswith("host-")
                   for p in pathlib.Path(want).parent.iterdir())


def test_compile_cache_fixed_in_checkout_when_unset():
    """unset: one fixed directory beside the package, the same for every
    process of this machine (the path is part of the cache's key)"""
    import rankfm_tpu
    runs = {_run(_PRINT_CACHE, {}, unset=("JAX_COMPILATION_CACHE_DIR",))
            for _ in range(2)}
    assert len(runs) == 1
    ours, jax_dir, _ = runs.pop().split()
    assert ours == jax_dir
    assert pathlib.Path(ours).parent == REPO / ".jax_cache"
    assert pathlib.Path(rankfm_tpu.CACHE_ROOT) == REPO / ".jax_cache"
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().splitlines()


@pytest.mark.parametrize("platforms,isa_dir", [
    ("cpu", True), ("cpu,cuda", True), ("cuda", False), ("cuda,cpu", False),
])
def test_compile_cache_host_isa_subdirectory_only_for_cpu(
        monkeypatch, platforms, isa_dir):
    """XLA:CPU entries are kept per host ISA; a GPU backend's are not"""
    import rankfm_tpu
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setenv("JAX_PLATFORMS", platforms)
    got = pathlib.Path(rankfm_tpu.compile_cache_dir())
    root = pathlib.Path(rankfm_tpu.CACHE_ROOT)
    if isa_dir:
        assert got.parent == root and got.name.startswith("host-")
    else:
        assert got == root


def test_compile_cache_not_set_for_an_installed_copy(tmp_path):
    """a copy of the package with no checkout around it sets no cache
    directory of its own"""
    shutil.copytree(PKG, tmp_path / "rankfm_tpu",
                    ignore=shutil.ignore_patterns("*.so", "__pycache__"))
    env = dict(os.environ, PYTHONPATH=str(tmp_path))
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    out = subprocess.run(
        [sys.executable, "-c", _PRINT_CACHE], capture_output=True,
        text=True, env=env, cwd=str(tmp_path), timeout=240)
    assert out.returncode == 0, out.stderr
    ours, jax_dir, _ = out.stdout.strip().splitlines()[-1].split()
    assert ours == jax_dir == "None"
    assert not (tmp_path / ".jax_cache").exists()


def _package_sources():
    return sorted(PKG.rglob("*.py"))


# character classes keep a repository-wide search for these words from
# finding this test itself
@pytest.mark.parametrize("pattern", [
    r"jax\.experimental\.pallas|from jax\.experimental import pallas",
    r"""["']t[p]u["']""",
    r"device_kind",
    r"\bplt[p]u\b|libt[p]u|\bmosaic\b",
])
def test_package_has_no_pallas_import_or_platform_branch(pattern):
    hits = [f"{p.relative_to(REPO)}:{n}"
            for p in _package_sources()
            for n, line in enumerate(p.read_text().splitlines(), 1)
            if re.search(pattern, line, flags=re.IGNORECASE)]
    assert not hits, hits


def test_importing_every_module_loads_no_pallas():
    mods = sorted(".".join(p.relative_to(REPO).with_suffix("").parts)
                  for p in _package_sources())
    mods = [m[:-len(".__init__")] if m.endswith(".__init__") else m
            for m in mods]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "print(sorted(k for k in sys.modules if 'pallas' in k))")
    assert _run(code, {"JAX_PLATFORMS": "cpu"}) == "[]"


def _smoke(cwd, *args, env_update=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **(env_update or {}))
    return subprocess.run([sys.executable, "chip_smoke.py", *args],
                          cwd=str(cwd), capture_output=True, text=True,
                          env=env, timeout=240)


def _result_line(out):
    lines = out.stdout.strip().splitlines()
    return lines[-1] if lines else ""


def test_chip_smoke_refuses_cpu():
    out = _smoke(REPO)
    assert out.returncode != 0
    assert '"ok"' not in _result_line(out)
    assert "no GPU" in out.stdout + out.stderr


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in _result_line(out)


@pytest.mark.parametrize("args,devices", [((), 1), (("--four-cards",), 4)],
                         ids=["one-card", "four-cards"])
def test_chip_smoke_rehearsal_runs_every_phase(args, devices):
    """--rehearse drives every phase's code at tiny shapes on the CPU (gates
    reported, not enforced) and never prints the result line"""
    flags = f"--xla_force_host_platform_device_count={devices}"
    out = _smoke(REPO, "--rehearse", *args, env_update={"XLA_FLAGS": flags})
    assert out.returncode == 3, out.stdout[-2000:] + out.stderr[-2000:]
    assert "rehearsal finished; no result line" in out.stdout
    assert '"ok"' not in _result_line(out)
    phases = ["four cards: data-parallel headline fit",
              "four cards: table-parallel epochs on a (1, 4) mesh",
              "four cards: sharded recommend on a (1, 4) mesh"] if args \
        else ["phase 2", "phase 3", "phase 4", "phase 5"]
    lines = out.stdout.splitlines()
    for phase in phases:
        assert any(ln.startswith(f"== {phase}") and ": done in" in ln
                   for ln in lines), phase
