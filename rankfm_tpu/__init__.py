"""rankfm_tpu — a factorization-machine retrieval engine in JAX.

A from-scratch JAX/XLA re-design of the capabilities of
`etlundquist/rankfm` (reference: /root/reference): Factorization Machines for
implicit-feedback ranking trained with pairwise BPR/WARP loss, plus top-N
retrieval, similarity search, and offline ranking evaluation — built for an
accelerator (batched matmul scoring, vectorized WARP rejection sampling,
sharded embedding tables over a `jax.sharding.Mesh`).

Public API mirrors the reference (`/root/reference/rankfm/rankfm.py:11`,
`/root/reference/rankfm/evaluation.py`):

    from rankfm_tpu import RankFM
    from rankfm_tpu import evaluation
"""

import os as _os

# the persistent compile cache's home when JAX_COMPILATION_CACHE_DIR is not
# set: one fixed directory beside the package in a checkout (the repository
# root), so every process of this checkout finds the same entries. An
# installed copy has no checkout around it and sets no directory.
_ROOT = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
CACHE_ROOT = (_os.path.join(_ROOT, ".jax_cache")
              if _os.path.isfile(_os.path.join(_ROOT, "pyproject.toml"))
              else None)


def _host_isa_tag():
    """Fingerprint of the host CPU's feature flags: XLA:CPU cache entries
    embed host ISA features that the cache key does not fully capture, so
    CPU entries are kept per host ISA. Fixed for a machine."""
    import hashlib
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                if line.startswith(("flags", "Features")):
                    return hashlib.sha1(line.encode()).hexdigest()[:12]
    except OSError:
        pass
    import platform
    return platform.machine() or "unknown"


def _backend_is_cpu():
    """Whether JAX will compile for the CPU, decided without starting a
    backend (`jax.distributed.initialize` must run before that):
    ``JAX_PLATFORMS``'s first entry when it is set, else whether no GPU
    plugin is installed."""
    platforms = _os.environ.get("JAX_PLATFORMS", "").strip()
    if platforms:
        return platforms.split(",")[0].strip() == "cpu"
    import pkgutil
    from importlib import metadata
    names = {ep.name for ep in metadata.entry_points(group="jax_plugins")}
    try:
        import jax_plugins
        names |= {m.name for m in pkgutil.iter_modules(jax_plugins.__path__)}
    except ImportError:
        pass
    return not any(gpu in name for name in names for gpu in ("cuda", "rocm"))


def compile_cache_dir():
    """The persistent compile-cache directory this package uses: the one
    ``JAX_COMPILATION_CACHE_DIR`` names; else, in a checkout, `CACHE_ROOT`
    (``CACHE_ROOT/host-<isa>`` for the CPU backend); else None."""
    env = _os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    if CACHE_ROOT is None:
        return None
    if _backend_is_cpu():
        return _os.path.join(CACHE_ROOT, f"host-{_host_isa_tag()}")
    return CACHE_ROOT


def _enable_compilation_cache():
    """Turn on JAX's persistent compilation cache, so a fresh process skips
    the compiles an earlier one paid. Where ``JAX_COMPILATION_CACHE_DIR``
    is set, JAX already uses that directory and its thresholds are left to
    the environment; nothing is set here."""
    if _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    try:
        import jax
        cache_dir = compile_cache_dir()
        if cache_dir is None:
            return
        _os.makedirs(cache_dir, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", cache_dir)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.2)
        jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    except Exception:
        pass  # read-only checkout: run uncached


_enable_compilation_cache()

from rankfm_tpu.models.rankfm import RankFM  # noqa: E402
from rankfm_tpu import evaluation  # noqa: E402

__version__ = "0.5.0"

__all__ = ["RankFM", "evaluation", "__version__"]
