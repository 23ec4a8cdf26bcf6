"""jampack-jax: a lossless BWT block codec in JAX.

Format-compatible with Jampack v0.80 archives (see SURVEY.md for the
structural analysis of the reference); compute path in JAX/XLA with a
host C++ runtime for the inherently serial encoder loops.
"""

__version__ = "0.1.0"

import os as _os
import sys as _sys


def enable_compile_cache() -> None:
    """Give JAX a persistent compilation cache.

    A JAX_COMPILATION_CACHE_DIR set by the caller is JAX's own setting and
    is left alone.  Otherwise the cache goes to the fixed path
    build/jax_cache of this checkout, so every later process starts warm.
    Set JAMPACK_NO_COMPILE_CACHE=1 to opt out."""
    if _os.environ.get("JAMPACK_NO_COMPILE_CACHE"):
        return
    if _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    cache = _os.path.join(
        _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
        "build", "jax_cache")
    _os.makedirs(cache, exist_ok=True)
    # env vars, so importing this package never imports jax (the native
    # engine's CLI path does not need it); a jax imported earlier has read
    # its env already and takes the same values through its config
    _os.environ["JAX_COMPILATION_CACHE_DIR"] = cache
    _os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "2.0")
    if "jax" in _sys.modules:
        import jax

        jax.config.update("jax_compilation_cache_dir", cache)
        jax.config.update(
            "jax_persistent_cache_min_compile_time_secs",
            float(_os.environ["JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS"]))


enable_compile_cache()
