"""Where the persistent compilation cache goes: a caller's
JAX_COMPILATION_CACHE_DIR is used as it is; otherwise the package sets the
fixed build/jax_cache of the checkout."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = """
import sys
sys.path.insert(0, {repo!r})
if {jax_first}:
    import jax
import jampack_jax
import jax
print(jax.config.jax_compilation_cache_dir)
"""


def _cache_dir(env_dir, jax_first):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    env.pop("JAMPACK_NO_COMPILE_CACHE", None)
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    code = PROBE.format(repo=REPO, jax_first=jax_first)
    p = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120,
                       check=True)
    return p.stdout.strip().splitlines()[-1]


def test_cache_follows_env(tmp_path):
    for jax_first in (False, True):
        assert _cache_dir(str(tmp_path), jax_first) == str(tmp_path)


def test_cache_defaults_to_checkout_build_dir():
    want = os.path.join(REPO, "build", "jax_cache")
    for jax_first in (False, True):
        assert _cache_dir(None, jax_first) == want
