import glob
import os
import subprocess
import sys

# The suite runs on the CPU backend with 8 virtual devices, so the
# multi-device sharding logic is exercised without accelerators.  Both
# must be set before jax is imported; a caller's JAX_PLATFORMS wins, so
# the gpu-marked tests can run on a card (see the `gpu` fixture).
os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

ORACLE = os.path.join(REPO, "build", "jampack_ref")
# the directory of the reference's C++ sources; named explicitly, with no
# default, so the tests compile only sources the caller pointed them at
REFERENCE_SRC = os.environ.get("JAMPACK_REFERENCE_SRC")


def _ensure_oracle():
    """Build the reference binary (golden oracle) if it isn't present.
    Returns its path, or None when neither the binary nor the reference
    sources exist."""
    if os.path.exists(ORACLE):
        return ORACLE
    if not REFERENCE_SRC:
        return None
    srcs = sorted(glob.glob(os.path.join(REFERENCE_SRC, "*.cpp")))
    if not srcs:
        return None
    os.makedirs(os.path.dirname(ORACLE), exist_ok=True)
    subprocess.run(
        ["g++", "-std=c++14", "-fopenmp", "-O2", "-w",
         "-D__min(a,b)=(((a)<(b))?(a):(b))",
         "-D__max(a,b)=(((a)>(b))?(a):(b))", *srcs, "-o", ORACLE],
        check=True)
    return ORACLE


@pytest.fixture(scope="session")
def oracle():
    if _ensure_oracle() is None:
        where = (f"no reference sources in {REFERENCE_SRC}" if REFERENCE_SRC
                 else "JAMPACK_REFERENCE_SRC is unset")
        pytest.skip(f"reference oracle unavailable: no build/jampack_ref "
                    f"and {where}")

    class Oracle:
        path = ORACLE

        @staticmethod
        def compress(src, dst, *args):
            subprocess.run(
                [ORACLE, "c", str(src), str(dst), "-t1", *args],
                check=True, capture_output=True,
            )

        @staticmethod
        def decompress(src, dst, *args):
            subprocess.run(
                [ORACLE, "d", str(src), str(dst), "-t1", *args],
                check=True, capture_output=True,
            )

    return Oracle


@pytest.fixture
def gpu():
    """The first GPU device, for tests marked `gpu`; skips where JAX's
    backend has none (decided here, at run time, so every test worker
    collects the same tests)."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip(f"needs a GPU; JAX's backend is {jax.default_backend()}")
    return jax.devices()[0]
