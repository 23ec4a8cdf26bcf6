"""Hardware discovery (sys_detect.cpp:20-154 counterpart).

The reference caches core count, available memory, and CUDA presence/VRAM
to clamp thread counts and decide GPU offload.  Here the accelerator side
is jax.devices() and the host side is os/sysconf; HybridEngine gates its
BWT device offload on `fits_on_device` the way the reference gates its
CUDA path on the 80%-of-VRAM test (format.hpp:27, bwt.cpp:102-114).
"""

import os


def core_count() -> int:
    """Host cores (sys_detect.cpp:22-55)."""
    return os.cpu_count() or 1


def available_memory() -> int:
    """Host bytes available (sys_detect.cpp:57-84)."""
    try:
        return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    except (ValueError, OSError, AttributeError):
        return 1 << 32


def accelerator_devices():
    """The accelerators JAX sees; [] on a CPU-only backend."""
    import jax

    return [d for d in jax.devices() if d.platform != "cpu"]


def device_memory(device=None) -> int:
    """Bytes JAX may allocate on `device` (default: the first
    accelerator), from its memory_stats()["bytes_limit"].  Raises when
    there is no accelerator or the device reports no limit: the offload
    gate below must not guess."""
    if device is None:
        devs = accelerator_devices()
        if not devs:
            raise RuntimeError("no accelerator: device memory is undefined")
        device = devs[0]
    stats = device.memory_stats() or {}
    if "bytes_limit" not in stats:
        raise RuntimeError(
            f"{device.device_kind} reports no bytes_limit in memory_stats()")
    return int(stats["bytes_limit"])


def fits_on_device(block_size: int, budget: float = 0.8) -> bool:
    """The reference's GPU-offload test: ~6 bytes of working set per input
    byte must fit in `budget` of device memory (format.hpp:27)."""
    if not accelerator_devices():
        return False
    return 6 * block_size <= budget * device_memory()
