"""Hardware discovery (sys_detect counterpart)."""

import pytest

from jampack_jax.runtime import sysinfo


def test_core_count_positive():
    assert sysinfo.core_count() >= 1


def test_available_memory_positive():
    assert sysinfo.available_memory() > 0


class _FakeDevice:
    device_kind = "fake"

    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


def test_device_memory_positive():
    assert sysinfo.device_memory(_FakeDevice({"bytes_limit": 80 << 30})) \
        == 80 << 30


def test_device_memory_raises_without_bytes_limit():
    with pytest.raises(RuntimeError, match="bytes_limit"):
        sysinfo.device_memory(_FakeDevice({"bytes_in_use": 1}))
    with pytest.raises(RuntimeError, match="bytes_limit"):
        sysinfo.device_memory(_FakeDevice(None))


def test_device_memory_raises_without_accelerator():
    # the suite runs on the CPU backend: there is no accelerator to ask
    assert sysinfo.accelerator_devices() == []
    with pytest.raises(RuntimeError, match="no accelerator"):
        sysinfo.device_memory()


def test_fits_on_device_consistent(monkeypatch):
    # tests run on the CPU backend: no accelerator -> never "fits"
    assert sysinfo.fits_on_device(8 << 20) is False
    # the reference's rule: 6N within 80% of the device's bytes_limit
    dev = _FakeDevice({"bytes_limit": 60 << 20})
    monkeypatch.setattr(sysinfo, "accelerator_devices", lambda: [dev])
    assert sysinfo.fits_on_device(8 << 20) is True
    assert sysinfo.fits_on_device(9 << 20) is False


def test_plan_workers_memory_clamp(monkeypatch):
    """OOM guard: K is clamped so the reference's 6N*K memory model (plus
    the read-ahead window) fits in available memory (jampack.cpp:186-192)."""
    from jampack_jax import cli
    from jampack_jax.runtime.pipeline import Options

    monkeypatch.setattr(sysinfo, "core_count", lambda: 16)
    monkeypatch.setattr(sysinfo, "available_memory", lambda: 1 << 30)  # 1 GiB
    # -b1000: one worker needs ~8 GB of buffers -> clamp to 1 despite 16 cores
    opt = Options(blocksize=1000 << 20, threads=0)
    assert cli.plan_workers(opt) == 1
    # 8 MB blocks: 16 workers * 64 MB fits in 1 GiB
    opt = Options(blocksize=8 << 20, threads=0)
    assert cli.plan_workers(opt) == 16
    # explicit -t wins below the memory cap
    opt = Options(blocksize=8 << 20, threads=3)
    assert cli.plan_workers(opt) == 3
    # single-block mode is always one instance
    opt = Options(blocksize=8 << 20, threads=8, multiblock=False)
    assert cli.plan_workers(opt) == 1


def test_plan_workers_default_is_core_count(monkeypatch):
    from jampack_jax import cli
    from jampack_jax.runtime.pipeline import Options

    monkeypatch.setattr(sysinfo, "core_count", lambda: 5)
    monkeypatch.setattr(sysinfo, "available_memory", lambda: 64 << 30)
    assert cli.plan_workers(Options(blocksize=8 << 20, threads=0)) == 5
