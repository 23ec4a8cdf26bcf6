"""Observability: per-stage timing, throughput and ratio accounting.

The reference has printf-only progress (jampack.cpp:226-231); here every
pipeline stage can be timed per block, aggregated across threads, and
reported as MB/s + share-of-wall-time, plus optional JAX profiler traces
for the device path.
"""

import json
import threading
import time
from collections import defaultdict
from contextlib import contextmanager


class StageMetrics:
    """Thread-safe accumulator of (stage -> bytes, seconds, calls)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.stats = defaultdict(lambda: [0, 0.0, 0])  # bytes, secs, calls

    @contextmanager
    def stage(self, name: str, nbytes: int):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                s = self.stats[name]
                s[0] += nbytes
                s[1] += dt
                s[2] += 1

    def summary(self) -> dict:
        total = sum(s[1] for s in self.stats.values()) or 1e-12
        out = {}
        for name, (nbytes, secs, calls) in sorted(self.stats.items()):
            out[name] = {
                "MB": round(nbytes / 1e6, 3),
                "s": round(secs, 4),
                "MB/s": round(nbytes / 1e6 / secs, 2) if secs > 0 else None,
                "share": round(secs / total, 3),
                "calls": calls,
            }
        return out

    def report(self) -> str:
        lines = []
        for name, row in self.summary().items():
            lines.append(
                f"  {name:<16} {row['MB']:>10.2f} MB {row['s']:>8.3f} s "
                f"{(row['MB/s'] or 0):>9.1f} MB/s  {row['share']*100:>5.1f}%"
            )
        return "\n".join(lines)

    def to_json(self) -> str:
        return json.dumps(self.summary())


class InstrumentedEngine:
    """Wraps any engine, timing every stage call into a StageMetrics."""

    def __init__(self, engine, metrics: StageMetrics = None):
        self._engine = engine
        self.metrics = metrics or StageMetrics()
        self.name = f"{engine.name}+metrics"

    def __getattr__(self, attr):
        fn = getattr(self._engine, attr)
        if not callable(fn):
            return fn

        def wrapped(data, *args, **kwargs):
            try:
                nbytes = int(getattr(data, "size", 0) or len(data))
            except TypeError:
                nbytes = 0
            with self.metrics.stage(attr, nbytes):
                return fn(data, *args, **kwargs)

        return wrapped


@contextmanager
def device_trace(logdir: str):
    """JAX profiler trace around a device-path region (view with xprof)."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def fused_decode_compute_wall(payload: bytes, blocksize: int, units: int,
                              lanes: int, lpx_spans: int,
                              trials: int = 3) -> float:
    """Best-of-trials DEVICE-COMPUTE wall of the fused block decode: every
    input staged on device OUTSIDE the timed region, each trial ended by
    block_until_ready.  The e2e wrapper additionally pays the host link
    (reference counterpart: bwt.cpp times the kernel, not the copy)."""
    import time

    import jax
    import numpy as np

    from .device_decode import (_jitted_core, _pay_to_device, block_meta,
                                pack_meta, plan_shapes)

    meta = block_meta(payload, lanes)
    shapes = plan_shapes([meta], [len(payload)], blocksize, lanes)
    packed = pack_meta(meta, payload, shapes)
    fn = _jitted_core(lanes, units, shapes["rmax"], shapes["ocap"],
                      shapes["out_cap"], shapes["max_tokens"], lpx_spans)
    pay = _pay_to_device(payload, shapes["pcap"])
    args = [jax.device_put(a) for a in packed[1:]]
    jax.block_until_ready(fn(pay, *args))  # warmup/compile
    best = float("inf")
    for _ in range(trials):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(pay, *args))
        best = min(best, time.perf_counter() - t0)
    return best


def fused_encode_compute_wall(data, opt, trials: int = 3) -> float:
    """Best-of-trials DEVICE-COMPUTE wall of the fused block encode
    (m3/f0 static-span config): padded input staged on device outside the
    timed region; the metadata fetch + splice (host/transfer work) is
    excluded.  Mirror of fused_decode_compute_wall."""
    import time

    import jax
    import jax.numpy as jnp
    import numpy as np

    from ..kernels.encode_stages import encode_block_dyn_core
    from .device_encode import _bucket_cap

    data = np.asarray(data, dtype=np.uint8)
    n = int(data.size)
    cap = _bucket_cap(n)
    padded = np.zeros(cap, np.uint8)
    padded[:n] = data
    dev = jax.device_put(jnp.asarray(padded))
    nn = jnp.int32(n)
    kw = dict(units=int(opt.anchor_units), chunk=int(opt.ans_chunk),
              lanes=int(opt.rans_lanes), lpx_spans=int(opt.lpx_spans),
              lpx_auto=False)
    jax.block_until_ready(encode_block_dyn_core(dev, nn, None, **kw))
    best = float("inf")
    for _ in range(trials):
        t0 = time.perf_counter()
        jax.block_until_ready(encode_block_dyn_core(dev, nn, None, **kw))
        best = min(best, time.perf_counter() - t0)
    return best
