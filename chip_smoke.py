"""Bring-up smoke of the fused codec on an NVIDIA GPU.

    python chip_smoke.py [--seed N] [--cards 4]

Drives the CLI's fused engine (`jampack_jax.cli.run`, in this process)
over a corpus generated from --seed: five 8 MB blocks (text, records,
dedupe, mostly-zeros, random) and a ragged ~3 MB tail.  Phases:

  kernels   each Pallas kernel against its plain XLA form, bit for bit,
            at the production-stream and JAM widths of the text block,
            with both forms' warm times
  prod      encode with the production stream (-m3 -f0 -c16 -L4 -u960
            -S4096 -Sa), archive bytes equal to the native engine's;
            fused decode, bit-exact to the input
  jam       the reference's default stream (-m0 -f1) on one 8 MB block:
            a native-engine archive decoded by the fused engine, and a
            fused encode equal to the native engine's bytes
  f2        one -f2 fused encode of a 4 MB records block (the device
            filter search and its joint histograms), equal to native,
            decoded back bit-exactly
  gpu_tests the tests marked `gpu`, run here through pytest.main

Every block at or above the device minimum must take the device route in
every fused call.  With --cards 4 only the four-card phase runs: the same
corpus encoded and decoded across a 4-device mesh (the CLI takes every
local device), archive bytes equal to a 1-device mesh in this process and
to the native engine's.

Prints the card's name and power limit, the devices, per phase the wall
and compile seconds and the block routes, and the peak device memory.
The last line is one JSON object, {"ok": true, "device": {...}}.  Exits
non-zero without that line when JAX finds no GPU or any phase fails.
"""

import argparse
import io
import json
import os
import subprocess
import sys
import time
import traceback
from collections import Counter

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

BLOCK = 8 << 20
TAIL = (3 << 20) + 12345
PROD_FLAGS = ["-m3", "-f0", "-c16", "-L4", "-u960", "-S4096", "-Sa"]
F2_FLAGS = ["-m3", "-f2", "-c16", "-L4", "-u960", "-S4096", "-Sa"]


# ---------------------------------------------------------------------------
# Seeded corpus


def textlike(rng, n):
    """i.i.d. letters, spaces and punctuation at English-like weights."""
    alpha = np.frombuffer(b" etaoinshrdlucmfwypvbgkqjxz.,\n", dtype=np.uint8)
    return alpha[rng.integers(0, alpha.size, n)]


def records(rng, n):
    """Fixed-width 4-byte rows: tag, slow counter, small noise, drift."""
    rec = np.zeros(n, np.uint8)
    rec[0::4] = 200 + (np.arange(rec[0::4].size) % 9)
    rec[1::4] = (np.arange(rec[1::4].size) // 3) & 0xFF
    rec[2::4] = rng.integers(0, 16, rec[2::4].size)
    rec[3::4] = np.cumsum(rng.integers(0, 3, rec[3::4].size)).astype(np.uint8)
    return rec


def dedupe(rng, n):
    """A 64 KB random pattern repeated, with sparse byte flips."""
    pat = rng.integers(0, 256, 64 << 10, dtype=np.uint8)
    out = np.tile(pat, n // pat.size + 1)[:n].copy()
    out[rng.integers(0, n, n // 64)] ^= 0xFF
    return out


def mostly_zeros(rng, n):
    out = np.zeros(n, np.uint8)
    out[rng.integers(0, n, n // 256)] = rng.integers(1, 256, n // 256)
    return out


def make_corpus(seed, block=BLOCK, tail=TAIL):
    """(corpus bytes, {name: block bytes}): five blocks and a ragged tail."""
    rng = np.random.default_rng(seed)
    parts = {
        "text": textlike(rng, block),
        "records": records(rng, block),
        "dedupe": dedupe(rng, block),
        "zeros": mostly_zeros(rng, block),
        "random": rng.integers(0, 256, block, dtype=np.uint8),
        "tail": textlike(rng, tail),
    }
    parts = {k: v.tobytes() for k, v in parts.items()}
    return b"".join(parts.values()), parts


# ---------------------------------------------------------------------------
# Phases: each returns a dict of what it observed and raises on a mismatch


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _write(path, data):
    with open(path, "wb") as f:
        f.write(data)


def _cli(argv, routes=None):
    from jampack_jax import cli

    rc = cli.run(["jampack"] + argv, routes=routes)
    if rc != 0:
        raise RuntimeError(f"cli {argv} returned {rc}")


def _check_routes(routes, what):
    """Every block must have run on the device, except blocks below the
    device minimum (counted as host:small) on encode."""
    bad = {k: v for k, v in routes.items()
           if k not in ("device", "host:small")}
    if bad or not routes.get("device"):
        raise AssertionError(f"{what}: blocks left the device: "
                             f"{dict(routes)}")


def roundtrip(workdir, name, data, flags):
    """Fused encode (bytes == native engine's at the same flags) and fused
    decode (bytes == input) of `data` through the CLI."""
    inp = os.path.join(workdir, f"{name}.bin")
    fused = os.path.join(workdir, f"{name}.fused.jam")
    native = os.path.join(workdir, f"{name}.native.jam")
    back = os.path.join(workdir, f"{name}.back")
    _write(inp, data)
    enc_routes, dec_routes = Counter(), Counter()
    t0 = time.perf_counter()
    _cli(["c", inp, fused, *flags, "--engine=fused"], enc_routes)
    t_enc = time.perf_counter() - t0
    _cli(["c", inp, native, *flags, "--engine=native"])
    if _read(fused) != _read(native):
        raise AssertionError(f"{name}: fused archive != native archive")
    t0 = time.perf_counter()
    _cli(["d", fused, back, "--engine=fused"], dec_routes)
    t_dec = time.perf_counter() - t0
    if _read(back) != data:
        raise AssertionError(f"{name}: fused decode != input")
    _check_routes(enc_routes, f"{name} encode")
    _check_routes(dec_routes, f"{name} decode")
    return {"mb": len(data) / 1e6, "encode_s": t_enc, "decode_s": t_dec,
            "archive_bytes": os.path.getsize(fused),
            "encode_routes": dict(enc_routes),
            "decode_routes": dict(dec_routes)}


def jam_default(workdir, block):
    """The reference's default stream on one block: the native engine's
    archive decoded by the fused engine, and the fused engine's encode
    equal to it byte for byte."""
    inp = os.path.join(workdir, "jam.bin")
    native = os.path.join(workdir, "jam.native.jam")
    fused = os.path.join(workdir, "jam.fused.jam")
    back = os.path.join(workdir, "jam.back")
    _write(inp, block)
    _cli(["c", inp, native, "-m0", "-f1"])
    dec_routes, enc_routes = Counter(), Counter()
    t0 = time.perf_counter()
    _cli(["d", native, back, "--engine=fused"], dec_routes)
    t_dec = time.perf_counter() - t0
    if _read(back) != block:
        raise AssertionError("jam: fused decode of the native archive "
                             "!= input")
    t0 = time.perf_counter()
    _cli(["c", inp, fused, "-m0", "-f1", "--engine=fused"], enc_routes)
    t_enc = time.perf_counter() - t0
    if _read(fused) != _read(native):
        raise AssertionError("jam: fused archive != native archive")
    _check_routes(enc_routes, "jam encode")
    _check_routes(dec_routes, "jam decode")
    return {"mb": len(block) / 1e6, "encode_s": t_enc, "decode_s": t_dec,
            "encode_routes": dict(enc_routes),
            "decode_routes": dict(dec_routes)}


def multi_card(workdir, data, flags):
    """The corpus across every local device (the CLI's mesh): archive
    bytes equal to a 1-device mesh's and to the native engine's, decode
    bit-exact."""
    import jax

    from jampack_jax.cli import _parse
    from jampack_jax.runtime.sharding import encode_archive_sharded, make_mesh

    if len(jax.devices()) < 2:
        raise RuntimeError("needs several devices, found 1")
    out = roundtrip(workdir, "cards", data, flags)
    opt = _parse(["jampack", "c", "in", "out", *flags])[3]
    one = io.BytesIO()
    routes1 = Counter()
    t0 = time.perf_counter()
    encode_archive_sharded(io.BytesIO(data), one, opt, make_mesh(1),
                           routes=routes1)
    out["encode_1card_s"] = time.perf_counter() - t0
    if one.getvalue() != _read(os.path.join(workdir, "cards.fused.jam")):
        raise AssertionError("multi-card archive != 1-card archive")
    _check_routes(routes1, "1-card encode")
    return out


def _timed(fn, reps=3):
    """(result, median seconds of `reps` warm calls) of a jitted fn."""
    import jax

    out = jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return out, sorted(ts)[len(ts) // 2]


def kernels(block, steps=4096, interpret=False):
    """The Pallas kernels against their plain XLA forms, bit for bit, at
    the widths the fused path gives them: the entropy decode of `block`
    written in the production stream and in the reference's default
    stream (the first `steps` symbol steps of each chain), and the encode
    model pass over the symbol chains that decode yields.  Reports both
    forms' median warm times."""
    import jax.numpy as jnp

    from jampack_jax.cli import _parse
    from jampack_jax.kernels import rans_pallas as rp
    from jampack_jax.kernels.rans_wide import (decode_lanes_wide,
                                               model_pairs_wide)
    from jampack_jax.runtime import device_decode as dd
    from jampack_jax.runtime.engines import NativeEngine
    from jampack_jax.runtime.pipeline import compress_block_ex

    out = {}
    data = np.frombuffer(block, np.uint8)
    for name, flags in (("prod", PROD_FLAGS), ("jam", ["-m0", "-f1"])):
        opt = _parse(["jampack", "c", "in", "out", *flags])[3]
        _, payload, _ = compress_block_ex(data, opt, NativeEngine())
        lanes = int(opt.rans_lanes)
        meta = dd.block_meta(payload, lanes)
        shapes = dd.plan_shapes([meta], [len(payload)], data.size, lanes)
        pay, starts, rlens = dd.pack_meta(meta, payload, shapes)[:3]
        whole = bool((rlens <= steps).all())  # else the final-state check
        rlens = np.minimum(rlens, steps).astype(np.int32)  # cannot hold
        mr = shapes["rmax"]
        groups = shapes["cmax"] if lanes >= 2 else 0
        args = (jnp.asarray(pay), jnp.asarray(starts), jnp.asarray(rlens))
        (want, want_ok), t_xla = _timed(lambda: decode_lanes_wide(
            *args, max_rlen=mr, groups=groups))
        (got, got_ok), t_krn = _timed(lambda: rp.decode_lanes_wide_pallas(
            *args, max_rlen=mr, groups=groups, interpret=interpret))
        if not (np.array_equal(np.asarray(want), np.asarray(got))
                and np.array_equal(np.asarray(want_ok), np.asarray(got_ok))
                and (bool(np.asarray(want_ok).all()) or not whole)):
            raise AssertionError(f"{name}: decode kernel != XLA decode")
        out[f"{name}_decode"] = {
            "chains": int((rlens > 0).sum()), "lanes": int(rlens.size),
            "steps": int(rlens.max()), "xla_s": t_xla, "kernel_s": t_krn}

        chains = decode_lanes_wide(*args, max_rlen=mr)[0]
        live = jnp.asarray(np.maximum(rlens, 0))
        want, t_xla = _timed(lambda: model_pairs_wide(chains, live, mr))
        got, t_krn = _timed(lambda: rp.model_pairs_wide_pallas(
            chains, live, mr, interpret=interpret))
        slot = np.arange(2 * mr)[None, :] < 2 * np.maximum(rlens, 0)[:, None]
        same = np.array_equal(np.asarray(want[2]), np.asarray(got[2])) and all(
            np.array_equal(np.where(slot, np.asarray(a), 0),
                           np.where(slot, np.asarray(b), 0))
            for a, b in zip(want[:2], got[:2]))
        if not (same and bool(np.asarray(want[2]).all())):
            raise AssertionError(f"{name}: model-pass kernel != XLA pass")
        out[f"{name}_model_pass"] = {"xla_s": t_xla, "kernel_s": t_krn}
    return out


def gpu_tests():
    """The `gpu`-marked tests, in this process (one process per card)."""
    import pytest

    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(HERE, "tests")])
    if rc != 0:
        raise AssertionError(f"gpu-marked tests failed (pytest rc={rc})")
    return {"pytest_rc": int(rc)}


# ---------------------------------------------------------------------------


class CompileClock:
    """Seconds JAX spends tracing, lowering and compiling, from its own
    monitoring events."""

    EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
              "/jax/core/compile/jaxpr_to_mlir_module_duration",
              "/jax/core/compile/backend_compile_duration")

    def __init__(self):
        self.secs = 0.0

    def __call__(self, event, duration_secs, **_):
        if event in self.EVENTS:
            self.secs += duration_secs


def _phase(name, fn, clock, results, failures):
    print(f"[{name}] start", flush=True)
    c0, t0 = clock.secs, time.perf_counter()
    try:
        out = fn()
    except Exception:  # noqa: BLE001 — reported, and the run exits 1
        failures.append(name)
        print(f"[{name}] FAILED\n{traceback.format_exc()}", flush=True)
        return
    out["wall_s"] = time.perf_counter() - t0
    out["compile_s"] = clock.secs - c0
    results[name] = out
    print(f"[{name}] {json.dumps(out, sort_keys=True)}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4))
    args = ap.parse_args(argv)

    import jax

    if jax.default_backend() != "gpu":
        print(f"chip_smoke: needs a GPU; JAX's backend is "
              f"{jax.default_backend()}", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(f"nvidia-smi: {smi.stdout.strip()}", flush=True)
    devs = jax.devices()
    print(f"jax.devices(): {devs}", flush=True)

    clock = CompileClock()
    jax.monitoring.register_event_duration_secs_listener(clock)
    workdir = os.path.join(HERE, "build", "chip_smoke")
    os.makedirs(workdir, exist_ok=True)
    t0 = time.perf_counter()
    data, parts = make_corpus(args.seed)
    print(f"corpus: {len(data)} bytes in {time.perf_counter() - t0:.2f}s "
          f"(seed {args.seed})", flush=True)

    results, failures = {}, []
    if len(devs) != args.cards:
        print(f"chip_smoke: --cards {args.cards} but JAX sees {len(devs)} "
              f"devices", file=sys.stderr)
        return 1
    if args.cards == 4:
        _phase("cards4", lambda: multi_card(workdir, data, PROD_FLAGS),
               clock, results, failures)
    else:
        _phase("kernels", lambda: kernels(parts["text"]), clock, results,
               failures)
        _phase("prod", lambda: roundtrip(workdir, "prod", data, PROD_FLAGS),
               clock, results, failures)
        _phase("jam", lambda: jam_default(workdir, parts["text"]),
               clock, results, failures)
        _phase("f2", lambda: roundtrip(workdir, "f2",
                                       parts["records"][: 4 << 20],
                                       F2_FLAGS),
               clock, results, failures)
        _phase("gpu_tests", gpu_tests, clock, results, failures)

    for d in devs:
        stats = d.memory_stats() or {}
        print(f"{d}: peak_bytes_in_use={stats.get('peak_bytes_in_use')} "
              f"bytes_limit={stats.get('bytes_limit')}", flush=True)
    print(f"total wall {time.perf_counter() - t0:.1f}s, compile "
          f"{clock.secs:.1f}s", flush=True)
    if failures:
        print(f"chip_smoke: FAILED phases: {failures}", file=sys.stderr)
        return 1
    print(f"nvidia-smi: {smi.stdout.strip()}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
