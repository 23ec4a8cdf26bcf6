"""REAL multi-process jax.distributed bring-up:
two OS processes initialize() against a shared coordinator, split an
archive via compress_stream_part / decompress_stream_part, the parent
stitches, and everything is bit-compared against the single-process path
— SURVEY §4's multi-host testing prescription on the CPU backend."""

import io
import os
import socket
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = r"""
import os, sys
sys.path.insert(0, sys.argv[5])
import jampack_jax  # noqa: F401  (sets the persistent compile cache)
import jax

pid = int(sys.argv[1])
port = sys.argv[2]
tmp = sys.argv[3]
mode = sys.argv[4]

from jampack_jax.runtime import distributed
distributed.initialize(f"127.0.0.1:{port}", 2, pid)
assert jax.process_count() == 2, jax.process_count()
assert jax.process_index() == pid

from jampack_jax.runtime.pipeline import Options
opt = Options(blocksize=4096, match_finder=0, filters=1)
if mode == "compress":
    with open(os.path.join(tmp, "raw.bin"), "rb") as inp:
        total = os.path.getsize(os.path.join(tmp, "raw.bin"))
        distributed.compress_stream_part(inp, total, tmp, pid, 2, opt)
else:
    with open(os.path.join(tmp, "archive.jam"), "rb") as inp:
        distributed.decompress_stream_part(inp, tmp, pid, 2)
jax.distributed.shutdown()
print("WORKER_OK", pid, flush=True)
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_pair(tmp, mode, port):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)  # plain 1-device CPU per process
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", WORKER, str(p), str(port), tmp, mode,
             REPO],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
            text=True)
        for p in range(2)
    ]
    outs = []
    for p, proc in enumerate(procs):
        out, _ = proc.communicate(timeout=240)
        outs.append(out)
        assert proc.returncode == 0, f"worker {p} failed:\n{out}"
        assert f"WORKER_OK {p}" in out, out
    return outs


def test_two_process_initialize_compress_decode(tmp_path):
    from jampack_jax.runtime.distributed import stitch, stitch_archive
    from jampack_jax.runtime.pipeline import (Options, compress_stream,
                                              decompress_stream)

    rng = np.random.default_rng(11)
    alpha = np.frombuffer(b" etaoinshrdlu.,\n", dtype=np.uint8)
    raw = alpha[rng.integers(0, 16, 3 * 4096 + 1500)].tobytes()
    tmp = str(tmp_path)
    with open(os.path.join(tmp, "raw.bin"), "wb") as f:
        f.write(raw)

    # --- 2-process COMPRESS: initialize() + parts, stitched == 1-process
    _run_pair(tmp, "compress", _free_port())
    arch_path = os.path.join(tmp, "archive.jam")
    stitch_archive(tmp, arch_path, 2)
    ref = io.BytesIO()
    compress_stream(io.BytesIO(raw), ref,
                    Options(blocksize=4096, match_finder=0, filters=1))
    with open(arch_path, "rb") as f:
        assert f.read() == ref.getvalue()

    # --- 2-process DECODE of the stitched archive, restitched == raw
    _run_pair(tmp, "decode", _free_port())
    out_path = os.path.join(tmp, "round.bin")
    stitch(tmp, out_path, 2)
    with open(out_path, "rb") as f:
        assert f.read() == raw

    # sanity: the single-process decode agrees too
    plain = io.BytesIO()
    with open(arch_path, "rb") as f:
        decompress_stream(f, plain)
    assert plain.getvalue() == raw
