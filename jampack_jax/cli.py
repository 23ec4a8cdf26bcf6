"""Command-line interface, argument-compatible with the reference binary.

    python -m jampack_jax.cli <c|d> input output [-b# -m# -f# -t# -T] [--engine E]
    python -m jampack_jax.cli i archive          (dump block headers)

Flags (main.cpp:65-89 semantics): -b block size in MB (1..1000), -m match
finder (0 dedupe / 1 hash chain / 2 suffix array / 3 store: both LZ stages
off — framework extension, archives stay reference-decodable), -f filters (0 off /
1 heuristic / 2 brute force / 3 device search), -t threads, -T
single-block low-memory decode.
Extra: --engine numpy|native|device|hybrid|fused (default native; fused =
the device-resident block-level chain, one block per device across the
local mesh); JTX/JT3 stream
parameters -u# BWT anchor units, -c# ANS chunk KB, -L# rANS lane-interleave
width, -S# Lpx span count (intra-block Lpx parallel width; 0 = skip the Lpx
stage), -Sa auto-gate Lpx per block (skip where measured gain is nil).
"""

import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .format import framing
from .format.constants import DEFAULT_BLOCKSIZE
from .runtime.pipeline import Options, compress_block_ex, decompress_block


def plan_workers(opt) -> int:
    """Memory/core-aware block-parallel worker count.

    The reference clamps instance count against the host (jampack.cpp:186-192)
    and documents encode memory as 6N*K for K instances on N-byte blocks
    (main.cpp:3-4).  Default K = core count; K is clamped so 6N*K (plus the
    2-deep read-ahead window's raw blocks, ~2N*K) fits in available memory.
    """
    from .runtime.sysinfo import available_memory, core_count

    if not opt.multiblock:
        return 1
    workers = opt.threads if opt.threads > 0 else core_count()
    per_worker = 8 * opt.blocksize  # 6N working set + 2N window buffers
    mem_cap = max(int(available_memory() // per_worker), 1)
    return max(min(workers, mem_cap), 1)


class _Progress:
    """Live per-block progress line (jampack.cpp:226-231,273-278 analog):
    MB processed, ratio, MB/s, carriage-return overwritten on stderr."""

    def __init__(self, label: str, enabled: bool = True):
        self.label = label
        self.enabled = enabled and sys.stderr.isatty()
        self.t0 = time.time()
        self.shown = False

    def update(self, raw: int, comp: int) -> None:
        if not self.enabled:
            return
        dt = time.time() - self.t0
        rate = (raw / 1e6) / dt if dt > 0 else 0.0
        ratio = (comp / raw * 100) if raw else 0.0
        print(f"\r{self.label}: {raw / 1e6:.1f} MB ({ratio:.2f}%) "
              f"@ {rate:.2f} MB/s", end="", file=sys.stderr, flush=True)
        self.shown = True

    def done(self) -> None:
        if self.shown:
            print(file=sys.stderr)


def _make_engine(name: str, threads: int):
    if name == "numpy":
        from .runtime.pipeline import Engine

        return Engine()
    if name == "device":
        from .runtime.engines import DeviceEngine

        return DeviceEngine()
    if name == "hybrid":
        from .runtime.engines import HybridEngine

        return HybridEngine(threads=threads)
    from .runtime.engines import NativeEngine

    return NativeEngine(threads=threads)


def _parse(argv):
    if len(argv) < 4:
        print(__doc__)
        return None
    mode, inp, outp = argv[1], argv[2], argv[3]
    if inp == outp:
        raise SystemExit("Refusing to write to input, change the output directory.")
    opt = Options(blocksize=DEFAULT_BLOCKSIZE, match_finder=0, filters=1)
    threads = 0
    engine = "native"
    multiblock = True
    for arg in argv[4:]:
        if arg.startswith("--"):
            if arg.startswith("--engine"):
                engine = arg.split("=", 1)[1] if "=" in arg else "native"
            elif arg == "--verbose":
                pass  # handled in run() via argv scan
            else:
                raise SystemExit(f"Unknown option: {arg}")
        elif arg.startswith("-") and len(arg) >= 2:
            p = arg[1:]
            while p:
                c = p[0]
                rest = p[1:]
                num = ""
                while rest and (rest[0].isdigit()):
                    num += rest[0]
                    rest = rest[1:]
                if c == "b" and num:
                    # mutate in place (with the Options clamp) so stream
                    # parameters set by earlier flags — -S#/-Sa included —
                    # survive regardless of flag order
                    from .format.constants import (MAX_BLOCKSIZE,
                                                   MIN_BLOCKSIZE)

                    opt.blocksize = int(min(max(int(num) << 20,
                                                MIN_BLOCKSIZE),
                                            MAX_BLOCKSIZE))
                elif c == "u" and num:
                    opt.anchor_units = int(num)  # native JTX container
                elif c == "c" and num:
                    opt.ans_chunk = int(num) << 10  # ANS chunk in KB
                elif c == "L" and num:
                    # JTX rANS lane interleave, validated at the boundary so
                    # header and payload can never disagree
                    from .runtime.pipeline import validate_rans_lanes

                    opt.rans_lanes = validate_rans_lanes(int(num))
                elif c == "S" and num:
                    # JT3 Lpx span count (intra-block Lpx parallel width);
                    # 0 = skip the Lpx stage on every block
                    from .runtime.pipeline import validate_lpx_spans

                    opt.lpx_spans = validate_lpx_spans(int(num))
                elif c == "S" and rest[:1] == "a":
                    # -Sa: per-block auto gate — measure the Lpx stage's
                    # gain and skip it (JT3 spans=0) where it earns nothing
                    opt.lpx_auto = True
                    rest = rest[1:]
                elif c == "m" and num:
                    from .runtime.pipeline import validate_match_finder

                    opt.match_finder = validate_match_finder(int(num))
                elif c == "f" and num:
                    opt.filters = int(num)
                elif c == "t" and num:
                    threads = int(num)
                elif c == "T":
                    multiblock = False
                elif c == "v":
                    pass  # -v verbose, handled in run() via argv scan
                else:
                    # unrecognized option character (e.g. the trailing 'a'
                    # of '-S4a'): fail loudly instead of silently dropping
                    raise SystemExit(f"Unknown option character "
                                     f"'{c}' in {arg}")
                p = rest
    opt.threads = threads
    opt.multiblock = multiblock
    return mode, inp, outp, opt, engine


def info(path: str) -> int:
    """Dump block headers (jampack.cpp:174-180 DisplayHeaderContents
    counterpart): per block magic kind, crc, compressed/block sizes, and
    JTX stream parameters."""
    total_c = 0
    n = 0
    with open(path, "rb") as f:
        while True:
            rec = framing.read_block(f)
            if rec is None:
                break
            h, payload = rec
            native = framing.is_native(h.units, h.lanes, h.lpx_spans)
            v3 = h.lpx_spans != framing.DEFAULT_LPX_SPANS
            kind = ("JT3" if v3 else "JTX") if native else "JAM"
            extra = (f" units={h.units} lanes={h.lanes} spans={h.lpx_spans}"
                     if native else "")
            print(f"block {n}: {kind} crc=0x{h.crc:08x} csize={h.csize} "
                  f"blocksize={h.blocksize}{extra}")
            total_c += h.csize + framing.header_size(h.units, h.lanes,
                                                     h.lpx_spans)
            n += 1
    print(f"{n} blocks, {total_c} compressed bytes")
    return 0


def run(argv, routes=None):
    """Run one CLI command; argv as sys.argv.  routes: an optional
    collections.Counter that the fused engine fills with one count per
    block under the path it took ("device", or "host:<reason>")."""
    if len(argv) >= 3 and argv[1] == "i":
        return info(argv[2])
    parsed = _parse(argv)
    if parsed is None:
        return 0
    mode, inp, outp, opt, engine_name = parsed
    if engine_name == "fused":
        # the device-resident block-level paths: the whole per-block chain
        # in one jit per block, one block per device across the local mesh
        # (encode needs -m3 and -f0/1/2; decode reads any archive)
        from .runtime.sharding import (decode_archive_sharded,
                                       encode_archive_sharded, make_mesh)

        from collections import Counter

        mesh = make_mesh()
        routes = routes if routes is not None else Counter()
        start = time.time()
        progress = _Progress("compressing" if mode == "c"
                             else "decompressing")
        with open(inp, "rb") as fin, open(outp, "wb") as fout:
            if mode == "c":
                raw, comp = encode_archive_sharded(fin, fout, opt, mesh,
                                                   progress=progress.update,
                                                   routes=routes)
            elif mode == "d":
                data = decode_archive_sharded(fin, mesh,
                                              progress=progress.update,
                                              routes=routes)
                fout.write(data)
                raw, comp = len(data), fin.tell()
            else:
                raise SystemExit("Invalid option!")
        progress.done()
        dt = time.time() - start
        ratio = (comp / raw * 100) if raw else 0.0
        rate = (raw / 1e6) / dt if dt > 0 else 0.0
        print(f"{raw / 1e6:.2f} MB <=> {comp / 1e6:.2f} MB ({ratio:.2f}%) "
              f"@ {rate:.2f} MB/s in {dt:.2f}s [fused x{mesh.devices.size}] "
              f"blocks: {dict(sorted(routes.items()))}")
        return 0
    engine = _make_engine(engine_name, opt.threads)
    verbose = any(a in ("-v", "--verbose") for a in argv[4:])
    if verbose:
        from .runtime.metrics import InstrumentedEngine

        engine = InstrumentedEngine(engine)
    start = time.time()
    raw = comp = 0
    workers = plan_workers(opt)
    progress = _Progress("compressing" if mode == "c" else "decompressing")

    with open(inp, "rb") as fin, open(outp, "wb") as fout:
        if mode == "c":
            def encode_one(blob):
                data = np.frombuffer(blob, dtype=np.uint8)
                return compress_block_ex(data, opt, engine)

            from collections import deque

            with ThreadPoolExecutor(max_workers=workers) as pool:
                window = deque()
                # feof semantics (jampack.cpp:205-214): an input of exactly
                # K*blocksize bytes (incl. K=0) gets one trailing EMPTY
                # block — archive bytes are the contract
                pending_empty = True
                eof = False
                while True:
                    while not eof and len(window) < workers * 2:
                        blob = fin.read(opt.blocksize)
                        if not blob:
                            eof = True
                            if pending_empty:
                                window.append(pool.submit(encode_one, b""))
                            break
                        raw += len(blob)
                        pending_empty = len(blob) == opt.blocksize
                        window.append(pool.submit(encode_one, blob))
                    if not window:
                        break
                    crc, payload, spans = window.popleft().result()
                    framing.write_block(fout, crc, payload, opt.blocksize,
                                        opt.anchor_units, opt.rans_lanes,
                                        spans)
                    comp += len(payload) + framing.HEADER_SIZE
                    progress.update(raw, comp)
        elif mode == "d":
            def decode_one(args):
                header, payload = args
                return decompress_block(payload, header.crc, engine,
                                        header.blocksize, header.units,
                                        header.lanes, header.lpx_spans)

            from collections import deque

            with ThreadPoolExecutor(max_workers=workers) as pool:
                window = deque()
                while True:
                    while len(window) < workers * 2:
                        rec = framing.read_block(fin)
                        if rec is None:
                            break
                        comp += rec[0].csize + framing.HEADER_SIZE
                        window.append(pool.submit(decode_one, rec))
                    if not window:
                        break
                    data = window.popleft().result()
                    fout.write(data.tobytes())
                    raw += data.size
                    progress.update(raw, comp)
        else:
            raise SystemExit("Invalid option!")

    progress.done()
    dt = time.time() - start
    ratio = (comp / raw * 100) if raw else 0.0
    rate = (raw / 1e6) / dt if dt > 0 else 0.0
    print(f"{raw / 1e6:.2f} MB <=> {comp / 1e6:.2f} MB ({ratio:.2f}%) "
          f"@ {rate:.2f} MB/s in {dt:.2f}s [{engine.name}]")
    if verbose:
        print("per-stage (aggregated across threads):")
        print(engine.metrics.report())
    return 0


def main():
    sys.exit(run(sys.argv))


if __name__ == "__main__":
    main()
