"""Device LZ77 token expansion.

The reference expands tokens serially with overlap-safe copies
(lz77.cpp:678-714, 632-651).  Here expansion becomes a parallel
pointer-doubling pass over the copy DAG:

  * the host scans the token stream once (bytes per token, cheap) and
    builds two n-sized arrays: `val` holds literal bytes where the output
    is given directly, and `ptr` holds, for every match byte, the earlier
    output position it copies from (p - offset); literal positions point
    at themselves.
  * on device, `ptr = ptr[ptr]` doubles until fixpoint: a chain of
    matches-of-matches of depth d resolves in ceil(log2 d) + 1 rounds of
    full-array gathers.  Overlapping copies (offset < length) are just
    chains p -> p-off -> p-2*off and need no special casing.
  * output = val[ptr].

Dedupe (m0) streams resolve in 2-3 rounds; anti-context (m1/m2) streams are
token-sparse by design (CHHM filtering) so depth stays shallow.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..stages.lz77 import read_token


@partial(jax.jit, static_argnames=("n",))
def _resolve(ptr: jnp.ndarray, val: jnp.ndarray, n: int):
    def cond(carry):
        ptr, _ = carry
        return jnp.any(ptr != ptr[ptr])

    def body(carry):
        ptr, k = carry
        return ptr[ptr], k + 1

    ptr, _ = jax.lax.while_loop(cond, body, (ptr, jnp.int32(0)))
    return val[ptr]


def lz77_decode_device(data: np.ndarray) -> np.ndarray:
    """Drop-in replacement for stages.lz77.lz77_decode on device."""
    buf = np.asarray(data, dtype=np.uint8).tobytes()
    n = len(buf)

    # host pass: token scan -> (dst, src_in, len) literal spans and
    # (dst, offset, len) match spans, plus total output length
    lit_spans = []
    match_spans = []
    pos = 0
    out_len = 0
    while pos < n:
        match, literal, offset, pos = read_token(buf, pos)
        if offset:
            lit_spans.append((out_len, pos, literal))
            out_len += literal
            pos += literal
            if pos >= n or out_len - offset < 0:
                raise ValueError("invalid lz77 token")
            match_spans.append((out_len, offset, match))
            out_len += match
        else:
            lit_spans.append((out_len, pos, n - pos))
            out_len += n - pos
            break

    val = np.zeros(out_len, dtype=np.uint8)
    ptr = np.arange(out_len, dtype=np.int32)
    bufa = np.frombuffer(buf, dtype=np.uint8)
    for dst, src, ln in lit_spans:
        val[dst : dst + ln] = bufa[src : src + ln]
    for dst, off, ln in match_spans:
        ptr[dst : dst + ln] = np.arange(dst - off, dst - off + ln, dtype=np.int32)

    if out_len == 0:
        return np.zeros(0, dtype=np.uint8)
    if not match_spans:
        return val
    out = _resolve(jnp.asarray(ptr), jnp.asarray(val), out_len)
    return np.asarray(jax.device_get(out))
