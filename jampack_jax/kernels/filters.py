"""Device filter-config search and transforms.

The reference scores filter configurations per 64 KB chunk with OpenMP
(-f2 brute force: 96 configs + raw; filters.cpp:256-286).  Here the whole
search is one batched device computation (survey P8): all widths' delta and
inline-delta transforms are built as vectorized ops, and the entropy scores
come from 256-bin histograms computed with segment sums — every config
scored in parallel on the VPU.

The LPC filter's adaptive weight is a serial recurrence, so brute-forcing
it stays host-side; the heuristic mode restricts LPC to the single
projection-detected width exactly like the reference does.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..format.constants import FILTER_MAX_WIDTH


def _entropy_from_counts(counts, total):
    p = counts / jnp.maximum(total, 1)
    return jnp.sum(jnp.where(counts > 0, -p * jnp.log2(jnp.maximum(p, 1e-30)), 0.0))


@partial(jax.jit, static_argnames=("length",))
def score_delta_configs(chunk: jnp.ndarray, length: int):
    """Order-0 entropy of delta and inline-delta transforms for all widths
    1..32, one vectorized pass each.  Returns (delta_scores, inline_scores),
    each (FILTER_MAX_WIDTH + 1,) with index 0 = raw entropy.

    For width w, the reordered-then-delta byte stream is a permutation of
    {chunk[i] - chunk[i-w]} plus the w channel heads — identical multiset to
    inline-delta up to boundary effects, so order-0 scores coincide and one
    shifted-difference batch scores both transform families.
    """
    c = chunk[:length].astype(jnp.int32)
    widths = jnp.arange(1, FILTER_MAX_WIDTH + 1)

    def score_w(w):
        prev = jnp.where(jnp.arange(length) >= w, jnp.roll(c, w), 0)
        diffs = (c - prev) & 0xFF
        counts = jnp.zeros(256, jnp.float32).at[diffs].add(1.0)
        return _entropy_from_counts(counts, length)

    dscores = jax.vmap(score_w)(widths)
    raw_counts = jnp.zeros(256, jnp.float32).at[c].add(1.0)
    raw = _entropy_from_counts(raw_counts, length)
    out = jnp.concatenate([raw[None], dscores])
    return out


def pick_config_device(chunk: np.ndarray) -> tuple:
    """Device-accelerated config pick: returns (type, width) favoring raw on
    ties, searching delta/inline-delta widths 1..32 on device."""
    n = int(chunk.size)
    if n == 0:
        return 0, 0
    scores = np.asarray(score_delta_configs(jnp.asarray(chunk), n))
    best_w = int(np.argmin(scores))
    # require a real win over raw: order-0 entropy of shifted differences
    # fluctuates by a few centibits on incompressible data
    if best_w == 0 or scores[best_w] >= scores[0] - 0.05:
        return 0, 0
    # prefer the context-preserving inline delta (same order-0 score family)
    return 2, best_w


@partial(jax.jit, static_argnames=("width", "length"))
def inline_delta_device(chunk: jnp.ndarray, width: int, length: int):
    """Inline delta as one shifted subtraction: bytes below align + width
    subtract an implicit zero (raw head + first row), everything else
    subtracts the same channel's previous row."""
    c = chunk[:length].astype(jnp.int32)
    align = length % width
    idx = jnp.arange(length)
    prev = jnp.where(idx >= align + width, jnp.roll(c, width), 0)
    return ((c - prev) & 0xFF).astype(jnp.uint8)


@partial(jax.jit, static_argnames=("width", "length"))
def inline_undelta_device(chunk: jnp.ndarray, width: int, length: int):
    """Inverse inline-delta: per-channel prefix sums via a (rows, width)
    reshape and cumulative sum along rows — a pure vector op."""
    c = chunk[:length].astype(jnp.int32)
    align = length % width
    head = c[:align]
    body = c[align:].reshape(-1, width)
    undone = jnp.cumsum(body, axis=0) & 0xFF
    return jnp.concatenate([head, undone.reshape(-1)]).astype(jnp.uint8)
