"""Device filter-config search: all 96 configs scored on device (survey P8).

The reference's -f2 brute force scores delta/LPC/inline x widths 1..32 with
mixed (order-0 + order-1)/2 entropy per 64 KB chunk (filters.cpp:256-286);
-f1 scores a stride/projection-guided candidate set with sorted entropy
(filters.cpp:287-369).  Here the heavy work runs on device:

  * all transforms batched: channel reorder = computed gather, delta =
    shifted subtract, inline delta = stride doubling, LPC = ONE lockstep
    recurrence over all (chunk, width) lanes;
  * exact integer order-1 joint histograms, so only the f32 log-sum is
    approximate;
  * f32 entropy scores reduced on device; the host re-scores ONLY the
    configs within a small margin of the f32 winner using the float64
    executable-spec scorer (stages/filters.py), so the final config choice
    is byte-identical to the spec/native engines (which match the
    reference's double-precision picks) while the 96-wide sweep stays on
    the device.

Encoder-side only: any config decodes identically everywhere.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..format.constants import FILTER_BLOCK_SIZE, FILTER_MAX_WIDTH

_FBS = FILTER_BLOCK_SIZE
_W = FILTER_MAX_WIDTH  # 32

# score margin (bits/sym) below which the host re-scores exactly in f64;
# f32 tree-summation error over 64K log terms is ~1e-5, so 1e-3 is ample
SCORE_EPS = 1e-3


def _reorder_idx(L, w):
    """reordered[j] = buf[src[j]]: inverse of the encoder's channel
    interleave — position j of the reordered stream reads channel-major
    element j (filters.cpp:85-99)."""
    j = jnp.arange(_FBS, dtype=jnp.int32)
    per = L // w  # full rows per channel
    extra = L % w  # channels with one extra element
    # channel c owns count(c) = per + (c < extra); start(c) = c*per + min(c, extra)
    # find channel of j: j < (c+1)*per + min(c+1, extra)
    # solve: c = j // (per+1) for j < extra*(per+1), else (j - extra) // per
    boundary = extra * (per + 1)
    c = jnp.where(j < boundary, j // jnp.maximum(per + 1, 1),
                  (j - extra) // jnp.maximum(per, 1))
    r = jnp.where(j < boundary, j % jnp.maximum(per + 1, 1),
                  (j - extra) % jnp.maximum(per, 1))
    src = r * w + c
    return jnp.where(j < L, jnp.clip(src, 0, _FBS - 1), 0)


def _group_joint(streams, lens):
    """Joint (prev, cur) pair counts per lane, (B, 256, 256) f32: one
    int32 scatter-add per group that moves only the symbol bytes (ctx
    starts at 0 like the spec's mixed_entropy).  Counts are exact."""
    B, n = streams.shape
    prev = jnp.concatenate(
        [jnp.zeros((B, 1), jnp.int32), streams[:, :-1]], axis=1)
    valid = jnp.arange(n, dtype=jnp.int32)[None, :] < lens[:, None]
    key = (jnp.arange(B, dtype=jnp.int32)[:, None] * 65536
           + prev * 256 + streams)
    key = jnp.where(valid, key, B * 65536)
    joint = jnp.zeros(B * 65536 + 1, jnp.int32).at[key.reshape(-1)].add(
        1, mode="drop")[:-1]
    return joint.reshape(B, 256, 256).astype(jnp.float32)


def _group_scores(streams, lens):
    return _scores_from_joint(_group_joint(streams, lens), lens)


def _scores_from_joint(joint, lens):
    """(order0 + order1)/2 mixed entropy in f32 from exact joint counts,
    replicating stages.filters.mixed_entropy's formulas."""
    n = jnp.maximum(lens.astype(jnp.float32), 1.0)
    col = jnp.sum(joint, axis=1)  # (B, 256) symbol counts = order-0 freqs
    row = jnp.sum(joint, axis=2)  # (B, 256) context totals

    def xlogx(v):
        return jnp.where(v > 0, v * jnp.log2(jnp.maximum(v, 1e-30)), 0.0)

    h0 = (xlogx(n) - jnp.sum(xlogx(col), axis=1)) / n
    h1 = (jnp.sum(xlogx(row), axis=1)
          - jnp.sum(xlogx(joint), axis=(1, 2))) / n
    return (h0 + h1) / 2.0


def _lpc_all(streams, lens):
    """LPC recurrence over every lane in lockstep (filters.cpp:49-65)."""
    B = streams.shape[0]

    def body(i, carry):
        out, weight, p1, p2 = carry
        active = i < lens
        cur = streams[:, i]
        err = (weight + (((p1 - p2) + p1) - cur)) & 0xFF
        nw = weight + ((err - weight) >> 6)
        out = out.at[:, i].set(jnp.where(active, err, out[:, i]))
        return (out, jnp.where(active, nw, weight),
                jnp.where(active, cur, p1), jnp.where(active, p1, p2))

    z = jnp.zeros(B, jnp.int32)
    out0 = jnp.zeros((B, _FBS), jnp.int32)
    steps = jnp.minimum(jnp.maximum(jnp.max(lens), 0), _FBS)
    out, _, _, _ = jax.lax.fori_loop(0, steps, body, (out0, z, z, z))
    return out


def _inline_all(streams, lens, w):
    """Inline per-channel delta via log-doubling (filters.cpp:101-120)."""
    j = jnp.arange(_FBS, dtype=jnp.int32)[None, :]
    align = (lens % w)[:, None]
    can = j - w >= align
    shifted = jnp.concatenate(
        [jnp.zeros_like(streams[:, :w]), streams[:, :-w]], axis=1)
    return jnp.where(can & (j < lens[:, None]),
                     (streams - shifted) & 0xFF, streams)


_GROUP = 512  # lanes per histogram group (bounds the count table)


def _reorder_dense(chunks: jnp.ndarray, F: int, w: int) -> jnp.ndarray:
    """Channel reorder of FULL (len == FBS) chunk rows as dense ops: pad ->
    (per+1, w) reshape -> transpose -> two static slices concatenated.
    Channels c < extra own per+1 elements, the rest per, and the output is
    channel-major — so it is exactly [T[:extra] flattened, T[extra:, :per]
    flattened].  Replaces a (F, FBS) random gather per width (the gathers
    were ~60% of the device -f2 sweep wall)."""
    per, extra = _FBS // w, _FBS % w
    pad = (per + 1) * w - _FBS
    xp = jnp.pad(chunks, ((0, 0), (0, pad)))
    t = xp.reshape(F, per + 1, w).transpose(0, 2, 1)  # (F, w, per+1)
    if extra:
        return jnp.concatenate(
            [t[:, :extra, :].reshape(F, -1),
             t[:, extra:, :per].reshape(F, -1)], axis=1)
    return t[:, :, :per].reshape(F, -1)


@partial(jax.jit, static_argnames=("F", "ragged"))
def score_all_configs_core(chunks: jnp.ndarray, lens: jnp.ndarray, F: int,
                           ragged: bool = True):
    """chunks: (F, FBS) uint8 (padded), lens: (F,).
    Returns scores (F, 3, 33) f32: [type, width] mixed entropies with
    width 0 = raw at [0,0] (other width-0 slots unused = +inf).

    Lane layout: lane 0..F-1 = raw, then per width w (1..32) three bands
    of F lanes (delta, lpc, inline).  All LPC lanes share ONE lockstep
    recurrence; histograms/scores run group-by-group so the one-hot
    operands stay bounded."""
    c32 = chunks.astype(jnp.int32)

    # transforms for every width; lanes as uint8 to bound memory
    bands = [chunks]
    lpc_inputs = []
    for w in range(1, _W + 1):
        # dense transpose reorder for full rows; only the (at most one)
        # ragged tail row still needs the index gather
        ro8 = _reorder_dense(chunks, F, w)
        if ragged:
            ri = _reorder_idx(lens[F - 1], w)  # (FBS,)
            ro8 = ro8.at[F - 1].set(jnp.take(chunks[F - 1], ri))
        ro = ro8.astype(jnp.int32)
        shifted = jnp.concatenate(
            [jnp.zeros((F, 1), jnp.int32), ro[:, :-1]], axis=1)
        delta = ((ro - shifted) & 0xFF).astype(jnp.uint8)
        inline = _inline_all(c32, lens, w).astype(jnp.uint8)
        bands.append(delta)
        bands.append(inline)
        lpc_inputs.append(ro8)

    # ONE LPC recurrence over all (width, chunk) lanes
    lpc_in = jnp.concatenate(lpc_inputs, axis=0)  # (32*F, FBS) u8
    lpc_lens = jnp.tile(lens, _W)
    lpc_out = _lpc_all(lpc_in.astype(jnp.int32), lpc_lens).astype(jnp.uint8)

    lanes = jnp.concatenate(bands + [lpc_out], axis=0)  # (97*F, FBS) u8
    lane_lens = jnp.concatenate(
        [lens, jnp.tile(lens, 2 * _W), lpc_lens], axis=0)
    B = lanes.shape[0]
    G = -(-B // _GROUP)
    pad = G * _GROUP - B
    lanes = jnp.pad(lanes, ((0, pad), (0, 0)))
    lane_lens = jnp.pad(lane_lens, (0, pad))
    lanes = lanes.reshape(G, _GROUP, _FBS)
    lane_lens = lane_lens.reshape(G, _GROUP)

    def group(g, acc):
        s = _group_scores(lanes[g].astype(jnp.int32), lane_lens[g])
        return jax.lax.dynamic_update_slice(acc, s[None, :], (g, 0))

    all_scores = jax.lax.fori_loop(
        0, G, group, jnp.zeros((G, _GROUP), jnp.float32)).reshape(-1)[:B]

    # unpack the lane layout into (F, 3, 33)
    scores = jnp.full((F, 3, _W + 1), jnp.inf, jnp.float32)
    scores = scores.at[:, 0, 0].set(all_scores[:F])
    for w in range(1, _W + 1):
        base = F + (w - 1) * 2 * F
        scores = scores.at[:, 0, w].set(all_scores[base: base + F])
        scores = scores.at[:, 2, w].set(all_scores[base + F: base + 2 * F])
        lbase = F + 2 * _W * F + (w - 1) * F
        scores = scores.at[:, 1, w].set(all_scores[lbase: lbase + F])
    return scores


def score_all_configs(data: np.ndarray) -> np.ndarray:
    """Host wrapper: split into 64 KB chunks, score all 96+raw configs on
    device.  Returns (F, 3, 33) float32."""
    data = np.asarray(data, dtype=np.uint8)
    F = max((data.size + _FBS - 1) // _FBS, 1)
    chunks = np.zeros((F, _FBS), np.uint8)
    lens = np.zeros(F, np.int32)
    for i in range(F):
        part = data[i * _FBS: (i + 1) * _FBS]
        chunks[i, : part.size] = part
        lens[i] = part.size
    ragged = bool(data.size != F * _FBS)
    out = score_all_configs_core(jnp.asarray(chunks), jnp.asarray(lens), F,
                                 ragged)
    return np.asarray(jax.device_get(out))


def pick_f2_configs(data: np.ndarray):
    """Reference -f2 brute-force selection with device scoring: the 96-wide
    sweep runs on device; candidates within SCORE_EPS of the f32 winner are
    re-scored in float64 by the executable-spec scorer so the final picks
    (and so the archive bytes) match the spec/native engines exactly.
    Returns [(type, width)] per chunk."""
    from ..stages.filters import _apply, mixed_entropy

    data = np.asarray(data, dtype=np.uint8)
    scores = score_all_configs(data)  # (F, 3, 33)
    picks = []
    for i in range(scores.shape[0]):
        chunk = data[i * _FBS: (i + 1) * _FBS]
        grid = scores[i]
        mn = np.min(grid)
        # exact re-score of near-winners (and always raw, the tie default)
        cand = {(0, 0)}
        for t in range(3):
            for w in range(1, _W + 1):
                if grid[t, w] <= mn + SCORE_EPS:
                    cand.add((t, w))
        exact = {}
        for (t, w) in cand:
            exact[(t, w)] = mixed_entropy(_apply(chunk, t, w) if w else chunk)
        # replicate the reference scan: raw wins ties, type-major order,
        # strict improvement (stages.filters.filters_encode:236-243)
        best_t, best_w = 0, 0
        best = exact[(0, 0)]
        for t in range(3):
            for w in range(1, _W + 1):
                s = exact.get((t, w), grid[t, w])
                if s < best:
                    best = s
                    best_t, best_w = t, w
        picks.append((best_t, best_w))
    return picks


def filters_encode_f2_device(data: np.ndarray) -> np.ndarray:
    """-f2 encode with the device config sweep; output byte-identical to
    stages.filters.filters_encode(data, 2)."""
    from ..stages.filters import _apply

    data = np.asarray(data, dtype=np.uint8)
    picks = pick_f2_configs(data)
    out = bytearray()
    for i, (t, w) in enumerate(picks):
        chunk = data[i * _FBS: (i + 1) * _FBS]
        out.append(t if w > 0 else 0)
        out.append(w)
        out += _apply(chunk, t, w).tobytes()
    return np.frombuffer(bytes(out), dtype=np.uint8)


# ---------------------------------------------------------------------------
# -f1 heuristic path (filters.cpp:287-369): stride/projection-guided
# candidates scored by sorted entropy.


def _prev_occurrence(keys: np.ndarray) -> np.ndarray:
    """prev[i] = last j < i with keys[j] == keys[i], else 0 — the
    vectorized form of the reference's dist[] tables (init 0)."""
    n = keys.size
    order = np.argsort(keys, kind="stable")
    ks = keys[order]
    prev = np.zeros(n, dtype=np.int64)
    same = ks[1:] == ks[:-1]
    prev[order[1:][same]] = order[:-1][same]
    return prev


def _pick_peak(hist: np.ndarray) -> int:
    """The reference's peak pick (filters.cpp:167-178): hist[j] must beat
    2x the average AND the running max seeded from hist[0]."""
    average = int(hist.sum()) // (_W + 1)
    smallest = 0
    mn = hist[0]
    for j in range(1, _W + 1):
        if hist[j] > average * 2 and hist[j] > mn:
            mn = hist[j]
            smallest = j
    return smallest


def find_stride_fast(buf: np.ndarray) -> int:
    """Vectorized find_stride (filters.cpp:147-178): the per-symbol
    last-occurrence distance histogram via one stable sort."""
    i = np.arange(buf.size, dtype=np.int64)
    stride = i - _prev_occurrence(buf.astype(np.int64))
    hist = np.bincount(stride % (_W + 1), minlength=_W + 1)
    return _pick_peak(hist)


def find_projection_fast(buf: np.ndarray) -> int:
    """Vectorized find_projection (filters.cpp:183-218): second-order
    stride detector — previous occurrence of (stride % 256)."""
    i = np.arange(buf.size, dtype=np.int64)
    stride = i - _prev_occurrence(buf.astype(np.int64))
    projection = i - _prev_occurrence(stride % 256)
    hist = np.bincount(projection % (_W + 1), minlength=_W + 1)
    return _pick_peak(hist)


@partial(jax.jit, static_argnames=("B",))
def sorted_entropy_scores_core(streams: jnp.ndarray, lens: jnp.ndarray,
                               B: int):
    """Sorted entropy (utils.cpp:122-141 / stages.filters.sorted_entropy)
    of each lane: order-1 entropy of the counting-sort-induced generalized
    BWT.  One stable sort per lane carries prev as payload (no gather)."""
    s32 = streams.astype(jnp.int32)
    # prev[0] = buf[n-1] like the spec's np.roll of the UNPADDED lane —
    # rolling the padded row read the zero padding there for ragged tails
    # (caught by the on-chip parity smoke: a 2-byte tail scored 1.0 bit
    # instead of 0.0 and flipped the chunk's -f1 pick)
    prev = jnp.roll(s32, 1, axis=1)
    last = jnp.take_along_axis(
        s32, (jnp.maximum(lens, 1) - 1)[:, None], axis=1)
    prev = jnp.concatenate([last, prev[:, 1:]], axis=1)
    j = jnp.arange(_FBS, dtype=jnp.int32)
    # pad keys sort last and are masked out of the histogram anyway
    keys = jnp.where(j[None, :] < lens[:, None], s32, 0x1FF)
    _, sbuf = jax.lax.sort((keys, prev), num_keys=1, is_stable=True)

    # pad symbols (0x1FF) would index outside the 256-symbol joint; they
    # are masked by lens in the histogram, so clip them onto symbol 0
    sbuf = jnp.clip(sbuf, 0, 255)
    joint = _group_joint(sbuf, lens)
    n = jnp.maximum(lens.astype(jnp.float32), 1.0)
    row = jnp.sum(joint, axis=2)

    def xlogx(v):
        return jnp.where(v > 0, v * jnp.log2(jnp.maximum(v, 1e-30)), 0.0)

    return (jnp.sum(xlogx(row), axis=1)
            - jnp.sum(xlogx(joint), axis=(1, 2))) / n


def pick_f1_configs(data: np.ndarray):
    """Reference -f1 heuristic selection with device sorted-entropy
    scoring; picks match stages.filters.filters_encode(data, 1) exactly
    (near-tie candidates re-score in float64).  Returns [(type, width)]
    per chunk."""
    from ..stages.filters import _apply, sorted_entropy

    data = np.asarray(data, dtype=np.uint8)
    F = max((data.size + _FBS - 1) // _FBS, 1)
    chunks = [data[i * _FBS: (i + 1) * _FBS] for i in range(F)]

    # candidate set per chunk (prev-config resolved in the sequential pass)
    cand_sets = []
    for c in chunks:
        cands = [(0, 0)]
        ch = find_stride_fast(c)
        if ch > 0:
            cands += [(0, ch), (2, ch)]
        chp = find_projection_fast(c)
        if chp > 0:
            cands += [(1, chp)]
        cand_sets.append(cands)

    # batch all candidate transforms into one device scoring call
    lanes, lens, owners = [], [], []
    for i, cands in enumerate(cand_sets):
        for (t, w) in cands:
            buf = _apply(chunks[i], t, w) if w else chunks[i]
            row = np.zeros(_FBS, np.uint8)
            row[: buf.size] = buf
            lanes.append(row)
            lens.append(buf.size)
            owners.append((i, t, w))
    B = len(lanes)
    dev = sorted_entropy_scores_core(
        jnp.asarray(np.stack(lanes)), jnp.asarray(np.asarray(lens, np.int32)),
        B)
    dev = np.asarray(jax.device_get(dev))
    scored = {}
    for k, (i, t, w) in enumerate(owners):
        scored[(i, t, w)] = float(dev[k])

    picks = []
    prev_t, prev_w = 0, 0
    exact_cache = {}

    def exact_score(i, t, w):
        key = (i, t, w)
        if key not in exact_cache:
            exact_cache[key] = sorted_entropy(
                _apply(chunks[i], t, w) if w else chunks[i])
        return exact_cache[key]

    for i, cands in enumerate(cand_sets):
        grid = {}
        for (t, w) in cands:
            grid[(t, w)] = scored[(i, t, w)]
        if (prev_t, prev_w) not in grid:
            grid[(prev_t, prev_w)] = exact_score(i, prev_t, prev_w)
        # near-tie exact re-score so the pick matches the f64 spec
        mn = min(grid.values())
        for key in list(grid):
            if grid[key] <= mn + SCORE_EPS:
                grid[key] = exact_score(i, *key)
        best_t, best_w = 0, 0
        best = grid.get((0, 0), 8.0)
        for t in range(3):
            for w in range(1, _W + 1):
                s = grid.get((t, w), 8.0)
                if s < best:
                    best = s
                    best_t, best_w = t, w
        picks.append((best_t, best_w))
        prev_t, prev_w = best_t, best_w
    return picks


def filters_encode_f1_device(data: np.ndarray) -> np.ndarray:
    """-f1 heuristic with device sorted-entropy scoring; byte-identical to
    stages.filters.filters_encode(data, 1)."""
    from ..stages.filters import _apply

    data = np.asarray(data, dtype=np.uint8)
    out = bytearray()
    for i, (t, w) in enumerate(pick_f1_configs(data)):
        chunk = data[i * _FBS: (i + 1) * _FBS]
        out.append(t if w > 0 else 0)
        out.append(w)
        out += _apply(chunk, t, w).tobytes()
    return np.frombuffer(bytes(out), dtype=np.uint8)
