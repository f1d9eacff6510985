"""Gram-filter cascade device kernels (XLA path).

Two filter designs share this module (planning: models/cascade.py; the
reference's hot loop they replace: ``ac_trie_search``,
``src/multifast/ahocorasick.c:199-234``):

**Sampled** (``filter_hits_sampled`` + ``verify_windows`` — the
headline engine).  Any occurrence of a pattern of length >= ``min_long``
covers exactly one point of a ``stride = min_long - q + 1`` lattice, so a
positional-alignment bloom (bit ``j`` set <=> some long pattern contains
this q-gram at offset ``j``) is probed only at grid points: 1/stride
bloom gathers per byte.  Fetched
words AND together across 1-2 salted probes; nonzero words mark grid
cells whose candidate window gets an on-device dense-DFA walk
(``verify_windows``), so the match-free common case ships two scalars to
the host.  Short patterns (< q) are matched exactly by compare-select and
packed into a second per-cell bitmask.

**Anchored** (``filter_candidates`` — short-min-length sets, or forced
with ``cascade_mode="anchored"``).
Every position is tested as a potential match start against 1-3 staged
blooms of q-gram class codes at fixed in-pattern offsets; surviving starts
are compacted and verified by a vectorized host root-walk.

Soundness (both): a true occurrence always passes its filter (its grams
were inserted by construction; shorts are exact), so candidates form a
superset of true starts and exact verification removes the rest.
Capacity overflows retry doubled — output is never truncated.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import jax
import jax.numpy as jnp

from .scan_jax import (
    INT32_MAX,
    KGRAM_MID_FLAG,
    KGRAM_STATE_MASK,
    _classes,
    blocked_nonzero,
)

KNUTH = 2654435761  # Knuth multiplicative hash constant


def gram_codes(cls: jax.Array, q: int, n_classes: int) -> jax.Array:
    """Rolling base-C q-gram codes: ``code[p]`` covers ``cls[p : p+q]``
    (positions whose gram would overrun the row read trailing zeros —
    harmless, those positions cannot start an owned full match).
    Codes wrap in int32; the bloom hash only needs determinism."""
    B, L = cls.shape
    pad = jnp.zeros((B, q - 1), jnp.int32)
    ext = jnp.concatenate([cls, pad], axis=1)
    code = jnp.zeros((B, L), jnp.int32)
    for j in range(q):
        code = code * n_classes + jax.lax.dynamic_slice_in_dim(ext, j, L, 1)
    return code


def bloom_slots(code: jax.Array, log2_bits: int, salt: int) -> jax.Array:
    """Multiplicative hash of a gram code into a bloom slot index."""
    h = (code.astype(jnp.uint32) ^ jnp.uint32(salt)) * jnp.uint32(KNUTH)
    return (h >> jnp.uint32(32 - log2_bits)).astype(jnp.int32)


def bloom_hit_take(words: jax.Array, slots: jax.Array) -> jax.Array:
    w = jnp.take(words, slots >> 5)
    return (w >> (slots & 31)) & 1


def short_pattern_mask(
    chunks: jax.Array, shorts: Sequence[bytes]
) -> jax.Array:
    """Exact start positions of short patterns via compare-select."""
    B, L = chunks.shape
    mask = jnp.zeros((B, L), jnp.bool_)
    maxs = max((len(s) for s in shorts), default=0)
    if maxs == 0:
        return mask
    pad = jnp.zeros((B, maxs), jnp.uint8)
    ext = jnp.concatenate([chunks, pad], axis=1)
    for s in shorts:
        eq = jnp.ones((B, L), jnp.bool_)
        for j, byte in enumerate(s):
            eq &= (
                jax.lax.dynamic_slice_in_dim(ext, j, L, 1)
                == jnp.uint8(byte)
            )
        mask |= eq
    return mask


#: polynomial rolling-hash base for sampled gram codes (odd => every byte
#: position keeps full weight mod 2^32; base 256 would zero out weights
#: past the 4th byte).  Shared by device kernel and host plan builder.
GRAM_BASE = 0x01000193  # FNV-1 prime
#: second, independent code family for signature-scale sets: a 32-bit
#: code saturates at ~n_entries/2^32 true code collisions per cell
#: (12M entries => ~3e-3 — every salt passes because the CODE collides,
#: not the hash), so a second polynomial digest of the same gram makes
#: the joint collision rate (n/2^32)^2.  Probed on extracted slots only.
GRAM_BASE2 = 0x31000197  # odd, independent of GRAM_BASE
#: dedicated probe salt of the second-family bloom
SALT2 = 0x6A09E667


def sampled_gram_codes(
    chunks: jax.Array, q: int, stride: int, base: int = GRAM_BASE
) -> jax.Array:
    """Polynomial q-gram byte codes ``sum_j byte[p+j] * GRAM_BASE^(q-1-j)``
    (wrapping int32) at the sampled grid positions ``p = m * stride`` only
    (``[B, M]``, ``M = ceil(L / stride)``) — no dense rolling-code array,
    and no byte->class lookup at all: raw bytes give a *finer* partition
    than classes (a gram containing a byte unused by every pattern can
    never equal a pattern gram), so membership filtering stays sound and
    gets strictly more selective.

    Implemented with cell-aligned reshapes/slices only (a stride-s
    slice of the byte axis would relayout through cross-lane shuffles):
    position ``p + j`` lives in cell
    ``i = j // stride``, lane ``r = j % stride`` of the ``[B, M', stride]``
    reshape, so the code is a per-cell weighted reduction.  Grid grams
    overrunning the row read trailing zeros, which is harmless: such
    positions cannot be the in-row gram of a full occurrence."""
    import numpy as np

    B, L = chunks.shape
    M = -(-L // stride)
    extra = -(-q // stride)  # whole zero cells covering the gram overhang
    pad = jnp.zeros((B, (M + extra) * stride - L), chunks.dtype)
    b3 = jnp.concatenate([chunks, pad], axis=1).reshape(
        B, M + extra, stride
    )
    code = jnp.zeros((B, M), jnp.int32)
    for i in range(extra + 1):
        w = np.zeros(stride, np.int64)
        for r in range(stride):
            j = i * stride + r
            if j < q:
                w[r] = pow(base, q - 1 - j, 1 << 32)
        if not w.any():
            continue
        w32 = jnp.asarray(w.astype(np.uint32).view(np.int32))
        part = b3[:, i : M + i, :].astype(jnp.int32) * w32[None, None, :]
        code = code + jnp.sum(part, axis=2, dtype=jnp.int32)
    return code


def sampled_gram_codes_planes(
    chunks: jax.Array, q: int, stride: int, base: int = GRAM_BASE
) -> jax.Array:
    """:func:`sampled_gram_codes` via *cell-aligned word planes* — exact
    same codes without the general path's ``[B, M, stride]`` reshape,
    whose small minor dim pads every materialized intermediate.  When
    ``stride % 4 ==
    0`` and ``stride | L``, cell ``m``'s q gram bytes live entirely in
    words ``(stride/4)*m + j4`` for ``j4 in 0..(q-1)//4`` — each plane
    ``P_j4[b, m]`` is laid out exactly like the grid, so code assembly is
    pure elementwise byte-extract/multiply-add over [B, M] arrays with no
    sub-128 minor dim anywhere.  Word packing itself is 4 strided lane
    slices."""
    import numpy as np

    B, L = chunks.shape
    assert stride % 4 == 0 and L % stride == 0, "planes path gate"
    spc = stride // 4
    M = L // stride
    words = None
    for k in range(4):
        part = chunks[:, k::4].astype(jnp.uint32) << jnp.uint32(8 * k)
        words = part if words is None else (words | part)
    n_planes = (q - 1) // 4 + 1
    planes = []
    for j4 in range(n_planes):
        shift, idx = divmod(j4, spc)
        pl = words[:, idx::spc] if spc > 1 else words
        if shift:
            pl = jnp.concatenate(
                [pl[:, shift:], jnp.zeros((B, shift), pl.dtype)], axis=1
            )
        planes.append(pl)
    code = jnp.zeros((B, M), jnp.uint32)
    for j in range(q):
        j4, k = divmod(j, 4)
        w = np.uint32(pow(base, q - 1 - j, 1 << 32))
        byte = (planes[j4] >> jnp.uint32(8 * k)) & jnp.uint32(0xFF)
        code = code + byte * w
    return code.astype(jnp.int32)


def sampled_codes_best(
    chunks: jax.Array, q: int, stride: int, base: int = GRAM_BASE
) -> jax.Array:
    """Dispatch to the planes formulation when its alignment gate holds."""
    L = chunks.shape[1]
    if stride % 4 == 0 and L % stride == 0:
        return sampled_gram_codes_planes(chunks, q, stride, base)
    return sampled_gram_codes(chunks, q, stride, base)


@functools.partial(
    jax.jit,
    static_argnames=(
        "q", "stride", "log2_words", "salts", "shorts", "capacity",
    ),
)
def filter_hits_sampled(
    words: jax.Array,  # [2**log2_words] int32 positional bloom
    chunks: jax.Array,  # [B, L] uint8
    lengths: jax.Array,  # [B] int32
    min_long_len: jax.Array,  # scalar int32 (0 disables the long path)
    q: int,
    stride: int,
    log2_words: int,
    salts: Tuple[int, ...],
    shorts: Tuple[bytes, ...],
    capacity: int,
) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Strided-sampled filter with *grid-domain* compaction.

    Device-side cost lives entirely on the sampled grid (``B * ceil(L /
    stride)`` cells — a compaction over the dense ``[B, L]`` start
    domain would cost more than the bloom gather itself): one bloom
    gather per grid cell, plus a hit
    compaction over grid cells.  Each compacted hit carries two int32
    bitmask words the *host* expands into candidate starts
    (models/cascade.py expand_hits):

    * ``long_word`` — positional-bloom word of the cell's gram: bit ``j``
      => candidate long-pattern start at ``m * stride - j``;
    * ``short_word`` — exact compare-select short-pattern starts packed by
      in-cell offset: bit ``i`` => short match starting at
      ``m * stride + i``.

    Soundness: any occurrence of a long pattern at start ``t`` spans at
    least ``min_long >= q + stride - 1`` bytes, so ``[t, t + stride - 1]``
    contains exactly one grid point ``p``; the gram at ``p`` is the
    pattern's own gram at offset ``j = p - t <= stride - 1``, which the
    plan inserted with bit ``j`` set — the expanded starts are a superset
    of all true starts and host verification removes the rest.  This
    divides the per-byte gather count by ``stride`` (8x for the headline
    16-byte needles at q=9).

    Returns ``(grid_idx [cap] flattened b * M + m ascending, long_word
    [cap], short_word [cap], n_hits)``; retry with doubled capacity when
    ``n_hits > capacity``."""
    B, L = chunks.shape
    M = -(-L // stride)
    code = sampled_codes_best(chunks, q, stride)
    # one probe per salt, alignment masks AND-combined: a true gram has
    # bit j set at every salted slot by construction, while stray bits
    # from fill must coincide across independent probes (rate^n_probes) —
    # the lever that keeps million-pattern filters selective.
    #
    # The gather runs as a lax.scan over NSLAB slabs of the grid (a
    # layout kept from the first accelerator this was tuned on, where the
    # slab loop pipelined index computation with the gather; correct on
    # any backend, and a retuning candidate).
    NSLAB = 8
    n_grid = B * M
    slab = -(-n_grid // NSLAB)
    code_flat = code.reshape(-1)
    if slab * NSLAB != n_grid:  # pad: padded cells are sliced off below
        code_flat = jnp.concatenate(
            [code_flat, jnp.zeros((slab * NSLAB - n_grid,), jnp.int32)]
        )
    code_slabs = code_flat.reshape(NSLAB, slab)

    def _probe_slab(acc, c):
        ws = None
        for salt in salts:
            h = (c.astype(jnp.uint32) ^ jnp.uint32(salt)) * jnp.uint32(KNUTH)
            widx = (h >> jnp.uint32(32 - log2_words)).astype(jnp.int32)
            probe = jnp.take(words, widx)  # THE gather
            ws = probe if ws is None else (ws & probe)
        return acc, ws

    _, w_slabs = jax.lax.scan(_probe_slab, jnp.int32(0), code_slabs)
    w = w_slabs.reshape(-1)[:n_grid].reshape(B, M)
    w = jnp.where(min_long_len > 0, w, 0)

    if shorts:
        sm = short_pattern_mask(chunks, shorts)
        sm &= (
            jax.lax.broadcasted_iota(jnp.int32, (B, L), 1)
            < lengths[:, None]
        )
        pad = jnp.zeros((B, M * stride - L), jnp.bool_)
        cell = jnp.concatenate([sm, pad], 1).reshape(B, M, stride)
        weights = (jnp.int32(1) << jnp.arange(stride, dtype=jnp.int32))
        sw = jnp.sum(cell * weights[None, None, :], axis=2, dtype=jnp.int32)
    else:
        sw = jnp.zeros((B, M), jnp.int32)

    # two-level compaction on the (sparse) grid-hit mask — see
    # scan_jax.blocked_nonzero for the cost rationale
    hit = (w | sw) != 0
    idx, n_hits = blocked_nonzero(hit.reshape(-1), capacity)
    safe = jnp.minimum(idx, B * M - 1)
    lw = jnp.where(idx < INT32_MAX, jnp.take(w.reshape(-1), safe), 0)
    swo = jnp.where(idx < INT32_MAX, jnp.take(sw.reshape(-1), safe), 0)
    return idx, lw, swo, n_hits


#: largest survivor-group size of the grouped take path's rank
#: extraction (one group per block column of ``block_r`` cells); the
#: learned ``cap_coarse`` scales with it (models/cascade.py seeds it from
#: the planner's stray estimate x the group size)
GROUP_BLOCK_R = 1024


@jax.jit
def pack_corpus_words(chunks: jax.Array) -> jax.Array:
    """``[B, L] uint8 -> [B, L/4] int32`` little-endian word pack via 4
    strided lane slices (a byte->word relayout with no small minor
    dim).  Module-level jit: one compile per corpus SHAPE, shared by the
    grouped take path and the resident-corpus cache (a per-handle
    closure would re-trace per handle)."""
    wc = None
    for k in range(4):
        part = chunks[:, k::4].astype(jnp.uint32) << jnp.uint32(8 * k)
        wc = part if wc is None else (wc | part)
    return jax.lax.bitcast_convert_type(wc, jnp.int32)


@functools.partial(
    jax.jit,
    static_argnames=(
        "q", "stride", "log2_words", "salts", "shorts", "capacity",
        "cap_coarse", "prefix_salts", "prefix_log2", "prefix_len",
        "block_r",
    ),
)
def filter_hits_sampled_grouped(
    words: jax.Array,  # [2**log2_words] int32 positional bloom (HBM)
    chunks: jax.Array,  # [B, L] uint8
    lengths: jax.Array,  # [B] int32
    min_long_len: jax.Array,  # scalar int32 (0 disables the long path)
    q: int,
    stride: int,
    log2_words: int,
    salts: Tuple[int, ...],
    shorts: Tuple[bytes, ...],
    capacity: int,
    cap_coarse: int,
    prefix_words=None,  # [2**prefix_log2 / 32] int32 bit bloom, or None
    prefix_salts: Tuple[int, ...] = (),
    prefix_log2: int = 0,
    prefix_len: int = 0,
    block_r: int = GROUP_BLOCK_R,
    words2=None,  # [2**log2_words] int32 second-family bloom, or None
    wc=None,  # [B, L/4] int32 packed corpus words (resident-corpus cache)
) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array, jax.Array]:
    """Take-path sampled filter with group rank extraction + per-slot
    refinement — the signature-scale fast path.

    Stage A probes ONLY the first salt over the grid — at signature
    scale every full-grid gather against the GiB-class bloom costs
    ~100+ ms, so the second salt moves to stage B where it re-probes
    just the extracted slots (the classic cascade trade: the planner's
    2-probe AND keeps selectivity, but only one probe needs to touch
    every cell).  Compaction goes through a per-group rank extraction
    (:func:`group_rank_extract`) instead of a flat nonzero over every
    grid cell; ``block_r`` (the group size) is chosen by the caller from
    the
    single-salt stray estimate so slot arrays stay small.  Stage B then
    ANDs the remaining salts and the pattern-prefix hash probe per
    single-alignment slot (window words gathered per slot).  Returns
    ``(grid_idx [cap] slot-order,
    long_word, short_word, n_final, n_coarse)`` with ``n_coarse`` the
    per-group survivor max (retry ``cap_coarse`` when exceeded).
    Requires ``stride % 4 == 0`` and ``stride | L`` (callers gate)."""
    B, L = chunks.shape
    M = L // stride
    spc = stride // 4
    # ONE corpus word pack + phase split, shared by both code families
    # AND the per-slot window fetches (three separate passes before);
    # resident-corpus callers pass the cached pack (``wc``) so it is
    # paid once per corpus instead of once per launch
    if wc is None:
        wc = pack_corpus_words(chunks)
    wc = jax.lax.bitcast_convert_type(wc, jnp.uint32)
    wc_flat = jax.lax.bitcast_convert_type(wc, jnp.int32).reshape(-1)
    n_words_c = wc_flat.shape[0]

    import numpy as _np

    n_planes = (q - 1) // 4 + 1
    planes = []
    for j4 in range(n_planes):
        shift, pidx = divmod(j4, spc)
        pl_ = wc[:, pidx::spc] if spc > 1 else wc
        if shift:
            pl_ = jnp.concatenate(
                [pl_[:, shift:], jnp.zeros((B, shift), pl_.dtype)], axis=1
            )
        planes.append(pl_)

    def _poly_code(base):
        c = jnp.zeros((B, M), jnp.uint32)
        for j in range(q):
            j4, k = divmod(j, 4)
            byte = (planes[j4] >> jnp.uint32(8 * k)) & jnp.uint32(0xFF)
            c = c + byte * _np.uint32(pow(base, q - 1 - j, 1 << 32))
        return c.astype(jnp.int32)

    code = _poly_code(GRAM_BASE)

    # stage-A probes as a lax.scan over NSLAB slabs (see
    # filter_hits_sampled)
    NSLAB = 8
    n_grid = B * M
    slab = -(-n_grid // NSLAB)
    code_flat = code.reshape(-1)
    if slab * NSLAB != n_grid:
        code_flat = jnp.concatenate(
            [code_flat, jnp.zeros((slab * NSLAB - n_grid,), jnp.int32)]
        )
    code_slabs = code_flat.reshape(NSLAB, slab)

    def _probe_slab(acc, c):
        # stage A: first salt only — the rest AND in on extracted slots
        salt = salts[0]
        h = (c.astype(jnp.uint32) ^ jnp.uint32(salt)) * jnp.uint32(KNUTH)
        widx = (h >> jnp.uint32(32 - log2_words)).astype(jnp.int32)
        return acc, jnp.take(words, widx)

    _, w_slabs = jax.lax.scan(_probe_slab, jnp.int32(0), code_slabs)
    w = w_slabs.reshape(-1)[:n_grid]
    w = jnp.where(min_long_len > 0, w, 0)

    if shorts:
        sw2 = _short_start_words(chunks, lengths, shorts, stride, M)
        sw = sw2.reshape(-1)
    else:
        sw = jnp.zeros_like(w)

    R = -(-n_grid // 128)
    n_blocks = max(1, -(-R // block_r))
    tot = n_blocks * block_r * 128

    def pad_flat(x):
        return jnp.concatenate(
            [x, jnp.zeros((tot - x.shape[0],), x.dtype)]
        )

    mpr = min(128, max(8, -(-cap_coarse // 8) * 8))
    # with a second-family bloom the extracted slot value is the
    # GRAM_BASE2 code (its probe replaces the same-code second salt,
    # which a true code collision would always pass); the shared planes
    # make the second code a handful of extra multiply-adds
    hv = _poly_code(GRAM_BASE2) if words2 is not None else code
    r_s, w_s, swo_s, c_s, cnt = group_rank_extract(
        pad_flat(w), pad_flat(sw), pad_flat(hv.reshape(-1)),
        block_r, mpr, n_blocks, n_grid,
    )

    nrows = n_blocks * mpr
    blk = (jnp.arange(nrows, dtype=jnp.int32) // mpr)[:, None]
    lane = jnp.arange(128, dtype=jnp.int32)[None, :]
    cell_s = (blk * block_r + r_s) * 128 + lane

    # stage B1: per-SLOT re-probes (the slot arrays are ~mpr/block_r of
    # the grid, so extra probes are nearly free here) — the second-family
    # bloom when present, else the planner's remaining salts
    if words2 is not None:
        h = (c_s.astype(jnp.uint32) ^ jnp.uint32(SALT2)) * jnp.uint32(
            KNUTH
        )
        widx = (h >> jnp.uint32(32 - log2_words)).astype(jnp.int32)
        w_s = w_s & jnp.take(words2, widx)
    else:
        for salt in salts[1:]:
            h = (c_s.astype(jnp.uint32) ^ jnp.uint32(salt)) * jnp.uint32(
                KNUTH
            )
            widx = (h >> jnp.uint32(32 - log2_words)).astype(jnp.int32)
            w_s = w_s & jnp.take(words, widx)

    alive = (r_s >= 0) & ((w_s | swo_s) != 0) & (cell_s < n_grid)
    slot, n_final = blocked_nonzero(alive.reshape(-1), capacity)
    safe = jnp.minimum(slot, nrows * 128 - 1)
    valid = slot < INT32_MAX
    idx = jnp.where(valid, jnp.take(cell_s.reshape(-1), safe), INT32_MAX)
    lw = jnp.where(valid, jnp.take(w_s.reshape(-1), safe), 0)
    swo = jnp.where(valid, jnp.take(swo_s.reshape(-1), safe), 0)

    # stage B2: prefix refinement on the COMPACTED hits only (the window
    # -word fetch costs ~6 gathers per element, so it must run on the
    # capacity-sized prefix, not the slot arrays).  Refined-dead entries
    # keep their compaction slot with idx=INT32_MAX / zero words — every
    # consumer masks on those; ``n_final`` stays the pre-refinement
    # count, which is what the output capacity must cover.
    prefix_on = (
        prefix_words is not None
        and stride <= 32
        and 4 <= prefix_len <= 20
        and prefix_salts
    )
    if prefix_on:
        c_min = _window_offsets(spc, prefix_len)
        safe_cell = jnp.where(valid, idx, 0)

        def get_plane(c):
            widx = jnp.clip(safe_cell * spc + c, 0, n_words_c - 1)
            return jnp.take(wc_flat, widx)

        h_s = _prefix_hash_select(
            get_plane, lw, stride, prefix_len, c_min
        )
        ok = None
        for salt in prefix_salts:
            hh = (h_s.astype(jnp.uint32) ^ jnp.uint32(salt)) * jnp.uint32(
                KNUTH
            )
            slots_b = (hh >> jnp.uint32(32 - prefix_log2)).astype(
                jnp.int32
            )
            bit = bloom_hit_take(prefix_words, slots_b)
            ok = bit if ok is None else (ok & bit)
        long_ok = prefix_refine_words(lw, h_s, ok, stride) != 0
        keep = long_ok | (swo != 0)
        idx = jnp.where(keep, idx, INT32_MAX)
        lw = jnp.where(keep, lw, 0)
        swo = jnp.where(keep, swo, 0)
    return idx, lw, swo, n_final, jnp.max(cnt)


def _window_offsets(spc: int, l16: int):
    """First word offset (relative to a cell's first word) covering the
    candidate windows ``[p - (s-1), p + l16)`` of the cell at byte ``p``
    (negative: windows of non-zero alignment start before the cell).
    The upper word bound is implicit in the byte offsets
    :func:`_prefix_hash_select` actually requests."""
    s = 4 * spc
    return -((s - 1 + 3) // 4)


def _align_bit_i32(j: int) -> int:
    """Two's-complement int32 value of alignment bit ``1 << j`` — what
    ``low = w & -w`` evaluates to in int32 when bit ``j`` is the lowest
    set bit.  For ``j == 31`` (stride 32) the Python literal ``1 << 31``
    overflows int32 at trace time and, even promoted, would never equal
    the INT32_MIN the lowest-set-bit trick produces
    (tests/test_cascade.py::test_stride32_long_patterns_prefix_refinement)."""
    v = 1 << j
    return v - (1 << 32) if v >= (1 << 31) else v


def _prefix_hash_select(get_plane, w, s, l16, c_min):
    """Rolling prefix-hash of every cell's single-alignment candidate.

    For each cell at byte ``p`` with coarse word ``w``, the candidate
    window of alignment ``j`` is ``[p - j, p - j + l16)``.  Computes all
    ``s`` window hashes by one base hash + ``s-1`` O(1) rolling steps
    (leading byte removed via the static ``K^(l16-1)`` weight, trailing
    byte appended), then selects the hash of the alignment named by the
    LOWEST set bit of ``w`` — exactly the single-candidate case the
    caller refines; multi-bit cells are passed through unrefined.

    ``get_plane(c)`` returns the corpus word at offset ``c`` from the
    cell's first word; bytes are extracted lazily and memoized."""
    K = jnp.uint32(GRAM_BASE)
    KL = jnp.uint32(pow(GRAM_BASE, l16 - 1, 1 << 32))
    plane_memo = {}
    byte_memo = {}

    def b(x):
        if x not in byte_memo:
            c, k = c_min + x // 4, x % 4
            if c not in plane_memo:
                plane_memo[c] = get_plane(c)
            byte_memo[x] = (
                plane_memo[c].astype(jnp.uint32) >> jnp.uint32(8 * k)
            ) & jnp.uint32(0xFF)
        return byte_memo[x]

    smask = (1 << s) - 1 if s < 32 else -1
    w8 = w & smask
    low = w8 & (0 - w8)  # lowest set bit (0 when no bits)
    off = -4 * c_min - (s - 1)  # window start byte of alignment s-1
    H = jnp.zeros(w.shape, jnp.uint32)
    for i in range(l16):
        H = H + b(off + i) * jnp.uint32(pow(GRAM_BASE, l16 - 1 - i, 1 << 32))
    h = jnp.where(low == _align_bit_i32(s - 1), H.astype(jnp.int32), 0)
    for j in range(s - 2, -1, -1):
        H = (H - b(off) * KL) * K + b(off + l16)
        off += 1
        h = jnp.where(low == _align_bit_i32(j), H.astype(jnp.int32), h)
    return h


def prefix_refine_words(w, hval, ok, stride):
    """Single-alignment refinement rule: zero the long word of a slot
    whose single coarse alignment bit failed the prefix probe; multi-bit
    slots pass unrefined (exactness never rests on a bloom)."""
    smask = (1 << stride) - 1 if stride < 32 else -1
    v = w & smask
    single = (v != 0) & ((v & (v - 1)) == 0)
    keep = (jnp.logical_not(single)) | (ok == 1)
    return jnp.where(keep, w, 0)


def group_rank_extract(w, sw, hval, block_r, mpr, n_blocks, n_grid):
    """Survivor rank extraction per block column of the grouped take
    path: a column cumsum ranks each column's hits and slot ``k``
    captures the (k+1)-th hit's row / word / value by masked sums.
    Inputs are flat ``[n_blocks * block_r * 128]`` arrays; returns
    ``(r_s, w_s, swo_s, h_s, cnt)`` with slot arrays ``[n_blocks * mpr,
    128]`` (``r_s`` = row within the block, -1 when empty) and ``cnt
    [n_blocks, 128]`` the per-column survivor counts (``max(cnt) > mpr``
    means slots were dropped and the launch must retry)."""
    tot = n_blocks * block_r * 128
    cell = jnp.arange(tot, dtype=jnp.int32)
    hit = ((w | sw) != 0) & (cell < n_grid)

    def g3(x):
        return x.reshape(n_blocks, block_r, 128)

    w3, sw3, c3, h3 = g3(w), g3(sw), g3(hval), g3(hit)
    hi = h3.astype(jnp.int32)
    cnt = jnp.sum(hi, axis=1)  # [n_blocks, 128]
    ranks = jnp.cumsum(hi, axis=1)
    row_i = jax.lax.broadcasted_iota(
        jnp.int32, (n_blocks, block_r, 128), 1
    )
    r_s, w_s, swo_s, c_s = [], [], [], []
    for k in range(mpr):
        sel = h3 & (ranks == k + 1)
        r_s.append(jnp.sum(jnp.where(sel, row_i + 1, 0), axis=1) - 1)
        w_s.append(jnp.sum(jnp.where(sel, w3, 0), axis=1))
        swo_s.append(jnp.sum(jnp.where(sel, sw3, 0), axis=1))
        c_s.append(jnp.sum(jnp.where(sel, c3, 0), axis=1))

    def st(parts):  # [n_blocks, mpr, 128] -> [n_blocks * mpr, 128]
        return jnp.stack(parts, axis=1).reshape(n_blocks * mpr, 128)

    return st(r_s), st(w_s), st(swo_s), st(c_s), cnt


def _short_start_words(chunks, lengths, shorts, stride, M):
    """Exact short-pattern starts packed per grid cell (bit ``i`` =>
    short match starting at ``m * stride + i``)."""
    B, L = chunks.shape
    sm = short_pattern_mask(chunks, shorts)
    sm &= (
        jax.lax.broadcasted_iota(jnp.int32, (B, L), 1) < lengths[:, None]
    )
    pad = jnp.zeros((B, M * stride - L), jnp.bool_)
    cell = jnp.concatenate([sm, pad], 1).reshape(B, M, stride)
    weights = jnp.int32(1) << jnp.arange(stride, dtype=jnp.int32)
    return jnp.sum(cell * weights[None, None, :], axis=2, dtype=jnp.int32)


@functools.partial(
    jax.jit,
    static_argnames=("n_classes", "stride", "win_len", "capacity", "n_hits"),
)
def verify_windows(
    table_flat: jax.Array,  # [S*C] int16/int32 dense transition table
    byte_class: jax.Array,
    used_bytes: jax.Array,
    chunks: jax.Array,  # [B, L] uint8, L % 4 == 0 (ROW_ALIGN)
    lengths: jax.Array,  # [B] int32
    grid_idx: jax.Array,  # [>=n_hits] int32 b*M+m hits, INT32_MAX-padded
    final_start: jax.Array,  # scalar int32
    n_classes: int,
    stride: int,
    win_len: int,  # (stride - 1) + max_pattern_len, <= 32
    capacity: int,
    n_hits: int,  # static pow2 slot count; slices grid_idx in-jit
) -> Tuple[jax.Array, jax.Array]:
    """Device verification of sampled-filter hits: walk the dense DFA over
    each hit's candidate window so only *matching* windows ever leave the
    device (the match-free common case fetches two scalars — on rigs where
    host<->device transfers are slow this beats shipping candidate buffers
    to a host verifier).

    Window of the hit at grid point ``p = m * stride``: ``[p - stride + 1,
    p + max_len)`` — it contains every occurrence whose *own* guaranteed
    hit is this cell (long starts in ``[p-stride+1, p]``, short starts in
    ``[p, p+stride)``).  The walk starts from the root at the window head,
    so any final state it reaches is a genuine in-window match; positions
    outside ``[0, length)`` contribute class 0 which pins the DFA at the
    root (unused-byte transitions all lead there).

    Returns ``(win_cell [cap] — grid ids of windows containing >= 1 final
    position, ascending, INT32_MAX-padded; n_flagged)``.  The host
    re-walks only flagged windows (work proportional to matches) and
    applies the exactly-once ownership rules (models/cascade.py
    emit_windows)."""
    B, L = chunks.shape
    M = -(-L // stride)
    H = min(n_hits, grid_idx.shape[0])
    grid_idx = grid_idx[:H]
    W = win_len
    active = grid_idx < INT32_MAX
    g = jnp.where(active, grid_idx, 0)
    b = g // M
    w0 = (g % M) * stride - (stride - 1)  # window head (may be < 0)

    base = b * L + w0
    row_len = lengths[b]
    if n_classes <= 255:
        # Fetch window CLASSES as packed 4-per-int32 words: one corpus
        # classify+pack pass (elementwise + strided lane slices) turns 2
        # gathers per window position (byte + class) into W/4+2 word
        # gathers per window — 262k vs 1.5M lookups at the headline's
        # 32k-window capacity.  Extraction is select/shift ALU only: the
        # covering word of position j is one of two adjacent fetched words
        # (carry select), never a per-j gather.  The class pack slices
        # LANES (cls32[:, k::4]), which avoids a u8[..., 4] minor-dim
        # reshape.
        cls_all = _classes(chunks, byte_class, used_bytes).astype(jnp.uint32)
        cw = None
        for k in range(4):
            part = cls_all[:, k::4] << jnp.uint32(8 * k)
            cw = part if cw is None else (cw | part)
        cw_flat = cw.reshape(-1)
        nw = cw_flat.shape[0]
        wbase = base >> 2  # floor division (base may be negative)
        off = base & 3
        n_words = W // 4 + 2
        wv = [
            jnp.take(cw_flat, jnp.clip(wbase + i, 0, nw - 1))
            for i in range(n_words)
        ]
        cols = []
        for j in range(W):
            lo, rem = divmod(j, 4)
            carry = off + rem >= 4  # covering word is wv[lo] or wv[lo+1]
            word = jnp.where(carry, wv[lo + 1], wv[lo])
            shift = ((off + rem) & 3) * 8
            cols.append(((word >> shift) & jnp.uint32(0xFF)).astype(jnp.int32))
    else:
        # >255 classes cannot pack into bytes: gather bytes directly
        # (H*W lookups, proportional to the hit count, not the corpus)
        j_idx = jnp.arange(W, dtype=jnp.int32)[None, :]
        bidx = jnp.clip(base[:, None] + j_idx, 0, B * L - 1)
        byte = jnp.take(chunks.reshape(-1), bidx).astype(jnp.int32)
        cls2d = _classes(byte.astype(jnp.uint8), byte_class, used_bytes)
        cols = [cls2d[:, j] for j in range(W)]

    # unrolled walk (W <= 32 static): no per-step loop overhead on these
    # small [H] gathers.  Per-j [H] vectors throughout — an [H, W] matrix
    # would pad its small minor dim W.
    state = jnp.zeros((H,), jnp.int32)
    flagged = jnp.zeros((H,), jnp.bool_)
    for j in range(W):
        pos_j = w0 + j
        valid_j = (pos_j >= 0) & (pos_j < row_len) & active
        cls_j = jnp.where(valid_j, cols[j], 0)
        state = jnp.take(table_flat, state * n_classes + cls_j).astype(
            jnp.int32
        )
        flagged |= (state >= final_start) & valid_j
    n_flagged = flagged.sum(dtype=jnp.int32)
    (slot,) = jnp.nonzero(flagged, size=capacity, fill_value=INT32_MAX)
    safe = jnp.minimum(slot, H - 1)
    win_cell = jnp.where(
        slot < INT32_MAX, jnp.take(grid_idx, safe), INT32_MAX
    )
    return win_cell, n_flagged


#: record slots per verified window; windows with more final positions
#: emit a sentinel record and are re-walked exactly on the host
VERIFY_KR = 4
#: sentinel ``j`` value marking a window whose record slots overflowed
#: (the path is gated to ``win_len <= 31`` so no real record uses it)
REC_OVERFLOW_J = 31


@functools.partial(
    jax.jit,
    static_argnames=(
        "n_classes", "stride", "win_len", "capacity", "n_hits",
    ),
)
def verify_windows_records(
    table_flat: jax.Array,  # [S*C] int16/int32 dense transition table
    byte_class: jax.Array,
    used_bytes: jax.Array,
    chunks: jax.Array,  # [B, L] uint8, L % 4 == 0 (ROW_ALIGN)
    lengths: jax.Array,  # [B] int32
    emit_from: jax.Array,  # [B] int32
    grid_idx: jax.Array,  # [>=n_hits] int32 b*M+m hits, INT32_MAX-padded
    final_start: jax.Array,  # scalar int32
    n_classes: int,
    stride: int,
    win_len: int,  # <= 31 (REC_OVERFLOW_J is reserved)
    capacity: int,
    n_hits: int,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Device verification with *match-record* emission (VERDICT r3 #2):
    instead of flagged window cells that the host must re-walk, ships
    compacted ``(cell, state*32 + j)`` records — one per final position
    of each verified window — so host work (and the host<->device fetch)
    is proportional to the MATCH count, not to windows x win_len (the
    flagged-window chain re-walks every flagged window in numpy).

    Each window accumulates up to ``VERIFY_KR`` records during the
    unrolled 1-gram walk; a window with more final positions emits one
    sentinel record (``j == REC_OVERFLOW_J``) and the host re-walks it
    exactly (``CascadeModel.emit_records_arrays``), so output is never
    truncated silently.  Device-side gating applies the row emission
    window (``emit_from``/``length``); the per-pattern ownership rule
    (which needs pattern lengths) stays on the host over the expanded
    records.

    Returns ``(rec_cell [cap], rec_pack [cap], n_rec)`` in slot order
    (host lexsorts after expansion); retry doubled when ``n_rec >
    capacity``.  Requires ``states < 2**26`` (26 + 5 bits packed) and
    ``win_len <= 31`` — callers gate via ``CascadeModel.records_ok``."""
    B, L = chunks.shape
    M = -(-L // stride)
    H = min(n_hits, grid_idx.shape[0])
    grid_idx = grid_idx[:H]
    W = win_len
    active = grid_idx < INT32_MAX
    g = jnp.where(active, grid_idx, 0)
    b = g // M
    w0 = (g % M) * stride - (stride - 1)
    base = b * L + w0
    row_len = lengths[b]
    row_emit = emit_from[b]

    if n_classes <= 255 and H * W * 32 >= B * L:
        # packed-class fetch: one corpus-wide classify+pack pass, W/4+2
        # word gathers per window (see verify_windows) — worth its corpus
        # pass once it saves more window gathers (~0.7*H*W) than the
        # pass's ~corpus/32 gather-equivalents
        cls_all = _classes(chunks, byte_class, used_bytes).astype(jnp.uint32)
        cw = None
        for k in range(4):
            part = cls_all[:, k::4] << jnp.uint32(8 * k)
            cw = part if cw is None else (cw | part)
        cw_flat = cw.reshape(-1)
        nw = cw_flat.shape[0]
        wbase = base >> 2
        off = base & 3
        n_words = W // 4 + 2
        wv = [
            jnp.take(cw_flat, jnp.clip(wbase + i, 0, nw - 1))
            for i in range(n_words)
        ]
        cols = []
        for j in range(W):
            lo, rem = divmod(j, 4)
            carry = off + rem >= 4
            word = jnp.where(carry, wv[lo + 1], wv[lo])
            shift = ((off + rem) & 3) * 8
            cols.append(
                ((word >> shift) & jnp.uint32(0xFF)).astype(jnp.int32)
            )
    else:
        # byte gathers proportional to the hit count (H*W), skipping the
        # corpus-wide class pack — the right trade at small H (the
        # common case once the prefix refinement prunes strays)
        j_idx = jnp.arange(W, dtype=jnp.int32)[None, :]
        bidx = jnp.clip(base[:, None] + j_idx, 0, B * L - 1)
        byte = jnp.take(chunks.reshape(-1), bidx).astype(jnp.int32)
        cls2d = _classes(byte.astype(jnp.uint8), byte_class, used_bytes)
        cols = [cls2d[:, j] for j in range(W)]

    state = jnp.zeros((H,), jnp.int32)
    cnt = jnp.zeros((H,), jnp.int32)
    slots = [jnp.zeros((H,), jnp.int32) for _ in range(VERIFY_KR)]
    for j in range(W):
        pos_j = w0 + j
        valid_j = (pos_j >= 0) & (pos_j < row_len) & active
        cls_j = jnp.where(valid_j, cols[j], 0)
        state = jnp.take(table_flat, state * n_classes + cls_j).astype(
            jnp.int32
        )
        fin = (
            (state >= final_start)
            & valid_j
            & (pos_j >= row_emit)
        )
        pack = state * 32 + j
        for k in range(VERIFY_KR):
            slots[k] = jnp.where(fin & (cnt == k), pack, slots[k])
        cnt = cnt + fin.astype(jnp.int32)
    over = cnt > VERIFY_KR
    slots.append(jnp.where(over, jnp.int32(REC_OVERFLOW_J), 0))
    used = [cnt > k for k in range(VERIFY_KR)] + [over]

    alive = jnp.stack(used).reshape(-1)  # [KR+1, H] slot-major
    slot_idx, n_rec = blocked_nonzero(alive, capacity)
    tot = (VERIFY_KR + 1) * H
    safe = jnp.minimum(slot_idx, tot - 1)
    valid = slot_idx < INT32_MAX
    pk = jnp.stack(slots).reshape(-1)
    cells = jnp.take(grid_idx, safe % H)
    rec_cell = jnp.where(valid, cells, INT32_MAX)
    rec_pack = jnp.where(valid, jnp.take(pk, safe), 0)
    return rec_cell, rec_pack, n_rec


#: state-field width of the packed 2-step verify entry (s2 | s1 << 15)
REC2_BITS = 15


@functools.partial(
    jax.jit,
    static_argnames=(
        "n_classes", "stride", "win_len", "capacity", "n_hits",
    ),
)
def verify_windows_records2(
    table2_flat: jax.Array,  # [S * C * C] int32 packed 2-step entries
    byte_class: jax.Array,
    used_bytes: jax.Array,
    chunks: jax.Array,  # [B, L] uint8, L % 4 == 0 (ROW_ALIGN)
    lengths: jax.Array,  # [B] int32
    emit_from: jax.Array,  # [B] int32
    grid_idx: jax.Array,  # [>=n_hits] int32 b*M+m hits, INT32_MAX-padded
    final_start: jax.Array,  # scalar int32
    n_classes: int,
    stride: int,
    win_len: int,  # <= 31 (REC_OVERFLOW_J is reserved)
    capacity: int,
    n_hits: int,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """:func:`verify_windows_records` in 2-class super-steps: the packed
    table ``table2[s, c1*C + c2] = s2 | (s1 << 15)`` advances two window
    positions per dependent gather, halving the serial chain that floors
    the match-dense verify stage (the per-position intermediate state
    ``s1`` rides in the entry's high bits, so finals
    at BOTH positions are detected exactly, with the same per-window
    record slots / overflow sentinel).  Requires ``S < 2**15``
    (CascadeModel.records2_ok); positions outside ``[0, length)``
    contribute class 0 (root transitions) exactly like the 1-step walk."""
    B, L = chunks.shape
    M = -(-L // stride)
    H = min(n_hits, grid_idx.shape[0])
    grid_idx = grid_idx[:H]
    W = win_len
    active = grid_idx < INT32_MAX
    g = jnp.where(active, grid_idx, 0)
    b = g // M
    w0 = (g % M) * stride - (stride - 1)
    base = b * L + w0
    row_len = lengths[b]
    row_emit = emit_from[b]

    if n_classes <= 255 and H * W * 32 >= B * L:
        cls_all = _classes(chunks, byte_class, used_bytes).astype(jnp.uint32)
        cw = None
        for k in range(4):
            part = cls_all[:, k::4] << jnp.uint32(8 * k)
            cw = part if cw is None else (cw | part)
        cw_flat = cw.reshape(-1)
        nw = cw_flat.shape[0]
        wbase = base >> 2
        off = base & 3
        n_words = W // 4 + 2
        wv = [
            jnp.take(cw_flat, jnp.clip(wbase + i, 0, nw - 1))
            for i in range(n_words)
        ]
        cols = []
        for j in range(W):
            lo, rem = divmod(j, 4)
            carry = off + rem >= 4
            word = jnp.where(carry, wv[lo + 1], wv[lo])
            shift = ((off + rem) & 3) * 8
            cols.append(
                ((word >> shift) & jnp.uint32(0xFF)).astype(jnp.int32)
            )
    else:
        j_idx = jnp.arange(W, dtype=jnp.int32)[None, :]
        bidx = jnp.clip(base[:, None] + j_idx, 0, B * L - 1)
        byte = jnp.take(chunks.reshape(-1), bidx).astype(jnp.int32)
        cls2d = _classes(byte.astype(jnp.uint8), byte_class, used_bytes)
        cols = [cls2d[:, j] for j in range(W)]

    smask = (1 << REC2_BITS) - 1
    C2 = n_classes * n_classes
    state = jnp.zeros((H,), jnp.int32)
    cnt = jnp.zeros((H,), jnp.int32)
    slots = [jnp.zeros((H,), jnp.int32) for _ in range(VERIFY_KR)]
    for t in range(-(-W // 2)):
        j1, j2 = 2 * t, 2 * t + 1
        pos1 = w0 + j1
        valid1 = (pos1 >= 0) & (pos1 < row_len) & active
        c1 = jnp.where(valid1, cols[j1], 0)
        if j2 < W:
            pos2 = w0 + j2
            valid2 = (pos2 >= 0) & (pos2 < row_len) & active
            c2 = jnp.where(valid2, cols[j2], 0)
        else:
            pos2 = pos1  # dead half-step: class 0, never emits
            valid2 = jnp.zeros_like(valid1)
            c2 = jnp.zeros_like(c1)
        entry = jnp.take(
            table2_flat, state * C2 + c1 * n_classes + c2
        ).astype(jnp.int32)
        s1 = entry >> REC2_BITS
        s2 = entry & smask
        for s_j, pos_j, valid_j, j in (
            (s1, pos1, valid1, j1),
            (s2, pos2, valid2, j2),
        ):
            if j >= W:
                continue
            fin = (
                (s_j >= final_start) & valid_j & (pos_j >= row_emit)
            )
            pack = s_j * 32 + j
            for k in range(VERIFY_KR):
                slots[k] = jnp.where(fin & (cnt == k), pack, slots[k])
            cnt = cnt + fin.astype(jnp.int32)
        state = s2
    over = cnt > VERIFY_KR
    slots.append(jnp.where(over, jnp.int32(REC_OVERFLOW_J), 0))
    used = [cnt > k for k in range(VERIFY_KR)] + [over]

    alive = jnp.stack(used).reshape(-1)
    slot_idx, n_rec = blocked_nonzero(alive, capacity)
    tot = (VERIFY_KR + 1) * H
    safe = jnp.minimum(slot_idx, tot - 1)
    valid = slot_idx < INT32_MAX
    pk = jnp.stack(slots).reshape(-1)
    cells = jnp.take(grid_idx, safe % H)
    rec_cell = jnp.where(valid, cells, INT32_MAX)
    rec_pack = jnp.where(valid, jnp.take(pk, safe), 0)
    return rec_cell, rec_pack, n_rec


@functools.partial(
    jax.jit,
    static_argnames=(
        "n_classes", "n_dense", "stride", "win_len", "capacity", "n_hits",
    ),
)
def verify_windows_records_compressed(
    dense_flat: jax.Array,  # [D*C] int32 dense-bank rows
    meta: jax.Array,  # [S-D] int32 packed (skip * EXC_PACK + exc_class + 1)
    exc_target: jax.Array,  # [S-D] int32
    byte_class: jax.Array,
    used_bytes: jax.Array,
    chunks: jax.Array,  # [B, L] uint8
    lengths: jax.Array,  # [B] int32
    emit_from: jax.Array,  # [B] int32
    grid_idx: jax.Array,  # [>=n_hits] int32 b*M+m hits, INT32_MAX-padded
    dense_final_start: jax.Array,  # scalar int32
    final_start: jax.Array,  # scalar int32
    n_classes: int,
    n_dense: int,
    stride: int,
    win_len: int,  # <= 31 (REC_OVERFLOW_J is reserved)
    capacity: int,
    n_hits: int,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Compressed-table edition of :func:`verify_windows_records`: the
    per-step walk is the fixed 3-gather compressed lookup and finality
    the two-range predicate (see ``verify_windows_compressed``), with
    the same per-window record slots / overflow sentinel — this brings
    match-count-proportional host work to signature-scale sets whose
    dense table exceeds HBM."""
    from ..core.tables import EXC_PACK

    B, L = chunks.shape
    M = -(-L // stride)
    H = min(n_hits, grid_idx.shape[0])
    grid_idx = grid_idx[:H]
    W = win_len
    active = grid_idx < INT32_MAX
    g = jnp.where(active, grid_idx, 0)
    b = g // M
    w0 = (g % M) * stride - (stride - 1)
    base = b * L + w0
    row_len = lengths[b]
    row_emit = emit_from[b]

    j_idx = jnp.arange(W, dtype=jnp.int32)[None, :]
    bidx = jnp.clip(base[:, None] + j_idx, 0, B * L - 1)
    byte = jnp.take(chunks.reshape(-1), bidx).astype(jnp.int32)
    cls2d = _classes(byte.astype(jnp.uint8), byte_class, used_bytes)

    D = jnp.int32(n_dense)
    state = jnp.zeros((H,), jnp.int32)
    cnt = jnp.zeros((H,), jnp.int32)
    slots = [jnp.zeros((H,), jnp.int32) for _ in range(VERIFY_KR)]
    for j in range(W):
        pos_j = w0 + j
        valid_j = (pos_j >= 0) & (pos_j < row_len) & active
        c = jnp.where(valid_j, cls2d[:, j], 0)
        sp = jnp.maximum(state - D, 0)
        m_ = jnp.take(meta, sp)
        tgt = jnp.take(exc_target, sp)
        key = m_ % EXC_PACK - 1
        skip = m_ // EXC_PACK
        row = jnp.where(state < D, state, skip)
        fb = jnp.take(dense_flat, row * n_classes + c)
        state = jnp.where((state >= D) & (c == key), tgt, fb).astype(
            jnp.int32
        )
        is_fin = (state >= final_start) | (
            (state < D) & (state >= dense_final_start)
        )
        fin = is_fin & valid_j & (pos_j >= row_emit)
        pack = state * 32 + j
        for k in range(VERIFY_KR):
            slots[k] = jnp.where(fin & (cnt == k), pack, slots[k])
        cnt = cnt + fin.astype(jnp.int32)
    over = cnt > VERIFY_KR
    slots.append(jnp.where(over, jnp.int32(REC_OVERFLOW_J), 0))
    used = [cnt > k for k in range(VERIFY_KR)] + [over]

    alive = jnp.stack(used).reshape(-1)
    slot_idx, n_rec = blocked_nonzero(alive, capacity)
    tot = (VERIFY_KR + 1) * H
    safe = jnp.minimum(slot_idx, tot - 1)
    valid = slot_idx < INT32_MAX
    pk = jnp.stack(slots).reshape(-1)
    cells = jnp.take(grid_idx, safe % H)
    rec_cell = jnp.where(valid, cells, INT32_MAX)
    rec_pack = jnp.where(valid, jnp.take(pk, safe), 0)
    return rec_cell, rec_pack, n_rec


@functools.partial(
    jax.jit,
    static_argnames=(
        "n_classes", "kv", "stride", "win_len", "capacity", "n_hits",
    ),
)
def verify_windows_kgram(
    ktable: jax.Array,  # [S * C^kv] int16/int32 packed k-gram entries
    byte_class: jax.Array,
    used_bytes: jax.Array,
    chunks: jax.Array,  # [B, L] uint8, L % 4 == 0 (ROW_ALIGN)
    lengths: jax.Array,  # [B] int32
    grid_idx: jax.Array,  # [>=n_hits] int32 b*M+m hits, INT32_MAX-padded
    final_start: jax.Array,  # scalar int32
    n_classes: int,
    kv: int,
    stride: int,
    win_len: int,
    capacity: int,
    n_hits: int,
) -> Tuple[jax.Array, jax.Array]:
    """:func:`verify_windows` in ``kv``-class super-steps: the k-gram
    table's mid-final flag (models/kgram_dfa.py) records finals strictly
    inside a cell and the end state's own finality is one compare, so the
    23-step dependent gather chain of the per-class walk becomes
    ``ceil(W/kv)`` gathers (6 at kv=4) — the dependent chain was the
    verify stage's floor once window classes came from packed words.

    Exactness under masking: positions outside ``[0, length)`` (and past
    the window) contribute class 0; no pattern contains an unused byte, so
    every class-0 transition lands at the root — a masked position can
    never be final, which makes the cell's mid flag equivalent to the
    per-position ``final & valid`` disjunction of the 1-gram walk.
    Requires ``n_classes <= 255`` (packed-class fetch)."""
    assert n_classes <= 255, "kgram verify requires packed classes"
    B, L = chunks.shape
    M = -(-L // stride)
    H = min(n_hits, grid_idx.shape[0])
    grid_idx = grid_idx[:H]
    W = win_len
    active = grid_idx < INT32_MAX
    g = jnp.where(active, grid_idx, 0)
    b = g // M
    w0 = (g % M) * stride - (stride - 1)
    base = b * L + w0
    row_len = lengths[b]

    # packed-class word fetch (see verify_windows)
    cls_all = _classes(chunks, byte_class, used_bytes).astype(jnp.uint32)
    cw = None
    for k in range(4):
        part = cls_all[:, k::4] << jnp.uint32(8 * k)
        cw = part if cw is None else (cw | part)
    cw_flat = cw.reshape(-1)
    nw = cw_flat.shape[0]
    wbase = base >> 2
    off = base & 3
    n_words = W // 4 + 2
    wv = [
        jnp.take(cw_flat, jnp.clip(wbase + i, 0, nw - 1))
        for i in range(n_words)
    ]

    def col(j):
        lo, rem = divmod(j, 4)
        carry = off + rem >= 4
        word = jnp.where(carry, wv[lo + 1], wv[lo])
        shift = ((off + rem) & 3) * 8
        c = ((word >> shift) & jnp.uint32(0xFF)).astype(jnp.int32)
        pos_j = w0 + j
        return jnp.where((pos_j >= 0) & (pos_j < row_len) & active, c, 0)

    is16 = ktable.dtype == jnp.int16
    ck = n_classes ** kv
    state = jnp.zeros((H,), jnp.int32)
    flagged = jnp.zeros((H,), jnp.bool_)
    for t in range(-(-W // kv)):
        code = jnp.zeros((H,), jnp.int32)
        for d in range(kv):
            j = t * kv + d
            code = code * n_classes + (col(j) if j < W else 0)
        entry = jnp.take(ktable, state * ck + code)
        if is16:
            state = (entry & jnp.int16(0x7FFF)).astype(jnp.int32)
            mid = entry < 0
        else:
            state = entry & KGRAM_STATE_MASK
            mid = (entry & KGRAM_MID_FLAG) != 0
        flagged |= mid | (state >= final_start)
    n_flagged = flagged.sum(dtype=jnp.int32)
    (slot,) = jnp.nonzero(flagged, size=capacity, fill_value=INT32_MAX)
    safe = jnp.minimum(slot, H - 1)
    win_cell = jnp.where(
        slot < INT32_MAX, jnp.take(grid_idx, safe), INT32_MAX
    )
    return win_cell, n_flagged


@functools.partial(
    jax.jit,
    static_argnames=(
        "n_classes", "n_dense", "stride", "win_len", "capacity", "n_hits",
    ),
)
def verify_windows_compressed(
    dense_flat: jax.Array,  # [D*C] int32 dense-bank rows
    meta: jax.Array,  # [S-D] int32 packed (skip * EXC_PACK + exc_class + 1)
    exc_target: jax.Array,  # [S-D] int32
    byte_class: jax.Array,
    used_bytes: jax.Array,
    chunks: jax.Array,  # [B, L] uint8
    lengths: jax.Array,  # [B] int32
    grid_idx: jax.Array,  # [>=n_hits] int32 b*M+m hits, INT32_MAX-padded
    dense_final_start: jax.Array,  # scalar int32
    final_start: jax.Array,  # scalar int32
    n_classes: int,
    n_dense: int,
    stride: int,
    win_len: int,
    capacity: int,
    n_hits: int,
) -> Tuple[jax.Array, jax.Array]:
    """Compressed-table analog of :func:`verify_windows`: the per-step
    walk is the fixed 3-gather compressed lookup
    (ops/scan_jax.scan_states_compressed) and finality the two-range
    predicate — this is what lets the sampled cascade (the fast engine)
    run on byte-dense signature-scale sets whose dense ``[S, C]`` table
    exceeds HBM (SURVEY §7; core/tables.CompressedAutomaton)."""
    from ..core.tables import EXC_PACK

    B, L = chunks.shape
    M = -(-L // stride)
    H = min(n_hits, grid_idx.shape[0])
    grid_idx = grid_idx[:H]
    W = win_len
    active = grid_idx < INT32_MAX
    g = jnp.where(active, grid_idx, 0)
    b = g // M
    w0 = (g % M) * stride - (stride - 1)

    j_idx = jnp.arange(W, dtype=jnp.int32)[None, :]
    base = b * L + w0
    bidx = jnp.clip(base[:, None] + j_idx, 0, B * L - 1)
    byte = jnp.take(chunks.reshape(-1), bidx).astype(jnp.int32)

    pos = w0[:, None] + j_idx
    valid = (pos >= 0) & (pos < lengths[b][:, None]) & active[:, None]
    cls = _classes(byte.astype(jnp.uint8), byte_class, used_bytes)
    cls = jnp.where(valid, cls, 0)

    D = jnp.int32(n_dense)
    state = jnp.zeros((H,), jnp.int32)
    flagged = jnp.zeros((H,), jnp.bool_)
    for j in range(W):
        c = cls[:, j]
        sp = jnp.maximum(state - D, 0)
        m = jnp.take(meta, sp)
        tgt = jnp.take(exc_target, sp)
        key = m % EXC_PACK - 1
        skip = m // EXC_PACK
        row = jnp.where(state < D, state, skip)
        fb = jnp.take(dense_flat, row * n_classes + c)
        state = jnp.where((state >= D) & (c == key), tgt, fb).astype(
            jnp.int32
        )
        fin = (state >= final_start) | (
            (state < D) & (state >= dense_final_start)
        )
        flagged |= fin & valid[:, j]
    n_flagged = flagged.sum(dtype=jnp.int32)
    (slot,) = jnp.nonzero(flagged, size=capacity, fill_value=INT32_MAX)
    safe = jnp.minimum(slot, H - 1)
    win_cell = jnp.where(
        slot < INT32_MAX, jnp.take(grid_idx, safe), INT32_MAX
    )
    return win_cell, n_flagged


@functools.partial(
    jax.jit,
    static_argnames=(
        "n_classes", "q", "offsets", "log2_bits", "salts", "shorts",
        "capacity",
    ),
)
def filter_candidates(
    bloom_words: jax.Array,  # [n_stages, bits/32] int32
    byte_class: jax.Array,
    used_bytes: jax.Array,
    chunks: jax.Array,  # [B, L] uint8
    lengths: jax.Array,  # [B] int32
    emit_from: jax.Array,  # [B] int32
    min_long_len: jax.Array,  # scalar int32 (0 disables the long path)
    n_classes: int,
    q: int,
    offsets: Tuple[int, ...],
    log2_bits: int,
    salts: Tuple[int, ...],
    shorts: Tuple[bytes, ...],
    capacity: int,
) -> Tuple[jax.Array, jax.Array]:
    """Candidate-start compaction.  Returns ``(start_idx [capacity],
    n_candidates)`` where ``start_idx`` holds flattened ``b * L + p``
    ascending, INT32_MAX-padded.

    A position is a candidate iff it passes every bloom stage (potential
    long-pattern start) or exactly begins a short pattern, and a match
    starting there could own an emission in this row: its earliest
    possible end must fall before ``length`` and its latest possible end
    after ``emit_from`` (ownership itself is re-checked exactly during
    host verification)."""
    B, L = chunks.shape
    cls = _classes(chunks, byte_class, used_bytes)
    p_idx = jax.lax.broadcasted_iota(jnp.int32, (B, L), 1)
    if offsets:  # long-pattern bloom stages (absent in shorts-only plans)
        code = gram_codes(cls, q, n_classes)
        pad = jnp.zeros((B, max(offsets)), jnp.int32)
        code_ext = jnp.concatenate([code, pad], axis=1)
        cand = jnp.ones((B, L), jnp.bool_)
        for s, (off, salt) in enumerate(zip(offsets, salts)):
            code_o = jax.lax.dynamic_slice_in_dim(code_ext, off, L, 1)
            slots = bloom_slots(code_o, log2_bits, salt)
            cand &= bloom_hit_take(bloom_words[s], slots).astype(jnp.bool_)
        # long-pattern starts need min_long_len bytes left in the row
        cand &= p_idx + min_long_len <= lengths[:, None]
        cand &= min_long_len > 0
    else:
        cand = jnp.zeros((B, L), jnp.bool_)

    if shorts:
        cand |= short_pattern_mask(chunks, shorts)
    # any match from start p ends at >= p (length >= 1): drop starts whose
    # best-case end still precedes the emission window
    cand &= p_idx < lengths[:, None]
    idx, n = blocked_nonzero(cand.reshape(-1), capacity)
    return idx, n
