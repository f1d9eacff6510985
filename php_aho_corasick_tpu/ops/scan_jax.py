"""Device scan kernels (pure jnp/XLA path — runs on any backend).

The hot loop of the reference (`ac_trie_search`,
``src/multifast/ahocorasick.c:199-234``) is a sequential byte-at-a-time walk
with failure-link chasing.  Here the automaton is a precomposed dense table,
so advancing the DFA costs exactly one gather:

    ``state[t+1] = table[state[t] * C + class(byte[t])]``

The kernels are built around gather *economy*:

* byte -> class via compare-select (VPU) for small alphabets, not a lookup;
* the **k-gram engine** precomposes k transitions into one table
  ``table_k[s, code(c_0..c_{k-1})]`` whose int32 entry packs the end state
  plus a "some intermediate position was final" flag — one gather advances
  k bytes; flagged (i.e. matching) cells are re-walked on the host;
* match output is compacted **on device**: finality is a compare
  (``state >= final_start``, see tables.py renumbering), matched cells are
  extracted with a fixed-capacity ``nonzero`` (count-then-gather; the
  caller retries with doubled capacity on overflow — exact, never
  silently truncated).

The sequential dependency is over the row length; throughput comes from the
batch dimension (many haystacks and/or halo-overlapped chunks of long
haystacks in lockstep) — the device-side analog of the reference's "one
automaton, many haystacks" amortization pattern.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

INT32_MAX = jnp.iinfo(jnp.int32).max

#: k-gram entry layout: low bits = end state, bit 30 = "some intermediate
#: position inside this cell reached a final state" (host re-walks flagged
#: cells to recover exact positions; see models/kgram_dfa.py).
KGRAM_STATE_MASK = (1 << 30) - 1
KGRAM_MID_FLAG = 1 << 30

#: compare-select classification is used up to this many distinct bytes
CLASSIFY_SELECT_LIMIT = 32


def classify_bytes(chunks: jax.Array, used_bytes: jax.Array) -> jax.Array:
    """byte -> class id via compare-select (VPU) instead of a gather.

    ``used_bytes`` is the sorted array of byte values appearing in any
    pattern; byte ``used_bytes[i]`` has class ``i + 1`` (matching the table
    compiler's class assignment), all others class 0.  An unrolled compare
    chain runs at VPU speed vs ~100M elems/s for a gathered 256-entry
    lookup; the gather path remains for pattern sets touching many bytes.
    """
    cls = jnp.zeros(chunks.shape, jnp.int32)
    for i in range(used_bytes.shape[0]):
        cls = jnp.where(chunks == used_bytes[i], jnp.int32(i + 1), cls)
    return cls


def _classes(chunks, byte_class, used_bytes):
    if used_bytes.shape[0] <= CLASSIFY_SELECT_LIMIT:
        return classify_bytes(chunks, used_bytes)
    return jnp.take(byte_class, chunks.astype(jnp.int32), axis=0)


@functools.partial(jax.jit, static_argnames=("n_classes",))
def scan_states(
    table_flat: jax.Array,  # [S*C] int16/int32
    byte_class: jax.Array,  # [256] int32
    used_bytes: jax.Array,  # [U] uint8 (sorted; classes 1..U)
    chunks: jax.Array,  # [B, L] uint8
    init_state: jax.Array,  # [B] int32
    n_classes: int,
) -> Tuple[jax.Array, jax.Array]:
    """Run the DFA over each row. Returns (states [B, L] int32, final [B])."""
    cls = _classes(chunks, byte_class, used_bytes)

    def step(state, cls_t):
        ns = jnp.take(table_flat, state * n_classes + cls_t).astype(jnp.int32)
        return ns, ns

    last, states = jax.lax.scan(step, init_state, cls.T)  # states: [L, B]
    return states.T, last


@functools.partial(jax.jit, static_argnames=("n_classes", "capacity"))
def scan_and_compact(
    table_flat: jax.Array,
    byte_class: jax.Array,
    used_bytes: jax.Array,
    chunks: jax.Array,  # [B, L] uint8
    init_state: jax.Array,  # [B] int32
    lengths: jax.Array,  # [B] int32 valid byte count per row
    emit_from: jax.Array,  # [B] int32 first in-row position allowed to emit
    final_start: jax.Array,  # scalar int32
    n_classes: int,
    capacity: int,
) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Byte-at-a-time scan + device-side match compaction.

    Returns ``(match_idx [capacity], match_state [capacity], n_matches,
    carry_state [B])``.  ``match_idx`` holds flattened ``b * L + t`` indices
    of final positions in ascending order (reference scan order within each
    row), padded with INT32_MAX.  ``n_matches`` is the *true* number of
    final positions; if it exceeds ``capacity`` the caller must retry.

    ``emit_from`` masks halo positions: for a chunk row carrying a left
    halo, positions before ``emit_from`` are owned by the neighboring chunk
    (or were already reported by a previous streaming feed) and must not
    emit here.

    ``carry_state[b]`` is the DFA state after the last *valid* byte of row
    ``b`` (``states[b, lengths[b]-1]``; ``init_state[b]`` for an empty
    row) — the ``last_node`` analog (``ahocorasick.c:236-238``), usable as
    ``init_state`` of a continuation row.  Rows are padded to ``L``, so
    the raw after-L state would be poisoned by pad bytes.
    """
    states, _ = scan_states(
        table_flat, byte_class, used_bytes, chunks, init_state, n_classes
    )
    last_t = jnp.maximum(lengths - 1, 0)
    carry = jnp.take_along_axis(states, last_t[:, None], axis=1)[:, 0]
    carry = jnp.where(lengths > 0, carry, init_state)
    idx, match_state, n_matches = compact_final_states(
        states, lengths, emit_from, final_start, capacity
    )
    return idx, match_state, n_matches, carry


@functools.partial(jax.jit, static_argnames=("n_classes", "n_dense"))
def scan_states_compressed(
    dense_flat: jax.Array,  # [D*C] int32 dense-bank rows
    meta: jax.Array,  # [S-D] int32 packed (skip * EXC_PACK + exc_class + 1)
    exc_target: jax.Array,  # [S-D] int32
    byte_class: jax.Array,
    used_bytes: jax.Array,
    chunks: jax.Array,  # [B, L] uint8
    init_state: jax.Array,  # [B] int32
    n_classes: int,
    n_dense: int,
) -> Tuple[jax.Array, jax.Array]:
    """DFA scan over the compressed (dense bank + single-exception row)
    table — see core/tables.CompressedAutomaton.  Fixed 3 gathers per byte
    (meta, exc_target, dense fallback) with no data-dependent control flow;
    the branch-free replacement for the reference's failure-link chasing
    (``ahocorasick.c:203-206``) when the dense ``[S, C]`` table would
    exceed device memory (byte-dense million-pattern sets, SURVEY §7)."""
    from ..core.tables import EXC_PACK

    cls = _classes(chunks, byte_class, used_bytes)
    D = jnp.int32(n_dense)

    def step(state, cls_t):
        sp = jnp.maximum(state - D, 0)
        m = jnp.take(meta, sp)
        tgt = jnp.take(exc_target, sp)
        key = m % EXC_PACK - 1
        skip = m // EXC_PACK
        row = jnp.where(state < D, state, skip)
        fb = jnp.take(dense_flat, row * n_classes + cls_t)
        ns = jnp.where((state >= D) & (cls_t == key), tgt, fb)
        return ns, ns

    last, states = jax.lax.scan(step, init_state, cls.T)
    return states.T, last


@functools.partial(
    jax.jit,
    static_argnames=("n_classes", "n_dense", "capacity"),
)
def scan_and_compact_compressed(
    dense_flat: jax.Array,
    meta: jax.Array,
    exc_target: jax.Array,
    byte_class: jax.Array,
    used_bytes: jax.Array,
    chunks: jax.Array,
    init_state: jax.Array,
    lengths: jax.Array,
    emit_from: jax.Array,
    dense_final_start: jax.Array,  # scalar int32
    final_start: jax.Array,  # scalar int32
    n_classes: int,
    n_dense: int,
    capacity: int,
) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Compressed-table analog of :func:`scan_and_compact`.  Finality is
    the two-range predicate of the [dense nonfinal][dense final][sparse
    nonfinal][sparse final] numbering (tables.CompressedAutomaton)."""
    states, _ = scan_states_compressed(
        dense_flat, meta, exc_target, byte_class, used_bytes, chunks,
        init_state, n_classes, n_dense,
    )
    last_t = jnp.maximum(lengths - 1, 0)
    carry = jnp.take_along_axis(states, last_t[:, None], axis=1)[:, 0]
    carry = jnp.where(lengths > 0, carry, init_state)
    B, L = states.shape
    t_idx = jax.lax.broadcasted_iota(jnp.int32, (B, L), 1)
    final = (states >= final_start) | (
        (states < n_dense) & (states >= dense_final_start)
    )
    final &= (t_idx >= emit_from[:, None]) & (t_idx < lengths[:, None])
    idx, n_matches = blocked_nonzero(final.reshape(-1), capacity)
    safe = jnp.minimum(idx, B * L - 1)
    match_state = jnp.where(
        idx < INT32_MAX, jnp.take(states.reshape(-1), safe), -1
    )
    return idx, match_state, n_matches, carry


def blocked_nonzero(flat: jax.Array, capacity: int, blk: int = 8):
    """Multi-level fixed-capacity compaction of a sparse boolean vector.

    ``jnp.nonzero(size=)`` costs time per input element; reducing
    ``blk``-element blocks first and
    compacting only flagged blocks cuts the dominant pass to ``n/blk``
    elements (sparse masks => few flagged blocks).  When the block-flag
    vector still dwarfs the capacity, the block compaction RECURSES —
    each level shrinks the nonzero input another ``blk``-fold for one
    extra ``capacity*blk`` pass, so compaction cost is ~``capacity``-
    proportional instead of input-proportional.  Returns ``(idx
    [capacity] ascending, INT32_MAX-padded, n_true)``; exact whenever
    ``n_true <= capacity`` (flagged blocks <= true bits at EVERY level,
    so no block pass overflows first)."""
    n = flat.shape[0]
    n_true = flat.sum(dtype=jnp.int32)
    if capacity * blk >= n:
        # dense regime (capacity within blk x of the input): the block
        # pyramid's capacity*blk second pass would cost MORE than one
        # direct nonzero over the input — e.g. the 1e-3 match-density
        # rows, where capacity ~ n/2
        (idx,) = jnp.nonzero(flat, size=capacity, fill_value=INT32_MAX)
        return idx.astype(jnp.int32), n_true
    nb = -(-n // blk)
    flat_p = jnp.concatenate(
        [flat, jnp.zeros(nb * blk - n, jnp.bool_)]
    ).reshape(nb, blk)
    blk_any = flat_p.any(axis=1)
    if nb > 16 * capacity:  # recursion beats a direct nonzero(nb) once
        # nb >> capacity*blk (the extra level's own second-pass cost)
        bidx, _ = blocked_nonzero(blk_any, capacity, blk)
    else:
        (bidx,) = jnp.nonzero(blk_any, size=capacity, fill_value=INT32_MAX)
    safe_b = jnp.minimum(bidx, nb - 1).astype(jnp.int32)
    sub = jnp.take(flat_p, safe_b, axis=0)  # [capacity, blk]
    sub &= (bidx < INT32_MAX)[:, None]
    (fin,) = jnp.nonzero(
        sub.reshape(-1), size=capacity, fill_value=INT32_MAX
    )
    fin32 = fin.astype(jnp.int32)
    safe_f = jnp.minimum(fin32, capacity * blk - 1)
    elem = (
        jnp.take(safe_b, safe_f // blk) * blk + safe_f % blk
    ).astype(jnp.int32)
    idx = jnp.where(fin32 < INT32_MAX, elem, INT32_MAX)
    return idx, n_true


def compact_final_states(states, lengths, emit_from, final_start, capacity):
    """Fixed-capacity compaction of final positions from a states matrix
    (shared by the dfa and tile engines)."""
    B, L = states.shape
    t_idx = jax.lax.broadcasted_iota(jnp.int32, (B, L), 1)
    final = (
        (states >= final_start)
        & (t_idx >= emit_from[:, None])
        & (t_idx < lengths[:, None])
    )
    idx, n_matches = blocked_nonzero(final.reshape(-1), capacity)
    safe = jnp.minimum(idx, B * L - 1)
    match_state = jnp.where(
        idx < INT32_MAX, jnp.take(states.reshape(-1), safe), -1
    )
    return idx, match_state, n_matches


@functools.partial(
    jax.jit, static_argnames=("n_classes", "k", "capacity")
)
def scan_and_compact_kgram(
    ktable: jax.Array,  # [S * C^k] int32 packed entries
    byte_class: jax.Array,  # [256] int32
    used_bytes: jax.Array,  # [U] uint8
    chunks: jax.Array,  # [B, L] uint8, L % k == 0
    init_state: jax.Array,  # [B] int32
    lengths: jax.Array,  # [B] int32
    emit_from: jax.Array,  # [B] int32
    final_start: jax.Array,  # scalar int32
    n_classes: int,
    k: int,
    capacity: int,
) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """k-bytes-per-gather scan + cell-level compaction.

    A *cell* is a k-byte window (cell ``j`` of row ``b`` covers positions
    ``[j*k, (j+1)*k)``).  A cell is flagged when its entry's mid-final flag
    is set or its end state is final, and it overlaps the row's
    ``[emit_from, length)`` emission window.  Output per flagged cell:
    flattened cell index and the state *entering* the cell.  The host
    re-walks each flagged cell's k bytes through the 1-gram table to
    recover exact per-position matches (ops/matches.py
    expand_matches_kgram) — work proportional to matches, not corpus size.

    Returns ``(cell_idx [cap], prev_state [cap], n_cells, carry [B])``.
    """
    B, L = chunks.shape
    assert L % k == 0
    n_cells_row = L // k
    cls = _classes(chunks, byte_class, used_bytes)
    # cell codes: base-C digits of each k-byte window (strided slices fuse
    # better than a [B, Lc, k] reshape)
    code = cls[:, 0::k]
    for j in range(1, k):
        code = code * n_classes + cls[:, j::k]

    is16 = ktable.dtype == jnp.int16  # int16 entries: state | flag<<15

    def step(state, code_t):
        entry = jnp.take(ktable, state * (n_classes**k) + code_t)
        if is16:
            ns = (entry & jnp.int16(0x7FFF)).astype(jnp.int32)
            mid = entry < 0  # flag lives in the int16 sign bit
        else:
            ns = entry & KGRAM_STATE_MASK
            mid = (entry & KGRAM_MID_FLAG) != 0
        # pack "this cell contains a final position" into the sign bit of
        # the emitted prev-state (one output array instead of two)
        interesting = mid | (ns >= final_start)
        packed = state | jnp.where(interesting, jnp.int32(-(2**31)), 0)
        return ns, packed

    carry, packed = jax.lax.scan(step, init_state, code.T)  # [Lc, B]

    # compaction in the scan's native time-major layout (no [Lc,B]->[B,Lc]
    # transpose of the full emission); the handful of compacted indices are
    # converted to canonical b*Lc+t form here and re-sorted by the host
    cell_t = jax.lax.broadcasted_iota(jnp.int32, (n_cells_row, B), 0)
    overlaps = (cell_t * k < lengths[None, :]) & (
        (cell_t + 1) * k > emit_from[None, :]
    )
    flagged = ((packed < 0) & overlaps).reshape(-1)
    idx, n_flagged = blocked_nonzero(flagged, capacity)
    safe = jnp.minimum(idx, B * n_cells_row - 1)
    out_prev = jnp.where(
        idx < INT32_MAX,
        jnp.take(packed.reshape(-1), safe) & KGRAM_STATE_MASK,
        -1,
    )
    b_of = idx % B
    t_of = idx // B
    out_idx = jnp.where(
        idx < INT32_MAX, b_of * n_cells_row + t_of, INT32_MAX
    )
    return out_idx, out_prev, n_flagged, carry
