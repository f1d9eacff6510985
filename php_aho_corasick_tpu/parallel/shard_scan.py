"""Data-parallel sharded scan: pjit/shard_map over the ``data`` mesh axis.

Device-side replacement for the reference's "one automaton, many haystacks"
amortization (``README.md:7-9``): chunk rows are sharded over chips, the
transition table + byte-class map are replicated (HBM-resident per chip),
and each chip runs the same compacted scan kernel on its rows.  Collectives
(inside every shard_map body):

* ``psum`` — global match count (the scalar every caller needs first);
* ``pmax`` — worst per-shard buffer occupancy: the capacity-retry decision
  (a shard overflowing its fixed match buffer forces a doubled retry —
  never silent truncation) costs ONE replicated scalar fetch instead of a
  per-shard counts array;
* ``all_gather`` — per-shard true counts, replicated so every *host* of a
  multi-host mesh can slice the buffers; with ``collect=True`` the match
  buffers themselves are also all_gathered (replicated outputs are
  fully-addressable on every process — required for multi-host, wasted
  HBM single-process, hence the switch).

Without ``collect`` the match buffers stay sharded (out_spec ``P("data")``)
and are fetched shard-major, which preserves global scan order because rows
are packed document-major and shards are contiguous row blocks.

Halo handling is identical to the single-chip path: rows already carry
their left overlap (ops/matches.py pack_documents), so no neighbor
communication is needed during the scan — the halo is the sequence-parallel
story for a streaming DFA (SURVEY §2.4).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.scan_jax import INT32_MAX, scan_and_compact
from .mesh import DATA_AXIS


def per_shard_capacity(
    global_est: int, n_shards: int, floor: int = 256
) -> int:
    """Per-shard buffer capacity from a GLOBAL hit estimate: the shard
    mean plus a 4-sigma Poisson imbalance margin (rows are sharded
    round-robin-by-block, so per-shard counts concentrate around
    ``global/n``).

    ``verify_windows`` walks its full *static* capacity, so a shard
    sized for the global count does ``n_shards`` x too much verify work
    and total throughput FALLS as devices are added.  The
    ``floor`` is the fixed term of the scaling-efficiency model: chips
    stop helping once ``global/n`` drops under it."""
    mean = max(int(global_est), 1) / max(n_shards, 1)
    return max(floor, int(mean + 4.0 * mean**0.5 + 8))

try:  # jax >= 0.6 exposes shard_map at top level
    shard_map = jax.shard_map
except AttributeError:  # pragma: no cover - older jax
    from jax.experimental.shard_map import shard_map


def _shard_onehot():
    """Boolean [n_shards] mask selecting this shard's slot (axis size is
    static inside shard_map: psum of a python literal)."""
    size = jax.lax.psum(1, DATA_AXIS)
    shard = jax.lax.axis_index(DATA_AXIS)
    return jax.lax.broadcasted_iota(jnp.int32, (int(size),), 0) == shard


def _globalize_counts(n):
    """Shared collective tail of every scan body: returns
    ``(counts [n_shards] replicated, gstats [2] replicated)`` where
    ``gstats = [psum(n) global matches, pmax(n) worst occupancy]``.

    The per-shard counts vector is built as a psum of slot-masked
    contributions (an all_gather whose replication the shard_map vma
    checker can statically verify)."""
    counts = jax.lax.psum(
        jnp.where(_shard_onehot(), n, 0), DATA_AXIS
    )
    n_tot = jax.lax.psum(n, DATA_AXIS)
    n_max = jax.lax.pmax(n, DATA_AXIS)
    return counts, jnp.stack([n_tot, n_max])


def _maybe_collect(buf, collect: bool):
    """Either keep a per-shard buffer sharded ([1, cap] local -> [n_shards,
    cap] global) or gather it replicated so every *process* of a multi-host
    mesh holds (and can address) the full set.  The gather is a psum of
    slot-masked contributions — statically replicated for the vma checker."""
    if collect:
        oh = _shard_onehot().reshape((-1,) + (1,) * buf.ndim)
        return jax.lax.psum(
            jnp.where(oh, buf[None], jnp.zeros((), buf.dtype)), DATA_AXIS
        )
    return buf[None]


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "n_classes", "capacity", "collect"),
)
def _sharded_call(
    table_flat,
    byte_class,
    used_bytes,
    chunks,
    init_state,
    lengths,
    emit_from,
    final_start,
    *,
    mesh: Mesh,
    n_classes: int,
    capacity: int,
    collect: bool = False,
):
    data, rep = P(DATA_AXIS), P()
    buf_spec = rep if collect else data

    def local_fn(table, bc, ub, ch, ini, ln, ef, fs):
        idx, sts, n, carry = scan_and_compact(
            table, bc, ub, ch, ini, ln, ef, fs,
            n_classes=n_classes, capacity=capacity,
        )
        shard = jax.lax.axis_index(DATA_AXIS)
        local_cells = ch.shape[0] * ch.shape[1]
        idx = jnp.where(idx < INT32_MAX, idx + shard * local_cells, idx)
        counts, gstats = _globalize_counts(n)
        return (
            _maybe_collect(idx, collect),
            _maybe_collect(sts, collect),
            counts,
            gstats,
            carry,
        )

    fn = shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(rep, rep, rep, data, data, data, data, rep),
        out_specs=(buf_spec, buf_spec, rep, rep, data),
    )
    return fn(
        table_flat, byte_class, used_bytes, chunks, init_state, lengths,
        emit_from, final_start,
    )


def sharded_scan_compact(
    mesh: Mesh,
    dev_arrays: dict,
    chunks,
    init_state,
    lengths,
    emit_from,
    n_classes: int,
    capacity: int,
    collect: bool = False,
) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array, jax.Array]:
    """Run the compacted 1-gram scan over the mesh.

    Returns ``(idx [n_shards, capacity], states [n_shards, capacity],
    counts [n_shards] replicated, gstats [2] replicated = [psum total,
    pmax occupancy], carry [B])`` — ``idx`` entries are *global* flattened
    ``row * L + t`` cell indices, ascending within each shard.  With
    ``collect=True`` the idx/states buffers are all_gathered (replicated,
    addressable on every host of a multi-host mesh).
    """
    return _sharded_call(
        dev_arrays["table_flat"],
        dev_arrays["byte_class"],
        dev_arrays["used_bytes"],
        chunks,
        init_state,
        lengths,
        emit_from,
        dev_arrays["final_start"],
        mesh=mesh,
        n_classes=n_classes,
        capacity=capacity,
        collect=collect,
    )


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "n_classes", "n_dense", "capacity", "collect"),
)
def _sharded_call_compressed(
    dense_flat,
    meta,
    exc_target,
    byte_class,
    used_bytes,
    chunks,
    init_state,
    lengths,
    emit_from,
    dense_final_start,
    final_start,
    *,
    mesh: Mesh,
    n_classes: int,
    n_dense: int,
    capacity: int,
    collect: bool = False,
):
    from ..ops.scan_jax import scan_and_compact_compressed

    data, rep = P(DATA_AXIS), P()
    buf_spec = rep if collect else data

    def local_fn(df, mt, et, bc, ub, ch, ini, ln, ef, dfs, fs):
        idx, sts, n, carry = scan_and_compact_compressed(
            df, mt, et, bc, ub, ch, ini, ln, ef, dfs, fs,
            n_classes=n_classes, n_dense=n_dense, capacity=capacity,
        )
        shard = jax.lax.axis_index(DATA_AXIS)
        local_cells = ch.shape[0] * ch.shape[1]
        idx = jnp.where(idx < INT32_MAX, idx + shard * local_cells, idx)
        counts, gstats = _globalize_counts(n)
        return (
            _maybe_collect(idx, collect),
            _maybe_collect(sts, collect),
            counts,
            gstats,
            carry,
        )

    fn = shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(rep, rep, rep, rep, rep, data, data, data, data, rep, rep),
        out_specs=(buf_spec, buf_spec, rep, rep, data),
    )
    return fn(
        dense_flat, meta, exc_target, byte_class, used_bytes, chunks,
        init_state, lengths, emit_from, dense_final_start, final_start,
    )


def sharded_scan_compact_compressed(
    mesh: Mesh,
    dev_arrays: dict,
    chunks,
    init_state,
    lengths,
    emit_from,
    n_classes: int,
    n_dense: int,
    capacity: int,
    collect: bool = False,
) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array, jax.Array]:
    """Run the compacted compressed-table scan over the mesh (byte-dense
    signature-scale sets whose dense ``[S, C]`` table exceeds HBM budget —
    core/tables.CompressedAutomaton).  Same outputs as
    :func:`sharded_scan_compact`; the dense bank + exception arrays are
    replicated per chip, rows sharded."""
    return _sharded_call_compressed(
        dev_arrays["dense_flat"],
        dev_arrays["meta"],
        dev_arrays["exc_target"],
        dev_arrays["byte_class"],
        dev_arrays["used_bytes"],
        chunks,
        init_state,
        lengths,
        emit_from,
        dev_arrays["dense_final_start"],
        dev_arrays["final_start"],
        mesh=mesh,
        n_classes=n_classes,
        n_dense=n_dense,
        capacity=capacity,
        collect=collect,
    )


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "n_classes", "k", "capacity", "collect"),
)
def _sharded_call_kgram(
    ktable,
    byte_class,
    used_bytes,
    chunks,
    init_state,
    lengths,
    emit_from,
    final_start,
    *,
    mesh: Mesh,
    n_classes: int,
    k: int,
    capacity: int,
    collect: bool = False,
):
    from ..ops.scan_jax import scan_and_compact_kgram

    data, rep = P(DATA_AXIS), P()
    buf_spec = rep if collect else data

    def local_fn(kt, bc, ub, ch, ini, ln, ef, fs):
        idx, prevs, n, carry = scan_and_compact_kgram(
            kt, bc, ub, ch, ini, ln, ef, fs,
            n_classes=n_classes, k=k, capacity=capacity,
        )
        shard = jax.lax.axis_index(DATA_AXIS)
        local_cells = ch.shape[0] * (ch.shape[1] // k)
        idx = jnp.where(idx < INT32_MAX, idx + shard * local_cells, idx)
        counts, gstats = _globalize_counts(n)
        return (
            _maybe_collect(idx, collect),
            _maybe_collect(prevs, collect),
            counts,
            gstats,
            carry,
        )

    fn = shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(rep, rep, rep, data, data, data, data, rep),
        out_specs=(buf_spec, buf_spec, rep, rep, data),
    )
    return fn(
        ktable, byte_class, used_bytes, chunks, init_state, lengths,
        emit_from, final_start,
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "mesh", "n_classes", "q", "offsets", "log2_bits", "salts", "shorts",
        "capacity", "collect",
    ),
)
def _sharded_call_cascade(
    bloom_words,
    byte_class,
    used_bytes,
    chunks,
    lengths,
    emit_from,
    min_long_len,
    *,
    mesh: Mesh,
    n_classes: int,
    q: int,
    offsets,
    log2_bits: int,
    salts,
    shorts,
    capacity: int,
    collect: bool = False,
):
    from ..ops.filter_jax import filter_candidates

    data, rep = P(DATA_AXIS), P()

    def local_fn(bw, bc, ub, ch, ln, ef, mll):
        idx, n = filter_candidates(
            bw, bc, ub, ch, ln, ef, mll,
            n_classes=n_classes, q=q, offsets=offsets, log2_bits=log2_bits,
            salts=salts, shorts=shorts, capacity=capacity,
        )
        shard = jax.lax.axis_index(DATA_AXIS)
        local_cells = ch.shape[0] * ch.shape[1]
        idx = jnp.where(idx < INT32_MAX, idx + shard * local_cells, idx)
        counts, gstats = _globalize_counts(n)
        return _maybe_collect(idx, collect), counts, gstats

    buf_spec = rep if collect else data
    fn = shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(rep, rep, rep, data, data, data, rep),
        out_specs=(buf_spec, rep, rep),
    )
    return fn(
        bloom_words, byte_class, used_bytes, chunks, lengths, emit_from,
        min_long_len,
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "mesh", "q", "stride", "log2_words", "salts", "shorts", "capacity",
        "collect",
    ),
)
def _sharded_call_cascade_sampled(
    words,
    chunks,
    lengths,
    min_long_len,
    *,
    mesh: Mesh,
    q: int,
    stride: int,
    log2_words: int,
    salts,
    shorts,
    capacity: int,
    collect: bool = False,
):
    from ..ops.filter_jax import filter_hits_sampled

    data, rep = P(DATA_AXIS), P()
    buf_spec = rep if collect else data

    def local_fn(w, ch, ln, mll):
        idx, lw, sw, n = filter_hits_sampled(
            w, ch, ln, mll,
            q=q, stride=stride, log2_words=log2_words,
            salts=salts, shorts=shorts, capacity=capacity,
        )
        shard = jax.lax.axis_index(DATA_AXIS)
        # grid cells per shard: rows x ceil(row_len / stride)
        local_cells = ch.shape[0] * (-(-ch.shape[1] // stride))
        idx = jnp.where(idx < INT32_MAX, idx + shard * local_cells, idx)
        counts, gstats = _globalize_counts(n)
        return (
            _maybe_collect(idx, collect),
            _maybe_collect(lw, collect),
            _maybe_collect(sw, collect),
            counts,
            gstats,
        )

    fn = shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(rep, data, data, rep),
        out_specs=(buf_spec, buf_spec, buf_spec, rep, rep),
    )
    return fn(words, chunks, lengths, min_long_len)


@functools.partial(
    jax.jit,
    static_argnames=(
        "mesh", "n_classes", "q", "stride", "log2_words", "salts", "shorts",
        "win_len", "cap_hits", "cap_flagged", "collect",
    ),
)
def _sharded_call_sampled_verified(
    words,
    table_flat,
    byte_class,
    used_bytes,
    chunks,
    lengths,
    min_long_len,
    final_start,
    *,
    mesh: Mesh,
    n_classes: int,
    q: int,
    stride: int,
    log2_words: int,
    salts,
    shorts,
    win_len: int,
    cap_hits: int,
    cap_flagged: int,
    collect: bool = False,
):
    """Sampled filter + device window verification chained inside ONE
    shard_map dispatch — each shard's flagged windows come back as global
    grid-cell ids; everything else stays on its chip.  Per-shard filter-hit
    and flagged-window counts come back replicated (all_gather) together
    with the ``[psum, pmax]`` scalars of each."""
    from ..ops.filter_jax import filter_hits_sampled, verify_windows

    data, rep = P(DATA_AXIS), P()
    buf_spec = rep if collect else data

    def local_fn(w, tf, bc, ub, ch, ln, mll, fs):
        idx, _lw, _sw, n = filter_hits_sampled(
            w, ch, ln, mll,
            q=q, stride=stride, log2_words=log2_words,
            salts=salts, shorts=shorts, capacity=cap_hits,
        )
        cells, nf = verify_windows(
            tf, bc, ub, ch, ln, idx, fs,
            n_classes=n_classes, stride=stride, win_len=win_len,
            capacity=cap_flagged, n_hits=cap_hits,
        )
        shard = jax.lax.axis_index(DATA_AXIS)
        local_cells = ch.shape[0] * (-(-ch.shape[1] // stride))
        cells = jnp.where(
            cells < INT32_MAX, cells + shard * local_cells, cells
        )
        _, gstats_hits = _globalize_counts(n)
        nfs, gstats_flagged = _globalize_counts(nf)
        return (
            _maybe_collect(cells, collect),
            nfs,
            gstats_hits,
            gstats_flagged,
        )

    fn = shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(rep, rep, rep, rep, data, data, rep, rep),
        out_specs=(buf_spec, rep, rep, rep),
    )
    return fn(
        words, table_flat, byte_class, used_bytes, chunks, lengths,
        min_long_len, final_start,
    )


def sharded_sampled_verified(
    mesh: Mesh,
    cascade_model,
    chunks,
    lengths,
    cap_hits: int,
    cap_flagged: int,
    collect: bool = False,
):
    """Mesh wrapper for the chained sampled-filter + window-verify pass.
    Returns ``(cells [n_shards, capB] global grid ids, n_flagged
    [n_shards] replicated, gstats_hits [2], gstats_flagged [2],
    gstats_coarse [2])`` where each gstats is the replicated ``[psum,
    pmax]`` of that stage's counts.  The single-stage take path has no
    per-row slot capacity, so it reports zeroed coarse stats — the
    caller's ``nc <= _cap_coarse`` check must never trip there (mirrors
    ``CascadeModel.scan_hits_sampled``)."""
    plan = cascade_model.plan
    dev = cascade_model.device_arrays
    dd = cascade_model.dense_model.device_arrays
    cells, nfs, gh, gf = _sharded_call_sampled_verified(
        dev["sampled_words"],
        dd["table_flat"],
        dev["byte_class"],
        dev["used_bytes"],
        chunks,
        lengths,
        dev["min_long_len"],
        dd["final_start"],
        mesh=mesh,
        n_classes=cascade_model.auto.n_classes,
        q=plan.q,
        stride=plan.stride,
        log2_words=plan.log2_words,
        salts=plan.sampled_salts,
        shorts=plan.shorts,
        win_len=cascade_model.win_len,
        cap_hits=cap_hits,
        cap_flagged=cap_flagged,
        collect=collect,
    )
    # Take path has no stage-1 slot capacity: report zeroed coarse stats
    # so adaptive_chain's nc <= _cap_coarse check never trips (the hit
    # count can legitimately exceed the 128-clamped coarse cap, which
    # would otherwise retry forever).
    import jax.numpy as _jnp

    return cells, nfs, gh, gf, _jnp.zeros_like(gh)


@functools.partial(
    jax.jit,
    static_argnames=(
        "mesh", "n_classes", "n_dense", "q", "stride", "log2_words",
        "salts", "shorts", "win_len", "cap_hits", "cap_rec", "cap_coarse",
        "prefix_salts", "prefix_log2", "prefix_len", "block_r", "grouped",
        "compressed", "use_k2", "has_words2", "collect",
    ),
)
def _sharded_call_sampled_records(
    words,
    words2,
    prefix_words,
    table_flat,  # dense [S*C] (compressed=False) else dense-bank rows
    meta,
    exc_target,
    byte_class,
    used_bytes,
    chunks,
    lengths,
    emit_from,
    min_long_len,
    dense_final_start,
    final_start,
    *,
    mesh: Mesh,
    n_classes: int,
    n_dense: int,
    q: int,
    stride: int,
    log2_words: int,
    salts,
    shorts,
    win_len: int,
    cap_hits: int,
    cap_rec: int,
    cap_coarse: int,
    prefix_salts=(),
    prefix_log2: int = 0,
    prefix_len: int = 0,
    block_r: int = 1024,
    grouped: bool = False,  # grouped take filter, else the flat take
    compressed: bool = False,
    use_k2: bool = False,  # table_flat holds the packed 2-step table
    has_words2: bool = False,
    collect: bool = False,
):
    """Sampled filter + *match-record* verification chained inside ONE
    shard_map dispatch — the multi-device edition of the serving fast
    path.  Per shard: the filter stage (grouped take, or flat take —
    ``grouped``), then
    ``verify_windows_records[_compressed]`` emitting compacted
    ``(cell, state*32+j)`` records with shard-globalized cell ids.
    Replicated outputs: per-shard record counts (the host's shard-major
    gather offsets) and the ``[psum, pmax]`` stats of hits / records /
    coarse survivors (capacity-retry decisions cost one scalar fetch).

    Unused filter args (e.g. ``words2`` without a second-family bloom,
    ``meta`` on the dense path) are passed as dummy arrays — static flags keep
    them out of the traced computation."""
    from ..ops.filter_jax import (
        filter_hits_sampled,
        filter_hits_sampled_grouped,
        verify_windows_records,
        verify_windows_records2,
        verify_windows_records_compressed,
    )

    data, rep = P(DATA_AXIS), P()
    buf_spec = rep if collect else data

    def local_fn(w, w2, pw, tf, mt, et, bc, ub, ch, ln, ef, mll, dfs, fs):
        if grouped:
            idx, _lw, _sw, n, nc = filter_hits_sampled_grouped(
                w, ch, ln, mll,
                q=q, stride=stride, log2_words=log2_words, salts=salts,
                shorts=shorts, capacity=cap_hits, cap_coarse=cap_coarse,
                prefix_words=pw if prefix_salts else None,
                prefix_salts=prefix_salts, prefix_log2=prefix_log2,
                prefix_len=prefix_len, block_r=block_r,
                words2=w2 if has_words2 else None,
            )
        else:
            idx, _lw, _sw, n = filter_hits_sampled(
                w, ch, ln, mll,
                q=q, stride=stride, log2_words=log2_words, salts=salts,
                shorts=shorts, capacity=cap_hits,
            )
            nc = jnp.zeros_like(n)  # flat path has no slot capacity
        if compressed:
            rec_cell, rec_pack, nr = verify_windows_records_compressed(
                tf, mt, et, bc, ub, ch, ln, ef, idx, dfs, fs,
                n_classes=n_classes, n_dense=n_dense, stride=stride,
                win_len=win_len, capacity=cap_rec, n_hits=cap_hits,
            )
        elif use_k2:
            rec_cell, rec_pack, nr = verify_windows_records2(
                tf, bc, ub, ch, ln, ef, idx, fs,
                n_classes=n_classes, stride=stride, win_len=win_len,
                capacity=cap_rec, n_hits=cap_hits,
            )
        else:
            rec_cell, rec_pack, nr = verify_windows_records(
                tf, bc, ub, ch, ln, ef, idx, fs,
                n_classes=n_classes, stride=stride, win_len=win_len,
                capacity=cap_rec, n_hits=cap_hits,
            )
        shard = jax.lax.axis_index(DATA_AXIS)
        local_cells = ch.shape[0] * (-(-ch.shape[1] // stride))
        rec_cell = jnp.where(
            rec_cell < INT32_MAX, rec_cell + shard * local_cells, rec_cell
        )
        nrs, gstats_rec = _globalize_counts(nr)
        _, gstats_hits = _globalize_counts(n)
        _, gstats_coarse = _globalize_counts(nc)
        return (
            _maybe_collect(rec_cell, collect),
            _maybe_collect(rec_pack, collect),
            nrs,
            gstats_hits,
            gstats_rec,
            gstats_coarse,
        )

    fn = shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(
            rep, rep, rep, rep, rep, rep, rep, rep,
            data, data, data, rep, rep, rep,
        ),
        out_specs=(buf_spec, buf_spec, rep, rep, rep, rep),
    )
    return fn(
        words, words2, prefix_words, table_flat, meta,
        exc_target, byte_class, used_bytes, chunks, lengths, emit_from,
        min_long_len, dense_final_start, final_start,
    )


def sharded_sampled_records(
    mesh: Mesh,
    cascade_model,
    chunks,
    lengths,
    emit_from,
    cap_hits: int,
    cap_rec: int,
    collect: bool = False,
):
    """Mesh wrapper for the chained sampled-filter + record-verify pass —
    the sharded analog of ``CascadeModel.launch_device_records``.
    Returns ``(rec_cell [n_shards, cap_rec] global grid ids, rec_pack
    [n_shards, cap_rec], n_recs [n_shards] replicated, gstats_hits [2],
    gstats_rec [2], gstats_coarse [2])``.  Callers gate on
    ``cascade_model.records_ok``; the filter stage auto-selects exactly
    like the single-device path (grouped take when the cell-alignment
    gate holds, flat take otherwise — the last reports zeroed coarse
    stats)."""
    import jax.numpy as _jnp

    plan = cascade_model.plan
    dev = cascade_model.device_arrays
    dd = cascade_model.dense_model.device_arrays
    dummy = _jnp.zeros((1,), _jnp.int32)
    grouped = cascade_model.grouped_path(chunks.shape[1])
    pw = dev.get("prefix_words")
    w2 = dev.get("sampled_words2")
    compressed = cascade_model._compressed
    use_k2 = (not compressed) and cascade_model.records2_ok
    if compressed:
        tflat = dd["dense_flat"]
    elif use_k2:
        tflat = cascade_model.verify2_table_dev
    else:
        tflat = dd["table_flat"]
    return _sharded_call_sampled_records(
        dev["sampled_words"],
        w2 if w2 is not None else dummy,
        pw if pw is not None else dummy,
        tflat,
        dd["meta"] if compressed else dummy,
        dd["exc_target"] if compressed else dummy,
        dev["byte_class"],
        dev["used_bytes"],
        chunks,
        lengths,
        emit_from,
        dev["min_long_len"],
        dd["dense_final_start"] if compressed else dummy,
        dd["final_start"],
        mesh=mesh,
        n_classes=cascade_model.auto.n_classes,
        n_dense=cascade_model.auto.n_dense if compressed else 0,
        q=plan.q,
        stride=plan.stride,
        log2_words=plan.log2_words,
        salts=plan.sampled_salts,
        shorts=plan.shorts,
        win_len=cascade_model.win_len,
        cap_hits=cap_hits,
        cap_rec=cap_rec,
        cap_coarse=cascade_model._cap_coarse,
        prefix_salts=plan.prefix_salts if pw is not None else (),
        prefix_log2=plan.prefix_log2,
        prefix_len=plan.prefix_len,
        block_r=cascade_model.take_group_block_r(),
        grouped=grouped,
        compressed=compressed,
        use_k2=use_k2,
        has_words2=w2 is not None,
        collect=collect,
    )


def sharded_filter_hits_sampled(
    mesh: Mesh,
    cascade_model,
    chunks,
    lengths,
    capacity: int,
    collect: bool = False,
):
    """Sharded sampled-mode grid-hit filter.  Returns ``(grid_idx
    [n_shards, cap], long_word, short_word, counts [n_shards] replicated,
    gstats [2] replicated)`` with shard-globalized grid indices (host
    expansion: CascadeModel expand_hits)."""
    plan = cascade_model.plan
    dev = cascade_model.device_arrays
    return _sharded_call_cascade_sampled(
        dev["sampled_words"],
        chunks,
        lengths,
        dev["min_long_len"],
        mesh=mesh,
        q=plan.q,
        stride=plan.stride,
        log2_words=plan.log2_words,
        salts=plan.sampled_salts,
        shorts=plan.shorts,
        capacity=capacity,
        collect=collect,
    )


def sharded_filter_candidates(
    mesh: Mesh,
    cascade_model,
    chunks,
    lengths,
    emit_from,
    capacity: int,
    collect: bool = False,
):
    """Sharded (anchored) cascade candidate filter.  Returns
    ``(idx [n_shards, cap], counts [n_shards] replicated, gstats [2]
    replicated)`` with global flattened start indices."""
    plan = cascade_model.plan
    dev = cascade_model.device_arrays
    return _sharded_call_cascade(
        dev["bloom_words"],
        dev["byte_class"],
        dev["used_bytes"],
        chunks,
        lengths,
        emit_from,
        dev["min_long_len"],
        mesh=mesh,
        n_classes=cascade_model.auto.n_classes,
        q=plan.q,
        offsets=plan.offsets,
        log2_bits=plan.log2_bits,
        salts=plan.salts,
        shorts=plan.shorts,
        capacity=capacity,
        collect=collect,
    )


def sharded_scan_compact_kgram(
    mesh: Mesh,
    dev_arrays: dict,
    chunks,
    init_state,
    lengths,
    emit_from,
    n_classes: int,
    k: int,
    capacity: int,
    collect: bool = False,
):
    """Sharded k-gram scan (see models/kgram_dfa.py).  Returns
    ``(cell_idx [n_shards, cap], prev_state [n_shards, cap],
    counts [n_shards] replicated, gstats [2] replicated, carry [B])``
    with global cell indices."""
    return _sharded_call_kgram(
        dev_arrays["ktable"],
        dev_arrays["byte_class"],
        dev_arrays["used_bytes"],
        chunks,
        init_state,
        lengths,
        emit_from,
        dev_arrays["final_start"],
        mesh=mesh,
        n_classes=n_classes,
        k=k,
        capacity=capacity,
        collect=collect,
    )
