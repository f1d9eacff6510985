"""The :class:`Matcher` — the framework's primary user-facing object.

Covers the full lifecycle of the reference's 6-function PHP API
(``src/php_ahocorasick.stub.php:12-37``) in one Pythonic class:

==========================  ==================================================
reference                   here
==========================  ==================================================
``ahocorasick_init``        ``Matcher(patterns)``
``ahocorasick_add_patterns``:meth:`Matcher.add_patterns` (pre-finalize only)
``ahocorasick_finalize``    :meth:`Matcher.finalize` (idempotent; True only
                            on the transition, ``php_ahocorasick.c:845-875``)
``ahocorasick_match``       :meth:`Matcher.match` (auto-finalizes on first
                            use, ``php_ahocorasick.c:707``; per-call state
                            reset — Issue #21 semantics)
``ahocorasick_isValid``     :meth:`Matcher.is_valid`
``ahocorasick_deinit``      :meth:`Matcher.close`
==========================  ==================================================

Match records are dicts with the reference's exact schema and key order
(``php_ahocorasick_match_handler``, ``src/php_ahocorasick.c:542-589``):
``pos`` (exclusive byte end offset), ``key`` (string id) *or* ``keyIdx``
(numeric id) *or* neither, ``aux`` (if provided; shared by reference),
``start_postion`` (sic — the reference's field-name typo is API surface,
``php_ahocorasick.c:578``), ``value`` (the pattern as originally given).

Unlike the reference's PHP glue — which ignores ``ac_trie_add`` statuses and
silently drops duplicate/overlong patterns (unchecked call at
``php_ahocorasick.c:484``) — :meth:`add_patterns` *returns* the per-pattern
statuses while keeping identical match output.
"""

from __future__ import annotations

from typing import Any, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np

from .config import DEFAULT_CONFIG, ScanConfig
from .core import TrieBuilder, compile_trie, empty_automaton
from .core.tables import CompiledAutomaton
from .errors import AddStatus, AhoError, warn
from .models.dense_dfa import DenseDfaModel
from .ops.matches import PackedRows, pack_documents
from .patterns import Pattern, parse_batch
from .utils import next_pow2 as _next_pow2

Haystack = Union[str, bytes, bytearray]

_UNSET = object()


class StateError(AhoError):
    """Operation on a closed/uninitialized matcher, or a lifecycle-order
    violation (reference: PHP warning + ``false``)."""


class DeviceCorpus:
    """Device-resident packed corpus handle.

    The reference's whole scale story is amortizing one automaton over
    many haystacks (``README.md:7-9``); the device-side dual is amortizing
    one *upload* over many scans: :meth:`Matcher.device_corpus` pays
    ``pack_documents`` + the host->device transfer once, and every
    subsequent ``match``/``match_arrays`` call against the handle
    re-scans the resident bytes at engine speed (the path the benchmarks
    previously reached only via the private ``dev_inputs`` argument).

    Create via :meth:`Matcher.device_corpus`; pass anywhere a haystack
    sequence is accepted by :meth:`Matcher.match_many` /
    :meth:`Matcher.match_arrays` / :meth:`Matcher.match_arrays_many`.
    The handle is tied to its matcher's chunking config (not to the
    pattern set — a rebuilt matcher with the same config can reuse it)."""

    def __init__(self, packed: PackedRows, chunks_d, lengths_d,
                 emit_from_d, n_docs: int, total_bytes: int,
                 chunk_len: int, mesh=None):
        self.packed = packed
        self.chunks_d = chunks_d
        self.lengths_d = lengths_d
        self.emit_from_d = emit_from_d
        self.n_docs = n_docs
        self.total_bytes = total_bytes
        self.chunk_len = chunk_len
        #: jax.sharding.Mesh when the resident rows are sharded over a
        #: device mesh (the serving fast path on several devices);
        #: None = single-device residency
        self.mesh = mesh
        self._phase_cache: dict = {}

    @property
    def dev_inputs(self):
        return (self.chunks_d, self.lengths_d, self.emit_from_d)

    def packed_words(self, cascade_model):
        """Lazily-cached int32 word pack of the resident corpus for the
        grouped take path (paid once per corpus instead of once per
        launch).  ``None`` when the plan's cell-aligned gate fails."""
        if cascade_model is None:
            return None
        p = cascade_model.plan
        L = self.chunks_d.shape[1]
        if (
            p.mode != "sampled"
            or not p.stride
            or p.stride % 4
            or L % p.stride
        ):
            return None
        if "wc" not in self._phase_cache:
            from .ops.filter_jax import pack_corpus_words

            self._phase_cache["wc"] = pack_corpus_words(self.chunks_d)
        return self._phase_cache["wc"]

    def dev_inputs_for(self, cascade_model):
        """``dev_inputs`` extended with the cached grouped-path word pack
        (consumed by ``CascadeModel.run_arrays``)."""
        return (
            self.chunks_d, self.lengths_d, self.emit_from_d,
            self.packed_words(cascade_model),
        )

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return (
            f"DeviceCorpus(docs={self.n_docs}, "
            f"bytes={self.total_bytes}, chunk_len={self.chunk_len})"
        )


def _as_bytes(h: Haystack) -> bytes:
    if isinstance(h, str):
        return h.encode("utf-8")
    return bytes(h)


class Matcher:
    """Multi-pattern byte matcher backed by a device-compiled dense DFA."""

    def __init__(
        self,
        patterns: Optional[Sequence[Any]] = None,
        config: ScanConfig = DEFAULT_CONFIG,
    ) -> None:
        self.config = config
        self._trie = self._make_builder(config)
        self._patterns: List[Pattern] = []  # accepted patterns, id = index
        self._statuses: List[AddStatus] = []
        self._auto = None  # CompiledAutomaton | CompressedAutomaton
        self._model = None  # DenseDfaModel | CompressedDfaModel
        self._used_bytes: set = set()  # distinct pattern bytes (for the
        # dense-vs-compressed table-size estimate at finalize)
        self._kmodel = None
        self._cascade = _UNSET
        from .utils.logging import ScanStats

        self.stats = ScanStats()
        self._finalized = False
        self._valid = True
        if patterns is not None:
            self.add_patterns(patterns)

    # ------------------------------------------------------------ build

    @staticmethod
    def _make_builder(config: ScanConfig):
        if config.prefer_native_builder:
            from . import native

            if native.available():
                return native.NativeTrieBuilder(config.max_pattern_length)
        return TrieBuilder(config.max_pattern_length)

    def add_patterns(self, specs: Sequence[Any]) -> List[AddStatus]:
        """Validate and insert a batch of pattern specs.

        The whole batch is validated before any insertion (a failed batch is
        atomic, matching ``php_ahocorasick_process_patterns``,
        ``php_ahocorasick.c:389-489``).  Returns one :class:`AddStatus` per
        spec; non-SUCCESS patterns are absent from the automaton (identical
        observable matching behavior to the reference's silent drop).
        """
        if not self._valid:
            warn("add_patterns on a closed matcher")
            raise StateError("matcher is closed")
        if self._finalized:
            warn("Cannot add patterns to an already finalized automaton")
            raise StateError("automaton already finalized")
        pats = parse_batch(specs)
        if hasattr(self._trie, "add_batch"):
            # native builder: one ctypes crossing for the whole batch
            # (per-pattern calls cost ~4.6 s of marshaling at 1M
            # patterns — round-5 build profile)
            statuses = self._trie.add_batch([p.value for p in pats])
            for p, st in zip(pats, statuses):
                if st == AddStatus.SUCCESS:
                    self._patterns.append(p)
                    self._used_bytes.update(p.value)
        else:
            statuses = []
            for p in pats:
                st = self._trie.add(p.value)
                if st == AddStatus.SUCCESS:
                    self._patterns.append(p)
                    self._used_bytes.update(p.value)
                statuses.append(st)
        self._statuses.extend(statuses)
        return statuses

    def finalize(self) -> bool:
        """Compile the automaton. Idempotent; True only on the transition."""
        if not self._valid:
            warn("finalize on a closed matcher")
            raise StateError("matcher is closed")
        if self._finalized:
            return False
        if not self._patterns:
            self._auto = empty_automaton()
        elif self._use_compressed_table():
            from .core.automaton import compile_trie_compressed
            from .models.compressed_dfa import CompressedDfaModel

            if isinstance(self._trie, TrieBuilder):
                self._auto = compile_trie_compressed(
                    self._trie, [len(p) for p in self._patterns]
                )
            else:  # native builder (signature scale)
                self._auto = self._trie.compile_compressed()
            self._trie.closed = True
            self._model = CompressedDfaModel(self._auto, self.config)
            self._finalized = True
            return True
        elif isinstance(self._trie, TrieBuilder):
            self._auto = compile_trie(
                self._trie,
                [len(p) for p in self._patterns],
                allow_int16=self.config.allow_int16_states,
            )
        else:  # native builder
            self._auto = self._trie.compile(
                allow_int16=self.config.allow_int16_states
            )
        self._trie.closed = True
        self._model = DenseDfaModel(self._auto, self.config)
        self._finalized = True
        return True

    def _use_compressed_table(self) -> bool:
        fmt = self.config.table_format
        if fmt != "auto":
            return fmt == "compressed"
        S = self._trie.n_states
        C = len(self._used_bytes) + 1
        dtype_bytes = 2 if (self.config.allow_int16_states and S <= 32767) else 4
        return S * C * dtype_bytes > self.config.dense_table_max_bytes

    @property
    def table_format(self) -> str:
        """Resolved transition-table layout ("dense" or "compressed")."""
        from .core.tables import CompressedAutomaton

        if not self._finalized:
            self.finalize()
        return (
            "compressed"
            if isinstance(self._auto, CompressedAutomaton)
            else "dense"
        )

    # ------------------------------------------------------------ query

    @property
    def finalized(self) -> bool:
        return self._finalized

    @property
    def n_patterns(self) -> int:
        return len(self._patterns)

    @property
    def automaton(self):
        """The frozen compiled automaton (:class:`CompiledAutomaton`, or
        :class:`~.core.tables.CompressedAutomaton` for byte-dense
        signature-scale sets — see :attr:`table_format`)."""
        if not self._finalized:
            self.finalize()
        assert self._auto is not None
        return self._auto

    @property
    def model(self):
        """The device scan model (DenseDfaModel or CompressedDfaModel)."""
        if not self._finalized:
            self.finalize()
        assert self._model is not None
        return self._model

    def is_valid(self) -> bool:
        return self._valid

    def describe(self) -> str:
        """Human-readable automaton summary (analog of ``ac_trie_display``,
        ``src/multifast/ahocorasick.c:304-307``)."""
        if not self._finalized:
            return f"Matcher(open, {len(self._patterns)} patterns)"
        return self.automaton.describe()

    # ------------------------------------------------------------ match

    def match(
        self,
        haystack: Haystack,
        find_all: bool = True,
        backend: Optional[str] = None,
    ) -> List[dict]:
        """Scan one haystack; returns reference-parity match record dicts.

        Automaton state is reset per call (a pattern split across two
        consecutive ``match`` calls does NOT match — Issue #21 semantics,
        ``php_ahocorasick.c:745`` forcing ``keep=0``; see
        :meth:`stream` for the opposite, joining behavior).

        With ``find_all=False``, returns only the records of the first
        matching end position (the reference aborts the scan via the
        callback return after fully processing that position's match set,
        ``php_ahocorasick.c:588``).
        """
        return self.match_many([haystack], find_all=find_all, backend=backend)[0]

    def match_many(
        self,
        haystacks: Sequence[Haystack],
        find_all: bool = True,
        backend: Optional[str] = None,
    ) -> List[List[dict]]:
        """Scan many haystacks in one batched device launch.  Accepts a
        :class:`DeviceCorpus` handle in place of the haystack sequence."""
        if not self._valid:
            warn("match on a closed matcher")
            raise StateError("matcher is closed")
        if not self._finalized:
            self.finalize()  # auto-finalize parity (php_ahocorasick.c:707)
        if isinstance(haystacks, DeviceCorpus):
            dc = haystacks
            results = [[] for _ in range(dc.n_docs)]
            if self._auto.n_patterns == 0:
                return results
            engine, docs_a, ends_a, pids_a = self._scan_handle_arrays(dc)
            self._emit_records(docs_a, ends_a, pids_a, results)
            self.stats.record(
                engine, "device", dc.total_bytes, int(docs_a.shape[0])
            )
            if not find_all:
                for i, recs in enumerate(results):
                    if recs:
                        first_pos = recs[0]["pos"]
                        results[i] = [
                            r for r in recs if r["pos"] == first_pos
                        ]
            return results
        docs = [_as_bytes(h) for h in haystacks]
        results: List[List[dict]] = [[] for _ in docs]
        if self._auto.n_patterns == 0 or not docs:
            return results

        be = backend or self.config.backend
        total = sum(len(d) for d in docs)
        if be == "host" or (be == "auto" and total <= self.config.host_scan_threshold):
            self._scan_host(docs, results)
            self.stats.record("scalar", "host", total, sum(map(len, results)))
        else:
            # split oversized corpora into multiple launches (documents are
            # independent, so this is exact; bounds device memory and keeps
            # flattened cell indices inside int32)
            limit = self.config.max_launch_bytes
            group: List[int] = []
            group_bytes = 0
            groups: List[List[int]] = []
            for i, d in enumerate(docs):
                if group and group_bytes + len(d) > limit:
                    groups.append(group)
                    group, group_bytes = [], 0
                group.append(i)
                group_bytes += len(d)
            if group:
                groups.append(group)
            engine = "-"
            for g in groups:
                sub_results: List[List[dict]] = [[] for _ in g]
                engine = self._scan_device([docs[i] for i in g], sub_results)
                for i, r in zip(g, sub_results):
                    results[i] = r
            self.stats.record(engine, "device", total, sum(map(len, results)))

        if not find_all:
            for i, recs in enumerate(results):
                if recs:
                    first_pos = recs[0]["pos"]
                    results[i] = [r for r in recs if r["pos"] == first_pos]
        return results

    def device_corpus(
        self, haystacks: Sequence[Haystack], shard: Optional[bool] = None
    ) -> DeviceCorpus:
        """Pack + upload a corpus once, returning a resident
        :class:`DeviceCorpus` accepted by :meth:`match_many`,
        :meth:`match_arrays` and :meth:`match_arrays_many` — the
        steady-state serving loop pays the pack + host->device transfer
        once per corpus instead of once per call (the device-side analog
        of the reference's one-automaton-many-haystacks amortization,
        ``README.md:7-9``).

        ``shard``: place the packed rows over the data mesh
        (``jax.sharding.NamedSharding`` on the row axis) so every scan
        against the handle runs the sharded fast path — one chip's HBM
        holds 1/N of the corpus and the record/verify chain runs per
        shard (parallel/shard_scan.sharded_sampled_records).  Default:
        auto (shard when ``config.auto_shard`` and more than one device
        is visible)."""
        if not self._valid:
            warn("device_corpus on a closed matcher")
            raise StateError("matcher is closed")
        if not self._finalized:
            self.finalize()
        import math

        import jax
        import jax.numpy as jnp

        docs = [_as_bytes(h) for h in haystacks]
        total = sum(map(len, docs))
        if total > self.config.max_launch_bytes:
            raise AhoError(
                f"device corpus of {total} bytes exceeds "
                f"max_launch_bytes={self.config.max_launch_bytes}; "
                "split into multiple handles"
            )
        halo = max(self._auto.max_len - 1, 0)
        n_dev = len(jax.devices())
        use_mesh = (
            shard
            if shard is not None
            else (self.config.auto_shard and n_dev > 1)
        ) and n_dev > 1
        mesh = None
        batch_pad = self.config.batch_pad
        if use_mesh:
            from .parallel.mesh import data_mesh

            mesh = data_mesh()
            batch_pad = math.lcm(batch_pad, int(mesh.devices.size))
        packed = pack_documents(
            docs, self._pack_chunk_len(), halo, batch_pad,
            row_align=self._row_align(),
        )
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            row = NamedSharding(mesh, P("data"))
            put = lambda x: jax.device_put(jnp.asarray(x), row)  # noqa: E731
        else:
            put = jnp.asarray
        return DeviceCorpus(
            packed,
            put(packed.chunks),
            put(packed.lengths),
            put(packed.emit_from),
            len(docs),
            total,
            self.config.chunk_len,
            mesh=mesh,
        )

    def _pack_chunk_len(self) -> int:
        """Chunk row length used for packing: the configured ``chunk_len``
        rounded UP to a multiple of the sampled cascade's stride (when the
        stride is cell-aligned), so interior rows land near the aligned
        length.  Pure padding: chunking is internal, results are
        row-length independent.  The hard ``stride | L`` gate of the
        grouped path is enforced by :meth:`_row_align` (the packed row
        length is what matters, chunk rounding alone cannot guarantee it
        once the halo + row alignment are added)."""
        base = self.config.chunk_len
        cm = self.cascade_model
        if cm is not None and cm.plan.mode == "sampled":
            s = cm.plan.stride
            if s and s % 4 == 0 and base % s:
                return ((base + s - 1) // s) * s
        return base

    def _row_align(self) -> int:
        """Row-length alignment for ``pack_documents``: ``lcm(stride,
        128)`` when the sampled cascade's cell-aligned fast paths apply,
        so the packed ``L`` always satisfies their ``stride | L`` gate
        regardless of halo or document lengths."""
        import math

        cm = self.cascade_model
        if cm is not None and cm.plan.mode == "sampled":
            s = cm.plan.stride
            if s and s % 4 == 0:
                return math.lcm(s, 128)
        return 128

    def _scan_handle_arrays(self, dc: DeviceCorpus):
        """Engine dispatch over a resident corpus handle (single-device
        residency here; mesh-sharded handles route to the sharded
        chains on their resident arrays)."""
        from .ops.matches import (
            expand_matches_arrays,
            expand_matches_kgram_arrays,
        )

        engine = self._pick_engine(dc.total_bytes)
        capacity = self.config.match_capacity
        packed = dc.packed
        if dc.mesh is not None:
            if engine == "cascade" and self.cascade_model is not None:
                arrays = self._run_sharded_cascade(
                    packed, capacity, dev=dc.dev_inputs
                )
                return ("cascade",) + tuple(arrays)
            sharded_engine = (
                "compressed"
                if engine == "dfa" and self.table_format == "compressed"
                else engine
            )
            if engine == "kgram":
                k = self.kgram_model.k
                cells_np, prevs_np, n = self._run_sharded(
                    packed, capacity, engine="kgram", dev=dc.dev_inputs
                )
                arrays = expand_matches_kgram_arrays(
                    self._auto, packed, k, cells_np, prevs_np, n
                )
            else:
                idx_np, sts_np, n = self._run_sharded(
                    packed, capacity, engine=sharded_engine,
                    dev=dc.dev_inputs,
                )
                arrays = expand_matches_arrays(
                    self._auto, packed, idx_np, sts_np, n
                )
            return (engine,) + tuple(arrays)
        if engine == "cascade":
            arrays = self.cascade_model.run_arrays(
                packed, capacity,
                dev_inputs=dc.dev_inputs_for(self.cascade_model),
            )
            return ("cascade",) + tuple(arrays)
        if engine == "kgram":
            k = self.kgram_model.k
            while True:
                cells, prevs, n, _ = self.kgram_model.scan_compact_device(
                    dc.chunks_d, dc.lengths_d, dc.emit_from_d, None,
                    capacity,
                )
                n = int(n)
                if n <= capacity:
                    break
                capacity = _next_pow2(n)
            arrays = expand_matches_kgram_arrays(
                self._auto, packed, k, np.asarray(cells),
                np.asarray(prevs), n,
            )
            return ("kgram",) + tuple(arrays)
        while True:
            idx, sts, n, _ = self._model.scan_compact_device(
                dc.chunks_d, dc.lengths_d, dc.emit_from_d, None, capacity
            )
            n = int(n)
            if n <= capacity:
                break
            capacity = _next_pow2(n)
        arrays = expand_matches_arrays(
            self._auto, packed, np.asarray(idx), np.asarray(sts), n
        )
        return (engine,) + tuple(arrays)

    def match_arrays_many(
        self,
        handles: Sequence[DeviceCorpus],
        find_all: bool = True,
    ) -> List[dict]:
        """Pipelined columnar scan of several resident corpora: all
        device chains are dispatched back-to-back with NO host fetch in
        between and every occupancy scalar comes back in one trailing
        fetch — the public steady-state serving loop.  Falls back to
        sequential :meth:`match_arrays` when the cascade record path is
        unavailable.  Returns one :meth:`match_arrays`-style dict per
        handle."""
        if not self._valid:
            warn("match on a closed matcher")
            raise StateError("matcher is closed")
        if not self._finalized:
            self.finalize()
        import jax.numpy as jnp

        cm = self.cascade_model
        if handles and (
            cm is None
            or cm.plan.mode != "sampled"
            or not cm.records_ok
        ):
            # the fallback is exact but must not be silent — long-pattern sets (win_len > 31) and non-sampled
            # plans serve at sequential speed
            reason = (
                "no cascade plan" if cm is None
                else f"plan mode {cm.plan.mode!r}" if cm.plan.mode != "sampled"
                else f"records gate: win_len={cm.win_len} (> 31) or "
                     f"states={self._auto.n_states} (>= 2^26) or no "
                     "device verify"
            )
            self.stats.record_records_fallback(reason)
            return [self.match_arrays(h, find_all) for h in handles]
        if handles and not all(
            self._pick_engine(h.total_bytes) == "cascade" for h in handles
        ):
            self.stats.record_records_fallback(
                "engine auto-selection routed a handle off the cascade"
            )
            return [self.match_arrays(h, find_all) for h in handles]
        if not handles:
            return []
        if all(h.mesh is not None for h in handles):
            return self._records_batch_sharded(handles, cm, find_all)
        if any(h.mesh is not None for h in handles):
            # mixed residency: serve each handle on its own fast path
            return [self.match_arrays(h, find_all) for h in handles]
        return self._records_batch_finish(
            *self._records_batch_dispatch(handles, cm), find_all
        )

    def _match_arrays_fresh_pipelined(self, docs, find_all):
        """Cold-corpus double buffering: slice a fresh
        document list into ``fresh_slice_bytes`` pieces and drive them
        through :meth:`match_arrays_stream`, so slice ``k+1``'s host
        packing + host->device upload overlap slice ``k``'s device scan
        (and slice ``k-1``'s host emission).  A one-shot ``match_arrays``
        over a fresh corpus previously packed + uploaded + scanned
        strictly serially.  Returns the merged columnar dict, or None
        when the pipeline does not apply (small input, no records-path
        plan, or a multi-device mesh — those keep the grouped path)."""
        import jax

        cm = self.cascade_model
        slice_bytes = min(
            self.config.fresh_slice_bytes,
            self.config.max_launch_bytes // 2,
        )
        total = sum(map(len, docs))
        if (
            cm is None
            or cm.plan.mode != "sampled"
            or not cm.records_ok
            or len(docs) < 2
            or total < 2 * slice_bytes
            or max(map(len, docs)) > slice_bytes
            or (self.config.auto_shard and len(jax.devices()) > 1)
            or self._pick_engine(total) != "cascade"
        ):
            return None

        slices: List[Tuple[int, int]] = []  # (doc_lo, doc_hi)
        lo = 0
        size = 0
        for i, d in enumerate(docs):
            if size and size + len(d) > slice_bytes:
                slices.append((lo, i))
                lo, size = i, 0
            size += len(d)
        slices.append((lo, len(docs)))

        def batches():
            for s_lo, s_hi in slices:
                # pack + device_put run here — i.e. while the PREVIOUS
                # slice's chains execute on device (enqueued async)
                yield [self.device_corpus(docs[s_lo:s_hi])]

        docs_l, ends_l, pids_l = [], [], []
        for (s_lo, _), res in zip(
            slices, self.match_arrays_stream(batches(), find_all)
        ):
            r = res[0]
            docs_l.append(r["doc"] + s_lo)  # globalize doc indices
            ends_l.append(r["pos"])
            pids_l.append(r["pattern"])
        docs_a = np.concatenate(docs_l)
        ends_a = np.concatenate(ends_l)
        pids_a = np.concatenate(pids_l)
        starts_a = ends_a - self._auto.pat_lens[pids_a]
        # bytes/matches were already counted per slice by _arrays_result;
        # only mark which path served the call (a second record here
        # would double-count the whole corpus)
        self.stats.last_engine = "cascade-fresh"
        return {
            "doc": docs_a,
            "pos": ends_a,
            "start_postion": starts_a,  # sic: reference API typo
            "pattern": pids_a,
        }

    def _records_batch_dispatch(self, handles, cm):
        """Enqueue the speculative records chains for a batch — device
        work only, NO host fetch (so a later batch can be dispatched
        before this one's records are expanded)."""
        cap_a = max(cm._cap_hits, 256)
        cap_r = max(cm._cap_flagged, 256)
        outs = [
            cm.launch_device_records(
                h.chunks_d, h.lengths_d, h.emit_from_d, cap_a, cap_r,
                wc=h.packed_words(cm),
            )
            for h in handles
        ]
        return handles, cm, outs, cap_a, cap_r

    def match_arrays_stream(self, handle_batches, find_all: bool = True):
        """Generator over batches of resident handles: yields one
        :meth:`match_arrays_many`-style result list per batch, with
        batch ``k+1``'s device chains dispatched BEFORE batch ``k``'s
        records are expanded on the host — the device computes the next
        batch while the host emits the previous one.  Exactness and per-batch results are
        identical to calling :meth:`match_arrays_many` per batch."""
        if not self._valid:
            warn("match on a closed matcher")
            raise StateError("matcher is closed")
        if not self._finalized:
            self.finalize()
        cm = self.cascade_model
        prev = None
        for batch in handle_batches:
            batch = list(batch)
            fast = (
                batch
                and cm is not None
                and cm.plan.mode == "sampled"
                and cm.records_ok
                and all(h.mesh is None for h in batch)
                and all(
                    self._pick_engine(h.total_bytes) == "cascade"
                    for h in batch
                )
            )
            if not fast:
                if prev is not None:
                    yield self._records_batch_finish(*prev, find_all)
                    prev = None
                yield self.match_arrays_many(batch, find_all)
                continue
            cur = self._records_batch_dispatch(batch, cm)
            if prev is not None:
                yield self._records_batch_finish(*prev, find_all)
            prev = cur
        if prev is not None:
            yield self._records_batch_finish(*prev, find_all)

    def _records_batch_finish(self, handles, cm, outs, cap_a, cap_r,
                              find_all):
        import jax.numpy as jnp

        flat = np.asarray(
            jnp.stack([s for o in outs for s in o[2:5]])
        ).reshape(len(outs), 3)
        # ONE concatenated prefix fetch for every in-capacity handle's
        # records: a single device concat instead of one synchronizing
        # np.asarray per handle
        counts = [
            (int(n), int(nr), int(nc)) for (n, nr, nc) in flat
        ]
        pieces = []
        for (rc, rp, _, _, _), (n, nr, nc) in zip(outs, counts):
            if (
                n <= cap_a and nr <= cap_r and nc <= cm._cap_coarse
                and nr > 0
            ):
                pieces.append(rc[:nr])
                pieces.append(rp[:nr])
        rec_flat = (
            np.asarray(jnp.concatenate(pieces)) if pieces else None
        )
        off = 0
        results = []
        for h, (rc, rp, _, _, _), (n, nr, nc) in zip(handles, outs, counts):
            if n > cap_a or nr > cap_r or nc > cm._cap_coarse:
                # overflow: this handle re-runs through the adaptive path
                arrays = cm.run_arrays(
                    h.packed, self.config.match_capacity,
                    dev_inputs=h.dev_inputs_for(cm),
                )
            elif nr == 0:
                z = np.zeros(0, np.int64)
                arrays = (z, z, z)
            else:
                rc_np = rec_flat[off : off + nr]
                rp_np = rec_flat[off + nr : off + 2 * nr]
                off += 2 * nr
                arrays = cm.emit_records_arrays(h.packed, rc_np, rp_np, nr)
            results.append(
                self._arrays_result(h, *arrays, find_all=find_all)
            )
        return results

    def _records_batch_sharded(self, handles, cm, find_all):
        """Pipelined records batch over mesh-sharded handles: all shard
        chains dispatch back-to-back, ONE replicated stats fetch decides
        per-handle retries, and every in-capacity handle's per-shard
        record slices come back in ONE concatenated fetch (the sharded
        twin of the single-device batch below)."""
        import jax
        import jax.numpy as jnp

        from .parallel.shard_scan import sharded_sampled_records

        collect = jax.process_count() > 1
        cm.rescale_caps_per_shard(int(handles[0].mesh.devices.size))
        cap_a = max(cm._cap_hits, 256)
        cap_r = max(cm._cap_flagged, 256)
        outs = [
            sharded_sampled_records(
                h.mesh, cm, h.chunks_d, h.lengths_d, h.emit_from_d,
                cap_a, cap_r, collect=collect,
            )
            for h in handles
        ]
        stats = np.asarray(
            jnp.stack([
                jnp.concatenate(
                    [jnp.stack([gh, gr, gc]).reshape(-1), nrs]
                )
                for (_, _, nrs, gh, gr, gc) in outs
            ])
        )
        meta = []
        groups = []
        for (rc, rp, *_), st in zip(outs, stats):
            ok = (
                int(st[1]) <= cap_a
                and int(st[3]) <= cap_r
                and int(st[5]) <= cm._cap_coarse
            )
            if ok:
                groups.append((rc, rp, [int(x) for x in st[6:]]))
            meta.append(ok)
        gathered = iter(self._gather_shard_records(groups))
        results = []
        for h, ok in zip(handles, meta):
            if not ok:
                arrays = self._sharded_records_arrays(
                    h.mesh, cm, h.packed, h.chunks_d, h.lengths_d,
                    h.emit_from_d, collect,
                )
            else:
                cells, packs, total = next(gathered)
                if total == 0:
                    z = np.zeros(0, np.int64)
                    arrays = (z, z, z)
                else:
                    arrays = cm.emit_records_arrays(
                        h.packed, cells, packs, total
                    )
            results.append(
                self._arrays_result(h, *arrays, find_all=find_all)
            )
        return results

    def _arrays_result(self, dc, docs_a, ends_a, pids_a, find_all) -> dict:
        if not find_all and docs_a.shape[0]:
            _, first_idx = np.unique(docs_a, return_index=True)
            first_pos = np.full(int(docs_a.max()) + 1, -1, dtype=np.int64)
            first_pos[docs_a[first_idx]] = ends_a[first_idx]
            keep = ends_a == first_pos[docs_a]
            docs_a, ends_a, pids_a = (
                docs_a[keep], ends_a[keep], pids_a[keep]
            )
        starts_a = ends_a - self._auto.pat_lens[pids_a]
        self.stats.record(
            "arrays", "device", dc.total_bytes, int(docs_a.shape[0])
        )
        return {
            "doc": docs_a,
            "pos": ends_a,
            "start_postion": starts_a,  # sic: reference API typo
            "pattern": pids_a,
        }

    def match_arrays(
        self,
        haystacks: Union[Sequence[Haystack], DeviceCorpus],
        find_all: bool = True,
    ) -> dict:
        """Columnar scan output for serving pipelines: returns
        ``{"doc": int64 [N], "pos": int64 [N], "start_postion": int64 [N],
        "pattern": int64 [N]}`` in reference emission order, with no
        per-record Python object construction (the high-volume
        analog of :meth:`match_many`'s reference-schema dicts;
        ``pattern`` indexes the accepted-pattern list = the order
        ``add_patterns`` accepted them).

        Accepts a :class:`DeviceCorpus` handle in place of the haystack
        sequence — the resident corpus is re-scanned with no packing or
        transfer cost."""
        if not self._valid:
            warn("match on a closed matcher")
            raise StateError("matcher is closed")
        if not self._finalized:
            self.finalize()
        if isinstance(haystacks, DeviceCorpus):
            dc = haystacks
            if self._auto.n_patterns == 0:
                z = np.zeros(0, np.int64)
                return self._arrays_result(dc, z, z, z, find_all)
            _, docs_a, ends_a, pids_a = self._scan_handle_arrays(dc)
            return self._arrays_result(
                dc, docs_a, ends_a, pids_a, find_all
            )
        docs = [_as_bytes(h) for h in haystacks]
        fresh = self._match_arrays_fresh_pipelined(docs, find_all)
        if fresh is not None:
            return fresh
        parts: List[tuple] = []
        if self._auto.n_patterns > 0 and docs:
            limit = self.config.max_launch_bytes
            group: List[int] = []
            group_bytes = 0
            for i, d in enumerate(docs):
                if group and group_bytes + len(d) > limit:
                    parts.append(self._group_arrays(docs, group))
                    group, group_bytes = [], 0
                group.append(i)
                group_bytes += len(d)
            if group:
                parts.append(self._group_arrays(docs, group))
        if parts:
            docs_a = np.concatenate([p[0] for p in parts])
            ends_a = np.concatenate([p[1] for p in parts])
            pids_a = np.concatenate([p[2] for p in parts])
        else:
            docs_a = ends_a = pids_a = np.zeros(0, np.int64)
        if not find_all and docs_a.shape[0]:
            # keep only each doc's first end-position group (vectorized
            # analog of the reference's callback-return abort)
            first_i = np.zeros(docs_a.shape[0], dtype=bool)
            _, first_idx = np.unique(docs_a, return_index=True)
            first_pos = np.full(int(docs_a.max()) + 1, -1, dtype=np.int64)
            first_pos[docs_a[first_idx]] = ends_a[first_idx]
            keep = ends_a == first_pos[docs_a]
            docs_a, ends_a, pids_a = docs_a[keep], ends_a[keep], pids_a[keep]
        starts_a = ends_a - self._auto.pat_lens[pids_a]
        self.stats.record(
            "arrays", "device", sum(map(len, docs)), int(docs_a.shape[0])
        )
        return {
            "doc": docs_a,
            "pos": ends_a,
            "start_postion": starts_a,  # sic: reference API typo
            "pattern": pids_a,
        }

    def _group_arrays(self, docs: List[bytes], group: List[int]):
        """One launch group -> (global_doc_ids, ends, pids)."""
        sub = [docs[i] for i in group]
        total = sum(map(len, sub))
        # backend="host" forces the host path at ANY size (same contract as
        # match_many); "auto" routes small groups to the host scalar scan
        if self.config.backend == "host" or (
            self.config.backend == "auto"
            and total <= self.config.host_scan_threshold
        ):
            from .ops.matches import csr_expand

            auto = self._auto
            dparts, eparts, pparts = [], [], []
            for gi, d in zip(group, sub):
                if not d:
                    continue
                positions, states, _ = self._scan_host_one(d)
                rec_of, pids = csr_expand(auto, states.astype(np.int64))
                dparts.append(np.full(pids.shape[0], gi, np.int64))
                eparts.append(positions.astype(np.int64)[rec_of] + 1)
                pparts.append(pids)
            if not dparts:
                z = np.zeros(0, np.int64)
                return z, z, z
            return (
                np.concatenate(dparts),
                np.concatenate(eparts),
                np.concatenate(pparts),
            )
        _, docs_a, ends_a, pids_a = self._scan_device_arrays(sub)
        gmap = np.asarray(group, dtype=np.int64)
        return gmap[docs_a], ends_a, pids_a

    def _scan_host_one(self, doc: bytes):
        from . import native
        from .core.tables import CompressedAutomaton

        if not isinstance(self._auto, CompressedAutomaton) and native.available():
            return native.oracle_scan(self._auto, doc)
        data = np.frombuffer(doc, dtype=np.uint8)
        return self._model.scan_host(data)

    # ------------------------------------------------------------ streaming

    def stream(self):
        """Open a :class:`~php_aho_corasick_tpu.stream.StreamScanner` — the
        ``keep=1`` chunk-continuation mode (``ahocorasick.c:191-194``):
        matches spanning feed boundaries ARE found, positions are global
        stream offsets."""
        from .stream import StreamScanner

        if not self._valid:
            warn("stream on a closed matcher")
            raise StateError("matcher is closed")
        return StreamScanner(self)

    # ------------------------------------------------------------ replace

    def replace(self, text, replacements, mode: str = "normal"):
        """One-shot search-and-replace (NORMAL/LAZY nominee semantics of the
        reference's MultiFast replace engine; see replace.py)."""
        from . import replace as _replace

        if not self._valid:
            warn("replace on a closed matcher")
            raise StateError("matcher is closed")
        return _replace.replace(self, text, replacements, mode)

    def replace_stream(self, replacements, mode: str = "normal"):
        """Streaming replace over chunked input; returns a
        :class:`~php_aho_corasick_tpu.replace.ReplaceStream`."""
        from .replace import ReplaceStream

        if not self._valid:
            warn("replace_stream on a closed matcher")
            raise StateError("matcher is closed")
        return ReplaceStream(self, replacements, mode)

    def warmup(self, doc_bytes: int = 0, n_docs: int = 1) -> None:
        """Pre-compile the device kernels for a given workload shape
        (first compiles take seconds; serving deployments call
        this once at startup)."""
        if doc_bytes <= 0:
            doc_bytes = self.config.chunk_len
        dummy = [b"\xff" * doc_bytes] * n_docs
        self.match_many(dummy, backend="device")

    def iter_matches(
        self,
        haystack: Haystack,
        find_all: bool = True,
        segment_bytes: int = 1 << 20,
    ) -> Iterator[dict]:
        """Pull-style match iterator — the reference's
        ``ac_trie_settext``/``ac_trie_findnext`` mode
        (``src/multifast/ahocorasick.c:253-281``, unused by its own PHP
        layer).  Incremental: the haystack is consumed one ``segment_bytes``
        slice at a time through the streaming DFA-state carry
        (:meth:`stream`), so segment ``k+1`` is never scanned until the
        consumer exhausts segment ``k``'s matches — a consumer that stops
        early (the ``findnext`` loop's break) pays only for the bytes
        scanned so far.  Record schema and order match :meth:`match`.

        With ``find_all=False``, yields only the first end-position's match
        group, then stops scanning (the callback-return abort,
        ``php_ahocorasick.c:588``)."""
        # validity check at CALL time (not first iteration): match()/stream()
        # raise immediately on a closed matcher, so this must too — hence the
        # non-generator wrapper returning an inner generator
        if not self._valid:
            warn("match on a closed matcher")
            raise StateError("matcher is closed")
        data = _as_bytes(haystack)
        seg = max(1, int(segment_bytes))

        def gen() -> Iterator[dict]:
            with self.stream() as st:
                for off in range(0, len(data), seg):
                    recs = st.feed(data[off : off + seg])
                    if not find_all and recs:
                        first_pos = recs[0]["pos"]
                        for r in recs:
                            if r["pos"] == first_pos:
                                yield r
                        return
                    yield from recs

        return gen()

    # ------------------------------------------------------------ teardown

    def close(self) -> bool:
        """Invalidate the matcher (``ahocorasick_deinit`` analog: finalizes
        first, then invalidates; second call returns False —
        ``php_ahocorasick.c:754-791``)."""
        if not self._valid:
            return False
        if not self._finalized:
            self.finalize()
        self._valid = False
        return True

    def __enter__(self) -> "Matcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------ internals

    def _format(self, pid: int, pos: int) -> dict:
        p = self._patterns[pid]
        rec: dict = {"pos": pos}
        if p.key is not None:
            rec["key"] = p.key
        elif p.ident is not None:
            rec["keyIdx"] = p.ident
        if p.has_aux:
            rec["aux"] = p.aux
        rec["start_postion"] = pos - len(p.value)  # sic: reference API typo
        rec["value"] = p.value_orig
        return rec

    def _scan_host(self, docs: List[bytes], results: List[List[dict]]) -> None:
        auto = self._auto
        for d, doc in enumerate(docs):
            if not doc:
                continue
            # C++ scalar scan when built (~100x the python loop)
            positions, states, _ = self._scan_host_one(doc)
            out = results[d]
            for t, s in zip(positions, states):
                lo, hi = auto.emit_start[s], auto.emit_start[s + 1]
                for pid in auto.emit_pats[lo:hi]:
                    out.append(self._format(int(pid), int(t) + 1))

    @property
    def kgram_model(self):
        """Lazily-built k-gram device model (models/kgram_dfa.py)."""
        if self._kmodel is None:
            if self.table_format == "compressed":
                raise AhoError(
                    "k-gram engine requires the dense table format"
                )
            from .models.kgram_dfa import KgramDfaModel

            self._kmodel = KgramDfaModel(self.automaton, self.config)
        return self._kmodel

    @property
    def cascade_model(self):
        """Lazily-planned cascade filter model (models/cascade.py);
        ``None`` when the pattern set is ineligible.  Works on both table
        formats — with table_format="compressed" the window verifier is
        the 3-gather compressed walk (verify_windows_compressed), which
        is what lets the fast engine run at byte-dense signature scale."""
        if self._cascade is _UNSET:
            from .models.cascade import CascadeModel, plan_cascade

            plan = plan_cascade(
                [p.value for p in self._patterns], self.automaton, self.config
            )
            self._cascade = (
                CascadeModel(
                    self.automaton, plan, self.config,
                    dense_model=self.model, stats=self.stats,
                )
                if plan.eligible
                else None
            )
        return self._cascade

    def _pick_engine(self, total_payload: int) -> str:
        cfg = self.config
        if self.table_format == "compressed":
            if cfg.engine == "kgram":
                raise ValueError(
                    f"engine {cfg.engine!r} requires the dense table format"
                )
            if cfg.engine == "cascade":
                if self.cascade_model is None:
                    raise ValueError(
                        "cascade engine forced but pattern set is ineligible"
                    )
                return "cascade"
            if cfg.engine == "auto":
                # the compressed dfa costs 3 gathers/byte; any eligible
                # sampled cascade (1/stride gathers/byte + device window
                # verify through the compressed walk) beats it
                cm = (
                    self.cascade_model
                    if total_payload >= cfg.cascade_min_bytes
                    else None
                )
                if (
                    cm is not None
                    and cm.plan.mode == "sampled"
                    and cm.device_verify_ok
                ):
                    return "cascade"
            return "dfa"  # scan_compact_device dispatches the compressed kernel
        if cfg.engine in ("dfa", "kgram"):
            return cfg.engine
        if cfg.engine == "cascade":
            if self.cascade_model is None:
                raise ValueError(
                    "cascade engine forced but pattern set is ineligible"
                )
            return "cascade"
        # any eligible cascade for large scans (the choice has not been
        # measured per device yet); else k-gram, else the dense walk
        if total_payload >= cfg.cascade_min_bytes and (
            self.cascade_model is not None
        ):
            return "cascade"
        if total_payload >= cfg.kgram_min_bytes and self.kgram_model.k >= 2:
            return "kgram"
        return "dfa"

    def _scan_device(self, docs: List[bytes], results: List[List[dict]]) -> str:
        engine, docs_a, ends_a, pids_a = self._scan_device_arrays(docs)
        self._emit_records(docs_a, ends_a, pids_a, results)
        return engine

    def _scan_device_arrays(self, docs: List[bytes]):
        """Device scan of one launch group; returns ``(engine, doc_ids,
        end_positions, pattern_ids)`` numpy arrays in reference emission
        order — the vectorized core of both :meth:`match_many` (dict
        output) and :meth:`match_arrays` (array output)."""
        import math

        import jax

        from .ops.matches import (
            expand_matches_arrays,
            expand_matches_kgram_arrays,
        )

        auto = self._auto
        halo = max(auto.max_len - 1, 0)
        n_dev = len(jax.devices())
        use_mesh = self.config.auto_shard and n_dev > 1
        batch_pad = (
            math.lcm(self.config.batch_pad, n_dev)
            if use_mesh
            else self.config.batch_pad
        )
        engine = self._pick_engine(sum(len(d) for d in docs))
        packed = pack_documents(
            docs, self._pack_chunk_len(), halo, batch_pad,
            row_align=self._row_align(),
        )
        capacity = self.config.match_capacity

        if engine == "cascade":
            cm = self.cascade_model
            if use_mesh and self.table_format == "dense":
                # (the sharded sampled+verify pass gathers from the dense
                # table; compressed cascades run single-device — rows are
                # independent, so multi-process corpora shard above this)
                arrays = self._run_sharded_cascade(packed, capacity)
            else:
                arrays = cm.run_arrays(packed, capacity)
        elif engine == "kgram":
            k = self.kgram_model.k
            if use_mesh:
                cells_np, prevs_np, n = self._run_sharded(
                    packed, capacity, engine="kgram"
                )
            else:
                while True:
                    cells, prevs, n, _ = (
                        self.kgram_model.scan_compact_device(
                            packed.chunks, packed.lengths, packed.emit_from,
                            None, capacity,
                        )
                    )
                    n = int(n)
                    if n <= capacity:
                        break
                    capacity = _next_pow2(n)
                cells_np = np.asarray(cells)
                prevs_np = np.asarray(prevs)
            arrays = expand_matches_kgram_arrays(
                auto, packed, k, cells_np, prevs_np, n
            )
        else:
            if use_mesh:
                idx_np, sts_np, n = self._run_sharded(
                    packed,
                    capacity,
                    engine=(
                        "compressed"
                        if self.table_format == "compressed"
                        else engine
                    ),
                )
            else:
                while True:
                    idx, sts, n, _ = self._model.scan_compact_device(
                        packed.chunks, packed.lengths, packed.emit_from,
                        None, capacity,
                    )
                    n = int(n)
                    if n <= capacity:
                        break
                    capacity = _next_pow2(n)
                idx_np = np.asarray(idx)
                sts_np = np.asarray(sts)
            arrays = expand_matches_arrays(auto, packed, idx_np, sts_np, n)
        return (engine,) + tuple(arrays)

    def _emit_records(self, docs_a, ends_a, pids_a, results) -> None:
        """Build reference-schema dicts from emission arrays.  Per-pattern
        constant parts (key/keyIdx/aux items, length, original value) are
        cached so the per-record work is one small dict build."""
        protos = self._fmt_protos()
        for i in range(docs_a.shape[0]):
            tail, plen, value = protos[pids_a[i]]
            pos = int(ends_a[i])
            rec = {"pos": pos}
            rec.update(tail)
            rec["start_postion"] = pos - plen
            rec["value"] = value
            results[docs_a[i]].append(rec)

    def _fmt_protos(self):
        if getattr(self, "_protos", None) is None or len(self._protos) != len(
            self._patterns
        ):
            protos = []
            for p in self._patterns:
                tail = {}
                if p.key is not None:
                    tail["key"] = p.key
                elif p.ident is not None:
                    tail["keyIdx"] = p.ident
                if p.has_aux:
                    tail["aux"] = p.aux
                protos.append((tail, len(p.value), p.value_orig))
            self._protos = protos
        return self._protos

    def _run_sharded_cascade(
        self, packed: PackedRows, capacity: int, dev=None
    ):
        """Mesh-sharded cascade: returns ``(docs, ends, pids)`` arrays.

        Sampled plans with record emission run the per-shard records
        chain; device-verify plans the chained filter+window-verify
        pass; other plans fall back to sharded candidate filtering +
        host verification.  ``dev``: already-sharded resident
        ``(chunks, lengths, emit_from)`` (a mesh-sharded DeviceCorpus)
        — skips the device_put."""
        import jax
        import jax.numpy as jnp
        from jax.sharding import NamedSharding, PartitionSpec as P

        from .parallel.mesh import data_mesh
        from .parallel.shard_scan import (
            sharded_filter_candidates,
            sharded_filter_hits_sampled,
            sharded_sampled_records,
            sharded_sampled_verified,
        )

        mesh = data_mesh()
        collect = jax.process_count() > 1
        cm0 = self.cascade_model
        if cm0 is not None:
            # round-3 scaling rule: capacities learned on one chip are
            # global counts; each shard needs only its Poisson share
            cm0.rescale_caps_per_shard(int(mesh.devices.size))
        if dev is not None:
            chunks, lengths, emit_from = dev
        else:
            row = NamedSharding(mesh, P("data"))
            chunks = jax.device_put(jnp.asarray(packed.chunks), row)
            lengths = jax.device_put(jnp.asarray(packed.lengths), row)
            emit_from = jax.device_put(jnp.asarray(packed.emit_from), row)
        cm = self.cascade_model
        if cm.plan.mode == "sampled" and cm.records_ok:
            # multi-device serving fast path: per-shard
            # record emission — host work scales with the match count on
            # every chip, exactly like the single-chip records path
            return self._sharded_records_arrays(
                mesh, cm, packed, chunks, lengths, emit_from, collect
            )
        if cm.plan.mode == "sampled" and cm.device_verify_ok:
            state = {}

            def launch(cap_a, cap_b):
                cells, nfs, gh, gf, gc = sharded_sampled_verified(
                    mesh, cm, chunks, lengths, cap_a, cap_b,
                    collect=collect,
                )
                state["nfs"] = np.asarray(nfs)
                # pmax scalars decide the retry (replicated, one fetch)
                stats = np.asarray(jnp.stack([gh, gf, gc]))
                return cells, int(stats[0, 1]), int(stats[1, 1]), int(
                    stats[2, 1]
                )

            cells, _ = cm.adaptive_chain(launch)
            cells2d = np.asarray(cells)
            nf_np = state["nfs"]
            parts = [
                cells2d[s, : nf_np[s]] for s in range(cells2d.shape[0])
            ]
            merged = (
                np.concatenate(parts) if parts else np.zeros(0, np.int32)
            )
            return cm.emit_windows_arrays(packed, merged, merged.shape[0])
        if cm.plan.mode == "sampled":
            while True:
                idx, lw, sw, counts, gstats = sharded_filter_hits_sampled(
                    mesh, cm, chunks, lengths, capacity, collect=collect
                )
                n_max = int(np.asarray(gstats)[1])  # pmax occupancy
                if n_max <= capacity:
                    break
                capacity = _next_pow2(n_max)
            counts_np = np.asarray(counts)
            idx2d, lw2d, sw2d = map(np.asarray, (idx, lw, sw))
            parts = []
            total = 0
            for s in range(idx2d.shape[0]):
                st, n = cm.expand_hits(
                    idx2d[s], lw2d[s], sw2d[s], int(counts_np[s]),
                    packed.row_len, packed.lengths,
                )
                parts.append(st)
                total += n
            merged = (
                np.concatenate(parts) if parts else np.zeros(0, np.int64)
            )
            return cm.verify_arrays(packed, merged, total)
        while True:
            idx, counts, gstats = sharded_filter_candidates(
                mesh, cm, chunks, lengths, emit_from, capacity,
                collect=collect,
            )
            n_max = int(np.asarray(gstats)[1])
            if n_max <= capacity:
                break
            capacity = _next_pow2(n_max)
        counts_np = np.asarray(counts)
        idx2d = np.asarray(idx)
        parts = [idx2d[s, : counts_np[s]] for s in range(idx2d.shape[0])]
        merged = (
            np.concatenate(parts) if parts else np.zeros(0, np.int32)
        )
        return cm.verify_arrays(packed, merged, int(counts_np.sum()))

    @staticmethod
    def _gather_shard_records(groups):
        """ONE concatenated device->host fetch of per-shard record
        slices for any number of record-buffer groups (handles).
        ``groups``: list of ``(rc [n_shards, cap], rp [n_shards, cap],
        sizes [n_shards])``.  Returns one ``(cells, packs, total)``
        numpy triple per group.  Shared by the single-corpus sharded
        path and the pipelined sharded batch — the interleaved-buffer
        slicing contract lives HERE only."""
        import jax.numpy as jnp

        pieces = []
        for rc, rp, sizes in groups:
            for s, nr in enumerate(sizes):
                if nr:
                    pieces.append(rc[s, :nr])
                    pieces.append(rp[s, :nr])
        buf = np.asarray(jnp.concatenate(pieces)) if pieces else None
        out = []
        off = 0
        z = np.zeros(0, np.int64)
        for rc, rp, sizes in groups:
            total = sum(sizes)
            if total == 0:
                out.append((z, z, 0))
                continue
            cells_l, packs_l = [], []
            for nr in sizes:
                if nr:
                    cells_l.append(buf[off : off + nr])
                    packs_l.append(buf[off + nr : off + 2 * nr])
                    off += 2 * nr
            out.append(
                (np.concatenate(cells_l), np.concatenate(packs_l), total)
            )
        return out

    def _sharded_records_arrays(
        self, mesh, cm, packed, chunks, lengths, emit_from, collect
    ):
        """Adaptive sharded record-verify chain + shard-major record
        merge: the multi-chip twin of ``CascadeModel.run_arrays``'s
        records branch.  One replicated stats fetch decides retries
        (pmax per stage); record buffers are sliced per shard on device
        and fetched in ONE concatenation, so fetched bytes scale with the
        match count."""
        import jax.numpy as jnp

        from .parallel.shard_scan import sharded_sampled_records

        state = {}

        def launch_r(cap_a, cap_r):
            rc, rp, nrs, gh, gr, gc = sharded_sampled_records(
                mesh, cm, chunks, lengths, emit_from, cap_a, cap_r,
                collect=collect,
            )
            flat = np.asarray(
                jnp.concatenate([jnp.stack([gh, gr, gc]).reshape(-1), nrs])
            )
            state["nrs"] = flat[6:]
            return (rc, rp), int(flat[1]), int(flat[3]), int(flat[5])

        (rc, rp), _ = cm.adaptive_chain(launch_r)
        sizes = [int(x) for x in state["nrs"]]
        ((cells, packs, total),) = self._gather_shard_records(
            [(rc, rp, sizes)]
        )
        if total == 0:
            z = np.zeros(0, np.int64)
            return z, z, z
        return cm.emit_records_arrays(packed, cells, packs, total)

    def _run_sharded(
        self, packed: PackedRows, capacity: int, engine: str, dev=None
    ):
        """Mesh-sharded scan with exact capacity-retry (see parallel/).
        ``dev``: already-sharded resident ``(chunks, lengths,
        emit_from)`` — skips the device_put."""
        import jax
        import jax.numpy as jnp
        from jax.sharding import NamedSharding, PartitionSpec as P

        from .ops.matches import merge_shard_buffers
        from .parallel.mesh import data_mesh
        from .parallel.shard_scan import (
            sharded_scan_compact,
            sharded_scan_compact_compressed,
            sharded_scan_compact_kgram,
        )

        mesh = data_mesh()
        row = NamedSharding(mesh, P("data"))
        rep = NamedSharding(mesh, P())
        if dev is not None:
            chunks, lengths, emit_from = dev
        else:
            chunks = jax.device_put(jnp.asarray(packed.chunks), row)
            lengths = jax.device_put(jnp.asarray(packed.lengths), row)
            emit_from = jax.device_put(jnp.asarray(packed.emit_from), row)
        init = jax.device_put(jnp.zeros((packed.batch,), jnp.int32), row)
        auto = self._auto
        # replicated automaton arrays are cached per engine: a resident
        # mesh-sharded DeviceCorpus re-scans many times, and re-uploading
        # the multi-MB table per pass would defeat the handle's
        # no-transfer contract (round-5 review finding)
        cache = getattr(self, "_sharded_dev_cache", None)
        if cache is None:
            cache = self._sharded_dev_cache = {}
        dev = cache.get(engine)
        if dev is None:
            if engine == "kgram":
                host = {
                    "ktable": self.kgram_model.ktable_host,
                    "byte_class": auto.byte_class.astype(np.int32),
                    "used_bytes": auto.used_bytes,
                }
            elif engine == "compressed":
                # replicate the compressed model's device dict (dense
                # bank + exception arrays) across the mesh
                host = {
                    k: np.asarray(v)
                    for k, v in self._model.device_arrays.items()
                }
            else:
                host = {
                    "table_flat": np.ascontiguousarray(
                        auto.table
                    ).reshape(-1),
                    "byte_class": auto.byte_class.astype(np.int32),
                    "used_bytes": auto.used_bytes,
                }
            dev = {
                k: jax.device_put(jnp.asarray(v), rep)
                for k, v in host.items()
            }
            if engine != "compressed":
                dev["final_start"] = jax.device_put(
                    jnp.int32(auto.final_start), rep
                )
            cache[engine] = dev
        collect = jax.process_count() > 1
        while True:
            if engine == "kgram":
                idx, aux, counts, gstats, _ = sharded_scan_compact_kgram(
                    mesh, dev, chunks, init, lengths, emit_from,
                    n_classes=auto.n_classes, k=self.kgram_model.k,
                    capacity=capacity, collect=collect,
                )
            elif engine == "compressed":
                idx, aux, counts, gstats, _ = sharded_scan_compact_compressed(
                    mesh, dev, chunks, init, lengths, emit_from,
                    n_classes=auto.n_classes, n_dense=auto.n_dense,
                    capacity=capacity, collect=collect,
                )
            else:
                idx, aux, counts, gstats, _ = sharded_scan_compact(
                    mesh, dev, chunks, init, lengths, emit_from,
                    n_classes=auto.n_classes, capacity=capacity,
                    collect=collect,
                )
            # retry decision = the replicated pmax scalar (one fetch; the
            # full buffers only cross to the host after it fits)
            n_max = int(np.asarray(gstats)[1])
            if n_max <= capacity:
                break
            capacity = _next_pow2(n_max)
        counts_np = np.asarray(counts)
        return merge_shard_buffers(np.asarray(idx), np.asarray(aux), counts_np)
