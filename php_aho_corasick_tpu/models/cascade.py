"""Gram-filter cascade model — planning and host-side exact verification.

See ops/filter_jax.py for the device kernel.  This module decides when the
cascade applies, builds the per-stage hashed blooms from the pattern set,
and verifies compacted candidate starts exactly with a vectorized trie
walk (goto-only, detected via ``state_depth``).

The start-based paradigm is the "failure-less Aho-Corasick" family
(cf. PFAC, arXiv:1811.10498, PAPERS.md) — here with a vectorized bloom
prefilter in front so only candidate starts pay the walk.

Equivalence argument (vs the DFA scan): every occurrence of every pattern
is found at its own start position — a pattern that is a suffix factor of
another match (the reference's failure-chain emission,
``node_collect_matches``) starts at a later position and is detected
there independently.  Sorting verified (start, pattern) pairs by
``(end, start)`` reproduces the reference's emission order exactly:
ascending end position, and within one end the longest pattern (earliest
start) first (``tests/test1.phpt:99-118``).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..config import ScanConfig
from ..core.tables import CompiledAutomaton
from ..ops.filter_jax import GRAM_BASE, KNUTH
from ..ops.matches import PackedRows
from ..utils import next_pow2 as _next_pow2


def _next_cap(n: int) -> int:
    """Smallest of ``{1, 1.25, 1.5, 1.75} * 2**k`` >= n: capacity sizing
    at quarter-octave granularity.  Device verify/compaction cost is
    capacity-proportional, so pure pow2 rounding wastes up to 2x work
    right after a threshold (66k matches -> 131072 slots; quarter steps
    give 81920).  Each distinct capacity is one extra compile per
    workload scale (persistent-cached)."""
    n = max(int(n), 1)
    p = 1
    while p < n:
        p *= 2
    for frac in (4, 5, 6, 7):
        c = frac * p // 8
        if c >= n:
            return c
    return p


@dataclasses.dataclass
class CascadePlan:
    eligible: bool
    reason: str
    q: int = 0
    offsets: Tuple[int, ...] = ()
    salts: Tuple[int, ...] = ()
    log2_bits: int = 0
    bloom_words: Optional[np.ndarray] = None  # [n_stages, bits/32] int32
    shorts: Tuple[bytes, ...] = ()
    min_long_len: int = 0
    #: own pattern id per state (-1 when the state's string is no pattern)
    own_pat: Optional[np.ndarray] = None
    #: "anchored": per-position multi-stage blooms; "sampled": one
    #: positional-alignment bloom checked every ``stride`` positions
    mode: str = "anchored"
    stride: int = 0
    log2_words: int = 0
    sampled_salts: Tuple[int, ...] = ()
    sampled_words: Optional[np.ndarray] = None  # [2**log2_words] int32
    #: second-code-family positional bloom (signature scale): built when
    #: the entry count makes 32-bit code collisions non-negligible; the
    #: grouped take path probes it with GRAM_BASE2 codes on extracted
    #: slots (ops/filter_jax.GRAM_BASE2 rationale)
    sampled_words2: Optional[np.ndarray] = None  # [2**log2_words] int32
    #: planner's estimated candidate starts per scanned byte (diagnostics)
    est_cand_density: float = 0.0
    #: pattern-prefix bit bloom (stage-2 refinement of the grouped filter):
    #: entries are the rolling hash of each long pattern's first
    #: ``prefix_len`` bytes; a slot whose coarse word names exactly one
    #: alignment is kept only if its window's prefix hash probes positive
    #: — kills true-q-gram-collision strays (ops/filter_jax.py)
    prefix_words: Optional[np.ndarray] = None  # [2**prefix_log2 / 32] int32
    prefix_salts: Tuple[int, ...] = ()
    prefix_log2: int = 0
    prefix_len: int = 0


def _gram_code_u32(classes: Sequence[int], n_classes: int) -> int:
    """Host replica of the device's wrapping base-C code arithmetic."""
    code = 0
    for c in classes:
        code = (code * n_classes + int(c)) & 0xFFFFFFFF
    return code


def _own_pat(auto: CompiledAutomaton) -> np.ndarray:
    """Own-pattern id per final state — table-format agnostic (the
    compressed format has TWO final ranges, see
    CompressedAutomaton.is_final)."""
    own = np.full(auto.n_states, -1, dtype=np.int64)
    finals = np.nonzero(auto.is_final(np.arange(auto.n_states)))[0]
    if finals.size:
        first = auto.emit_pats[auto.emit_start[finals]]
        is_own = auto.pat_lens[first] == auto.state_depth[finals]
        own[finals[is_own]] = first[is_own]
    return own


#: planner cost terms in seconds, measured at the headline shapes (2048 x
#: 16-byte needles over a 128 MiB resident corpus) on an NVIDIA H100 80GB
#: HBM3 with a 400 W power limit; ``chip_smoke.py``'s planner phase
#: re-measures them.  One salted bloom probe (hash + gather) per grid cell:
_GATHER_S = 4.3e-11
#: grid-hit compaction (ops/scan_jax.blocked_nonzero), per grid cell
_COMPACT_S = 2.6e-11
#: device window verify, per window position of one hit-capacity slot
_WINDOW_STEP_S = 3.1e-10
#: device->host fetch + host expand + verify, per grid hit (windows too
#: long for the device verifier)
_HOST_HIT_S = 7.2e-7
#: grid gram-code assembly per corpus byte: cell-aligned word planes
#: (``stride % 4 == 0``) and the general ``[B, M, stride]`` reshape path
_CODES_ALIGNED_S = 1.6e-11
_CODES_GENERAL_S = 3.7e-12
#: hard cap on positional-bloom alignments (bits of an int32 word).
_MAX_STRIDE = 32
#: skip exact gram enumeration above this many (pattern, alignment) entries.
_ENUM_CAP = 64_000_000
#: build the second-code-family bloom once this many (pattern, alignment)
#: entries make 32-bit code collisions non-negligible (n/2^32 per cell)
WORDS2_MIN_ENTRIES = 1 << 20


def _alignment_gram_codes(
    longs: Sequence[bytes], q: int, s: int, base: int = GRAM_BASE
) -> Tuple[np.ndarray, np.ndarray]:
    """``(codes, aligns)`` of every long pattern's q-gram at offsets
    ``[0, s)`` — wrapping uint32 polynomial byte codes, bit-identical to
    the device's int32 arithmetic (ops/filter_jax.py sampled_gram_codes,
    base GRAM_BASE)."""
    by_len: dict = {}
    for p in longs:
        by_len.setdefault(len(p), []).append(p)
    codes: List[np.ndarray] = []
    aligns: List[np.ndarray] = []
    base = np.uint32(base)
    for n, ps in sorted(by_len.items()):
        arr = np.frombuffer(b"".join(ps), np.uint8).reshape(len(ps), n)
        u = arr.astype(np.uint32)
        for j in range(s):  # s <= min_long - q + 1 <= n - q + 1
            c = np.zeros(len(ps), np.uint32)
            for t in range(q):
                c = c * base + u[:, j + t]
            codes.append(c)
            aligns.append(np.full(len(ps), j, np.int32))
    return np.concatenate(codes), np.concatenate(aligns)


def _sampled_cost(
    q: int,
    s: int,
    n_entries: int,
    log2_w: int,
    n_probes: int,
    A: int,
    max_len: int,
) -> Tuple[float, float]:
    """Per-byte cost estimate + per-lookup hit rate of one sampled config
    (cost terms measured on the device, see ``_GATHER_S``)."""
    true_density = min(1.0, n_entries / float(A) ** q)
    # A grid cell strays at alignment j when, in EVERY one of the n_probes
    # salted probe words, bit j was set by some pattern with a gram at
    # offset j hashing to the same slot.  Patterns per offset = n_entries/s,
    # so per-bit fill = (n_entries/s) / W and the cell strays at any of its
    # s alignments: ~ s * fill^n.  (At signature scale an optimistic
    # 1-probe estimate here floods device verify — the second probe pays
    # for itself.)
    fill = (n_entries / float(s)) / float(1 << log2_w)
    stray = s * fill ** n_probes
    hit_rate = min(1.0, 1.1 * true_density + stray)
    win_len = s - 1 + max_len
    if win_len <= 32:
        # device window verify walks every slot of its static capacity
        # H = next_pow2(1.25 * hits), not n_hits — model that padding as
        # an average 1.6x on the hit rate
        verify = _WINDOW_STEP_S * win_len * 1.6 * hit_rate / s
    else:  # host expand + verify of every grid hit
        verify = _HOST_HIT_S * hit_rate / s
    codes = _CODES_ALIGNED_S if s % 4 == 0 else _CODES_GENERAL_S
    cost = _GATHER_S * n_probes / s + _COMPACT_S / s + verify + codes
    return cost, hit_rate


def _plan_prefix_bloom(
    longs: Sequence[bytes], min_long: int, len_cap: int = 16
) -> dict:
    """Build the pattern-prefix bit bloom for stage-2 refinement: one
    entry per distinct ``prefix_len``-byte pattern prefix, hashed by the
    device's rolling polynomial (ops/filter_jax._prefix_hash_select).
    Sized for <= ~1/512 fill per salt; a second salt squares the fill
    when the entry count forces a large table.  Vectorized per length
    group + native scatter (a per-byte Python loop costs seconds at 1M
    patterns)."""
    from .. import native
    from ..ops.filter_jax import GRAM_BASE, KNUTH

    l16 = min(min_long, max(4, min(len_cap, 16)))
    by_len: dict = {}
    for p in longs:
        by_len.setdefault(len(p), []).append(p)
    parts = []
    for n_, ps in sorted(by_len.items()):
        arr = np.frombuffer(b"".join(ps), np.uint8).reshape(len(ps), n_)
        u = arr[:, :l16].astype(np.uint32)
        h = np.zeros(len(ps), np.uint32)
        for j in range(l16):
            h = h * np.uint32(GRAM_BASE) + u[:, j]
        parts.append(h)
    hs = (
        np.unique(np.concatenate(parts))
        if parts
        else np.zeros(0, np.uint32)
    )
    n = max(hs.shape[0], 1)
    if n <= 8192:
        # small sets: size for ~1/16 fill per salt and probe TWO salts
        # (joint 1/256), which keeps the table small
        log2_p = max(int(np.ceil(np.log2(n))) + 4, 14)
        salts = (0x7F4A7C15, 0x94D049BB)
    else:
        log2_p = min(max(int(np.ceil(np.log2(n))) + 9, 14), 26)
        fill = n / (1 << log2_p)
        salts = (0x7F4A7C15, 0x94D049BB)[: (1 if fill <= 1 / 256 else 2)]
    words = np.zeros((1 << log2_p) // 32, dtype=np.uint32)
    for salt in salts:
        hh = (hs ^ np.uint32(salt)) * np.uint32(KNUTH)
        slots = (hh >> np.uint32(32 - log2_p)).astype(np.int64)
        native.scatter_or_bit(words, slots)
    return dict(
        words=words.view(np.int32), salts=salts, log2=log2_p, len=l16
    )


def _plan_sampled(
    longs: Sequence[bytes],
    auto: CompiledAutomaton,
    config: ScanConfig,
    min_long: int,
) -> Optional[dict]:
    """Pick ``(q, stride, log2_words, n_probes)`` for the strided
    positional bloom by a per-byte cost model.  Returns None when no
    sampled configuration is viable (e.g. min_long == q => stride 1, or
    candidate density saturates)."""
    A = max(int(auto.used_bytes.shape[0]), 1)
    n_longs = len(longs)
    max_w = config.cascade_log2_words_max
    max_len = auto.max_len
    best = None
    for q in range(min(16, min_long), config.cascade_min_q - 1, -1):
        s = min(_MAX_STRIDE, min_long - q + 1)
        if s < 2:
            continue
        n_entries = n_longs * s
        base_w = int(np.ceil(np.log2(max(n_entries, 1))))
        for n_probes in (1, 2):
            for log2_w in sorted({
                min(max(base_w + 5, 14), max_w),
                min(max(base_w + 8, 14), max_w),
                min(max(base_w + 10, 14), max_w),
            }):
                cost, hit_rate = _sampled_cost(
                    q, s, n_entries, log2_w, n_probes, A, max_len
                )
                cost += log2_w * 1e-12  # prefer smaller tables on ties
                cand = hit_rate / s
                if cand > config.cascade_max_cand_density:
                    continue
                if best is None or cost < best["cost"]:
                    best = dict(
                        q=q, stride=s, log2_words=log2_w,
                        n_probes=n_probes, cost=cost, cand_per_byte=cand,
                    )
    return best


def plan_cascade(
    patterns: Sequence[bytes],
    auto: CompiledAutomaton,
    config: ScanConfig,
) -> CascadePlan:
    if not patterns:
        return CascadePlan(False, "no patterns")
    longs = [p for p in patterns if len(p) >= config.cascade_min_q]
    shorts = tuple(p for p in patterns if len(p) < config.cascade_min_q)
    if len(shorts) > config.cascade_max_shorts:
        return CascadePlan(
            False, f"{len(shorts)} short patterns (> {config.cascade_max_shorts})"
        )
    log2_bits = config.cascade_log2_bloom_bits
    if not longs:
        return CascadePlan(
            True, "shorts-only", q=0, shorts=shorts, min_long_len=0,
            bloom_words=np.zeros((0, 1), np.int32), own_pat=_own_pat(auto),
        )
    min_long = min(len(p) for p in longs)

    if config.cascade_mode in ("auto", "sampled"):
        choice = _plan_sampled(longs, auto, config, min_long)
        if choice is not None and len(longs) * choice["stride"] <= _ENUM_CAP:
            q, s = choice["q"], choice["stride"]
            log2_w = choice["log2_words"]
            salts = (0x85EBCA6B, 0xC2B2AE35)[: choice["n_probes"]]
            from .. import native

            codes, aligns = _alignment_gram_codes(longs, q, s)
            bits = np.uint32(1) << aligns.astype(np.uint32)
            words = np.zeros(1 << log2_w, dtype=np.uint32)
            for salt in salts:
                h = (codes ^ np.uint32(salt)) * np.uint32(KNUTH)
                widx = (h >> np.uint32(32 - log2_w)).astype(np.int64)
                native.scatter_or(words, widx, bits)
            # exact candidate-density estimate from the built filter
            n_distinct = np.unique(codes).shape[0]
            _, hit_rate = _sampled_cost(
                q, s, n_distinct, log2_w, len(salts),
                max(int(auto.used_bytes.shape[0]), 1), auto.max_len,
            )
            density = hit_rate / s
            if density <= config.cascade_max_cand_density:
                prefix = _plan_prefix_bloom(
                    longs, min_long, config.cascade_prefix_len
                )
                words2 = None
                if codes.shape[0] >= WORDS2_MIN_ENTRIES:
                    # 32-bit code space saturates: ~n/2^32 of random
                    # grams equal a true entry CODE and pass every salt;
                    # a second-family bloom makes that (n/2^32)^2
                    from ..ops.filter_jax import GRAM_BASE2, SALT2

                    codes2, _ = _alignment_gram_codes(
                        longs, q, s, base=GRAM_BASE2
                    )
                    w2 = np.zeros(1 << log2_w, dtype=np.uint32)
                    h2 = (codes2 ^ np.uint32(SALT2)) * np.uint32(KNUTH)
                    widx2 = (h2 >> np.uint32(32 - log2_w)).astype(np.int64)
                    native.scatter_or(w2, widx2, bits)
                    words2 = w2.view(np.int32)
                return CascadePlan(
                    True,
                    f"sampled q={q} stride={s} probes={len(salts)}",
                    q=q,
                    shorts=shorts,
                    min_long_len=min_long,
                    own_pat=_own_pat(auto),
                    mode="sampled",
                    stride=s,
                    log2_words=log2_w,
                    sampled_salts=salts,
                    sampled_words=words.view(np.int32),
                    sampled_words2=words2,
                    est_cand_density=density,
                    prefix_words=prefix["words"],
                    prefix_salts=prefix["salts"],
                    prefix_log2=prefix["log2"],
                    prefix_len=prefix["len"],
                )
        if config.cascade_mode == "sampled":
            return CascadePlan(
                False, "no viable sampled configuration for this pattern set"
            )
    q = min(8, min_long)
    # stage offsets: gram windows fully inside every long pattern
    offs = {0}
    if min_long - q >= 1:
        offs.add(min_long - q)
    if min_long - q >= 2:
        offs.add((min_long - q) // 2)
    offsets = tuple(sorted(offs))
    # bloom fill check: a saturated filter passes everything — not worth it
    if len(longs) > (1 << log2_bits) * config.cascade_max_fill:
        return CascadePlan(
            False,
            f"{len(longs)} long patterns saturate a 2^{log2_bits}-bit bloom",
        )
    bc = auto.byte_class
    C = auto.n_classes
    salts = tuple(0x9E3779B9 * (s + 1) & 0xFFFFFFFF for s in range(len(offsets)))
    words = np.zeros((len(offsets), (1 << log2_bits) // 32), dtype=np.uint32)
    for s, (off, salt) in enumerate(zip(offsets, salts)):
        for p in longs:
            cls = bc[np.frombuffer(p, np.uint8)[off : off + q]]
            code = _gram_code_u32(cls, C)
            h = ((code ^ salt) * KNUTH) & 0xFFFFFFFF
            slot = h >> (32 - log2_bits)
            words[s, slot >> 5] |= np.uint32(1) << np.uint32(slot & 31)
    return CascadePlan(
        True,
        "ok",
        q=q,
        offsets=offsets,
        salts=salts,
        log2_bits=log2_bits,
        bloom_words=words.view(np.int32),
        shorts=shorts,
        min_long_len=min_long,
        own_pat=_own_pat(auto),
    )


class CascadeModel:
    """Device candidate filter + exact verifier (device windows or host)."""

    def __init__(
        self,
        auto: CompiledAutomaton,
        plan: CascadePlan,
        config: ScanConfig,
        dense_model=None,  # DenseDfaModel: shares its device table for
        # the window-verify kernel instead of uploading a second copy
        stats=None,  # utils.logging.ScanStats: capacity-retry counters
    ) -> None:
        assert plan.eligible
        self.auto = auto
        self.plan = plan
        self.config = config
        self.dense_model = dense_model
        self.stats = stats
        self._dev = None
        #: adaptive capacities for the speculative A->B launch chain
        #: (learned from each launch's observed counts; may shrink)
        self._cap_hits = 4096
        self._cap_flagged = 256
        #: slot capacity of the grouped take path's rank extraction: max
        #: stage-A survivors per slot group (a ``take_group_block_r``-cell
        #: block column).  Structurally <= 128.  Seeded from the planner's
        #: stray estimate so the first launch doesn't walk the doubling
        #: ladder (each bump recompiles).
        self._cap_coarse = 8
        self._force_take = False
        lam = None
        if plan.mode == "sampled" and plan.log2_words:
            # grouped take path: stage A probes one salt, so survivors
            # per cell ~ the single-salt stray; the group size is chosen
            # to keep the per-group mean small (take_group_block_r)
            lam = self._take_stray1() * self.take_group_block_r()
        if lam is not None:
            init = int(lam + 6.0 * lam**0.5 + 2)
            self._cap_coarse = max(8, min(128, -(-init // 8) * 8))
        self._cap_coarse_floor = self._cap_coarse

    def _take_stray1(self) -> float:
        """Per-cell single-salt stray estimate of the grouped take path:
        stride alignment bits x the positional bloom's per-bit fill."""
        p = self.plan
        return min(
            1.0,
            p.stride * self.auto.n_patterns / float(1 << p.log2_words),
        )

    def take_group_block_r(self) -> int:
        """Group size of the grouped take path's rank extraction, sized
        so the expected survivors per group stay <= ~8 at the single-
        salt stray (slot arrays and their stage-B probes scale with
        ``mpr x n_groups``; smaller groups trade a finer extraction for
        fewer wasted slots at high stray)."""
        from ..ops.filter_jax import GROUP_BLOCK_R

        p = self.plan
        if p.mode != "sampled" or not p.log2_words:
            return GROUP_BLOCK_R
        br = GROUP_BLOCK_R
        stray1 = self._take_stray1()
        while br > 128 and stray1 * br > 8.0:
            br //= 2
        return br

    def grouped_path(
        self, row_len: int, cap_coarse: Optional[int] = None
    ) -> bool:
        """Whether a launch over rows of ``row_len`` bytes runs the grouped
        take filter (cell-aligned stride, slot capacity within the
        128-slot extraction) rather than the flat take filter."""
        p = self.plan
        cc = cap_coarse or self._cap_coarse
        return (
            not self._force_take  # > 128 survivors/group: flat path only
            and p.stride % 4 == 0
            and row_len % p.stride == 0
            and cc <= 128
        )

    @property
    def learned_caps(self) -> Tuple[int, int]:
        """Adaptive ``(cap_hits, cap_flagged)`` capacities learned from past
        launches — the starting point for a pipelined launch batch (used by
        bench.py and steady-state serving loops)."""
        return max(self._cap_hits, 256), max(self._cap_flagged, 256)

    def seed_caps(
        self, n_hits_est: int, n_flagged_est: int, n_shards: int = 1
    ) -> None:
        """Pre-seed the adaptive capacities from workload knowledge (e.g. a
        known planted-match density) so the first launch on a new corpus
        doesn't walk the doubling ladder — each distinct capacity is a new
        XLA compile shape.  Estimates are GLOBAL; with
        ``n_shards > 1`` each shard gets the mean + Poisson-margin share
        (parallel.shard_scan.per_shard_capacity — the round-3 rule that
        per-shard capacity must SHRINK with the shard count)."""
        from ..parallel.shard_scan import per_shard_capacity

        a = per_shard_capacity(max(n_hits_est, 1), n_shards)
        b = per_shard_capacity(max(n_flagged_est, 1), n_shards)
        self._cap_hits = max(self._cap_hits, _next_cap(a))
        self._cap_flagged = max(self._cap_flagged, _next_cap(b))

    def rescale_caps_per_shard(self, n_shards: int) -> None:
        """One-time rebase of learned capacities when entering a sharded
        run: single-chip learning reflects GLOBAL counts, but each shard
        only sees ~1/n of them (and pays verify work proportional to its
        static capacity).  Subsequent sharded launches re-learn from the
        pmax stats, so this only guides the first."""
        from ..parallel.shard_scan import per_shard_capacity

        if getattr(self, "_caps_sharded_for", None) == n_shards:
            return
        self._caps_sharded_for = n_shards
        self._cap_hits = _next_cap(
            per_shard_capacity(self._cap_hits, n_shards)
        )
        self._cap_flagged = _next_cap(
            per_shard_capacity(self._cap_flagged, n_shards)
        )

    @property
    def win_len(self) -> int:
        """Window length of the device verifier: covers every occurrence
        owned by one grid cell (long starts in ``[p-stride+1, p]``, short
        starts in ``[p, p+stride)``)."""
        return self.plan.stride - 1 + self.auto.max_len

    @property
    def records_ok(self) -> bool:
        """Gate for the device match-record emission path
        (ops/filter_jax.verify_windows_records[_compressed]): needs a
        reserved sentinel ``j`` (win_len <= 31) and states packable next
        to a 5-bit position (states < 2**26)."""
        return (
            self.device_verify_ok
            and self.win_len <= 31
            and self.auto.n_states < (1 << 26)
        )

    @property
    def records2_ok(self) -> bool:
        """Gate for the 2-class super-step record verifier
        (ops/filter_jax.verify_windows_records2): states must fit the
        15-bit packed field and the composed [S, C, C] table must stay
        within ``verify_kgram_bytes``."""
        from ..ops.filter_jax import REC2_BITS

        return (
            self.records_ok
            and not self._compressed
            and self.auto.n_states < (1 << REC2_BITS)
            and self.auto.n_states * self.auto.n_classes ** 2 * 4
            <= self.config.verify_kgram_bytes
        )

    @property
    def verify2_table_dev(self):
        """Lazy device upload of the packed 2-step verify table:
        ``table2[s, c1*C + c2] = s2 | (s1 << 15)`` (one numpy compose,
        paid once per automaton)."""
        if getattr(self, "_verify2_table", None) is None:
            import jax.numpy as jnp

            from ..ops.filter_jax import REC2_BITS

            t = np.ascontiguousarray(self.auto.table, dtype=np.int64)
            S, C = t.shape
            s1 = t  # [S, C]
            s2 = t[s1.reshape(-1), :].reshape(S, C, C)  # [S, c1, c2]
            packed = (s2 | (s1[:, :, None] << REC2_BITS)).astype(np.int32)
            self._verify2_table = jnp.asarray(packed.reshape(-1))
        return self._verify2_table

    @property
    def device_verify_ok(self) -> bool:
        """Device window verification needs the final-step bitmask to fit
        an int32 and a DFA model (dense or compressed) to share the
        transition table."""
        return (
            self.plan.mode == "sampled"
            and self.win_len <= 32
            and self.dense_model is not None
        )

    @property
    def _compressed(self) -> bool:
        from ..core.tables import CompressedAutomaton

        return isinstance(self.auto, CompressedAutomaton)

    @property
    def verify_kv(self) -> int:
        """Super-step width of the window verifier's k-gram walk (1 =
        plain per-class walk).  Picks the largest k whose composed table
        fits :attr:`ScanConfig.verify_kgram_bytes` — each +1 removes a
        dependent gather round from every verify launch."""
        if self._compressed or self.auto.n_classes > 255:
            return 1  # packed-class fetch requires byte-sized classes
        from ..ops.scan_jax import KGRAM_MID_FLAG

        S, C = self.auto.n_states, self.auto.n_classes
        esize = 2 if (S < (1 << 15) and self.config.allow_int16_states) else 4
        if esize == 4 and S >= KGRAM_MID_FLAG:
            return 1
        kv = 1
        for k in (2, 3, 4):
            if (
                S * C**k * esize <= self.config.verify_kgram_bytes
                and S * C**k < 2**31
            ):
                kv = k
        return kv

    @property
    def verify_ktable_dev(self):
        """Lazy device upload of the verify k-gram table (compose is
        host-side numpy/native, paid once per automaton)."""
        if getattr(self, "_verify_ktable", None) is None:
            import jax.numpy as jnp

            from .kgram_dfa import KgramDfaModel

            km = KgramDfaModel(self.auto, self.config, k=self.verify_kv)
            self._verify_ktable = jnp.asarray(km.ktable_host)
        return self._verify_ktable

    @property
    def device_arrays(self):
        if self._dev is None:
            import jax.numpy as jnp

            auto = self.auto
            p = self.plan
            self._dev = {
                "byte_class": jnp.asarray(auto.byte_class.astype(np.int32)),
                "used_bytes": jnp.asarray(auto.used_bytes),
                "min_long_len": jnp.int32(p.min_long_len),
            }
            if p.mode == "sampled":
                self._dev["sampled_words"] = jnp.asarray(p.sampled_words)
                if p.prefix_words is not None:
                    self._dev["prefix_words"] = jnp.asarray(p.prefix_words)
                if p.sampled_words2 is not None:
                    self._dev["sampled_words2"] = jnp.asarray(
                        p.sampled_words2
                    )
            else:
                self._dev["bloom_words"] = jnp.asarray(p.bloom_words)
        return self._dev

    def scan_hits_sampled(
        self, chunks, lengths, capacity: int,
        cap_coarse: Optional[int] = None, wc=None,
    ):
        """One launch of the grid-domain sampled filter.  Returns
        ``(grid_idx, long_word, short_word, n_hits, n_coarse)``.  The
        grouped take path reports ``n_coarse`` = the max survivors per
        extraction group (its ``cap_coarse`` slot capacity must not
        overflow); the flat take path (used when the cell-alignment gate
        fails or after ``_force_take``) has no slot capacity and reports
        ``n_coarse == 0`` so the caller's coarse-capacity check never
        trips."""
        import jax.numpy as jnp

        from ..ops.filter_jax import (
            filter_hits_sampled,
            filter_hits_sampled_grouped,
        )

        dev = self.device_arrays
        p = self.plan
        cc = cap_coarse or self._cap_coarse
        if self.grouped_path(chunks.shape[1], cc):
            # grouped take path: rank-extracted compaction + per-slot
            # prefix refinement
            return filter_hits_sampled_grouped(
                dev["sampled_words"],
                jnp.asarray(chunks),
                jnp.asarray(lengths),
                dev["min_long_len"],
                q=p.q,
                stride=p.stride,
                log2_words=p.log2_words,
                salts=p.sampled_salts,
                shorts=p.shorts,
                capacity=capacity,
                cap_coarse=cc,
                prefix_words=dev.get("prefix_words"),
                prefix_salts=p.prefix_salts,
                prefix_log2=p.prefix_log2,
                prefix_len=p.prefix_len,
                block_r=self.take_group_block_r(),
                words2=dev.get("sampled_words2"),
                wc=wc,
            )
        idx, lw, sw, n = filter_hits_sampled(
            dev["sampled_words"],
            jnp.asarray(chunks),
            jnp.asarray(lengths),
            dev["min_long_len"],
            q=p.q,
            stride=p.stride,
            log2_words=p.log2_words,
            salts=p.sampled_salts,
            shorts=p.shorts,
            capacity=capacity,
        )
        # the flat path has no per-row slot capacity: report 0 so the
        # caller's nc <= _cap_coarse check never trips
        return idx, lw, sw, n, jnp.zeros_like(n)

    def expand_hits(
        self,
        grid_idx: np.ndarray,
        long_word: np.ndarray,
        short_word: np.ndarray,
        n_hits: int,
        row_len: int,
        lengths: np.ndarray,  # [B] int32 (host copy)
    ) -> Tuple[np.ndarray, int]:
        """Host expansion of compacted grid hits into sorted unique
        candidate-start indices (flattened ``b * L + t``)."""
        p = self.plan
        s = p.stride
        M = -(-row_len // s)
        g = grid_idx[:n_hits].astype(np.int64)
        lw = long_word[:n_hits].astype(np.int64) & 0xFFFFFFFF
        sw = short_word[:n_hits].astype(np.int64) & 0xFFFFFFFF
        b = g // M
        pos = (g % M) * s
        base = b * row_len
        min_long = p.min_long_len
        parts: List[np.ndarray] = []
        for j in range(s):
            sel = (lw >> j) & 1 != 0
            if sel.any():
                t = pos[sel] - j
                ok = (t >= 0) & (t + min_long <= lengths[b[sel]])
                parts.append(base[sel][ok] + t[ok])
            sel = (sw >> j) & 1 != 0
            if sel.any():  # short starts: already length-gated on device
                parts.append(base[sel] + pos[sel] + j)
        if not parts:
            return np.zeros(0, np.int64), 0
        starts = np.unique(np.concatenate(parts))
        return starts, starts.shape[0]

    def adaptive_chain(self, launch):
        """Drive one speculative A->B launch chain with capacity learning.

        Both kernels are dispatched back-to-back with NO host fetch in
        between and the occupancy scalars come back in one fetch.  Phase-A
        capacity adapts (up AND down) to the last observed hit count;
        overflowing any stage retries with that capacity doubled.
        ``launch(cap_a, cap_b)`` must return ``(cells, n_hits, n_flagged,
        n_coarse)`` with host ints for the counts (``n_coarse`` checks
        the extraction slot capacity ``self._cap_coarse``; the flat take
        path reports ``n_coarse == 0`` since it has none)."""
        cap_a = max(self._cap_hits, 256)
        cap_b = self._cap_flagged
        while True:
            cells, n, nf, nc = launch(cap_a, cap_b)
            if n <= cap_a and nf <= cap_b and nc <= self._cap_coarse:
                break
            if n > cap_a:
                self._count_retry("filter", n, cap_a)
                cap_a = _next_cap(n)
            if nf > cap_b:
                self._count_retry("verify", nf, cap_b)
                cap_b = _next_cap(nf)
            if nc > self._cap_coarse:
                self._count_retry("coarse", nc, self._cap_coarse)
                self._grow_cap_coarse(nc)
        self._cap_hits = max(256, _next_cap(n + n // 4))
        self._cap_flagged = cap_b
        self._decay_cap_coarse(nc)
        return cells, nf

    def _count_retry(self, stage: str, observed: int, cap: int) -> None:
        if self.stats is not None:
            self.stats.record_capacity_retry(stage, observed, cap)

    def _grow_cap_coarse(self, nc: int) -> None:
        """Grow the stage-1 slot cap after an overflow; past the 128-slot
        structural ceiling of the extraction, permanently fall back to
        the take filter (exact, no slot capacity) instead of spinning."""
        if _next_pow2(nc) > 128:
            self._force_take = True
        else:
            self._cap_coarse = min(128, _next_pow2(nc))

    def _decay_cap_coarse(self, nc: int) -> None:
        """Decay the learned stage-1 slot cap back toward the planner
        seed once dense launches stop recurring.  One 128-bumping
        launch would otherwise pin every later launch at up to 128
        masked-reduction extraction passes plus a recompile per bump —
        halving only when the observed max fits in half the cap limits
        recompile churn while still converging back to the seed."""
        floor = self._cap_coarse_floor
        if self._cap_coarse > floor and nc <= self._cap_coarse // 2:
            self._cap_coarse = max(floor, self._cap_coarse // 2)

    def launch_device(self, chunks_d, lengths_d, cap_a, cap_b, wc=None):
        """One speculative filter→verify chain entirely on device.

        Returns ``(cells, n_d, nf_d, nc_d)`` as *device* values with no
        host fetch, so callers can keep several chains in flight and
        synchronize once per batch instead of once per launch.  The counts must be checked against
        ``cap_a``/``cap_b``/``self._cap_coarse`` after fetching — overflow
        means retry bigger."""
        from ..ops.filter_jax import (
            verify_windows,
            verify_windows_compressed,
            verify_windows_kgram,
        )

        dd = self.dense_model.device_arrays
        dev = self.device_arrays
        idx, _lw, _sw, n_d, nc_d = self.scan_hits_sampled(
            chunks_d, lengths_d, cap_a, wc=wc
        )
        if not self._compressed and self.verify_kv > 1:
            cells, nf_d = verify_windows_kgram(
                self.verify_ktable_dev,
                dev["byte_class"],
                dev["used_bytes"],
                chunks_d,
                lengths_d,
                idx,
                dd["final_start"],
                n_classes=self.auto.n_classes,
                kv=self.verify_kv,
                stride=self.plan.stride,
                win_len=self.win_len,
                capacity=cap_b,
                n_hits=cap_a,
            )
            return cells, n_d, nf_d, nc_d
        if self._compressed:
            cells, nf_d = verify_windows_compressed(
                dd["dense_flat"],
                dd["meta"],
                dd["exc_target"],
                dev["byte_class"],
                dev["used_bytes"],
                chunks_d,
                lengths_d,
                idx,
                dd["dense_final_start"],
                dd["final_start"],
                n_classes=self.auto.n_classes,
                n_dense=self.auto.n_dense,
                stride=self.plan.stride,
                win_len=self.win_len,
                capacity=cap_b,
                n_hits=cap_a,
            )
        else:
            cells, nf_d = verify_windows(
                dd["table_flat"],
                dev["byte_class"],
                dev["used_bytes"],
                chunks_d,
                lengths_d,
                idx,
                dd["final_start"],
                n_classes=self.auto.n_classes,
                stride=self.plan.stride,
                win_len=self.win_len,
                capacity=cap_b,
                n_hits=cap_a,
            )
        return cells, n_d, nf_d, nc_d

    def launch_device_records(
        self, chunks_d, lengths_d, emit_from_d, cap_a, cap_r, wc=None,
    ):
        """Speculative filter→record-verify chain: like
        :meth:`launch_device` but the verify stage emits compacted
        per-match ``(cell, state*32+j)`` records instead of flagged
        windows (ops/filter_jax.verify_windows_records) — the host then
        expands records instead of re-walking windows, so host + fetch
        cost scales with the match count.  Returns ``(rec_cell,
        rec_pack, n_d, nr_d, nc_d)`` device values (no host fetch)."""
        from ..ops.filter_jax import (
            verify_windows_records,
            verify_windows_records_compressed,
        )

        dd = self.dense_model.device_arrays
        dev = self.device_arrays
        idx, _lw, _sw, n_d, nc_d = self.scan_hits_sampled(
            chunks_d, lengths_d, cap_a, wc=wc
        )
        if self._compressed:
            rec_cell, rec_pack, nr_d = verify_windows_records_compressed(
                dd["dense_flat"],
                dd["meta"],
                dd["exc_target"],
                dev["byte_class"],
                dev["used_bytes"],
                chunks_d,
                lengths_d,
                emit_from_d,
                idx,
                dd["dense_final_start"],
                dd["final_start"],
                n_classes=self.auto.n_classes,
                n_dense=self.auto.n_dense,
                stride=self.plan.stride,
                win_len=self.win_len,
                capacity=cap_r,
                n_hits=cap_a,
            )
            return rec_cell, rec_pack, n_d, nr_d, nc_d
        rec_cell, rec_pack, nr_d = verify_windows_records(
            dd["table_flat"],
            dev["byte_class"],
            dev["used_bytes"],
            chunks_d,
            lengths_d,
            emit_from_d,
            idx,
            dd["final_start"],
            n_classes=self.auto.n_classes,
            stride=self.plan.stride,
            win_len=self.win_len,
            capacity=cap_r,
            n_hits=cap_a,
        )
        return rec_cell, rec_pack, n_d, nr_d, nc_d

    def emit_records_arrays(
        self,
        packed: PackedRows,
        rec_cell: np.ndarray,
        rec_pack: np.ndarray,
        n_rec: int,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Expand device match records into ``(docs, end_pos, pids)``
        arrays in reference emission order — vectorized csr expansion +
        the per-pattern ownership rule; no window re-walk.  Windows that
        overflowed their record slots arrive as sentinel records and are
        re-walked exactly via :meth:`emit_windows_arrays` (their normal
        records are discarded to avoid double emission)."""
        from ..ops.filter_jax import REC_OVERFLOW_J
        from ..ops.matches import csr_expand

        z = np.zeros(0, np.int64)
        if n_rec == 0:
            return z, z, z
        auto = self.auto
        s = self.plan.stride
        L = packed.row_len
        M = -(-L // s)
        cell = rec_cell[:n_rec].astype(np.int64)
        pack = rec_pack[:n_rec].astype(np.int64)
        j = pack & 31
        sentinel = j == REC_OVERFLOW_J
        parts: List[np.ndarray] = []
        if sentinel.any():
            over_cells = np.unique(cell[sentinel])
            keep_n = ~np.isin(cell, over_cells)
            docs_o, ends_o, pids_o = self.emit_windows_arrays(
                packed, over_cells, over_cells.shape[0]
            )
            cell, pack, j = cell[keep_n], pack[keep_n], j[keep_n]
        else:
            docs_o = None
        if cell.shape[0]:
            state = pack >> 5
            b = cell // M
            m = cell % M
            e = m * s - (s - 1) + j  # end-1 byte index within the row
            rec_of, pids = csr_expand(auto, state)
            src_b = b[rec_of]
            src_e = e[rec_of]
            src_m = m[rec_of]
            ln = auto.pat_lens[pids].astype(np.int64)
            t = src_e + 1 - ln
            short_limit = self.config.cascade_min_q
            owner = np.where(ln >= short_limit, -(-t // s), t // s)
            keep = owner == src_m
            if keep.any():
                parts.append(
                    np.stack(
                        [src_b[keep], src_e[keep] + 1, t[keep], pids[keep]]
                    )
                )
        if not parts:
            if docs_o is not None:
                return docs_o, ends_o, pids_o
            return z, z, z
        arr = np.concatenate(parts, axis=1)
        order = np.lexsort((arr[2], arr[1], arr[0]))
        docs = packed.doc_id[arr[0, order]].astype(np.int64)
        ends = packed.global_off[arr[0, order]] + arr[1, order]
        pids_n = arr[3, order]
        if docs_o is not None and docs_o.shape[0]:
            # merge the (rare) overflow emissions by (doc, end, start)
            starts_n = ends - auto.pat_lens[pids_n]
            starts_o = ends_o - auto.pat_lens[pids_o]
            allc = np.concatenate
            docs, ends, pids_all, starts = (
                allc([docs, docs_o]),
                allc([ends, ends_o]),
                allc([pids_n, pids_o]),
                allc([starts_n, starts_o]),
            )
            o2 = np.lexsort((starts, ends, docs))
            return docs[o2], ends[o2], pids_all[o2]
        return docs, ends, pids_n

    def run_arrays(self, packed: PackedRows, capacity: int, dev_inputs=None):
        """Full cascade on one device: filter (+ device window verify when
        available); returns ``(docs, end_pos, pids)`` arrays in reference
        emission order.

        ``dev_inputs``: optional ``(chunks, lengths, emit_from)`` already on
        device — steady-state callers scanning one resident corpus many
        times (benchmarks, resident-corpus serving) skip the re-upload."""
        if self.plan.mode == "sampled" and self.device_verify_ok:
            import jax.numpy as jnp

            wc = None
            if dev_inputs is not None:
                chunks_d, lengths_d, emit_from_d = dev_inputs[:3]
                if len(dev_inputs) > 3:  # resident-corpus word pack
                    wc = dev_inputs[3]
            else:
                # one host->device upload, shared by every retry + phase B
                chunks_d = jnp.asarray(packed.chunks)
                lengths_d = jnp.asarray(packed.lengths)
                emit_from_d = None
            if self.records_ok:
                if emit_from_d is None:
                    emit_from_d = jnp.asarray(packed.emit_from)

                def launch_r(cap_a, cap_r):
                    rc, rp, n_d, nr_d, nc_d = self.launch_device_records(
                        chunks_d, lengths_d, emit_from_d, cap_a, cap_r, wc=wc,
                    )
                    n, nr, nc = map(
                        int, np.asarray(jnp.stack([n_d, nr_d, nc_d]))
                    )
                    return (rc, rp), n, nr, nc

                (rc, rp), nr = self.adaptive_chain(launch_r)
                if nr == 0:
                    z = np.zeros(0, np.int64)
                    return z, z, z
                return self.emit_records_arrays(
                    packed, np.asarray(rc[:nr]), np.asarray(rp[:nr]), nr
                )

            def launch(cap_a, cap_b):
                cells, n_d, nf_d, nc_d = self.launch_device(
                    chunks_d, lengths_d, cap_a, cap_b, wc=wc,
                )
                n, nf, nc = map(
                    int, np.asarray(jnp.stack([n_d, nf_d, nc_d]))
                )
                return cells, n, nf, nc

            cells, nf = self.adaptive_chain(launch)
            if nf == 0:
                z = np.zeros(0, np.int64)
                return z, z, z  # common case: nothing to fetch
            return self.emit_windows_arrays(packed, np.asarray(cells), nf)
        idx_np, n = self.candidates_np(packed, capacity)
        return self.verify_arrays(packed, idx_np, n)

    def run(self, packed: PackedRows, capacity: int, dev_inputs=None):
        """Iterator facade over :meth:`run_arrays`."""
        docs, ends, pids = self.run_arrays(packed, capacity, dev_inputs)

        def gen():
            for i in range(docs.shape[0]):
                yield int(docs[i]), int(ends[i]), pids[i : i + 1]

        return gen()

    def emit_windows_arrays(
        self, packed: PackedRows, win_cells: np.ndarray, n_flagged: int
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Host re-walk of the (rare) flagged windows; applies the
        exactly-once ownership rules and returns ``(docs, end_pos, pids)``
        arrays in reference emission order — vectorized per window step
        and per emission (no per-record Python loop).

        Ownership: a long occurrence at start ``t`` belongs to the window
        of its guaranteed grid hit ``ceil(t / stride)``; a short one to
        ``floor(t / stride)`` — each match is accepted by exactly one
        flagged window even when neighboring windows overlap it."""
        z = np.zeros(0, np.int64)
        if n_flagged == 0:
            return z, z, z
        from ..ops.matches import csr_expand

        auto = self.auto
        s = self.plan.stride
        L = packed.row_len
        M = -(-L // s)
        g = win_cells[:n_flagged].astype(np.int64)
        rows = g // M
        m = g % M
        w0 = m * s - (s - 1)
        bc = auto.byte_class
        row_len = packed.lengths[rows].astype(np.int64)
        row_emit = packed.emit_from[rows].astype(np.int64)
        short_limit = self.config.cascade_min_q
        states = np.zeros(g.shape[0], dtype=np.int64)
        parts: List[np.ndarray] = []  # [4, n] stacks of (row, end, start, pid)
        for j in range(self.win_len):
            pos = w0 + j
            valid = (pos >= 0) & (pos < row_len)
            byte = packed.chunks[rows, np.clip(pos, 0, L - 1)]
            cls = np.where(valid, bc[byte], 0)
            states = auto.lookup(states, cls).astype(np.int64)
            emit = (
                auto.is_final(states)
                & valid
                & (pos >= row_emit)
                & (pos < row_len)
            )
            fin = np.nonzero(emit)[0]
            if fin.size == 0:
                continue
            rec_of, pids = csr_expand(auto, states[fin])
            src = fin[rec_of]
            e = pos[src]  # end-1 byte index
            ln = auto.pat_lens[pids].astype(np.int64)
            t = e + 1 - ln
            owner = np.where(ln >= short_limit, -(-t // s), t // s)
            keep = owner == m[src]
            if keep.any():
                parts.append(
                    np.stack(
                        [rows[src][keep], e[keep] + 1, t[keep], pids[keep]]
                    )
                )
        if not parts:
            return z, z, z
        arr = np.concatenate(parts, axis=1)  # [4, n]
        order = np.lexsort((arr[2], arr[1], arr[0]))
        docs = packed.doc_id[arr[0, order]].astype(np.int64)
        ends = packed.global_off[arr[0, order]] + arr[1, order]
        return docs, ends, arr[3, order]

    def emit_windows(
        self, packed: PackedRows, win_cells: np.ndarray, n_flagged: int
    ) -> Iterator[Tuple[int, int, np.ndarray]]:
        """Iterator facade over :meth:`emit_windows_arrays`."""
        docs, ends, pids = self.emit_windows_arrays(
            packed, win_cells, n_flagged
        )

        def gen():
            for i in range(docs.shape[0]):
                yield int(docs[i]), int(ends[i]), pids[i : i + 1]

        return gen()

    def candidates_np(self, packed: PackedRows, capacity: int):
        """Device filter + capacity retry + (sampled) host bit expansion.
        Returns ``(start_idx np, n_starts)`` ready for :meth:`verify`."""
        if self.plan.mode == "sampled":
            while True:
                idx, lw, sw, n, nc = self.scan_hits_sampled(
                    packed.chunks, packed.lengths, capacity
                )
                n, nc = int(n), int(nc)
                if n <= capacity and nc <= self._cap_coarse:
                    break
                if n > capacity:
                    self._count_retry("filter", n, capacity)
                    capacity = _next_cap(n)
                if nc > self._cap_coarse:
                    self._count_retry("coarse", nc, self._cap_coarse)
                    self._grow_cap_coarse(nc)
            self._decay_cap_coarse(nc)
            return self.expand_hits(
                np.asarray(idx), np.asarray(lw), np.asarray(sw), n,
                packed.row_len, packed.lengths,
            )
        while True:
            idx, n = self.scan_candidates(
                packed.chunks, packed.lengths, packed.emit_from, capacity
            )
            n = int(n)
            if n <= capacity:
                break
            capacity = _next_cap(n)
        return np.asarray(idx), n

    def scan_candidates(self, chunks, lengths, emit_from, capacity: int):
        import jax.numpy as jnp

        from ..ops.filter_jax import filter_candidates

        dev = self.device_arrays
        p = self.plan
        assert p.mode != "sampled", "use scan_hits_sampled / candidates_np"
        return filter_candidates(
            dev["bloom_words"],
            dev["byte_class"],
            dev["used_bytes"],
            jnp.asarray(chunks),
            jnp.asarray(lengths),
            jnp.asarray(emit_from),
            dev["min_long_len"],
            n_classes=self.auto.n_classes,
            q=p.q,
            offsets=p.offsets,
            log2_bits=p.log2_bits,
            salts=p.salts,
            shorts=p.shorts,
            capacity=capacity,
        )

    def verify_arrays(
        self,
        packed: PackedRows,
        start_idx: np.ndarray,  # [capacity] flattened b * L + p, ascending
        n_cand: int,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Exact verification: vectorized goto-walk from root over each
        candidate window; returns ``(docs, end_pos, pids)`` arrays in
        reference emission order ``(row, end, start)``."""
        if n_cand == 0:
            z = np.zeros(0, np.int64)
            return z, z, z
        auto = self.auto
        L = packed.row_len
        idx = start_idx[:n_cand].astype(np.int64)
        rows = idx // L
        ps = idx % L
        bc = auto.byte_class
        depth = auto.state_depth
        own = self.plan.own_pat
        row_len = packed.lengths[rows].astype(np.int64)
        row_emit = packed.emit_from[rows].astype(np.int64)

        # active-set walk: candidates that fall off the pure-prefix path are
        # compacted away each level, so total work tracks the (rapidly
        # decaying) survivor count rather than candidates x max_len
        act = np.arange(idx.shape[0])
        states = np.zeros(idx.shape[0], dtype=np.int64)
        out_rows: List[np.ndarray] = []
        out_end: List[np.ndarray] = []
        out_start: List[np.ndarray] = []
        out_pid: List[np.ndarray] = []
        for j in range(auto.max_len):
            pos = ps[act] + j
            in_row = pos < row_len[act]
            if not in_row.all():
                act = act[in_row]
                pos = pos[in_row]
            if act.size == 0:
                break
            b = packed.chunks[rows[act], pos]
            st = auto.lookup(states[act], bc[b]).astype(np.int64)
            states[act] = st
            on_path = depth[st] == j + 1  # left the pure-prefix path?
            o = own[st]
            # end-1 byte index = pos; ownership window [emit_from, length)
            emit = on_path & (o >= 0) & (pos >= row_emit[act])
            if emit.any():
                sel = np.nonzero(emit)[0]
                out_rows.append(rows[act[sel]])
                out_end.append(pos[sel] + 1)
                out_start.append(ps[act[sel]])
                out_pid.append(o[sel])
            if not on_path.all():
                act = act[on_path]
        if not out_rows:
            z = np.zeros(0, np.int64)
            return z, z, z
        r = np.concatenate(out_rows)
        e = np.concatenate(out_end)
        st = np.concatenate(out_start)
        pid = np.concatenate(out_pid)
        order = np.lexsort((st, e, r))  # (row, end, start): longest-first
        docs = packed.doc_id[r[order]].astype(np.int64)
        ends = packed.global_off[r[order]] + e[order]
        return docs, ends, pid[order].astype(np.int64)

    def verify(
        self,
        packed: PackedRows,
        start_idx: np.ndarray,
        n_cand: int,
    ) -> Iterator[Tuple[int, int, np.ndarray]]:
        """Iterator facade over :meth:`verify_arrays`."""
        docs, ends, pids = self.verify_arrays(packed, start_idx, n_cand)

        def gen():
            for i in range(docs.shape[0]):
                yield int(docs[i]), int(ends[i]), pids[i : i + 1]

        return gen()
