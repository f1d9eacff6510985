"""Typed runtime configuration.

The reference has only compile-time constants (``AC_PATTRN_MAX_LENGTH=1024``
at ``src/multifast/actypes.h:148``; ``MF_REPLACEMENT_BUFFER_SIZE=2048`` at
``actypes.h:153``) and a single runtime knob (``findAll``).  The device
build adds the knobs that matter on accelerator hardware: chunking/halo
geometry, device-side match-buffer capacity, table dtype, and mesh shape.
"""

from __future__ import annotations

import dataclasses

#: engine and bloom_impl values whose kernels were removed; ScanConfig
#: rejects them by name instead of silently running another path
_REMOVED_ENGINES = ("tile",)
_REMOVED_BLOOM_IMPLS = ("pallas", "pallas_vmem")


@dataclasses.dataclass(frozen=True)
class ScanConfig:
    """Configuration for automaton compilation and device scan."""

    #: Hard per-pattern byte-length limit (reference ``actypes.h:148``).
    max_pattern_length: int = 1024

    #: Target length of one device-side scan row.  Long haystacks are split
    #: into rows of at most this many payload bytes (plus a left halo) so the
    #: sequential per-byte dependency is bounded and batch parallelism grows
    #: with input size.  Must exceed the longest added pattern.
    chunk_len: int = 2048

    #: Initial capacity of the device-side compacted match buffer (number of
    #: match *positions*).  On overflow the scan retries with a doubled
    #: capacity — results are always exact, never truncated.
    match_capacity: int = 4096

    #: Pad batch dims to multiples of this to bound jit recompilation.
    batch_pad: int = 8

    #: Use int16 transition tables when the state count allows it (halves
    #: the table's device-memory footprint).
    allow_int16_states: bool = True

    #: Build the trie with the C++ native builder when the shared library is
    #: available (bit-identical output; much faster at signature scale).
    prefer_native_builder: bool = True

    #: Preferred mesh axis name for data-parallel corpus sharding.
    data_axis: str = "data"

    #: Automatically shard device scans over all visible devices via a 1-D
    #: data mesh when more than one device is present.
    auto_shard: bool = True

    #: Scan backend: "auto" (host below :attr:`host_scan_threshold`, device
    #: above), "device" (always JAX), or "host" (always numpy scalar path).
    backend: str = "auto"

    #: Device scan engine.  "auto": any eligible cascade for scans of at
    #: least ``cascade_min_bytes``, else k-gram for scans of at least
    #: ``kgram_min_bytes``, else dense (Matcher._pick_engine).  Explicit
    #: values: "dfa" (1-gram dense table), "kgram" (k-byte
    #: super-transitions), "cascade" (bloom filter + exact verify; the
    #: planner prefers sampled mode, anchored mode is reachable by
    #: forcing cascade_mode="anchored").
    engine: str = "auto"

    #: Transition-table layout: "auto" switches to the compressed
    #: (dense-bank + single-exception rows) format when the dense ``[S, C]``
    #: table would exceed :attr:`dense_table_max_bytes`; "dense" /
    #: "compressed" force a layout.  Compressed scans cost 3 gathers/byte
    #: instead of 1 but fit byte-dense million-pattern sets in HBM
    #: (core/tables.CompressedAutomaton; SURVEY §7 "Table memory at
    #: signature scale").
    table_format: str = "auto"

    #: With table_format="auto", estimated dense table bytes above this
    #: switch finalize to the compressed layout (default 1 GiB, a small
    #: share of one device's memory that leaves room for the corpus and
    #: blooms; not yet re-measured against the compressed walk).
    dense_table_max_bytes: int = 1 << 30

    #: Byte budget for the k-gram super-transition table (S * C^k * 4).
    kgram_budget_bytes: int = 256 * 1024 * 1024

    #: With engine="auto", scans smaller than this use the 1-gram model
    #: (the k-gram table build is amortized only by large corpora).
    kgram_min_bytes: int = 1 << 20

    #: log2 of per-stage bloom filter bits for the cascade engine.
    cascade_log2_bloom_bits: int = 17

    #: patterns shorter than this are handled by exact compare-select in
    #: the cascade engine (longer ones go through the gram blooms).
    cascade_min_q: int = 4

    #: more short patterns than this disqualifies the cascade engine
    #: (compare-select cost grows linearly with short-pattern count).
    cascade_max_shorts: int = 16

    #: max bloom fill ratio before the cascade is considered useless.
    cascade_max_fill: float = 0.25

    #: with engine="auto", scans at least this large prefer the cascade.
    cascade_min_bytes: int = 1 << 20

    #: bloom lookup implementation: "auto" or "take" (both the XLA gather
    #: filter).  The former "pallas" and "pallas_vmem" kernels are removed
    #: and rejected.
    bloom_impl: str = "auto"

    #: Byte length of the pattern-prefix refinement hash (capped by the
    #: shortest long pattern).  Soundness never depends on it (a true
    #: occurrence's window prefix is in the bloom by construction); more
    #: bytes = finer stray discrimination, fewer bytes = less rolling-hash
    #: arithmetic.
    cascade_prefix_len: int = 12

    #: cascade filter mode: "auto" (planner cost model), "sampled" (force
    #: the strided positional bloom), "anchored" (force per-position
    #: multi-stage blooms).
    cascade_mode: str = "auto"

    #: log2 cap on the sampled positional bloom's word count (2**28 int32
    #: words = 1 GiB of device memory).  The planner only sizes up when the
    #: entry count demands it (signature-scale sets) — small pattern sets
    #: stay at a few MiB.
    cascade_log2_words_max: int = 28

    #: planner bound on estimated candidate starts per scanned byte for the
    #: sampled cascade (host verification stays proportional to this).
    cascade_max_cand_density: float = 0.02

    #: byte budget for the window verifier's k-gram super-transition table
    #: (the cascade's device verify walks candidate windows in k-class
    #: steps — k dependent gathers become one).  Sized so the headline
    #: automaton gets k=4 (6 gathers per 23-byte window instead of 23);
    #: 0 disables the k-gram verifier (plain per-class walk).
    verify_kgram_bytes: int = 192 * 1024 * 1024

    #: corpora larger than this are scanned in multiple device launches
    #: (documents are independent, so splitting is exact); also keeps
    #: flattened cell indices comfortably inside int32.
    max_launch_bytes: int = 256 * 1024 * 1024

    #: With backend="auto", total haystack bytes at or below this run on the
    #: host scalar scanner — device dispatch overhead dominates tiny scans.
    host_scan_threshold: int = 4096

    #: Slice size of the cold-corpus double-buffered pipeline
    #: (Matcher._match_arrays_fresh_pipelined): a fresh match_arrays over
    #: many documents packs + uploads slice k+1 while slice k scans on
    #: device.  Small enough to overlap meaningfully, large enough that
    #: per-slice dispatch overhead amortizes.
    fresh_slice_bytes: int = 16 * 1024 * 1024

    def __post_init__(self) -> None:
        if self.max_pattern_length < 1:
            raise ValueError("max_pattern_length must be >= 1")
        if self.chunk_len < 1:
            raise ValueError("chunk_len must be >= 1")
        if self.match_capacity < 1:
            raise ValueError("match_capacity must be >= 1")
        if self.table_format not in ("auto", "dense", "compressed"):
            raise ValueError(
                f"table_format must be auto/dense/compressed, "
                f"got {self.table_format!r}"
            )
        if self.cascade_mode not in ("auto", "sampled", "anchored"):
            raise ValueError(
                f"cascade_mode must be auto/sampled/anchored, "
                f"got {self.cascade_mode!r}"
            )
        if self.engine in _REMOVED_ENGINES:
            raise ValueError(
                f"engine {self.engine!r} was removed; use auto, dfa, kgram "
                "or cascade"
            )
        if self.engine not in ("auto", "dfa", "kgram", "cascade"):
            raise ValueError(
                f"engine must be auto/dfa/kgram/cascade, got {self.engine!r}"
            )
        if self.bloom_impl in _REMOVED_BLOOM_IMPLS:
            raise ValueError(
                f"bloom_impl {self.bloom_impl!r} was removed; use auto or "
                "take"
            )
        if self.bloom_impl not in ("auto", "take"):
            raise ValueError(
                f"bloom_impl must be auto/take, got {self.bloom_impl!r}"
            )


DEFAULT_CONFIG = ScanConfig()
