"""Structured logging + scan counters.

The reference's only observability is PHP warnings and benchmark printf
(``examples/benchmark.php:49,81-84``).  Here: a standard library logger
(``php_aho_corasick_tpu``) and a per-matcher :class:`ScanStats` counter
block surfaced as ``Matcher.stats``.
"""

from __future__ import annotations

import dataclasses
import logging

logger = logging.getLogger("php_aho_corasick_tpu")


@dataclasses.dataclass
class ScanStats:
    """Cumulative per-matcher scan counters."""

    scans: int = 0
    bytes_scanned: int = 0
    matches_emitted: int = 0
    #: launches whose fixed-capacity output overflowed and retried with a
    #: bigger capacity — each distinct capacity is a new XLA compile
    #: shape, so a nonzero steady-state rate means caps are mis-seeded
    #: (see CascadeModel.seed_caps)
    capacity_retries: int = 0
    #: ``match_arrays_many`` batches that could NOT take the pipelined
    #: device-record fast path and fell back to sequential scans (see
    #: ``records_fallback_reason`` for the most recent cause): the
    #: fallback is correct but must not be silent
    records_fallbacks: int = 0
    records_fallback_reason: str = ""
    last_engine: str = ""
    last_backend: str = ""

    def record(self, engine: str, backend: str, n_bytes: int, n_matches: int) -> None:
        self.scans += 1
        self.bytes_scanned += n_bytes
        self.matches_emitted += n_matches
        self.last_engine = engine
        self.last_backend = backend
        logger.debug(
            "scan engine=%s backend=%s bytes=%d matches=%d",
            engine, backend, n_bytes, n_matches,
        )

    def record_capacity_retry(self, stage: str, observed: int, cap: int) -> None:
        self.capacity_retries += 1
        logger.info(
            "capacity retry (%s): observed %d > cap %d — recompile; "
            "seed_caps avoids this in steady state", stage, observed, cap,
        )

    def record_records_fallback(self, reason: str) -> None:
        self.records_fallbacks += 1
        self.records_fallback_reason = reason
        logger.info(
            "match_arrays_many: records fast path unavailable (%s); "
            "falling back to sequential match_arrays", reason,
        )

    def summary(self) -> str:
        return (
            f"{self.scans} scans, {self.bytes_scanned / 2**20:.1f} MiB, "
            f"{self.matches_emitted} matches, last={self.last_engine}/"
            f"{self.last_backend}, {self.capacity_retries} capacity "
            f"retries, {self.records_fallbacks} records fallbacks"
        )
