"""Streaming (chunk-continuation) scanning — the ``keep=1`` capability.

The reference's C layer supports feeding one logical input as successive
chunks: ``ac_trie_search(..., keep=1)`` preserves ``last_node`` and
``base_position`` so matches spanning a chunk edge are found
(``src/multifast/ahocorasick.c:191-194, 236-238``; the PHP layer always
resets, ``php_ahocorasick.c:745``).

Device-side equivalent — two carry mechanisms, routed per feed:

**Device state carry** (the default device path).  The carried DFA state
(the ``last_node`` analog) is fed straight into the scan kernel as the
first row's ``init_state`` and the *kernel's own* carry output
(``scan_and_compact``'s ``carry_state``) becomes the next feed's state —
no prefix prepend, no per-feed host walk, no tail buffer; feed cost is
O(len(data)) engine work on both sides, independent of ``max_len``.
Rows after the first inside one feed continue through the standard
halo/`emit_from` machinery (a match spans <= ``max_len`` bytes, so only
row 0 needs the cross-feed state).

**Prefix re-scan** (host feeds + large cascade feeds).  The carried
state's trie depth ``d = state_depth[state]`` is exactly the number of
trailing bytes that could still be part of a future match (the quantity
the reference's replace backlog cut is built on, ``replace.c:529``); the
feed prepends those ``d`` bytes and suppresses emissions inside them.
Used where the carrying kernel is not the best engine: host feeds (the
native C oracle scan has no init-state entry) and large feeds whose
engine choice is the start-based sampled cascade (filters cannot carry a
DFA state; prepending ``d <= 1024`` bytes costs ~nothing at MiB feed
sizes).  Here the carried state refresh is an O(min(stream, max_len))
host table walk.
"""

from __future__ import annotations

from typing import List, Union

import numpy as np


class StreamScanner:
    """Incremental scanner over one logical byte stream.

    Usage::

        with matcher.stream() as st:
            for chunk in chunks:
                records.extend(st.feed(chunk))

    Each record has the standard schema; positions are *global* stream
    offsets.  A pattern split across two feeds IS reported (unlike
    consecutive :meth:`Matcher.match` calls — Issue #21 semantics).
    """

    def __init__(self, matcher) -> None:
        self._m = matcher
        self._m.finalize() if not matcher.finalized else None
        self.base_position = 0  # bytes consumed so far
        self.state = 0  # carried DFA state (the ``last_node`` analog)
        self._tail = b""  # last <= max_len stream bytes (prefix path only)
        self._closed = False
        self._cap = matcher.config.match_capacity

    @property
    def state_depth(self) -> int:
        """Trie depth of the carried state = number of trailing stream
        bytes that may still extend to a match (``replace.c:529``)."""
        return int(self._m.automaton.state_depth[self.state])

    def feed(self, data: Union[str, bytes, bytearray]) -> List[dict]:
        """Scan the next chunk; returns matches ending inside it (including
        matches that started in earlier feeds)."""
        if self._closed:
            raise ValueError("stream is closed")
        if isinstance(data, str):
            data = data.encode("utf-8")
        data = bytes(data)
        if not data:
            return []
        m = self._m
        cfg = m.config
        use_host = cfg.backend == "host" or (
            cfg.backend == "auto" and len(data) <= cfg.host_scan_threshold
        )
        if not use_host:
            engine = m._pick_engine(len(data))
            if engine != "cascade":
                return self._feed_device_carry(data)
        return self._feed_prefix(data)

    # -------------------------------------------------- device state carry

    def _feed_device_carry(self, data: bytes) -> List[dict]:
        """Exact device carry: row 0 starts from the carried state, the
        kernel's carry output becomes the next feed's state."""
        from .ops.matches import expand_matches_arrays, pack_documents
        from .utils import next_pow2

        m = self._m
        auto = m.automaton
        halo = max(auto.max_len - 1, 0)
        packed = pack_documents([data], m.config.chunk_len, halo)
        init = np.zeros(packed.batch, dtype=np.int32)
        rows = np.nonzero(packed.doc_id == 0)[0]
        init[rows[0]] = self.state
        while True:
            idx, sts, n, carry = m.model.scan_compact_device(
                packed.chunks, packed.lengths, packed.emit_from,
                init, self._cap,
            )
            n = int(n)
            if n <= self._cap:
                break
            self._cap = next_pow2(n)
        docs_a, ends_a, pids_a = expand_matches_arrays(
            auto, packed, np.asarray(idx), np.asarray(sts), n
        )
        out: List[List[dict]] = [[]]
        m._emit_records(docs_a, ends_a + self.base_position, pids_a, out)
        self.state = int(np.asarray(carry)[rows[-1]])
        self.base_position += len(data)
        # keep the byte tail current (an O(max_len) slice, no table walk)
        # so a later feed routed to the prefix path can prepend real bytes
        H = auto.max_len
        self._tail = (self._tail + data)[-H:] if H else b""
        return out[0]

    # -------------------------------------------------- prefix re-scan

    def _feed_prefix(self, data: bytes) -> List[dict]:
        d = self.state_depth
        prefix = self._tail[len(self._tail) - d:] if d else b""
        text = prefix + data
        recs = self._m.match(text)
        offset = self.base_position - d
        out = []
        for r in recs:
            if r["pos"] <= d:
                continue  # ends at/inside the carried prefix: already reported
            r = dict(r)
            r["pos"] += offset
            r["start_postion"] += offset
            out.append(r)
        self._advance(data)
        return out

    def _advance(self, data: bytes) -> None:
        """Refresh (state, tail, base_position) after consuming ``data``.

        The carried state is recomputed by walking the last
        ``min(stream_len, max_len)`` bytes from the root: the true state
        has depth <= max_len, and a root walk over H >= depth trailing
        bytes lands exactly on the longest-suffix node."""
        auto = self._m.automaton
        H = auto.max_len
        self._tail = (self._tail + data)[-H:] if H else b""
        cls = auto.byte_class[np.frombuffer(self._tail, dtype=np.uint8)]
        s = np.zeros(1, dtype=np.int64)
        for c in cls:  # table-format-agnostic walk (dense or compressed)
            s = auto.lookup(s, c.reshape(1))
        self.state = int(s[0])
        self.base_position += len(data)

    def reset(self) -> None:
        """Forget all carried state (the ``keep=0`` reset,
        ``ahocorasick.c:191-192``)."""
        self._tail = b""
        self.state = 0
        self.base_position = 0

    def close(self) -> None:
        self._closed = True

    def __enter__(self) -> "StreamScanner":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
