#!/usr/bin/env python
"""Bulk scanning: the "one automaton, many haystacks" production pattern
(the reference's intended amortization, ``/root/reference/README.md:7-9``)
on the device — build once, warm the kernels, then stream corpora through
``match_many``.

  python examples/bulk_scan.py
"""

import os as _os
import random
import sys as _sys
import time

_sys.path.insert(0, _os.path.join(_os.path.dirname(_os.path.abspath(__file__)), ".."))

from php_aho_corasick_tpu import Matcher, ScanConfig


def main():
    rng = random.Random(0)
    needles = sorted(
        {bytes(rng.choice(b"abcdef") for _ in range(16)) for _ in range(2048)}
    )
    m = Matcher(
        [{"id": i, "value": p} for i, p in enumerate(needles)],
        ScanConfig(backend="device", chunk_len=4096),
    )
    m.finalize()
    print(m.describe())

    # Pre-compile the device kernels for the serving shape (first
    # compiles take seconds; do this once at startup).
    m.warmup(doc_bytes=1 << 20, n_docs=8)

    for batch in range(3):
        docs = [
            bytes(rng.choice(b"abcdef") for _ in range(1 << 20))
            for _ in range(8)
        ]
        # plant one needle so the batch has something to find
        docs[0] = docs[0][:500] + needles[batch] + docs[0][516:]
        t0 = time.time()
        results = m.match_many(docs)
        dt = time.time() - t0
        n = sum(len(r) for r in results)
        mb = sum(map(len, docs)) / 2**20
        print(
            f"batch {batch}: {mb:.0f} MiB, {n} matches, "
            f"{dt * 1e3:.0f} ms  (engine stats: {m.stats.summary()})"
        )


if __name__ == "__main__":
    main()
