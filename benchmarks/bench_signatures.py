#!/usr/bin/env python
"""Signature-scale benchmark (BASELINE.json config 4): 1M needles
(virus-signature style), device-resident transition table, one GPU.

Two alphabet regimes:

* ``--alphabet hex`` (default): 16-symbol signatures — the dense table
  holds (~12M states x 17 classes) and the sampled cascade's 2-probe
  positional bloom keeps the filter selective at ~9M (gram, alignment)
  entries with on-device window verification.
* ``--alphabet byte``: full-256-byte signatures — the dense [S, C] table
  would be ~16 GB, so finalize auto-selects the COMPRESSED format
  (dense-bank + single-exception rows) and the cascade verifies windows
  through the 3-gather compressed walk (round 3; SURVEY §7 "table memory
  at signature scale").

The 1-gram DFA remains the fallback comparison (gather-bound floor).
Scaling beyond one device is the data-parallel mesh story
(bench_scaling.py).  Without a GPU the script fails.

  python benchmarks/bench_signatures.py [--needles 1000000] [--mib 64]
      [--alphabet hex|byte]
"""

import argparse
import json
import os as _os
import sys as _sys

_ROOT = _os.path.join(_os.path.dirname(_os.path.abspath(__file__)), "..")
_sys.path.insert(0, _ROOT)
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--needles", type=int, default=1_000_000)
    ap.add_argument("--needle-len", type=int, default=16)
    ap.add_argument("--mib", type=int, default=64)
    ap.add_argument("--alphabet", choices=("hex", "byte"), default="hex")
    args = ap.parse_args()

    from chip_smoke import card_line, require_gpu
    from php_aho_corasick_tpu import Matcher, ScanConfig, native
    from php_aho_corasick_tpu.ops.matches import pack_documents
    from php_aho_corasick_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache(_ROOT)
    dev = require_gpu()

    rng = np.random.default_rng(7)
    if args.alphabet == "hex":
        amap = np.frombuffer(b"0123456789abcdef", np.uint8)
        draw = lambda n: amap[rng.integers(0, 16, n, dtype=np.uint8)]  # noqa: E731
    else:
        draw = lambda n: rng.integers(0, 256, n, dtype=np.uint8)  # noqa: E731
    raw = draw((args.needles, args.needle_len))
    patterns = list({bytes(raw[i]) for i in range(args.needles)})

    t0 = time.time()
    cfg = ScanConfig(backend="device", chunk_len=4096)
    m = Matcher([{"id": i, "value": p} for i, p in enumerate(patterns)], cfg)
    m.finalize()
    build_s = time.time() - t0
    auto = m.automaton
    print(
        f"build: {build_s:.1f}s  states={auto.n_states:,} "
        f"table={auto.table_bytes / 2**20:.0f} MiB "
        f"format={m.table_format} (native={native.available()})"
    )

    n_bytes = args.mib * 2**20
    corpus = bytearray(draw(n_bytes))
    planted = 0
    doc_sz = 2**20
    for j in range(0, n_bytes - 16, max(n_bytes // 200, 1)):
        if j % doc_sz > doc_sz - args.needle_len:
            continue  # would straddle a document boundary (docs are
            # independent; such a plant legitimately cannot match)
        corpus[j : j + args.needle_len] = patterns[j % len(patterns)]
        planted += 1
    docs = [bytes(corpus[i : i + doc_sz]) for i in range(0, n_bytes, doc_sz)]

    import jax.numpy as jnp

    packed = pack_documents(docs, m._pack_chunk_len(), auto.max_len - 1,
                            row_align=m._row_align())
    ch = jnp.asarray(packed.chunks)
    ln = jnp.asarray(packed.lengths)
    ef = jnp.asarray(packed.emit_from)

    engine = m._pick_engine(n_bytes)
    cm = m.cascade_model if engine == "cascade" else None
    handle = None
    if cm is not None:
        print(f"engine: cascade ({cm.plan.reason}, "
              f"bloom {4 << cm.plan.log2_words >> 20} MiB, "
              f"device_verify={cm.device_verify_ok}, "
              f"records={cm.records_ok})")
        # PUBLIC steady-state path: resident handle + pipelined records
        # batches (headline methodology; engages the corpus word-pack /
        # phase caches the launch otherwise re-pays per pass)
        handle = m.device_corpus(docs)

        def launch():
            res = m.match_arrays(handle)
            return int(res["doc"].shape[0])
    else:
        print(f"engine: {engine} (dense dfa fallback)")

        def launch():
            idx, sts, n, carry = m.model.scan_compact_device(
                ch, ln, ef, None, 1 << 16
            )
            return int(n)

    n = launch()  # warm
    n = launch()  # adaptive capacities settle
    reps = 3
    if cm is not None:
        reps = 8  # the per-batch stats + record fetches amortize across
        # the pipelined batch, as in bench.py
        m.match_arrays_many([handle] * reps)  # warm the batch structure

        def batch():
            t0 = time.time()
            m.match_arrays_many([handle] * reps)
            return (time.time() - t0) / reps

        dts = sorted(batch() for _ in range(3))
        dt = dts[1]
    else:
        times = []
        for _ in range(reps):
            t0 = time.time()
            n = launch()
            times.append(time.time() - t0)
        dt = sorted(times)[reps // 2]
    print(
        f"scan: {dt*1e3:.0f} ms for {args.mib} MiB -> "
        f"{n_bytes / dt / 1e9:.3f} GB/s; matches={n} "
        f"(planted {planted})"
    )
    assert n >= planted

    # dense-DFA comparison point on the same corpus
    def launch_dfa():
        idx, sts, nd, carry = m.model.scan_compact_device(
            ch, ln, ef, None, 1 << 16
        )
        return int(nd)

    launch_dfa()
    t0 = time.time()
    launch_dfa()
    ddt = time.time() - t0
    print(f"dfa fallback: {ddt*1e3:.0f} ms -> {n_bytes / ddt / 1e9:.3f} GB/s")

    print(json.dumps({
        "alphabet": args.alphabet,
        "needles": len(patterns),
        "needle_len": args.needle_len,
        "states": int(auto.n_states),
        "table_mib": auto.table_bytes / 2**20,
        "table_format": m.table_format,
        "build_s": build_s,
        "corpus_mib": args.mib,
        "gbps": n_bytes / dt / 1e9,
        "pass_ms": dt * 1e3,
        "matches": int(n),
        "planted": planted,
        "dfa_fallback_gbps": n_bytes / ddt / 1e9,
        "engine": cm.plan.reason if cm is not None else engine,
        "device": dev.device_kind,
        "card": card_line(),
    }))


if __name__ == "__main__":
    main()
