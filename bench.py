#!/usr/bin/env python
"""Headline benchmark — the reference's own workload on one GPU.

Workload (reference ``examples/benchmark.php:20-31``): 2048 needles x 16
chars over alphabet ``abcdef``.  The reference scans 256 haystacks x 8192
chars (2 MiB per pass) and reports 0.174 s per pass incl. automaton build
=> ~12 MB/s implied throughput (``README.md:183``, BASELINE.md).

Here one automaton scans a 128 MiB resident corpus of 8 KiB documents in
steady state through the public ``device_corpus`` + ``match_arrays_many``
path; density rows stream 64 MiB corpora with planted needles through
``match_arrays_stream``, and the cold path times packing, upload and a
fresh ``match_arrays``.  Every timed call returns host arrays (or ends in
``block_until_ready``), so the device has finished when the clock stops.
Without a GPU the script fails.  Prints exactly one JSON line.
"""

import json
import os
import sys
import time

import chip_smoke as cs

REFERENCE_GBPS = 2.0 * 1024**2 / 0.174326 / 1e9  # ~0.01203 GB/s
MIB = 1 << 20


def _median(fn, reps):
    fn()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[len(ts) // 2], sorted(ts)


def main() -> int:
    import jax
    import jax.numpy as jnp

    from php_aho_corasick_tpu import Matcher, ScanConfig
    from php_aho_corasick_tpu.ops.matches import pack_documents
    from php_aho_corasick_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache(os.path.dirname(os.path.abspath(__file__)))
    dev = cs.require_gpu()
    needles = cs.make_needles(1337)
    cfg = ScanConfig(backend="device", chunk_len=4096)
    t0 = time.perf_counter()
    m = Matcher(cs.id_patterns(needles), cfg)
    m.finalize()
    cm = m.cascade_model
    build_s = time.perf_counter() - t0

    docs = cs.make_corpus(1338, 128 * MIB // 8192, 8192, 1e-5, needles)
    total = sum(map(len, docs))
    handle = m.device_corpus(docs)
    res = m.match_arrays(handle)  # compile + settle capacities
    reps = 8
    dt, spread = _median(lambda: m.match_arrays_many([handle] * reps), 5)
    dt /= reps
    gbps = total / dt / 1e9

    t0 = time.perf_counter()
    pk = pack_documents(docs, m._pack_chunk_len(), m.automaton.max_len - 1,
                        row_align=m._row_align())
    pack_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    jax.block_until_ready(jnp.asarray(pk.chunks))
    upload_s = time.perf_counter() - t0
    cold_s, _ = _median(lambda: m.match_arrays(docs), 1)
    cold = {
        "pack_gbps": total / pack_s / 1e9,
        "upload_gbps": total / upload_s / 1e9,
        "cold_scan_gbps": total / cold_s / 1e9,
    }

    density_rows = {}
    for i, dens in enumerate((1e-5, 1e-3)):
        ddocs = cs.make_corpus(1339 + i, 64 * MIB // 8192, 8192, dens,
                               needles)
        n_plant = int(dens * 64 * MIB)
        if cm is not None:
            cm.seed_caps(2 * n_plant, 2 * n_plant)
        hd = m.device_corpus(ddocs)
        matches = int(m.match_arrays(hd)["doc"].shape[0])
        batches = [[hd] * 4 for _ in range(3)]
        t, ts = _median(lambda: list(m.match_arrays_stream(batches)), 3)
        density_rows[f"{dens:g}"] = {
            "gbps": 64 * MIB / (t / 12) / 1e9,
            "pass_ms": t / 12 * 1e3,
            "pass_ms_spread": [x / 12 * 1e3 for x in ts],
            "matches": matches,
        }
        del hd

    print(json.dumps({
        "metric": "scan_throughput_2048x16_needles",
        "value": gbps,
        "unit": "GB/s",
        "vs_baseline": gbps / REFERENCE_GBPS,
        "detail": {
            "corpus_mib": total / MIB,
            "pass_ms": dt * 1e3,
            "pass_ms_spread": [t / reps * 1e3 for t in spread],
            "public_api": "device_corpus + match_arrays_many",
            "build_s": build_s,
            "engine": m._pick_engine(total),
            "plan": cm.plan.reason if cm is not None else None,
            "matches": int(res["doc"].shape[0]),
            "cold_path": cold,
            "match_density": density_rows,
            "device": {"platform": dev.platform, "kind": dev.device_kind,
                       "count": len(jax.devices())},
            "card": cs.card_line(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
