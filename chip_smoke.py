#!/usr/bin/env python
"""Bring-up check on one NVIDIA GPU: the public matching path, end to end.

    python chip_smoke.py               # every phase, one GPU
    python chip_smoke.py --four-cards  # the sharded path on four GPUs only

Phases (each one raises on failure; nothing is caught and carried on):

1. device — refuses anything but a GPU; prints the card, its power limit
   and the compile cache directory;
2. surfaces — match / halo / match_many / find_all / UTF-8 / compat
   lifecycle / error split / CLI scan + replace / StreamScanner / replace,
   each compared with ``backend="host"``;
3. headline — the reference's own workload at resident-corpus scale:
   2048 needles x 16 bytes over ``abcdef``, a 128 MiB corpus of 8 KiB
   documents with needles planted at ~1e-5 per byte (resident
   ``match_arrays`` + ``match_arrays_many``, then the same documents fresh
   through ``match_many`` and ``match_arrays``), and a 64 MiB corpus at
   1e-3 per byte through ``match_arrays_stream``;
4. engines — every engine a user can force, at a few MiB each;
5. planner — re-measures the cascade planner's cost terms at the headline
   shapes (models/cascade.py ``_GATHER_S`` and friends).

Every result is compared EXACTLY with the C++ MultiFast-semantics oracle
(``native.oracle_scan``) as ``(doc, pos, start_postion, pattern)`` arrays.
The matcher is integer-only (no matmul, no float path), so TF32 and
summation order do not apply: the tolerance is zero.  Patterns and corpora
are generated from ``--seed``.

The last line of standard output is one JSON object naming the device;
it is printed only when every phase passed.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import random
import subprocess
import sys
import tempfile
import time
from typing import List, Sequence

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
MIB = 1 << 20
ALPHABET = b"abcdef"


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


# ----------------------------------------------------------------- device


def require_gpu():
    """The first JAX device, which must be a GPU (no CPU fallback)."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"chip_smoke: needs a GPU, JAX found {dev.platform!r} "
            f"({dev.device_kind})"
        )
    return dev


def card_line() -> str:
    """``name, power.limit`` of the first card from nvidia-smi (a child
    process that does not touch JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def phase_device(cache_dir: str):
    import jax

    dev = require_gpu()
    log("device", f"platform={dev.platform} kind={dev.device_kind} "
        f"count={len(jax.devices())} jax={jax.__version__}")
    log("device", f"nvidia-smi: {card_line()}")
    log("device", f"compile cache: {cache_dir}")
    return dev


# ----------------------------------------------------------- data + oracle


def make_needles(seed: int, n: int = 2048, length: int = 16,
                 alphabet: bytes = ALPHABET) -> List[bytes]:
    rng = random.Random(seed)
    out = set()
    while len(out) < n:
        out.add(bytes(rng.choice(alphabet) for _ in range(length)))
    return sorted(out)


def make_corpus(seed: int, n_docs: int, doc_len: int, density: float,
                needles: Sequence[bytes],
                alphabet: bytes = ALPHABET) -> List[bytes]:
    """``n_docs`` random documents over ``alphabet`` with needles planted
    at ``density`` per byte (generated in bulk with numpy)."""
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(alphabet, np.uint8)
    buf = alpha[rng.integers(0, alpha.size, n_docs * doc_len)]
    buf = buf.reshape(n_docs, doc_len)
    n_plant = int(density * n_docs * doc_len)
    if n_plant:
        width = max(map(len, needles))
        table = np.zeros((len(needles), width), np.uint8)
        lens = np.array([len(p) for p in needles])
        for i, p in enumerate(needles):
            table[i, : len(p)] = np.frombuffer(p, np.uint8)
        pi = rng.integers(0, len(needles), n_plant)
        di = rng.integers(0, n_docs, n_plant)
        off = rng.integers(0, doc_len - width, n_plant)
        for ln in np.unique(lens[pi]):
            sel = lens[pi] == ln
            cols = off[sel][:, None] + np.arange(ln)[None, :]
            buf[di[sel][:, None], cols] = table[pi[sel], :ln]
    return [bytes(r) for r in buf]


def require_oracle():
    from php_aho_corasick_tpu import native

    if not native.available():
        raise SystemExit(
            "chip_smoke: the native oracle library did not build or load "
            "(make -C php_aho_corasick_tpu/native)"
        )
    return native


def oracle_arrays(auto, docs: Sequence[bytes]):
    """Reference ``(doc, pos, start_postion, pattern)`` arrays from the
    C++ oracle, one document at a time, in reference emission order."""
    from php_aho_corasick_tpu.ops.matches import csr_expand

    native = require_oracle()
    D, E, P = [], [], []
    for i, d in enumerate(docs):
        if not d:
            continue
        pos, st, _ = native.oracle_scan(auto, d)
        if pos.size:
            rec_of, pids = csr_expand(auto, st.astype(np.int64))
            D.append(np.full(pids.shape[0], i, np.int64))
            E.append(pos[rec_of].astype(np.int64) + 1)
            P.append(pids.astype(np.int64))
    if not D:
        z = np.zeros(0, np.int64)
        return z, z, z, z
    d, e, p = np.concatenate(D), np.concatenate(E), np.concatenate(P)
    return d, e, e - auto.pat_lens[p].astype(np.int64), p


def records_to_arrays(results: Sequence[Sequence[dict]]):
    """``match_many`` dicts -> arrays (patterns were added as
    ``{"id": i}``, so ``keyIdx`` is the accepted-pattern index)."""
    rows = [
        (i, r["pos"], r["start_postion"], r["keyIdx"])
        for i, recs in enumerate(results)
        for r in recs
    ]
    a = np.asarray(rows, np.int64).reshape(-1, 4)
    return a[:, 0], a[:, 1], a[:, 2], a[:, 3]


def assert_exact(name: str, got, ref) -> int:
    """Exact equality of ``(doc, pos, start_postion, pattern)``."""
    if isinstance(got, dict):
        got = (got["doc"], got["pos"], got["start_postion"], got["pattern"])
    for key, g, r in zip(("doc", "pos", "start_postion", "pattern"),
                         got, ref):
        g, r = np.asarray(g, np.int64), np.asarray(r, np.int64)
        if g.shape != r.shape or not np.array_equal(g, r):
            raise AssertionError(
                f"{name}: {key} differs from the oracle "
                f"({g.shape[0]} vs {r.shape[0]} records)"
            )
    return int(np.asarray(ref[0]).shape[0])


def id_patterns(needles: Sequence[bytes]):
    return [{"id": i, "value": p} for i, p in enumerate(needles)]


# --------------------------------------------------------------- surfaces


def phase_surfaces(seed: int, doc_bytes: int = 200_000) -> None:
    from php_aho_corasick_tpu import (
        AhoError, AhoWarning, Matcher, ScanConfig, ahocorasick_deinit,
        ahocorasick_finalize, ahocorasick_init, ahocorasick_isValid,
        ahocorasick_match,
    )
    from php_aho_corasick_tpu.__main__ import main as cli_main

    dev_cfg = ScanConfig(backend="device")
    c = Matcher([{"key": "ab", "value": "alfa"}, {"value": "lfa"}], dev_cfg)
    r = c.match("...alfa...")
    assert r == [
        {"pos": 7, "key": "ab", "start_postion": 3, "value": "alfa"},
        {"pos": 7, "start_postion": 4, "value": "lfa"},
    ], r
    long = c.match("x" * 100_000 + "alfa")  # chunked rows + halo
    assert [x["pos"] for x in long] == [100_004, 100_004], long
    many = c.match_many(["alfa", "no", "xxlfa"])
    assert [len(x) for x in many] == [2, 0, 1], many
    fa = c.match("alfa lfa", find_all=False)
    assert fa and all(x["pos"] == 4 for x in fa), fa
    u = Matcher([{"value": "中文"}], dev_cfg).match("a中文b")
    assert u[0]["pos"] == 7 and u[0]["start_postion"] == 1, u
    log("surfaces", "match / halo / match_many / find_all / UTF-8 ok")

    # compat lifecycle and the AhoError / warning split
    h = ahocorasick_init([{"key": "k", "value": "v"}])
    assert ahocorasick_match("avb", h) and ahocorasick_isValid(h)
    assert ahocorasick_deinit(h) and not ahocorasick_isValid(h)
    try:
        Matcher([{"id": "notanint", "value": "x"}])
    except AhoError:
        pass
    else:
        raise AssertionError("a bad pattern id must raise AhoError")
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert ahocorasick_finalize("not a matcher") is False
    assert any(issubclass(w.category, AhoWarning) for w in caught)
    st = Matcher(["dup", "dup"])
    assert [s.name for s in st._statuses] == [
        "SUCCESS", "DUPLICATE_PATTERN"
    ]
    log("surfaces", "compat lifecycle + AhoError/warning split ok")

    # sampled cascade on the device vs the host scalar scanner
    rng = random.Random(seed)
    needles = sorted({
        bytes(rng.choice(ALPHABET) for _ in range(16)) for _ in range(256)
    })
    pats = id_patterns(needles)
    doc = bytearray(rng.choice(ALPHABET) for _ in range(doc_bytes))
    doc[777:793] = needles[42]
    doc[doc_bytes - 50_000:doc_bytes - 49_984] = needles[7]
    doc = bytes(doc)
    m = Matcher(pats, ScanConfig(backend="device", engine="cascade",
                                 auto_shard=False))
    host = Matcher(pats, ScanConfig(backend="host"))
    recs = m.match(doc)
    assert recs == host.match(doc), "cascade vs host"
    assert any(r["keyIdx"] == 42 and r["pos"] == 793 for r in recs)

    # stream and replace, device vs host
    cuts = [0, 1000, 1001, 77_777, doc_bytes // 2, doc_bytes]
    got, want = [], []
    with m.stream() as s_dev, host.stream() as s_host:
        for lo, hi in zip(cuts, cuts[1:]):
            got += s_dev.feed(doc[lo:hi])
            want += s_host.feed(doc[lo:hi])
    assert got == want and got, "StreamScanner device vs host"
    repl = {needles[42]: b"<A>", needles[7]: b"<BB>",
            needles[42][4:]: b"-"}
    rm = Matcher(list(repl), ScanConfig(backend="device", auto_shard=False))
    rh = Matcher(list(repl), ScanConfig(backend="host"))
    for mode in ("normal", "lazy"):
        assert rm.replace(doc, repl, mode) == rh.replace(doc, repl, mode), (
            f"replace {mode}"
        )
    log("surfaces", f"cascade {len(recs)} records, stream, replace "
        "normal + lazy == host")

    # the CLI, in-process
    with tempfile.TemporaryDirectory() as tmp:
        pfile = os.path.join(tmp, "patterns.txt")
        rfile = os.path.join(tmp, "repl.tsv")
        ifile = os.path.join(tmp, "input.bin")
        with open(pfile, "wb") as f:
            f.write(b"\n".join(needles[:64]) + b"\n")
        with open(rfile, "wb") as f:
            f.write(b"".join(p + b"\t#" + b"\n" for p in needles[:8]))
        with open(ifile, "wb") as f:
            f.write(doc)
        outs = {}
        for backend in ("device", "host"):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf), \
                    contextlib.redirect_stderr(io.StringIO()):
                rc = cli_main(["scan", "-p", pfile, "-i", ifile,
                               "--backend", backend])
            assert rc == 0
            ofile = os.path.join(tmp, f"out_{backend}.bin")
            with contextlib.redirect_stderr(io.StringIO()):
                rc = cli_main(["replace", "-p", pfile, "-r", rfile,
                               "-i", ifile, "-o", ofile,
                               "--backend", backend])
            assert rc == 0
            with open(ofile, "rb") as f:
                outs[backend] = (buf.getvalue(), f.read())
        assert outs["device"] == outs["host"], "CLI device vs host"
        n_cli = outs["host"][0].count("\n")
    log("surfaces", f"CLI scan ({n_cli} lines) + replace == host")


# --------------------------------------------------------------- headline


def _plan_line(m, handle) -> str:
    cm = m.cascade_model
    if cm is None:
        return "no cascade plan"
    path = (
        "grouped take" if cm.grouped_path(handle.chunks_d.shape[1])
        else "flat take"
    )
    return (
        f"mode={cm.plan.mode} q={cm.plan.q} stride={cm.plan.stride} "
        f"probes={len(cm.plan.sampled_salts)} filter={path}"
    )


def _record_chain_memory(m, handle) -> str:
    """``memory_analysis()`` of the compiled filter and record-verify
    executables of the headline chain."""
    import jax.numpy as jnp

    from php_aho_corasick_tpu.ops import filter_jax as fj

    cm = m.cascade_model
    p = cm.plan
    dev = cm.device_arrays
    dd = cm.dense_model.device_arrays
    cap_a, cap_r = cm.learned_caps
    chunks, lengths = handle.chunks_d, handle.lengths_d
    if cm.grouped_path(chunks.shape[1]):
        filt = fj.filter_hits_sampled_grouped.lower(
            dev["sampled_words"], chunks, lengths, dev["min_long_len"],
            q=p.q, stride=p.stride, log2_words=p.log2_words,
            salts=p.sampled_salts, shorts=p.shorts, capacity=cap_a,
            cap_coarse=cm._cap_coarse, prefix_words=dev.get("prefix_words"),
            prefix_salts=p.prefix_salts, prefix_log2=p.prefix_log2,
            prefix_len=p.prefix_len, block_r=cm.take_group_block_r(),
            words2=dev.get("sampled_words2"),
            wc=handle.packed_words(cm),
        )
    else:
        filt = fj.filter_hits_sampled.lower(
            dev["sampled_words"], chunks, lengths, dev["min_long_len"],
            q=p.q, stride=p.stride, log2_words=p.log2_words,
            salts=p.sampled_salts, shorts=p.shorts, capacity=cap_a,
        )
    idx = jnp.zeros((cap_a,), jnp.int32)
    ver = fj.verify_windows_records.lower(
        dd["table_flat"], dev["byte_class"], dev["used_bytes"], chunks,
        lengths, handle.emit_from_d, idx, dd["final_start"],
        n_classes=m.automaton.n_classes, stride=p.stride,
        win_len=cm.win_len, capacity=cap_r, n_hits=cap_a,
    )
    parts = []
    for name, lowered in (("filter", filt), ("verify", ver)):
        ma = lowered.compile().memory_analysis()
        parts.append(
            f"{name}: temp={getattr(ma, 'temp_size_in_bytes', '?')} "
            f"args={getattr(ma, 'argument_size_in_bytes', '?')} "
            f"out={getattr(ma, 'output_size_in_bytes', '?')}"
        )
    return "; ".join(parts)


def headline_matcher(needles, config=None):
    from php_aho_corasick_tpu import Matcher, ScanConfig

    cfg = config or ScanConfig(backend="device", chunk_len=4096)
    t0 = time.perf_counter()
    m = Matcher(id_patterns(needles), cfg)
    m.finalize()
    _ = m.cascade_model
    return m, time.perf_counter() - t0


def phase_headline(seed: int, resident_bytes: int = 128 * MIB,
                   stream_bytes: int = 64 * MIB, doc_len: int = 8192,
                   n_many: int = 4, config=None) -> dict:
    """Resident, fresh and streamed serving of the headline deployment,
    each compared exactly with the oracle.  Returns the matcher, handle
    and timings for the planner phase."""
    import jax

    needles = make_needles(seed)
    m, build_s = headline_matcher(needles, config)
    log("headline", f"build {build_s:.3f} s (set-up): "
        f"{m.automaton.n_states} states")

    t0 = time.perf_counter()
    docs = make_corpus(seed + 1, resident_bytes // doc_len, doc_len, 1e-5,
                       needles)
    ref = oracle_arrays(m.automaton, docs)
    log("headline", f"corpus {sum(map(len, docs)) / MIB:.0f} MiB, oracle "
        f"{ref[0].shape[0]} matches ({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    handle = m.device_corpus(docs, shard=False)
    r = m.match_arrays(handle)
    first_s = time.perf_counter() - t0
    n = assert_exact("resident match_arrays", r, ref)
    log("headline", f"engine={m._pick_engine(handle.total_bytes)} "
        f"{_plan_line(m, handle)}")
    log("headline", f"resident match_arrays exact ({n} records); upload + "
        f"first scan incl. compile {first_s:.2f} s (set-up)")
    outs = m.match_arrays_many([handle] * n_many)
    for o in outs:
        assert_exact("resident match_arrays_many", o, ref)
    t0 = time.perf_counter()
    m.match_arrays_many([handle] * n_many)
    dt = (time.perf_counter() - t0) / n_many
    log("headline", f"match_arrays_many x{n_many} exact; one pass "
        f"{dt * 1e3:.2f} ms (bring-up timing, not a benchmark)")
    if m.cascade_model is not None:
        log("headline", f"record chain memory: "
            f"{_record_chain_memory(m, handle)}")

    t0 = time.perf_counter()
    fresh = m.match_many(docs)
    assert_exact("fresh match_many", records_to_arrays(fresh), ref)
    fresh_many_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    assert_exact("fresh match_arrays", m.match_arrays(docs), ref)
    log("headline", f"fresh match_many exact ({fresh_many_s:.2f} s), fresh "
        f"match_arrays exact ({time.perf_counter() - t0:.2f} s), "
        f"path={m.stats.last_engine}")

    sdocs = make_corpus(seed + 2, stream_bytes // doc_len, doc_len, 1e-3,
                        needles)
    sref = oracle_arrays(m.automaton, sdocs)
    if m.cascade_model is not None:
        m.cascade_model.seed_caps(2 * sref[0].shape[0], 2 * sref[0].shape[0])
    shandle = m.device_corpus(sdocs, shard=False)
    batches = [[shandle], [shandle, shandle]]
    n_batches = 0
    for res in m.match_arrays_stream(batches):
        for o in res:
            assert_exact("match_arrays_stream 1e-3", o, sref)
        n_batches += 1
    assert n_batches == len(batches)
    log("headline", f"match_arrays_stream {stream_bytes / MIB:.0f} MiB at "
        f"1e-3: exact ({sref[0].shape[0]} records per pass)")
    stats = jax.devices()[0].memory_stats() or {}
    log("headline", f"peak_bytes_in_use={stats.get('peak_bytes_in_use')}")
    return {"matcher": m, "handle": handle, "needles": needles}


# ---------------------------------------------------------------- engines


@contextlib.contextmanager
def aligned_strides():
    """Make the cascade planner prefer cell-aligned strides (a multiple of
    4), which the grouped take filter needs.  With the measured cost terms
    the planner may choose none at a given shape; this reaches the grouped
    path anyway so it stays checked."""
    from php_aho_corasick_tpu.models import cascade as cmod

    saved = cmod._CODES_GENERAL_S
    cmod._CODES_GENERAL_S = 1.0
    try:
        yield
    finally:
        cmod._CODES_GENERAL_S = saved


def phase_engines(seed: int, n_bytes: int = 4 * MIB,
                  doc_len: int = 8192) -> None:
    """Every engine a user can force, against the oracle."""
    from php_aho_corasick_tpu import Matcher, ScanConfig

    n_docs = max(1, n_bytes // doc_len)
    base = dict(backend="device", auto_shard=False, chunk_len=4096)
    needles = make_needles(seed + 7, n=512)
    docs = make_corpus(seed + 8, n_docs, doc_len, 2e-4, needles)
    dense = Matcher(id_patterns(needles), ScanConfig(**base))
    ref = oracle_arrays(dense.automaton, docs)

    def check(name, cfg, pats=needles, corpus=docs, reference=ref,
              grouped=None):
        with aligned_strides() if grouped else contextlib.nullcontext():
            m = Matcher(id_patterns(pats), cfg)
            cm = m.cascade_model  # plans inside the context
        if grouped is False:
            cm._force_take = True
        got = m.match_arrays(corpus)
        n = assert_exact(name, got, reference)
        if grouped is not None:
            L = m.device_corpus(corpus[:1], shard=False).chunks_d.shape[1]
            assert cm.grouped_path(L) == grouped, name
            name += f" ({cm.plan.reason})"
        engine = m._pick_engine(sum(map(len, corpus)))
        log("engines", f"{name}: exact ({n} records, engine={engine}, "
            f"table={m.table_format})")

    check("engine=dfa", ScanConfig(engine="dfa", **base))
    check("engine=kgram", ScanConfig(engine="kgram", **base))
    casc = ScanConfig(engine="cascade", cascade_mode="sampled", **base)
    check("cascade sampled, grouped take", casc, grouped=True)
    check("cascade sampled, flat take", casc, grouped=False)
    check("cascade anchored",
          ScanConfig(engine="cascade", cascade_mode="anchored", **base))
    check("compressed dfa",
          ScanConfig(engine="dfa", table_format="compressed", **base))
    check("compressed cascade",
          ScanConfig(engine="cascade", table_format="compressed", **base))

    # more short patterns than cascade_max_shorts: no cascade plan, so
    # engine="auto" picks the k-gram or the dense walk
    rng = random.Random(seed + 10)
    small = sorted({bytes(rng.choice(b"abcdefghij") for _ in range(2))
                    for _ in range(40)})[:20] + [b"abcab", b"jihgfedcba"]
    sdocs = make_corpus(seed + 10, n_docs, doc_len, 1e-4, small,
                        alphabet=bytes(range(97, 123)))
    sm = Matcher(id_patterns(small), ScanConfig(**base))
    S, C = sm.automaton.table.shape
    assert S * C <= 4096 and sm.cascade_model is None, (S, C)
    engine = sm._pick_engine(n_docs * doc_len)
    assert engine in ("dfa", "kgram"), engine
    check(f"small automaton S*C={S * C} engine=auto ({engine})",
          ScanConfig(**base), small, sdocs,
          oracle_arrays(sm.automaton, sdocs))


# ---------------------------------------------------------------- planner


def _median_time(fn, reps: int = 5) -> float:
    fn()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[len(ts) // 2]


def phase_planner(m, handle, n_cand: int = 200_000, n_hits: int = 100_000,
                  n_slots: int = 65536) -> dict:
    """Re-measure the cascade planner's cost terms at the headline shapes
    (models/cascade.py): seconds per bloom probe, per compacted grid cell,
    per window-verify step, per host-verified grid hit, and per byte of
    gram-code assembly (word planes and the general reshape path)."""
    import jax
    import jax.numpy as jnp

    from php_aho_corasick_tpu.models import cascade as cmod
    from php_aho_corasick_tpu.ops.filter_jax import (
        KNUTH, sampled_gram_codes, sampled_gram_codes_planes,
        verify_windows_records,
    )
    from php_aho_corasick_tpu.ops.scan_jax import blocked_nonzero

    cm = m.cascade_model
    p = cm.plan
    q = p.q
    # the word-plane path needs a cell-aligned stride; measure both code
    # paths at the nearest such stride when the plan's is not
    s = p.stride if p.stride % 4 == 0 else 8
    chunks = handle.chunks_d
    B, L = chunks.shape
    if L % s:
        L = L - L % s
        chunks = chunks[:, :L]
    M = L // s
    out = {}
    planes = jax.jit(sampled_gram_codes_planes, static_argnums=(1, 2))
    general = jax.jit(sampled_gram_codes, static_argnums=(1, 2))
    out["codes_aligned_s"] = _median_time(
        lambda: planes(chunks, q, s).block_until_ready()) / (B * L)
    out["codes_general_s"] = _median_time(
        lambda: general(chunks, q, s).block_until_ready()) / (B * L)
    code = general(chunks, q, s)
    words = cm.device_arrays["sampled_words"]
    shift = 32 - p.log2_words

    @jax.jit
    def probe(words, code):
        h = (code.astype(jnp.uint32) ^ jnp.uint32(p.sampled_salts[0])) \
            * jnp.uint32(KNUTH)
        return jnp.take(words, (h >> jnp.uint32(shift)).astype(jnp.int32))

    out["gather_s"] = _median_time(
        lambda: probe(words, code).block_until_ready()) / (B * M)
    mask = jnp.asarray(np.random.default_rng(1).random(B * M) < 1e-4)
    bn = jax.jit(blocked_nonzero, static_argnums=(1,))
    out["compact_s"] = _median_time(
        lambda: jax.block_until_ready(bn(mask, 4096))) / (B * M)
    rng = np.random.default_rng(2)
    H = min(n_slots, B * M)
    gidx = jnp.asarray(
        np.sort(rng.choice(B * M, H, replace=False)).astype(np.int32)
    )
    dd = cm.dense_model.device_arrays
    dev = cm.device_arrays
    hl = handle.lengths_d
    he = handle.emit_from_d
    hc = handle.chunks_d
    Mh = -(-hc.shape[1] // p.stride)
    gidx = jnp.minimum(gidx, B * Mh - 1)
    out["window_step_s"] = _median_time(
        lambda: jax.block_until_ready(verify_windows_records(
            dd["table_flat"], dev["byte_class"], dev["used_bytes"], hc,
            hl, he, gidx, dd["final_start"],
            n_classes=m.automaton.n_classes, stride=p.stride,
            win_len=cm.win_len, capacity=4096, n_hits=H,
        ))) / (H * cm.win_len)
    packed = handle.packed
    nh = min(n_hits, B * Mh)
    g = np.sort(rng.choice(B * Mh, nh, replace=False)).astype(np.int32)
    lw = (np.int64(1) << rng.integers(0, p.stride, nh)).astype(np.int32)
    gd, lwd, swd = (jnp.asarray(x) for x in (g, lw, np.zeros_like(lw)))

    def host_path():
        a, b, c = np.asarray(gd), np.asarray(lwd), np.asarray(swd)
        st, k = cm.expand_hits(a, b, c, nh, packed.row_len, packed.lengths)
        cm.verify_arrays(packed, st, k)

    out["host_hit_s"] = _median_time(host_path, reps=3) / nh
    in_code = {
        "gather_s": cmod._GATHER_S, "compact_s": cmod._COMPACT_S,
        "window_step_s": cmod._WINDOW_STEP_S, "host_hit_s": cmod._HOST_HIT_S,
        "codes_aligned_s": cmod._CODES_ALIGNED_S,
        "codes_general_s": cmod._CODES_GENERAL_S,
    }
    for k, v in out.items():
        log("planner", f"{k} = {v:.3e} s (in code: {in_code[k]:.1e})")
    return out


# ------------------------------------------------------------- four cards


def phase_four_cards(seed: int, n_cards: int = 4,
                     resident_bytes: int = 128 * MIB, doc_len: int = 8192,
                     dfa_bytes: int = 32 * MIB, config=None) -> None:
    """The sharded serving path over a 1-D data mesh of ``n_cards``
    devices against the same corpus on one device, in one process:
    resident ``match_arrays_many`` (sharded record chain) and the sharded
    DFA scan, with their psum/pmax statistics."""
    import jax
    import jax.numpy as jnp

    from php_aho_corasick_tpu import Matcher, ScanConfig
    from php_aho_corasick_tpu.parallel.shard_scan import (
        sharded_sampled_records,
        sharded_scan_compact,
    )

    devs = jax.devices()
    if len(devs) < n_cards:
        raise SystemExit(f"chip_smoke: needs {n_cards} devices, "
                         f"found {len(devs)}")
    cfg = config or ScanConfig(backend="device", chunk_len=4096)
    needles = make_needles(seed)
    docs = make_corpus(seed + 1, resident_bytes // doc_len, doc_len, 1e-5,
                       needles)
    sharded = Matcher(id_patterns(needles), cfg)
    single = Matcher(id_patterns(needles),
                     dataclasses.replace(cfg, auto_shard=False))
    ref = oracle_arrays(sharded.automaton, docs)

    hs = sharded.device_corpus(docs, shard=True)
    h1 = single.device_corpus(docs, shard=False)
    assert hs.mesh is not None and hs.mesh.devices.size == n_cards
    holders = {s.device for s in hs.chunks_d.addressable_shards
               if s.data.shape[0] > 0}
    assert len(holders) == n_cards, f"rows on {len(holders)} devices"
    log("four-cards", f"rows of {hs.chunks_d.shape} over "
        f"{len(holders)} devices: {sorted(str(d) for d in holders)}")

    many_s = sharded.match_arrays_many([hs, hs])
    many_1 = single.match_arrays_many([h1, h1])
    for o in many_s + many_1:
        assert_exact("four-card records", o, ref)
    log("four-cards", f"sharded match_arrays_many == one card == oracle "
        f"({ref[0].shape[0]} records)")

    cm_s, cm_1 = sharded.cascade_model, single.cascade_model
    cap_a = max(cm_1._cap_hits, cm_s._cap_hits, 4096)
    cap_r = max(cm_1._cap_flagged, cm_s._cap_flagged, 4096)
    _, _, nrs, gh, gr, _ = sharded_sampled_records(
        hs.mesh, cm_s, hs.chunks_d, hs.lengths_d, hs.emit_from_d,
        cap_a, cap_r,
    )
    _, _, n_d, nr_d, _ = cm_1.launch_device_records(
        h1.chunks_d, h1.lengths_d, h1.emit_from_d, cap_a * n_cards,
        cap_r * n_cards, wc=h1.packed_words(cm_1),
    )
    gh, gr, nrs = (np.asarray(x) for x in (gh, gr, nrs))
    n1, nr1 = int(n_d), int(nr_d)
    assert int(gr[0]) == nr1 == int(nrs.sum()), (gr, nr1, nrs)
    assert int(gh[0]) == n1, (gh, n1)
    assert int(gr[1]) == int(nrs.max()) and int(gh[1]) <= int(gh[0])
    log("four-cards", f"records psum={int(gr[0])} pmax={int(gr[1])} "
        f"per shard {nrs.tolist()}; hits psum={int(gh[0])} == one card")

    ddocs = docs[: dfa_bytes // doc_len]
    dref = oracle_arrays(sharded.automaton, ddocs)
    dcfg = dataclasses.replace(cfg, engine="dfa")
    dsh = Matcher(id_patterns(needles), dcfg)
    d1 = Matcher(id_patterns(needles),
                 dataclasses.replace(dcfg, auto_shard=False))
    hds = dsh.device_corpus(ddocs, shard=True)
    hd1 = d1.device_corpus(ddocs, shard=False)
    assert_exact("sharded dfa", dsh.match_arrays(hds), dref)
    assert_exact("one-card dfa", d1.match_arrays(hd1), dref)
    dev = dsh._sharded_dev_cache["dfa"]
    init = jax.device_put(
        jnp.zeros((hds.chunks_d.shape[0],), jnp.int32),
        hds.chunks_d.sharding,
    )
    cap = 1 << 16
    _, _, counts, gstats, _ = sharded_scan_compact(
        hds.mesh, dev, hds.chunks_d, init, hds.lengths_d, hds.emit_from_d,
        n_classes=dsh.automaton.n_classes, capacity=cap,
    )
    _, _, n_single, _ = d1.model.scan_compact_device(
        hd1.chunks_d, hd1.lengths_d, hd1.emit_from_d, None, cap * n_cards,
    )
    counts, gstats = np.asarray(counts), np.asarray(gstats)
    assert int(gstats[0]) == int(counts.sum()) == int(n_single), (
        gstats, counts, n_single)
    assert int(gstats[1]) == int(counts.max())
    log("four-cards", f"sharded dfa == one card == oracle "
        f"({dref[0].shape[0]} records); positions psum={int(gstats[0])} "
        f"pmax={int(gstats[1])} per shard {counts.tolist()}")


# ------------------------------------------------------------------- main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded path on four GPUs")
    ap.add_argument("--seed", type=int, default=1337)
    args = ap.parse_args(argv)

    import jax

    from php_aho_corasick_tpu.utils.compile_cache import enable_compile_cache

    cache_dir = enable_compile_cache(ROOT)
    dev = phase_device(cache_dir)
    require_oracle()
    t_all = time.perf_counter()
    if args.four_cards:
        phase_four_cards(args.seed)
    else:
        phase_surfaces(args.seed)
        head = phase_headline(args.seed)
        phase_engines(args.seed)
        phase_planner(head["matcher"], head["handle"])
    log("done", f"all phases passed in {time.perf_counter() - t_all:.1f} s")
    print(card_line(), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": dev.platform,
            "kind": dev.device_kind,
            "count": len(jax.devices()),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
