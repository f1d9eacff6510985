"""Public device-resident corpus handles (VERDICT r3 #3).

A ``DeviceCorpus`` pays pack + upload once; every match call against it
must equal the upload-per-call public paths exactly.
"""

import random

import numpy as np
import pytest

from php_aho_corasick_tpu import AhoError, DeviceCorpus, Matcher, ScanConfig


def _mk_docs(seed=5, n=6, size=4000):
    rng = random.Random(seed)
    patterns = [b"gammagammagam", b"aggregateagg!", b"magmamagmamag"]
    docs = []
    for _ in range(n):
        d = bytearray(rng.choice(b"agmert!") for _ in range(size))
        for _ in range(4):
            p = rng.choice(patterns)
            pos = rng.randrange(0, len(d) - len(p))
            d[pos : pos + len(p)] = p
        docs.append(bytes(d))
    return patterns, docs


@pytest.mark.parametrize("engine", ["cascade", "kgram", "dfa"])
def test_handle_match_many_parity(engine):
    patterns, docs = _mk_docs()
    cfg = ScanConfig(backend="device", engine=engine, auto_shard=False,
                     chunk_len=512)
    m = Matcher([{"id": i, "value": p} for i, p in enumerate(patterns)],
                cfg)
    expect = m.match_many(docs)
    h = m.device_corpus(docs)
    assert isinstance(h, DeviceCorpus)
    got = m.match_many(h)
    assert got == expect
    # the handle is reusable: a second scan sees identical results
    assert m.match_many(h) == expect


def test_handle_match_arrays_parity():
    patterns, docs = _mk_docs(seed=9)
    cfg = ScanConfig(backend="device", engine="cascade", auto_shard=False,
                     chunk_len=512)
    m = Matcher([{"id": i, "value": p} for i, p in enumerate(patterns)],
                cfg)
    expect = m.match_arrays(docs)
    h = m.device_corpus(docs)
    got = m.match_arrays(h)
    for k in ("doc", "pos", "start_postion", "pattern"):
        np.testing.assert_array_equal(got[k], expect[k])


def test_handle_find_all_false():
    patterns, docs = _mk_docs(seed=3)
    cfg = ScanConfig(backend="device", engine="cascade", auto_shard=False,
                     chunk_len=512)
    m = Matcher([{"id": i, "value": p} for i, p in enumerate(patterns)],
                cfg)
    h = m.device_corpus(docs)
    assert m.match_many(h, find_all=False) == m.match_many(
        docs, find_all=False
    )
    got = m.match_arrays(h, find_all=False)
    expect = m.match_arrays(docs, find_all=False)
    for k in ("doc", "pos", "start_postion", "pattern"):
        np.testing.assert_array_equal(got[k], expect[k])


def test_match_arrays_many_pipelined():
    patterns, docs1 = _mk_docs(seed=11)
    _, docs2 = _mk_docs(seed=12)
    cfg = ScanConfig(backend="device", engine="cascade", auto_shard=False,
                     chunk_len=512)
    m = Matcher([{"id": i, "value": p} for i, p in enumerate(patterns)],
                cfg)
    h1, h2 = m.device_corpus(docs1), m.device_corpus(docs2)
    # force the pipelined batch to overflow its speculative capacities so
    # the per-handle retry path is exercised too
    cm = m.cascade_model
    if cm is not None:
        cm._cap_hits = 256
        cm._cap_flagged = 256
    got = m.match_arrays_many([h1, h2])
    exp = [m.match_arrays(docs1), m.match_arrays(docs2)]
    for g, e in zip(got, exp):
        for k in ("doc", "pos", "start_postion", "pattern"):
            np.testing.assert_array_equal(g[k], e[k])


def test_handle_size_limit():
    cfg = ScanConfig(backend="device", max_launch_bytes=1024)
    m = Matcher([b"abcabcabcabc"], cfg)
    with pytest.raises(AhoError):
        m.device_corpus([b"x" * 4096])


def test_records_fallback_counter():
    """match_arrays_many off the records fast path must count + name the
    fallback (VERDICT r4 weak #3) while staying exact."""
    rng = random.Random(31)
    # 47-byte patterns: win_len = stride-1+47 > 31 => records gate fails
    patterns = [
        bytes(rng.choice(b"abcdef") for _ in range(47)) for _ in range(6)
    ]
    docs = []
    for _ in range(3):
        d = bytearray(rng.choice(b"abcdef") for _ in range(4000))
        p = rng.choice(patterns)
        d[100 : 100 + len(p)] = p
        docs.append(bytes(d))
    cfg = ScanConfig(backend="device", engine="cascade", auto_shard=False,
                     chunk_len=1024)
    m = Matcher([{"id": i, "value": p} for i, p in enumerate(patterns)],
                cfg)
    h = m.device_corpus(docs)
    assert m.stats.records_fallbacks == 0
    got = m.match_arrays_many([h])
    assert m.stats.records_fallbacks == 1
    assert m.stats.records_fallback_reason
    expect = m.match_arrays(docs)
    for k in ("doc", "pos", "start_postion", "pattern"):
        np.testing.assert_array_equal(got[0][k], expect[k])


def test_match_arrays_stream_parity():
    """match_arrays_stream (cross-batch double buffering) must yield
    exactly what per-batch match_arrays_many returns, for fast-path and
    fallback batches alike."""
    patterns, docs1 = _mk_docs(seed=41)
    _, docs2 = _mk_docs(seed=42)
    cfg = ScanConfig(backend="device", engine="cascade", auto_shard=False,
                     chunk_len=512)
    m = Matcher([{"id": i, "value": p} for i, p in enumerate(patterns)],
                cfg)
    h1, h2 = m.device_corpus(docs1), m.device_corpus(docs2)
    batches = [[h1, h2], [h2], [h1, h1, h2]]
    got = list(m.match_arrays_stream(batches))
    exp = [m.match_arrays_many(b) for b in batches]
    assert len(got) == len(exp)
    for gl, el in zip(got, exp):
        for g, e in zip(gl, el):
            for k in ("doc", "pos", "start_postion", "pattern"):
                np.testing.assert_array_equal(g[k], e[k])


def test_fresh_pipelined_parity():
    """The cold-corpus double-buffered pipeline (VERDICT r4 #5) must
    return exactly what the grouped launch path returns, including doc
    index globalization across slices and find_all=False."""
    patterns, _ = _mk_docs()
    rng = random.Random(71)
    docs = []
    for _ in range(40):
        d = bytearray(rng.choice(b"agmert!") for _ in range(3000))
        for _ in range(2):
            p = rng.choice(patterns)
            pos = rng.randrange(0, len(d) - len(p))
            d[pos : pos + len(p)] = p
        docs.append(bytes(d))
    cfg = ScanConfig(backend="device", engine="cascade", auto_shard=False,
                     chunk_len=512, fresh_slice_bytes=16 * 1024)
    m = Matcher([{"id": i, "value": p} for i, p in enumerate(patterns)],
                cfg)
    got = m.match_arrays(docs)
    assert m.stats.last_engine == "cascade-fresh", m.stats.last_engine
    cfg2 = ScanConfig(backend="device", engine="cascade", auto_shard=False,
                      chunk_len=512)  # default slice: pipeline inactive
    m2 = Matcher([{"id": i, "value": p} for i, p in enumerate(patterns)],
                 cfg2)
    expect = m2.match_arrays(docs)
    for k in ("doc", "pos", "start_postion", "pattern"):
        np.testing.assert_array_equal(got[k], expect[k])
    gf = m.match_arrays(docs, find_all=False)
    ef = m2.match_arrays(docs, find_all=False)
    for k in ("doc", "pos", "start_postion", "pattern"):
        np.testing.assert_array_equal(gf[k], ef[k])
