"""Device-scan correctness: chunking/halo, capacity retry, backend parity,
and randomized fuzz against an independent brute-force oracle."""

import random

import numpy as np
import pytest

from php_aho_corasick_tpu import Matcher, ScanConfig


def brute_force(patterns, text):
    """Independent oracle: all (end_pos, pattern) occurrences, reference
    order (ascending end, longer pattern first at equal end)."""
    out = []
    for pid, p in enumerate(patterns):
        start = text.find(p)
        while start != -1:
            out.append((start + len(p), -len(p), pid))
            start = text.find(p, start + 1)
    out.sort()
    return [(pos, pid) for pos, _, pid in out]


def matcher_pairs(recs):
    return [(r["pos"], r["_pid"]) for r in recs]


def run_match(patterns, text, config):
    c = Matcher([{"id": i, "value": p} for i, p in enumerate(patterns)], config)
    recs = c.match(text)
    return [(r["pos"], r["keyIdx"]) for r in recs]


@pytest.mark.parametrize("seed", range(8))
def test_fuzz_vs_brute_force(seed, backend):
    rng = random.Random(seed)
    alphabet = b"abcd"
    n_pats = rng.randint(1, 24)
    patterns = []
    seen = set()
    while len(patterns) < n_pats:
        L = rng.randint(1, 9)
        p = bytes(rng.choice(alphabet) for _ in range(L))
        if p not in seen:
            seen.add(p)
            patterns.append(p)
    text = bytes(rng.choice(alphabet) for _ in range(rng.randint(0, 3000)))
    cfg = ScanConfig(backend=backend, chunk_len=256, match_capacity=8)
    assert run_match(patterns, text, cfg) == brute_force(patterns, text)


def test_chunk_halo_exactness():
    # pattern spans every chunk boundary; chunked device scan must still
    # find each occurrence exactly once
    pat = b"wxyz"
    text = (b"." * 97 + pat) * 50
    cfg = ScanConfig(backend="device", chunk_len=64, match_capacity=4)
    got = run_match([pat], text, cfg)
    assert got == brute_force([pat], text)
    assert len(got) == 50


def test_halo_wider_than_chunk():
    # max_len-1 halo larger than chunk_len payload still correct
    pat = b"q" * 40
    text = b"q" * 200
    cfg = ScanConfig(backend="device", chunk_len=16)
    got = run_match([pat], text, cfg)
    assert got == brute_force([pat], text)
    assert len(got) == 200 - 40 + 1


def test_capacity_overflow_retry_is_exact():
    # every position matches; initial capacity 4 must grow, not truncate
    text = b"a" * 1000
    cfg = ScanConfig(backend="device", match_capacity=4)
    got = run_match([b"a"], text, cfg)
    assert len(got) == 1000
    assert got == brute_force([b"a"], text)


def test_match_many_batched(backend):
    cfg = ScanConfig(backend=backend)
    c = Matcher(["ab", "bc"], cfg)
    docs = ["xxabyy", "", "bcbcbc", "zzz", "ab"]
    res = c.match_many(docs)
    assert [len(r) for r in res] == [1, 0, 3, 0, 1]
    assert res[2][0]["pos"] == 2 and res[2][2]["pos"] == 6
    # identical to one-at-a-time
    for doc, r in zip(docs, res):
        assert c.match(doc) == r


def test_find_all_false_returns_first_position_group(backend):
    # at the first matching end position, ALL patterns of that position are
    # returned (the reference aborts only after the handler processed the
    # whole AC_MATCH_t, php_ahocorasick.c:588)
    cfg = ScanConfig(backend=backend)
    c = Matcher(["abcd", "cd", "zz"], cfg)
    recs = c.match("xxabcdzz", find_all=False)
    assert [r["value"] for r in recs] == ["abcd", "cd"]
    assert all(r["pos"] == 6 for r in recs)


def test_overlapping_and_nested(backend):
    cfg = ScanConfig(backend=backend)
    got = run_match([b"aaa", b"aa", b"a"], b"aaaa", cfg)
    assert got == brute_force([b"aaa", b"aa", b"a"], b"aaaa")


def test_binary_patterns_full_byte_range(backend):
    cfg = ScanConfig(backend=backend)
    pats = [bytes([0, 1, 255]), bytes([255, 255]), b"\x00"]
    text = bytes([0, 1, 255, 255, 255, 0])
    got = run_match(pats, text, cfg)
    assert got == brute_force(pats, text)


def test_long_doc_equals_unchunked(backend):
    rng = random.Random(123)
    patterns = [b"abcab", b"bca", b"cc", b"aaaa"]
    text = bytes(rng.choice(b"abc") for _ in range(20000))
    chunked = run_match(patterns, text, ScanConfig(backend=backend, chunk_len=512))
    assert chunked == brute_force(patterns, text)


def test_scan_host_matches_device_states():
    from php_aho_corasick_tpu.core import TrieBuilder, compile_trie
    from php_aho_corasick_tpu.models.dense_dfa import DenseDfaModel
    from php_aho_corasick_tpu.ops.scan_jax import scan_states

    import jax.numpy as jnp

    t = TrieBuilder()
    for p in [b"he", b"she", b"his", b"hers"]:
        t.add(p)
    auto = compile_trie(t, [2, 3, 3, 4])
    model = DenseDfaModel(auto, ScanConfig())
    data = np.frombuffer(b"ushershishehe", dtype=np.uint8)
    pos, sts, carry = model.scan_host(data)

    dev = model.device_arrays
    states, last = scan_states(
        dev["table_flat"],
        dev["byte_class"],
        dev["used_bytes"],
        jnp.asarray(data)[None, :],
        jnp.zeros((1,), jnp.int32),
        auto.n_classes,
    )
    states = np.asarray(states)[0]
    assert int(last[0]) == carry
    dev_final = np.nonzero(states >= auto.final_start)[0]
    assert (dev_final == pos).all()
    assert (states[dev_final] == sts).all()


def test_multi_launch_split_is_exact():
    from php_aho_corasick_tpu import ScanConfig as SC

    rng = random.Random(77)
    patterns = [b"abcab", b"bca"]
    docs = [bytes(rng.choice(b"abc") for _ in range(3000)) for _ in range(10)]
    pats = [{"id": i, "value": p} for i, p in enumerate(patterns)]
    # force many launches: 4 KB per launch over 30 KB of docs
    small = Matcher(pats, SC(backend="device", max_launch_bytes=4096)).match_many(docs)
    big = Matcher(pats, SC(backend="device")).match_many(docs)
    assert small == big


def test_match_many_empty_inputs(backend):
    c = Matcher(["ab"], ScanConfig(backend=backend))
    assert c.match_many([]) == []
    assert c.match_many(["", ""]) == [[], []]


def test_blocked_nonzero_matches_plain():
    """Two-level compaction must equal jnp.nonzero for any density."""
    import jax.numpy as jnp
    import numpy as np
    from php_aho_corasick_tpu.ops.scan_jax import INT32_MAX, blocked_nonzero

    rng = np.random.default_rng(3)
    for n, dens, cap in [(1000, 0.03, 64), (4096, 0.5, 4096),
                         (777, 0.0, 16), (513, 1.0, 1024), (8, 0.4, 8),
                         # n >> 16*cap: exercises the recursive block
                         # levels (one and two extra levels deep)
                         (100_000, 0.0005, 128), (2_000_000, 0.00002, 64),
                         (300_000, 0.0, 32)]:
        mask = rng.random(n) < dens
        idx, cnt = blocked_nonzero(jnp.asarray(mask), cap)
        idx, cnt = np.asarray(idx), int(cnt)
        want = np.nonzero(mask)[0]
        assert cnt == want.shape[0]
        if cnt <= cap:  # exact when within capacity
            np.testing.assert_array_equal(idx[:cnt], want)
            assert (idx[cnt:] == INT32_MAX).all()


def test_match_arrays_parity_with_dicts():
    """match_arrays output must be the columnar image of match_many."""
    import numpy as np

    from php_aho_corasick_tpu import Matcher, ScanConfig

    pats = [
        {"key": "ab", "value": "alfa"},
        {"value": "lfa"},
        {"id": 9, "value": "zz"},
    ]
    docs = [b"xxalfayyzz", b"", b"lfazzalfa"]
    m = Matcher(pats, ScanConfig(backend="device"))
    arr = m.match_arrays(docs)
    recs = m.match_many(docs)
    flat = [
        (d, r["pos"], r["start_postion"], r["value"])
        for d, rl in enumerate(recs)
        for r in rl
    ]
    vals = [p["value"].encode() if isinstance(p["value"], str) else p["value"]
            for p in pats]
    got = [
        (int(arr["doc"][i]), int(arr["pos"][i]),
         int(arr["start_postion"][i]), vals[int(arr["pattern"][i])])
        for i in range(arr["doc"].shape[0])
    ]
    want = [(d, p, s, v.encode() if isinstance(v, str) else v)
            for d, p, s, v in flat]
    assert got == want
    # find_all=False parity
    arr1 = m.match_arrays(docs, find_all=False)
    recs1 = m.match_many(docs, find_all=False)
    n1 = sum(map(len, recs1))
    assert arr1["doc"].shape[0] == n1


def test_match_arrays_host_path():
    from php_aho_corasick_tpu import Matcher, ScanConfig

    m = Matcher([{"id": 0, "value": "ab"}], ScanConfig(backend="host"))
    arr = m.match_arrays([b"abxab"])
    assert list(arr["pos"]) == [2, 5]
    assert list(arr["pattern"]) == [0, 0]


def test_match_arrays_host_forced_never_touches_device(monkeypatch):
    """backend="host" must route to the host scan at ANY corpus size
    (same contract as match_many) — a large group must NOT hit the
    device path."""
    from php_aho_corasick_tpu import Matcher, ScanConfig

    # tiny threshold so the group is "large"; host backend still forced
    m = Matcher(
        [{"id": 0, "value": "ab"}],
        ScanConfig(backend="host", host_scan_threshold=4),
    )
    m.finalize()

    def boom(*a, **k):  # device entry for _group_arrays' large-group path
        raise AssertionError("device scan reached despite backend='host'")

    monkeypatch.setattr(m, "_scan_device_arrays", boom)
    arr = m.match_arrays([b"abxab" * 100])
    assert arr["doc"].shape[0] == 200


def test_iter_matches_closed_matcher_raises_at_call_time():
    import pytest

    from php_aho_corasick_tpu import Matcher, StateError

    m = Matcher(["ab"])
    m.finalize()
    m.close()
    with pytest.raises(StateError):
        m.iter_matches("ab")  # must raise NOW, not at first next()
