"""k-gram super-transition engine: table composition and end-to-end parity
with the 1-gram engine and the brute-force oracle."""

import random

import numpy as np
import pytest

from php_aho_corasick_tpu import Matcher, ScanConfig
from php_aho_corasick_tpu.core import TrieBuilder, compile_trie
from php_aho_corasick_tpu.models.kgram_dfa import (
    build_kgram_table,
    pick_k,
)
from php_aho_corasick_tpu.ops.scan_jax import KGRAM_MID_FLAG, KGRAM_STATE_MASK


def build(patterns):
    t = TrieBuilder()
    lens = []
    for p in patterns:
        t.add(p)
        lens.append(len(p))
    return compile_trie(t, lens)


def brute_force(patterns, text):
    out = []
    for pid, p in enumerate(patterns):
        start = text.find(p)
        while start != -1:
            out.append((start + len(p), -len(p), pid))
            start = text.find(p, start + 1)
    out.sort()
    return [(pos, pid) for pos, _, pid in out]


def test_kgram_table_matches_stepwise_walk():
    auto = build([b"he", b"she", b"his", b"hers"])
    for k in (2, 4):
        kt = build_kgram_table(auto, k).reshape(auto.n_states, -1)
        C = auto.n_classes
        rng = random.Random(0)
        for _ in range(200):
            s0 = rng.randrange(auto.n_states)
            cls = [rng.randrange(C) for _ in range(k)]
            code = 0
            for c in cls:
                code = code * C + c
            entry = int(kt[s0, code])
            # stepwise reference walk
            s = s0
            mid = False
            for j, c in enumerate(cls):
                s = int(auto.table[s, c])
                if j < k - 1 and s >= auto.final_start:
                    mid = True
            assert entry & KGRAM_STATE_MASK == s
            assert bool(entry & KGRAM_MID_FLAG) == mid


def test_pick_k_budget():
    auto = build([b"ab", b"cd"])  # tiny: S ~ 5, C = 5
    assert pick_k(auto, 1 << 30) == 8
    assert pick_k(auto, 0) == 1


@pytest.mark.parametrize("seed", range(6))
def test_kgram_engine_parity(seed):
    rng = random.Random(seed)
    alphabet = b"abcd"
    patterns = list({
        bytes(rng.choice(alphabet) for _ in range(rng.randint(1, 9)))
        for _ in range(rng.randint(1, 30))
    })
    text = bytes(rng.choice(alphabet) for _ in range(4000))
    pats = [{"id": i, "value": p} for i, p in enumerate(patterns)]
    kg = Matcher(
        pats,
        ScanConfig(backend="device", engine="kgram", auto_shard=False,
                   chunk_len=512, match_capacity=16),
    ).match(text)
    got = [(r["pos"], r["keyIdx"]) for r in kg]
    assert got == brute_force(patterns, text)


def test_kgram_sharded_parity():
    rng = random.Random(7)
    patterns = [b"abca", b"ca", b"aaa", b"b"]
    docs = [bytes(rng.choice(b"abc") for _ in range(6000)) for _ in range(6)]
    pats = [{"id": i, "value": p} for i, p in enumerate(patterns)]
    res = Matcher(
        pats,
        ScanConfig(backend="device", engine="kgram", auto_shard=True,
                   chunk_len=512, match_capacity=64),
    ).match_many(docs)
    for doc, recs in zip(docs, res):
        assert [(r["pos"], r["keyIdx"]) for r in recs] == brute_force(patterns, doc)


def test_kgram_dense_match_capacity_retry():
    res = Matcher(
        ["a"],
        ScanConfig(backend="device", engine="kgram", auto_shard=False,
                   match_capacity=2),
    ).match(b"a" * 3000)
    assert len(res) == 3000


def test_auto_engine_thresholds():
    cfg = ScanConfig(backend="device", kgram_min_bytes=100)
    m = Matcher(["abc", "bc"], cfg)
    m.finalize()
    assert m._pick_engine(50) == "dfa"
    assert m._pick_engine(1000) == "kgram"
    # a bigger automaton (cascade-ineligible via shorts)
    import random

    rng = random.Random(0)
    alphabet = bytes(range(97, 123))
    pats = list({
        bytes(rng.choice(alphabet) for _ in range(rng.randint(2, 3)))
        for _ in range(1500)
    })
    m2 = Matcher([{"value": p} for p in pats], cfg)
    m2.finalize()
    assert m2._pick_engine(1000) == "kgram"
