"""Gram-filter cascade engine: planning, soundness, and exact parity."""

import random

import numpy as np
import pytest

from php_aho_corasick_tpu import Matcher, ScanConfig
from php_aho_corasick_tpu.models.cascade import plan_cascade


def brute_force(patterns, text):
    out = []
    for pid, p in enumerate(patterns):
        start = text.find(p)
        while start != -1:
            out.append((start + len(p), -len(p), pid))
            start = text.find(p, start + 1)
    out.sort()
    return [(pos, pid) for pos, _, pid in out]


@pytest.fixture
def aligned_planner(monkeypatch):
    """Make the planner prefer cell-aligned strides (a multiple of 4), the
    grouped take filter's gate; the measured cost terms may choose none
    at a test's small shapes."""
    from php_aho_corasick_tpu.models import cascade as cascmod

    monkeypatch.setattr(cascmod, "_CODES_GENERAL_S", 1.0)


def run_cascade(patterns, text, **cfg_kw):
    cfg = ScanConfig(backend="device", engine="cascade", auto_shard=False,
                     **cfg_kw)
    c = Matcher([{"id": i, "value": p} for i, p in enumerate(patterns)], cfg)
    return [(r["pos"], r["keyIdx"]) for r in c.match(text)]


# ------------------------------------------------------------- planning

def test_plan_basic():
    pats = [b"abcdefgh" * 2, b"longpattern!", b"tiny"]
    m = Matcher([{"value": p} for p in pats])
    plan = plan_cascade([p.value for p in m._patterns], m.automaton,
                        ScanConfig())
    assert plan.eligible
    assert plan.q == 4  # min long pattern length 4 ('tiny')
    assert 0 in plan.offsets
    assert plan.bloom_words.shape[0] == len(plan.offsets)


def test_plan_too_many_shorts():
    pats = [bytes([65 + i]) for i in range(20)]  # 20 single-byte patterns
    m = Matcher([{"value": p} for p in pats])
    plan = plan_cascade([p.value for p in m._patterns], m.automaton,
                        ScanConfig())
    assert not plan.eligible


def test_plan_saturated_bloom():
    m = Matcher(["abcdefgh"])
    plan = plan_cascade([b"abcdefgh"], m.automaton,
                        ScanConfig(cascade_log2_bloom_bits=4,
                                   cascade_max_fill=0.01,
                                   cascade_mode="anchored"))
    assert not plan.eligible


def test_plan_shorts_only():
    m = Matcher(["ab", "cd"])
    plan = plan_cascade([b"ab", b"cd"], m.automaton, ScanConfig())
    assert plan.eligible and plan.min_long_len == 0 and plan.shorts


# ------------------------------------------------------------- parity

@pytest.mark.parametrize("seed", range(8))
def test_cascade_parity_fuzz(seed):
    rng = random.Random(seed)
    alphabet = b"abcdef"
    n_long = rng.randint(1, 40)
    patterns = list({
        bytes(rng.choice(alphabet) for _ in range(rng.randint(5, 12)))
        for _ in range(n_long)
    })
    if rng.random() < 0.5:  # sometimes add short patterns
        patterns += list({
            bytes(rng.choice(alphabet) for _ in range(rng.randint(1, 3)))
            for _ in range(rng.randint(1, 5))
        })
    patterns = list(dict.fromkeys(patterns))
    text = bytearray(rng.choice(alphabet) for _ in range(6000))
    # plant some patterns to guarantee matches
    for _ in range(20):
        p = rng.choice(patterns)
        pos = rng.randrange(0, len(text) - len(p))
        text[pos : pos + len(p)] = p
    text = bytes(text)
    got = run_cascade(patterns, text, chunk_len=512, match_capacity=64)
    assert got == brute_force(patterns, text)


def test_cascade_equals_dfa_engine():
    rng = random.Random(42)
    patterns = [b"gamma", b"ammag", b"mm", b"aaaa"]
    text = bytes(rng.choice(b"agm") for _ in range(20000))
    pats = [{"id": i, "value": p} for i, p in enumerate(patterns)]
    cas = Matcher(pats, ScanConfig(backend="device", engine="cascade",
                                   auto_shard=False)).match(text)
    dfa = Matcher(pats, ScanConfig(backend="device", engine="dfa",
                                   auto_shard=False)).match(text)
    assert cas == dfa


def test_cascade_suffix_factors_and_order():
    # overlap + suffix-factor emission order: alfa then lfa at same end
    pats = ["alfa", "lfa", "beta"]
    got = run_cascade([p.encode() for p in pats], b"xxalfa beta!")
    assert got == [(6, 0), (6, 1), (11, 2)]


def test_cascade_chunk_halo():
    pat = b"wxyzwxyz"
    text = (b"." * 97 + pat) * 50
    got = run_cascade([pat], text, chunk_len=64, match_capacity=8)
    assert len(got) == 50
    assert got == brute_force([pat], text)


def test_cascade_capacity_retry_dense():
    # adversarial: every position passes (pattern 'aaaa' on 'aaaa...')
    text = b"a" * 3000
    got = run_cascade([b"aaaa"], text, match_capacity=4)
    assert len(got) == 3000 - 4 + 1


def test_cascade_shorts_exact():
    got = run_cascade([b"ab", b"b", b"longerpat"], b"abba longerpat!")
    assert got == brute_force([b"ab", b"b", b"longerpat"], b"abba longerpat!")


def test_cascade_take_bloom_impl_forced():
    rng = random.Random(3)
    patterns = [b"pattern!", b"needle12"]
    text = bytearray(rng.choice(b"patern!ledi12") for _ in range(3000))
    text[100:108] = b"pattern!"
    text[2000:2008] = b"needle12"
    text = bytes(text)
    got = run_cascade(patterns, text, bloom_impl="take")
    assert got == brute_force(patterns, text)


def test_auto_prefers_cascade_for_large_scans():
    cfg = ScanConfig(backend="device", cascade_min_bytes=1000)
    m = Matcher(["abcdefgh"], cfg)
    m.finalize()
    assert m._pick_engine(5000) == "cascade"
    assert m._pick_engine(100) == "dfa"


def test_forced_cascade_on_ineligible_raises():
    cfg = ScanConfig(backend="device", engine="cascade")
    m = Matcher([bytes([65 + i]) for i in range(20)], cfg)
    with pytest.raises(ValueError):
        m.match(b"AAAA" * 1000)


def test_cascade_sharded_parity():
    rng = random.Random(21)
    patterns = [b"gammagam", b"magma", b"aggregate"]
    docs = []
    for _ in range(6):
        d = bytearray(rng.choice(b"agmert") for _ in range(5000))
        for _ in range(5):
            p = rng.choice(patterns)
            pos = rng.randrange(0, len(d) - len(p))
            d[pos : pos + len(p)] = p
        docs.append(bytes(d))
    pats = [{"id": i, "value": p} for i, p in enumerate(patterns)]
    cfg = ScanConfig(backend="device", engine="cascade", auto_shard=True,
                     chunk_len=512, match_capacity=32)
    res = Matcher(pats, cfg).match_many(docs)
    for doc, recs in zip(docs, res):
        assert [(r["pos"], r["keyIdx"]) for r in recs] == brute_force(patterns, doc)


def test_cascade_shorts_only_plan_end_to_end():
    # no long patterns at all: blooms disabled, compare-select only
    got = run_cascade([b"ab", b"c"], b"zabcz ab c")
    assert got == brute_force([b"ab", b"c"], b"zabcz ab c")


# ------------------------------------------------- sampled (strided) mode

def test_expand_hits_matches_bruteforce():
    """Host expansion of grid-hit bitmask words must equal the definition:
    long bit j at grid point p = m*stride => start p - j (length-gated);
    short bit i => start p + i."""
    rng = random.Random(0)
    pats = [bytes(rng.choice(b"abcdef") for _ in range(16))
            for _ in range(32)]
    m = Matcher([{"value": p} for p in pats],
                ScanConfig(backend="device", engine="cascade"))
    cm = m.cascade_model
    s = cm.plan.stride
    min_long = cm.plan.min_long_len
    nprng = np.random.default_rng(5)
    B, L = 3, 103
    M = -(-L // s)
    lengths = np.asarray([L, 57, 0], np.int32)
    n_hits = 17
    grid = np.sort(
        nprng.choice(B * M, size=n_hits, replace=False)
    ).astype(np.int32)
    lw = nprng.integers(0, 1 << s, n_hits, dtype=np.int64)
    sw = nprng.integers(0, 1 << s, n_hits, dtype=np.int64)
    lw32 = (lw & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    sw32 = (sw & 0xFFFFFFFF).astype(np.uint32).view(np.int32)

    want = set()
    for g, w_l, w_s in zip(grid, lw, sw):
        b, mm = divmod(int(g), M)
        p = mm * s
        for j in range(s):
            if (int(w_l) >> j) & 1:
                t = p - j
                if t >= 0 and t + min_long <= lengths[b]:
                    want.add(b * L + t)
            if (int(w_s) >> j) & 1:
                want.add(b * L + p + j)
    got, n = cm.expand_hits(grid, lw32, sw32, n_hits, L, lengths)
    assert n == len(want)
    assert sorted(want) == got.tolist()


def test_sampled_gram_codes_match_host():
    import jax.numpy as jnp
    from php_aho_corasick_tpu.ops.filter_jax import (
        GRAM_BASE, sampled_gram_codes,
    )

    rng = np.random.default_rng(9)
    B, L, q, stride = 2, 77, 8, 5
    chunks = rng.integers(0, 256, (B, L), dtype=np.int64).astype(np.uint8)
    got = np.asarray(
        sampled_gram_codes(jnp.asarray(chunks), q, stride)
    ).astype(np.uint32)
    ext = np.concatenate([chunks, np.zeros((B, q), np.uint8)], axis=1)
    for b in range(B):
        for m in range(got.shape[1]):
            p = m * stride
            want = 0
            for t in range(q):
                want = (want * GRAM_BASE + int(ext[b, p + t])) & 0xFFFFFFFF
            assert got[b, m] == want, (b, m)


def test_sampled_gram_codes_planes_exact():
    """The cell-aligned word-plane formulation must produce bit-identical
    codes to the general reshape path wherever its alignment gate holds
    (stride % 4 == 0 and stride | L)."""
    import jax.numpy as jnp
    from php_aho_corasick_tpu.ops.filter_jax import (
        sampled_codes_best,
        sampled_gram_codes,
        sampled_gram_codes_planes,
    )

    rng = np.random.default_rng(31)
    for q, stride, B, L in [
        (9, 8, 3, 256),    # headline plan shape
        (8, 8, 2, 512),
        (8, 4, 2, 128),
        (5, 4, 4, 64),
        (13, 12, 2, 384),
        (9, 8, 1, 4096),   # full chunk row
    ]:
        chunks = rng.integers(0, 256, (B, L), dtype=np.int64).astype(np.uint8)
        ref = np.asarray(sampled_gram_codes(jnp.asarray(chunks), q, stride))
        got = np.asarray(
            sampled_gram_codes_planes(jnp.asarray(chunks), q, stride)
        )
        np.testing.assert_array_equal(got, ref, err_msg=f"q={q} s={stride}")
        best = np.asarray(sampled_codes_best(jnp.asarray(chunks), q, stride))
        np.testing.assert_array_equal(best, ref)
    # off-gate shapes must silently fall back
    chunks = rng.integers(0, 256, (2, 100), dtype=np.int64).astype(np.uint8)
    ref = np.asarray(sampled_gram_codes(jnp.asarray(chunks), 8, 9))
    best = np.asarray(sampled_codes_best(jnp.asarray(chunks), 8, 9))
    np.testing.assert_array_equal(best, ref)


def test_plan_picks_sampled_for_long_patterns():
    rng = random.Random(0)
    pats = [bytes(rng.choice(b"abcdef") for _ in range(16))
            for _ in range(64)]
    m = Matcher([{"value": p} for p in pats])
    plan = plan_cascade([p.value for p in m._patterns], m.automaton,
                        ScanConfig())
    assert plan.eligible and plan.mode == "sampled"
    assert plan.stride >= 2 and plan.q + plan.stride - 1 <= 16
    assert plan.sampled_words is not None


def test_forced_sampled_on_short_min_long_is_ineligible():
    # min_long == 4 => stride would be 1: no sampled configuration
    plan_m = Matcher(["tiny"])
    plan = plan_cascade([b"tiny"], plan_m.automaton,
                        ScanConfig(cascade_mode="sampled"))
    assert not plan.eligible


@pytest.mark.parametrize("seed", range(8))
def test_sampled_cascade_parity_fuzz(seed):
    rng = random.Random(1000 + seed)
    alphabet = b"abcdef"
    patterns = list({
        bytes(rng.choice(alphabet) for _ in range(rng.randint(9, 24)))
        for _ in range(rng.randint(1, 60))
    })
    if rng.random() < 0.5:  # mixed-in shorts stay exact via compare-select
        patterns += list({
            bytes(rng.choice(alphabet) for _ in range(rng.randint(1, 3)))
            for _ in range(rng.randint(1, 4))
        })
    patterns = list(dict.fromkeys(patterns))
    text = bytearray(rng.choice(alphabet) for _ in range(6000))
    for _ in range(25):
        p = rng.choice(patterns)
        pos = rng.randrange(0, len(text) - len(p))
        text[pos : pos + len(p)] = p
    text = bytes(text)
    got = run_cascade(patterns, text, chunk_len=512, match_capacity=64,
                      cascade_mode="sampled")
    assert got == brute_force(patterns, text)


def test_sampled_cascade_chunk_halo():
    pat = b"wxyzwxyzwxyz"
    text = (b"." * 93 + pat) * 40
    got = run_cascade([pat], text, chunk_len=64, match_capacity=8,
                      cascade_mode="sampled")
    assert len(got) == 40
    assert got == brute_force([pat], text)


def test_sampled_cascade_capacity_retry():
    # dense matches: an occurrence every 2 bytes forces repeated doubling
    pat = b"ab" * 6
    text = b"ab" * 1250
    got = run_cascade([pat], text, match_capacity=4,
                      cascade_mode="sampled")
    assert got == brute_force([pat], text)


def test_sampled_launch_device_pipelined():
    """bench.py's steady-state path: several filter->verify chains in
    flight with no intermediate fetch, occupancy scalars pulled once at
    the end; every chain must agree and emission must stay exact."""
    import jax.numpy as jnp

    from php_aho_corasick_tpu.ops.matches import pack_documents

    rng = random.Random(7)
    alphabet = b"abcdef"
    patterns = list(dict.fromkeys(
        bytes(rng.choice(alphabet) for _ in range(16)) for _ in range(32)
    ))
    text = bytearray(rng.choice(alphabet) for _ in range(8000))
    for _ in range(10):
        p = rng.choice(patterns)
        pos = rng.randrange(0, len(text) - len(p))
        text[pos : pos + len(p)] = p
    text = bytes(text)

    cfg = ScanConfig(backend="device", engine="cascade", auto_shard=False,
                     cascade_mode="sampled", chunk_len=512)
    m = Matcher([{"id": i, "value": p} for i, p in enumerate(patterns)],
                cfg)
    m.finalize()
    cm = m.cascade_model
    assert cm is not None and cm.device_verify_ok

    packed = pack_documents([text], cfg.chunk_len, m.automaton.max_len - 1)
    chunks = jnp.asarray(packed.chunks)
    lengths = jnp.asarray(packed.lengths)

    cap_a, cap_b = 4096, 1024
    outs = [cm.launch_device(chunks, lengths, cap_a, cap_b)
            for _ in range(3)]
    flat = np.asarray(jnp.stack(
        [s for _c, n, nf, nc in outs for s in (n, nf)]
    ))  # single sync fetch for all three chains
    ns, nfs = flat[0::2], flat[1::2]
    assert (ns == ns[0]).all() and (nfs == nfs[0]).all()
    assert 0 < ns[0] <= cap_a and 0 < nfs[0] <= cap_b

    got = [
        (end, int(pids[0]))
        for _doc, end, pids in cm.emit_windows(
            packed, np.asarray(outs[-1][0]), int(nfs[0])
        )
    ]
    assert got == brute_force(patterns, text)


def test_sampled_cascade_overlapping_and_suffix_order():
    pats = [b"abcdabcdabcd", b"cdabcdabcd", b"dabcdabcd"]
    text = b"..abcdabcdabcdabcd.."
    got = run_cascade(pats, text, cascade_mode="sampled")
    assert got == brute_force(pats, text)


def test_sampled_ineligible_degenerate_alphabet():
    # single-letter pattern: every gram is a member; the planner must
    # refuse the sampled filter (candidate density ~1)
    plan_m = Matcher([b"a" * 12])
    plan = plan_cascade([b"a" * 12], plan_m.automaton,
                        ScanConfig(cascade_mode="sampled"))
    assert not plan.eligible


def test_sampled_cascade_sharded_parity():
    rng = random.Random(77)
    patterns = [b"gammagammagam", b"aggregateagg!", b"magmamagmamag"]
    docs = []
    for _ in range(6):
        d = bytearray(rng.choice(b"agmert!") for _ in range(5000))
        for _ in range(5):
            p = rng.choice(patterns)
            pos = rng.randrange(0, len(d) - len(p))
            d[pos : pos + len(p)] = p
        docs.append(bytes(d))
    pats = [{"id": i, "value": p} for i, p in enumerate(patterns)]
    cfg = ScanConfig(backend="device", engine="cascade", auto_shard=True,
                     chunk_len=512, match_capacity=32,
                     cascade_mode="sampled")
    res = Matcher(pats, cfg).match_many(docs)
    for doc, recs in zip(docs, res):
        assert [(r["pos"], r["keyIdx"]) for r in recs] == brute_force(
            patterns, doc
        )


def test_force_take_escape_at_pathological_density(aligned_planner):
    """> 128 survivors per extraction group exceed the grouped path's
    structural slot ceiling: the model must permanently fall back to the
    flat take filter and stay exact (a match every 16 bytes over 1 MiB
    puts ~512 hits in every 1024-cell column group)."""
    p = b"abcdefabcdefabcd"
    text = p * 70000
    cfg = ScanConfig(backend="device", engine="cascade", auto_shard=False,
                     cascade_mode="sampled", bloom_impl="take",
                     chunk_len=4096)
    m = Matcher([{"id": 0, "value": p}], cfg)
    m.finalize()
    assert m.cascade_model.plan.stride % 4 == 0, m.cascade_model.plan.reason
    recs = m.match(text)
    assert m.cascade_model._force_take
    assert len(recs) == 70000
    assert recs[0]["pos"] == 16 and recs[-1]["pos"] == len(text)


def test_grouped_take_words2_parity(monkeypatch):
    """Second-code-family bloom (signature-scale code-collision killer)
    forced on a small set: the dual-code grouped take path must stay
    exact."""
    from php_aho_corasick_tpu.models import cascade as cascmod

    monkeypatch.setattr(cascmod, "WORDS2_MIN_ENTRIES", 1)
    rng = random.Random(17)
    patterns = list({
        bytes(rng.choice(b"abcdef") for _ in range(16)) for _ in range(64)
    })
    text = bytearray(rng.choice(b"abcdef") for _ in range(40000))
    for _ in range(25):
        p = rng.choice(patterns)
        pos = rng.randrange(0, len(text) - len(p))
        text[pos : pos + len(p)] = p
    text = bytes(text)
    cfg = ScanConfig(backend="device", engine="cascade", auto_shard=False,
                     cascade_mode="sampled", bloom_impl="take")
    m = Matcher([{"id": i, "value": p} for i, p in enumerate(patterns)],
                cfg)
    m.finalize()
    assert m.cascade_model.plan.sampled_words2 is not None
    got = [(r["pos"], r["keyIdx"]) for r in m.match(text)]
    assert got == brute_force(patterns, text)


def test_records_overflow_sentinel_rewalk():
    """> VERIFY_KR final positions in one verified window must overflow
    to the sentinel record and be re-walked exactly on the host
    (emit_records_arrays), with no duplicate or lost emissions."""
    base = b"abcdefghijklm"
    patterns = [base[i : i + 9] for i in range(5)]  # ends 5 consecutive
    text = b"zzz..." + base + b"...zzz" + base + b"!!"
    got = run_cascade(patterns, text, cascade_mode="sampled")
    assert got == brute_force(patterns, text)


def test_records_path_emit_parity_dense():
    """Dense planted corpus through the records emission path equals
    brute force (device record decode + ownership on host)."""
    rng = random.Random(99)
    patterns = [b"gammagammagamma!", b"deltadeltadelta!"]
    text = bytearray(rng.choice(b"gadelmt!") for _ in range(30000))
    for k in range(400):
        p = patterns[k % 2]
        pos = rng.randrange(0, len(text) - len(p))
        text[pos : pos + len(p)] = p
    text = bytes(text)
    got = run_cascade(patterns, text, cascade_mode="sampled")
    assert got == brute_force(patterns, text)


def test_sampled_sharded_take_path_dense_hits_terminates():
    """Regression: the sharded take path reported its
    hit gstats as the coarse gstats; with > 128 hits in a shard the
    128-clamped ``_cap_coarse`` could never satisfy ``nc <= cap`` and
    ``_run_sharded_cascade`` retried forever.  The take path must report
    zeroed coarse stats, terminate, and stay exact."""
    rng = random.Random(31337)
    patterns = [b"needleneedlenee", b"haystackhaystac"]
    docs = []
    for _ in range(8):
        d = bytearray(rng.choice(b"xyzuvw") for _ in range(6000))
        for k in range(200):  # >> 128 flagged cells per shard
            pos = rng.randrange(0, len(d) - 16)
            d[pos : pos + 15] = patterns[k % 2]
        docs.append(bytes(d))
    cfg = ScanConfig(backend="device", engine="cascade", auto_shard=True,
                     chunk_len=512, cascade_mode="sampled",
                     bloom_impl="take")
    m = Matcher([{"id": i, "value": p} for i, p in enumerate(patterns)], cfg)
    assert m.cascade_model is not None
    res = m.match_many(docs)
    for doc, recs in zip(docs, res):
        assert [(r["pos"], r["keyIdx"]) for r in recs] == brute_force(
            patterns, doc
        )


def test_sampled_two_probe_parity():
    # a tiny bloom cap saturates the 1-probe filter; the planner must
    # escalate to 2 AND-combined probes and stay exact
    rng = random.Random(99)
    patterns = list({
        bytes(rng.choice(b"abcdef") for _ in range(16)) for _ in range(300)
    })
    text = bytearray(rng.choice(b"abcdef") for _ in range(20000))
    for _ in range(10):
        p = rng.choice(patterns)
        pos = rng.randrange(0, len(text) - len(p))
        text[pos : pos + len(p)] = p
    text = bytes(text)
    cfg = ScanConfig(backend="device", engine="cascade", auto_shard=False,
                     cascade_mode="sampled", cascade_log2_words_max=14)
    m = Matcher([{"id": i, "value": p} for i, p in enumerate(patterns)], cfg)
    m.finalize()
    plan = m.cascade_model.plan
    assert len(plan.sampled_salts) == 2, plan.reason
    got = [(r["pos"], r["keyIdx"]) for r in m.match(text)]
    assert got == brute_force(patterns, text)


def test_sampled_matches_anchored_engine():
    rng = random.Random(13)
    patterns = [bytes(rng.choice(b"abcd") for _ in range(12))
                for _ in range(20)]
    patterns = list(dict.fromkeys(patterns))
    text = bytearray(rng.choice(b"abcd") for _ in range(30000))
    for _ in range(30):
        p = rng.choice(patterns)
        pos = rng.randrange(0, len(text) - len(p))
        text[pos : pos + len(p)] = p
    text = bytes(text)
    sam = run_cascade(patterns, text, cascade_mode="sampled")
    anc = run_cascade(patterns, text, cascade_mode="anchored")
    assert sam == anc == brute_force(patterns, text)


# --------------------------------------------- stride-32 prefix refinement

def test_stride32_long_patterns_prefix_refinement():
    """Pattern sets with min length >= 47 drive the planner to stride 32
    (q=16), whose alignment-31 bit is INT32_MIN under the lowest-set-bit
    trick — the round-4 advisor's int32-overflow repro (ADVICE.md high:
    ``1 << 31`` overflowed at trace time on the grouped take path, and a
    promoted compare would have dropped alignment-31 candidates).  Plants
    occurrences at EVERY in-row offset so all 32 alignments, including
    bit 31, are exercised end to end."""
    rng = random.Random(7)
    alphabet = b"abcdef"
    patterns = [
        bytes(rng.choice(alphabet) for _ in range(rng.randint(47, 64)))
        for _ in range(12)
    ]
    patterns = list(dict.fromkeys(patterns))
    text = bytearray(rng.choice(alphabet) for _ in range(8192))
    for off in range(64):  # all alignments j = p - t in [0, 32)
        p = patterns[off % len(patterns)]
        pos = off * 120 + off
        text[pos : pos + len(p)] = p
    text = bytes(text)
    cfg = ScanConfig(backend="device", engine="cascade", auto_shard=False,
                     cascade_mode="sampled", chunk_len=1024)
    m = Matcher([{"id": i, "value": p} for i, p in enumerate(patterns)],
                cfg)
    cm = m.cascade_model
    assert cm is not None and cm.plan.stride == 32, cm.plan.reason
    got = [(r["pos"], r["keyIdx"]) for r in m.match(text)]
    assert got == brute_force(patterns, text)


def test_records2_superstep_parity():
    """The 2-class super-step record verifier (verify_windows_records2,
    which the sharded take-path record chain runs when records2_ok) must
    equal brute force exactly — including windows with finals at BOTH
    half-steps and the overflow sentinel (dense plants force > VERIFY_KR
    finals)."""
    rng = random.Random(55)
    patterns = list({
        bytes(rng.choice(b"ab") for _ in range(16)) for _ in range(40)
    })
    # binary alphabet + heavy planting => overlapping matches, adjacent
    # final positions, record-slot overflow
    text = bytearray(rng.choice(b"ab") for _ in range(20000))
    for i in range(300):
        p = patterns[i % len(patterns)]
        pos = rng.randrange(0, len(text) - len(p))
        text[pos : pos + len(p)] = p
    text = bytes(text)
    cfg = ScanConfig(backend="device", engine="cascade", auto_shard=True,
                     cascade_mode="sampled", chunk_len=1024,
                     bloom_impl="take")
    m = Matcher([{"id": i, "value": p} for i, p in enumerate(patterns)],
                cfg)
    cm = m.cascade_model
    assert cm is not None and cm.plan.mode == "sampled", cm.plan.reason
    assert cm.records_ok and cm.records2_ok
    got = [(r["pos"], r["keyIdx"]) for r in m.match(text)]
    assert got == brute_force(patterns, text)


# ------------------------------------- take paths: seeded sampled fuzz


def _fuzz_case(seed, alphabet):
    """Seeded sampled-cascade corpus: mixed-length long patterns (plus
    shorts on odd seeds) over ``abcdef``, or random bytes covering all 256
    values (n_classes = 257 > 255 drives the byte-gather verifier)."""
    if alphabet == "abcdef":
        rng = random.Random(4200 + seed)
        patterns = list({
            bytes(rng.choice(b"abcdef") for _ in range(rng.randint(9, 20)))
            for _ in range(rng.randint(2, 50))
        })
        if seed % 2:
            patterns += [b"xy", b"q"]
        text = bytearray(rng.choice(b"abcdef") for _ in range(5000))
        n_plant = 15
    else:
        rng = random.Random(8600 + seed)
        patterns = list({
            bytes(rng.randrange(256) for _ in range(rng.randint(9, 18)))
            for _ in range(rng.randint(8, 40))
        })
        patterns += [bytes(range(16 * i, 16 * i + 16)) for i in range(16)]
        text = bytearray(rng.randrange(256) for _ in range(4000))
        n_plant = 12
    patterns = list(dict.fromkeys(patterns))
    for _ in range(n_plant):
        p = rng.choice(patterns)
        pos = rng.randrange(0, len(text) - len(p))
        text[pos : pos + len(p)] = p
    return patterns, bytes(text)


@pytest.mark.parametrize("path", ["grouped", "flat"])
@pytest.mark.parametrize(
    "seed,alphabet",
    [(s, "abcdef") for s in range(4)] + [(s, "bytes") for s in range(2)],
)
def test_sampled_take_paths_fuzz(seed, alphabet, path, monkeypatch):
    """The same seeded fuzz through the grouped take filter (rank
    extraction + prefix refinement) and the flat take filter."""
    if path == "grouped":
        from php_aho_corasick_tpu.models import cascade as cascmod

        monkeypatch.setattr(cascmod, "_CODES_GENERAL_S", 1.0)
    patterns, text = _fuzz_case(seed, alphabet)
    cfg = ScanConfig(backend="device", engine="cascade", auto_shard=False,
                     cascade_mode="sampled", bloom_impl="take",
                     chunk_len=512, match_capacity=64)
    m = Matcher([{"id": i, "value": p} for i, p in enumerate(patterns)],
                cfg)
    cm = m.cascade_model
    assert cm is not None and cm.plan.mode == "sampled", cm.plan.reason
    if path == "flat":
        cm._force_take = True
    L = m.device_corpus([text], shard=False).chunks_d.shape[1]
    assert cm.grouped_path(L) == (path == "grouped"), cm.plan.reason
    got = [(r["pos"], r["keyIdx"]) for r in m.match(text)]
    assert got == brute_force(patterns, text)


# ----------------------------------- grouped-path helpers vs numpy


@pytest.mark.parametrize(
    "block_r,mpr,n_blocks,density",
    [(8, 8, 2, 0.3), (16, 4, 3, 0.5), (32, 8, 1, 0.05)],
)
def test_group_rank_extract_matches_numpy(block_r, mpr, n_blocks, density):
    import jax.numpy as jnp

    from php_aho_corasick_tpu.ops.filter_jax import group_rank_extract

    rng = np.random.default_rng(block_r + mpr)
    tot = n_blocks * block_r * 128
    n_grid = tot - 77  # a padded tail must never count
    hit_w = rng.random(tot) < density
    w = np.where(hit_w, rng.integers(1, 2**31, tot), 0).astype(np.int32)
    sw = np.where(rng.random(tot) < density / 4,
                  rng.integers(1, 255, tot), 0).astype(np.int32)
    hv = rng.integers(-(2**31), 2**31, tot, dtype=np.int64).astype(np.int32)
    got = [np.asarray(x) for x in group_rank_extract(
        jnp.asarray(w), jnp.asarray(sw), jnp.asarray(hv),
        block_r, mpr, n_blocks, n_grid,
    )]
    r_w = np.full((n_blocks * mpr, 128), -1, np.int32)
    w_w, s_w, h_w = (np.zeros((n_blocks * mpr, 128), np.int32)
                     for _ in range(3))
    cnt_w = np.zeros((n_blocks, 128), np.int32)
    for b in range(n_blocks):
        for lane in range(128):
            k = 0
            for r in range(block_r):
                cell = (b * block_r + r) * 128 + lane
                if cell >= n_grid or (w[cell] | sw[cell]) == 0:
                    continue
                cnt_w[b, lane] += 1
                if k < mpr:
                    row = b * mpr + k
                    r_w[row, lane] = r
                    w_w[row, lane] = w[cell]
                    s_w[row, lane] = sw[cell]
                    h_w[row, lane] = hv[cell]
                k += 1
    for g, want in zip(got, (r_w, w_w, s_w, h_w, cnt_w)):
        np.testing.assert_array_equal(g, want)


@pytest.mark.parametrize("stride,l16", [(4, 12), (8, 16), (32, 16)])
def test_prefix_hash_select_matches_numpy(stride, l16):
    """Rolling prefix hash of each cell's lowest-alignment candidate
    window ``[p - j, p - j + l16)`` against a direct polynomial hash."""
    import jax.numpy as jnp

    from php_aho_corasick_tpu.ops.filter_jax import (
        GRAM_BASE,
        _prefix_hash_select,
        _window_offsets,
    )

    rng = np.random.default_rng(stride)
    spc = stride // 4
    n_cells = 64
    pad = 64  # zero bytes on both sides of the corpus
    body = rng.integers(0, 256, n_cells * stride, dtype=np.int64)
    buf = np.concatenate([np.zeros(pad), body, np.zeros(pad)]).astype(
        np.uint8
    )
    words = buf.view(np.uint32).astype(np.int64).astype(np.uint32)
    words = jnp.asarray(words.view(np.int32))
    first = pad // 4 + np.arange(n_cells) * spc  # each cell's first word
    c_min = _window_offsets(spc, l16)
    w = rng.integers(0, 1 << min(stride, 31), n_cells, dtype=np.int64)
    w[::7] = 0
    if stride == 32:
        w[1] = -(2**31)  # alignment 31 alone
    w32 = jnp.asarray(w.astype(np.int64).astype(np.uint32).view(np.int32))

    def get_plane(c):
        return jnp.take(words, jnp.asarray(first + c))

    got = np.asarray(_prefix_hash_select(get_plane, w32, stride, l16, c_min))
    mask = (1 << stride) - 1
    for m_ in range(n_cells):
        v = int(w[m_]) & mask
        if v == 0:
            assert got[m_] == 0
            continue
        j = (v & -v).bit_length() - 1
        start = pad + m_ * stride - j
        h = 0
        for x in buf[start : start + l16]:
            h = (h * GRAM_BASE + int(x)) & 0xFFFFFFFF
        assert int(got[m_]) & 0xFFFFFFFF == h, (m_, j)
