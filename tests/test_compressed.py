"""Compressed (dense-bank + single-exception) table format tests.

The format exists for byte-dense signature-scale sets where the dense
``[S, C]`` table exceeds HBM (SURVEY §7 "Table memory at signature
scale"); parity is checked at small scale against the dense compiler,
the brute-force oracle, and the golden corpus — the exactness argument
is scale-independent (the representation is lossless by construction).
"""

import random

import numpy as np
import pytest

from php_aho_corasick_tpu import Matcher, ScanConfig
from php_aho_corasick_tpu.core.automaton import (
    compile_trie,
    compile_trie_compressed,
)
from php_aho_corasick_tpu.core.tables import CompressedAutomaton
from php_aho_corasick_tpu.core.trie import TrieBuilder


def _build_pair(pats):
    t1, t2 = TrieBuilder(), TrieBuilder()
    lens = []
    for p in pats:
        s1 = t1.add(p)
        s2 = t2.add(p)
        assert s1 == s2
        if s1.name == "SUCCESS":
            lens.append(len(p))
    dense = compile_trie(t1, lens, allow_int16=False)
    comp = compile_trie_compressed(t2, lens)
    comp.validate()
    return dense, comp


def _walk_parity(dense, comp, text: bytes):
    """Both automata must agree on finality, emitted pattern ids, and
    state depth at every position (state ids differ by renumbering)."""
    cls = dense.byte_class[np.frombuffer(text, np.uint8)]
    assert (cls == comp.byte_class[np.frombuffer(text, np.uint8)]).all()
    sd = np.zeros(1, np.int64)
    sc = np.zeros(1, np.int64)
    for cl in cls:
        sd = dense.lookup(sd, cl.reshape(1))
        sc = comp.lookup(sc, cl.reshape(1))
        fd = bool(sd[0] >= dense.final_start)
        assert fd == bool(comp.is_final(sc)[0])
        assert dense.state_depth[sd[0]] == comp.state_depth[sc[0]]
        if fd:
            pd = dense.emit_pats[
                dense.emit_start[sd[0]] : dense.emit_start[sd[0] + 1]
            ]
            pc = comp.emit_pats[
                comp.emit_start[sc[0]] : comp.emit_start[sc[0] + 1]
            ]
            assert list(pd) == list(pc)


CASES = {
    "unary-chains": [b"a" * k for k in range(1, 24)],
    "two-letter": [b"ab" * 5, b"b" * 8, b"a" * 8, b"abba", b"baab", b"bb"],
    "ushers": [b"he", b"she", b"his", b"hers", b"ushers"],
    "dup-and-reject": [b"x", b"x", b"", b"xy"],
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_builder_parity_fixed(name):
    pats = CASES[name]
    dense, comp = _build_pair(pats)
    assert comp.n_states == dense.n_states
    assert comp.max_len == dense.max_len
    rng = random.Random(hash(name) & 0xFFFF)
    alpha = sorted(set(b for p in pats for b in p)) + [0, 127]
    for _ in range(20):
        n = rng.randrange(1, 150)
        _walk_parity(
            dense, comp, bytes(rng.choice(alpha) for _ in range(n))
        )


@pytest.mark.parametrize("seed", range(6))
def test_builder_parity_fuzz(seed):
    rng = random.Random(seed)
    alpha_bits = rng.choice([2, 3, 8])  # alphabet density axis
    alpha = list(range(1 << alpha_bits))
    pats = [
        bytes(rng.choice(alpha) for _ in range(rng.randrange(1, 12)))
        for _ in range(rng.randrange(2, 60))
    ]
    dense, comp = _build_pair(pats)
    for _ in range(15):
        n = rng.randrange(1, 300)
        _walk_parity(
            dense, comp, bytes(rng.choice(alpha) for _ in range(n))
        )


def test_unary_chains_stay_sparse():
    # the classic worst case for failure-chain length is the best case
    # for the exception format: every state has <= 1 goto edge
    _, comp = _build_pair([b"a" * k for k in range(1, 40)])
    assert comp.n_dense == 1  # just the root


def test_byte_dense_compression_ratio():
    rng = random.Random(99)
    pats = [bytes(rng.randrange(256) for _ in range(16)) for _ in range(400)]
    dense, comp = _build_pair(pats)
    assert comp.table_bytes < dense.table.nbytes // 2


FORCED = ScanConfig(table_format="compressed", backend="device")


def test_matcher_forced_compressed_device():
    pats = [{"key": "ab", "value": "alfa"}, {"value": "lfa"}, {"value": "x"}]
    mC = Matcher(pats, FORCED)
    mD = Matcher(pats, ScanConfig(backend="device"))
    assert mC.table_format == "compressed"
    assert mD.table_format == "dense"
    assert isinstance(mC.automaton, CompressedAutomaton)
    doc = "..alfa..xx..lfalfa"
    assert mC.match(doc) == mD.match(doc)
    # chunked long-doc path (halo + emit_from)
    long_doc = "y" * 100_000 + "alfa" + "y" * 50_000 + "x"
    assert mC.match(long_doc) == mD.match(long_doc)


def test_matcher_forced_compressed_host_fuzz():
    rng = random.Random(3)
    pats = [
        bytes(rng.choice(b"abcd") for _ in range(rng.randrange(1, 6)))
        for _ in range(30)
    ]
    specs = [{"id": i, "value": p} for i, p in enumerate(dict.fromkeys(pats))]
    mC = Matcher(specs, ScanConfig(table_format="compressed"))
    mD = Matcher(specs, ScanConfig())
    for trial in range(25):
        doc = bytes(
            rng.choice(b"abcde") for _ in range(rng.randrange(1, 400))
        )
        for be in ("host", "device"):
            assert mC.match(doc, backend=be) == mD.match(doc, backend=be), (
                trial,
                be,
            )


def test_compressed_stream_and_replace():
    cfg = ScanConfig(table_format="compressed")
    m = Matcher([{"value": "defg"}, {"value": "defghijkl"}], cfg)
    s = m.stream()
    recs = s.feed("xxxde") + s.feed("fghij") + s.feed("kl")
    assert [r["pos"] for r in recs] == [7, 12]
    out = m.replace("..defg..", {"defg": "X"})
    assert out == "..X.."


def test_compressed_engines_guarded():
    cfg = ScanConfig(table_format="compressed", engine="kgram")
    m = Matcher([{"value": "abc"}], cfg)
    with pytest.raises(ValueError):
        m.match("zabcz", backend="device")
    # the cascade is ALLOWED on compressed tables since round 3 (the
    # window verifier walks the compressed lookup)
    assert Matcher([{"value": "abc"}], FORCED).cascade_model is not None


def test_compressed_save_load(tmp_path):
    pats = [b"he", b"she", b"his", b"hers"]
    _, comp = _build_pair(pats)
    p = tmp_path / "auto.npz"
    comp.save(p)
    back = CompressedAutomaton.load(p)
    back.validate()
    assert (back.dense_table == comp.dense_table).all()
    assert (back.meta == comp.meta).all()
    assert back.final_start == comp.final_start


def test_native_compressed_bit_parity():
    from php_aho_corasick_tpu import native

    if not native.available():
        pytest.skip("native library unavailable")
    rng = random.Random(17)
    for trial in range(5):
        pats = list(
            dict.fromkeys(
                bytes(
                    rng.randrange(rng.choice([4, 256]))
                    for _ in range(rng.randrange(1, 10))
                )
                for _ in range(rng.randrange(2, 80))
            )
        )
        t = TrieBuilder()
        lens = [len(p) for p in pats if t.add(p).name == "SUCCESS"]
        py = compile_trie_compressed(t, lens)
        nb = native.NativeTrieBuilder()
        for p in pats:
            nb.add(p)
        cc = nb.compile_compressed()
        cc.validate()
        assert (cc.dense_table == py.dense_table).all(), trial
        assert (cc.meta == py.meta).all(), trial
        assert (cc.exc_target[cc.meta % 512 > 0]
                == py.exc_target[py.meta % 512 > 0]).all(), trial
        assert (cc.emit_start == py.emit_start).all(), trial
        assert (cc.emit_pats == py.emit_pats).all(), trial
        assert (cc.state_depth == py.state_depth).all(), trial
        assert cc.dense_final_start == py.dense_final_start
        assert cc.final_start == py.final_start


def test_auto_format_switch_threshold():
    # a tiny threshold forces auto-selection of the compressed format
    cfg = ScanConfig(dense_table_max_bytes=64)
    m = Matcher([{"value": "hello"}, {"value": "world"}], cfg)
    assert m.table_format == "compressed"
    assert m.match("say hello world")[0]["value"] == "hello"
    # default threshold keeps small sets dense
    assert Matcher([{"value": "hello"}]).table_format == "dense"


def test_compressed_sharded_parity():
    """The compressed scan over the 8-device mesh (round-3: the dense-only
    use_mesh restriction is lifted) must match the dense sharded result
    exactly — replicated dense-bank + exception arrays, sharded rows."""
    rng = random.Random(17)
    pats = [
        bytes(rng.choice(b"abcdwxyz") for _ in range(rng.randrange(2, 10)))
        for _ in range(40)
    ]
    specs = [{"id": i, "value": p} for i, p in enumerate(dict.fromkeys(pats))]
    docs = []
    for _ in range(9):
        d = bytearray(rng.choice(b"abcdwxyz") for _ in range(3000))
        for _ in range(4):
            p = rng.choice(pats)
            pos = rng.randrange(0, len(d) - len(p))
            d[pos : pos + len(p)] = p
        docs.append(bytes(d))
    mC = Matcher(specs, ScanConfig(table_format="compressed",
                                   backend="device", auto_shard=True,
                                   chunk_len=512, match_capacity=64))
    mD = Matcher(specs, ScanConfig(backend="device", auto_shard=True,
                                   chunk_len=512, match_capacity=64))
    import jax

    assert len(jax.devices()) > 1  # the mesh path must actually engage
    assert mC.table_format == "compressed"
    resC = mC.match_many(docs)
    resD = mD.match_many(docs)
    assert resC == resD
    assert sum(map(len, resC)) > 0
    # columnar image through the same sharded kernel
    arrC = mC.match_arrays(docs)
    arrD = mD.match_arrays(docs)
    for k in ("doc", "pos", "start_postion", "pattern"):
        assert (arrC[k] == arrD[k]).all()


# --------------------------------------- compressed-table cascade (round 3)

def _brute(patterns, text):
    out = []
    for pid, p in enumerate(patterns):
        start = text.find(p)
        while start != -1:
            out.append((start + len(p), -len(p), pid))
            start = text.find(p, start + 1)
    out.sort()
    return [(pos, pid) for pos, _, pid in out]


@pytest.mark.parametrize("seed", range(4))
def test_compressed_cascade_parity_fuzz(seed):
    """The sampled cascade forced onto a compressed table (device window
    verify through the 3-gather walk) must match brute force exactly."""
    rng = random.Random(300 + seed)
    patterns = list({
        bytes(rng.choice(b"abcdef") for _ in range(rng.randint(10, 20)))
        for _ in range(rng.randint(4, 40))
    })
    if seed % 2:
        patterns += [b"zq"]
    text = bytearray(rng.choice(b"abcdef") for _ in range(6000))
    for _ in range(12):
        p = rng.choice(patterns)
        pos = rng.randrange(0, len(text) - len(p))
        text[pos : pos + len(p)] = p
    text = bytes(text)
    cfg = ScanConfig(backend="device", engine="cascade", auto_shard=False,
                     table_format="compressed", cascade_mode="sampled",
                     chunk_len=512, match_capacity=64)
    m = Matcher([{"id": i, "value": p} for i, p in enumerate(patterns)], cfg)
    assert m.table_format == "compressed"
    cm = m.cascade_model
    assert cm is not None and cm.device_verify_ok
    got = [(r["pos"], r["keyIdx"]) for r in m.match(text)]
    assert got == _brute(patterns, text)


def test_compressed_cascade_equals_dense_cascade():
    rng = random.Random(31)
    patterns = list({
        bytes(rng.choice(b"abcdef") for _ in range(16)) for _ in range(64)
    })
    docs = []
    for _ in range(5):
        d = bytearray(rng.choice(b"abcdef") for _ in range(4000))
        p = rng.choice(patterns)
        d[100:100 + len(p)] = p
        docs.append(bytes(d))
    specs = [{"id": i, "value": p} for i, p in enumerate(patterns)]
    base = dict(backend="device", engine="cascade", auto_shard=False,
                cascade_mode="sampled", chunk_len=512, match_capacity=64)
    mC = Matcher(specs, ScanConfig(table_format="compressed", **base))
    mD = Matcher(specs, ScanConfig(**base))
    assert mC.match_many(docs) == mD.match_many(docs)


def test_compressed_auto_picks_cascade_for_large_scans():
    rng = random.Random(33)
    patterns = list({
        bytes(rng.choice(b"abcdef") for _ in range(16)) for _ in range(64)
    })
    cfg = ScanConfig(backend="device", table_format="compressed",
                     auto_shard=False, cascade_min_bytes=1024)
    m = Matcher([{"id": i, "value": p} for i, p in enumerate(patterns)], cfg)
    assert m._pick_engine(1 << 20) == "cascade"
    assert m._pick_engine(16) == "dfa"


