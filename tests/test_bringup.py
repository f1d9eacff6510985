"""Removed engine/bloom options, engine choice for small automata, and the
compile-cache location used by the entry points."""

import random

import jax
import pytest

from php_aho_corasick_tpu import Matcher, ScanConfig
from php_aho_corasick_tpu.utils.compile_cache import enable_compile_cache


@pytest.mark.parametrize(
    "field,value",
    [("engine", "tile"), ("bloom_impl", "pallas"),
     ("bloom_impl", "pallas_vmem")],
)
def test_scan_config_rejects_removed_values(field, value):
    with pytest.raises(ValueError, match="removed"):
        ScanConfig(**{field: value})


def test_cli_rejects_removed_engine(tmp_path, capsys):
    from php_aho_corasick_tpu.__main__ import main

    (tmp_path / "p.txt").write_bytes(b"abc\n")
    (tmp_path / "in.bin").write_bytes(b"xxabcxx")
    with pytest.raises(SystemExit):
        main(["scan", "-p", str(tmp_path / "p.txt"),
              "-i", str(tmp_path / "in.bin"), "--engine", "tile"])
    assert "invalid choice" in capsys.readouterr().err


def _brute(patterns, text):
    out = []
    for pid, p in enumerate(patterns):
        start = text.find(p)
        while start != -1:
            out.append((start + len(p), -len(p), pid))
            start = text.find(p, start + 1)
    out.sort()
    return [(pos, pid) for pos, _, pid in out]


@pytest.mark.parametrize("sharded", [False, True])
@pytest.mark.parametrize("want", ["dfa", "kgram"])
def test_small_automaton_auto_engine(want, sharded):
    """A small automaton with more short patterns than the cascade takes
    (the regime the tile engine used to serve) picks the dense or k-gram
    walk under engine="auto" and matches brute force, on one device or
    sharded over the 8-device CPU mesh."""
    rng = random.Random(5)
    patterns = sorted({
        bytes(rng.choice(b"abcdefghij") for _ in range(2)) for _ in range(40)
    })[:20] + [b"abcab", b"jihgfedcba"]
    docs = []
    for _ in range(4):
        d = bytearray(rng.choice(b"abcdefghijklmnop") for _ in range(3000))
        for _ in range(10):
            p = rng.choice(patterns)
            pos = rng.randrange(0, len(d) - len(p))
            d[pos : pos + len(p)] = p
        docs.append(bytes(d))
    cfg = ScanConfig(
        backend="device", auto_shard=sharded, chunk_len=512,
        kgram_min_bytes=1024 if want == "kgram" else 1 << 30,
    )
    m = Matcher([{"id": i, "value": p} for i, p in enumerate(patterns)], cfg)
    S, C = m.automaton.table.shape
    assert S * C <= 4096 and m.cascade_model is None
    assert m._pick_engine(sum(map(len, docs))) == want
    for doc, recs in zip(docs, m.match_many(docs)):
        assert [(r["pos"], r["keyIdx"]) for r in recs] == _brute(
            patterns, doc
        )
    assert m.stats.last_engine == want


def test_compile_cache_uses_env_var(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
    before = jax.config.jax_compilation_cache_dir
    assert enable_compile_cache(str(tmp_path)) == str(tmp_path / "env")
    assert jax.config.jax_compilation_cache_dir == before  # nothing set


def test_compile_cache_defaults_to_repo_dir(monkeypatch, tmp_path):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = enable_compile_cache(str(tmp_path))
        assert path == str(tmp_path / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
