"""chip_smoke.py's device guard and its phases at tiny sizes on the CPU
test mesh (the script itself refuses to run without a GPU)."""

import pytest

import chip_smoke as cs
from php_aho_corasick_tpu import ScanConfig

MIB = 1 << 20

#: tiny corpora still reach the cascade engine with a lowered threshold
TINY = ScanConfig(backend="device", chunk_len=4096, auto_shard=False,
                  cascade_min_bytes=1 << 16)


def test_require_gpu_refuses_cpu():
    with pytest.raises(SystemExit, match="needs a GPU"):
        cs.require_gpu()


def test_phase_surfaces_tiny():
    cs.phase_surfaces(3, doc_bytes=60_000)


def test_phase_headline_and_planner_tiny():
    head = cs.phase_headline(3, resident_bytes=MIB, stream_bytes=MIB // 2,
                             n_many=2, config=TINY)
    m = head["matcher"]
    assert m._pick_engine(head["handle"].total_bytes) == "cascade"
    terms = cs.phase_planner(m, head["handle"], n_cand=2000, n_hits=1000,
                             n_slots=512)
    assert set(terms) == {
        "codes_aligned_s", "codes_general_s", "gather_s", "compact_s",
        "window_step_s", "host_hit_s",
    }
    assert all(v > 0 for v in terms.values())


def test_phase_engines_tiny():
    cs.phase_engines(3, n_bytes=MIB // 4)


def test_phase_four_cards_on_cpu_mesh():
    import jax

    n = len(jax.devices())
    cs.phase_four_cards(
        3, n_cards=n, resident_bytes=MIB, dfa_bytes=MIB // 4,
        config=ScanConfig(backend="device", chunk_len=4096,
                          cascade_min_bytes=1 << 16),
    )


def test_assert_exact_catches_a_difference():
    import numpy as np

    ref = tuple(np.arange(3) for _ in range(4))
    assert cs.assert_exact("same", ref, ref) == 3
    bad = (ref[0], ref[1] + 1, ref[2], ref[3])
    with pytest.raises(AssertionError, match="pos differs"):
        cs.assert_exact("bad", bad, ref)
