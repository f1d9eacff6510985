#!/usr/bin/env python
"""Port of the reference's own benchmark protocol
(``/root/reference/examples/benchmark.php:1-85``):

  10 samples; each sample draws 2048 random needles (16 chars, alphabet
  ``abcdef``) and scans 256 random haystacks x 8192 chars (2 MiB),
  comparing a naive per-needle substring search against Aho-Corasick.
  AC timing INCLUDES automaton construction per sample, exactly like the
  reference (``README.md:168-187``).

Run on the default backend (the GPU when present):  python benchmarks/benchmark_reference.py
Smaller/quicker:  python benchmarks/benchmark_reference.py --samples 3 --naive-needles 64
"""

import argparse
import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.join(_os.path.dirname(_os.path.abspath(__file__)), ".."))
import random
import time


def gen(rng, n, alphabet=b"abcdef"):
    return bytes(rng.choice(alphabet) for _ in range(n))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--samples", type=int, default=10)
    ap.add_argument("--needles", type=int, default=2048)
    ap.add_argument("--needle-len", type=int, default=16)
    ap.add_argument("--haystacks", type=int, default=256)
    ap.add_argument("--haystack-len", type=int, default=8192)
    ap.add_argument(
        "--naive-needles",
        type=int,
        default=128,
        help="needles used for the naive pass (full 2048 would take ~hours "
        "in Python, like the reference's 13 s/pass in PHP; scaled estimate "
        "is reported)",
    )
    args = ap.parse_args()

    from php_aho_corasick_tpu import Matcher, ScanConfig

    rng = random.Random(20260817)
    ac_times = []
    naive_times = []
    total_matches = 0
    for s in range(args.samples):
        needles = list(
            {gen(rng, args.needle_len) for _ in range(args.needles)}
        )
        haystacks = [
            gen(rng, args.haystack_len) for _ in range(args.haystacks)
        ]

        # --- naive strpos-style scan (reference benchmark.php:36-48) ---
        t0 = time.time()
        naive_found = 0
        for h in haystacks:
            for p in needles[: args.naive_needles]:
                ofs = h.find(p)
                while ofs != -1:
                    naive_found += 1
                    ofs = h.find(p, ofs + 1)
        scale = args.needles / max(args.naive_needles, 1)
        naive_times.append((time.time() - t0) * scale)

        # --- Aho-Corasick incl. build (reference benchmark.php:55-76) ---
        t0 = time.time()
        m = Matcher(
            [{"id": i, "value": p} for i, p in enumerate(needles)],
            ScanConfig(backend="device"),
        )
        res = m.match_many(haystacks)
        n = sum(map(len, res))
        ac_times.append(time.time() - t0)
        total_matches += n
        print(
            f"sample {s}: naive(est)={naive_times[-1]:.3f}s "
            f"ac={ac_times[-1]:.3f}s matches={n}"
        )

    mib = args.haystacks * args.haystack_len / 2**20
    avg_naive = sum(naive_times) / len(naive_times)
    avg_ac = sum(ac_times) / len(ac_times)
    print(f"\ncorpus per pass: {mib:.1f} MiB; samples: {args.samples}")
    print(f"avg naive (scaled estimate): {avg_naive:.3f} s/pass")
    print(f"avg aho-corasick (incl build): {avg_ac:.3f} s/pass "
          f"= {mib / 1024 / avg_ac:.3f} GiB/s")
    print(f"speedup vs naive: {avg_naive / avg_ac:.1f}x")
    print("reference (PHP, author's machine): naive 13.061 s, "
          "ac 0.174 s, 74.9x (README.md:182-187)")


if __name__ == "__main__":
    main()
