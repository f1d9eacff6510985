"""Randomized cross-config soak: public API vs brute force.

Sweeps pattern shapes x engines x chunk lengths x densities x find_all
x handles on the CPU backend (run under the test env for the virtual
mesh).  Not part of the pytest suite (runtime-bounded dev tool):

    JAX_PLATFORMS=cpu python benchmarks/fuzz_soak.py [--seconds 600]
"""

import argparse
import os
import random
import sys
import time

sys.path.insert(
    0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
)

import jax

jax.config.update("jax_platforms", "cpu")

from php_aho_corasick_tpu import Matcher, ScanConfig  # noqa: E402


def brute(patterns, text):
    out = []
    for pid, p in enumerate(patterns):
        s = text.find(p)
        while s != -1:
            out.append((s + len(p), -len(p), pid))
            s = text.find(p, s + 1)
    out.sort()
    return [(pos, pid) for pos, _, pid in out]


def one_case(rng: random.Random) -> dict:
    alpha = rng.choice([b"ab", b"abcdef", b"abcdefgh0123", bytes(range(256))])
    n_pat = rng.randint(1, 120)
    lens = rng.choice([(1, 4), (4, 9), (9, 20), (1, 20), (16, 16)])
    patterns = list({
        bytes(rng.choice(alpha) for _ in range(rng.randint(*lens)))
        for _ in range(n_pat)
    })
    n_docs = rng.randint(1, 6)
    docs = []
    for _ in range(n_docs):
        d = bytearray(
            rng.choice(alpha) for _ in range(rng.randint(0, 12000))
        )
        for _ in range(rng.randint(0, 30)):
            p = rng.choice(patterns)
            if len(d) > len(p):
                pos = rng.randrange(0, len(d) - len(p))
                d[pos : pos + len(p)] = p
        docs.append(bytes(d))
    cfg = dict(
        backend="device",
        engine=rng.choice(["auto", "dfa", "kgram", "cascade"]),
        auto_shard=rng.random() < 0.5,
        chunk_len=rng.choice([256, 512, 1024, 4096]),
        match_capacity=rng.choice([16, 256, 4096]),
        cascade_mode=rng.choice(["auto", "sampled", "anchored"]),
        table_format=rng.choice(["auto", "dense"]),
    )
    find_all = rng.random() < 0.8
    use_handle = rng.random() < 0.3 and not cfg["auto_shard"]
    try:
        m = Matcher(
            [{"id": i, "value": p} for i, p in enumerate(patterns)],
            ScanConfig(**cfg),
        )
    except ValueError:
        return {"skipped": "forced-engine ineligible"}
    try:
        tgt = m.device_corpus(docs) if use_handle else docs
        res = m.match_many(tgt, find_all=find_all)
    except ValueError as e:
        if "ineligible" in str(e) or "requires" in str(e) or (
            "exceeds" in str(e)
        ):
            return {"skipped": str(e)[:40]}
        raise
    for doc, recs in zip(docs, res):
        want = brute(patterns, doc)
        if not find_all and want:
            first = want[0][0]
            want = [w for w in want if w[0] == first]
        got = [(r["pos"], r["keyIdx"]) for r in recs]
        assert got == want, (cfg, find_all, use_handle, len(doc),
                             got[:5], want[:5])
    return {"ok": sum(map(len, res))}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=int, default=600)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cases", type=int, default=200, help=(
        "cases per child process — every random config is a fresh XLA "
        "compile, and a few hundred accumulated executables exhaust "
        "process memory (observed LLVM 'Cannot allocate memory' at "
        "~360 cases), so the parent re-spawns children"
    ))
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--artifact", default=None, help=(
        "write a JSON summary (cases, mismatches, runtime) on success"
    ))
    args = ap.parse_args()
    rng = random.Random(args.seed)
    t0 = time.time()
    if args.child:
        n = ok = 0
        for _ in range(args.cases):
            r = one_case(random.Random(rng.randrange(1 << 30)))
            n += 1
            ok += "ok" in r
        print(f"CHILD OK: {n} cases, {ok} produced scans", flush=True)
        return
    import subprocess

    total = 0
    while time.time() - t0 < args.seconds:
        cmd = [
            sys.executable, os.path.abspath(__file__), "--child",
            "--seed", str(rng.randrange(1 << 30)),
            "--cases", str(args.cases),
        ]
        r = subprocess.run(cmd, capture_output=True, text=True)
        tail = (r.stdout + r.stderr).strip().splitlines()
        if r.returncode != 0 or not any(
            ln.startswith("CHILD OK") for ln in tail
        ):
            print("SOAK FAILURE in child:")
            print("\n".join(tail[-25:]))
            sys.exit(1)
        total += args.cases
        print(f"{total} cases in {time.time() - t0:.0f}s", flush=True)
    print(f"SOAK OK: {total} cases, 0 mismatches")
    if args.artifact:
        import json

        with open(args.artifact, "w") as f:
            json.dump({
                "cases": total,
                "mismatches": 0,
                "seconds": round(time.time() - t0),
                "sweep": "engines x chunk_len x capacity x cascade_mode "
                         "x bloom_impl x table_format x find_all x "
                         "handles x auto_shard (8-device CPU mesh)",
                "seed": args.seed,
                "measured_at": time.strftime(
                    "%Y-%m-%dT%H:%M:%SZ", time.gmtime()
                ),
            }, f, indent=1)
        print(f"wrote {args.artifact}")


if __name__ == "__main__":
    main()
