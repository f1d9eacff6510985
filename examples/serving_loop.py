"""Steady-state serving with device-resident corpora.

The reference's scale story is one automaton amortized over many
haystacks (the reference's `README.md:7-9`).  The device-side dual is
amortizing the *upload*: ``Matcher.device_corpus`` packs and transfers a
corpus once, and every subsequent ``match_arrays`` call against the
handle re-scans resident bytes at engine speed.  For throughput serving,
``match_arrays_many`` pipelines several handles through one trailing
scalar fetch (each blocking fetch costs a full host<->device round
trip).

Run: ``python examples/serving_loop.py``
"""

import os
import random
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from php_aho_corasick_tpu import Matcher, ScanConfig  # noqa: E402


def main() -> None:
    rng = random.Random(7)
    signatures = sorted(
        {
            bytes(rng.choice(b"abcdefgh") for _ in range(16))
            for _ in range(512)
        }
    )
    matcher = Matcher(
        [{"id": i, "value": s} for i, s in enumerate(signatures)],
        ScanConfig(backend="device"),
    )
    matcher.finalize()

    # one batch of documents arrives; pay pack + upload once
    docs = [
        bytes(rng.choice(b"abcdefgh") for _ in range(8192))
        for _ in range(64)
    ]
    docs[3] = docs[3][:100] + signatures[42] + docs[3][100:]
    handle = matcher.device_corpus(docs)
    print(handle)

    # re-scan the resident corpus (e.g. after a policy change, or for
    # several independent queries) without re-uploading
    t0 = time.time()
    res = matcher.match_arrays(handle)
    print(
        f"single scan: {res['doc'].shape[0]} matches "
        f"in {(time.time() - t0) * 1e3:.1f} ms"
    )

    # pipelined high-throughput loop over several resident corpora
    handles = [handle] * 4
    t0 = time.time()
    outs = matcher.match_arrays_many(handles)
    dt = (time.time() - t0) / len(handles)
    total = sum(o["doc"].shape[0] for o in outs)
    print(
        f"pipelined x{len(handles)}: {total} matches, "
        f"{dt * 1e3:.1f} ms/corpus "
        f"({handle.total_bytes / dt / 1e9:.2f} GB/s)"
    )

    # handles interoperate with the dict API too
    recs = matcher.match_many(handle)
    print("doc 3 records:", recs[3])

    # steady-state STREAMED serving (round 5): batch k+1's device
    # chains dispatch before batch k's records expand on the host, so
    # the device never idles behind host emission — the right loop for
    # match-dense production feeds
    batches = [[handle] * 2 for _ in range(3)]
    t0 = time.time()
    n_stream = sum(
        o["doc"].shape[0]
        for out in matcher.match_arrays_stream(batches)
        for o in out
    )
    dt = (time.time() - t0) / 6
    print(
        f"streamed 3x2 batches: {n_stream} matches, "
        f"{dt * 1e3:.1f} ms/corpus"
    )

    # on a multi-device mesh, shard the resident corpus over the devices
    # (each device holds 1/N of the rows; the per-shard record chains run
    # under one shard_map dispatch): device_corpus(docs, shard=True)


if __name__ == "__main__":
    main()
