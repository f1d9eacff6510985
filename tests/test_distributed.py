"""Two-process ``jax.distributed`` execution of the sharded scan paths.

The rest of the suite simulates multi-device on ONE process (8 virtual CPU
devices); this file runs TWO real OS processes, 4 virtual devices each,
joined through a localhost coordinator — the first genuine exercise of
``parallel.mesh.init_distributed`` and of every ``process_count > 1``
branch in api.py (``collect=True`` all_gathered match buffers must be
addressable from both processes).  Reference analog: none — the reference
is single-threaded (SURVEY §2.4); this is the device-native multi-host
backend's CPU-cluster rehearsal.
"""

import os
import socket
import subprocess
import sys

import pytest

WORKER = os.path.join(os.path.dirname(__file__), "helpers",
                      "distributed_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_sharded_scan_parity():
    port = _free_port()
    coordinator = f"127.0.0.1:{port}"
    env = {
        k: v for k, v in os.environ.items()
        if k not in ("XLA_FLAGS", "JAX_PLATFORMS")
    }
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, coordinator, "2", str(pid)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            env=env,
            text=True,
        )
        for pid in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=540)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("distributed workers timed out:\n" + "\n".join(outs))
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
        assert "PARITY-OK dfa=" in out, f"worker {pid} output:\n{out}"
        assert "PARITY-OK cascade=" in out, f"worker {pid} output:\n{out}"
    # both processes must agree on the global match count
    counts = [
        sorted(line for line in out.splitlines() if "PARITY-OK" in line)
        for out in outs
    ]
    assert counts[0] == counts[1]
