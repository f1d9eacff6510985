"""Compressed-row DFA model — the byte-dense signature-scale engine.

Device wrapper over :class:`core.tables.CompressedAutomaton` (dense bank +
single-exception sparse rows).  Selected automatically when the dense
``[S, C]`` table would exceed ``ScanConfig.dense_table_max_bytes`` — the
regime the reference cannot reach at all (its pointer trie is ~100 B/node;
1M random-byte patterns is ~16M nodes ≈ 1.6 GB of pointer-chasing memory,
`src/multifast/node.h:37-58`), and where the dense table (~16 GB) outgrows
``dense_table_max_bytes``.  The compressed scan costs a fixed 3 gathers/byte vs the
dense table's 1 (ops/scan_jax.scan_states_compressed).

Interface-compatible with :class:`DenseDfaModel` where the generic engine
machinery needs it (``scan_compact_device``, ``scan_host``,
``device_arrays``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..config import ScanConfig
from ..core.tables import CompressedAutomaton


class CompressedDfaModel:
    """Device-side compressed automaton + scan methods."""

    def __init__(
        self, auto: CompressedAutomaton, config: ScanConfig
    ) -> None:
        self.auto = auto
        self.config = config
        self._dev = None

    # -- host path (small inputs / oracle) -------------------------------

    def scan_host(
        self,
        data: np.ndarray,  # [n] uint8
        init_state: int = 0,
        emit_from: int = 0,
    ) -> Tuple[np.ndarray, np.ndarray, int]:
        """Scalar host scan via the compressed lookup (used below
        ``host_scan_threshold`` and by parity tests)."""
        auto = self.auto
        cls = auto.byte_class[data]
        s = np.int64(init_state)
        pos_out = []
        st_out = []
        one = np.ones(1, dtype=np.int64)
        for t in range(cls.shape[0]):
            s = auto.lookup(s * one, int(cls[t]) * one)[0]
            if t >= emit_from and (
                s >= auto.final_start
                or (auto.dense_final_start <= s < auto.n_dense)
            ):
                pos_out.append(t)
                st_out.append(int(s))
        return (
            np.asarray(pos_out, dtype=np.int64),
            np.asarray(st_out, dtype=np.int32),
            int(s),
        )

    # -- device path ------------------------------------------------------

    @property
    def device_arrays(self):
        if self._dev is None:
            import jax.numpy as jnp

            auto = self.auto
            # 1-sized placeholders keep gathers well-formed when every
            # state is dense (tiny automata forced into compressed mode)
            meta = auto.meta if auto.meta.size else np.zeros(1, np.int32)
            tgt = (
                auto.exc_target
                if auto.exc_target.size
                else np.zeros(1, np.int32)
            )
            self._dev = {
                "dense_flat": jnp.asarray(
                    np.ascontiguousarray(auto.dense_table).reshape(-1)
                ),
                "meta": jnp.asarray(meta),
                "exc_target": jnp.asarray(tgt),
                "byte_class": jnp.asarray(auto.byte_class.astype(np.int32)),
                "used_bytes": jnp.asarray(auto.used_bytes),
                "dense_final_start": jnp.int32(auto.dense_final_start),
                "final_start": jnp.int32(auto.final_start),
            }
        return self._dev

    def scan_compact_device(
        self,
        chunks: np.ndarray,  # [B, L] uint8
        lengths: np.ndarray,  # [B] int32
        emit_from: np.ndarray,  # [B] int32
        init_state: Optional[np.ndarray],
        capacity: int,
    ):
        import jax.numpy as jnp

        from ..ops.scan_jax import scan_and_compact_compressed

        dev = self.device_arrays
        B = chunks.shape[0]
        if init_state is None:
            init = jnp.zeros((B,), dtype=jnp.int32)
        else:
            init = jnp.asarray(init_state, dtype=jnp.int32)
        return scan_and_compact_compressed(
            dev["dense_flat"],
            dev["meta"],
            dev["exc_target"],
            dev["byte_class"],
            dev["used_bytes"],
            jnp.asarray(chunks),
            init,
            jnp.asarray(lengths),
            jnp.asarray(emit_from),
            dev["dense_final_start"],
            dev["final_start"],
            n_classes=self.auto.n_classes,
            n_dense=self.auto.n_dense,
            capacity=capacity,
        )
