"""Dense byte-class DFA — the flagship device model.

Wraps a :class:`CompiledAutomaton` with its device-resident arrays and the
scan entry points.  This is the device-side object that replaces the
reference's in-memory ``AC_TRIE_t`` (``src/multifast/ahocorasick.h:37-67``):
the trie is gone; what ships to the device is the precomposed ``[S, C]`` transition
table, the 256-entry byte-class map, and the finality threshold.

A host (numpy) scalar scanner is included as the small-input fast path
(device dispatch overhead dominates below a few KiB) and doubles as an
in-process oracle for the device kernels.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np

from ..config import ScanConfig
from ..core.tables import CompiledAutomaton


class DenseDfaModel:
    """Device-side automaton + scan methods."""

    def __init__(self, auto: CompiledAutomaton, config: ScanConfig) -> None:
        self.auto = auto
        self.config = config
        self._dev = None  # lazily-created device arrays

    # -- host fast path -------------------------------------------------

    def scan_host(
        self,
        data: np.ndarray,  # [n] uint8
        init_state: int = 0,
        emit_from: int = 0,
    ) -> Tuple[np.ndarray, np.ndarray, int]:
        """Scalar reference scan. Returns (positions, states, carry_state).

        ``positions[i]`` is the in-buffer index whose consumption reached a
        final state; emission starts at ``emit_from``.
        """
        auto = self.auto
        table = auto.table
        cls = auto.byte_class[data]
        s = init_state
        fs = auto.final_start
        pos_out = []
        st_out = []
        for t in range(cls.shape[0]):
            s = int(table[s, cls[t]])
            if s >= fs and t >= emit_from:
                pos_out.append(t)
                st_out.append(s)
        return (
            np.asarray(pos_out, dtype=np.int64),
            np.asarray(st_out, dtype=np.int32),
            s,
        )

    # -- device path ----------------------------------------------------

    @property
    def device_arrays(self):
        if self._dev is None:
            import jax.numpy as jnp

            auto = self.auto
            self._dev = {
                "table_flat": jnp.asarray(np.ascontiguousarray(auto.table).reshape(-1)),
                "byte_class": jnp.asarray(auto.byte_class.astype(np.int32)),
                "used_bytes": jnp.asarray(auto.used_bytes),
                "final_start": jnp.int32(auto.final_start),
            }
        return self._dev

    def scan_compact_device(
        self,
        chunks: np.ndarray,  # [B, L] uint8
        lengths: np.ndarray,  # [B] int32
        emit_from: np.ndarray,  # [B] int32
        init_state: Optional[np.ndarray],  # [B] int32 or None (root)
        capacity: int,
    ):
        """One fixed-capacity scan+compact launch (see ops.scan_jax)."""
        import jax.numpy as jnp

        from ..ops.scan_jax import scan_and_compact

        dev = self.device_arrays
        B = chunks.shape[0]
        if init_state is None:
            init = jnp.zeros((B,), dtype=jnp.int32)
        else:
            init = jnp.asarray(init_state, dtype=jnp.int32)
        return scan_and_compact(
            dev["table_flat"],
            dev["byte_class"],
            dev["used_bytes"],
            jnp.asarray(chunks),
            init,
            jnp.asarray(lengths),
            jnp.asarray(emit_from),
            dev["final_start"],
            n_classes=self.auto.n_classes,
            capacity=capacity,
        )
