"""php_aho_corasick_tpu — an accelerator multi-pattern matching framework.

A ground-up re-design of the capabilities of the ``ahocorasick`` PHP
extension (ph4r05/php_aho_corasick, wrapping MultiFast v2.0): Aho-Corasick
multi-pattern search with byte-exact positions, pattern metadata
(key/id/aux), incremental build + finalize lifecycle, streaming, and
search-and-replace — built on JAX/XLA:

* trie + BFS failure links compiled into a dense byte-class-compressed
  transition table (one gather per scanned byte — no failure chasing);
* batched, halo-overlapped chunk scanning for throughput and long inputs;
* data-parallel corpus sharding over a ``jax.sharding.Mesh`` with the table
  replicated per device and match results reduced via collectives;
* a C++ native builder for million-pattern (signature-scale) automata.
"""

from .api import DeviceCorpus, Matcher, StateError
from .compat import (
    ahocorasick_add_patterns,
    ahocorasick_deinit,
    ahocorasick_finalize,
    ahocorasick_init,
    ahocorasick_isValid,
    ahocorasick_match,
)
from .config import DEFAULT_CONFIG, ScanConfig
from .core.tables import CompiledAutomaton
from .errors import AddStatus, AhoError, AhoException, AhoWarning
from .patterns import Pattern, PatternFormatError

__version__ = "0.1.0"

__all__ = [
    "Matcher",
    "DeviceCorpus",
    "ScanConfig",
    "DEFAULT_CONFIG",
    "CompiledAutomaton",
    "Pattern",
    "PatternFormatError",
    "StateError",
    "AddStatus",
    "AhoError",
    "AhoException",
    "AhoWarning",
    "ahocorasick_init",
    "ahocorasick_add_patterns",
    "ahocorasick_finalize",
    "ahocorasick_match",
    "ahocorasick_isValid",
    "ahocorasick_deinit",
    "__version__",
]
