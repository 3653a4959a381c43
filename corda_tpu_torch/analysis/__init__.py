"""Static invariant analyzer for the corda_tpu_torch tree.

``python -m corda_tpu_torch.analysis corda_tpu_torch/`` runs every rule over the tree
and exits 0 iff no live (unsuppressed, unbaselined) findings remain. The
rules machine-check the framework's load-bearing prose invariants —
determinism of the replicated apply paths, no silent exception swallowing
on verify/notarise paths, one build of each kernel library and mesh (no
per-call compile), no blocking I/O or device synchronisation under
general-purpose locks, an acyclic lock-acquisition graph, and span names
drawn from the obs stage registry.

Stdlib-only (``ast`` + ``json`` + ``re``): importable and runnable with no
torch present, so tier-1 and bare CI shells can gate on it.

The port's own copy of ``corda_tpu/analysis``: the same six rules, engine,
suppressions and baseline semantics, scanning ``corda_tpu_torch`` with its
own (empty) baseline; where a rule names JAX's idiom, it names the port's
counterpart (see ``rules.NoJitInHotpath`` and ``NoBlockingUnderLock``).
"""

from __future__ import annotations

from .engine import (
    DEFAULT_BASELINE,
    FileContext,
    Finding,
    Report,
    Rule,
    analyze_paths,
    analyze_source,
    baseline_entries_from_findings,
    load_baseline,
)
from .rules import ALL_RULES

__all__ = [
    "ALL_RULES",
    "DEFAULT_BASELINE",
    "FileContext",
    "Finding",
    "Report",
    "Rule",
    "analyze_paths",
    "analyze_source",
    "baseline_entries_from_findings",
    "load_baseline",
]
