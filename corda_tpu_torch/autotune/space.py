"""The autotune knob registry: a typed, bounded parameter space over the
config keys that already exist in this tree.

Every :class:`Knob` names a real lever — a ``section.key`` in
``node/config.py``, a loadtest-harness kwarg, or a documented env var —
plus its bounds, step rule, default, and the doctor cause(s) that
implicate it (the causes mirror ``obs/doctor.RULE_SPECS``; the
cross-reference is validated both ways). The controller never invents a
knob: a sweep spec is a subset of THIS registry, so every candidate it
tries is a config a human could have written by hand.

:func:`validate_registry` is the analyzer-style drift guard: every
config-target knob must resolve to a live dataclass field of
``node/config.py``, every harness-target knob to a real keyword of the
named ``tools/loadtest.py`` function, and every env-target knob's
variable name must appear in the source of the module that reads it.
A registry entry that stops resolving fails the test suite, exactly like
a stale stage name fails the trace-stage-registry rule.

Stdlib-only; imports of config/loadtest happen inside the validator so
the registry itself stays importable from bare tool processes.

The port's own copy of ``corda_tpu/autotune/space.py``: the same knobs,
bounds and validator; the env knob names the port's sidecar client.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = [
    "KNOBS",
    "Knob",
    "changed_values",
    "default_values",
    "env_for",
    "harness_kwargs_for",
    "knob_applies",
    "knobs_for",
    "neighbors",
    "overlay_for",
    "overlay_toml",
    "step_down",
    "step_up",
    "validate_registry",
]

# Target kinds: where a knob's value lands when a candidate runs.
#   config:<section>.<key>   -> CORDA_TPU_CONFIG_OVERLAY entry
#   harness:<func>:<kwarg>   -> keyword of a tools/loadtest.py harness
#   env:<VAR>:<module>       -> env var read by <module>
_CONFIG, _HARNESS, _ENV = "config", "harness", "env"


@dataclass(frozen=True)
class Knob:
    """One bounded lever. ``step`` is multiplicative when ``step_mode``
    is "mul" (doubling walks a log-scale space in few trials) and
    additive when "add"; ``seed`` is the first non-zero value a "mul"
    step proposes when the current value is 0 (0 * 2 goes nowhere)."""

    name: str               # registry key, e.g. "raft.pipeline_window"
    target: str             # "config:raft.pipeline_window", see above
    kind: str               # "int" | "float"
    lo: float
    hi: float
    step: float
    step_mode: str          # "mul" | "add"
    default: float
    causes: tuple           # doctor causes implicating this knob
    seed: float = 0.0       # mul-from-zero seed (0 = unused)


KNOBS: dict = {k.name: k for k in (
    # Verify plane: the sidecar accumulation window (harness-level knob —
    # the sweep passes it to the sidecar argv via run_slo_sweep) and the
    # device-routing floor (env knob read by node/verify_client.py).
    Knob("sidecar.coalesce_us", "harness:run_slo_sweep:sidecar_coalesce_us",
         "int", 0, 20_000, 2.0, "mul", 2000,
         ("device_occupancy", "verify", "verify_wait"), seed=250),
    Knob("batch.device_min_sigs",
         "env:CORDA_TPU_SIDECAR_MIN_SIGS:corda_tpu_torch.node.verify_client",
         "int", 1, 4096, 2.0, "mul", 16,
         ("device_occupancy", "pad_fraction", "verify")),
    # Batch/verify config ([batch] in node.toml).
    Knob("batch.coalesce_ms", "config:batch.coalesce_ms",
         "float", 0.0, 10.0, 2.0, "mul", 0.0,
         ("rounds", "poll", "seal", "fsync"), seed=0.5),
    Knob("batch.max_sigs", "config:batch.max_sigs",
         "int", 256, 16_384, 2.0, "mul", 4096,
         ("pad_fraction",)),
    Knob("batch.async_depth", "config:batch.async_depth",
         "int", 1, 16, 2.0, "mul", 2,
         ("verify_wait",)),
    # Raft commit plane ([raft]).
    Knob("raft.pipeline_window", "config:raft.pipeline_window",
         "int", 64, 8192, 2.0, "mul", 1024,
         ("replicate",)),
    Knob("raft.append_chunk", "config:raft.append_chunk",
         "int", 32, 2048, 2.0, "mul", 256,
         ("replicate", "seal")),
    Knob("raft.apply_queue_depth", "config:raft.apply_queue_depth",
         "int", 256, 65_536, 2.0, "mul", 4096,
         ("apply", "rounds")),
    # Admission ([qos]) — the calibrate_admission levers.
    Knob("qos.interactive_rate", "config:qos.interactive_rate",
         "float", 0.0, 1e6, 2.0, "mul", 0.0,
         ("admission",), seed=100.0),
    Knob("qos.bulk_rate", "config:qos.bulk_rate",
         "float", 0.0, 1e6, 2.0, "mul", 0.0,
         ("admission",), seed=100.0),
    Knob("qos.queue_watermark", "config:qos.queue_watermark",
         "int", 0, 8192, 2.0, "mul", 0,
         ("admission",), seed=64),
    # Sharded notary ([notary_shards]).
    Knob("notary_shards.count", "config:notary_shards.count",
         "int", 1, 4, 2.0, "mul", 1,
         ("rounds",)),
    # Vault engine ([vault]) — a boolean lever walked as 0/1: arming it
    # swaps the in-memory vault for the sqlite indexed engine when the
    # doctor's vault_scan rule fires.
    Knob("vault.indexed", "config:vault.indexed",
         "int", 0, 1, 1.0, "add", 0,
         ("vault_scan",)),
)}


def _quantize(knob: Knob, value: float) -> float:
    value = min(knob.hi, max(knob.lo, value))
    if knob.kind == "int":
        return int(round(value))
    return round(float(value), 6)


def step_up(knob: Knob, value: float):
    """The next larger candidate value, or None at the upper bound."""
    if knob.step_mode == "mul":
        nxt = knob.seed if (value == 0 and knob.seed) else value * knob.step
    else:
        nxt = value + knob.step
    nxt = _quantize(knob, nxt)
    return nxt if nxt > value else None


def step_down(knob: Knob, value: float):
    """The next smaller candidate value, or None at the lower bound
    (a "mul" knob seeded from zero steps back down to zero)."""
    if knob.step_mode == "mul":
        nxt = 0.0 if (knob.seed and value <= knob.seed) else \
            value / knob.step
    else:
        nxt = value - knob.step
    nxt = _quantize(knob, nxt)
    return nxt if nxt < value else None


def neighbors(knob: Knob, value: float) -> tuple:
    """(up, down) candidates around ``value``, Nones dropped."""
    return tuple(v for v in (step_up(knob, value), step_down(knob, value))
                 if v is not None)


def knobs_for(cause: str) -> tuple:
    """Registry knobs a doctor cause implicates, in registry order."""
    return tuple(k for k in KNOBS.values() if cause in k.causes)


def knob_applies(knob: Knob, harness_fn: str) -> bool:
    """Whether a knob can reach a run measured by ``harness_fn``:
    config/env knobs reach every spawned process (overlay env / env
    var); a harness-target knob only applies to its own function."""
    kind, _, rest = knob.target.partition(":")
    if kind != _HARNESS:
        return True
    return rest.split(":", 1)[0] == harness_fn


def default_values(names) -> dict:
    """name -> hand-tuned default for a knob subset (the incumbent)."""
    return {n: KNOBS[n].default for n in names}


def changed_values(values: dict) -> dict:
    """The subset of ``values`` that differs from the hand-tuned
    defaults — what a candidate actually ships. Shipping a default is
    not always a no-op (a ``[notary_shards]`` section with the default
    count still ENABLES sharding on a node that had none), so the
    incumbent must travel with no overlay at all."""
    return {n: v for n, v in values.items() if v != KNOBS[n].default}


def overlay_for(values: dict) -> dict:
    """The nested config dict for the config-target knobs in ``values``
    — the ``CORDA_TPU_CONFIG_OVERLAY`` payload. Non-config knobs
    (harness/env targets) are skipped; they travel by other roads."""
    out: dict = {}
    for name, value in sorted(values.items()):
        knob = KNOBS[name]
        kind, _, rest = knob.target.partition(":")
        if kind != _CONFIG:
            continue
        section, key = rest.split(".", 1)
        out.setdefault(section, {})[key] = value
    return out


def overlay_toml(values: dict) -> str:
    """The committed-config rendering: the same overlay as TOML text an
    operator can drop next to node.toml (or paste into it)."""
    lines = []
    for section, keys in sorted(overlay_for(values).items()):
        lines.append(f"[{section}]")
        for key, value in sorted(keys.items()):
            if isinstance(value, bool):
                rendered = "true" if value else "false"
            else:
                rendered = repr(value)
            lines.append(f"{key} = {rendered}")
        lines.append("")
    return "\n".join(lines)


def env_for(values: dict) -> dict:
    """Env-var assignments for the env-target knobs in ``values``."""
    out = {}
    for name, value in sorted(values.items()):
        knob = KNOBS[name]
        kind, _, rest = knob.target.partition(":")
        if kind == _ENV:
            var = rest.split(":", 1)[0]
            out[var] = str(value)
    return out


def harness_kwargs_for(values: dict, func_name: str) -> dict:
    """Keyword overrides for harness-target knobs bound to ``func_name``."""
    out = {}
    for name, value in sorted(values.items()):
        knob = KNOBS[name]
        kind, _, rest = knob.target.partition(":")
        if kind == _HARNESS:
            fn, kwarg = rest.split(":", 1)
            if fn == func_name:
                out[kwarg] = value
    return out


# ---------------------------------------------------------------------------
# Drift validation (analyzer-style: run by the test suite, importable by
# the CLI's --validate).
# ---------------------------------------------------------------------------


def _config_sections() -> dict:
    """section name -> dataclass type, from node/config.py itself."""
    from ..node import config as _config
    return {
        "batch": _config.BatchConfig,
        "raft": _config.RaftConfig,
        "qos": _config.QosConfig,
        "durability": _config.DurabilityConfig,
        "notary_shards": _config.ShardConfig,
        "vault": _config.VaultConfig,
    }


def validate_registry() -> list:
    """Every registry entry must resolve to a live lever; every doctor
    rule-spec knob must resolve to a registry entry. Returns the list of
    violations (empty = the space matches the tree)."""
    import dataclasses
    import importlib
    import inspect

    errors = []
    sections = _config_sections()
    for knob in KNOBS.values():
        kind, _, rest = knob.target.partition(":")
        if kind == _CONFIG:
            section, _, key = rest.partition(".")
            cls = sections.get(section)
            if cls is None:
                errors.append(f"{knob.name}: unknown config section "
                              f"[{section}]")
            elif key not in {f.name for f in dataclasses.fields(cls)}:
                errors.append(f"{knob.name}: no field {key!r} on "
                              f"{cls.__name__}")
        elif kind == _HARNESS:
            fn_name, _, kwarg = rest.partition(":")
            from ..tools import loadtest as _loadtest
            fn = getattr(_loadtest, fn_name, None)
            if fn is None:
                errors.append(f"{knob.name}: no harness "
                              f"loadtest.{fn_name}")
            elif kwarg not in inspect.signature(fn).parameters:
                errors.append(f"{knob.name}: loadtest.{fn_name} has no "
                              f"kwarg {kwarg!r}")
        elif kind == _ENV:
            var, _, module = rest.partition(":")
            try:
                src = inspect.getsource(importlib.import_module(module))
            except (ImportError, OSError):
                errors.append(f"{knob.name}: cannot read source of "
                              f"{module}")
                continue
            if var not in src:
                errors.append(f"{knob.name}: env var {var} not read by "
                              f"{module}")
        else:
            errors.append(f"{knob.name}: unknown target kind {kind!r}")
        if not (knob.lo <= knob.default <= knob.hi):
            errors.append(f"{knob.name}: default {knob.default} outside "
                          f"[{knob.lo}, {knob.hi}]")
        if knob.step_mode not in ("mul", "add"):
            errors.append(f"{knob.name}: bad step_mode {knob.step_mode!r}")

    # The doctor's structured specs must stay a subset of this registry.
    from ..obs import doctor as _doctor
    for table_name in ("RULE_SPECS", "PIPELINED_RULE_SPECS"):
        table = getattr(_doctor, table_name)
        for cause, spec in table.items():
            for name in spec.get("knobs", ()):
                if name not in KNOBS:
                    errors.append(f"doctor.{table_name}[{cause!r}] names "
                                  f"unknown knob {name!r}")
    return errors
