"""The autotune plane (round 21): a closed-loop controller that turns
perf-doctor verdicts into gated parameter sweeps and self-committed
configs.

Three parts, matching the shape of the loop:

  * :mod:`~corda_tpu_torch.autotune.space` — the typed, bounded knob registry
    over the config keys that actually exist, each knob carrying its
    config path, bounds, step rule and the doctor cause(s) that
    implicate it, with analyzer-style validation pinning the registry
    to ``node/config.py`` so the space can never drift.
  * :mod:`~corda_tpu_torch.autotune.controller` — verdict in, sweep out: a
    deterministic seeded hill-climb over the implicated knobs, every
    candidate measured by an existing loadtest harness and gated
    against the incumbent under ``perfdoctor --gate`` direction+band
    policy (exactly-once flags are hard gates), the winner emitted as
    a TOML overlay plus an ``autotune`` trajectory record with full
    provenance.
  * :mod:`~corda_tpu_torch.autotune.runtime` — the opt-in bounded runtime
    leg: a controller thread feeding live ``round_breakdown`` deltas
    into the adaptive policies that already exist, with hysteresis and
    a hard revert-on-regression guard; off by default and bit-identical
    when disarmed.

``python -m corda_tpu_torch.tools.autotune`` is the CLI face.

The port's own copy of ``corda_tpu/autotune/``.
"""

from . import controller, runtime, space

__all__ = ["controller", "runtime", "space"]
