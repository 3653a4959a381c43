"""Observability of the port: the span recorder (``trace``), the always-on
metric registry (``telemetry``) and its Prometheus exposition (``export``).

Own copies of ``corda_tpu/obs/{trace,telemetry,export}.py``, stdlib only, so
the verify plane can count and trace without importing torch or anything
of the JAX package.
"""

from . import trace  # noqa: F401  (re-export: corda_tpu_torch.obs.trace)
