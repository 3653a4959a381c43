"""corda_tpu_torch.qos — priority lanes, deadlines, and admission control.

The port's own copy of ``corda_tpu/qos``.

See context.py for the propagation model (mirrors obs/trace arming) and
admission.py for the entry-point shed policy. Import the submodule
directly at instrumentation points (``from ..qos import context as
_qos``) so the one-attribute disarmed check stays cheap and explicit.
"""

from .admission import AdmissionController, TokenBucket
from .calibrate import apply_calibration, calibrate_admission
from .context import (LANES, LANE_BULK, LANE_INTERACTIVE, QosContext,
                      QosPlane, arm, arm_from_env, clear_context, disarm,
                      get_context, set_context)

# NOTE: ``ACTIVE`` is deliberately NOT re-exported — a from-import would
# freeze the binding at import time. Instrumentation points import the
# submodule (``from ..qos import context as _qos``) and read
# ``_qos.ACTIVE`` so arming is always seen.

__all__ = [
    "AdmissionController",
    "apply_calibration",
    "calibrate_admission",
    "LANES",
    "LANE_BULK",
    "LANE_INTERACTIVE",
    "QosContext",
    "QosPlane",
    "TokenBucket",
    "arm",
    "arm_from_env",
    "clear_context",
    "disarm",
    "get_context",
    "set_context",
]
