"""What nvidia-smi says of the card beside a run: its name, power limit and
SM clock (a card held below its 700 W limit or its top clock runs slower,
so every number is kept with these); and what a run's set-up spent
building the program."""

from __future__ import annotations

import shutil
import subprocess
import sys

FIELDS = ("name", "power.limit", "clocks.sm", "clocks.max.sm")


def smi() -> dict:
    """{"smi_name", "power_limit_w", "sm_clock_mhz", "sm_clock_max_mhz"} of
    card 0, or {} when nvidia-smi is absent or fails."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return {}
    try:
        out = subprocess.run(
            [exe, "--query-gpu=" + ",".join(FIELDS),
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=20, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return {}
    row = [x.strip() for x in out.splitlines()[0].split(",")]
    vals = dict(zip(FIELDS, row))

    def num(key):
        try:
            return float(vals[key])
        except (KeyError, ValueError):
            return None

    return {"smi_name": vals.get("name"), "power_limit_w": num("power.limit"),
            "sm_clock_mhz": num("clocks.sm"),
            "sm_clock_max_mhz": num("clocks.max.sm")}


def build_seconds() -> float:
    """Seconds this process spent building the program's CUDA kernels (one
    nvcc each, in parallel: the longest) and native cores (gcc, one after
    another); 0 once the checkout holds them."""
    total = 0.0
    ops = sys.modules.get("corda_tpu_torch.ops._build")
    if ops is not None and ops.BUILD_SECONDS:
        total += max(ops.BUILD_SECONDS.values())
    native = sys.modules.get("corda_tpu_torch.native")
    if native is not None:
        total += sum(native.BUILD_SECONDS.values())
    return total
