"""The mesh verifier's packed route draws its shadow sample.

A ``TorchMeshVerifier`` with ``shadow_rate`` 1.0 whose kernel accepts every
lane raises the divergence through ``pack_device`` plus ``verify_packed``,
the route a mesh-owning sidecar runs: the packed route is TorchVerifier's,
so it samples as a single device does. The JAX package's ``MeshVerifier``
runs no shadow check on that route (``corda_tpu/crypto/provider.py``
``MeshVerifier.verify_packed``): its case is a strict xfail (ROADMAP.md
queue 3), and fails the day the reference is repaired.
"""

import numpy as np
import pytest
import torch

from corda_tpu.crypto import provider as jprov
from corda_tpu.crypto import ref_ed25519 as jref
from corda_tpu_torch.crypto import provider
from corda_tpu_torch.crypto import ref_ed25519 as ref
from corda_tpu_torch.ops import ed25519 as ted


def _jobs(mod, ref_mod, n=6):
    """n ed25519 jobs over tx-id-sized messages, every third tampered."""
    out = []
    for i in range(n):
        seed = bytes([i + 1]) * 32
        msg = (b"mesh-shadow-%d" % i).ljust(32, b".")
        sig = ref_mod.sign(seed, msg)
        if i % 3 == 2:
            msg = bytes([msg[0] ^ 1]) + msg[1:]
        out.append(mod.VerifyJob(ref_mod.public_key(seed), msg, sig))
    return out


def _raised(verifier, packed):
    """What ``verify_packed`` raised on ``packed``, or None."""
    try:
        verifier.verify_packed(packed)
    except RuntimeError as exc:
        return str(exc)
    return None


@pytest.mark.parametrize("d", [1, 3])
def test_the_port_mesh_samples_its_packed_batches(d, monkeypatch):
    monkeypatch.setattr(ted, "verify_arrays_hashed", lambda a, r, s, m:
                        torch.ones(a.shape[1], dtype=torch.bool))
    v = provider.TorchMeshVerifier(devices=["cpu"] * d, shadow_rate=1.0,
                                   device_min_sigs=0)
    packed = v.pack_device(_jobs(provider, ref))
    assert packed is not None and packed.n_devices == d
    raised = _raised(v, packed)
    assert raised is not None and "divergence" in raised
    assert v.device_batches == 1


@pytest.mark.xfail(strict=True, raises=AssertionError, reason=(
    "ROADMAP.md queue 3: the JAX package's MeshVerifier.verify_packed runs "
    "no shadow check (corda_tpu/crypto/provider.py), so a mesh sidecar "
    "never samples its packed batches"))
def test_the_jax_mesh_samples_its_packed_batches():
    import jax

    if len(jax.devices()) < 2:
        pytest.skip("needs the conftest's virtual CPU mesh")
    v = jprov.MeshVerifier(n_devices=2, shadow_rate=1.0, device_min_sigs=0)
    packed = v.pack_device(_jobs(jprov, jref))
    assert packed is not None and packed.n_devices == 2
    # The kernel accepts every lane, the tampered ones too.
    packed.fn = lambda *arrays: np.ones(packed.bucket, bool)
    raised = _raised(v, packed)
    assert raised is not None and "divergence" in raised
