"""The port's device-owning sidecar with ``devices=N``
(corda_tpu_torch/crypto/sidecar.py over ops/sharded.py): the mirror of
tests/test_sidecar_mesh.py. The mesh here is copies of the CPU device
(each slice runs the plain versions); parity with the single-device and
host tiers, pad-lane masking and per-device attribution, and the port's
answer to a mesh the host cannot build: the server refuses to start (the
JAX package's stays up on its host tier, tests/test_sidecar_mesh.py:147).
The adaptive coalesce_us policy runs on both packages' servers."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from corda_tpu.crypto import sidecar as jsc
from corda_tpu.crypto.provider import CpuVerifier as JaxCpuVerifier
from corda_tpu_torch.crypto import sidecar as sc
from corda_tpu_torch.crypto.keys import KeyPair
from corda_tpu_torch.crypto.provider import (CpuVerifier, TorchMeshVerifier,
                                             TorchVerifier, VerifyJob)
from corda_tpu_torch.crypto.sidecar import SidecarServer
from corda_tpu_torch.node.verify_client import SidecarVerifier


def _address(tmp_path, name="s.sock") -> str:
    path = str(tmp_path / name)
    return path if len(path) < 100 else "127.0.0.1:0"


def _jobs(n, reject_every=5):
    """n well-formed ed25519 jobs, every reject_every-th sig corrupted --
    accept AND reject lanes so pad masking can't hide a wrong answer."""
    out = []
    for i in range(n):
        kp = KeyPair.generate(bytes([(i % 250) + 1]) * 32)
        msg = (b"mesh-%04d" % i).ljust(32, b".")
        sig = bytes(kp.sign(msg).bytes)
        if i % reject_every == reject_every - 1:
            sig = sig[:7] + bytes([sig[7] ^ 0x20]) + sig[8:]
        out.append(VerifyJob(bytes(kp.public.encoded), msg, sig))
    return out


def test_mesh_sidecar_parity_pad_masking_and_stats(tmp_path):
    srv = SidecarServer(
        _address(tmp_path),
        verifier=TorchMeshVerifier(devices=[torch.device("cpu")] * 8,
                                   device_min_sigs=0),
        coalesce_us=0, devices=8).start()
    try:
        assert srv.stats()["mesh_devices"] == 8  # proven in start()
        # 19 lanes on an 8-wide mesh pad to 24: 5 pad lanes that must
        # verify False without leaking into (or out of) the real lanes.
        jobs = _jobs(19)
        want = CpuVerifier().verify_batch(jobs)
        assert want.any() and not want.all()
        cli = SidecarVerifier(srv.address, device_min_sigs=0,
                              deadline_ms=120_000.0, devices=8)
        out = cli.verify_batch(jobs)
        assert np.array_equal(out, want), (out.tolist(), want.tolist())
        assert cli.fallbacks == 0
        assert cli.last_tier == "device"

        stats = srv.stats()
        assert stats["device_batches"] == 1
        assert stats["host_batches"] == 0
        assert stats["device_occupancy"] == 1.0
        assert stats["packed_batches"] == 1
        assert stats["pack_s_total"] > 0.0
        assert stats["device_lanes"] == 24
        assert stats["pad_lanes"] == 24 - 19
        assert stats["pad_fraction"] == round(5 / 24, 4)
        assert stats["per_device_occupancy"] == round(19 / 24, 4)
        assert stats["per_device_batch_sigs_hist"] == {"3": 1}
        assert stats["devices"] == 8

        side = cli.sidecar_stats()
        assert side["devices"] == 8
        assert side["server"]["mesh_devices"] == 8
        assert side["server"]["per_device_occupancy"] == round(19 / 24, 4)
    finally:
        srv.stop()


def test_mesh_matches_single_device_tier_bit_exact(tmp_path):
    jobs = _jobs(37, reject_every=4)
    single = TorchVerifier(device="cpu", device_min_sigs=0).verify_batch(jobs)
    srv = SidecarServer(
        _address(tmp_path),
        verifier=TorchMeshVerifier(devices=[torch.device("cpu")] * 4,
                                   device_min_sigs=0),
        coalesce_us=0, devices=4).start()
    try:
        cli = SidecarVerifier(srv.address, device_min_sigs=0,
                              deadline_ms=120_000.0)
        out = cli.verify_batch(jobs)
        assert np.array_equal(out, single)
        assert np.array_equal(out, CpuVerifier().verify_batch(jobs))
        assert srv.stats()["device_lanes"] == 40  # 37 padded to 4 x 10
    finally:
        srv.stop()


def test_unbuildable_mesh_refuses_to_start(tmp_path, monkeypatch):
    """Where the JAX package's server stays up on its exact host tier, the
    port's raises in start(), before it listens: a host with one card
    cannot own a 2-card mesh."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    address = _address(tmp_path)
    srv = SidecarServer(address, verifier=TorchMeshVerifier(n_devices=2),
                        coalesce_us=0, devices=2)
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        srv.start()
    assert srv.mesh_devices is None and srv._listener is None
    assert srv.stats()["device_lanes"] == 0


def test_cli_devices_beyond_the_host_exits_before_its_banner(tmp_path):
    """--devices 2 on a host that cannot give two cards exits non-zero and
    never prints "sidecar up"."""
    proc = subprocess.run(
        [sys.executable, "-m", "corda_tpu_torch.crypto.sidecar", "--socket",
         _address(tmp_path), "--devices", "2"],
        capture_output=True, text=True, timeout=120,
        env={**__import__("os").environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert "sidecar up" not in proc.stdout


def test_devices_one_keeps_single_device_verifier():
    make = SidecarServer._make_server_verifier
    assert make("torch", 1, "cpu").name == "torch"
    assert make("torch", 0, "cpu").name == "torch"
    assert make("torch", 8, "cpu").name == "torch-sharded"
    assert len(make("torch", 8, "cpu").mesh) == 8
    assert make("torch-shadow", 4, "cpu").shadow_rate == 0.05
    assert len(make("torch-sharded", 2, "cpu").mesh) == 2
    assert make("cpu", 8, "cpu").name == "cpu-openssl"


def test_pad_to_devices_arithmetic():
    for mod in (sc, jsc):
        assert mod.pad_to_devices(19, 8) == 24
        assert mod.pad_to_devices(64, 8) == 64
        assert mod.pad_to_devices(1, 8) == 8
        assert mod.pad_to_devices(0, 8) == 8
        assert mod.pad_to_devices(65, 8) == 72
        assert mod.pad_to_devices(100, 1) == 100
        for b in mod.BUCKETS:
            for ndev in (1, 2, 4, 8):
                assert mod.pad_to_devices(b, ndev) == b


# -- adaptive coalesce_us (no timing: the policy is driven directly) --------

PKGS = {"corda_tpu": (jsc, JaxCpuVerifier), "corda_tpu_torch": (sc,
                                                                CpuVerifier)}


def _adapt_server(pkg, coalesce_us, max_sigs=4096):
    mod, cpu = PKGS[pkg]
    return mod.SidecarServer("/tmp/unused-adapt.sock", verifier=cpu(),
                             coalesce_us=coalesce_us, max_sigs=max_sigs,
                             adaptive_coalesce=True)


def _feed(pkg, srv, n_requests, n_sigs):
    for _ in range(PKGS[pkg][0].ADAPT_WINDOW):
        srv._adapt_observe(n_requests, n_sigs)


@pytest.mark.parametrize("pkg", PKGS)
def test_adaptive_coalesce_shrinks_when_batches_fill_early(pkg):
    srv = _adapt_server(pkg, 1000)
    _feed(pkg, srv, n_requests=4, n_sigs=2048)
    assert srv.coalesce_us == 750
    assert srv.coalesce_adjustments == 1
    assert srv.coalesce_us_initial == 1000


@pytest.mark.parametrize("pkg", PKGS)
def test_adaptive_coalesce_grows_only_while_coalescing(pkg):
    srv = _adapt_server(pkg, 1000)
    _feed(pkg, srv, n_requests=1, n_sigs=100)
    assert srv.coalesce_us == 1000
    _feed(pkg, srv, n_requests=3, n_sigs=100)
    assert srv.coalesce_us == 1500
    srv0 = _adapt_server(pkg, 0)
    _feed(pkg, srv0, n_requests=2, n_sigs=64)
    assert srv0.coalesce_us == PKGS[pkg][0].ADAPT_SEED_US


@pytest.mark.parametrize("pkg", PKGS)
def test_adaptive_coalesce_hysteresis_band_and_ceiling(pkg):
    srv = _adapt_server(pkg, 1000)
    _feed(pkg, srv, n_requests=4, n_sigs=1500)
    assert srv.coalesce_us == 1000
    assert srv.coalesce_adjustments == 0
    srv_hi = _adapt_server(pkg, 19_000)
    _feed(pkg, srv_hi, n_requests=2, n_sigs=64)
    assert srv_hi.coalesce_us == PKGS[pkg][0].ADAPT_CEILING_US


@pytest.mark.parametrize("pkg", PKGS)
def test_adaptive_coalesce_off_by_default(pkg):
    mod, cpu = PKGS[pkg]
    srv = mod.SidecarServer("/tmp/unused-adapt.sock", verifier=cpu(),
                            coalesce_us=0)
    assert srv.adaptive_coalesce is False
    stats = srv.stats()
    assert stats["adaptive_coalesce"] is False
    assert stats["coalesce_adjustments"] == 0
