"""The port's multi-device verify (corda_tpu_torch/ops/sharded.py,
provider.TorchMeshVerifier) against the JAX package's shard_map tier on
its 8-device virtual CPU mesh and against the oracle: the mirror of
tests/test_sharded.py. The port's CPU mesh is ``[torch.device("cpu")] *
8``: each slice runs the plain versions, so the padding, the slicing and
the lane order are what is held to the reference here; the kernels'
per-device launches run on the card (chip_smoke.py phase 27)."""

import numpy as np
import pytest
import torch

import jax

from corda_tpu.crypto import ref_ed25519 as ref
from corda_tpu.ops import ed25519_jax
from corda_tpu.ops import sharded as jsharded
from corda_tpu_torch.crypto.provider import (TorchMeshVerifier, TorchVerifier,
                                             VerifyJob, make_verifier)
from corda_tpu_torch.ops import ed25519 as ted
from corda_tpu_torch.ops import sharded

CPU8 = [torch.device("cpu")] * 8
# Each CPU slice runs the plain versions (~2 s a slice here), so the cases
# that need no 8-wide parity with the JAX mesh split over fewer copies.
CPU4 = [torch.device("cpu")] * 4


@pytest.fixture(scope="module")
def jax_mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs the conftest's 8-device virtual CPU mesh")
    return jsharded.make_mesh(8)


def _sig_fixture(n, pad_to=0):
    """tests/test_sharded.py's fixture: a third corrupted (R byte, S byte
    or the key); ``pad_to`` pads each message before it is signed."""
    pks, msgs, sigs = [], [], []
    for i in range(n):
        sk = bytes([(i % 255) + 1]) * 32
        pk = ref.public_key(sk)
        m = (b"shard-%d" % i).ljust(pad_to, b"-")
        s = ref.sign(sk, m)
        if i % 3 == 2:
            which = i % 9
            if which == 2:
                s = bytes([s[0] ^ 1]) + s[1:]
            elif which == 5:
                s = s[:40] + bytes([s[40] ^ 1]) + s[41:]
            else:
                pk = bytes([pk[0] ^ 1]) + pk[1:]
        pks.append(pk)
        msgs.append(m)
        sigs.append(s)
    return pks, msgs, sigs


def _oracle(pks, msgs, sigs):
    return [ref.verify(p, m, s) for p, m, s in zip(pks, msgs, sigs)]


def test_sharded_verify_matches_oracle_and_jax(jax_mesh):
    pks, msgs, sigs = _sig_fixture(19)  # ragged: exercises pad-and-mask
    got = sharded.verify_batch_sharded(pks, msgs, sigs, sharded.make_mesh(
        devices=CPU8))
    want = _oracle(pks, msgs, sigs)
    assert got.tolist() == want
    assert sum(want) not in (0, len(want))
    assert got.tolist() == jsharded.verify_batch_sharded(
        pks, msgs, sigs, jax_mesh).tolist()


def test_sharded_rejects_malformed_without_raising():
    pks, msgs, sigs = _sig_fixture(4)
    pks[1] = b"\x01" * 7        # wrong-length key
    sigs[2] = b"\x02" * 11      # wrong-length sig
    got = sharded.verify_batch_sharded(
        pks, msgs, sigs, sharded.make_mesh(devices=[torch.device("cpu")] * 2))
    assert got[0] and not got[1] and not got[2]


@pytest.mark.parametrize("mod", [jsharded, sharded], ids=["jax", "port"])
def test_pad_to_devices(mod):
    assert mod.pad_to_devices(1, 8) == 8
    assert mod.pad_to_devices(8, 8) == 8
    assert mod.pad_to_devices(9, 8) == 16
    assert mod.pad_to_devices(0, 8) == 8


def test_sharded_device_hash_path_matches_oracle(jax_mesh):
    pks, msgs, sigs = _sig_fixture(19)
    msgs32 = [m.ljust(32, b".") for m in msgs]
    sigs32 = [ref.sign(bytes([(i % 255) + 1]) * 32, msgs32[i])
              if ref.verify(pks[i], msgs[i], sigs[i]) else sigs[i]
              for i in range(len(sigs))]
    packed = sharded.pack_batch_sharded(pks, msgs32, sigs32,
                                        sharded.make_mesh(devices=CPU4))
    assert packed.fn is ted.verify_arrays_hashed  # the device-hash graph
    got = sharded.dispatch_packed(packed)
    want = _oracle(pks, msgs32, sigs32)
    assert got.tolist() == want
    assert any(want) and not all(want)
    assert got.tolist() == jsharded.verify_batch_sharded(
        pks, msgs32, sigs32, jax_mesh).tolist()


def test_a_few_hundred_lanes_with_malformed_and_pad_lanes(jax_mesh):
    """250 lanes of tx-id-sized messages, 7 of them malformed: the 243
    well-formed pad to 248 on the 8-wide mesh (31 a device); the mask
    equals the JAX package's on its mesh and the oracle's, lane for
    lane."""
    pks, msgs, sigs = _sig_fixture(250, pad_to=32)
    for i in (3, 40, 41, 150, 151, 248, 249):
        if i % 2:
            pks[i] = pks[i][:31]
        else:
            sigs[i] = sigs[i] + b"\x00"
    mesh = sharded.make_mesh(devices=CPU8)
    packed = sharded.pack_batch_sharded(pks, msgs, sigs, mesh)
    assert (packed.bucket, packed.pad_lanes, len(packed.good)) == (248, 5, 243)
    assert [a[0].shape for a in packed.arrays] == [(8, 31)] * 8
    got = sharded.dispatch_packed(packed)
    want = _oracle(pks, msgs, sigs)
    assert got.tolist() == want
    assert got.tolist() == jsharded.verify_batch_sharded(
        pks, msgs, sigs, jax_mesh).tolist()


def test_sharded_verify_fn_on_the_jax_packers_words(jax_mesh):
    """The same (8, N) words through both packages' sharded verify graphs:
    the challenge-and-verify twin of the JAX package's jit(shard_map)."""
    pks, msgs, sigs = _sig_fixture(16, pad_to=32)
    arrays, n = ed25519_jax.precompute_batch_device(pks, msgs, sigs,
                                                    bucket=64)
    host = [np.asarray(a) for a in arrays]
    got = sharded.sharded_verify_hashed_fn(
        sharded.make_mesh(devices=CPU4))(*host)
    want = np.asarray(jsharded.sharded_verify_hashed_fn(jax_mesh)(*arrays))
    assert got.tolist() == want.tolist()
    assert got[:n].tolist() == _oracle(pks, msgs, sigs)


def test_mesh_verifier_provider_on_mesh():
    v = make_verifier("torch-sharded", device="cpu")
    assert isinstance(v, TorchMeshVerifier) and v.name == "torch-sharded"
    assert v.mesh == (torch.device("cpu"),)
    v = TorchMeshVerifier(devices=CPU4, device_min_sigs=0)
    pks, msgs, sigs = _sig_fixture(21)
    jobs = [VerifyJob(p, m, s) for p, m, s in zip(pks, msgs, sigs)]
    got = v.verify_batch(jobs)
    assert got.tolist() == _oracle(pks, msgs, sigs)
    assert len(v.mesh) == 4 and v.kernel_backend == "torch-cpu"
    assert (v.device_batches, v.host_batches) == (1, 0)
    assert v.verify_batch([]).tolist() == []


def test_mesh_verifier_shadow_divergence_raises(monkeypatch):
    v = TorchMeshVerifier(devices=[torch.device("cpu")] * 2, shadow_rate=1.0,
                          device_min_sigs=0)
    pks, msgs, sigs = _sig_fixture(5)
    jobs = [VerifyJob(p, m, s) for p, m, s in zip(pks, msgs, sigs)]
    assert len(v.verify_batch(jobs)) == 5  # agreement: no raise
    # A wrong device answer is caught by the shadow check: the host-hashed
    # messages' kernel accepts every lane, the tampered ones too.
    monkeypatch.setattr(ted, "verify_arrays", lambda a, r, s, h: torch.ones(
        a.shape[1], dtype=torch.bool))
    with pytest.raises(RuntimeError, match="divergence"):
        v.verify_batch(jobs)


def test_node_config_selects_the_mesh_verifier(tmp_path):
    """verifier = "torch-sharded" is a config kind; on a host without a
    card the node refuses to build it (no host-tier fallback)."""
    from corda_tpu_torch.node.config import NodeConfig
    from corda_tpu_torch.node.node import Node

    cfg = tmp_path / "node.toml"
    cfg.write_text(f'name = "Meshy"\nbase_dir = "{tmp_path}/meshy"\n'
                   'verifier = "torch-sharded"\n')
    config = NodeConfig.load(str(cfg))
    assert config.verifier == "torch-sharded"
    if torch.cuda.is_available():
        pytest.skip("this case checks the refusal on a host without a card")
    with pytest.raises(RuntimeError, match="cuda"):
        Node(config)


def test_a_mesh_wider_than_the_host_raises(monkeypatch):
    """A host with one card: a 2-device mesh raises at build, in
    make_mesh and in TorchMeshVerifier's mesh; one device builds."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        sharded.make_mesh(2)
    v = TorchMeshVerifier(n_devices=2)
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        v.mesh
    assert sharded.make_mesh() == (torch.device("cuda", 0),)
    assert sharded.make_mesh(1) == (torch.device("cuda", 0),)


def test_one_device_path_is_the_single_device_verifiers(monkeypatch):
    """D = 1: no pad lane, one call of the graph, and the mask equal to
    TorchVerifier's on the same jobs."""
    pks, msgs, sigs = _sig_fixture(9)
    msgs = [m.ljust(32, b"+") for m in msgs]
    jobs = [VerifyJob(p, m, s) for p, m, s in zip(pks, msgs, sigs)]
    calls = []
    real = ted.verify_arrays_hashed

    def counted(*words):
        calls.append(words[0].shape)
        return real(*words)

    monkeypatch.setattr(ted, "verify_arrays_hashed", counted)
    packed = sharded.pack_batch_sharded(pks, msgs, sigs,
                                        sharded.make_mesh(devices=["cpu"]))
    assert packed.pad_lanes == 0 and packed.bucket == 9
    got = sharded.dispatch_packed(packed)
    assert calls == [(8, 9)]
    assert got.tolist() == TorchVerifier(
        device="cpu", device_min_sigs=0).verify_batch(jobs).tolist()
