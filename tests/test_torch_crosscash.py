"""The port's CrossCash (corda_tpu_torch/tools/crosscash.py) against the
JAX package's: the mirror of tests/test_crosscash.py (the model and the
matcher, the generator, and the three process cases, slow as in the
reference, on the host placement), plus ``generate_wave`` under one seed
giving the same commands in both packages, and the card placement as the
default that raises on a host without one.
"""

import random

import pytest

from corda_tpu.tools import crosscash as ref
from corda_tpu_torch.tools.crosscash import (
    CORDAPP,
    CrossCashCommand,
    CrossCashModel,
    generate_wave,
    main,
    run_crosscash,
    vaults_match,
    verify_tiers,
)


def test_model_and_matcher_unit():
    m = CrossCashModel()
    m.apply(CrossCashCommand("issue", "A", 500, "B", 1))
    m.apply(CrossCashCommand("pay", "B", 200, "C"))
    assert m.balances == {"B": 300, "C": 200}
    assert vaults_match({"B": 300, "C": 200},
                        {"B": {"A": 300}, "C": {"A": 200}})
    assert not vaults_match({"B": 300}, {"B": {"A": 299}})   # lost update
    assert not vaults_match({"B": 300}, {"B": {"A": 600}})   # double spend
    assert vaults_match({"B": 0}, {})                        # absent == zero
    with pytest.raises(ValueError):
        m.apply(CrossCashCommand("pay", "A", 1, "B"))
    with pytest.raises(ValueError):
        m.apply(CrossCashCommand("burn", "A", 1, "B"))


def test_generate_wave_respects_balances():
    m = CrossCashModel()
    rng = random.Random(3)
    names = ["A", "B", "C"]
    for _ in range(50):
        for cmd in generate_wave(m, names, rng, 2):
            if cmd.kind == "pay":
                assert m.balances.get(cmd.node, 0) >= cmd.quantity
                assert cmd.recipient != cmd.node
            m.apply(cmd)


@pytest.mark.parametrize("seed, size", [(3, 2), (7, 3), (11, 2), (23, 5)])
def test_generate_wave_equals_the_references(seed, size):
    names = [f"Bank{i}" for i in range(4)]
    waves = {}
    for mod in (ref, None):
        gen = ref.generate_wave if mod else generate_wave
        Model = ref.CrossCashModel if mod else CrossCashModel
        model, rng, out = Model(), random.Random(seed), []
        for _ in range(30):
            cmds = gen(model, names, rng, size)
            for cmd in cmds:
                model.apply(cmd)
            out.append([(c.kind, c.node, c.quantity, c.recipient, c.nonce,
                         c.rpc_args()) for c in cmds])
        waves["ref" if mod else "port"] = (out, dict(model.balances))
    assert waves["port"] == waves["ref"]


def test_vaults_match_equals_the_references():
    rng = random.Random(5)
    for _ in range(200):
        expected = {f"N{i}": rng.randrange(0, 3) for i in range(3)}
        gathered = {f"N{i}": {"Bank": rng.randrange(0, 3)}
                    for i in range(rng.randrange(0, 4))}
        assert vaults_match(expected, gathered) == ref.vaults_match(
            expected, gathered)


def test_flow_registers_in_the_ports_registry_only():
    from corda_tpu.flows.api import flow_registry as ref_registry
    from corda_tpu_torch.flows.api import flow_registry
    from corda_tpu_torch.tools.crosscash import CashCommandFlow

    assert flow_registry.get("crosscash.CashCommandFlow") is CashCommandFlow
    assert ref_registry.get("crosscash.CashCommandFlow") is \
        ref.CashCommandFlow
    assert CORDAPP == "corda_tpu_torch.tools.crosscash"


def test_result_wire_name_is_the_references():
    from corda_tpu.serialization.codec import wire_name_of as ref_wire_name
    from corda_tpu_torch.serialization.codec import wire_name_of
    from corda_tpu_torch.tools.crosscash import CashCommandResult

    assert wire_name_of(CashCommandResult) == ref_wire_name(
        ref.CashCommandResult) == "tools.crosscash.CashCommandResult"


def test_cli_places_every_node_on_the_card_by_default(monkeypatch, capsys):
    seen = {}

    def fake_run(**kw):
        seen.update(kw)
        return ref.CrossCashResult(1, 0, 0, 0, True, [], {}, {})

    import corda_tpu_torch.tools.crosscash as xc

    monkeypatch.setattr(xc, "run_crosscash", fake_run)
    assert main([]) == 0
    assert seen["device"] == "accelerator"
    assert (seen["n_waves"], seen["wave_size"], seen["clients"],
            seen["notary"]) == (4, 3, 3, "raft")
    assert main(["--device", "cpu"]) == 0
    assert seen["device"] == "cpu"
    capsys.readouterr()


class _MetricsRpc:
    def __init__(self, metrics):
        self.metrics = metrics

    def call(self, name):
        assert name == "node_metrics"
        return self.metrics


def _metrics(launches, at_boot):
    return {"verify_batches": 3, "verify_device_batches": 2,
            "verify_host_batches": 1, "verify_device_degraded": 0,
            "kernel_backend": "cuda", "kernel_launches": launches,
            "kernel_launches_at_boot": at_boot}


def test_verify_tiers_reads_the_launches_made_after_the_boot_warm():
    t = verify_tiers(_MetricsRpc(_metrics(
        {"ed25519_verify": 6, "sha512_challenge": 5, "sha256_many": 0},
        {"ed25519_verify": 4, "sha512_challenge": 4, "sha256_many": 0})))
    assert (t["batches"], t["device"], t["host"]) == (3, 2, 1)
    assert t["launches"] == {"ed25519_verify": 2, "sha512_challenge": 1,
                             "sha256_many": 0}
    # No kernel module loaded and no warm: no launches.
    assert verify_tiers(_MetricsRpc(_metrics(None, None)))["launches"] == {}


def test_card_placement_raises_without_a_card(tmp_path):
    import torch

    assert not torch.cuda.is_available()
    with pytest.raises(Exception, match="exited|did not come up"):
        run_crosscash(n_waves=1, wave_size=1, clients=2, notary="simple",
                      base_dir=str(tmp_path), max_seconds=60.0)


@pytest.mark.slow
def test_crosscash_converges_simple_notary(tmp_path):
    r = run_crosscash(n_waves=3, wave_size=2, clients=2, notary="simple",
                      seed=11, base_dir=str(tmp_path), device="cpu")
    assert r.commands_committed > 0
    assert r.converged, (r.expected, r.gathered)
    assert r.commands_committed + r.commands_rejected == r.commands_run
    assert set(r.verify_tiers) == {"Notary", "Bank0", "Bank1"}
    assert all(t["device"] == 0 for t in r.verify_tiers.values())
    assert all(not any(t["launches"].values())
               for t in r.verify_tiers.values())


@pytest.mark.slow
def test_crosscash_detects_injected_lost_update(tmp_path):
    r = run_crosscash(n_waves=3, wave_size=2, clients=2, notary="simple",
                      seed=11, base_dir=str(tmp_path),
                      converge_timeout=8.0, _drop_model_update=True,
                      device="cpu")
    assert not r.converged


@pytest.mark.slow
def test_crosscash_converges_under_kill_sigstop_strain(tmp_path):
    r = run_crosscash(
        n_waves=5, wave_size=3, clients=3, notary="raft",
        seed=23, base_dir=str(tmp_path),
        disrupt=("kill-follower", "sigstop-follower", "strain-follower"),
        disrupt_wave=1, max_seconds=480.0, device="cpu")
    assert len(r.disruptions) >= 4
    assert any("SIGKILL" in x for x in r.disruptions)
    assert any("strain" in x for x in r.disruptions)
    assert r.commands_committed > 0
    assert r.converged, (r.disruptions, r.expected, r.gathered)


@pytest.mark.slow
def test_cli_runs_as_a_module_on_the_host(tmp_path):
    # As __main__ the result type keeps its module's wire name, so the CLI
    # decodes the nodes' replies (the reference's CLI fails here).
    import json
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-m", "corda_tpu_torch.tools.crosscash", "--device",
         "cpu", "--notary", "simple", "--waves", "2", "--clients", "2",
         "--wave-size", "2"], cwd=repo, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, TMPDIR=str(tmp_path)))
    assert out.returncode == 0, out.stderr[-2000:]
    doc = json.loads(out.stdout.strip().splitlines()[-1])
    assert doc["converged"] and doc["commands_run"] == 4
