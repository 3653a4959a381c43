"""The port's small utilities, generators, expect DSL, simulation and
visualiser against the JAX package's: the mirror of the cases of
tests/test_utilities.py whose modules this slice ports (interpolators,
generators, the expect DSL, the trade simulation, NonEmptySet, the
progress renderer, the cash balance metric), plus parity on the same
seeded inputs:

* one seed gives the same generator stream, field by field and as wire
  bytes, in both packages;
* the interpolators agree with the reference's within 1e-12;
* ``TradeSimulation`` on a CPU verifier settles the same transaction (one
  id, one set of bytes) over the same sent-message feed, and
  ``render_svg`` draws that feed to the same bytes;
* ``generate_service_identity`` builds the same composite key bytes.
"""

import importlib
import io
import random

import numpy as np
import pytest

from corda_tpu_torch.crypto.provider import CpuVerifier

PKGS = ("corda_tpu", "corda_tpu_torch")


def _m(pkg, path):
    return importlib.import_module(f"{pkg}.{path}")


def _wire(pkg, obj) -> bytes:
    return _m(pkg, "serialization.codec").serialize(obj).bytes


# ---------------------------------------------------------------------------
# Interpolators (tests/test_utilities.py:80-98)
# ---------------------------------------------------------------------------


class TestInterpolators:
    def test_linear(self):
        from corda_tpu_torch.utils.interpolators import LinearInterpolator

        li = LinearInterpolator((0.0, 10.0), (0.0, 100.0))
        assert li.interpolate(5.0) == 50.0
        with pytest.raises(ValueError):
            li.interpolate(11.0)

    def test_cubic_spline_passes_through_knots_and_is_smooth(self):
        from corda_tpu_torch.utils.interpolators import (
            CubicSplineInterpolator,
        )

        xs = (0.0, 1.0, 2.0, 3.0, 4.0)
        ys = (1.0, 2.0, 0.5, 3.0, 2.5)
        cs = CubicSplineInterpolator(xs, ys)
        for x, y in zip(xs, ys):
            assert abs(cs.interpolate(x) - y) < 1e-9
        samples = [cs.interpolate(x / 10) for x in range(0, 41)]
        assert all(-2.0 < s < 5.0 for s in samples)

    @pytest.mark.parametrize("kind", ["LinearInterpolator",
                                      "CubicSplineInterpolator"])
    @pytest.mark.parametrize("seed", [1, 2, 3])
    def test_equal_to_the_reference(self, kind, seed):
        rng = np.random.default_rng(seed)
        n = int(rng.integers(2, 12))
        xs = tuple(float(x) for x in np.cumsum(rng.uniform(0.1, 3.0, n)))
        ys = tuple(float(y) for y in rng.normal(0.0, 2.0, n))
        port = getattr(_m("corda_tpu_torch", "utils.interpolators"),
                       kind)(xs, ys)
        ref = getattr(_m("corda_tpu", "utils.interpolators"), kind)(xs, ys)
        for x in rng.uniform(xs[0], xs[-1], 64):
            assert abs(port.interpolate(float(x))
                       - ref.interpolate(float(x))) <= 1e-12
        for bad in (xs[0] - 1.0, xs[-1] + 1.0):
            for interp in (port, ref):
                with pytest.raises(ValueError):
                    interp.interpolate(bad)

    @pytest.mark.parametrize("xs, ys", [((0.0,), (1.0,)),
                                        ((0.0, 1.0), (1.0,)),
                                        ((1.0, 1.0), (0.0, 2.0))])
    def test_bad_knots_refused_by_both(self, xs, ys):
        for pkg in PKGS:
            with pytest.raises(ValueError):
                _m(pkg, "utils.interpolators").LinearInterpolator(xs, ys)


# ---------------------------------------------------------------------------
# Generators (tests/test_utilities.py:141-170)
# ---------------------------------------------------------------------------


def _event_fields(event):
    kind = type(event).__name__
    owner = getattr(event, "owner", getattr(event, "new_owner", None))
    return (kind, event.amount.quantity, event.amount.token, owner)


class TestGenerators:
    def test_generator_monad_composes(self):
        from corda_tpu_torch.testing.generators import Generator

        rng = random.Random(42)
        gen = Generator.int_range(1, 6).flat_map(
            lambda n: Generator.pick(["a", "b"]).map(lambda s: s * n))
        values = gen.list_of(20).generate(rng)
        assert all(set(v) <= {"a", "b"} and 1 <= len(v) <= 6 for v in values)

    def test_cash_event_stream_stays_valid(self):
        from corda_tpu_torch.testing.generators import (
            ExitEvent,
            IssueEvent,
            MoveEvent,
            cash_event_generator,
        )

        rng = random.Random(7)
        balance = {"issued": 0}
        gen = cash_event_generator(["alice", "bob"],
                                   lambda: balance["issued"])
        for _ in range(200):
            event = gen.generate(rng)
            if isinstance(event, IssueEvent):
                balance["issued"] += event.amount.quantity
            elif isinstance(event, (MoveEvent, ExitEvent)):
                assert event.amount.quantity <= balance["issued"]
                if isinstance(event, ExitEvent):
                    balance["issued"] -= event.amount.quantity

    @pytest.mark.parametrize("seed", [0, 7, 1234])
    def test_cash_event_stream_equals_the_references(self, seed):
        streams = {}
        for pkg in PKGS:
            mod = _m(pkg, "testing.generators")
            rng = random.Random(seed)
            balance = {"issued": 0}
            gen = mod.cash_event_generator(["alice", "bob", "carol"],
                                           lambda: balance["issued"])
            out = []
            for _ in range(300):
                event = gen.generate(rng)
                if isinstance(event, mod.IssueEvent):
                    balance["issued"] += event.amount.quantity
                elif isinstance(event, mod.ExitEvent):
                    balance["issued"] -= event.amount.quantity
                out.append(_event_fields(event))
            streams[pkg] = out
        assert streams["corda_tpu"] == streams["corda_tpu_torch"]
        assert {e[0] for e in streams["corda_tpu_torch"]} == {
            "IssueEvent", "MoveEvent", "ExitEvent"}

    @pytest.mark.parametrize("name", [
        "key_pair_gen", "party_gen", "secure_hash_gen", "state_ref_gen",
        "amount_gen", "issued_amount_gen"])
    def test_domain_generators_equal_the_references(self, name):
        wires = {}
        for pkg in PKGS:
            mod = _m(pkg, "testing.generators")
            if name == "issued_amount_gen":
                issuer = mod.party_gen().generate(random.Random(99)).ref(
                    b"\x01")
                gen = mod.issued_amount_gen(issuer)
            else:
                gen = getattr(mod, name)()
            values = gen.list_of(8).generate(random.Random(5))
            if name == "key_pair_gen":
                values = [kp.public for kp in values]
            wires[pkg] = [_wire(pkg, v) for v in values]
        assert wires["corda_tpu"] == wires["corda_tpu_torch"]
        assert len(set(wires["corda_tpu_torch"])) > 1


# ---------------------------------------------------------------------------
# Expect DSL (tests/test_utilities.py:173-199)
# ---------------------------------------------------------------------------


class A:
    def __init__(self, n):
        self.n = n


class B:
    pass


class TestExpectDsl:
    def test_sequence_and_parallel(self):
        from corda_tpu_torch.testing.expect import (
            ExpectationFailed,
            expect,
            expect_events,
            parallel,
            sequence,
        )

        feed = [A(1), B(), A(2), B()]
        expect_events(feed, sequence(
            expect(A, lambda e: e.n == 1),
            parallel(expect(A, lambda e: e.n == 2), expect(B)),
            expect(B),
        ))
        with pytest.raises(ExpectationFailed):
            expect_events([A(1)], sequence(expect(A), expect(B)))

    @pytest.mark.parametrize("feed, ok", [
        ([A(1), B(), A(2), B()], True),
        ([B(), A(1), A(2)], False),
        ([A(1), A(2), B(), B()], True),
        ([A(1)], False),
        ([], False),
    ])
    def test_verdicts_equal_the_references(self, feed, ok):
        verdicts = []
        for pkg in PKGS:
            e = _m(pkg, "testing.expect")
            spec = e.sequence(e.expect(A, lambda x: x.n == 1),
                              e.parallel(e.expect(B), e.expect(A)),
                              e.expect(B))
            try:
                e.expect_events(feed, spec)
                verdicts.append(True)
            except e.ExpectationFailed as exc:
                verdicts.append(str(exc))
        assert verdicts[0] == verdicts[1]
        assert (verdicts[1] is True) is ok

    def test_unknown_spec_raises_type_error(self):
        from corda_tpu_torch.testing.expect import expect_events

        with pytest.raises(TypeError):
            expect_events([A(1)], object())


# ---------------------------------------------------------------------------
# Simulation and visualiser (tests/test_utilities.py:202-224)
# ---------------------------------------------------------------------------


def _run_trade(pkg):
    verifier = _m(pkg, "crypto.provider").CpuVerifier()
    sim = _m(pkg, "testing.simulation").TradeSimulation(verifier=verifier)
    try:
        final = sim.run_trade(price_quantity=750)
        feed = [(str(m.sender), str(m.recipient),
                 m.message.topic_session.topic) for m in sim.sent_messages]
        svg = _m(pkg, "tools.visualiser").render_svg(sim.sent_messages)
        seller = sim.banks[0]
        paid = sum(o.data.amount.quantity for o in final.tx.outputs
                   if type(o.data).__name__ == "CashState"
                   and o.data.owner == seller.identity.owning_key)
        senders = {m.sender for m in sim.sent_messages}
        return {"id": final.id.bytes, "wire": _wire(pkg, final),
                "feed": feed, "svg": svg, "paid": paid,
                "senders": len(senders)}
    finally:
        sim.stop()


@pytest.fixture(scope="module")
def trades():
    return {pkg: _run_trade(pkg) for pkg in PKGS}


class TestSimulation:
    def test_trade_simulation_over_latency_network(self, trades):
        port = trades["corda_tpu_torch"]
        assert port["paid"] == 750
        assert len(port["feed"]) >= 6
        assert port["senders"] >= 3

    def test_trade_equals_the_references(self, trades):
        port, ref = trades["corda_tpu_torch"], trades["corda_tpu"]
        assert port["id"] == ref["id"]
        assert port["wire"] == ref["wire"]

    def test_sent_message_feed_equals_the_references(self, trades):
        assert trades["corda_tpu_torch"]["feed"] == trades["corda_tpu"]["feed"]

    def test_render_svg_equals_the_references(self, trades, tmp_path):
        svg = trades["corda_tpu_torch"]["svg"]
        assert svg == trades["corda_tpu"]["svg"]
        assert svg.startswith("<svg") and svg.endswith("</svg>")
        assert "platform.session" in svg

    def test_latency_grows_with_distance(self):
        from corda_tpu.testing import simulation as ref
        from corda_tpu_torch.testing import simulation as port

        for a, b in ((port.LONDON, port.TOKYO), (port.ZURICH, port.LONDON),
                     (port.NEW_YORK, port.SINGAPORE)):
            ra = getattr(ref, a.name.upper().replace(" ", "_"))
            rb = getattr(ref, b.name.upper().replace(" ", "_"))
            assert port._great_circle_km(a, b) == ref._great_circle_km(ra, rb)
        assert port._great_circle_km(port.LONDON, port.TOKYO) > \
            port._great_circle_km(port.LONDON, port.ZURICH)

    def test_without_a_verifier_the_network_takes_the_card(self,
                                                           monkeypatch):
        from corda_tpu_torch.crypto import provider
        from corda_tpu_torch.testing.simulation import Simulation

        monkeypatch.setattr(provider, "_default", CpuVerifier())
        sim = Simulation(bank_count=1)
        try:
            assert sim.network.verifier is None
            assert sim.banks[0].smm.verifier is provider.get_verifier()
        finally:
            sim.stop()


class TestVisualiser:
    def test_empty_feed(self):
        from corda_tpu.tools.visualiser import render_svg as ref_svg
        from corda_tpu_torch.tools.visualiser import render_svg

        assert render_svg([]) == ref_svg([]) == \
            "<svg xmlns='http://www.w3.org/2000/svg'/>"

    def test_writes_the_file_and_caps_the_feed(self, trades, tmp_path):
        from corda_tpu_torch.testing.simulation import TradeSimulation
        from corda_tpu_torch.tools.visualiser import render_svg

        sim = TradeSimulation(verifier=CpuVerifier())
        try:
            sim.run_trade()
            path = tmp_path / "trade.svg"
            svg = render_svg(sim.sent_messages, path, max_messages=3)
            assert path.read_text() == svg
            assert svg.count("marker-end") == 3
        finally:
            sim.stop()

    def test_labels_are_escaped(self):
        from types import SimpleNamespace

        from corda_tpu.tools.visualiser import render_svg as ref_svg
        from corda_tpu_torch.tools.visualiser import render_svg

        msg = SimpleNamespace(
            sender="<a&b>", recipient="c",
            message=SimpleNamespace(
                topic_session=SimpleNamespace(topic="x<y>")))
        svg = render_svg([msg])
        assert svg == ref_svg([msg])
        assert "&lt;a&amp;b&gt;" in svg and "x&lt;y&gt;" in svg


# ---------------------------------------------------------------------------
# Small utilities (tests/test_utilities.py:227-282)
# ---------------------------------------------------------------------------


class TestSmallUtils:
    def test_non_empty_set(self):
        from corda_tpu_torch.utils.collections import NonEmptySet

        s = NonEmptySet.of(1, 2, 3)
        assert 2 in s and len(s) == 3
        with pytest.raises(ValueError):
            NonEmptySet([])
        with pytest.raises(ValueError):
            s - {1, 2, 3}
        assert s & {2, 3} == {2, 3}

    def test_non_empty_set_algebra_equals_the_references(self):
        from corda_tpu.utils.collections import NonEmptySet as Ref
        from corda_tpu_torch.utils.collections import NonEmptySet

        ops = ["__and__", "__sub__", "__xor__", "__or__", "intersection",
               "difference", "symmetric_difference", "union"]
        for other in ({1}, {1, 2, 3}, {4}, {2, 9}):
            for op in ops:
                results = []
                for cls in (NonEmptySet, Ref):
                    try:
                        out = getattr(cls.of(1, 2, 3), op)(other)
                        results.append((type(out).__name__, sorted(out)))
                    except ValueError:
                        results.append("empty")
                assert results[0] == results[1], (op, other)

    def test_progress_renderer_follows_feed(self, tmp_path):
        from corda_tpu_torch.flows.api import FlowLogic, register_flow
        from corda_tpu_torch.node.config import NodeConfig
        from corda_tpu_torch.node.node import Node
        from corda_tpu_torch.utils.progress import ProgressTracker, Step
        from corda_tpu_torch.utils.progress_render import ProgressRenderer

        @register_flow(name="TorchUtilitiesSteppyFlow")
        class SteppyFlow(FlowLogic):
            def __init__(self, n: int):
                self.n = n
                self.progress_tracker = ProgressTracker(
                    Step("Working"), Step("Finishing"))

            def call(self):
                self.progress_tracker.next_step()
                self.progress_tracker.next_step()
                return self.n

        node = Node(NodeConfig(name="P", base_dir=tmp_path / "P",
                               network_map=tmp_path / "m.json",
                               verifier="cpu")).start()
        try:
            out = io.StringIO()
            renderer = ProgressRenderer(node.smm, out=out)
            node.start_flow(SteppyFlow(1))
            lines = renderer.poll()
            text = "\n".join(lines)
            assert "started" in text and "Working" in text \
                and "Finishing" in text and "finished" in text
            assert out.getvalue().splitlines() == lines
            assert renderer.in_flight == {}
        finally:
            node.stop()

    def test_cash_balance_metrics(self, tmp_path):
        from corda_tpu_torch.finance import Amount, Cash
        from corda_tpu_torch.node.config import NodeConfig
        from corda_tpu_torch.node.node import Node

        node = Node(NodeConfig(name="B", base_dir=tmp_path / "B",
                               network_map=tmp_path / "m.json",
                               verifier="cpu")).start()
        try:
            issue = Cash.generate_issue(
                Amount(1234, "USD"), node.identity.ref(b"\x01"),
                node.identity.owning_key, node.identity)
            issue.sign_with(node.key)
            node.services.record_transactions([issue.to_signed_transaction()])
            assert node.smm.metrics["balance.USD"] == 1234
        finally:
            node.stop()

    @pytest.mark.parametrize("threshold", [1, 2, 3])
    def test_service_identity_equals_the_references(self, threshold):
        parties = {}
        for pkg in PKGS:
            keys = _m(pkg, "crypto.keys")
            members = [keys.KeyPair.generate(bytes([0x60 + i]) * 32).public
                       for i in range(3)]
            party = _m(pkg, "utils.service_identity").generate_service_identity(
                "Raft Notary Service", members, threshold=threshold)
            parties[pkg] = (party.name, _wire(pkg, party.owning_key),
                            _wire(pkg, party))
        assert parties["corda_tpu"] == parties["corda_tpu_torch"]

    def test_service_identity_is_fulfilled_by_any_member(self):
        from corda_tpu_torch.crypto.keys import KeyPair
        from corda_tpu_torch.utils.service_identity import (
            generate_service_identity,
        )

        members = [KeyPair.generate(bytes([0x70 + i]) * 32).public
                   for i in range(3)]
        party = generate_service_identity("Raft", members)
        for key in members:
            assert party.owning_key.is_fulfilled_by({key})
        with pytest.raises(ValueError):
            generate_service_identity("Raft", [])
