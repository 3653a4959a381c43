"""The port's rate oracle and two-party deal flows
(corda_tpu_torch/flows/oracle.py, deal.py) against the JAX package's:
the mirror of tests/test_oracle.py, each case run on both packages over
MockNetwork (whose keys come from a counter, so both packages have the
same identities), the fix, the transaction ids and the oracle's
signature byte-equal; then bench_partial_merkle's tear-off
(corda_tpu_torch/testing/simm_load.tear_off) and every oracle wire type,
byte-equal and decodable by the other package.
"""

import dataclasses
import importlib
import subprocess
import sys
from pathlib import Path
from types import ModuleType, SimpleNamespace

import pytest

from corda_tpu_torch.testing import simm_load as sl

PKGS = ("corda_tpu", "corda_tpu_torch")
RATE = 5_6700  # tests/test_oracle.py:27


def _m(pkg, path):
    return importlib.import_module(f"{pkg}.{path}")


def jax_api(port: SimpleNamespace) -> SimpleNamespace:
    """A runner's ``port_api()`` (testing/simm_load.py, multisig_load.py)
    with each name taken from the JAX package's module of the same path;
    the other configs-5-and-4 test files import it from here."""
    out = {}
    for name, obj in vars(port).items():
        path = obj.__name__ if isinstance(obj, ModuleType) else obj.__module__
        module = importlib.import_module(
            path.replace("corda_tpu_torch.", "corda_tpu.", 1))
        out[name] = module if isinstance(obj, ModuleType) else getattr(
            module, obj.__name__)
    return SimpleNamespace(**out)


def _setup(pkg):
    oracle_mod = _m(pkg, "flows.oracle")
    net = _m(pkg, "testing.mock_network").MockNetwork(
        verifier=_m(pkg, "crypto.provider").CpuVerifier())
    notary = net.create_notary_node("Notary")
    oracle_node = net.create_node("Oracle Inc")
    alice = net.create_node("Alice")
    libor = oracle_mod.FixOf("LIBOR", 20_000, "3M")
    oracle = oracle_mod.RateOracle(oracle_node.smm, oracle_node.key,
                                   {libor: RATE})
    return net, notary, oracle_node, alice, oracle, libor


def _fixed_tx(pkg, alice, notary, fix):
    builder = _m(pkg, "testing.dummies").DummyContract.generate_initial(
        alice.identity.ref(b"\x01"), 5, notary.identity)
    builder.add_command(_m(pkg, "contracts.structures").Command(
        fix, (alice.identity.owning_key,)))
    builder.sign_with(alice.key)
    return builder.to_signed_transaction(check_sufficient_signatures=False)


def _query_and_sign(pkg):
    oracle_mod = _m(pkg, "flows.oracle")
    serialize = _m(pkg, "serialization.codec").serialize
    net, notary, oracle_node, alice, _oracle, libor = _setup(pkg)
    try:
        qh = alice.start_flow(oracle_mod.RatesFixQueryFlow(
            oracle_node.identity, libor))
        net.run_network()
        fix = qh.result.result()
        assert fix == oracle_mod.Fix(libor, RATE)
        stx = _fixed_tx(pkg, alice, notary, fix)
        sh = alice.start_flow(oracle_mod.RatesFixSignFlow(
            oracle_node.identity, stx))
        net.run_network()
        sig = sh.result.result()
        sig.verify(stx.id.bytes)
        assert sig.by == oracle_node.key.public
        return serialize(fix).bytes, bytes(stx.id.bytes), bytes(sig.bytes)
    finally:
        net.stop_nodes()


def test_query_then_sign_over_tear_off():
    assert _query_and_sign("corda_tpu_torch") == _query_and_sign("corda_tpu")


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("case", ["wrong value", "unknown fix"])
def test_oracle_refuses(pkg, case):
    oracle_mod = _m(pkg, "flows.oracle")
    net, notary, oracle_node, alice, _oracle, libor = _setup(pkg)
    try:
        if case == "wrong value":
            stx = _fixed_tx(pkg, alice, notary, oracle_mod.Fix(libor,
                                                               RATE + 1))
            handle = alice.start_flow(oracle_mod.RatesFixSignFlow(
                oracle_node.identity, stx))
            match = "incorrect fix"
        else:
            handle = alice.start_flow(oracle_mod.RatesFixQueryFlow(
                oracle_node.identity, oracle_mod.FixOf("EURIBOR", 20_000,
                                                       "6M")))
            match = "unknown fix"
        net.run_network()
        with pytest.raises(Exception, match=match):
            handle.result.result()
    finally:
        net.stop_nodes()


@pytest.mark.parametrize("pkg", PKGS)
def test_oracle_privacy_only_commands_revealed(pkg):
    oracle_mod = _m(pkg, "flows.oracle")
    filtered = _m(pkg, "transactions.filtered")
    FlowException = _m(pkg, "flows.api").FlowException
    net, notary, oracle_node, alice, oracle, libor = _setup(pkg)
    try:
        stx = _fixed_tx(pkg, alice, notary, oracle_mod.Fix(libor, RATE))
        leaky = filtered.FilteredTransaction.build_merkle_transaction(
            stx.tx, filtered.FilterFuns(
                filter_commands=lambda c: isinstance(c.value,
                                                     oracle_mod.Fix),
                filter_outputs=lambda _o: True))
        with pytest.raises(FlowException, match="only see commands"):
            oracle.sign(leaky, stx.id)
        proper = filtered.FilteredTransaction.build_merkle_transaction(
            stx.tx, filtered.FilterFuns(
                filter_commands=lambda c: isinstance(c.value,
                                                     oracle_mod.Fix)))
        with pytest.raises(FlowException, match="Merkle proof"):
            oracle.sign(proper, _m(pkg, "crypto.hashes").SecureHash.zero())
        assert oracle.sign(proper, stx.id).by == oracle_node.key.public
    finally:
        net.stop_nodes()


# --- TwoPartyDealFlow (tests/test_oracle.py:121-208) ------------------------

_DEAL_TYPES: dict = {}


# The acceptor's flow name in each package's registry. It belongs to this
# file alone: tests/test_oracle.py registers its own SwapAcceptor class
# under "SwapAcceptor", and a registry refuses a second class under one
# name, so sharing it would fail whichever test ran second in a process.
ACCEPTOR_FLOW_NAME = "TorchParitySwapAcceptor"


def _deal_types(pkg):
    """SwapCommand, SwapDeal and the SwapAcceptor flow, registered once
    with ``pkg``'s codec and flow registry (the flow under
    ACCEPTOR_FLOW_NAME)."""
    if pkg in _DEAL_TYPES:
        return _DEAL_TYPES[pkg]
    s = _m(pkg, "contracts.structures")
    register = _m(pkg, "serialization.codec").register
    SecureHash = _m(pkg, "crypto.hashes").SecureHash
    FlowException = _m(pkg, "flows.api").FlowException
    accepted: list = []

    @register
    @dataclasses.dataclass(frozen=True)
    class SwapCommand(s.TypeOnlyCommandData):
        pass

    class _SwapContract(s.Contract):
        def verify(self, tx):
            pass

        @property
        def legal_contract_reference(self):
            return SecureHash.sha256(b"swap")

    @register
    @dataclasses.dataclass(frozen=True)
    class SwapDeal(s.DealState):
        party_a: object = None
        party_b: object = None
        notional: int = 0
        uid: object = dataclasses.field(default_factory=s.UniqueIdentifier)

        @property
        def linear_id(self):
            return self.uid

        @property
        def contract(self):
            return _SwapContract()

        @property
        def participants(self):
            return [self.party_a.owning_key, self.party_b.owning_key]

        @property
        def parties(self):
            return [self.party_a, self.party_b]

    @_m(pkg, "flows.api").register_flow(name=ACCEPTOR_FLOW_NAME)
    class SwapAcceptor(_m(pkg, "flows.deal").DealAcceptorFlow):
        def validate_terms(self, deal):
            accepted.append(deal.notional)
            if deal.notional > 1_000_000:
                raise FlowException("notional too large")

    _DEAL_TYPES[pkg] = (SwapCommand, SwapDeal, SwapAcceptor, accepted)
    return _DEAL_TYPES[pkg]


def _deal(pkg, verifier, notional):
    SwapCommand, SwapDeal, SwapAcceptor, accepted = _deal_types(pkg)
    deal_mod = _m(pkg, "flows.deal")
    s = _m(pkg, "contracts.structures")
    net = _m(pkg, "testing.mock_network").MockNetwork(verifier=verifier)
    try:
        notary = net.create_notary_node("Notary")
        alice = net.create_node("Alice")
        bob = net.create_node("Bob")
        bob.register_initiated_flow("DealInstigatorFlow",
                                    lambda party: SwapAcceptor(party))
        accepted.clear()
        deal = SwapDeal(alice.identity, bob.identity, notional,
                        s.UniqueIdentifier(external_id="swap",
                                           id=b"\x07" * 16))
        handle = alice.start_flow(deal_mod.DealInstigatorFlow(
            bob.identity, deal, SwapCommand(), notary.identity))
        net.run_network()
        try:
            final = handle.result.result()
        except Exception as e:  # noqa: BLE001 -- compared across packages
            return type(e).__name__, list(accepted)
        assert len(final.sigs) == 3  # alice + bob + notary
        for node in (alice, bob):
            assert node.services.storage_service.validated_transactions \
                .get_transaction(final.id) is not None
        return bytes(final.id.bytes), list(accepted), \
            sorted(bytes(sig.bytes) for sig in final.sigs)
    finally:
        net.stop_nodes()


@pytest.mark.parametrize("kind,notional", [
    ("cpu", 500_000), ("cpu", 2_000_000), ("torch-cpu", 500_000)])
def test_deal_agreed_signed_and_finalised(kind, notional):
    from corda_tpu.crypto.provider import CpuVerifier as JaxCpuVerifier
    from corda_tpu_torch.crypto.provider import CpuVerifier, TorchVerifier

    verifier = (CpuVerifier() if kind == "cpu"
                else TorchVerifier(device="cpu", device_min_sigs=0))
    ours = _deal("corda_tpu_torch", verifier, notional)
    assert ours == _deal("corda_tpu", JaxCpuVerifier(), notional)
    assert ours[1] == [notional]
    if notional > 1_000_000:  # the acceptor refuses: the session ends
        assert ours[0] == "FlowSessionException"


def test_deal_types_leave_the_reference_flow_name_free():
    """Registering this file's acceptor in the JAX package's flow registry
    must not take the name tests/test_oracle.py registers its own
    acceptor under."""
    api = _m("corda_tpu", "flows.api")
    acceptor = _deal_types("corda_tpu")[2]
    assert api.flow_registry.get(ACCEPTOR_FLOW_NAME) is acceptor
    assert api.flow_registry.get("SwapAcceptor") is None


def test_reference_deal_test_passes_after_this_file_in_one_process():
    """The order xdist's --dist loadfile may pick on one worker: this
    file's deal cases, then the reference's TestTwoPartyDeal, in one
    interpreter."""
    here = Path(__file__).resolve()
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:xdist",
         "-p", "no:cacheprovider", "-p", "no:randomly",
         f"{here}::test_deal_agreed_signed_and_finalised",
         f"{here.parent / 'test_oracle.py'}::TestTwoPartyDeal"],
        cwd=here.parent.parent, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-2000:]
    assert "4 passed" in proc.stdout, proc.stdout[-2000:]


# --- the tear-off and the wire types ----------------------------------------


def test_tear_off_is_byte_equal_and_decodes_across_packages():
    """bench_partial_merkle's FilteredTransaction: the same wtx id and the
    same blob in both packages; each decodes the other's and verifies it
    against the id, and no other component is revealed."""
    apis = {"corda_tpu_torch": sl.port_api(),
            "corda_tpu": jax_api(sl.port_api())}
    made = {pkg: sl.tear_off(api) for pkg, api in apis.items()}
    blobs = {pkg: apis[pkg].serialize(ftx).bytes
             for pkg, (_wtx, ftx) in made.items()}
    assert blobs["corda_tpu"] == blobs["corda_tpu_torch"]
    ids = {pkg: wtx.id for pkg, (wtx, _ftx) in made.items()}
    assert bytes(ids["corda_tpu"].bytes) == bytes(ids["corda_tpu_torch"]
                                                   .bytes)
    for pkg, other in (PKGS, PKGS[::-1]):
        ftx = _m(pkg, "serialization.codec").deserialize(blobs[other])
        assert type(ftx).__module__.startswith(pkg + ".")
        assert ftx.verify(ids[pkg])
        leaves = ftx.filtered_leaves
        assert len(leaves.commands) == 8 and not leaves.outputs
        assert not leaves.inputs and not leaves.attachments
        assert not ftx.verify(_m(pkg, "crypto.hashes").SecureHash.sha256(
            b"another transaction"))


def _oracle_values(pkg, kind):
    o = _m(pkg, "flows.oracle")
    keys = _m(pkg, "crypto.keys")
    fix_of = o.FixOf("LIBOR", 20_100, "3M")
    fix = o.Fix(fix_of, 4_2500)
    if kind == "FixOf":
        return fix_of
    if kind == "Fix":
        return fix
    if kind == "QueryRequest":
        return o.QueryRequest((fix_of, o.FixOf("EURIBOR", 1, "6M")))
    if kind == "QueryResponse":
        return o.QueryResponse((fix,))
    if kind == "SignRefused":
        return o.SignRefused("incorrect fix")
    api = sl.port_api() if pkg == "corda_tpu_torch" else jax_api(
        sl.port_api())
    wtx, ftx = sl.tear_off(api)
    if kind == "SignRequest":
        return o.SignRequest(ftx, wtx.id)
    key = keys.KeyPair.generate(b"\x55" * 32)
    return o.SignResponse(key.sign(wtx.id.bytes))


@pytest.mark.parametrize("kind", ["FixOf", "Fix", "QueryRequest",
                                  "QueryResponse", "SignRequest",
                                  "SignResponse", "SignRefused"])
def test_oracle_wire_types_are_byte_equal_both_ways(kind):
    blobs = {pkg: _m(pkg, "serialization.codec").serialize(
        _oracle_values(pkg, kind)).bytes for pkg in PKGS}
    assert blobs["corda_tpu"] == blobs["corda_tpu_torch"]
    for pkg, other in (PKGS, PKGS[::-1]):
        back = _m(pkg, "serialization.codec").deserialize(blobs[other])
        assert back == _oracle_values(pkg, kind)
        assert type(back).__module__ == f"{pkg}.flows.oracle"
