"""Oracle flows: query facts, then get a signature over a Merkle tear-off.

The port's own copy of ``corda_tpu/flows/oracle.py``.

Capability match for the reference's rate-fix oracle machinery (reference:
samples/irs-demo/src/main/kotlin/net/corda/irs/api/NodeInterestRates.kt:37-55
— Oracle.sign(FilteredTransaction) signs a transaction id only after checking
every REVEALED command is a fix it attests to, without seeing anything else —
and samples/irs-demo/.../flows/RatesFixFlow.kt — the client-side
query + build + sign round trip).

Privacy property exercised end-to-end: the oracle receives a
FilteredTransaction (commands only), verifies the partial Merkle proof
against the given id, checks the fix values equal its own data, and signs the
id. The rest of the transaction stays hidden.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..contracts.structures import Command, CommandData
from ..crypto.hashes import SecureHash
from ..crypto.keys import DigitalSignature
from ..crypto.party import Party
from ..serialization.codec import register
from ..serialization.tokens import SerializeAsToken
from ..transactions.filtered import FilteredTransaction, FilterFuns
from .api import FlowException, FlowLogic, register_flow


@register
@dataclass(frozen=True, order=True)
class FixOf:
    """What is being fixed: a named index on a day for a tenor
    (FinanceTypes Fix/FixOf capability)."""

    name: str
    for_day: int  # epoch days
    of_tenor: str


@register
@dataclass(frozen=True)
class Fix(CommandData):
    """An observed fact: the fix and its value, embedded as a command so the
    oracle's signature covers it (NodeInterestRates Fix)."""

    of: FixOf
    value: int  # scaled by 10^4 (basis-point hundredths); ints serialize
    # canonically, unlike floats


@register
@dataclass(frozen=True)
class QueryRequest:
    queries: tuple  # of FixOf


@register
@dataclass(frozen=True)
class QueryResponse:
    fixes: tuple  # of Fix


@register
@dataclass(frozen=True)
class SignRequest:
    ftx: FilteredTransaction
    tx_id: SecureHash


@register
@dataclass(frozen=True)
class SignResponse:
    sig: DigitalSignature.WithKey


@register
@dataclass(frozen=True)
class SignRefused:
    """The oracle declined (bad proof, wrong value, oversharing) — the reason
    travels back so clients can diagnose instead of seeing a dead session."""

    reason: str


class RateOracle(SerializeAsToken):
    """The oracle service: holds the rate table, answers queries, and signs
    tear-offs whose every revealed Fix matches the table
    (NodeInterestRates.Oracle.sign capability). A checkpoint token, so
    handler flows referencing it survive node restarts."""

    def __init__(self, smm, key_pair, rates: dict[FixOf, int]):
        self.key_pair = key_pair
        self.rates = dict(rates)
        smm.register_flow_initiator(
            "RatesFixQueryFlow", lambda party: OracleQueryHandler(party, self))
        smm.register_flow_initiator(
            "RatesFixSignFlow", lambda party: OracleSignHandler(party, self))
        smm.token_context.register(self)

    @property
    def token_name(self) -> str:
        return "rate-oracle"

    def query(self, queries) -> list[Fix]:
        out = []
        for q in queries:
            if q not in self.rates:
                raise FlowException(f"unknown fix {q}")
            out.append(Fix(q, self.rates[q]))
        return out

    def sign(self, ftx: FilteredTransaction, tx_id: SecureHash
             ) -> DigitalSignature.WithKey:
        # 1. The tear-off must genuinely belong to tx_id.
        if not ftx.verify(tx_id):
            raise FlowException("partial Merkle proof failed")
        # 2. Only commands may be revealed to this oracle.
        leaves = ftx.filtered_leaves
        if leaves.inputs or leaves.outputs or leaves.attachments:
            raise FlowException("oracle must only see commands")
        fixes = [c.value for c in leaves.commands if isinstance(c.value, Fix)]
        if not fixes:
            raise FlowException("no Fix commands to attest")
        # 3. Every revealed fix must match our table.
        for fix in fixes:
            if self.rates.get(fix.of) != fix.value:
                raise FlowException(f"incorrect fix {fix}")
        return self.key_pair.sign(tx_id.bytes)


@register_flow
class OracleQueryHandler(FlowLogic):
    def __init__(self, other_party: Party, oracle):
        self.other_party = other_party
        self.oracle = oracle

    def call(self):
        req = yield self.receive(self.other_party, QueryRequest)
        try:
            reply = QueryResponse(
                tuple(self.oracle.query(req.unwrap().queries)))
        except FlowException as e:
            reply = SignRefused(str(e))
        yield self.send(self.other_party, reply)


@register_flow
class OracleSignHandler(FlowLogic):
    def __init__(self, other_party: Party, oracle):
        self.other_party = other_party
        self.oracle = oracle

    def call(self):
        req = yield self.receive(self.other_party, SignRequest)
        request = req.unwrap()
        try:
            sig = self.oracle.sign(request.ftx, request.tx_id)
            reply = SignResponse(sig)
        except FlowException as e:
            reply = SignRefused(str(e))
        yield self.send(self.other_party, reply)


@register_flow
class RatesFixQueryFlow(FlowLogic):
    """Client: ask the oracle for a fix (RatesFixFlow query leg)."""

    def __init__(self, oracle_party: Party, fix_of: FixOf):
        self.oracle_party = oracle_party
        self.fix_of = fix_of

    def call(self):
        response = yield self.send_and_receive(
            self.oracle_party, QueryRequest((self.fix_of,)), object)
        reply = response.unwrap()
        if isinstance(reply, SignRefused):
            raise FlowException(f"oracle refused query: {reply.reason}")
        if not isinstance(reply, QueryResponse):
            raise FlowException("unexpected oracle reply")
        fixes = reply.fixes
        if len(fixes) != 1 or fixes[0].of != self.fix_of:
            raise FlowException("oracle returned the wrong fix")
        return fixes[0]


@register_flow
class RatesFixSignFlow(FlowLogic):
    """Client: send ONLY the Fix commands (tear-off) and collect the
    oracle's signature over the whole transaction id."""

    def __init__(self, oracle_party: Party, stx):
        self.oracle_party = oracle_party
        self.stx = stx

    def call(self):
        wtx = self.stx.tx
        funs = FilterFuns(filter_commands=lambda c: isinstance(c.value, Fix))
        ftx = FilteredTransaction.build_merkle_transaction(wtx, funs)
        response = yield self.send_and_receive(
            self.oracle_party, SignRequest(ftx, wtx.id), object)
        reply = response.unwrap()
        if isinstance(reply, SignRefused):
            raise FlowException(f"oracle refused to sign: {reply.reason}")
        if not isinstance(reply, SignResponse):
            raise FlowException("unexpected oracle reply")
        sig = reply.sig
        sig.verify(wtx.id.bytes)
        return sig
