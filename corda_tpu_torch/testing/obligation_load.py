"""A seeded Obligation workload through a validating notary, with its
outcome record.

Each group of four transactions runs IOUs through every lifecycle of
``finance/obligation.py``:

  0. issue: Alice owes Bob ``m`` and ``q``, Alice owes Carol ``r`` and
     Carol owes Alice ``p``, and the Bank issues Alice ``q`` of cash in
     the same transaction (signed by Alice, Carol and the Bank);
  1. move: Bob sells his ``m`` claim to Carol (signed by Bob);
  2. partial settle: Alice pays Bob ``s < q`` of the cash and ``q - s``
     stays owed (``Obligation.generate_settle``, signed by Alice);
  3. bilateral net: Alice's ``r`` against Carol's ``p``
     (``Obligation.generate_net``, signed by Alice and Carol).

So a group carries seven signatures, and its last three transactions have
inputs, each from the group's issue only: a validating notary refuses a
dependency that lacks its notary's signature, so a chain of unnotarised
transactions could not go through in one burst. ``n_bad`` seeded transactions get one signature byte flipped; a
transaction is expected to notarise when its own signatures and all its
ancestors' are valid (the validating notary resolves each chain from
Alice and verifies it, ``Obligation.verify`` included).

``run_obligations`` records every transaction on Alice, then notarises
every transaction with inputs from Alice in one burst and returns what a
comparison needs: each outcome (the notary's signature bytes, or the
exception's type names), each flow's start-to-result time, and per node
the verify batches, their sizes and the time inside ``verify_batch``.
Like ``notary_load``, everything here is passed the package it drives
(``api``), so the same workload runs in either package; ``port_api()``
gives this package's own.
"""

from __future__ import annotations

import dataclasses
import time
from types import SimpleNamespace

import numpy as np

from .notary_load import TimedVerifier, outcome_of, start_timed

NODE_NAMES = ("Notary", "Alice", "Bob")


def port_api() -> SimpleNamespace:
    """This package's classes that the workload uses."""
    from ..contracts.structures import Command, Issued
    from ..crypto.keys import KeyPair
    from ..crypto.party import Party
    from ..crypto.provider import VerifyJob
    from ..finance.amount import Amount
    from ..finance.cash import CashIssue, CashState
    from ..finance.obligation import (
        Obligation,
        ObligationIssue,
        ObligationMove,
        ObligationState,
    )
    from ..flows.notary import NotaryClientFlow
    from ..transactions.builder import TransactionBuilder
    from .mock_network import MockNetwork

    return SimpleNamespace(
        Command=Command, Issued=Issued, KeyPair=KeyPair, Party=Party,
        VerifyJob=VerifyJob, Amount=Amount, CashIssue=CashIssue,
        CashState=CashState, Obligation=Obligation,
        ObligationIssue=ObligationIssue, ObligationMove=ObligationMove,
        ObligationState=ObligationState, NotaryClientFlow=NotaryClientFlow,
        TransactionBuilder=TransactionBuilder, MockNetwork=MockNetwork)


def make_network(api, verifier):
    """A MockNetwork with a validating notary, Alice and Bob, created in
    that order (the same identities in every network made here); each
    node's state machine verifies through a TimedVerifier."""
    net = api.MockNetwork(verifier=verifier)
    notary = net.create_notary_node(NODE_NAMES[0], validating=True)
    alice = net.create_node(NODE_NAMES[1])
    bob = net.create_node(NODE_NAMES[2])
    for node in (notary, alice, bob):
        node.smm.verifier = TimedVerifier(node.smm.verifier)
    return net, notary, alice, bob


@dataclasses.dataclass
class ObligationWorkload:
    txs: list             # four a group: issue, move, settle, net
    parents: list         # per transaction, the positions of its inputs' txs
    bad: tuple            # positions with a flipped signature byte

    @property
    def with_inputs(self) -> list[int]:
        """The positions the burst notarises (every non-issue)."""
        return [k for k in range(len(self.txs)) if self.parents[k]]


def build_obligations(api, notary, alice, bob, n: int, n_bad: int,
                      seed: int) -> ObligationWorkload:
    """``n`` transactions (``n // 4`` groups; ``n`` a multiple of 4) with
    amounts from ``seed``; ``n_bad`` seeded transactions get a seeded
    signature's seeded byte flipped."""
    if n % 4:
        raise ValueError("n must be a multiple of 4 (one group a lifecycle)")
    rng = np.random.default_rng(seed)
    carol = api.KeyPair.generate(b"\x7c" * 32)
    bank_key = api.KeyPair.generate(b"\x7b" * 32)
    bank = api.Party.of("Bank", bank_key.public)
    token = api.Issued(bank.ref(b"\x01"), "USD")
    a, b, c = (alice.identity.owning_key, bob.identity.owning_key,
               carol.public.composite)
    txs, parents = [], []
    for g in range(n // 4):
        m, q, r, p = (int(x) for x in rng.integers(1_000, 10_000, 4))
        s = int(rng.integers(1, q))

        def owed(obligor, qty, owner):
            return api.ObligationState(obligor, api.Amount(qty, token), owner)

        issue = api.TransactionBuilder(notary=notary.identity)
        for state in (owed(a, m, b), owed(a, q, b), owed(a, r, c),
                      owed(c, p, a), api.CashState(api.Amount(q, token), a)):
            issue.add_output_state(state)
        issue.add_command(api.Command(api.ObligationIssue(g), (a, c)))
        issue.add_command(api.Command(api.CashIssue(g), (bank.owning_key,)))
        for key in (alice.key, carol, bank_key):
            issue.sign_with(key)
        t0 = issue.to_signed_transaction()

        move = api.TransactionBuilder(notary=notary.identity)
        move.add_input_state(t0.tx.out_ref(0))
        move.add_output_state(owed(a, m, c))
        move.add_command(api.Command(api.ObligationMove(), (b,)))
        move.sign_with(bob.key)
        t1 = move.to_signed_transaction(check_sufficient_signatures=False)

        settle = api.TransactionBuilder(notary=notary.identity)
        api.Obligation.generate_settle(settle, [t0.tx.out_ref(1)],
                                       [t0.tx.out_ref(4)],
                                       api.Amount(s, token))
        settle.sign_with(alice.key)
        t2 = settle.to_signed_transaction(check_sufficient_signatures=False)

        net = api.TransactionBuilder(notary=notary.identity)
        api.Obligation.generate_net(net, [t0.tx.out_ref(2), t0.tx.out_ref(3)])
        net.sign_with(alice.key)
        net.sign_with(carol)
        t3 = net.to_signed_transaction(check_sufficient_signatures=False)

        base = 4 * g
        txs += [t0, t1, t2, t3]
        parents += [(), (base,), (base,), (base,)]
    bad = tuple(sorted(int(i) for i in rng.choice(n, n_bad, replace=False)))
    for k in bad:
        stx = txs[k]
        j = int(rng.integers(0, len(stx.sigs)))
        i = int(rng.integers(0, 64))
        sig = stx.sigs[j]
        flipped = type(sig)(sig.bytes[:i] + bytes([sig.bytes[i] ^ 0x01])
                            + sig.bytes[i + 1:], sig.by)
        sigs = stx.sigs[:j] + (flipped,) + stx.sigs[j + 1:]
        txs[k] = dataclasses.replace(stx, sigs=sigs)
    return ObligationWorkload(txs, parents, bad)


def signature_jobs(api, workload: ObligationWorkload) -> tuple[list, list]:
    """One VerifyJob per signature, in transaction order, and each
    transaction's (first, last + 1) job span."""
    jobs, spans = [], []
    for stx in workload.txs:
        first = len(jobs)
        jobs += [api.VerifyJob(sig.by.encoded, stx.id.bytes, sig.bytes)
                 for sig in stx.sigs]
        spans.append((first, len(jobs)))
    return jobs, spans


def expected_ok(workload: ObligationWorkload, spans, mask) -> list[bool]:
    """Per transaction with inputs (``with_inputs`` order): do its own
    signatures and all its ancestors' pass ``mask``?"""
    valid: list[bool] = []
    for k, (lo, hi) in enumerate(spans):
        valid.append(bool(all(mask[lo:hi]))
                     and all(valid[p] for p in workload.parents[k]))
    return [valid[k] for k in workload.with_inputs]


def run_obligations(api, net, notary, alice, bob,
                    workload: ObligationWorkload) -> dict:
    """Record every transaction on Alice, then notarise every transaction
    with inputs from Alice in one burst (``net.run_network()``)."""
    for stx in workload.txs:
        alice.record_transaction(stx)
    order = workload.with_inputs
    starts = [0.0] * len(order)
    ends = [0.0] * len(order)
    t0 = time.perf_counter()
    handles = [start_timed(alice, api.NotaryClientFlow(workload.txs[k]),
                           starts, ends, i) for i, k in enumerate(order)]
    net.run_network()
    wall_s = time.perf_counter() - t0
    outcomes = [outcome_of(h) for h in handles]
    nodes = {}
    for node in (notary, alice, bob):
        timed = node.smm.verifier
        nodes[node.name] = {
            "verify_batches": node.smm.metrics["verify_batches"],
            "verify_sigs": node.smm.metrics["verify_sigs"],
            "verify_device_degraded":
                node.smm.metrics["verify_device_degraded"],
            "batch_sizes": list(timed.sizes),
            "verify_s": timed.seconds,
        }
    return {
        "outcomes": outcomes,
        "tx_ids": [bytes(workload.txs[k].id.bytes) for k in order],
        "flow_s": [e - s for s, e in zip(starts, ends)],
        "wall_s": wall_s,
        "notarised": sum(o[0] == "ok" for o in outcomes),
        "committed_count": notary.uniqueness_provider.committed_count,
        "nodes": nodes,
    }
