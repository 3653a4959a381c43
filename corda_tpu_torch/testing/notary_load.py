"""A seeded notarisation workload over MockNetwork, with its outcome record.

The raft-notary-demo's workload (samples/raft-notary-demo, NotaryDemo.kt):
DummyContract transactions, each issued on Alice and moved to Bob with
Alice's signature, notarised through ``NotaryClientFlow`` on one notary
node. A seeded share of the moves carries a flipped signature byte (the
client's own signature check must refuse them), and a few second spends of
inputs that an earlier round notarised must meet ``NotaryConflict``.

``run_workload`` starts the flows in one burst or in waves (start a wave,
``run_network``, start the next), then the second spends as a last round,
and returns what a comparison needs: every transaction's outcome (the
notary's signature bytes, or the exception and error type names), each
flow's time from ``start_flow`` to its result, the committed input set,
and per node the state machine's verify counts, its largest batch and the
time spent inside ``verify_batch``.

Everything here is passed the package it drives (``api``: ``MockNetwork``,
``DummyContract`` and ``NotaryClientFlow``), so the same workload runs in
this package and in any other with the same classes; ``port_api()`` gives
this package's own.
"""

from __future__ import annotations

import dataclasses
import time
from types import SimpleNamespace

import numpy as np

NODE_NAMES = ("Notary", "Alice", "Bob")


def port_api() -> SimpleNamespace:
    """This package's MockNetwork, DummyContract and NotaryClientFlow."""
    from ..flows.notary import NotaryClientFlow
    from .dummies import DummyContract
    from .mock_network import MockNetwork

    return SimpleNamespace(MockNetwork=MockNetwork, DummyContract=DummyContract,
                           NotaryClientFlow=NotaryClientFlow)


class TimedVerifier:
    """Forwards ``verify_batch`` to ``inner`` and keeps the calls' sizes and
    the seconds spent inside them. Every other attribute reads through."""

    def __init__(self, inner):
        self.inner = inner
        self.sizes: list[int] = []
        self.seconds = 0.0

    def verify_batch(self, jobs):
        t0 = time.perf_counter()
        try:
            return self.inner.verify_batch(jobs)
        finally:
            self.seconds += time.perf_counter() - t0
            self.sizes.append(len(jobs))

    def __getattr__(self, name):
        return getattr(self.inner, name)


def make_network(api, verifier, validating: bool):
    """A MockNetwork with the notary, Alice and Bob, created in that order
    (MockNetwork's keys come from a counter, so every network made here
    has the same identities). Each node's state machine verifies through a
    TimedVerifier over ``verifier``."""
    net = api.MockNetwork(verifier=verifier)
    notary = net.create_notary_node(NODE_NAMES[0], validating=validating)
    alice = net.create_node(NODE_NAMES[1])
    bob = net.create_node(NODE_NAMES[2])
    for node in (notary, alice, bob):
        node.smm.verifier = TimedVerifier(node.smm.verifier)
    return net, notary, alice, bob


@dataclasses.dataclass
class Workload:
    issues: list           # recorded on Alice before any flow starts
    moves: list            # notarised in the burst or the waves
    doubles: list          # second spends, notarised in a last round
    bad: tuple             # positions in ``moves`` with a flipped sig byte
    double_of: tuple       # the move each second spend conflicts with


def build_workload(api, notary, alice, bob, n: int, n_bad: int,
                   n_double: int, seed: int) -> Workload:
    """``n`` issue-and-move pairs with magic numbers from ``seed``; the
    moves at ``n_bad`` seeded positions get their signature's byte
    ``sig[k]`` (k seeded too) flipped; ``n_double`` second spends move the
    inputs of seeded good moves back to Alice."""
    rng = np.random.default_rng(seed)
    magics = rng.integers(0, 2**31, n)
    bad = tuple(sorted(int(i) for i in rng.choice(n, n_bad, replace=False)))
    good = [i for i in range(n) if i not in set(bad)]
    double_of = tuple(int(i) for i in rng.choice(good, n_double,
                                                 replace=False))
    issues, moves = [], []
    for i in range(n):
        builder = api.DummyContract.generate_initial(
            alice.identity.ref(i.to_bytes(4, "big")), int(magics[i]),
            notary.identity)
        builder.sign_with(alice.key)
        issue = builder.to_signed_transaction()
        issues.append(issue)
        move = api.DummyContract.move(issue.tx.out_ref(0),
                                      bob.identity.owning_key)
        move.sign_with(alice.key)
        moves.append(move.to_signed_transaction(
            check_sufficient_signatures=False))
    for i in bad:
        stx = moves[i]
        sig = stx.sigs[0]
        k = int(rng.integers(0, 64))
        flipped = type(sig)(sig.bytes[:k] + bytes([sig.bytes[k] ^ 0x01])
                            + sig.bytes[k + 1:], sig.by)
        moves[i] = dataclasses.replace(stx, sigs=(flipped,))
    doubles = []
    for i in double_of:
        move = api.DummyContract.move(issues[i].tx.out_ref(0),
                                      alice.identity.owning_key)
        move.sign_with(alice.key)
        doubles.append(move.to_signed_transaction(
            check_sufficient_signatures=False))
    return Workload(issues, moves, doubles, bad, double_of)


def outcome_of(handle) -> tuple:
    """("ok", notary signature bytes, signer key bytes), or the exception's
    type name and, for a NotaryException, its error's type name."""
    try:
        sig = handle.result.result()
    except Exception as e:  # noqa: BLE001 -- the outcome is the record
        error = getattr(e, "error", None)
        return (type(e).__name__,
                type(error).__name__ if error is not None else None)
    return ("ok", bytes(sig.bytes), bytes(sig.by.encoded))


def _start(api, node, stx, starts: list, ends: list, k: int):
    starts[k] = time.perf_counter()
    handle = node.start_flow(api.NotaryClientFlow(stx))

    def _done(_future, k=k):
        ends[k] = time.perf_counter()

    handle.result.add_done_callback(_done)
    if handle.result.done and not ends[k]:  # finished inside start_flow
        ends[k] = time.perf_counter()
    return handle


def run_network_async(net, timeout_s: float = 120.0) -> None:
    """``net.run_network()`` for nodes whose state machine has the async
    verify pump installed (``smm.async_verify``): deliver messages, submit
    each such node's micro-batch to its pump and deliver the batches it
    has finished (other nodes flush as usual), until nothing moves and no
    batch is in flight. Raises AssertionError after ``timeout_s``."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        net.messaging_network.run()
        progressed = 0
        for node in net.nodes:
            if node.smm.async_verify is not None:
                progressed += node.smm.submit_pending_verifies()
                progressed += node.smm.drain_async_verifies()
            else:
                progressed += node.smm.flush_pending_verifies()
        busy = any(node.smm.async_verify is not None
                   and node.smm.async_verify.in_flight for node in net.nodes)
        if (not progressed and not busy
                and net.messaging_network.in_flight_count == 0):
            return
        if busy and not progressed:
            time.sleep(0.005)
    raise AssertionError("the network did not settle")


def run_workload(api, net, notary, alice, bob, workload: Workload,
                 wave: int | None = None, settle=None) -> dict:
    """Notarise ``workload.moves`` from Alice, all at once (``wave`` None)
    or ``wave`` flows at a time, then the second spends as one more round;
    each round ends with ``settle(net)`` (default ``net.run_network()``;
    ``run_network_async`` for the async pump). Returns the outcome record
    (see the module docstring); ``wall_s`` is the whole run's, ``flow_s``
    each flow's start-to-result time in the order of ``moves`` then
    ``doubles``."""
    stxs = workload.moves + workload.doubles
    starts = [0.0] * len(stxs)
    ends = [0.0] * len(stxs)
    rounds = ([range(len(workload.moves))] if wave is None else
              [range(lo, min(lo + wave, len(workload.moves)))
               for lo in range(0, len(workload.moves), wave)])
    rounds.append(range(len(workload.moves), len(stxs)))
    for issue in workload.issues:
        alice.record_transaction(issue)
    handles = [None] * len(stxs)
    t0 = time.perf_counter()
    for r in rounds:
        for k in r:
            handles[k] = _start(api, alice, stxs[k], starts, ends, k)
        if settle is None:
            net.run_network()
        else:
            settle(net)
    wall_s = time.perf_counter() - t0
    outcomes = [outcome_of(h) for h in handles]
    committed = {
        (bytes(ref.txhash.bytes), ref.index): bytes(tx.id.bytes)
        for ref, tx in notary.uniqueness_provider._committed.items()}
    nodes = {}
    for node in (notary, alice, bob):
        timed = node.smm.verifier
        nodes[node.name] = {
            "verify_batches": node.smm.metrics["verify_batches"],
            "verify_sigs": node.smm.metrics["verify_sigs"],
            "verify_device_degraded":
                node.smm.metrics["verify_device_degraded"],
            "largest_batch": max(timed.sizes, default=0),
            "verify_s": timed.seconds,
        }
    return {
        "outcomes": outcomes,
        "tx_ids": [bytes(s.id.bytes) for s in stxs],
        "flow_s": [e - s for s, e in zip(starts, ends)],
        "wall_s": wall_s,
        "verify_s": sum(v["verify_s"] for v in nodes.values()),
        "notarised": sum(o[0] == "ok" for o in outcomes),
        "committed": committed,
        "committed_count": notary.uniqueness_provider.committed_count,
        "nodes": nodes,
    }


def expected_outcomes(workload: Workload) -> list:
    """The outcome kind each transaction must have: a refused own signature
    for the flipped ones, a conflict for the second spends, else a notary
    signature."""
    bad = set(workload.bad)
    kinds = [("NotaryException", "NotarySignaturesMissing") if i in bad
             else ("ok",) for i in range(len(workload.moves))]
    kinds += [("NotaryException", "NotaryConflict")] * len(workload.doubles)
    return kinds
