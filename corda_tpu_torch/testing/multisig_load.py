"""BASELINE config 4 (finance Cash with 3-of-3 CompositeKey multi-sig,
fan-out verify) as a verify batch and as a notarisation workload.

* ``multisig_batch`` is bench_multisig's batch (bench.py:478-522): three
  board keys, a 3-of-3 composite over them, 64 transaction
  ids each signed by all three, every eighth by only the first two, tiled
  to ``tile_to`` transactions. ``fulfilled`` is the composite walk after a
  verify: per transaction, the keys whose signatures verified, held to the
  composite's threshold.
* ``build_moves`` / ``run_moves`` are tests/test_attachments_multisig.py's
  3-of-3 Cash case at scale over MockNetwork: ``n`` USD cash states issued
  by the Treasury to the board key, each moved back to the Treasury by a
  transaction the board signs (every eighth with only two members), all
  notarised in one burst at a validating notary, which must refuse exactly
  the under-signed moves.

Every function is passed the package it drives (``api``), as
notary_load's are; ``port_api()`` gives this package's own. Keys come from
fixed seeds and nonces from ``seed``, so every package builds byte-equal
transactions.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np

from .notary_load import TimedVerifier, _committed_of, _node_record, \
    _stages_before, outcome_of, start_timed

MOVE_NAMES = ("Notary", "Treasury")
MOVE_AMOUNT = 9_000  # USD, tests/test_attachments_multisig.py:77
SHORT_EVERY = 8      # every eighth transaction carries two signatures
N_DISTINCT = 64      # bench_multisig's distinct transactions


def port_api() -> SimpleNamespace:
    """This package's classes that the runners use."""
    from ..contracts.structures import Command, Issued
    from ..crypto.composite import CompositeKey
    from ..crypto.keys import KeyPair
    from ..crypto.provider import VerifyJob
    from ..finance.amount import Amount
    from ..finance.cash import Cash, CashMove, CashState
    from ..flows.notary import NotaryClientFlow
    from ..transactions.builder import TransactionBuilder
    from .mock_network import MockNetwork

    return SimpleNamespace(
        Command=Command, Issued=Issued, CompositeKey=CompositeKey,
        KeyPair=KeyPair, VerifyJob=VerifyJob, Amount=Amount, Cash=Cash,
        CashMove=CashMove, CashState=CashState,
        NotaryClientFlow=NotaryClientFlow,
        TransactionBuilder=TransactionBuilder, MockNetwork=MockNetwork)


def is_short(i: int) -> bool:
    return i % SHORT_EVERY == SHORT_EVERY - 1


# --- the verify batch (bench_multisig) --------------------------------------


def multisig_batch(api, tile_to: int) -> tuple:
    """(composite, txs, jobs, spans): bench_multisig's board keys and
    3-of-3 composite, ``tile_to`` (tx id, signatures) pairs tiled from
    N_DISTINCT distinct ones, one VerifyJob per signature in order,
    and each transaction's (first, last + 1) job index."""
    signers = [api.KeyPair.generate(bytes([0x31 + i]) * 32)
               for i in range(3)]
    composite = api.CompositeKey.Builder().add_keys(
        *[api.CompositeKey.leaf(kp.public) for kp in signers]).build(
            threshold=3)
    rng = np.random.default_rng(5)
    distinct = []
    for i in range(N_DISTINCT):
        msg = rng.integers(0, 256, 32, np.uint8).tobytes()
        sigs = [kp.sign(msg) for kp in signers]
        distinct.append((msg, sigs[:2] if is_short(i) else sigs))
    txs = [distinct[i % N_DISTINCT] for i in range(tile_to)]
    jobs, spans = [], []
    for msg, sigs in txs:
        spans.append((len(jobs), len(jobs) + len(sigs)))
        jobs += [api.VerifyJob(sig.by.encoded, msg, sig.bytes)
                 for sig in sigs]
    return composite, txs, jobs, spans


def fulfilled(composite, txs, spans, ok) -> list[bool]:
    """Per transaction: do the signatures ``ok`` accepts fulfil the
    composite? (bench_multisig's walk.)"""
    out = []
    for (_msg, sigs), (lo, hi) in zip(txs, spans):
        valid = {sigs[k - lo].by for k in range(lo, hi) if ok[k]}
        out.append(composite.is_fulfilled_by(valid))
    return out


# --- the notarisation workload ----------------------------------------------


def board_keys(api) -> list:
    """tests/test_attachments_multisig.py:71's three board members."""
    return [api.KeyPair.generate(bytes([0x61 + i]) * 32) for i in range(3)]


def make_move_network(api, verifier) -> tuple:
    """(net, notary, treasury) of MOVE_NAMES, the notary validating, each
    state machine's verifier a TimedVerifier over ``verifier``."""
    net = api.MockNetwork(verifier=verifier)
    notary = net.create_notary_node(MOVE_NAMES[0], validating=True)
    treasury = net.create_node(MOVE_NAMES[1])
    for node in (notary, treasury):
        node.smm.verifier = TimedVerifier(node.smm.verifier)
    return net, notary, treasury


def build_moves(api, notary, treasury, n: int, seed: int) -> tuple:
    """(issues, moves): ``n`` Cash issues of MOVE_AMOUNT USD by the
    Treasury to the 3-of-3 board key (nonces from ``seed``), and for each
    a move of it back to the Treasury under the board's CashMove, signed
    by all three members, or by two where ``is_short``."""
    members = board_keys(api)
    board = api.CompositeKey.Builder().add_keys(
        *[kp.public for kp in members]).build(threshold=3)
    token = api.Issued(treasury.identity.ref(b"\x01"), "USD")
    nonces = np.random.default_rng(seed).integers(0, 2**62, n)
    issues, moves = [], []
    for i in range(n):
        issue = api.Cash.generate_issue(
            api.Amount(MOVE_AMOUNT, "USD"), treasury.identity.ref(b"\x01"),
            board, notary.identity, nonce=int(nonces[i]))
        issue.sign_with(treasury.key)
        issue_stx = issue.to_signed_transaction()
        tx = api.TransactionBuilder(notary=notary.identity)
        tx.add_input_state(issue_stx.tx.out_ref(0))
        tx.add_output_state(api.CashState(
            api.Amount(MOVE_AMOUNT, token), treasury.identity.owning_key))
        tx.add_command(api.Command(api.CashMove(), (board,)))
        for kp in members[:2] if is_short(i) else members:
            tx.sign_with(kp)
        issues.append(issue_stx)
        moves.append(tx.to_signed_transaction(
            check_sufficient_signatures=False))
    return issues, moves


def run_moves(api, net, notary, treasury, issues, moves) -> dict:
    """Record the issues on the Treasury, then notarise every move from it
    in one burst and run the network. Returns each move's outcome
    (notary_load's ``outcome_of``) and start-to-result time, the notary's committed inputs and
    each node's verify record."""
    for stx in issues:
        treasury.record_transaction(stx)
    nodes = (notary, treasury)
    before = _stages_before(nodes)
    starts, ends = [0.0] * len(moves), [0.0] * len(moves)
    t0 = time.perf_counter()
    handles = [start_timed(treasury, api.NotaryClientFlow(stx), starts, ends,
                           k) for k, stx in enumerate(moves)]
    net.run_network()
    wall_s = time.perf_counter() - t0
    return {
        "outcomes": [outcome_of(h) for h in handles],
        "tx_ids": [bytes(s.id.bytes) for s in moves],
        "flow_s": [e - s for s, e in zip(starts, ends)],
        "wall_s": wall_s,
        "committed": _committed_of(notary),
        "nodes": {n.identity.name: _node_record(n, before) for n in nodes},
    }
