"""The benchmark's own copy of the port's ``tools/loadgen.FirehoseFlow``, as
a CorDapp of the client nodes of ``raft.fh32``.

Each client takes its notary as the program's own clients do, the network
map's first (``get_any_notary``, as ``tools/loadgen.FirehoseFlow`` takes
it), and signs its corpus from the seed (``plan.py`` fixes which
moves are honest, tampered or second spends), then keeps ``inflight``
notarisations in flight, closed loop, until the driver's ``stop`` file
appears;
it then drains what is in flight, writes one record per move to
``records_<client>.json`` in the control directory and returns a summary.

A move is a ``DummyMove`` of one ``DummyMultiOwnerState`` owned by
``width`` keys, so it carries ``width`` signatures; its input is the output
of its own issue transaction, recorded on the client so the validating
notary resolves it from there. A tampered move has one of its signatures
flipped and is sent without the client's own signature check (a client
that forges, so that the notary is the one to refuse it); a second spend
consumes the input of an earlier honest move, and is started only once that
move's outcome has reached the client.

After ``warm`` outcomes the client writes ``warm_<client>`` in the control
directory: the driver opens its window once every client has.
"""

from __future__ import annotations

import json
import os
import time

from corda_tpu_torch.contracts.structures import Command
from corda_tpu_torch.crypto.batch_sign import sign_builders
from corda_tpu_torch.crypto.keys import DigitalSignature, KeyPair
from corda_tpu_torch.flows.api import FlowLogic, register_flow
from corda_tpu_torch.flows.notary import (
    NotaryClientFlow,
    NotaryException,
    NotarySuccess,
    SignRequest,
)
from corda_tpu_torch.testing.dummies import (
    DummyCreate,
    DummyMove,
    DummyMultiOwnerState,
)
from corda_tpu_torch.transactions.builder import TransactionBuilder
from corda_tpu_torch.transactions.signed import SignedTransaction

from benchmark.cluster import plan

PREPARE_CHUNK = 128  # moves built and signed in one round of the run loop
STOP_POLL_S = 0.01  # how often the stop file is looked for


@register_flow(name="bench.ForgingNotaryClientFlow")
class ForgingNotaryClientFlow(NotaryClientFlow):
    """``NotaryClientFlow`` without the client's check of its own
    signatures: the notary receives the move as it is."""

    def _my_flow_name(self) -> str:
        # The notary's service flow answers sessions of NotaryClientFlow.
        return "NotaryClientFlow"

    def call(self):
        self.progress_tracker.current_step = self.REQUESTING
        target = self.via if self.via is not None else self.stx.tx.notary
        request = SignRequest(self.stx, self.service_hub.my_identity)
        response = yield self.send_and_receive(target, request)
        self.progress_tracker.current_step = self.VALIDATING
        result = response.unwrap()
        if isinstance(result, NotarySuccess):
            yield self.verify_signature_batched(result.sig,
                                                self.stx.id.bytes)
            return result.sig
        raise NotaryException(result.error)


class _Engine:
    """The per-round engine the node's run loop polls; memory only (a
    restarted client restarts the measurement)."""

    def __init__(self, flow: "Fh32Flow"):
        self.flow = flow
        self.smm = flow.state_machine.manager
        self.notary = None  # get_any_notary's, once the map has one
        seed, client = flow.seed, flow.client
        self.keys = [KeyPair.generate(plan.key_entropy(seed, client, "key", k))
                     for k in range(flow.width)]
        self.owners = tuple(k.public.composite for k in self.keys)
        self.issuer = KeyPair.generate(plan.key_entropy(seed, client,
                                                        "issuer"))
        self.kind, self.original = plan.moves(
            seed, client, flow.n_tx, flow.tampered_per_block,
            flow.second_per_block, flow.block)
        self.corpus: list = []  # (stx, input refs)
        self.out_refs: list = []  # the state each move's issue made
        self.records: list = []
        self.started = self.done = 0
        self.deferred: list[int] = []  # second spends waiting on originals
        self.next = 0  # next corpus index not yet started or deferred
        self.warm_written = False
        self.stopped = False
        self._stop_checked = 0.0
        self.prepared_at = 0.0
        self.prepare_s = 0.0
        self.dir = flow.control_dir

    # -- the corpus ---------------------------------------------------------

    def _prepare_round(self) -> bool:
        n = self.flow.n_tx
        if len(self.corpus) >= n:
            return True
        t0 = time.perf_counter()
        lo = len(self.corpus)
        hi = min(n, lo + PREPARE_CHUNK)
        issuer_cmd = (self.issuer.public.composite,)
        issues, moves = [], []
        for i in range(lo, hi):
            if self.kind[i] == plan.SECOND_SPEND:
                ref = self.out_refs[self.original[i]]
            else:
                issue = TransactionBuilder(notary=self.notary)
                issue.add_output_state(
                    DummyMultiOwnerState(i * 1_000_003, self.owners))
                issue.add_command(Command(DummyCreate(), issuer_cmd))
                issues.append(issue)
                ref = issue._wire_cached().out_ref(0)
            self.out_refs.append(ref)
            move = TransactionBuilder(notary=self.notary)
            move.add_input_state(ref)
            move.add_command(Command(DummyMove(), self.owners))
            # A second spend's output differs from its original's, so the
            # two moves have two ids over one input.
            move.add_output_state(DummyMultiOwnerState(
                i + (n if self.kind[i] == plan.SECOND_SPEND else 0),
                self.owners))
            moves.append(move)
        sign_builders(issues + moves,
                      [(self.issuer,)] * len(issues)
                      + [self.keys] * len(moves))
        self.flow.record_transactions(
            [b.to_signed_transaction() for b in issues])
        for i, move in zip(range(lo, hi), moves):
            stx = move.to_signed_transaction(
                check_sufficient_signatures=False)
            if self.kind[i] == plan.TAMPERED:
                stx = self._tampered(i, stx)
            self.corpus.append((stx, [self.out_refs[i].ref]))
        self.prepare_s += time.perf_counter() - t0
        return False

    def _tampered(self, i: int, stx):
        lane, pos, mask = plan.flipped_lane(self.flow.seed, self.flow.client,
                                            i, len(stx.sigs))
        sigs = list(stx.sigs)
        raw = bytearray(sigs[lane].bytes)
        raw[pos] ^= mask
        sigs[lane] = DigitalSignature.WithKey(bytes=bytes(raw),
                                              by=sigs[lane].by)
        return SignedTransaction(stx.tx_bits, tuple(sigs), stx.id)

    # -- the closed loop ----------------------------------------------------

    def _stop_seen(self) -> bool:
        """Whether the driver's stop file is there, looked for at most
        every STOP_POLL_S."""
        now = time.monotonic()
        if not self.stopped and now - self._stop_checked >= STOP_POLL_S:
            self._stop_checked = now
            self.stopped = os.path.exists(os.path.join(self.dir, "stop"))
        return self.stopped

    def _ready(self, i: int) -> bool:
        """A second spend waits for its original's outcome."""
        o = self.original.get(i)
        return o is None or self.records[o] is not None

    def _take(self):
        """The next move to start, or None."""
        for k, i in enumerate(self.deferred):
            if self._ready(i):
                return self.deferred.pop(k)
        while self.next < self.flow.n_tx:
            i = self.next
            self.next += 1
            if self._ready(i):
                return i
            self.deferred.append(i)
        return None

    def _start(self, i: int) -> None:
        stx, inputs = self.corpus[i]
        flow_cls = (ForgingNotaryClientFlow if self.kind[i] == plan.TAMPERED
                    else NotaryClientFlow)
        handle = self.smm.add(flow_cls(stx))
        self.started += 1
        t_start = time.time()

        def on_done(future, i=i, t_start=t_start):
            t_done = time.time()
            exc = future.exception()
            rec = {"i": i, "t_start": t_start, "t_done": t_done,
                   "tx_id": bytes(stx.id.bytes).hex(),
                   "inputs": [[bytes(r.txhash.bytes).hex(), r.index]
                              for r in inputs]}
            if exc is None:
                sig = future.result()
                rec.update(acked=True, notary_pk=bytes(sig.by.encoded).hex(),
                           notary_sig=bytes(sig.bytes).hex())
            else:
                error = getattr(exc, "error", None)
                rec.update(acked=False, error=type(
                    error if error is not None else exc).__name__)
            self.records[i] = rec
            self.done += 1

        handle.result.add_done_callback(on_done)

    def poll(self):
        if self.notary is None:
            self.notary = \
                self.flow.service_hub.network_map_cache.get_any_notary()
            if self.notary is None:
                return None
        if not self._prepare_round():
            return None
        if not self.records:
            self.records = [None] * self.flow.n_tx
            self.prepared_at = time.time()
        if not self.warm_written and self.done >= self.flow.warm:
            self.warm_written = True
            path = os.path.join(self.dir, f"warm_{self.flow.client}")
            with open(path + ".tmp", "w") as f:
                f.write(str(time.time()))
            os.replace(path + ".tmp", path)
        if not self._stop_seen():
            while self.started - self.done < self.flow.inflight:
                i = self._take()
                if i is None:
                    break
                self._start(i)
        if not self.stopped or self.done < self.started:
            return None
        records = [r for r in self.records if r is not None]
        path = os.path.join(self.dir, f"records_{self.flow.client}.json")
        with open(path + ".tmp", "w") as f:
            json.dump(records, f)
        os.replace(path + ".tmp", path)
        return {"started": self.started, "done": self.done,
                "corpus": len(self.corpus), "left": self.flow.n_tx
                - self.next + len(self.deferred),
                "prepare_s": round(self.prepare_s, 3),
                "prepared_at": self.prepared_at, "notary": self.notary.name}


@register_flow(name="bench.Fh32Flow")
class Fh32Flow(FlowLogic):
    """start_flow_dynamic("bench.Fh32Flow", (seed, client, n_tx, width,
    inflight, warm, tampered_per_block, second_per_block, block,
    control_dir)) -> a summary dict; the records go to a file."""

    def __init__(self, seed: int, client: int, n_tx: int, width: int,
                 inflight: int, warm: int, tampered_per_block: int,
                 second_per_block: int, block: int, control_dir: str):
        self.seed = seed
        self.client = client
        self.n_tx = n_tx
        self.width = width
        self.inflight = inflight
        self.warm = warm
        self.tampered_per_block = tampered_per_block
        self.second_per_block = second_per_block
        self.block = block
        self.control_dir = control_dir

    def call(self):
        result = yield self.service_request(lambda: _Engine(self).poll)
        return result


def install(node) -> None:
    """CorDapp hook: importing the module registers the flows."""
