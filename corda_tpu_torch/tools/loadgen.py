"""In-node load generation: the firehose lives WHERE the flows live.

Capability match for the reference's loadtest generate/execute loop
(reference: tools/loadtest/src/main/kotlin/net/corda/loadtest/LoadTest.kt:
39-144 — generation happens against remote nodes, execution runs ON them)
re-shaped for the multi-process driver: instead of the coordinating process
round-robin-pumping every node under one GIL (the round-2 harness artifact),
each client NODE PROCESS runs a FirehoseFlow that generates, signs and
notarises its own transaction stream in-process. The coordinator only makes
two RPC calls per client: start the firehose, fetch the result summary.

Workload shape (NotaryDemo firehose widened to the fan-out-verify case,
BASELINE config 4): every move transaction is owned by `width` distinct keys
and carries `width` signatures, so one notarisation round-trip pushes `width`
signature checks through the client's verify pump (and the validating
notary's, if configured) — tens of signatures per flow, the VERDICT round-2
prescription for feeding the TPU through the framework instead of beside it.

Admission control is the open-loop/closed-loop seam (VERDICT round-2 item 2):

  * closed-loop (`inflight=K`): keep K notarisations in flight — measures
    capacity;
  * open-loop (`rate_tx_s=λ`): start flows on a fixed-rate schedule
    regardless of completions — measures latency at an offered load, giving
    p50 ≠ p99 tail behaviour that the start-all-then-pump shape cannot.

The flow itself suspends exactly ONCE (on a ServiceRequest): the per-tx
machinery runs in the poll callable the node's run loop drives each round,
so the firehose's own checkpoint stays O(1) while its children (ordinary
NotaryClientFlow instances) checkpoint normally.

The port's own copy of ``corda_tpu/tools/loadgen.py``. The flows register
in the port's flow registry only; the codec's wire names carry no package
prefix, so a ``FirehoseResult`` decodes in either package.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass

from ..crypto.keys import KeyPair
from ..flows.api import FlowLogic, register_flow
from ..flows.notary import NotaryClientFlow
from ..serialization.codec import register
from .ingest import IngestStats, build_chunk_columnar


@register
@dataclass(frozen=True)
class FirehoseResult:
    """Summary returned to the RPC caller."""

    requested: int
    committed: int
    rejected: int
    duration_s: float
    tx_per_sec: float
    p50_ms: float
    p90_ms: float
    p99_ms: float
    width: int
    sigs_signed: int
    # Sharded-notary mix accounting: how many of the requested transactions
    # were generated with inputs spanning two shards, and how many of those
    # committed (the exactly-once audit needs both sides of the ratio).
    cross_requested: int = 0
    cross_committed: int = 0
    # QoS lane this firehose ran on ("" = unlabelled) and how many of its
    # rejections were admission-control sheds (OverloadedError) — the SLO
    # sweep separates shed load from genuine conflicts with these.
    lane: str = ""
    shed: int = 0
    # Ingest (round-15) client-plane attribution: columnar prepare
    # throughput and the process CPU this firehose consumed. Defaulted so
    # older drivers deserialize newer results (ClientReply precedent).
    tx_built_per_s: float = 0.0
    sigs_signed_per_s: float = 0.0
    serialize_ms: float = 0.0
    prepare_s: float = 0.0
    cpu_s: float = 0.0


class _Firehose:
    """The per-round engine driven by poll(); lives only in memory (the
    owning flow re-creates it from scratch if restored — idempotent for a
    load TOOL: a restart restarts the measurement, it does not double-spend
    because every generated state is fresh)."""

    BURST_CAP = 512  # max flow starts admitted per scheduling round
    # Transactions built+signed per prepare round. Columnar prepare
    # (ingest.build_chunk_columnar) amortizes signing into ONE native
    # batch per chunk, so bigger chunks are cheaper per tx — 256 keeps a
    # round under ~100 ms while the node still services its run loop.
    PREPARE_CHUNK = 256

    def __init__(self, flow: "FirehoseFlow"):
        self.flow = flow
        hub = flow.service_hub
        self.smm = flow.state_machine.manager
        self.notary = self._find_notary(hub)
        # Throwaway signer set: `width` owner keys sign every move; one
        # issuer key signs issues (the contract does not require issue
        # signatures from owners, and this keeps signing cost ~width+1/tx).
        self.keys = [KeyPair.generate() for _ in range(flow.width)]
        self.owners = tuple(k.public.composite for k in self.keys)
        self.issuer = KeyPair.generate()
        # PREPARE phase: the corpus is built and signed BEFORE the timer
        # starts (NotaryDemo semantics — issuance/signing is workload setup;
        # the measured quantity is the notarisation pipeline). Chunked so
        # the node keeps servicing its run loop while preparing.
        self.corpus: list = []  # (stx, via_party_or_None, is_cross)
        self.started = 0
        self.done = 0
        self.committed = 0
        self.rejected = 0
        self.shed = 0
        self.cross_requested = 0
        self.cross_committed = 0
        self.sigs_signed = 0
        self.latencies: list[float] = []
        self.ingest = IngestStats()  # columnar prepare attribution
        self.t0: float | None = None  # set when the measured phase begins
        self._cpu0 = 0.0  # process CPU mark at measured-phase start
        # Sharded topology (if any) from the netmap: routes each move to
        # its owning group's first member so single-shard traffic takes the
        # fast path (without this every request lands on one arbitrary
        # member and most commits cross groups — shard scaling would
        # measure the coordinator, not the shards).
        from ..flows.notary import _shard_directory

        self.directory = _shard_directory(flow)
        # Every Nth corpus transaction spans two shards (0 = none). With no
        # shard directory the "cross" txs still carry two inputs — the
        # same tx shape through an unsharded notary.
        frac = getattr(flow, "cross_frac", 0.0)
        self._cross_every = round(1.0 / frac) if frac > 0.0 else 0

    @staticmethod
    def _find_notary(hub):
        notary = hub.network_map_cache.get_any_notary()
        if notary is None:
            raise RuntimeError("no notary advertised in the network map")
        return notary

    def _route(self, state_and_ref):
        """Member Party of the shard group owning a StateAndRef's ref
        (None when the notary is unsharded)."""
        return self._route_ref(state_and_ref.ref)

    def _route_ref(self, ref):
        """Same routing from a bare StateRef (replay workers only carry
        the deserialized wire, not StateAndRefs)."""
        if self.directory is None:
            return None
        from ..node.services.sharding import shard_of

        count, groups = self.directory
        members = groups.get(shard_of(ref, count))
        return members[0] if members else None

    def _prepare_round(self) -> bool:
        """One prepare round; True once the corpus is complete. The base
        engine builds columnar (ingest.build_chunk_columnar replaced the
        retired per-tx `_build_one` loop: byte-identical output, one
        batched sign + one record_transactions per chunk)."""
        if len(self.corpus) < self.flow.n_tx:
            k = min(self.PREPARE_CHUNK, self.flow.n_tx - len(self.corpus))
            self.corpus.extend(
                build_chunk_columnar(self, len(self.corpus), k, self.ingest))
            return False  # the clock starts on a LATER round
        return True

    def _admit_quota(self) -> int:
        """How many new flows this round may start."""
        remaining = self.flow.n_tx - self.started
        if remaining <= 0:
            return 0
        if self.flow.rate_tx_s > 0.0:
            # Open loop: the schedule says `rate*elapsed` flows should have
            # started by now — start the shortfall, completions be damned.
            elapsed = time.perf_counter() - self.t0
            due = int(self.flow.rate_tx_s * elapsed) - self.started
            return max(0, min(remaining, due, self.BURST_CAP))
        in_flight = self.started - self.done
        return max(0, min(remaining, self.flow.inflight - in_flight,
                          self.BURST_CAP))

    def poll(self):
        if not self._prepare_round():
            return None  # still preparing; the clock has not started
        if self.t0 is None:
            self.t0 = time.perf_counter()
            self._cpu0 = time.process_time()
        from ..qos import context as _qos

        lane = getattr(self.flow, "lane", "")
        plane = _qos.ACTIVE
        for _ in range(self._admit_quota()):
            stx, via, cross = self.corpus[self.started]
            self.started += 1
            submitted = time.perf_counter()
            # Lane-labelled load: each tx gets a fresh QosContext stamped
            # admitted-now (interactive derives its deadline from slo_ms),
            # so the whole QoS plane sees this firehose's class. Unlabelled
            # (lane="" or plane disarmed) starts exactly as before.
            qctx = (plane.new_context(
                        lane, getattr(self.flow, "slo_ms", 0.0) or None)
                    if plane is not None and lane else None)
            handle = self.smm.add(NotaryClientFlow(stx, via=via), qos=qctx)

            def on_done(future, t=submitted, cross=cross):
                self.done += 1
                self.latencies.append(time.perf_counter() - t)
                exc = future.exception()
                if exc is None:
                    self.committed += 1
                    if cross:
                        self.cross_committed += 1
                else:
                    self.rejected += 1
                    from ..flows.notary import OverloadedError

                    if isinstance(getattr(exc, "error", None),
                                  OverloadedError):
                        self.shed += 1

            handle.result.add_done_callback(on_done)
        if self.done < self.flow.n_tx:
            return None
        duration = time.perf_counter() - self.t0
        lat = sorted(self.latencies) or [0.0]

        def pct(p: float) -> float:
            return round(1e3 * lat[min(len(lat) - 1, int(len(lat) * p))], 2)

        return FirehoseResult(
            requested=self.flow.n_tx,
            committed=self.committed,
            rejected=self.rejected,
            duration_s=round(duration, 3),
            tx_per_sec=round(self.flow.n_tx / duration, 1),
            p50_ms=pct(0.50),
            p90_ms=pct(0.90),
            p99_ms=pct(0.99),
            width=self.flow.width,
            sigs_signed=self.sigs_signed,
            cross_requested=self.cross_requested,
            cross_committed=self.cross_committed,
            lane=getattr(self.flow, "lane", ""),
            shed=self.shed,
            tx_built_per_s=self.ingest.tx_built_per_s,
            sigs_signed_per_s=self.ingest.sigs_signed_per_s,
            serialize_ms=self.ingest.serialize_ms,
            prepare_s=round(self.ingest.prepare_s, 4),
            # Total process CPU attributable to this firehose: columnar
            # prepare plus the measured drive phase.
            cpu_s=round(self.ingest.cpu_s
                        + (time.process_time() - self._cpu0), 4),
        )


@register_flow(name="loadgen.FirehoseFlow")
class FirehoseFlow(FlowLogic):
    """RPC-startable firehose: start_flow("loadgen.FirehoseFlow", n_tx,
    width, inflight, rate_tx_s, cross_frac) → FirehoseResult.

    cross_frac > 0 makes every round(1/cross_frac)-th move consume inputs
    owned by two different notary shards (the 2PC path); single-shard moves
    route to their owning group via the netmap shard directory."""

    def __init__(self, n_tx: int, width: int = 1, inflight: int = 64,
                 rate_tx_s: float = 0.0, cross_frac: float = 0.0,
                 lane: str = "", slo_ms: float = 0.0):
        self.n_tx = n_tx
        self.width = width
        self.inflight = inflight
        self.rate_tx_s = rate_tx_s
        self.cross_frac = cross_frac
        # QoS lane for every generated tx ("interactive"/"bulk"; "" starts
        # them unlabelled) and the interactive SLO override in ms (0 uses
        # the armed plane's default).
        self.lane = lane
        self.slo_ms = slo_ms

    def call(self):
        result = yield self.service_request(lambda: _Firehose(self).poll)
        return result


@register
@dataclass(frozen=True)
class IngestBuildResult:
    """Summary of a pre-built, pre-serialized corpus (IngestBuildFlow)."""

    path: str
    n_tx: int
    sigs_signed: int
    bytes_written: int
    tx_built_per_s: float
    sigs_signed_per_s: float
    serialize_ms: float
    prepare_s: float
    cpu_s: float
    cross_requested: int = 0


class _IngestBuild(_Firehose):
    """Build + sign + serialize a corpus to a multi-tx frame on disk,
    WITHOUT driving any load: the multiprocess firehose's prepare stage.
    Replay workers map disjoint slices of the written frame, so they
    never rebuild or re-sign anything."""

    def poll(self):
        if not self._prepare_round():
            return None
        from .ingest import serialize_corpus

        frame = serialize_corpus(
            [stx for stx, _, _ in self.corpus], self.ingest)
        tmp = self.flow.out_path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(frame)
        os.replace(tmp, self.flow.out_path)  # atomic: never a torn corpus
        st = self.ingest
        return IngestBuildResult(
            path=self.flow.out_path,
            n_tx=st.n_tx,
            sigs_signed=st.sigs_signed,
            bytes_written=len(frame),
            tx_built_per_s=st.tx_built_per_s,
            sigs_signed_per_s=st.sigs_signed_per_s,
            serialize_ms=st.serialize_ms,
            prepare_s=round(st.prepare_s, 4),
            cpu_s=round(st.cpu_s, 4),
            cross_requested=self.cross_requested,
        )


@register_flow(name="loadgen.IngestBuildFlow")
class IngestBuildFlow(FlowLogic):
    """RPC-startable corpus builder: columnar build+sign n_tx moves, pack
    them into ONE multi-tx frame at out_path, return IngestBuildResult.
    Issue provenance is recorded on THIS node only — replay slices must
    be driven at a non-validating notary (uniqueness does not need the
    back chain; validation would)."""

    def __init__(self, out_path: str, n_tx: int, width: int = 1,
                 cross_frac: float = 0.0):
        self.out_path = out_path
        self.n_tx = n_tx
        self.width = width
        self.cross_frac = cross_frac
        self.inflight = 0  # unused: this flow never starts children
        self.rate_tx_s = 0.0
        self.lane = ""
        self.slo_ms = 0.0

    def call(self):
        result = yield self.service_request(lambda: _IngestBuild(self).poll)
        return result


class _Replay(_Firehose):
    """Firehose engine whose prepare phase LOADS a pre-serialized corpus
    slice instead of building one — the worker half of the multiprocess
    firehose. Deserialization is chunked so the node's run loop keeps
    servicing transport while the slice loads; route and cross flags are
    re-derived from each wire's inputs (first-input shard owner; >1 input
    = cross), so the frame needs no sidecar metadata."""

    LOAD_CHUNK = 512  # wires deserialized per prepare round

    def __init__(self, flow):
        super().__init__(flow)
        self._payloads: list | None = None

    def _prepare_round(self) -> bool:
        from ..serialization.codec import deserialize
        from .ingest import unpack_frame

        t0 = time.perf_counter()
        cpu0 = time.process_time()
        if self._payloads is None:
            with open(self.flow.corpus_path, "rb") as f:
                blob = f.read()
            payloads = unpack_frame(blob)  # loud on any damage
            lo = self.flow.offset
            hi = lo + self.flow.n_tx
            if hi > len(payloads):
                raise RuntimeError(
                    f"corpus slice [{lo}:{hi}) exceeds frame of "
                    f"{len(payloads)} entries")
            self._payloads = payloads[lo:hi]
        done = len(self.corpus)
        if done < self.flow.n_tx:
            for p in self._payloads[done:done + self.LOAD_CHUNK]:
                stx = deserialize(p)
                inputs = stx.tx.inputs
                cross = len(inputs) > 1
                if cross:
                    self.cross_requested += 1
                if not self.flow.width:
                    self.flow.width = len(stx.sigs)
                self.corpus.append(
                    (stx, self._route_ref(inputs[0]), cross))
            self.ingest.n_tx = len(self.corpus)
            self.ingest.prepare_s += time.perf_counter() - t0
            self.ingest.cpu_s += time.process_time() - cpu0
            return False
        return True


@register_flow(name="loadgen.FirehoseReplayFlow")
class FirehoseReplayFlow(FlowLogic):
    """RPC-startable replay firehose: drive a disjoint [offset, offset+
    n_tx) slice of a pre-built multi-tx corpus frame through the notary.
    Same admission control and result shape as FirehoseFlow; the corpus
    was signed once by IngestBuildFlow, so the worker's own CPU is almost
    entirely submission — the shape that lets W processes offer W× the
    single-process rate."""

    def __init__(self, corpus_path: str, offset: int, n_tx: int,
                 inflight: int = 64, rate_tx_s: float = 0.0,
                 lane: str = "", slo_ms: float = 0.0):
        self.corpus_path = corpus_path
        self.offset = offset
        self.n_tx = n_tx
        self.inflight = inflight
        self.rate_tx_s = rate_tx_s
        self.lane = lane
        self.slo_ms = slo_ms
        self.width = 0  # observed from the first deserialized wire
        self.cross_frac = 0.0  # cross mix is baked into the corpus

    def call(self):
        result = yield self.service_request(lambda: _Replay(self).poll)
        return result


def install(node) -> None:
    """Cordapp hook — importing the module registers the flows; nothing
    else to wire (the firehose starts children directly on the node's
    SMM)."""
