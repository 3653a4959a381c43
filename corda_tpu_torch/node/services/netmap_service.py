"""The network map directory service — dynamic registration over the wire.

The port's own copy of ``corda_tpu/node/services/netmap_service.py``.

Capability match for the reference's NetworkMapService (reference:
node/src/main/kotlin/net/corda/node/services/network/NetworkMapService.kt:
37-60 and PersistentNetworkMapService.kt): one designated node runs the
directory; peers push SIGNED registrations (add/remove with a monotonically
increasing serial so replayed or out-of-order updates are rejected), fetch
the current map, and subscribe for pushed updates.

The static netmap FILE (corda_tpu_torch/node/config.py) remains the bootstrap
mechanism — a node needs the map service's own address from somewhere; this
service takes over from there, exactly as the reference bootstraps the map
node from config.

Wire shape (topic "platform.netmap"):
  RegistrationRequest(signed NodeRegistration)  -> RegistrationResponse
  FetchMapRequest                               -> FetchMapResponse(nodes)
  SubscribeRequest                              -> (pushed) MapUpdate per change
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from ...crypto.party import Party
from ...crypto.signed_data import SignedData
from ...serialization.codec import deserialize, register, serialize
from ..messaging.api import Message, MessagingService, TopicSession
from .api import NodeInfo

NETMAP_TOPIC = "platform.netmap"

ADD = "add"
REMOVE = "remove"


@register
@dataclass(frozen=True)
class NodeRegistration:
    """What a node signs to join/leave the map (NetworkMapService.kt
    NodeRegistration): its info, a serial for ordering, add/remove."""

    node_info: NodeInfo
    serial: int
    kind: str  # ADD | REMOVE


@register
@dataclass(frozen=True)
class RegistrationRequest:
    registration: SignedData  # over a serialized NodeRegistration
    reply_to: Any  # transport address


@register
@dataclass(frozen=True)
class RegistrationResponse:
    success: bool
    error: str | None = None


@register
@dataclass(frozen=True)
class FetchMapRequest:
    reply_to: Any
    subscribe: bool = False


@register
@dataclass(frozen=True)
class FetchMapResponse:
    nodes: tuple = ()


@register
@dataclass(frozen=True)
class MapUpdate:
    kind: str
    node_info: NodeInfo


class NetworkMapService:
    """Server side, hosted by the map node."""

    def __init__(self, messaging: MessagingService):
        self._messaging = messaging
        self._nodes: dict[str, NodeInfo] = {}  # party name -> info
        self._serials: dict[str, int] = {}
        self._subscribers: list[Any] = []
        messaging.add_message_handler(NETMAP_TOPIC, 0, self._on_message)

    def _on_message(self, message: Message) -> None:
        try:
            payload = deserialize(message.data)
        except Exception:
            return
        if isinstance(payload, RegistrationRequest):
            response = self._register(payload)
            self._send(payload.reply_to, response)
        elif isinstance(payload, FetchMapRequest):
            self._send(payload.reply_to,
                       FetchMapResponse(tuple(self._nodes.values())))
            if payload.subscribe and payload.reply_to not in self._subscribers:
                self._subscribers.append(payload.reply_to)

    def _register(self, request: RegistrationRequest) -> RegistrationResponse:
        try:
            # verified() authenticates: the registration must be signed by
            # the registering identity's own key (NetworkMapService.kt
            # processRegistrationChangeRequest capability).
            reg = request.registration.verified()
            if not isinstance(reg, NodeRegistration):
                return RegistrationResponse(False, "not a NodeRegistration")
            identity = reg.node_info.legal_identity
            signer = request.registration.sig.by
            if signer not in identity.owning_key.keys:
                return RegistrationResponse(
                    False, "registration not signed by the node's identity")
            name = identity.name
            if reg.serial <= self._serials.get(name, -1):
                return RegistrationResponse(
                    False, f"stale serial {reg.serial}")
            self._serials[name] = reg.serial
            if reg.kind == ADD:
                self._nodes[name] = reg.node_info
            elif reg.kind == REMOVE:
                self._nodes.pop(name, None)
            else:
                return RegistrationResponse(False, f"bad kind {reg.kind!r}")
            update = MapUpdate(reg.kind, reg.node_info)
            for sub in list(self._subscribers):
                self._send(sub, update)
            return RegistrationResponse(True)
        except Exception as e:
            return RegistrationResponse(False, f"{type(e).__name__}: {e}")

    def _send(self, to, payload) -> None:
        self._messaging.send(TopicSession(NETMAP_TOPIC, 1),
                             serialize(payload).bytes, to)

    @property
    def node_count(self) -> int:
        return len(self._nodes)

    def get_node(self, name: str) -> NodeInfo | None:
        return self._nodes.get(name)

    def serial_of(self, name: str) -> int:
        return self._serials.get(name, -1)


class NetworkMapClient:
    """Client side: register this node, fetch/subscribe, and feed the local
    NetworkMapCache + identity service from pushed updates."""

    def __init__(self, messaging: MessagingService, map_address,
                 network_map_cache, identity_service, key_pair):
        self._messaging = messaging
        self._map_address = map_address
        self._cache = network_map_cache
        self._identities = identity_service
        self._key = key_pair
        self._serial = 0
        self.registered = False
        self.fetched = False
        messaging.add_message_handler(NETMAP_TOPIC, 1, self._on_message)

    def register(self, node_info: NodeInfo, kind: str = ADD) -> None:
        self._serial += 1
        reg = NodeRegistration(node_info, self._serial, kind)
        blob = serialize(reg)
        signed = SignedData(blob, self._key.sign(blob.bytes))
        self._messaging.send(
            TopicSession(NETMAP_TOPIC, 0),
            serialize(RegistrationRequest(signed,
                                          self._messaging.my_address)).bytes,
            self._map_address)

    def fetch_and_subscribe(self) -> None:
        self._messaging.send(
            TopicSession(NETMAP_TOPIC, 0),
            serialize(FetchMapRequest(self._messaging.my_address,
                                      subscribe=True)).bytes,
            self._map_address)

    def _on_message(self, message: Message) -> None:
        try:
            payload = deserialize(message.data)
        except Exception:
            return
        if isinstance(payload, RegistrationResponse):
            if payload.success:
                self.registered = True
        elif isinstance(payload, FetchMapResponse):
            for info in payload.nodes:
                self._apply(ADD, info)
            self.fetched = True
        elif isinstance(payload, MapUpdate):
            self._apply(payload.kind, payload.node_info)

    def _apply(self, kind: str, info: NodeInfo) -> None:
        if kind == ADD:
            self._identities.register_identity(info.legal_identity)
            self._cache.add_node(info)
        else:
            self._cache.remove_node(info)
