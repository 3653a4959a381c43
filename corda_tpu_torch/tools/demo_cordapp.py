"""The notary-demo CorDapp: issue + move + notarise in one flow.

Capability match for the reference's raft-notary-demo app (reference:
samples/raft-notary-demo/src/main/kotlin/net/corda/notarydemo/api/
NotaryDemoApi.kt driven by NotaryDemo.kt:14-29, installed through
plugin/NotaryDemoPlugin.kt:8-16): a client asks the node to mint a dummy
state, spend it, and obtain the notary's uniqueness signature. Load it into
a node with `cordapps = ["corda_tpu_torch.tools.demo_cordapp"]` and drive it over
RPC with `start_flow("IssueAndNotariseFlow", magic)`.
"""

from __future__ import annotations

from ..flows.api import FlowException, FlowLogic, register_flow
from ..flows.notary import NotaryClientFlow
from ..node.services.api import NOTARY_TYPE
from ..testing.dummies import DummyContract


@register_flow
class IssueAndNotariseFlow(FlowLogic):
    """Mint a DummyContract state, move it to ourselves, notarise the move.
    Returns the notarised transaction id (hex)."""

    def __init__(self, magic: int):
        self.magic = magic

    def call(self):
        notary = self._pick_notary()
        me = self.service_hub.my_identity
        builder = DummyContract.generate_initial(
            me.ref(self.magic.to_bytes(4, "big")), self.magic, notary)
        builder.sign_with(self.service_hub.legal_identity_key)
        issue_stx = builder.to_signed_transaction()
        self.record_transactions([issue_stx])

        move = DummyContract.move(issue_stx.tx.out_ref(0), me.owning_key)
        move.sign_with(self.service_hub.legal_identity_key)
        stx = move.to_signed_transaction(check_sufficient_signatures=False)

        sig = yield from self.sub_flow(NotaryClientFlow(stx))
        self.record_transactions([stx.with_additional_signature(sig)])
        return stx.id.hex()

    def _pick_notary(self):
        for info in self.service_hub.network_map_cache.party_nodes:
            if any(s.type.is_sub_type_of(NOTARY_TYPE)
                   for s in info.advertised_services):
                return info.legal_identity
        raise FlowException("no notary advertised in the network map")


def install(node) -> None:  # plugin hook; nothing extra to wire
    pass
