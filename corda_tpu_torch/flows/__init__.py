"""L2/L3 flow framework: the programming model and the library flows.

The port's own copies of ``corda_tpu/flows``: the flow API, the notary
client and services, fetch, resolve, finality and data vending. ``deal``,
``oracle`` and ``state_replacement`` are not ported yet (ROADMAP.md).
"""

from .api import (  # noqa: F401
    FlowException,
    FlowLogic,
    FlowSessionException,
    ReceiveRequest,
    SendAndReceiveRequest,
    SendRequest,
    UntrustworthyData,
    VerifyTxRequest,
    flow_registry,
    register_flow,
)
from .notary import (  # noqa: F401
    NotaryClientFlow,
    NotaryConflict,
    NotaryError,
    NotaryException,
    NotaryServiceFlow,
    NotarySignaturesMissing,
    NotaryTimestampInvalid,
    NotaryTransactionInvalid,
    ValidatingNotaryFlow,
)
from .fetch import FetchAttachmentsFlow, FetchTransactionsFlow  # noqa: F401
from .resolve import ResolveTransactionsFlow  # noqa: F401
from .finality import BroadcastTransactionFlow, FinalityFlow  # noqa: F401
from .data_vending import install_data_vending  # noqa: F401
