"""L1 ledger data model: states, contracts, commands, transactions-for-contract.

The port's copies of ``corda_tpu/contracts``: ``structures.py``,
``verification.py`` and ``dsl.py``, with ``universal.py``, ``clauses.py``,
``sandbox.py`` and ``attachments_loader.py`` as modules of their own (not
exported here, as in the JAX package).
"""

from .structures import (  # noqa: F401
    Attachment,
    AuthenticatedObject,
    Command,
    CommandData,
    ContractState,
    Contract,
    DealState,
    FungibleAsset,
    IssueCommand,
    Issued,
    LinearState,
    MoveCommand,
    OwnableState,
    SchedulableState,
    StateAndRef,
    StateRef,
    Timestamp,
    TransactionState,
    TypeOnlyCommandData,
    UniqueIdentifier,
)
from .verification import (  # noqa: F401
    InOutGroup,
    TransactionForContract,
    TransactionVerificationException,
    ContractRejection,
    MoreThanOneNotary,
    NotaryChangeInWrongTransactionType,
    SignersMissing,
    InvalidNotaryChange,
    TransactionMissingEncumbranceException,
    TransactionResolutionException,
)
