"""L1 transactions: wire/signed/ledger transactions, builder, tear-offs.

The port's own copies of ``corda_tpu/transactions``.
"""

from .types import TransactionType, GeneralTransactionType, NotaryChangeTransactionType  # noqa: F401
from .wire import WireTransaction  # noqa: F401
from .signed import SignedTransaction, SignaturesMissingException  # noqa: F401
from .ledger import LedgerTransaction  # noqa: F401
from .builder import TransactionBuilder  # noqa: F401
from .filtered import FilteredLeaves, FilteredTransaction, FilterFuns  # noqa: F401
