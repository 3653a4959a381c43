"""L1 transactions: wire and signed transactions and the builder.

The port's copies of ``corda_tpu/transactions``; ``ledger.py``,
``filtered.py`` and ``graph_search.py`` are not ported yet (ROADMAP.md).
"""

from .types import TransactionType, GeneralTransactionType, NotaryChangeTransactionType  # noqa: F401
from .wire import WireTransaction  # noqa: F401
from .signed import SignedTransaction, SignaturesMissingException  # noqa: F401
from .builder import TransactionBuilder  # noqa: F401
