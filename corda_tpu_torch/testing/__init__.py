"""Test infrastructure of the port (own copies of corda_tpu/testing): the
dummy contract and its states (``dummies``, registered under the same wire
names), canned identities (``identities``), the ledger DSL
(``ledger_dsl``), the deterministic in-memory network (``mock_network``)
and fault injection (``faults``). Import the submodules directly: the state machine
and the transport import ``faults`` for their hooks, so an eager import of
``mock_network`` here would be circular."""
