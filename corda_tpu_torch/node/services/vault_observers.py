"""Vault-driven observers: balances as metrics.

Capability match for the reference's CashBalanceAsMetricsObserver (reference:
node/src/main/kotlin/net/corda/node/services/vault/
CashBalanceAsMetricsObserver.kt:11 — vault updates maintain a per-currency
cash-balance gauge in the node's metric registry)."""

from __future__ import annotations


class CashBalanceMetricsObserver:
    """Keeps metrics['balance.<currency>'] equal to the vault's unconsumed
    cash per currency (smallest units)."""

    def __init__(self, vault_service, metrics: dict):
        self._metrics = metrics
        self._balances: dict[str, int] = {}
        vault_service.subscribe(self._on_update)
        for sar in vault_service.iter_unconsumed():
            self._apply(sar, +1)
        self._publish()

    def _on_update(self, update) -> None:
        for sar in update.consumed:
            self._apply(sar, -1)
        for sar in update.produced:
            self._apply(sar, +1)
        self._publish()

    def _apply(self, sar, sign: int) -> None:
        from ...finance.cash import CashState

        state = sar.state.data
        if not isinstance(state, CashState):
            return
        currency = str(state.amount.token.product)
        self._balances[currency] = self._balances.get(currency, 0) \
            + sign * state.amount.quantity

    def _publish(self) -> None:
        for currency, quantity in self._balances.items():
            self._metrics[f"balance.{currency}"] = quantity


class IndexedBalanceMetricsObserver:
    """The indexed-engine twin: the vault already maintains per-currency
    aggregates in its vault_balances table, so publishing is one O(1)
    read of vault.balances() per update — no second in-memory tally that
    could drift from the durable one. Currencies that drain to zero keep
    publishing 0 (balances() omits them; the gauge must not go stale)."""

    def __init__(self, vault_service, metrics: dict):
        self._vault = vault_service
        self._metrics = metrics
        self._seen: set[str] = set()
        vault_service.subscribe(self._on_update)
        self._publish()

    def _on_update(self, update) -> None:
        self._publish()

    def _publish(self) -> None:
        balances = self._vault.balances()
        for currency in self._seen - set(balances):
            self._metrics[f"balance.{currency}"] = 0
        for currency, quantity in balances.items():
            self._metrics[f"balance.{currency}"] = quantity
            self._seen.add(currency)
