"""OnLedgerAsset: the generic issued-fungible-asset contract.

Capability match for the reference's OnLedgerAsset + AbstractConserveAmount
(reference: finance/src/main/kotlin/net/corda/contracts/asset/
OnLedgerAsset.kt:26-60, finance/.../clause/ConserveAmount.kt): one shared
implementation of the issue/move/exit conservation rules and of greedy
coin-selection transaction generation with change, parameterised by the
concrete asset's state/command types and state derivation. Cash and
CommodityContract instantiate it (the reference's CommodityContract.kt:36
is "intentionally similar to Cash" for exactly this reason); Obligation's
bilateral settle/net lifecycle is a different shape and stays its own
contract.
"""

from __future__ import annotations

from ..contracts.dsl import RequirementFailed, require_that, select_command
from ..contracts.structures import (
    Command,
    CommandData,
    Contract,
    Issued,
    StateAndRef,
)
from ..crypto.composite import CompositeKey
from ..crypto.party import PartyAndReference
from ..transactions.builder import TransactionBuilder
from .amount import Amount, sum_or_zero


class InsufficientBalanceException(Exception):
    def __init__(self, amount_missing: Amount):
        super().__init__(f"Insufficient balance, missing {amount_missing}")
        self.amount_missing = amount_missing


class OnLedgerAsset(Contract):
    """Subclasses set the four type attributes and implement the three
    factory hooks + derive_state (OnLedgerAsset.kt's abstract surface)."""

    state_type: type
    issue_command_type: type
    move_command_type: type
    exit_command_type: type
    asset_noun: str = "asset"  # for error text ("cash", "commodity")

    # -- hooks -------------------------------------------------------------

    def make_issue_command(self, nonce: int) -> CommandData:
        raise NotImplementedError

    def make_move_command(self) -> CommandData:
        raise NotImplementedError

    def make_exit_command(self, amount: Amount) -> CommandData:
        raise NotImplementedError

    def derive_state(self, template, amount: Amount, owner: CompositeKey):
        """New state like `template` with amount/owner replaced
        (OnLedgerAsset.deriveState): keeps concrete-state extra fields."""
        raise NotImplementedError

    # -- verification (Cash.kt clause semantics, direct requireThat form) --

    def verify(self, tx) -> None:
        groups = tx.group_states(self.state_type, lambda s: s.amount.token)
        if not groups:
            raise RequirementFailed(
                f"{type(self).__name__} transaction has no "
                f"{self.asset_noun} states")
        for group in groups:
            token = group.grouping_key
            issuer_key = token.issuer.party.owning_key
            input_sum = sum_or_zero((s.amount for s in group.inputs), token)
            output_sum = sum_or_zero((s.amount for s in group.outputs), token)

            issue_cmds = [c for c in tx.commands
                          if isinstance(c.value, self.issue_command_type)]
            exit_cmds = [c for c in tx.commands
                         if isinstance(c.value, self.exit_command_type)
                         and c.value.amount.token == token]
            if issue_cmds and not group.inputs:
                with require_that() as req:
                    req("output values sum to more than the inputs",
                        output_sum.quantity > input_sum.quantity)
                    req("the issue command has the issuer as a signer",
                        any(issuer_key in c.signers for c in issue_cmds))
            elif exit_cmds:
                exit_amount = exit_cmds[0].value.amount
                with require_that() as req:
                    req("the amounts balance minus the exit amount",
                        input_sum.quantity - output_sum.quantity
                        == exit_amount.quantity)
                    req("the exit command is signed by the issuer",
                        any(issuer_key in c.signers for c in exit_cmds))
                    req("the exit command is signed by every input owner",
                        all(any(s.owner in c.signers for c in exit_cmds)
                            for s in group.inputs))
            else:
                move = select_command(tx.commands, self.move_command_type)
                with require_that() as req:
                    req("there are input states in a move", bool(group.inputs))
                    req("the amounts balance",
                        input_sum.quantity == output_sum.quantity)
                    req("every input owner has signed the move",
                        all(s.owner in move.signers for s in group.inputs))

    # -- transaction generation (OnLedgerAsset.kt:40-47 capability) --------

    def generate_issue(self, amount: Amount, issuer: PartyAndReference,
                       owner: CompositeKey, notary, nonce: int = 0,
                       ) -> TransactionBuilder:
        token = Issued(issuer, amount.token)
        state = self.derive_state(None, Amount(amount.quantity, token), owner)
        tx = TransactionBuilder(notary=notary)
        tx.add_output_state(state)
        tx.add_command(Command(self.make_issue_command(nonce),
                               (issuer.party.owning_key,)))
        return tx

    def generate_spend(self, tx: TransactionBuilder, amount: Amount,
                       recipient: CompositeKey,
                       asset_states: list[StateAndRef],
                       change_owner: CompositeKey | None = None,
                       ) -> list[CompositeKey]:
        """Greedy coin selection: consume states until `amount` of the
        product is covered; pay the recipient, return change. Returns the
        keys that must sign (input owners)."""
        product = amount.token
        gathered: list[StateAndRef] = []
        covered = 0
        for sar in asset_states:
            state = sar.state.data
            if not isinstance(state, self.state_type):
                continue
            if state.amount.token.product != product:
                continue
            gathered.append(sar)
            covered += state.amount.quantity
            if covered >= amount.quantity:
                break
        if covered < amount.quantity:
            raise InsufficientBalanceException(
                Amount(amount.quantity - covered, product))
        for sar in gathered:
            tx.add_input_state(sar)
        # Pay by issuer bucket, largest first, to minimise outputs.
        by_token: dict = {}
        for sar in gathered:
            st = sar.state.data
            by_token[st.amount.token] = (
                by_token.get(st.amount.token, 0) + st.amount.quantity)
        remaining = amount.quantity
        template = gathered[0].state.data
        change_key = change_owner or template.owner
        for token, qty in sorted(by_token.items(), key=lambda kv: -kv[1]):
            pay = min(qty, remaining)
            if pay:
                tx.add_output_state(self.derive_state(
                    template, Amount(pay, token), recipient))
            if qty > pay:  # change stays with the spender
                tx.add_output_state(self.derive_state(
                    template, Amount(qty - pay, token), change_key))
            remaining -= pay
        owners = list({sar.state.data.owner for sar in gathered})
        tx.add_command(Command(self.make_move_command(), tuple(owners)))
        return owners

    def generate_exit(self, tx: TransactionBuilder, amount: Amount,
                      asset_states: list[StateAndRef],
                      ) -> list[CompositeKey]:
        """Consume states of the exact issued token and burn `amount`,
        returning any remainder to its owner."""
        token = amount.token
        gathered = [s for s in asset_states
                    if isinstance(s.state.data, self.state_type)
                    and s.state.data.amount.token == token]
        covered = sum(s.state.data.amount.quantity for s in gathered)
        if covered < amount.quantity:
            raise InsufficientBalanceException(
                Amount(amount.quantity - covered, token))
        for sar in gathered:
            tx.add_input_state(sar)
        if covered > amount.quantity:
            template = gathered[0].state.data
            tx.add_output_state(self.derive_state(
                template, Amount(covered - amount.quantity, token),
                template.owner))
        owners = list({s.state.data.owner for s in gathered})
        signers = owners + [token.issuer.party.owning_key]
        tx.add_command(Command(self.make_exit_command(amount),
                               tuple(signers)))
        return signers
