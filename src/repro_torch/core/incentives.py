"""Incentive mechanism for model sharing (paper §IV: "may also introduce
incentive mechanisms (e.g., based on monetary income or mutual interest) to
enable sharing of high-quality models in the network").

Credit-based ledger: publishing earns credits proportional to model quality;
every download pays the publisher, minus a service fee that goes to the
cloud operator's account; fetching costs the requester.  Parties with no
credits can still bootstrap via a small stipend (cold-start).

Conservation: credits enter the economy only by *minting* (cold-start
stipends and publish rewards), every fetch is a zero-sum transfer
(requester -> publisher + operator), every refund reverses one, and fraud
slashing burns balance and minted together — so at any instant

    sum(balances) == total_minted

``assert_conserved`` checks this invariant; the runtime exchange loop and
the scale benchmarks call it every cycle.

Fault tolerance (chaos runtime): ``on_refund`` reverses a paid fetch whose
download was dropped or corrupted in flight, and ``on_fraud`` handles a
publisher caught advertising an inflated card by the verify-on-fetch
re-evaluation — all of the publisher's minted publish rewards are slashed
(burned, keeping conservation exact) and the account is flagged so future
publishes mint nothing.  A byzantine publisher therefore ends at most with
its stipend, below any honest party's publish income.

Hierarchical topologies add *region operator* accounts (registered via
:meth:`IncentiveLedger.add_operator`): when a fetch is served in-region —
resolved by the region's discovery shard from one of its edge vaults or
its cache, never touching the backbone — the region operator earns
``region_fee_share`` of the service fee and the cloud operator keeps the
rest; that split is what pays for running the regional shards.  Operator
accounts never receive stipends and never mint, so the conservation
invariant extends unchanged over per-region accounts.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Set

# the cloud operator's account: collects the service fee on every fetch
OPERATOR = "cloud"


@dataclasses.dataclass
class LedgerEntry:
    """One account's balance plus per-operation counters."""

    balance: float = 0.0
    published: int = 0
    downloads_served: int = 0
    fetches: int = 0
    denied: int = 0  # fetch/serve attempts refused for insufficient credit
    refunds: int = 0  # failed fetches/queries reversed (drop/corruption/fraud)
    frauds: int = 0  # times this account was caught publishing inflated cards
    mint_earned: float = 0.0  # cumulative publish rewards (slashed on fraud)
    # serving tier (request plane): paid prediction queries issued / served
    queries: int = 0
    queries_served: int = 0


class IncentiveLedger:
    """Credit accounts for every party plus the cloud operator.

    ``service_fee`` is the fraction of each fetch payment retained by the
    operator (paper: the discovery/distillation service is a cloud service
    someone has to run); the remainder goes to the model's publisher.
    ``region_fee_share`` is the fraction of that fee forwarded to a region
    operator when a fetch is served in-region — by the region's shard from
    an edge vault or the region cache (hierarchical topologies only; see
    :meth:`add_operator`).
    """

    def __init__(self, publish_reward: float = 1.0, fetch_cost: float = 2.0,
                 quality_bonus: float = 5.0, stipend: float = 5.0,
                 service_fee: float = 0.2, operator: str = OPERATOR,
                 region_fee_share: float = 0.5, serve_cost: float = 0.05):
        if not 0.0 <= region_fee_share <= 1.0:
            raise ValueError(
                f"region_fee_share must be in [0, 1], got {region_fee_share}"
            )
        self.accounts: Dict[str, LedgerEntry] = {}
        self.publish_reward = publish_reward
        self.fetch_cost = fetch_cost
        self.quality_bonus = quality_bonus
        self.stipend = stipend
        self.service_fee = service_fee
        self.operator = operator
        self.region_fee_share = region_fee_share
        # per-query micro-fee settled by the serving tier: orders of
        # magnitude below fetch_cost — a prediction rents the model for
        # one query, a fetch buys the weights
        self.serve_cost = serve_cost
        self.minted = 0.0  # all credits ever created (stipends + rewards)
        self.flagged: Set[str] = set()  # caught byzantine publishers
        # staleness-demoted publishers: honest parties whose models decayed
        # below the drift threshold — they keep their earnings (no slash,
        # no flag) but stop minting until they publish is re-enabled
        self.demoted: Set[str] = set()
        # operator accounts (cloud + region shards): never stipended
        self.operators: Set[str] = {operator}
        self._acct(operator)  # operator starts at zero, no stipend

    def _acct(self, party: str) -> LedgerEntry:
        acct = self.accounts.get(party)
        if acct is None:
            grant = 0.0 if party in self.operators else self.stipend
            acct = self.accounts[party] = LedgerEntry(balance=grant)
            self.minted += grant
        return acct

    def add_operator(self, name: str) -> None:
        """Register an infrastructure operator account (e.g. a region's).

        Operators collect fee shares but never receive stipends and never
        mint publish rewards, so adding them cannot disturb conservation.
        Must happen before the account transacts as a party.
        """
        if name in self.accounts and name not in self.operators:
            raise ValueError(f"{name!r} already exists as a party account")
        self.operators.add(name)
        self._acct(name)

    def on_publish(self, party: str, accuracy: float) -> float:
        """Mint the publish reward + accuracy-proportional quality bonus.

        Flagged accounts (caught publishing inflated cards) mint nothing:
        reputation death is what keeps a repeat byzantine publisher from
        re-earning slashed rewards cycle after cycle.  Returns the amount
        minted (0.0 for flagged accounts) so callers can report the fee
        side of a publish outcome.
        """
        acct = self._acct(party)
        acct.published += 1
        if party in self.flagged or party in self.demoted:
            return 0.0
        reward = self.publish_reward + self.quality_bonus * max(accuracy, 0.0)
        acct.balance += reward
        acct.mint_earned += reward
        self.minted += reward
        return reward

    def can_fetch(self, party: str) -> bool:
        """Can this account cover one fetch? (Opens it if new.)"""
        return self._acct(party).balance >= self.fetch_cost

    def on_denied(self, party: str):
        """Count a fetch attempt refused for insufficient credit."""
        self._acct(party).denied += 1

    def _fee_split(self, region_operator: Optional[str],
                   cost: Optional[float] = None):
        """(total fee, region operator's cut) for one payment of ``cost``.

        ``cost`` defaults to ``fetch_cost``; the serving tier passes
        ``serve_cost`` so query micro-fees split identically to fetch fees.
        """
        if cost is None:
            cost = self.fetch_cost
        fee = cost * self.service_fee
        region_cut = (fee * self.region_fee_share
                      if region_operator is not None else 0.0)
        return fee, region_cut

    def fee_record(self, region_operator: Optional[str] = None, *,
                   cost: Optional[float] = None,
                   refunded: bool = False) -> Dict[str, float]:
        """Describe one payment's settlement for an :class:`Outcome` envelope.

        Pure reporting — touches no balances.  Returns ``paid`` (what the
        requester transferred), ``fee`` (the operator slice of it) and
        ``region_cut`` (the share forwarded to a region operator, 0.0 for
        flat/cloud service); ``refunded`` adds a ``refunded`` key equal to
        ``paid`` for payments that were reversed in full.
        """
        if cost is None:
            cost = self.fetch_cost
        fee, region_cut = self._fee_split(region_operator, cost)
        rec = {"paid": cost, "fee": fee, "region_cut": region_cut}
        if refunded:
            rec["refunded"] = cost
        return rec

    def on_fetch(self, requester: str, publisher: str,
                 region_operator: Optional[str] = None):
        """Zero-sum transfer: requester -> publisher, fee -> operator(s).

        When the fetch was served in-region, pass the region's operator
        account: it earns ``region_fee_share`` of the service fee and the
        cloud operator keeps the remainder.
        """
        if not self.can_fetch(requester):
            self._acct(requester).denied += 1
            raise PermissionError(f"{requester} has insufficient credits")
        fee, region_cut = self._fee_split(region_operator)
        req = self._acct(requester)
        req.balance -= self.fetch_cost
        req.fetches += 1
        pub = self._acct(publisher)
        pub.balance += self.fetch_cost - fee
        pub.downloads_served += 1
        self._acct(self.operator).balance += fee - region_cut
        if region_operator is not None:
            self._acct(region_operator).balance += region_cut

    def on_refund(self, requester: str, publisher: str,
                  region_operator: Optional[str] = None):
        """Reverse one paid fetch (dropped/corrupted/fraud/outage delivery).

        Exact inverse of :meth:`on_fetch` — requester is made whole, and
        the publisher, cloud operator, and (if the payment split a fee
        share) region operator return their cuts — so the transfer nets to
        zero and conservation is untouched.  Pass the same
        ``region_operator`` the payment used.
        """
        fee, region_cut = self._fee_split(region_operator)
        req = self._acct(requester)
        req.balance += self.fetch_cost
        req.refunds += 1
        self._acct(publisher).balance -= self.fetch_cost - fee
        self._acct(self.operator).balance -= fee - region_cut
        if region_operator is not None:
            self._acct(region_operator).balance -= region_cut

    # -- serving tier (request plane) ---------------------------------------
    def can_serve(self, party: str, mult: float = 1.0) -> bool:
        """Can this account cover one prediction query? (Opens it if new.)

        ``mult`` is the SLA-tier fee multiplier: a tier-2 request must be
        able to cover ``serve_cost * mult``, not just the base fee.
        """
        return self._acct(party).balance >= self.serve_cost * mult

    def on_serve(self, requester: str, publisher: str,
                 region_operator: Optional[str] = None,
                 mult: float = 1.0):
        """Zero-sum micro-fee for one served prediction query.

        Mirrors :meth:`on_fetch` at ``serve_cost * mult``: requester pays,
        the replica's publisher earns the remainder, the operator(s) split
        the service fee — with the region operator's cut flowing when the
        query was answered by a region-hosted replica or shard resolution
        rather than the cloud.  ``mult`` is the SLA-tier fee multiplier
        (priority tiers pay more for the right to jump the slot queue);
        the fee split scales with it, so operators and publishers share
        the premium pro rata.  Conservation is untouched (no minting).
        """
        if not self.can_serve(requester, mult):
            self._acct(requester).denied += 1
            raise PermissionError(f"{requester} has insufficient credits")
        cost = self.serve_cost * mult
        fee, region_cut = self._fee_split(region_operator, cost)
        req = self._acct(requester)
        req.balance -= cost
        req.queries += 1
        pub = self._acct(publisher)
        pub.balance += cost - fee
        pub.queries_served += 1
        self._acct(self.operator).balance += fee - region_cut
        if region_operator is not None:
            self._acct(region_operator).balance += region_cut

    def on_serve_refund(self, requester: str, publisher: str,
                        region_operator: Optional[str] = None,
                        mult: float = 1.0):
        """Reverse one paid query (dark region, fraud, or capacity refusal).

        Exact inverse of :meth:`on_serve`, same contract as
        :meth:`on_refund`: pass the same ``region_operator`` *and the same
        ``mult``* the payment used and the transfer nets to zero.
        """
        cost = self.serve_cost * mult
        fee, region_cut = self._fee_split(region_operator, cost)
        req = self._acct(requester)
        req.balance += cost
        req.refunds += 1
        self._acct(publisher).balance -= cost - fee
        self._acct(self.operator).balance -= fee - region_cut
        if region_operator is not None:
            self._acct(region_operator).balance -= region_cut

    def on_fraud(self, publisher: str) -> float:
        """Slash a publisher caught advertising an inflated card.

        Burns every publish reward the account ever minted (balance and
        ``minted`` drop together, so conservation holds exactly) and flags
        the account so future publishes mint nothing.  Returns the slashed
        amount.  Idempotent for already-flagged accounts with no new mints.
        """
        acct = self._acct(publisher)
        slashed = acct.mint_earned
        acct.balance -= slashed
        acct.mint_earned = 0.0
        self.minted -= slashed
        acct.frauds += 1
        self.flagged.add(publisher)
        return slashed

    def demote(self, party: str) -> None:
        """Gate a publisher's minting after its models went stale.

        Unlike :meth:`on_fraud` nothing is burned or flagged — the party
        was honest when it published; the world drifted underneath it.
        Its balance stays, but further publishes mint nothing until
        :meth:`promote` re-enables it (a fresh model that re-measures well
        earns its minting back).  No balance moves, so conservation is
        untouched.
        """
        self._acct(party)
        self.demoted.add(party)

    def promote(self, party: str) -> None:
        """Lift a staleness demotion (the party re-published fresh models)."""
        self.demoted.discard(party)

    def on_retire(self, party: str, beneficiary: str) -> float:
        """Escrow a retiring account's entire balance to ``beneficiary``.

        Elastic membership: when a party retires from the exchange (or a
        region is drained and its operator account wound down), its
        credits do not vanish — they transfer to the named beneficiary
        account (the party's region operator, or the cloud operator in a
        flat topology).  A pure zero-sum transfer, so conservation holds
        across every membership event.  Returns the escrowed amount.
        Retiring an account that never transacted escrows nothing (the
        account is *not* opened — that would mint a stipend just to move
        it).
        """
        acct = self.accounts.get(party)
        if acct is None:
            return 0.0
        amount = acct.balance
        acct.balance = 0.0
        self._acct(beneficiary).balance += amount
        return amount

    def balance(self, party: str) -> float:
        """Current balance (opens the account — and mints the stipend for
        non-operators — on first touch)."""
        return self._acct(party).balance

    # -- conservation + reporting -------------------------------------------
    def total_credits(self) -> float:
        """Sum of every account balance, operators included."""
        return sum(a.balance for a in self.accounts.values())

    def assert_conserved(self, tol: float = 1e-6):
        """Invariant: every credit in circulation was minted, none vanished."""
        total = self.total_credits()
        if abs(total - self.minted) > tol:
            raise AssertionError(
                f"credit conservation violated: sum(balances)={total!r} != "
                f"minted={self.minted!r}"
            )

    def distribution(self) -> Dict[str, float]:
        """Summary of party balances (operators excluded) for reports."""
        bals = sorted(a.balance for p, a in self.accounts.items()
                      if p not in self.operators)
        region_total = sum(self.accounts[p].balance for p in self.operators
                           if p != self.operator)
        if not bals:
            return {"parties": 0, "operator": self.balance(self.operator)}
        n = len(bals)
        out = {
            "parties": n,
            "min": bals[0],
            "median": bals[n // 2],
            "max": bals[-1],
            "mean": sum(bals) / n,
            "operator": self.balance(self.operator),
            "minted": self.minted,
            "denied": sum(a.denied for a in self.accounts.values()),
            "refunds": sum(a.refunds for a in self.accounts.values()),
            "frauds": sum(a.frauds for a in self.accounts.values()),
            "flagged": len(self.flagged),
            "demoted": len(self.demoted),
        }
        served = sum(a.queries_served for a in self.accounts.values())
        if served:
            out["queries_served"] = served
        if len(self.operators) > 1:
            out["region_operators"] = len(self.operators) - 1
            out["region_fee_total"] = region_total
        return out
