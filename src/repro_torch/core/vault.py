"""Secure model vaults (paper §IV, Fig. 2).

A vault is hosted on an edge server and stores trained models as
content-addressed, HMAC-signed blobs together with a ModelCard carrying
provenance and the quality metrics produced by the evaluation service.
Integrity is verified on every fetch; tampered blobs are rejected.
"""
from __future__ import annotations

import copy
import dataclasses
import hashlib
import hmac
import json
from typing import Callable, Dict, List, Optional

from repro_torch.checkpoint.serde import params_from_bytes, params_to_bytes
from repro_torch.runtime.clock import SimClock


@dataclasses.dataclass
class ModelCard:
    """Metadata + quality card for a stored model."""

    model_id: str
    task: str  # e.g. "femnist_classification"
    arch: str  # e.g. "cnn", "lr", "qwen2-1.5b"
    owner: str
    num_params: int
    metrics: Dict  # evaluator output: accuracy, per_class, loss, n
    version: int = 1
    created_at: float = 0.0
    content_hash: str = ""
    parent: Optional[str] = None  # lineage (e.g. distilled-from)

    def to_json(self) -> str:
        """Canonical (key-sorted) JSON; the byte string vault signatures cover.

        Built from ``__dict__`` directly: the card is a flat dataclass over
        JSON-native values, and ``dataclasses.asdict``'s recursive
        deep-copy was the single hottest call in the 100k-party hierarchy
        benchmark.
        """
        return json.dumps(self.__dict__, sort_keys=True)

    @staticmethod
    def from_json(s: str) -> "ModelCard":
        """Inverse of :meth:`to_json`."""
        return ModelCard(**json.loads(s))


class IntegrityError(Exception):
    """A fetched blob or card failed its hash/signature verification."""


@dataclasses.dataclass
class VaultEntry:
    """One stored model: card + signed blob (+ a fetch-path decode cache).

    ``parsed`` caches the deserialized params after the first verified
    fetch — blobs are content-addressed and immutable per version, so
    re-parsing the archive on every download of a popular model is pure
    overhead.  Integrity (content hash + signature over the *current*
    card serialization) is still checked on every fetch; only the blob
    decode is memoized.
    """

    card: ModelCard
    blob: bytes
    signature: bytes
    parsed: object = None


class ModelVault:
    """One secure model store (paper: hosted by an edge server)."""

    def __init__(
        self,
        vault_id: str,
        secret_key: bytes = b"vault-secret",
        clock: Optional[Callable[[], float]] = None,
    ):
        self.vault_id = vault_id
        self._key = secret_key
        self._entries: Dict[str, VaultEntry] = {}
        # `created_at` comes from the injected simulated clock, never the wall
        # clock, so vault state is a pure function of the event schedule.
        self._clock = clock if clock is not None else SimClock()

    # -- internals ---------------------------------------------------------
    def set_clock(self, clock: Callable[[], float]):
        """Rebind the ``created_at`` clock; only legal while empty.

        Stored cards already carry timestamps from the old clock, so a
        non-empty vault cannot switch timelines.
        """
        if self._entries:
            raise ValueError("cannot rebind the clock of a vault that "
                             "already stores models")
        self._clock = clock

    def _sign(self, blob: bytes, card_json: str) -> bytes:
        mac = hmac.new(self._key, blob, hashlib.sha256)
        mac.update(card_json.encode())
        return mac.digest()

    @staticmethod
    def content_hash(blob: bytes) -> str:
        """Content address of a serialized model blob."""
        return hashlib.sha256(blob).hexdigest()

    # -- API ----------------------------------------------------------------
    def store(self, params, card: ModelCard) -> ModelCard:
        """Serialize, hash, sign, and store a model. Returns the final card."""
        blob = params_to_bytes(params)
        prev = self._entries.get(card.model_id)
        card = dataclasses.replace(
            card,
            content_hash=self.content_hash(blob),
            created_at=float(self._clock()),
            version=(prev.card.version + 1) if prev else 1,
        )
        sig = self._sign(blob, card.to_json())
        self._entries[card.model_id] = VaultEntry(card, blob, sig)
        return card

    def store_copy(self, params, card: ModelCard) -> ModelCard:
        """Store a replica of a card from another vault, identity preserved.

        Unlike :meth:`store`, the card's ``version`` and ``created_at`` are
        kept (this vault is a cache, not the model's origin), so downstream
        consumers keyed on ``(model_id, version)`` — e.g. verify-on-fetch
        verdict memoization — see the same blob identity as the original.
        The replica is hashed and signed under *this* vault's key.
        """
        blob = params_to_bytes(params)
        card = dataclasses.replace(card, content_hash=self.content_hash(blob))
        sig = self._sign(blob, card.to_json())
        self._entries[card.model_id] = VaultEntry(card, blob, sig)
        return card

    def fetch(self, model_id: str):
        """Verify integrity and return (params, card).

        Hash and signature are checked on every fetch; the blob decode is
        memoized per entry (blobs are immutable per version), so repeated
        downloads of a popular model pay the crypto but not the archive
        parse.  Each caller receives its own deep copy of the decoded
        tree — a requester mutating its download cannot poison later
        fetches of the same blob.
        """
        entry = self._entries.get(model_id)
        if entry is None:
            raise KeyError(f"model {model_id!r} not in vault {self.vault_id}")
        if self.content_hash(entry.blob) != entry.card.content_hash:
            raise IntegrityError(f"content hash mismatch for {model_id}")
        expect = self._sign(entry.blob, entry.card.to_json())
        if not hmac.compare_digest(expect, entry.signature):
            raise IntegrityError(f"signature mismatch for {model_id}")
        if entry.parsed is None:
            entry.parsed = params_from_bytes(entry.blob)
        return copy.deepcopy(entry.parsed), entry.card

    def entries(self) -> List[VaultEntry]:
        """Every stored entry, model-id-sorted (snapshot export).

        Entries carry the exact blob and signature bytes, so a snapshot
        can persist and later reinstall them verbatim via
        :meth:`restore_entry` — content hashes (and therefore every
        ``nbytes`` the Link cost model will compute) survive unchanged.
        """
        return [self._entries[mid] for mid in sorted(self._entries)]

    def restore_entry(self, card: ModelCard, blob: bytes,
                      signature: bytes) -> None:
        """Reinstall a snapshotted entry verbatim.

        The blob's content hash and the HMAC signature (under *this*
        vault's key) are verified on restore, so a snapshot tampered with
        at rest is rejected at load time, not at first fetch.
        """
        if self.content_hash(blob) != card.content_hash:
            raise IntegrityError(
                f"restored blob hash mismatch for {card.model_id}"
            )
        expect = self._sign(blob, card.to_json())
        if not hmac.compare_digest(expect, signature):
            raise IntegrityError(
                f"restored signature mismatch for {card.model_id}"
            )
        self._entries[card.model_id] = VaultEntry(card, blob, signature)

    def evict(self, model_id: str) -> bool:
        """Drop a stored entry (replica decay in serving caches).

        Returns True if the model was present.  Pure local storage
        reclaim — any discovery index advertising this vault's copy must
        be deregistered separately by the caller.
        """
        return self._entries.pop(model_id, None) is not None

    def cards(self) -> List[ModelCard]:
        """Every stored model's card (latest version each)."""
        return [e.card for e in self._entries.values()]

    def blob_size(self, model_id: str) -> int:
        """Serialized size in bytes (what the Link cost model transfers)."""
        return len(self._entries[model_id].blob)

    def __contains__(self, model_id: str) -> bool:
        return model_id in self._entries

    def __len__(self) -> int:
        return len(self._entries)
