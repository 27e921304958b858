"""Vectorized party populations: a cohort's math as batched tensor ops.

At 10k-party scale, driving each party's SGD loop on its own is pure
launch overhead — the models are tiny.  A :class:`PartyPopulation` stacks
homogeneous parties' params into one dict of tensors with a leading party
axis that stays on the device across a cycle, and drives every party's
minibatch step at once (:class:`~repro_torch.federated.client.LocalTrainer`).

Distillation is batched the same way: ``distill_batch`` drives a *subset*
of parties, each with its own fetched teacher, through whole KD epochs
whose loss goes through :func:`~repro_torch.core.losses.fused_distillation_loss`
— ONE ``kd_loss`` kernel launch per minibatch step over the flattened
(k·B, C) rows of every student.  Subsets are padded to power-of-two
buckets, as in the reference, so the launch shapes stay bounded; padded
rows are masked out of the loss and never written back.  Teachers may
come from a different architecture (paper §IV: only the logit space must
match) — pass the teacher cohort's ``apply`` fn.

The numpy RNG is consumed in the reference's order (the one-time
``permuted`` pre-shuffle, then one ``permutation`` per epoch), so block
schedules match ``repro.runtime.population`` for the same seed.  Initial
params come from a ``torch.Generator`` and cannot match ``jax.random``;
:meth:`restore_state` installs an ``export_state()`` snapshot from either
package (see :mod:`repro_torch.convert`).

Discovery, publishing, and transfer accounting stay per-party (they are
cheap, event-scheduled Python); only the math is batched.
"""
from __future__ import annotations

from typing import Any, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.convert import params_from_reference
from repro_torch.core.losses import fused_distillation_loss
from repro_torch.core.vault import ModelCard
from repro_torch.device import resolve_device
from repro_torch.federated.client import LocalTrainer
from repro_torch.optim import apply_updates


def _to_host(tree):
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_host(v) for v in tree)
    return tree.detach().cpu().numpy()


def stack_teachers(teacher_params: Sequence, device=None) -> dict:
    """Stack per-party teacher param dicts into one party-axis dict on
    ``device``: stacked on the host, then one transfer per leaf."""
    device = resolve_device(device)
    return {k: torch.as_tensor(np.stack([np.asarray(p[k])
                                         for p in teacher_params])).to(device)
            for k in teacher_params[0]}


class CohortState(NamedTuple):
    """One cohort's device-resident state.

    ``params`` and ``opt_state`` carry a leading party axis; ``cursor``
    counts minibatch steps taken since construction.
    """

    params: Any
    opt_state: Any
    cursor: int


def _bucket(k: int, multiple: int, cap: int) -> int:
    """Smallest power-of-two >= k that is a multiple of ``multiple``,
    bounded by ``cap`` rounded up to a multiple (the reference's rule)."""
    b = 1
    while b < k:
        b *= 2
    while b % multiple:
        b *= 2
    cap_m = -(-cap // multiple) * multiple
    return min(b, max(cap_m, multiple)) if cap_m >= k else b


class PartyPopulation:
    """N homogeneous parties whose state lives in one stacked dict of tensors.

    ``device`` defaults to the GPU; with no CUDA device that raises.  Pass
    ``device="cpu"`` to run on the host (the kernels' plain versions).
    """

    def __init__(
        self,
        model,  # SmallModel-style: init(k, generator, device), apply, num_classes
        x_train: np.ndarray,  # (N, n, ...) per-party training inputs
        y_train: np.ndarray,  # (N, n) per-party labels
        *,
        task: str,
        lr: float = 0.05,
        batch_size: int = 32,
        seed: int = 0,
        party_ids: Optional[List[str]] = None,
        device=None,
    ):
        assert x_train.shape[0] == y_train.shape[0]
        self.device = resolve_device(device)
        self.model = model
        self.task = task
        self.num_parties = int(x_train.shape[0])
        self.batch_size = min(batch_size, y_train.shape[1])
        self.party_ids = party_ids or [
            f"party{i}" for i in range(self.num_parties)
        ]
        self._rng = np.random.default_rng(seed)
        # pre-shuffle each party's samples ONCE (seeded): epochs then walk a
        # permuted schedule of contiguous blocks
        shuf = self._rng.permuted(
            np.broadcast_to(np.arange(y_train.shape[1]),
                            y_train.shape[:2]), axis=1,
        )
        self.x = np.take_along_axis(
            np.asarray(x_train),
            shuf.reshape(shuf.shape + (1,) * (x_train.ndim - 2)), axis=1,
        )
        self.y = np.take_along_axis(np.asarray(y_train), shuf, axis=1)

        generator = torch.Generator().manual_seed(seed)
        params = model.init(self.num_parties, generator, self.device)
        self._params_per_party = sum(int(np.prod(p.shape[1:]))
                                     for p in params.values())
        trainer = LocalTrainer(model.apply, lr=lr)
        self._opt = trainer.opt
        self._step = trainer.step
        self.state = CohortState(
            params=params,
            opt_state=self._opt.init(params, (self.num_parties,)),
            cursor=0,
        )
        # device-resident training data; the kernel takes int32 labels, so
        # labels are converted explicitly whatever integer type came in
        self._jx = torch.as_tensor(self.x).to(self.device)
        self._jy = torch.as_tensor(self.y.astype(np.int32)).to(self.device)

    @property
    def params(self):
        """The stacked per-party params (leading axis = party axis)."""
        return self.state.params

    # -- the batched distillation step ---------------------------------------
    def _distill_step(self, params, opt_state, bx, by, t_params, t_apply,
                      alpha, temperature):
        """One KD update for every party of the stack (one kernel launch)."""
        with torch.no_grad():
            teacher_logits = t_apply(t_params, bx)
        with torch.enable_grad():
            leaves = {k: v.detach().requires_grad_(True)
                      for k, v in params.items()}
            per_party = fused_distillation_loss(
                self.model.apply(leaves, bx), teacher_logits, by, alpha,
                temperature)
            grads = torch.autograd.grad(per_party.sum(), list(leaves.values()))
        updates, opt_state = self._opt.update(dict(zip(leaves, grads)),
                                              opt_state, params)
        return apply_updates(params, updates), opt_state, per_party.detach()

    def _distill_epochs(self, params, t_params, t_apply, x, y, blocks, alpha,
                        temperature):
        opt_state = self._opt.init(params, (x.shape[0],))
        loss = torch.zeros(x.shape[0], device=self.device)
        B = self.batch_size
        for blk in blocks:
            s = int(blk) * B
            params, opt_state, loss = self._distill_step(
                params, opt_state, x[:, s:s + B], y[:, s:s + B], t_params,
                t_apply, alpha, temperature)
        return params, loss

    # -- batching ------------------------------------------------------------
    @property
    def _n_blocks(self) -> int:
        return self.y.shape[1] // self.batch_size

    def _epoch_blocks(self, epochs: int) -> np.ndarray:
        """Block schedule for ``epochs`` epochs: (steps,) int32 block ids,
        one ``permutation`` draw per epoch from the population RNG."""
        blocks = [self._rng.permutation(self._n_blocks)
                  for _ in range(epochs)]
        if not blocks:
            return np.zeros((0,), np.int32)
        return np.concatenate(blocks).astype(np.int32)

    # -- bulk operations -----------------------------------------------------
    def train_epochs(self, epochs: int = 1) -> float:
        """Run local SGD for every party; returns the mean final-step loss."""
        blocks = self._epoch_blocks(epochs)
        params = self.state.params
        opt_state = self._opt.init(params, (self.num_parties,))
        loss = torch.zeros(self.num_parties, device=self.device)
        B = self.batch_size
        for blk in blocks:
            s = int(blk) * B
            params, opt_state, loss = self._step(
                params, opt_state, self._jx[:, s:s + B], self._jy[:, s:s + B])
        self.state = CohortState(params=params, opt_state=opt_state,
                                 cursor=self.state.cursor + len(blocks))
        return float(loss.mean())

    def distill_from(self, teacher_params, *, teacher_apply=None,
                     epochs: int = 1, alpha: float = 0.5,
                     temperature: float = 2.0) -> float:
        """Distill one shared teacher (one party's params) into every party."""
        t_apply = teacher_apply if teacher_apply is not None \
            else self.model.apply
        blocks = self._epoch_blocks(epochs)
        # a party axis of 1 broadcasts the teacher over the cohort
        t_params = {k: v.unsqueeze(0) for k, v in
                    params_from_reference(teacher_params, self.device).items()}
        params, loss = self._distill_epochs(
            self.state.params, t_params, t_apply, self._jx, self._jy, blocks,
            alpha, temperature)
        self.state = CohortState(params=params,
                                 opt_state=self.state.opt_state,
                                 cursor=self.state.cursor + len(blocks))
        return float(loss.mean())

    def distill_batch(self, indices, teacher_params, *, teacher_apply=None,
                      epochs: int = 1, alpha: float = 0.5,
                      temperature: float = 2.0, bucket: bool = True) -> float:
        """KD epochs for a *subset* of parties, each with its own teacher.

        ``indices`` selects the students; ``teacher_params`` is a dict
        stacked along a matching leading axis (see :func:`stack_teachers`).
        With ``bucket`` the subset is padded to a power-of-two bucket (pad
        students repeat the last party, pad teachers the first teacher);
        padded rows are masked out of the loss and dropped on write-back.
        Returns the mean final-step loss over the real students.
        """
        idx = np.asarray(indices, dtype=np.int64)
        if idx.size == 0:
            return 0.0
        t_apply = teacher_apply if teacher_apply is not None \
            else self.model.apply
        k = idx.size
        blocks = self._epoch_blocks(epochs)
        pad = _bucket(k, 1, self.num_parties) - k if bucket else 0
        t_params = params_from_reference(teacher_params, self.device)
        gather = torch.as_tensor(idx).to(self.device)
        if pad:
            gather = torch.cat([gather, torch.full(
                (pad,), self.num_parties - 1, dtype=torch.int64,
                device=self.device)])
            t_params = {n: torch.cat([a, a[:1].expand(pad, *a.shape[1:])])
                        for n, a in t_params.items()}
        full = self.state.params
        sub = {n: a[gather] for n, a in full.items()}
        sub, loss = self._distill_epochs(
            sub, t_params, t_apply, self._jx[gather], self._jy[gather],
            blocks, alpha, temperature)
        real = gather[:k]
        params = {}
        for n, a in full.items():
            a = a.clone()
            a[real] = sub[n][:k]
            params[n] = a
        self.state = CohortState(params=params,
                                 opt_state=self.state.opt_state,
                                 cursor=self.state.cursor + len(blocks))
        return float(loss[:k].mean())

    def evaluate(self, x_eval, y_eval) -> np.ndarray:
        """Per-party accuracy on a shared eval set.

        Correct-prediction *counts* are computed on the device (argmax takes
        the first maximum, as the reference's); the division happens in
        float64 on the host, so accuracies are bit-identical to the
        reference's whenever the predictions are.
        """
        y = np.asarray(y_eval)
        x = torch.tensor(np.asarray(x_eval), device=self.device)
        with torch.no_grad():
            preds = self.model.apply(self.state.params, x).argmax(-1)
            hits = (preds == torch.as_tensor(y).to(self.device)[None]).sum(-1)
        return hits.cpu().numpy() / float(y.size)

    # -- per-party views (for publish/fetch paths) ---------------------------
    def party_params(self, i: int):
        """Party ``i``'s params sliced out of the stack (numpy)."""
        return {k: v[i].cpu().numpy() for k, v in self.state.params.items()}

    def all_party_params(self) -> list:
        """Every party's params as numpy dicts, from ONE transfer per leaf.

        The per-party dicts are zero-copy row views of the host copy, in
        the reference's (sorted) key order; contiguous float32 rows, so
        their serde bytes are the reference's for the same values.
        """
        host = {k: self.state.params[k].cpu().numpy()
                for k in sorted(self.state.params)}
        return [{k: a[i] for k, a in host.items()}
                for i in range(self.num_parties)]

    # -- snapshot/restore ----------------------------------------------------
    def export_state(self) -> dict:
        """The cohort's full mutable state as host-side numpy data, in the
        layout of the reference's ``export_state``."""
        return {
            "params": _to_host(self.state.params),
            "opt_state": _to_host(self.state.opt_state),
            "cursor": int(self.state.cursor),
            "rng_state": self._rng.bit_generator.state,
            "num_parties": self.num_parties,
            "party_ids": list(self.party_ids),
        }

    def restore_state(self, snap: dict) -> None:
        """Install a state captured by ``export_state`` (of this package or
        the reference): params and opt state go to this population's device
        and the RNG resumes from the captured bit-generator state."""
        if (snap["num_parties"] != self.num_parties
                or list(snap["party_ids"]) != list(self.party_ids)):
            raise ValueError(
                f"snapshot is for {snap['num_parties']} parties "
                f"{snap['party_ids'][:3]}..., this population has "
                f"{self.num_parties} parties {self.party_ids[:3]}..."
            )
        self.state = CohortState(
            params=params_from_reference(snap["params"], self.device),
            opt_state=params_from_reference(snap["opt_state"], self.device),
            cursor=int(snap["cursor"]),
        )
        self._rng.bit_generator.state = snap["rng_state"]

    def make_card(self, i: int, accuracy: float) -> ModelCard:
        """Build party ``i``'s model card around a measured accuracy."""
        return ModelCard(
            model_id=f"{self.party_ids[i]}/{self.model.name}",
            task=self.task,
            arch=self.model.name,
            owner=self.party_ids[i],
            num_params=self._params_per_party,
            metrics={"accuracy": float(accuracy), "per_class": {},
                     "n": int(self.y.shape[1]),
                     "logit_dim": int(self.model.num_classes)},
        )
