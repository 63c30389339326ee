"""SampleBatch: columnar container for trajectory data, a copy of
`ray_tpu/rllib/sample_batch.py` (numpy only; the port imports nothing
of `ray_tpu`).

A dict of equally-sized arrays with the standard column names, plus
concat/shuffle/minibatch helpers. Arrays are host numpy; the learner
moves what it trains on to the device.
"""

from __future__ import annotations

from typing import Dict, Iterator, List

import numpy as np

OBS = "obs"
NEXT_OBS = "new_obs"
ACTIONS = "actions"
REWARDS = "rewards"
DONES = "dones"
ACTION_LOGP = "action_logp"
VF_PREDS = "vf_preds"
ADVANTAGES = "advantages"
VALUE_TARGETS = "value_targets"
EPS_ID = "eps_id"


class SampleBatch(dict):
    """dict[str, np.ndarray] with batch semantics."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        for k, v in list(self.items()):
            if not isinstance(v, np.ndarray):
                self[k] = np.asarray(v)

    @property
    def count(self) -> int:
        for v in self.values():
            return len(v)
        return 0

    def __len__(self) -> int:        # len(batch) == rows, like the reference
        return self.count

    def slice(self, start: int, end: int) -> "SampleBatch":
        return SampleBatch({k: v[start:end] for k, v in self.items()})

    def shuffle(self, rng: np.random.Generator | None = None) -> "SampleBatch":
        rng = rng or np.random.default_rng()
        perm = rng.permutation(self.count)
        return SampleBatch({k: v[perm] for k, v in self.items()})

    def minibatches(self, size: int,
                    rng: np.random.Generator | None = None
                    ) -> Iterator["SampleBatch"]:
        batch = self.shuffle(rng) if rng is not None else self
        for i in range(0, batch.count - size + 1, size):
            yield batch.slice(i, i + size)

    def split_by_episode(self) -> List["SampleBatch"]:
        """Split on EPS_ID boundaries; without EPS_ID, fall back to DONES
        (each done row ends an episode); with neither, the whole batch is
        one episode."""
        if EPS_ID in self:
            ids = self[EPS_ID]
            boundaries = [0] + list(np.where(ids[1:] != ids[:-1])[0] + 1) \
                + [len(ids)]
        elif DONES in self:
            dones = np.asarray(self[DONES]).astype(bool)
            boundaries = [0] + list(np.flatnonzero(dones[:-1]) + 1) \
                + [len(dones)]
        else:
            return [self]
        return [self.slice(a, b)
                for a, b in zip(boundaries[:-1], boundaries[1:])]

    def __repr__(self):
        cols = {k: tuple(v.shape) for k, v in self.items()}
        return f"SampleBatch({self.count}: {cols})"


def concat_samples(batches: List[SampleBatch]) -> SampleBatch:
    """Reference: `SampleBatch.concat_samples` (sample_batch.py)."""
    if not batches:
        return SampleBatch()
    keys = batches[0].keys()
    return SampleBatch({
        k: np.concatenate([b[k] for b in batches], axis=0) for k in keys})


def compute_gae(rewards: np.ndarray, values: np.ndarray, dones: np.ndarray,
                last_value: float | np.ndarray, gamma: float,
                lam: float) -> Dict[str, np.ndarray]:
    """Generalized advantage estimation over a (possibly multi-episode)
    rollout (reference: `rllib/evaluation/postprocessing.py`
    compute_gae_for_sample_batch). Host-numpy reverse scan.
    """
    T = len(rewards)
    adv = np.zeros(T, np.float32)
    lastgaelam = 0.0
    for t in reversed(range(T)):
        nonterminal = 1.0 - float(dones[t])
        next_v = last_value if t == T - 1 else values[t + 1]
        delta = rewards[t] + gamma * next_v * nonterminal - values[t]
        lastgaelam = delta + gamma * lam * nonterminal * lastgaelam
        adv[t] = lastgaelam
    return {ADVANTAGES: adv,
            VALUE_TARGETS: (adv + values).astype(np.float32)}
