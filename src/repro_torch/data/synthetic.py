"""Synthetic data pipeline (a verbatim copy of ``src/repro/data/
synthetic.py``: numpy only, so both packages draw identical streams from
the same seed).

GLUE is not redistributable offline, so the accuracy-shaped experiments run
on deterministic synthetic tasks with the same interface:

* ``lm_stream`` — learnable LM data: tokens follow a random order-1 Markov
  chain (fixed by seed), so next-token loss has signal and training curves
  are meaningful.
* ``classification_tasks`` — T GLUE-like sequence-classification tasks (the
  multi-task experiments of paper §3.2): each task has its own labeling rule
  over a shared token distribution; the label is supervised as the last
  token of the sequence, so the same LM loss machinery applies.

Iterators are **stateful and resumable**: ``state()`` returns a dict that
``restore()`` accepts — the checkpoint manager persists it so a restart
continues the exact data order (fault-tolerance requirement).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass
class LMStream:
    vocab_size: int
    seq_len: int
    batch: int
    seed: int = 0
    branching: int = 4      # out-degree of the Markov chain (lower=easier)

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        # sparse random transition table: each token can be followed by
        # ``branching`` tokens with random fixed probabilities
        nxt = rng.integers(0, self.vocab_size,
                           (self.vocab_size, self.branching))
        p = rng.dirichlet(np.ones(self.branching), self.vocab_size)
        self._next, self._p = nxt, p
        self._step = 0

    def state(self) -> dict:
        return {"step": self._step, "seed": self.seed}

    def restore(self, state: dict) -> None:
        assert state["seed"] == self.seed, "data stream seed mismatch"
        self._step = int(state["step"])

    def _sample(self, rng):
        toks = np.empty((self.batch, self.seq_len), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab_size, self.batch)
        for t in range(1, self.seq_len):
            choice = (rng.random((self.batch, 1))
                      > np.cumsum(self._p[toks[:, t - 1]], -1)).sum(-1)
            choice = np.minimum(choice, self.branching - 1)
            toks[:, t] = self._next[toks[:, t - 1], choice]
        return toks

    def __next__(self) -> dict:
        rng = np.random.default_rng((self.seed, self._step))
        self._step += 1
        toks = self._sample(rng)
        return {"tokens": toks,
                "mask": np.ones_like(toks, np.float32)}

    def __iter__(self) -> Iterator[dict]:
        return self


@dataclasses.dataclass
class ClassificationTasks:
    """T synthetic classification tasks for the MTL experiments (§3.2).

    Task t's rule: label = (token at position t) mod n_classes — each task
    attends to a different position, so the task core must route attention
    differently per task. The label is appended as the final token (from a
    reserved class-token range), so next-token loss on the last position is
    exactly the classification loss.
    """
    vocab_size: int
    seq_len: int
    batch: int
    num_tasks: int
    n_classes: int = 2
    seed: int = 0

    def __post_init__(self):
        assert self.vocab_size > self.n_classes
        self._step = 0

    def state(self) -> dict:
        return {"step": self._step, "seed": self.seed}

    def restore(self, state: dict) -> None:
        self._step = int(state["step"])

    @property
    def class_token_base(self) -> int:
        return self.vocab_size - self.n_classes

    def sample(self, task: int, split: str = "train") -> dict:
        salt = 0 if split == "train" else 10**6
        rng = np.random.default_rng((self.seed, task, self._step + salt))
        if split == "train":
            self._step += 1
        body = rng.integers(0, self.class_token_base,
                            (self.batch, self.seq_len - 1), dtype=np.int32)
        label = (body[:, task % self.seq_len] % self.n_classes).astype(
            np.int32)
        toks = np.concatenate(
            [body, (self.class_token_base + label)[:, None]], axis=1)
        mask = np.zeros_like(toks, np.float32)
        mask[:, -1] = 1.0            # supervise only the label position
        return {"tokens": toks, "mask": mask, "task": np.int32(task),
                "labels": label}

    @staticmethod
    def accuracy(logits_last: np.ndarray, labels: np.ndarray,
                 class_token_base: int, n_classes: int) -> float:
        """logits_last: (B, V) logits at the position predicting the label."""
        cls = logits_last[:, class_token_base:class_token_base + n_classes]
        return float((cls.argmax(-1) == labels).mean())
