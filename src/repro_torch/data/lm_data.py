"""Federated language-model data: per-client Markov token sources.

Used by the deep/transformer instantiation of one-shot FL and by the
end-to-end training example. Each client owns a distinct low-entropy
Markov chain over the vocabulary (non-IID by construction), so local
models genuinely specialize and ensembling/distillation has signal.

A copy of ``repro.data.lm_data`` (numpy only): the same seeds give
byte-identical tokens.
"""
from __future__ import annotations

from typing import Iterator, List, Tuple

import numpy as np

from repro_torch.utils.seeds import derive_device_seed


def _client_transition(rng: np.random.Generator, vocab: int, branching: int = 8):
    """Sparse row-stochastic transition matrix as (indices, probs)."""
    idx = rng.integers(0, vocab, size=(vocab, branching))
    raw = rng.random((vocab, branching)) + 0.1
    probs = raw / raw.sum(axis=1, keepdims=True)
    return idx, probs


def make_federated_lm_data(
    n_clients: int,
    vocab: int,
    tokens_per_client: int,
    seed: int = 0,
    branching: int = 8,
) -> List[np.ndarray]:
    """Returns one token array per client."""
    out = []
    for c in range(n_clients):
        rng = np.random.default_rng(derive_device_seed(seed, c))
        idx, probs = _client_transition(rng, vocab, branching)
        toks = np.empty(tokens_per_client, np.int32)
        state = int(rng.integers(vocab))
        for i in range(tokens_per_client):
            toks[i] = state
            j = rng.choice(branching, p=probs[state])
            state = int(idx[state, j])
        out.append(toks)
    return out


def token_batches(
    tokens: np.ndarray, batch: int, seq_len: int, seed: int = 0
) -> Iterator[np.ndarray]:
    """Infinite iterator of (batch, seq_len+1) windows (input+target)."""
    rng = np.random.default_rng(seed)
    n = len(tokens) - seq_len - 1
    if n <= 0:
        reps = (seq_len + 2) // max(len(tokens), 1) + 1
        tokens = np.tile(tokens, reps)
        n = len(tokens) - seq_len - 1
    while True:
        starts = rng.integers(0, n, size=batch)
        yield np.stack([tokens[s : s + seq_len + 1] for s in starts]).astype(np.int32)
