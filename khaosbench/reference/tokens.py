"""The content of a stream event, as the job consumes it: event ``offset``
of the stream with seed ``seed`` is a sequence of ``length`` tokens whose
first token is drawn from ``numpy.random.default_rng(seed * 2654435761 +
offset)`` in [0, vocab) and whose later tokens follow
``t[i+1] = (31 * t[i] + 7) mod vocab`` (a learnable stream).  A frozen
copy of the job's event definition, for the reference's side."""
from __future__ import annotations

import numpy as np


def event_tokens(seed: int, offsets, length: int, vocab: int) -> np.ndarray:
    out = np.empty((len(offsets), length), dtype=np.int64)
    for i, off in enumerate(offsets):
        rng = np.random.default_rng(np.uint64(seed * 2654435761 + int(off)))
        out[i, 0] = rng.integers(0, vocab)
    for j in range(1, length):
        out[:, j] = (31 * out[:, j - 1] + 7) % vocab
    return out


def step_batch(seed: int, step: int, batch: int, seq_len: int,
               vocab: int) -> tuple[np.ndarray, np.ndarray]:
    """(tokens, labels) of the ``step``-th batch from the stream's start."""
    seq = event_tokens(seed, range(step * batch, (step + 1) * batch),
                       seq_len + 1, vocab)
    return seq[:, :-1], seq[:, 1:]
