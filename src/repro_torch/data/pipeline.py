"""Deterministic tokenized batch pipeline over the event stream.

An *event* is a fixed-length document of tokens generated deterministically
from its global offset (counter-based RNG), so any host can materialize any
event independently — this is what makes elastic rescaling and exactly-once
recovery trivial: the checkpointed cursor fully determines the remaining
stream.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.data.stream import EventStream


@dataclass
class PipelineCursor:
    offset: int = 0        # next global event index to emit

    def to_dict(self) -> dict:
        return {"offset": int(self.offset)}

    @staticmethod
    def from_dict(d: dict) -> "PipelineCursor":
        return PipelineCursor(offset=int(d["offset"]))


def _tokens_for_events(offsets: np.ndarray, seq_len: int, vocab: int,
                       seed: int) -> np.ndarray:
    """Counter-based deterministic token generation: event offset -> tokens.

    Philox-style: each event's tokens depend only on (seed, offset), never
    on consumption history.  Sequences follow an affine successor process
    t_{i+1} = (a * t_i + b) mod vocab with a random start per event, so the
    synthetic stream is LEARNABLE (a model can drive CE toward zero) while
    staying fully deterministic — needed both for exactly-once tests and
    for meaningful end-to-end training demos.
    """
    a, b = 31, 7
    out = np.empty((len(offsets), seq_len), dtype=np.int64)
    starts = np.empty(len(offsets), dtype=np.int64)
    for i, off in enumerate(offsets):
        rng = np.random.default_rng(np.uint64(seed * 2654435761 + int(off)))
        starts[i] = rng.integers(0, vocab)
    out[:, 0] = starts
    for j in range(1, seq_len):
        out[:, j] = (a * out[:, j - 1] + b) % vocab
    return out.astype(np.int32)


class StreamingBatcher:
    """Assemble (global_batch, seq_len) token batches from an EventStream.

    One event == one sequence.  ``next_batch`` returns None when the stream
    has not yet produced a full batch (the trainer then idles — underload),
    otherwise consumes ``global_batch`` events and returns tokens+labels.
    """

    def __init__(self, stream: EventStream, global_batch: int, seq_len: int,
                 vocab: int, seed: int = 0,
                 cursor: Optional[PipelineCursor] = None) -> None:
        self.stream = stream
        self.global_batch = global_batch
        self.seq_len = seq_len
        self.vocab = vocab
        self.seed = seed
        self.cursor = cursor or PipelineCursor()
        # keep stream consumption consistent with a restored cursor
        self.stream.consumed = max(self.stream.consumed, self.cursor.offset)

    def ready(self) -> bool:
        return self.stream.lag >= self.global_batch

    def next_batch(self) -> Optional[dict]:
        if not self.ready():
            return None
        taken = self.stream.consume(self.global_batch)
        assert taken == self.global_batch
        offs = np.arange(self.cursor.offset, self.cursor.offset + taken)
        tokens = _tokens_for_events(offs, self.seq_len + 1, self.vocab, self.seed)
        self.cursor.offset += taken
        return {
            "tokens": tokens[:, :-1],
            "labels": tokens[:, 1:],
            "first_offset": int(offs[0]),
        }

    # -- checkpoint integration ---------------------------------------------
    def state_dict(self) -> dict:
        return {"cursor": self.cursor.to_dict(), "stream": self.stream.cursor()}

    def restore(self, state: dict) -> None:
        self.cursor = PipelineCursor.from_dict(state["cursor"])
        self.stream.restore(state["stream"])
        self.stream.consumed = max(self.stream.consumed, self.cursor.offset)
