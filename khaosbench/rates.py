"""Peak rates of the card the benchmark runs on, from NVIDIA's data sheet
(dense, without sparsity), at the full power limit.  Another card raises
rather than guess: it comes with its row and a run on it."""
from __future__ import annotations

from typing import NamedTuple


class Rates(NamedTuple):
    hbm: float          # bytes/s
    fp32: float         # FLOP/s on the CUDA cores
    bf16: float         # FLOP/s on the tensor cores


CARDS = {"NVIDIA H100 80GB HBM3": Rates(3.35e12, 67e12, 989e12)}   # SXM5


def card_rates(name: str) -> Rates:
    """The rates of the card that ``torch.cuda.get_device_name`` names."""
    if name not in CARDS:
        raise ValueError(f"no published rates for card {name!r}")
    return CARDS[name]
