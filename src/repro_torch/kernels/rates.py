"""Peak rates of the cards the kernels are built for, from NVIDIA's data
sheets: the least time a kernel could take is its bytes over ``hbm`` or
its operations over the peak of their type, whichever is larger."""
from __future__ import annotations

from typing import NamedTuple


class Rates(NamedTuple):
    """Peak rates of one card (dense, NVIDIA's data sheet)."""
    hbm: float          # bytes/s
    fp32: float         # FLOP/s on the CUDA cores
    bf16: float         # FLOP/s on the tensor cores


def card_rates(name: str) -> Rates:
    """The rates of the SKU ``name`` (``torch.cuda.get_device_name``)
    names; an unknown card raises rather than guess."""
    if "H200" in name:
        return Rates(4.8e12, 67e12, 989e12)
    if "H100" in name and "PCIe" in name:
        return Rates(2.0e12, 51e12, 756e12)
    if "H100" in name and "NVL" in name:
        return Rates(3.9e12, 60e12, 835e12)
    if "H100" in name:
        return Rates(3.35e12, 67e12, 989e12)
    raise ValueError(f"no published rates for card {name!r}")
