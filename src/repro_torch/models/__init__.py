from repro_torch.models import layers, zoo

__all__ = ["layers", "zoo"]
