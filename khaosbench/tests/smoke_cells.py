"""Configurations and mixes at the port's SMOKE sizes, for CPU tests of
the harness (the cells' own files hold the published widths)."""
import copy
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def smoke_config(name: str, dtype: str = "float32") -> dict:
    cfg = json.loads((HERE / "configs" / f"{name}.json").read_text())
    if cfg["port"]["family"] == "moe":
        small = {"hidden_size": 64, "num_attention_heads": 4,
                 "num_key_value_heads": 4, "intermediate_size": 64,
                 "vocab_size": 512, "num_experts": 8,
                 "num_experts_per_tok": 2, "rope_theta": 10000.0}
    else:
        small = {"hidden_size": 64, "num_attention_heads": 4,
                 "num_key_value_heads": 1, "intermediate_size": 128,
                 "vocab_size": 512, "rope_theta": 10000.0}
    cfg.update(small)
    cfg["port"] = dict(cfg["port"], object="SMOKE")
    cfg["run"] = dict(cfg["run"], batch=2, seq_len=32, dtype=dtype)
    return cfg


def smoke_traffic(name: str, **kw) -> dict:
    t = json.loads((HERE / "traffic" / f"{name}.json").read_text())
    t = copy.deepcopy(t)
    t.update(kw)
    return t
