"""Configurations and mixes at the port's SMOKE sizes, for CPU tests of
the harness (the cells' own files hold the published widths; each model
module's ``smoke`` says what shrinks)."""
import copy
import json
from pathlib import Path

from khaosbench import spec

HERE = Path(__file__).resolve().parent.parent


def smoke_config(name: str, dtype: str = "float32") -> dict:
    cfg = json.loads((HERE / "configs" / f"{name}.json").read_text())
    cfg.update(spec.model(cfg["model"]).smoke(cfg))
    cfg["run"] = dict(cfg["run"], batch=2, seq_len=32, dtype=dtype)
    return cfg


def smoke_traffic(name: str, **kw) -> dict:
    t = json.loads((HERE / "traffic" / f"{name}.json").read_text())
    t = copy.deepcopy(t)
    t.update(kw)
    return t
