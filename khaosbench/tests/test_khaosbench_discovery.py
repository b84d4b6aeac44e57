"""A new cell, configuration, traffic mix, metric or model is found by its
name: adding its files and its entry is enough, with no edit of the
harness.  A configuration of an architecture the benchmark knows is its
JSON file; a new architecture is its JSON file and its model module
(``khaosbench/models/<model>.py``: the program's config, the parameter
tree, the train state, the plain reference, the counts and the observers
with their checks)."""
import json
import shutil
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src"), str(ROOT / "khaosbench")]

import run as runner  # noqa: E402
from khaosbench import flops, spec  # noqa: E402
from khaosbench.harness import CellRun  # noqa: E402
from repro_torch.models import zoo  # noqa: E402
from smoke_cells import smoke_traffic  # noqa: E402


def _copy_benchmark(tmp_path) -> tuple:
    here = tmp_path / "khaosbench"
    for sub in ("configs", "traffic", "metrics", "models"):
        shutil.copytree(ROOT / "khaosbench" / sub, here / sub)
    return here, json.loads((ROOT / "BENCHMARK.json").read_text())


def test_new_files_are_found_by_name(tmp_path):
    here, bench = _copy_benchmark(tmp_path)
    cfg = json.loads((ROOT / "khaosbench/configs/yi-6b.2l.json").read_text())
    cfg["num_hidden_layers"] = 1
    (here / "configs" / "yi-6b.1l.json").write_text(json.dumps(cfg))
    (here / "traffic" / "burst.json").write_text(json.dumps(
        {"source": "poisson", "rate_events_per_s": 3.0, "ci_s": 1.0,
         "plan": {}, "failures": [], "failure_kind": "task"}))
    (here / "metrics" / "steps_seen.py").write_text(
        "def read(rec):\n    return float(len(rec.step_walls))\n")
    bench["configs"].append({"name": "yi-6b.1l", "source": "https://x",
                             "file": "khaosbench/configs/yi-6b.1l.json",
                             "reduced": ["num_hidden_layers"], "why": "y"})
    bench["workloads"].append({"name": "yi6b1.burst", "config": "yi-6b.1l",
                               "traffic": "burst", "chips": 1, "why": "z"})
    bench["per_layer"].append({"name": "steps_seen", "unit": "steps",
                               "better": "higher", "source": "host_clock",
                               "layer": "runtime.trainer",
                               "moves": "setup_s",
                               "workloads": ["yi6b1.burst"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    loaded = spec.load_benchmark(tmp_path)
    cell = spec.cell(loaded, "yi6b1.burst")
    assert spec.config(loaded, cell["config"], tmp_path)[
        "num_hidden_layers"] == 1
    assert spec.traffic(cell["traffic"], here)["rate_events_per_s"] == 3.0
    names = [m["name"] for m in spec.metrics_for(loaded, "yi6b1.burst", True)]
    assert names == ["steps_seen"]

    class Rec:
        step_walls = [0.1, 0.2]
    assert spec.reader("steps_seen", here)(Rec()) == 2.0
    # a cell's untraced metrics are the end-to-end ones that name it or all
    e2e = [m["name"] for m in spec.metrics_for(loaded, "yi6b1.burst", False)]
    assert e2e == ["setup_s"]
    # a configuration of a known architecture names its module
    assert spec.model(cfg["model"], here).param_shapes(cfg)["layers"][
        "attn"]["wq"][0][0] == 1


# A model module the harness has never seen: a dense decoder with tied
# embeddings, biased q/k/v, LayerNorm and an ungated GELU MLP (the port's
# dense family with its other options), whose train state holds a leaf
# outside the optimizer, and whose observer checks the norms' outputs.
TIED_BIAS = '''
"""A dense decoder with tied embeddings, biased q/k/v projections,
LayerNorm and an ungated tanh-GELU MLP, run by the port's dense family.
Its train state holds ``loss_mean``, a running mean of the loss that the
program moves outside the optimizer."""
import dataclasses
import math

import torch

from repro_torch.configs import yi_6b
from repro_torch.models import layers

from khaosbench import flops
from khaosbench.reference import adamw
from khaosbench.reference.decoder import rope
from khaosbench.reference.precision import Precision


def port_config(cfg):
    run = cfg["run"]
    return dataclasses.replace(
        yi_6b.SMOKE, num_layers=cfg["num_hidden_layers"],
        d_model=cfg["hidden_size"], num_heads=cfg["num_attention_heads"],
        num_kv_heads=cfg["num_key_value_heads"],
        d_ff=cfg["intermediate_size"], vocab_size=cfg["vocab_size"],
        vocab_pad_multiple=cfg["vocab_pad_multiple"],
        rope_theta=cfg["rope_theta"], norm_eps=cfg["norm_eps"],
        tie_embeddings=True, qkv_bias=True, norm_type="layernorm",
        activation="gelu", dtype=run["dtype"],
        param_dtype=run["param_dtype"], remat_policy=run["remat_policy"])


def _sizes(cfg):
    return (cfg["hidden_size"], cfg["num_hidden_layers"],
            cfg["num_attention_heads"], cfg["num_key_value_heads"],
            cfg["intermediate_size"])


def param_shapes(cfg):
    d, L, H, K, f = _sizes(cfg)
    hd, m = d // H, cfg["vocab_pad_multiple"]
    V = -(-cfg["vocab_size"] // m) * m
    out = 0.02 / math.sqrt(2 * L)

    def norm(*lead):
        return {"scale": ((*lead, d), None), "bias": ((*lead, d), 0.02)}
    return {"emb": {"embed": ((V, d), 0.02)}, "final_norm": norm(),
            "layers": {
                "ln1": norm(L), "ln2": norm(L),
                "attn": {"wq": ((L, d, H, hd), 0.02),
                         "wk": ((L, d, K, hd), 0.02),
                         "wv": ((L, d, K, hd), 0.02),
                         "wo": ((L, H, hd, d), out),
                         "bq": ((L, H, hd), 0.02), "bk": ((L, K, hd), 0.02),
                         "bv": ((L, K, hd), 0.02)},
                "ffn": {"w_up": ((L, d, f), 0.02),
                        "w_down": ((L, f, d), out)}}}


def initial_state(trainer, params):
    def zero(dtype):
        return torch.zeros((), dtype=dtype, device=trainer.device)
    return {"params": params, "opt": trainer.optimizer.init(params),
            "step": zero(torch.int32), "loss_mean": zero(torch.float32)}


def _layer_norm(x, p, eps):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]


def loss_fn(params, cfg, tokens, labels, pr):
    d, L, H, K, f = _sizes(cfg)
    B, S = tokens.shape
    eps, theta = cfg["norm_eps"], cfg["rope_theta"]
    pos = torch.arange(S, device=tokens.device)[None].expand(B, S)
    mask = torch.ones(S, S, dtype=torch.bool, device=tokens.device).tril()
    embed = params["emb"]["embed"]
    x = embed[tokens.long()]
    for i in range(L):
        lp = {g: {n: w[i] for n, w in leaves.items()}
              for g, leaves in params["layers"].items()}
        a, h = lp["attn"], _layer_norm(x, lp["ln1"], eps)
        q = rope(pr.einsum("bsd,dnh->bsnh", h, a["wq"]) + a["bq"], pos, theta)
        k = rope(pr.einsum("bsd,dnh->bsnh", h, a["wk"]) + a["bk"], pos, theta)
        v = pr.einsum("bsd,dnh->bsnh", h, a["wv"]) + a["bv"]
        k = torch.repeat_interleave(k, H // K, dim=2)
        v = torch.repeat_interleave(v, H // K, dim=2)
        w = pr.einsum("bqnh,bsnh->bnqs", q, k) / math.sqrt(d // H)
        w = torch.softmax(w.masked_fill(~mask, float("-inf")), dim=-1)
        o = pr.einsum("bnqs,bsnh->bqnh", w, v)
        x = x + pr.einsum("bsnh,nhd->bsd", o, a["wo"])
        h = _layer_norm(x, lp["ln2"], eps)
        u = torch.nn.functional.gelu(
            pr.einsum("bsd,df->bsf", h, lp["ffn"]["w_up"]), approximate="tanh")
        x = x + pr.einsum("bsf,fd->bsd", u, lp["ffn"]["w_down"])
    x = _layer_norm(x, params["final_norm"], eps)
    logits = pr.einsum("bsd,vd->bsv", x, embed)[..., :cfg["vocab_size"]]
    return torch.nn.functional.cross_entropy(
        logits.reshape(B * S, -1), labels.reshape(-1).long())


def train_steps(params, cfg, opt, batches, precision=None):
    pr = precision or Precision()
    return adamw.train_steps(lambda p, t, l: loss_fn(p, cfg, t, l, pr),
                             params, opt, batches)


def train_step_flops(cfg, batch, seq_len):
    d, L, H, K, f = _sizes(cfg)
    hd = d // H
    per_token = L * (2 * d * H * hd + 2 * d * K * hd + 2 * d * f) \\
        + d * cfg["vocab_size"]
    attn = 3 * 2 * 2 * seq_len * seq_len / 2 * H * hd * batch * L
    return 6.0 * per_token * batch * seq_len + attn


def packed_state_elements(cfg):
    shapes = param_shapes(cfg)
    return flops.packed_elements({"params": shapes, "m": shapes, "v": shapes,
                                  "loss_mean": ((), None)})


class NormOutputs:
    """Counts the norms' calls and their non-finite outputs."""

    name = "norm_outputs"

    def __init__(self, device):
        self.calls = 0
        self.nonfinite = torch.zeros((), dtype=torch.int64, device=device)

    def install(self):
        self._real, layers.apply_norm = layers.apply_norm, self._apply

    def uninstall(self):
        layers.apply_norm = self._real

    def _apply(self, p, x, cfg):
        y = self._real(p, x, cfg)
        self.calls += 1
        self.nonfinite.add_((~torch.isfinite(y.detach())).sum())
        return y

    def summary(self):
        return {"calls": self.calls, "nonfinite": int(self.nonfinite)}

    def checks(self, summary):
        return {"norm_nonfinite": (summary["nonfinite"], 0)}


def observers(cfg, device):
    return [NormOutputs(device)]


def smoke(cfg):
    return {}
'''

TIED_BIAS_CONFIG = {
    "model": "tied_bias", "hidden_size": 64, "num_attention_heads": 4,
    "num_key_value_heads": 2, "intermediate_size": 96,
    "num_hidden_layers": 2, "vocab_size": 500, "vocab_pad_multiple": 256,
    "rope_theta": 10000.0, "norm_eps": 1e-5, "source": "https://x",
    "reduced": {},
    "run": {"batch": 2, "seq_len": 32, "dtype": "float32",
            "param_dtype": "float32", "remat_policy": "minimal"},
    "limits": {"grad_norm_gap": 1e-3, "change_norm_gap": 1e-2}}


def carried_loss_mean(monkeypatch):
    """The program of the new architecture: the port's step, moving the
    state's ``loss_mean`` outside the optimizer (as a router's selection
    bias would move)."""
    real = zoo.make_train_step

    def make(*a, **k):
        step = real(*a, **k)

        def train_step(state, batch):
            new, metrics = step(state, batch)
            new["loss_mean"] = 0.9 * state["loss_mean"] \
                + 0.1 * metrics["loss"].float()
            return new, metrics
        return train_step
    monkeypatch.setattr(zoo, "make_train_step", make)


def _new_model_cell(tmp_path, monkeypatch, fault=None):
    here, bench = _copy_benchmark(tmp_path)
    (here / "models" / "tied_bias.py").write_text(
        textwrap.dedent(TIED_BIAS))
    yi = json.loads((ROOT / "khaosbench/configs/yi-6b.2l.json").read_text())
    cfg = dict(TIED_BIAS_CONFIG, optimizer=yi["optimizer"])
    (here / "configs" / "tied-bias.smoke.json").write_text(json.dumps(cfg))
    bench["configs"].append({"name": "tied-bias.smoke", "source": "https://x",
                             "file": "khaosbench/configs/tied-bias.smoke.json",
                             "reduced": [], "why": "y"})
    bench["workloads"].append({"name": "tied.chaos", "config":
                               "tied-bias.smoke", "traffic": "chaos.ci1",
                               "chips": 1, "why": "z"})
    carried_loss_mean(monkeypatch)
    if fault is not None:
        fault(monkeypatch)
    cell = spec.cell(bench, "tied.chaos")
    run = CellRun(spec.config(bench, cell["config"], tmp_path),
                  smoke_traffic("chaos.ci1", rate_events_per_s=20.0,
                                ci_s=0.2),
                  2 ** 31 + 77, 4.0, device="cpu", here=here)
    run.setup()
    run.window()
    return run, bench, cell, here


def test_a_new_model_module_runs_a_cell_correctly(tmp_path, monkeypatch):
    assert not (ROOT / "khaosbench" / "models" / "tied_bias.py").exists()
    run, bench, cell, here = _new_model_cell(tmp_path, monkeypatch)
    assert float(run.tr.state["loss_mean"]) > 0       # moved by the program
    assert "embed" in run.tr.state["params"]["emb"]
    assert "unembed" not in run.tr.state["params"]["emb"]
    assert run.rec.restores and run.rec.triggers
    dev, checks = run.finish()
    out = runner.result(run, bench, cell, False, dev, checks, here)
    assert out["correct"], out["checks"]
    assert out["checks"]["norm_nonfinite"] == {"value": 0, "limit": 0}
    assert out["checks"]["restore_mismatch"]["value"] == 0
    assert run.rec.observed["norm_outputs"]["calls"] > 0
    assert set(out["metrics"]) == {"setup_s"}
    # the counts are the module's: its state's leaf outside the optimizer
    # is packed too
    packed = run.model.packed_state_elements(run.cfg)
    assert packed == 3 * flops.packed_elements(
        run.model.param_shapes(run.cfg)) + 1024
    assert run.rec.int8_encode_bytes == flops.int8_encode_bytes(packed)


def unchanged_state(monkeypatch):
    real = zoo.make_train_step

    def make(*a, **k):
        step = real(*a, **k)
        return lambda state, batch: (state, step(state, batch)[1])
    monkeypatch.setattr(zoo, "make_train_step", make)


def test_a_fault_in_the_new_models_program_makes_it_incorrect(
        tmp_path, monkeypatch):
    run, bench, cell, here = _new_model_cell(tmp_path, monkeypatch,
                                             unchanged_state)
    assert float(run.tr.state["loss_mean"]) == 0.0
    dev, checks = run.finish()
    out = runner.result(run, bench, cell, False, dev, checks, here)
    assert not out["correct"]
    assert out["checks"]["grad_norm_gap"]["value"] > 0.5


def test_the_harness_names_no_architecture():
    for name in ("harness", "flops", "weights", "checks", "control"):
        text = (ROOT / "khaosbench" / f"{name}.py").read_text()
        assert "is_moe" not in text and "family" not in text, name
