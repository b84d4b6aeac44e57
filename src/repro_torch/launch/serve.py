"""Serving launcher of the port: the batched server at an arch's reduced
config, on the CUDA device unless ``--device`` names another.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --local \
        [--device cpu]

Only the ``--local`` path of the JAX package's ``launch/serve.py`` is
ported: without it the reference compiles the sharded decode step for a
production mesh.  The sharding rules and meshes are ported
(``sharding.py``, ``launch/mesh.py``); that path waits for the port's
roofline and dry run (ROADMAP section 1, item 3).
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--local", action="store_true",
                    help="the batched server at the arch's reduced config")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the server (default: cuda)")
    args = ap.parse_args(argv)
    if not args.local:
        ap.error("only --local runs are ported: the production-mesh decode "
                 "step waits for the port's roofline and dry run "
                 "(roofline.py and launch/dryrun.py, ROADMAP section 1, "
                 "item 3)")

    import numpy as np
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import zoo
    from repro_torch.runtime.server import ServeRequest, StreamServer
    from repro_torch.utils.trees import resolve_device

    cfg = get_smoke_config(args.arch)
    dev = resolve_device(args.device)
    params = zoo.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             dev)
    srv = StreamServer(cfg, params)
    rng = np.random.default_rng(0)
    reqs = [ServeRequest(i, rng.integers(0, cfg.vocab_size, 16,
                                         dtype=np.int32), 8)
            for i in range(4)]
    out = {k: v.tolist() for k, v in srv.serve_batch(reqs).items()}
    print(out)
    return out


if __name__ == "__main__":
    main()
