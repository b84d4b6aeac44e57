"""Serving launcher of the port: the batched server at an arch's reduced
config, on the CUDA device unless ``--device`` names another, or the
production-mesh decode step.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --local \
        [--device cpu]

    # the sharded decode step on the production mesh, one rank per GPU:
    torchrun ... -m repro_torch.launch.serve --arch yi-6b \
        --shape decode_32k [--multi-pod]

Without ``--local`` the step of ``--shape`` is built as the dry run
builds it, over the caller's process group of 256 (or 512) ranks, and
its dry-run record is printed (``launch.dryrun.production``); with no
group of the mesh's size it exits with the mesh's own error.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="decode_32k")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--local", action="store_true",
                    help="the batched server at the arch's reduced config")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the server, or the production "
                         "mesh's device type (default: cuda)")
    args = ap.parse_args(argv)
    if not args.local:
        from repro_torch.launch.dryrun import production
        return production(args.arch, args.shape, args.multi_pod, args.device)

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
