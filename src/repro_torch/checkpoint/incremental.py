"""Incremental (delta) checkpointing — the port of
``repro.checkpoint.incremental``; blobs and manifests are byte-compatible
with the JAX package in both directions.

Between full checkpoints only the compressed delta vs the last *full*
checkpoint is persisted.  Two encodings:

  * ``lossless``: delta = new - base (float32) plus the XOR residual
    bits(new) ^ bits(base + delta), so restore is BIT-exact.  Non-float
    leaves store the XOR of raw bytes.
  * ``int8``: per-1024-group int8 quantized delta (lossy; error at most
    max|delta_group| / 254 per element).

Two blob layouts coexist, selected by the source:

  * per-leaf (v2, and always the host path): one ``key@suffix.bin`` blob
    set per leaf, encoded/compressed/written concurrently on the io pool.
  * flat (v3, device placement): a ``pipeline.DeltaLeafSource`` hands over
    ONE already-encoded payload for its packed f32 subtree, frame-
    compressed into ``flat@d.bin``/``flat@r.bin`` (lossless) or
    ``flat@q.bin``/``flat@s.bin`` (int8) and described by the manifest's
    ``"flat"`` section.  ``apply_delta`` restores both layouts.

Decoding runs through ``kernels/ckpt_delta.ops`` on the device the
placement names: the CUDA kernels for ``placement="device"``, their plain
versions on the CPU for ``placement="host"`` — the same bits either way.
The flat decode goes in GROUP-aligned chunks of about 1 GiB, so its
device memory stays bounded whatever the state size (the decode is
elementwise, so chunking changes no bit).

Chain layout: full_0, delta_1..delta_{k-1}, full_k, ...; restore loads the
newest full plus its newest delta (deltas are vs the base full).
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.checkpoint.store import (compress_frames, decompress_frames,
                                          fresh_tmp_dir, get_compressor,
                                          get_decompressor,
                                          publish_dir_atomic,
                                          write_json_atomic)
from repro_torch.kernels.ckpt_delta import ops
from repro_torch.kernels.ckpt_delta import ref as codec_ref
from repro_torch.kernels.ckpt_delta.ref import GROUP
from repro_torch.utils.trees import (resolve_device, tree_flatten_with_names,
                                     tree_structure, tree_unflatten)

DECODE_CHUNK = 1 << 28          # elements per flat decode chunk (1 GiB f32)


def delta_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"delta_{step:010d}")


def _host(x: np.ndarray) -> torch.Tensor:
    """A CPU tensor over a (possibly read-only) numpy array; the codec
    only reads it."""
    arr = np.ascontiguousarray(x).reshape(-1)
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(arr)


def _encode_leaf_blobs(key: str, leaf: np.ndarray, b: np.ndarray,
                       mode: str, compress) -> dict[str, bytes]:
    """blob-key -> compressed payload for one leaf (runs on an io worker)."""
    blobs: dict[str, bytes] = {}
    if mode == "lossless":
        if leaf.dtype == np.float32:
            n = leaf.size
            d, r, _, _ = codec_ref.lossless_encode_groups(
                codec_ref.pad_to_groups(_host(leaf)),
                codec_ref.pad_to_groups(_host(b)))
            blobs[key] = compress(d[:n].numpy().tobytes())
            blobs[key + "::r"] = compress(r[:n].numpy().tobytes())
        elif np.issubdtype(leaf.dtype, np.floating):
            delta = leaf.astype(np.float32) - b.astype(np.float32)
            pred = (b.astype(np.float32) + delta).astype(leaf.dtype)
            resid = np.frombuffer(leaf.tobytes(), np.uint8) \
                ^ np.frombuffer(pred.tobytes(), np.uint8)
            blobs[key] = compress(delta.tobytes())
            blobs[key + "::r"] = compress(resid.tobytes())
        else:
            xored = np.frombuffer(leaf.tobytes(), np.uint8) \
                ^ np.frombuffer(b.tobytes(), np.uint8)
            blobs[key] = compress(xored.tobytes())
        return blobs
    # int8 group-quantized delta of the zero-padded leaf
    q, scales, _ = codec_ref.int8_encode_groups(
        codec_ref.pad_to_groups(_host(leaf.astype(np.float32))),
        codec_ref.pad_to_groups(_host(b.astype(np.float32))))
    blobs[key + "::q"] = compress(q.numpy().tobytes())
    blobs[key + "::s"] = compress(scales.numpy().tobytes())
    return blobs


def write_delta(directory: str, step: int, state_np: Any, base: Any,
                base_step: int, timestamp: float = 0.0,
                extra: Optional[dict] = None, mode: str = "lossless",
                codec: str = "auto", level: int = 3
                ) -> tuple[str, int, float]:
    """Encode + atomically publish one delta checkpoint.

    ``state_np`` and ``base`` may be pytrees or ``pipeline.LeafSource``s.
    A ``pipeline.DeltaLeafSource`` arrives FLAT-encoded: its payload is
    frame-compressed into ``flat@*.bin`` under the manifest's ``"flat"``
    section, its per-leaf change counts become ``"zero"`` markers, and
    only leaves outside the packed subtree take the per-leaf host path.
    A host-path leaf whose bytes equal the base's is likewise a ``"zero"``
    marker.  Returns (path, payload_bytes, encode_cpu_s).
    """
    from repro_torch.checkpoint.pipeline import as_leaf_source, io_pool

    codec_name, compress = get_compressor(codec, level)
    src = as_leaf_source(state_np)
    base_src = as_leaf_source(base)
    placement = getattr(src, "placement", "host")
    layout = getattr(src, "layout", None)
    if layout is not None and getattr(src, "codec", mode) != mode:
        raise ValueError(f"flat-encoded source codec {src.codec!r} does not "
                         f"match the requested delta mode {mode!r}")
    packed = frozenset(layout.names) if layout is not None else frozenset()
    path = delta_dir(directory, step)
    tmp = fresh_tmp_dir(path)

    def encode_leaf(name: str) -> tuple[str, int, float, bool]:
        key = name.replace("/", "::")
        t0 = time.thread_time()
        leaf = np.asarray(src.get(name))
        b = np.asarray(base_src.get(name))
        # skip-zero fast path: byte-level equality through u8 views
        if leaf.dtype == b.dtype and leaf.shape == b.shape and \
                np.array_equal(leaf.reshape(-1).view(np.uint8),
                               b.reshape(-1).view(np.uint8)):
            return key, 0, time.thread_time() - t0, True
        blobs = _encode_leaf_blobs(key, leaf, b, mode, compress)
        cpu_s = time.thread_time() - t0
        nbytes = 0
        for k, blob in blobs.items():
            with open(os.path.join(tmp, k.replace("::", "@") + ".bin"),
                      "wb") as f:
                f.write(blob)
            nbytes += len(blob)
        return key, nbytes, cpu_s, False

    futures = [io_pool().submit(encode_leaf, n) for n in src.names
               if n not in packed]

    flat_meta = None
    flat_bytes = 0
    flat_cpu = 0.0
    zero_flat: list[str] = []
    if layout is not None:
        payload = src.flat_payload()            # blocks until chunks land
        zero_flat = [n.replace("/", "::") for n in src.zero_names]
        flat_meta = {"size": layout.total, "group": GROUP,
                     "layout": [[name.replace("/", "::"), off, size, shape]
                                for name, off, size, shape
                                in layout.to_manifest()],
                     "arrays": {}}
        for sfx in (("d", "r") if mode == "lossless" else ("q", "s")):
            arr = payload.get(sfx)
            if arr is None:             # every packed leaf unchanged
                continue
            if isinstance(arr, str):    # "zero": residual D2H was skipped
                flat_meta["arrays"][sfx] = "zero"
                continue
            frames, lens, cpu = compress_frames(arr, compress, io_pool())
            fname = f"flat@{sfx}.bin"
            with open(os.path.join(tmp, fname), "wb") as f:
                for frame in frames:
                    f.write(frame)
            del frames
            flat_meta["arrays"][sfx] = {"file": fname,
                                        "dtype": str(arr.dtype),
                                        "frames": lens}
            flat_bytes += sum(lens)
            flat_cpu += cpu

    results = [f.result() for f in futures]
    nbytes = sum(n for _, n, _, _ in results) + flat_bytes
    encode_cpu_s = sum(c for _, _, c, _ in results) + flat_cpu
    meta = {"base_step": base_step, "step": step, "timestamp": timestamp,
            "mode": mode, "codec": codec_name, "scheme": "sub+xor",
            "placement": placement,
            "zero": [k for k, _, _, z in results if z] + zero_flat,
            "extra": extra or {}}
    if flat_meta is not None:
        meta["flat"] = flat_meta
    write_json_atomic(os.path.join(tmp, "delta_manifest.json"), meta)
    publish_dir_atomic(tmp, path)
    return path, nbytes, encode_cpu_s


def read_delta_manifest(directory: str, step: int) -> Optional[dict]:
    mpath = os.path.join(delta_dir(directory, step), "delta_manifest.json")
    if not os.path.exists(mpath):
        return None
    try:
        with open(mpath) as f:
            return json.load(f)
    except (json.JSONDecodeError, OSError):
        return None


def newest_delta_step(directory: str) -> Optional[int]:
    steps = []
    for name in os.listdir(directory):
        if name.startswith("delta_") and not name.endswith(".tmp"):
            step = int(name.split("_")[1])
            if read_delta_manifest(directory, step) is not None:
                steps.append(step)
    return max(steps) if steps else None


def _decode_leaf(ddir: str, name: str, leaf: np.ndarray, mode: str,
                 xor_ints: bool, zero: frozenset, decompress,
                 device: torch.device) -> np.ndarray:
    """Read + decompress + decode one leaf (runs on an io worker); the
    f32 decode runs through the codec ops on ``device``."""
    key = name.replace("/", "@")
    if name.replace("/", "::") in zero:     # unchanged leaf: base as-is
        return leaf
    if mode == "lossless":
        with open(os.path.join(ddir, key + ".bin"), "rb") as f:
            raw = decompress(f.read())
        if leaf.dtype == np.float32:
            delta = np.frombuffer(raw, np.float32)
            rpath = os.path.join(ddir, key + "@r.bin")
            if os.path.exists(rpath):        # bit-exactness correction
                with open(rpath, "rb") as f:
                    resid = np.frombuffer(decompress(f.read()), np.int32)
                out = ops.lossless_decode(_host(leaf).to(device),
                                          _host(delta).to(device),
                                          _host(resid).to(device))
                return out.cpu().numpy().reshape(leaf.shape)
            return (leaf.reshape(-1) + delta).reshape(leaf.shape)
        if np.issubdtype(leaf.dtype, np.floating):
            delta = np.frombuffer(raw, np.float32).reshape(leaf.shape)
            pred = (leaf.astype(np.float32) + delta).astype(leaf.dtype)
            rpath = os.path.join(ddir, key + "@r.bin")
            if os.path.exists(rpath):        # bit-exactness correction
                with open(rpath, "rb") as f:
                    resid = np.frombuffer(decompress(f.read()), np.uint8)
                exact = np.frombuffer(pred.tobytes(), np.uint8) ^ resid
                pred = np.frombuffer(exact.tobytes(),
                                     leaf.dtype).reshape(leaf.shape)
            return pred
        if xor_ints:
            xored = np.frombuffer(raw, np.uint8)
            base_b = np.frombuffer(leaf.tobytes(), np.uint8)
            return np.frombuffer((xored ^ base_b).tobytes(),
                                 leaf.dtype).reshape(leaf.shape)
        # legacy scheme stored the raw leaf bytes
        return np.frombuffer(raw, leaf.dtype).reshape(leaf.shape)
    with open(os.path.join(ddir, key + "@q.bin"), "rb") as f:
        q = np.frombuffer(decompress(f.read()), np.int8)
    with open(os.path.join(ddir, key + "@s.bin"), "rb") as f:
        s = np.frombuffer(decompress(f.read()), np.float32)
    delta = ops.delta_decode(_host(q).to(device), _host(s).to(device))
    delta = delta[:leaf.size].cpu().numpy().reshape(leaf.shape)
    return (leaf.astype(np.float32) + delta).astype(leaf.dtype)


def _base_chunk(entries: list, base_leaves: dict, a: int,
                b: int) -> np.ndarray:
    """Elements [a, b) of the packed base, rebuilt from the restored base
    leaves with ``FlatLayout``'s zero padding."""
    out = np.zeros(b - a, np.float32)
    for name, off, size, _ in entries:
        lo, hi = max(off, a), min(off + size, b)
        if lo < hi:
            leaf = np.asarray(base_leaves[name], np.float32).reshape(-1)
            out[lo - a:hi - a] = leaf[lo - off:hi - off]
    return out


def _decode_flat(ddir: str, flat: dict, mode: str, zero: frozenset,
                 base_leaves: dict, decompress,
                 device: torch.device) -> dict:
    """Decode the flat payload back into per-leaf arrays.

    The packed base is rebuilt chunk by chunk from the restored base
    leaves, each GROUP-aligned chunk of base/payload goes to ``device``,
    is decoded there (sub+XOR-residual, or int8 dequant plus the base
    added apart, as the reference adds it) and comes back into one host
    output buffer; each leaf is then sliced out by its manifest extent.
    Leaves in ``zero`` take the base as-is."""
    from repro_torch.checkpoint.pipeline import io_pool

    entries = [(key.replace("::", "/"), int(off), int(size), tuple(shape))
               for key, off, size, shape in flat["layout"]]
    arrays: dict[str, np.ndarray] = {}
    for sfx, spec in flat.get("arrays", {}).items():
        if spec == "zero":
            continue
        arrays[sfx] = decompress_frames(
            os.path.join(ddir, spec["file"]), spec["frames"],
            np.dtype(spec["dtype"]), decompress, io_pool())
    if not arrays:                  # every packed leaf was unchanged
        return {name: base_leaves[name] for name, _, _, _ in entries}
    total = int(flat["size"])
    out_flat = np.empty(total, np.float32)
    for a in range(0, total, DECODE_CHUNK):
        b = min(total, a + DECODE_CHUNK)
        base_c = torch.from_numpy(_base_chunk(entries, base_leaves, a, b)
                                  ).to(device)
        if mode == "lossless":
            d_c = _host(arrays["d"][a:b]).to(device)
            r = arrays.get("r")
            r_c = (torch.zeros(b - a, dtype=torch.int32, device=device)
                   if r is None             # skipped all-zero residual
                   else _host(r[a:b].view(np.int32)).to(device))
            out_c = ops.lossless_decode(base_c, d_c, r_c)
        else:
            q_c = _host(arrays["q"][a:b]).to(device)
            s_c = _host(arrays["s"][a // GROUP:b // GROUP]).to(device)
            out_c = base_c + ops.delta_decode(q_c, s_c)
        torch.from_numpy(out_flat[a:b]).copy_(out_c)
        del base_c, out_c
    out: dict[str, np.ndarray] = {}
    for name, off, size, shape in entries:
        if name.replace("/", "::") in zero:
            out[name] = base_leaves[name]       # unchanged: base as-is
        else:
            out[name] = out_flat[off:off + size].reshape(shape)
    return out


def apply_delta(directory: str, step: int, base_state: Any,
                placement: str = "host", device: Any = None) -> Any:
    """Apply the delta at ``step`` on top of ``base_state`` (the restored
    base full snapshot, numpy leaves).  Codec and mode come from the
    delta manifest; v3 flat, v2 per-leaf and mixed deltas all restore
    through this one reader.

    ``placement`` selects where the DECODE runs, independent of where the
    delta was encoded: "device" decodes through the CUDA kernels on
    ``device`` (the CUDA device unless the caller names another),
    "host" through their plain versions on the CPU."""
    assert placement in ("host", "device"), placement
    dev = resolve_device(device) if placement == "device" \
        else torch.device("cpu")
    meta = read_delta_manifest(directory, step)
    if meta is None:
        raise FileNotFoundError(f"delta {step} is corrupt or missing")
    # manifests without codec/scheme fields predate them: written with
    # zstd, float deltas without a residual, non-float leaves raw
    decompress = get_decompressor(meta.get("codec", "zstd"))
    mode = meta.get("mode", "lossless")
    xor_ints = meta.get("scheme") == "sub+xor"
    zero = frozenset(meta.get("zero", ()))
    ddir = delta_dir(directory, step)
    named = [(n, np.asarray(l)) for n, l in
             tree_flatten_with_names(base_state)]
    flat_out: dict[str, np.ndarray] = {}
    flat = meta.get("flat")
    if flat:
        flat_out = _decode_flat(ddir, flat, mode, zero, dict(named),
                                decompress, dev)
    from repro_torch.checkpoint.pipeline import io_pool
    futures = {name: io_pool().submit(_decode_leaf, ddir, name, leaf, mode,
                                      xor_ints, zero, decompress, dev)
               for name, leaf in named if name not in flat_out}
    out = [flat_out[name] if name in flat_out else futures[name].result()
           for name, _ in named]
    return tree_unflatten(tree_structure(base_state), out)
