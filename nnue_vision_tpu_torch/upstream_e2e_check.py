"""End-to-end interchange check: a trained NNUE checkpoint through the
upstream `nnue_inference` binary, held to the port's int8 paths (the
port's counterpart of `scripts/upstream_e2e_check.py`, the PARITY.md 64/64
artifact).

    python -m nnue_vision_tpu_torch.upstream_e2e_check --ckpt CKPT \\
        [--ref-build build/torch_engine_ref] [--n 64] \\
        [--dataset synthetic-hard] [--synthetic-size 20000] [--device cuda]

Serializes the checkpoint (this package's, the JAX package's or an
upstream torch file) with the port's `serialize.serialize_checkpoint`,
reads the `.nnue` back with `formats.read_nnue`, and runs the first `--n`
images of the dataset's test split (seed 42), normalized, one per
process, through `<ref-build>/nnue_inference`: the unmodified upstream
binary, built from the upstream checkout with
`cmake -S <upstream>/engine -B build/torch_engine_ref && cmake --build
build/torch_engine_ref --target nnue_inference`; any build of the engine's
tool takes its place (the port's own is `build/torch_engine/`).

The binary prints fixed ten-decimal logits (`%.10f`), which cannot
round-trip a float32 below ~1e-3 (a logit of exactly -2^-11 prints as
-0.0004882812), so bit-exactness is judged at that shared representation:
a path's logits printed the same way must equal the binary's text. The
paths are the plain sim (`ops/engine_sim.nnue_engine_forward`) and, on the
card, K1 (`ops/nnue_kernels.nnue_engine_forward_mega`); both run on
`--device` (the card unless the caller names another; without CUDA that
raises). Prints one JSON line with the JAX tool's keys, and on the card
`bit_exact_vs_k1`; exits 1 if any image differs, 2 if the binary is
missing.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
DEFAULT_REF_BUILD = REPO / "build" / "torch_engine_ref"


def printed(logits: np.ndarray) -> list:
    """Each image's logits as the engine prints them (`%.10f`)."""
    return [[f"{float(v):.10f}" for v in row] for row in np.asarray(logits)]


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--ref-build", default=str(DEFAULT_REF_BUILD))
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--dataset", default="synthetic-hard")
    ap.add_argument("--synthetic-size", type=int, default=20000)
    ap.add_argument("--device", default="cuda",
                    help="where the sim and K1 run (default: the card)")
    args = ap.parse_args(argv)

    exe = Path(args.ref_build) / "nnue_inference"
    if not exe.exists():
        print(f"upstream binary missing at {exe} — build it first "
              "(see the module's docstring)", file=sys.stderr)
        return 2

    from nnue_vision_tpu_torch.data.datasets import GenericVisionDataset
    from nnue_vision_tpu_torch.formats import read_nnue
    from nnue_vision_tpu_torch.ops import nnue_kernels as nk
    from nnue_vision_tpu_torch.ops.engine_sim import (
        nnue_engine_forward,
        nnue_sim_params,
        resolve_device,
    )
    from nnue_vision_tpu_torch.serialize import load_checkpoint_auto, serialize_checkpoint
    from nnue_vision_tpu_torch.training.evaluate import normalize_host

    device = resolve_device(args.device)
    model_type, _, _ = load_checkpoint_auto(Path(args.ckpt), device=device)
    if model_type != "nnue":
        print(f"the interchange check is NNUE; got {model_type}", file=sys.stderr)
        return 2

    ds = GenericVisionDataset(args.dataset, split="test",
                              synthetic_size=args.synthetic_size, seed=42)
    labels = ds.labels[: args.n]
    norm = normalize_host(ds.images[: args.n])
    n, h, w = norm.shape[:3]

    with tempfile.TemporaryDirectory() as tmp:
        td = Path(tmp)
        model_path = td / "flagship.nnue"
        serialize_checkpoint(Path(args.ckpt), model_path, device=device)
        q = read_nnue(model_path)
        upstream = []
        img_path = td / "img.bin"
        for img in norm:
            np.ascontiguousarray(img, np.float32).tofile(img_path)
            r = subprocess.run(
                [str(exe), str(model_path), str(img_path), str(h), str(w)],
                capture_output=True, text=True, timeout=60,
            )
            if r.returncode != 0:
                raise RuntimeError(f"{exe} failed (rc={r.returncode}): {r.stderr}")
            upstream.append(r.stdout.strip().split(",")[:-1])

    sim, cfg = nnue_sim_params(q, device=device)
    x = torch.from_numpy(norm).to(device)
    kw = dict(cfg=cfg, image_h=h, image_w=w)
    paths = {"bit_exact_vs_our_sim":
             nnue_engine_forward(sim, x, **kw)[0].cpu().numpy()}
    if device.type == "cuda":
        head = nk.mega_head_params(sim, cfg, h, w)
        paths["bit_exact_vs_k1"] = nk.nnue_engine_forward_mega(
            head, x.reshape(n, -1), **kw)[0].cpu().numpy()

    exact = {key: sum(int(ours == theirs) for ours, theirs
                      in zip(printed(logits), upstream))
             for key, logits in paths.items()}
    correct = sum(int(int(np.argmax(np.array([float(v) for v in u], np.float32)))
                      == int(label))
                  for u, label in zip(upstream, labels))
    out = {
        "ckpt": args.ckpt,
        "n": n,
        "upstream_binary": str(exe),
        "bit_exact_vs_our_sim": exact["bit_exact_vs_our_sim"],
        "upstream_correct": correct,
        "upstream_accuracy": round(correct / max(1, n), 4),
    }
    if "bit_exact_vs_k1" in exact:
        out["bit_exact_vs_k1"] = exact["bit_exact_vs_k1"]
    print(json.dumps(out))
    broken = [k for k, v in exact.items() if v != n]
    if broken:
        print(f"logit mismatch against the binary ({', '.join(broken)}) — "
              "parity broken", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
