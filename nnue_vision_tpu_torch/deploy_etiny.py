"""Deploy an EtinyNet checkpoint and score the deployed model beside the
float one.

    python -m nnue_vision_tpu_torch.deploy_etiny CHECKPOINT \\
        --config config/train_etinynet_anchor_qat.py [--seed 42] \\
        [--max_samples 500] [--out model.etiny] [--device cuda]

The checkpoint's model (this package's or the JAX package's pickle) goes
through `etinynet_quantize` into a `.etiny` file (`--out`, or a temporary
one), which is read back and run by `etiny_forward_kernel`, one K6 launch
per LB block, on the first `--max_samples` images of the config's val
split (the test split the training loop evaluates, drawn from the config's
dataset and `--seed`). The float model runs in eval mode on the same
images, in float32 (TF32 off, as in training). Prints one JSON object: the
float and int8 accuracy, the share of images whose predictions agree, and
the per-image relative logit error max|float - int8| / max(1e-3,
max|float|) (median, 90th percentile, max, share above 0.1); on the card
each int8 batch is also held to the engine sim (`k6_max_abs_err_vs_sim`,
null on the CPU, where the kernel's plain version is the sim). Runs on
the card unless `--device` names another.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from config import load_config
from nnue_vision_tpu_torch.data.augment import normalize_images
from nnue_vision_tpu_torch.data.datasets import GenericVisionDataset
from nnue_vision_tpu_torch.formats import read_etiny, write_etiny
from nnue_vision_tpu_torch.models.etinynet import EtinyNet, etinynet_quantize
from nnue_vision_tpu_torch.ops.engine_sim import (
    etiny_engine_forward,
    etiny_sim_params,
    resolve_device,
)
from nnue_vision_tpu_torch.ops.etiny_kernels import (
    etiny_forward_kernel,
    etiny_kernel_params,
)
from nnue_vision_tpu_torch.training.checkpoint import (
    etinynet_from_checkpoint,
    load_checkpoint,
)


def deploy(model: EtinyNet, etiny_path: Path) -> Tuple:
    """Quantize `model` into `etiny_path` and read it back: (the quantized
    model as read, K6's params, the sim's params, its config), on the
    model's device."""
    write_etiny(etinynet_quantize(model), etiny_path)
    q = read_etiny(etiny_path)
    sim, cfg = etiny_sim_params(q, device=next(model.parameters()).device)
    return q, etiny_kernel_params(sim, cfg), sim, cfg


def score(model: EtinyNet, kparams: Dict, sim: Dict, cfg, images: np.ndarray,
          labels: np.ndarray, batch: int = 1024) -> Dict:
    """The int8 forward (K6, one launch per LB block and batch) against the
    float model in eval mode on (images (N, H, W, 3) in [0, 1], labels
    (N,)); on the card each int8 batch is also held to the engine sim."""
    dev = next(model.parameters()).device
    model.eval()
    h, w = images.shape[1:3]
    err = 0.0 if dev.type == "cuda" else None
    rel, float_pred, int8_pred = [], [], []
    for i in range(0, len(labels), batch):
        x = normalize_images(torch.from_numpy(images[i:i + batch]).to(dev)).contiguous()
        il = etiny_forward_kernel(kparams, x, cfg=cfg, image_h=h, image_w=w)
        if err is not None:
            ref = etiny_engine_forward(sim, x, cfg=cfg, image_h=h, image_w=w)
            err = max(err, float((il.double() - ref.double()).abs().max()))
        with torch.no_grad():
            fl = model(x)
        if not (bool(torch.isfinite(fl).all()) and bool(torch.isfinite(il).all())):
            raise FloatingPointError("non-finite logits")
        rel.append(((fl - il).abs().amax(1) / fl.abs().amax(1).clamp_min(1e-3)).cpu())
        float_pred.append(fl.argmax(1).cpu())
        int8_pred.append(il.argmax(1).cpu())
    rel_np = torch.cat(rel).numpy().astype(np.float64)
    fp, ip = torch.cat(float_pred).numpy(), torch.cat(int8_pred).numpy()
    return {
        "n": int(len(labels)),
        "float_acc": float((fp == labels).mean()),
        "int8_acc": float((ip == labels).mean()),
        "agree": float((fp == ip).mean()),
        "rel_err_median": float(np.median(rel_np)),
        "rel_err_p90": float(np.percentile(rel_np, 90)),
        "rel_err_max": float(rel_np.max()),
        "rel_err_share_above_0.1": float((rel_np > 0.1).mean()),
        "k6_max_abs_err_vs_sim": err,
    }


def main(argv: Optional[list] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("checkpoint", type=Path)
    parser.add_argument("--config", required=True,
                        help="the training config whose val split is scored")
    parser.add_argument("--seed", type=int, help="override the config's seed")
    parser.add_argument("--max_samples", type=int)
    parser.add_argument("--out", type=Path, help="where to write the .etiny")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    cfg = load_config(args.config)
    seed = args.seed if args.seed is not None else getattr(cfg, "seed", 42)
    val = GenericVisionDataset(
        getattr(cfg, "dataset_name", "cifar10"), split="test",
        max_samples=args.max_samples,
        synthetic_size=getattr(cfg, "synthetic_size", 512), seed=seed)
    dev = resolve_device(args.device)
    # the float model computes in float32, as train_model trains it
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    payload = load_checkpoint(args.checkpoint)
    model = etinynet_from_checkpoint(payload, device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        out = args.out or Path(tmp) / "model.etiny"
        _, kparams, sim, ecfg = deploy(model, out)
        size = out.stat().st_size
    result = score(model, kparams, sim, ecfg, val.images, val.labels)
    result.update(etiny_bytes=size, checkpoint_epoch=payload.get("epoch"), seed=seed,
                  device=torch.cuda.get_device_name(dev) if dev.type == "cuda"
                  else str(dev))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
