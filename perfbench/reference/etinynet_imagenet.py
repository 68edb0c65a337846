"""The plain EtinyNet-1.0 at ImageNet size: its parameters and norm
statistics, its training and eval forward and its multiply-adds, its
quantization to the int8 engine's integers, the engine's forward and its
multiply-adds, in plain torch and numpy.

Part of the benchmark's yardstick: it imports nothing of the program. The
arithmetic that does not depend on the widths (the operand casts, the
norms, the weight folds and roundings, the engine's stem, blocks, pool and
classifier) is `perfbench/reference/etinynet.py`'s; this module holds what
does: the 1.0 table and every function that walks it.

The network is EtinyNet-1.0 (Xu et al., AAAI 2022) as marict/nnue-vision
builds it for ImageNet (`config/train_etinynet_imagenet.py`): a 32-channel
3×3 stride-2 stem; four LB blocks of 32, four of 128, then the dense
stages, three DLB blocks of 192 and two of 256, the first block of each
stage at stride 2; a 1×1 conv to 1,280 channels, the global mean and a
1,000-class linear classifier. At 224×224 the blocks' inputs are 112, 56,
28, 14 and 7 on a side. Departures from the paper: the int8 engine runs no
residual and no dense path (a trained model's float and int8 functions
differ there; the benchmark compares the engine's integers, which do not);
BatchNorm normalizes with the biased batch variance, as the repository's
trainer does. Float paths run in the configuration's dtype with TF32 off
(the harness switches it off).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from perfbench.reference import etinynet as base
from perfbench.reference.etinynet import DTYPES, GAIN
# the engine's forward walks the quantized blocks it is given: no table
from perfbench.reference.etinynet import engine_forward  # noqa: F401

VARIANTS = {
    "1.0": {"conv_channels": 32,
            "stages": [[(32, 32)] * 4, [(128, 128)] * 4,
                       [(192, 192)] * 3, [(256, 256)] * 2],
            "final_channels": 1280},
    # the CPU tests' cut of the same layout
    "micro": base.VARIANTS["micro"],
}


def blocks(cfg: dict) -> List[Tuple[int, int, int, int, bool, bool]]:
    """[(in, mid, out, stride, dense stage, has the dense projection)]: the
    first block of every stage has stride 2; stages 3 and 4 are dense."""
    t = VARIANTS[cfg["variant"]]
    out, prev = [], t["conv_channels"]
    for s, stage in enumerate(t["stages"]):
        for i, (mid, o) in enumerate(stage):
            stride = 2 if i == 0 else 1
            dense = s >= 2
            out.append((prev, mid, o, stride, dense,
                        dense and stride == 1 and prev == o))
            prev = o
    return out


def param_specs(cfg: dict) -> List[Tuple[str, tuple, tuple]]:
    """(name, shape, init) of every parameter, in the program's order:
    every conv U(±1/√(kh·kw·in)) in HWIO, norms at scale 1 and bias 0, the
    classifier U(±1/√final)."""
    t = VARIANTS[cfg["variant"]]
    c0, fin = t["conv_channels"], t["final_channels"]
    specs = [("stem_w", (3, 3, 3, c0), ("uniform", 27))]
    base._bn("stem_bn", c0, specs)
    for i, (cin, mid, out, _, _, proj) in enumerate(blocks(cfg)):
        b = f"blocks.{i}"
        specs.append((f"{b}.pw_expand_w", (1, 1, cin, mid), ("uniform", cin)))
        base._bn(f"{b}.bn1", mid, specs)
        specs.append((f"{b}.dw_w", (3, 3, 1, mid), ("uniform", 9)))
        base._bn(f"{b}.bn2", mid, specs)
        specs.append((f"{b}.pw_project_w", (1, 1, mid, out), ("uniform", mid)))
        base._bn(f"{b}.bn3", out, specs)
        if proj:
            specs.append((f"{b}.dense_proj_w", (1, 1, cin + out, out),
                          ("uniform", cin + out)))
            base._bn(f"{b}.dense_bn", out, specs)
    last = blocks(cfg)[-1][2]
    specs.append(("final_w", (1, 1, last, fin), ("uniform", last)))
    base._bn("final_bn", fin, specs)
    specs += [("cls_w", (cfg["num_classes"], fin), ("uniform", fin)),
              ("cls_b", (cfg["num_classes"],), ("uniform", fin))]
    return specs


def init_stats(cfg: dict, device) -> Dict[str, torch.Tensor]:
    """Running statistics at their init: mean 0, var 1."""
    out = {}
    for name, shape, _ in param_specs(cfg):
        if name.endswith(".scale"):
            prefix = name[:-len(".scale")]
            out[f"{prefix}.mean"] = torch.zeros(shape[0], device=device)
            out[f"{prefix}.var"] = torch.ones(shape[0], device=device)
    return out


def forward(p: Dict[str, torch.Tensor], stats: Optional[Dict[str, torch.Tensor]],
            images: torch.Tensor, cfg: dict, *, train: bool = True,
            low: bool = False) -> torch.Tensor:
    """Logits (B, classes) float32 of normalized (B, H, W, 3) images: the
    stem → BN → ReLU6; per block 1×1 expand → BN → ReLU6 → 3×3 depthwise →
    BN → ReLU6 → 1×1 project → BN, a residual at stride 1 where in == out
    and in the dense stages then a 1×1 projection of [identity, h] → BN;
    the final 1×1 conv → BN → ReLU6, the global mean and the classifier.
    In training the norms use batch statistics and update `stats` (None:
    no update); `low` rounds every conv and matmul operand to float8."""
    net = base._Net(p, stats, DTYPES[cfg["dtype"]], train, low)
    x = images.to(net.dtype)
    x = base._relu6(net.bn(net.conv(x, "stem_w", 2), "stem_bn"))
    for i, (cin, mid, out, stride, _, proj) in enumerate(blocks(cfg)):
        b = f"blocks.{i}"
        identity = x
        h = base._relu6(net.bn(net.pw(x, f"{b}.pw_expand_w"), f"{b}.bn1"))
        h = base._relu6(net.bn(net.conv(h, f"{b}.dw_w", stride, groups=mid),
                               f"{b}.bn2"))
        h = net.bn(net.pw(h, f"{b}.pw_project_w"), f"{b}.bn3")
        if stride == 1 and cin == out:
            h = h + identity
            if proj:
                h = net.bn(net.pw(torch.cat([identity, h], dim=-1),
                                  f"{b}.dense_proj_w"), f"{b}.dense_bn")
        x = h
    x = base._relu6(net.bn(net.pw(x, "final_w"), "final_bn"))
    x = x.mean(dim=(1, 2))
    logits = net.op(x) @ net.op(p["cls_w"]).T + p["cls_b"].to(net.dtype)
    return logits.to(torch.float32)


def forward_macs(cfg: dict) -> float:
    """Multiply-adds of one training forward at cfg["input_size"], by the
    base reference's rule over this module's table: the stem, each block's
    expand at its input size, its depthwise and project (and dense
    projection) at the strided size, the final 1×1 conv, the classifier."""
    t = VARIANTS[cfg["variant"]]
    h = (cfg["input_size"] - 1) // 2 + 1
    macs = h * h * t["conv_channels"] * 27
    for cin, mid, out, stride, _, proj in blocks(cfg):
        macs += h * h * cin * mid
        h = (h - 1) // stride + 1
        macs += h * h * (mid * 9 + mid * out + ((cin + out) * out if proj else 0))
    macs += h * h * blocks(cfg)[-1][2] * t["final_channels"]
    return float(macs + t["final_channels"] * cfg["num_classes"])


def engine_macs(cfg: dict):
    """(stem, LB stage, classifier) multiply-adds of one image through the
    int8 engine: the stem at its stride; per block the expand at its input
    size, the depthwise and project at the strided size; the final 1×1 conv
    as one more block whose identity depthwise and ×64 diagonal project
    need one multiply-add per value. The engine runs no residual or dense
    path."""
    t = VARIANTS[cfg["variant"]]
    h = (cfg["input_size"] - 1) // 2 + 1
    stem = h * h * t["conv_channels"] * 27
    stage = 0
    for cin, mid, out, stride, _, _ in blocks(cfg):
        stage += h * h * cin * mid
        h = (h - 1) // stride + 1
        stage += h * h * (mid * 9 + mid * out)
    fin = t["final_channels"]
    stage += h * h * (blocks(cfg)[-1][2] * fin + 2 * fin)
    return float(stem), float(stage), float(fin * cfg["num_classes"])


def _q_final(p, fold, cfg, bits):
    fin = VARIANTS[cfg["variant"]]["final_channels"]
    w, b = fold(p["final_w"], "final_bn")
    dw_id = np.zeros((fin, 3, 3), np.int8)
    dw_id[:, 1, 1] = 64
    return {"we": base._qw(w[0, 0].T, bits=bits), "be": base._qb(b, 64.0 * GAIN),
            "dw": dw_id, "wp": base._qw(np.eye(fin)), "stride": 1,
            "scales": (64 * GAIN, 64, 64 // GAIN)}


def quantize(params: Dict[str, torch.Tensor], stats: Dict[str, torch.Tensor],
             cfg: dict, bits: int = 8) -> Dict[str, object]:
    """The engine's integers of a float model (the `.etiny` scheme): each
    norm folded in float64 into the conv before it; the stem's weights at
    16 and its bias at 1024, the expands at 64 with divisor 1024, the
    depthwise at 64, the projects at 64 with divisor 4; the final 1×1 conv
    + norm as one more block with an identity depthwise and a ×64 diagonal
    project; the classifier at 64 over 1024. `bits=4` keeps every weight
    on int4's grid instead: the control of the serving comparison."""
    p, fold = base._folder(params, stats)
    q = base._q_stem(p, fold, bits)
    q["blocks"] = [base._q_block(p, fold, i, blk[3], bits)
                   for i, blk in enumerate(blocks(cfg))]
    q["blocks"].append(_q_final(p, fold, cfg, bits))
    q["cls_w"] = base._qw(p["cls_w"], bits=bits)
    q["cls_b"] = base._qb(p["cls_b"], 64.0 * GAIN)
    return q


@torch.no_grad()
def calibrate(params: Dict[str, torch.Tensor], images: torch.Tensor,
              cfg: dict) -> Dict[str, torch.Tensor]:
    """Running statistics for serving a model with random weights through
    the int8 engine, layer by layer from the float value the engine's own
    integer input to each norm gives, the layers before quantized with
    theirs: mean and variance for the norms the engine folds with their
    bias (the stem, the expands, the final conv), the mean square for
    those it folds as a scale alone (the depthwise and project convs). The
    norms of the residual and dense paths keep their init."""
    dev = images.device
    stats = init_stats(cfg, dev)

    def both(prefix, pre):
        stats[f"{prefix}.mean"] = pre.mean(dim=(0, 1, 2)).float()
        stats[f"{prefix}.var"] = pre.var(dim=(0, 1, 2), unbiased=False).float()

    def square(prefix, pre):
        stats[f"{prefix}.mean"] = torch.zeros(pre.shape[-1], device=dev)
        stats[f"{prefix}.var"] = (pre * pre).mean(dim=(0, 1, 2)).float()

    x64 = images.to(torch.float64)
    w = params["stem_w"].to(torch.float64).permute(3, 2, 0, 1)
    both("stem_bn", torch.nn.functional.conv2d(
        torch.trunc(x64 * 64).permute(0, 3, 1, 2) / 64, w, stride=2,
        padding=1).permute(0, 2, 3, 1))
    del x64
    p, fold = base._folder(params, stats)
    x = base._stem(base._q_stem(p, fold, 8), images)
    specs = blocks(cfg)
    for i in range(len(specs) + 1):
        final = i == len(specs)
        b = "final" if final else f"blocks.{i}"
        stride = None if final else specs[i][3]
        we = params["final_w" if final else f"{b}.pw_expand_w"][0, 0].to(torch.float64)
        both("final_bn" if final else f"{b}.bn1", (x.to(torch.float64) / GAIN) @ we)
        if final:
            break
        p, fold = base._folder(params, stats)
        blk = base._q_block(p, fold, i, stride, 8)
        hid = base._expand(x, blk)
        dw = params[f"{b}.dw_w"][:, :, 0, :].permute(2, 0, 1).to(torch.float64)
        square(f"{b}.bn2", base._depthwise_acc(hid.to(torch.float64), dw, stride))
        p, fold = base._folder(params, stats)
        blk = base._q_block(p, fold, i, stride, 8)
        hid = base._depthwise(hid, blk)
        wp = params[f"{b}.pw_project_w"][0, 0].to(torch.float64)
        square(f"{b}.bn3", hid.to(torch.float64) @ wp)
        p, fold = base._folder(params, stats)
        x = base._project(hid, base._q_block(p, fold, i, stride, 8))
    return stats
