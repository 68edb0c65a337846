"""The plain EtinyNet: its parameters and norm statistics, its training and
eval forward, its quantization to the int8 engine's integers, and the
engine's forward, in plain torch and numpy.

Part of the benchmark's yardstick: it imports nothing of the program. The
network is EtinyNet (Xu et al., AAAI 2022) as marict/nnue-vision builds
it: a 3×3 stride-2 stem → BN → ReLU6; linear-depthwise blocks (1×1 expand
→ BN → ReLU6 → 3×3 depthwise → BN → ReLU6 → 1×1 project → BN, a residual
at stride 1 where in == out, and in the dense stages a 1×1 projection of
[identity, h] → BN); a 1×1 conv → BN → ReLU6, the global mean and a
linear classifier. BatchNorm normalizes with the biased batch variance in
training and updates its running statistics as 0.9·old + 0.1·batch.

`dtype` is the dtype the convs and matmuls take their operands in; the
parameters, the norms' statistics and the logits stay float32. `low`
(the control) rounds every conv and matmul operand to float8 e4m3 first,
straight through.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.nn import functional as F

VARIANTS = {
    "0.98M": {"conv_channels": 28,
              "stages": [[(28, 28)] * 3, [(112, 112)] * 3,
                         [(168, 168)] * 3, [(224, 224)] * 2],
              "final_channels": 1120},
    "0.75": {"conv_channels": 24,
             "stages": [[(24, 24)] * 3, [(96, 96)] * 3,
                        [(144, 144)] * 3, [(192, 192)] * 2],
             "final_channels": 960},
    "micro": {"conv_channels": 8,
              "stages": [[(8, 8)], [(16, 16)] * 2, [(24, 24)] * 2,
                         [(32, 32)] * 2],
              "final_channels": 128},
}
EPS = 1e-5
MOMENTUM = 0.9
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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


def _bn(prefix: str, ch: int, specs: list) -> None:
    specs += [(f"{prefix}.scale", (ch,), ("const", 1.0)),
              (f"{prefix}.bias", (ch,), ("const", 0.0))]


def param_specs(cfg: dict) -> List[Tuple[str, tuple, tuple]]:
    """(name, shape, init) of every parameter, in the program's order:
    every conv U(±1/√(kh·kw·in)) in HWIO, norms at scale 1 and bias 0, the
    classifier U(±1/√final)."""
    t = VARIANTS[cfg["variant"]]
    c0, fin = t["conv_channels"], t["final_channels"]
    specs = [("stem_w", (3, 3, 3, c0), ("uniform", 27))]
    _bn("stem_bn", c0, specs)
    for i, (cin, mid, out, _, _, proj) in enumerate(blocks(cfg)):
        b = f"blocks.{i}"
        specs.append((f"{b}.pw_expand_w", (1, 1, cin, mid), ("uniform", cin)))
        _bn(f"{b}.bn1", mid, specs)
        specs.append((f"{b}.dw_w", (3, 3, 1, mid), ("uniform", 9)))
        _bn(f"{b}.bn2", mid, specs)
        specs.append((f"{b}.pw_project_w", (1, 1, mid, out), ("uniform", mid)))
        _bn(f"{b}.bn3", out, specs)
        if proj:
            specs.append((f"{b}.dense_proj_w", (1, 1, cin + out, out),
                          ("uniform", cin + out)))
            _bn(f"{b}.dense_bn", out, specs)
    last = blocks(cfg)[-1][2]
    specs.append(("final_w", (1, 1, last, fin), ("uniform", last)))
    _bn("final_bn", fin, specs)
    specs += [("cls_w", (cfg["num_classes"], fin), ("uniform", fin)),
              ("cls_b", (cfg["num_classes"],), ("uniform", fin))]
    return specs


def norms(cfg: dict) -> List[Tuple[str, int]]:
    """(prefix, channels) of every norm, in forward order."""
    return [(n[:-len(".scale")], s[0]) for n, s, _ in param_specs(cfg)
            if n.endswith(".scale")]


def init_stats(cfg: dict, device) -> Dict[str, torch.Tensor]:
    """Running statistics at their init: mean 0, var 1."""
    out = {}
    for prefix, ch in norms(cfg):
        out[f"{prefix}.mean"] = torch.zeros(ch, device=device)
        out[f"{prefix}.var"] = torch.ones(ch, device=device)
    return out


def _low(x: torch.Tensor) -> torch.Tensor:
    return x + (x.to(torch.float8_e4m3fn).to(x.dtype) - x).detach()


class _Net:
    """One forward's arithmetic: operand casts, the norms, the convs."""

    def __init__(self, p, stats, dtype, train: bool, low: bool):
        self.p, self.stats, self.dtype = p, stats, dtype
        self.train, self.low = train, low

    def op(self, x):
        x = x.to(self.dtype)
        return _low(x) if self.low else x

    def pw(self, x, name):
        return self.op(x) @ self.op(self.p[name][0, 0])

    def conv(self, x, name, stride, groups=1):
        w = self.op(self.p[name]).permute(3, 2, 0, 1)
        return F.conv2d(self.op(x).permute(0, 3, 1, 2), w, stride=stride,
                        padding=1, groups=groups).permute(0, 2, 3, 1)

    def bn(self, x, prefix):
        xf = x.to(torch.float32)
        if self.train:
            mean = xf.mean(dim=(0, 1, 2))
            var = xf.var(dim=(0, 1, 2), unbiased=False)
            if self.stats is not None:
                with torch.no_grad():
                    for k, v in (("mean", mean), ("var", var)):
                        s = self.stats[f"{prefix}.{k}"]
                        s.copy_(MOMENTUM * s + (1 - MOMENTUM) * v.detach())
        else:
            mean, var = self.stats[f"{prefix}.mean"], self.stats[f"{prefix}.var"]
        inv = torch.rsqrt(var + EPS)
        y = (xf - mean) * (inv * self.p[f"{prefix}.scale"]) + self.p[f"{prefix}.bias"]
        return y.to(x.dtype)


def _relu6(x):
    return torch.minimum(torch.maximum(x, torch.tensor(0.0, dtype=x.dtype)),
                         torch.tensor(6.0, dtype=x.dtype))


def forward(p: Dict[str, torch.Tensor], stats: Optional[Dict[str, torch.Tensor]],
            images: torch.Tensor, cfg: dict, *, train: bool = True,
            low: bool = False) -> torch.Tensor:
    """Logits (B, classes) float32 of normalized (B, H, W, 3) images. In
    training the norms use batch statistics and update `stats` (None: no
    update)."""
    net = _Net(p, stats, DTYPES[cfg["dtype"]], train, low)
    x = images.to(net.dtype)
    x = _relu6(net.bn(net.conv(x, "stem_w", 2), "stem_bn"))
    for i, (cin, mid, out, stride, _, proj) in enumerate(blocks(cfg)):
        b = f"blocks.{i}"
        identity = x
        h = _relu6(net.bn(net.pw(x, f"{b}.pw_expand_w"), f"{b}.bn1"))
        h = _relu6(net.bn(net.conv(h, f"{b}.dw_w", stride, groups=mid), f"{b}.bn2"))
        h = net.bn(net.pw(h, f"{b}.pw_project_w"), f"{b}.bn3")
        if stride == 1 and cin == out:
            h = h + identity
            if proj:
                h = net.bn(net.pw(torch.cat([identity, h], dim=-1),
                                  f"{b}.dense_proj_w"), f"{b}.dense_bn")
        x = h
    x = _relu6(net.bn(net.pw(x, "final_w"), "final_bn"))
    x = x.mean(dim=(1, 2))
    logits = net.op(x) @ net.op(p["cls_w"]).T + p["cls_b"].to(net.dtype)
    return logits.to(torch.float32)


def forward_macs(cfg: dict) -> float:
    """Multiply-adds of one forward at cfg["input_size"]: the stem, each
    block's expand at its input size, its depthwise and project (and dense
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


# ---------------------------------------------------------------------------
# int8 serving
# ---------------------------------------------------------------------------

GAIN = 16  # every block boundary carries 16× its float value


def _qw(w, scale: float = 64.0, bits: int = 8) -> np.ndarray:
    q = np.clip(np.round(np.asarray(w, np.float64) * scale), -127, 127)
    if bits == 4:
        q = np.clip(np.round(q / 16.0), -7, 7) * 16.0
    return q.astype(np.int8)


def _qb(b, scale: float) -> np.ndarray:
    return np.round(np.asarray(b, np.float64) * scale).astype(np.int32)


def _folder(params, stats):
    p = {k: v.detach().to("cpu", torch.float32).numpy() for k, v in params.items()}
    s = {k: v.detach().to("cpu", torch.float32).numpy() for k, v in stats.items()}

    def fold(w, prefix):
        """The norm folded into the conv before it, in float64: (w·k,
        bias − mean·k) with k = scale / √(var + eps)."""
        g = np.asarray(p[f"{prefix}.scale"], np.float64)
        k = g / np.sqrt(np.asarray(s[f"{prefix}.var"], np.float64) + EPS)
        bias = (np.asarray(p[f"{prefix}.bias"], np.float64)
                - np.asarray(s[f"{prefix}.mean"], np.float64) * k)
        return np.asarray(w, np.float64) * k, bias
    return p, fold


def _q_stem(p, fold, bits):
    w, b = fold(p["stem_w"], "stem_bn")
    return {"stem_w": _qw(np.transpose(w, (3, 2, 0, 1)), GAIN, bits),
            "stem_b": _qb(b, 64.0 * GAIN)}


def _q_block(p, fold, i, stride, bits):
    b = f"blocks.{i}"
    pw_e, pw_e_b = fold(p[f"{b}.pw_expand_w"], f"{b}.bn1")
    dw, _ = fold(p[f"{b}.dw_w"], f"{b}.bn2")
    pw_p, _ = fold(p[f"{b}.pw_project_w"], f"{b}.bn3")
    return {"we": _qw(pw_e[0, 0].T, bits=bits), "be": _qb(pw_e_b, 64.0 * GAIN),
            "dw": _qw(np.transpose(dw[:, :, 0, :], (2, 0, 1)), bits=bits),
            "wp": _qw(pw_p[0, 0].T, bits=bits), "stride": stride,
            "scales": (64 * GAIN, 64, 64 // GAIN)}


def _q_final(p, fold, cfg, bits):
    fin = VARIANTS[cfg["variant"]]["final_channels"]
    w, b = fold(p["final_w"], "final_bn")
    dw_id = np.zeros((fin, 3, 3), np.int8)
    dw_id[:, 1, 1] = 64
    return {"we": _qw(w[0, 0].T, bits=bits), "be": _qb(b, 64.0 * GAIN),
            "dw": dw_id, "wp": _qw(np.eye(fin)), "stride": 1,
            "scales": (64 * GAIN, 64, 64 // GAIN)}


def quantize(params: Dict[str, torch.Tensor], stats: Dict[str, torch.Tensor],
             cfg: dict, bits: int = 8) -> Dict[str, object]:
    """The engine's integers of a float model (the `.etiny` scheme): each
    norm folded in float64 into the conv before it (with its bias into the
    stem, the expands and the final conv; as a scale alone into the
    depthwise and project convs), the stem's weights at 16 and its bias at
    1024, the expands at 64 with divisor 1024, the depthwise at 64, the
    projects at 64 with divisor 4; the final 1×1 conv + norm as one more
    block with an identity depthwise and a ×64 diagonal project; the
    classifier at 64 over 1024. The residual and dense paths are not in
    the engine. `bits=4` keeps every weight on int4's grid instead: the
    control of the serving comparison."""
    p, fold = _folder(params, stats)
    q = _q_stem(p, fold, bits)
    q["blocks"] = [_q_block(p, fold, i, blk[3], bits)
                   for i, blk in enumerate(blocks(cfg))]
    q["blocks"].append(_q_final(p, fold, cfg, bits))
    q["cls_w"] = _qw(p["cls_w"], bits=bits)
    q["cls_b"] = _qb(p["cls_b"], 64.0 * GAIN)
    return q


def _tdiv(a, b):
    return torch.div(a, b, rounding_mode="trunc")


def _dot(x, w):
    return (x.to(torch.float64) @ w.to(torch.float64)).to(torch.int64)


def _t(a, dev):
    return torch.as_tensor(a).to(dev)


def _stem(q, images: torch.Tensor) -> torch.Tensor:
    """int32(x·64), the 3×3 stride-2 conv + bias, truncating /64, clamp
    ±127: (B, H, W, 3) float32 → (B, oh, ow, C) int64."""
    dev = images.device
    b, h, w, _ = images.shape
    oh, ow = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    c0 = q["stem_w"].shape[0]
    scale = torch.full((), 64.0, dtype=torch.float32, device=dev)
    pad = torch.zeros((b, h + 2, w + 2, 3), dtype=torch.float64, device=dev)
    pad[:, 1:h + 1, 1:w + 1] = torch.trunc(images.to(torch.float32) * scale)
    patches = pad.unfold(1, 3, 2).unfold(2, 3, 2).reshape(b * oh * ow, 27)
    acc = (patches @ _t(q["stem_w"], dev).reshape(c0, 27).to(torch.float64).T
           ).to(torch.int64).reshape(b, oh, ow, c0) + _t(q["stem_b"], dev).to(torch.int64)
    return torch.clamp(_tdiv(acc, 64), -127, 127)


def _expand(x, blk):
    s_e = blk["scales"][0]
    acc = _dot(x, _t(blk["we"], x.device).T) + _t(blk["be"], x.device).to(torch.int64)
    return torch.clamp(_tdiv(acc, s_e), 0, 6)


def _depthwise_acc(hid, dw, s):
    b, h, w, c = hid.shape
    oh, ow = (h - 1) // s + 1, (w - 1) // s + 1
    hp = F.pad(hid, (0, 0, 1, 1, 1, 1))
    acc = torch.zeros((b, oh, ow, c), dtype=hid.dtype, device=hid.device)
    for kh in range(3):
        for kw in range(3):
            acc += hp[:, kh:kh + (oh - 1) * s + 1:s,
                      kw:kw + (ow - 1) * s + 1:s] * dw[:, kh, kw]
    return acc


def _depthwise(hid, blk):
    acc = _depthwise_acc(hid, _t(blk["dw"], hid.device).to(torch.int64),
                         blk["stride"])
    return torch.clamp(_tdiv(acc, blk["scales"][1]), 0, 6)


def _project(hid, blk):
    acc = _dot(hid, _t(blk["wp"], hid.device).T)
    return torch.clamp(_tdiv(acc, blk["scales"][2]), -127, 127)


def engine_forward(q: Dict[str, object], images: torch.Tensor, cfg: dict
                   ) -> torch.Tensor:
    """The int8 engine's logits (B, classes) float32 of normalized (B, H,
    W, 3) float32 images: the stem (int32(x·64), 3×3 stride 2, + bias,
    truncating /64, clamp ±127), each block (expand + bias, /1024, clamp
    [0, 6]; depthwise, /64, clamp [0, 6]; project, /4, clamp ±127), the
    global mean (truncating), the classifier's accumulator over 1024."""
    x = _stem(q, images)
    for blk in q["blocks"]:
        x = _project(_depthwise(_expand(x, blk), blk), blk)
    pooled = torch.clamp(_tdiv(x.sum(dim=(1, 2)), x.shape[1] * x.shape[2]),
                         -127, 127)
    out = _dot(pooled, _t(q["cls_w"], x.device).T) + _t(q["cls_b"], x.device).to(torch.int64)
    return out.to(torch.float32) / torch.full((), 64.0 * GAIN,
                                              dtype=torch.float32, device=x.device)


@torch.no_grad()
def calibrate(params: Dict[str, torch.Tensor], images: torch.Tensor,
              cfg: dict) -> Dict[str, torch.Tensor]:
    """Running statistics for serving a model with random weights through
    the int8 engine. Layer by layer, each norm's statistics are read from
    the float value the engine's own integer input to it gives (the layers
    before already quantized with theirs): mean and variance for the norms
    the engine folds with their bias (the stem, the expands, the final
    conv), the mean square for those it folds as a scale alone (the
    depthwise and project convs). So every folded norm scales its
    pre-activation to about unit size, and the int8 blocks stay alive
    through the network's depth, as a trained engine model's do (the
    init's mean 0 and var 1 leave the blocks past the third at zero). The
    norms of the residual and dense paths, which the engine does not run,
    keep their init."""
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
    both("stem_bn", F.conv2d(torch.trunc(x64 * 64).permute(0, 3, 1, 2) / 64, w,
                             stride=2, padding=1).permute(0, 2, 3, 1))
    p, fold = _folder(params, stats)
    x = _stem(_q_stem(p, fold, 8), images)
    specs = blocks(cfg)
    for i in range(len(specs) + 1):
        final = i == len(specs)
        b = "final" if final else f"blocks.{i}"
        stride = None if final else specs[i][3]
        we = params["final_w" if final else f"{b}.pw_expand_w"][0, 0].to(torch.float64)
        both("final_bn" if final else f"{b}.bn1", (x.to(torch.float64) / GAIN) @ we)
        if final:
            break
        p, fold = _folder(params, stats)
        blk = _q_block(p, fold, i, stride, 8)
        hid = _expand(x, blk)
        dw = params[f"{b}.dw_w"][:, :, 0, :].permute(2, 0, 1).to(torch.float64)
        square(f"{b}.bn2", _depthwise_acc(hid.to(torch.float64), dw, stride))
        p, fold = _folder(params, stats)
        blk = _q_block(p, fold, i, stride, 8)
        hid = _depthwise(hid, blk)
        wp = params[f"{b}.pw_project_w"][0, 0].to(torch.float64)
        square(f"{b}.bn3", hid.to(torch.float64) @ wp)
        p, fold = _folder(params, stats)
        x = _project(hid, _q_block(p, fold, i, stride, 8))
    return stats
