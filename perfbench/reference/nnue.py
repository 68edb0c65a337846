"""The plain NNUE: its parameters, its float and QAT forward with the
straight-through threshold, its quantization to the engine's integers, and
the int8 engine's forward, in plain torch and numpy.

Part of the benchmark's yardstick: it imports nothing of the program. The
model is marict/nnue-vision's NNUE for images: a 3×3 conv at the engine's
stride, a hard threshold whose mask, placed flat into a grid²·C buffer, is
the feature vector; a feature transformer (F → L1), the pairwise product of
its two halves beside the first half, and dense layers L1 → L2 → L3 →
classes. Its QAT, the configurations' recipe, clamps the activations to
the engine's ranges, collapses the per-channel thresholds to their mean,
and fake-quantizes weights and biases straight through.

The engine's forward is computed exactly: every integer stage in int64,
truncating divisions, and each product as a float64 matmul of
integer-valued operands (every partial sum an integer below 2^53).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
from torch.nn import functional as F

WEIGHTS = ("ft_w", "fc1_w", "fc2_w", "out_w")  # clipped to [-1, 1]


def conv_stride(image_h: int, grid: int) -> int:
    """The engine's runtime stride rule: ceil((H - 1) / (grid - 1))."""
    return max(1, -(-(image_h - 1) // (grid - 1)))


def conv_out_hw(cfg: dict) -> int:
    return (cfg["input_size"] - 1) // conv_stride(cfg["input_size"],
                                                  cfg["grid_size"]) + 1


def num_features(cfg: dict) -> int:
    return cfg["grid_size"] ** 2 * cfg["num_features_per_square"]


def param_specs(cfg: dict) -> List[Tuple[str, tuple, tuple]]:
    """(name, shape, init) of every parameter, in the program's order, with
    the JAX package's init distributions: ("uniform", fan_in) for
    U(±1/√fan_in), ("normal", std), ("const", value)."""
    ch, l1, l2, l3, nc = (cfg["num_features_per_square"], cfg["l1_size"],
                          cfg["l2_size"], cfg["l3_size"], cfg["num_classes"])
    return [
        ("conv_w", (ch, 3, 3, 3), ("uniform", 27)),
        ("visual_threshold", (ch,), ("const", 0.1)),
        ("ft_w", (num_features(cfg), l1), ("normal", 0.1)),
        ("ft_b", (l1,), ("const", 0.0)),
        ("fc1_w", (l2, l1), ("uniform", l1)),
        ("fc1_b", (l2,), ("uniform", l1)),
        ("fc2_w", (l3, l2), ("uniform", l2)),
        ("fc2_b", (l3,), ("uniform", l2)),
        ("out_w", (nc, l3), ("uniform", l3)),
        ("out_b", (nc,), ("uniform", l3)),
        ("nnue2score", (), ("const", 600.0)),
    ]


class _Threshold(torch.autograd.Function):
    """(x > t) forward; backward: dx = g, dt = -Σ g·k·σ'(k(x - t)), k = 10."""

    @staticmethod
    def forward(ctx, x, t):
        ctx.save_for_backward(x, t)
        return (x > t).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, t = ctx.saved_tensors
        sig = torch.sigmoid(10.0 * (x - t))
        return g, (-(g * 10.0 * sig * (1.0 - sig)).sum(dim=(0, 1, 2))).to(t.dtype)


def _clip(x, lo, hi):
    """max then min, so a value on a bound passes half the gradient."""
    lo_t = torch.tensor(lo, dtype=x.dtype)
    hi_t = torch.tensor(hi, dtype=x.dtype)
    return torch.minimum(torch.maximum(x, lo_t), hi_t)


def _fq(w, scale, clip=1.0):
    q = torch.round(torch.clamp(w, -clip, clip) * scale) / scale
    return w + (q - w).detach()


def _fq_bias(b, scale):
    return b + (torch.round(b * scale) / scale - b).detach()


def _qat(p: Dict[str, torch.Tensor], half: int) -> Dict[str, torch.Tensor]:
    p = dict(p)
    cw = p["conv_w"]
    p["conv_w"] = cw + (torch.round(torch.clamp(cw, -127 / 64, 127 / 64) * 64)
                        / 64 - cw).detach()
    p["ft_w"] = _fq(p["ft_w"], 64)
    p["ft_b"] = _fq_bias(p["ft_b"], 64)
    w = p["fc1_w"]
    p["fc1_w"] = torch.cat([_fq(w[:, :half], 64), _fq(w[:, half:], 32)], dim=1)
    p["fc1_b"] = _fq_bias(p["fc1_b"], 2048)
    p["fc2_w"] = _fq(p["fc2_w"], 64)
    p["fc2_b"] = _fq_bias(p["fc2_b"], 4096)
    p["out_w"] = _fq(p["out_w"], 64)
    p["out_b"] = _fq_bias(p["out_b"], 4096)
    return p


DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _low(x: torch.Tensor) -> torch.Tensor:
    return x + (x.to(torch.float8_e4m3fn).to(x.dtype) - x).detach()


def forward(p: Dict[str, torch.Tensor], images: torch.Tensor, cfg: dict,
            low: bool = False) -> torch.Tensor:
    """Logits (B, classes) float32 of normalized (B, H, W, 3) images: the
    QAT forward. The images, the conv, the threshold compare, the FT, the
    pairwise products and the dense layers compute in cfg["dtype"]; the
    parameters are fake-quantized in float32 and then cast, the threshold
    mean is taken in float32. `low` (a control) rounds every conv and
    matmul operand to float8 e4m3 first, straight through."""
    if not cfg["qat"]:
        raise NotImplementedError("the reference follows the QAT NNUE only")
    if cfg["dtype"] not in DTYPES:
        raise ValueError(f"the reference computes in {sorted(DTYPES)}, not "
                         f"{cfg['dtype']!r}")
    dtype = DTYPES[cfg["dtype"]]

    def op(x):
        x = x.to(dtype)
        return _low(x) if low else x

    half = cfg["l1_size"] // 2
    p = _qat(p, half)
    # serialization collapses the thresholds to their mean: train against it
    mean_t = p["visual_threshold"].mean(dim=0, keepdim=True)
    x = images.to(dtype)
    conv = F.conv2d(op(x).permute(0, 3, 1, 2), op(p["conv_w"]),
                    stride=conv_stride(cfg["input_size"], cfg["grid_size"]),
                    padding=1).permute(0, 2, 3, 1)
    mask = _Threshold.apply(conv, mean_t.expand(p["visual_threshold"].shape)
                            .to(dtype))
    b = mask.shape[0]
    flat = mask.reshape(b, -1)
    pad = num_features(cfg) - flat.shape[1]
    # the engine thresholds the zero-filled tail of the grid buffer as well
    tail = _Threshold.apply(x.new_zeros((b, 1, pad, 1)), mean_t.to(dtype))
    features = torch.cat([flat, tail.reshape(b, pad)], dim=1)
    ft = _clip(op(features) @ op(p["ft_w"]) + p["ft_b"].to(dtype),
               0.0, 127.0 / 64.0)
    a, c = ft[:, :half], ft[:, half:]
    l0 = torch.cat([_clip(a * c, 0.0, 127.0 / 32.0), a], dim=1)

    def linear(v, name):
        return op(v) @ op(p[f"{name}_w"]).T + p[f"{name}_b"].to(dtype)
    h1 = _clip(linear(l0, "fc1"), 0.0, 127.0 / 64.0)
    h2 = _clip(linear(h1, "fc2"), 0.0, 127.0 / 64.0)
    return linear(h2, "out").to(torch.float32)


@torch.no_grad()
def after_update(p: Dict[str, torch.Tensor]) -> None:
    """The NNUE's weight clip after every optimizer step."""
    for name in WEIGHTS:
        p[name].clamp_(-1.0, 1.0)


# ---------------------------------------------------------------------------
# int8 serving
# ---------------------------------------------------------------------------


def _qw(w: np.ndarray, scale: float = 64.0, bits: int = 8) -> np.ndarray:
    """round(w·scale) clamped to ±127, as int8; with bits=4 the value kept
    on int4's grid of that range (multiples of 16, within ±112)."""
    q = np.clip(np.round(np.asarray(w, np.float64) * scale), -127, 127)
    if bits == 4:
        q = np.clip(np.round(q / 16.0), -7, 7) * 16.0
    return q.astype(np.int8)


def _qb(b: np.ndarray, scale: float = 64.0) -> np.ndarray:
    return np.round(np.asarray(b, np.float64) * scale).astype(np.int32)


def quantize(params: Dict[str, torch.Tensor], cfg: dict, bits: int = 8
             ) -> Dict[str, object]:
    """The engine's integers of a float model (the `.nnue` scheme): FT and
    fc2/out weights at 64, fc1's product columns at 64 and linear columns
    at 32, biases at 64/2048/4096/4096, the threshold as the channel mean
    times 64. `bits=4` keeps every weight on int4's grid instead: the
    control of the serving comparison."""
    p = {k: v.detach().to("cpu", torch.float32).numpy() for k, v in params.items()}
    half = cfg["l1_size"] // 2
    unit = lambda w: np.clip(w, -1.0, 1.0)  # noqa: E731
    fc1 = unit(p["fc1_w"])
    return {
        "conv_w": _qw(p["conv_w"], bits=bits),
        "conv_b": np.zeros(p["conv_w"].shape[0], np.int32),
        "threshold": float(np.mean(p["visual_threshold"])) * 64.0,
        "ft_w": _qw(unit(p["ft_w"]), bits=bits).astype(np.int16),
        "ft_b": _qb(p["ft_b"]),
        "fc1_w": np.concatenate([_qw(fc1[:, :half], 64.0, bits),
                                 _qw(fc1[:, half:], 32.0, bits)], axis=1),
        "fc1_b": _qb(p["fc1_b"], 2048.0),
        "fc2_w": _qw(unit(p["fc2_w"]), bits=bits),
        "fc2_b": _qb(p["fc2_b"], 4096.0),
        "out_w": _qw(unit(p["out_w"]), bits=bits),
        "out_b": _qb(p["out_b"], 4096.0),
    }


def _tdiv(a: torch.Tensor, b: int) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="trunc")


def _dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return (x.to(torch.float64) @ w.to(torch.float64)).to(torch.int64)


def engine_forward(q: Dict[str, object], images: torch.Tensor, cfg: dict
                   ) -> torch.Tensor:
    """The int8 engine's logits (B, classes) float32 of (B, H, W, 3)
    float32 images: int32(x·64), the integer conv (+bias, truncating /64,
    clamp ±127), flat placement into the zero-filled buffer, the float
    threshold compare, the FT sum wrapped to int16 and clamped to
    [0, 127], the pairwise and dense stages with truncating divisions, and
    the output accumulator over 4096."""
    dev = images.device
    t = {k: torch.as_tensor(v).to(dev) for k, v in q.items()
         if isinstance(v, np.ndarray)}
    b, h, w, _ = images.shape
    s = conv_stride(h, cfg["grid_size"])
    oh, ow = (h - 1) // s + 1, (w - 1) // s + 1
    c = t["conv_w"].shape[0]
    scale = torch.full((), 64.0, dtype=torch.float32, device=dev)
    qin = torch.trunc(images.to(torch.float32) * scale)
    pad = torch.zeros((b, h + 2, w + 2, 3), dtype=torch.float64, device=dev)
    pad[:, 1:h + 1, 1:w + 1] = qin
    patches = pad.unfold(1, 3, s).unfold(2, 3, s).reshape(b * oh * ow, 27)
    acc = (patches @ t["conv_w"].reshape(c, 27).to(torch.float64).T
           ).to(torch.int64).reshape(b, oh * ow * c)
    conv = torch.clamp(_tdiv(acc, 64), -127, 127)
    buf = F.pad(conv, (0, num_features(cfg) - conv.shape[1]))
    thresh = torch.full((), q["threshold"], dtype=torch.float32, device=dev)
    mask = buf.to(torch.float32) > thresh
    acc = _dot(mask, t["ft_w"]) + t["ft_b"].to(torch.int64)
    ft = torch.clamp(((acc & 0xFFFF) ^ 0x8000) - 0x8000, 0, 127)
    half = cfg["l1_size"] // 2
    a, bb = ft[:, :half], ft[:, half:]
    l0 = torch.cat([torch.clamp(_tdiv(a * bb, 128), 0, 127),
                    torch.clamp(a, 0, 127)], dim=1)
    h1 = torch.clamp(_tdiv(_dot(l0, t["fc1_w"].T) + t["fc1_b"], 32), 0, 127)
    h2 = torch.clamp(_tdiv(_dot(h1, t["fc2_w"].T) + t["fc2_b"], 64), 0, 127)
    out = _dot(h2, t["out_w"].T) + t["out_b"].to(torch.int64)
    return out.to(torch.float32) / torch.full((), 4096.0, dtype=torch.float32,
                                              device=dev)


def forward_macs(cfg: dict) -> float:
    """Multiply-adds of one forward: the conv, the FT as a dense product,
    and the dense layers."""
    hw = conv_out_hw(cfg)
    ch, l1, l2, l3, nc = (cfg["num_features_per_square"], cfg["l1_size"],
                          cfg["l2_size"], cfg["l3_size"], cfg["num_classes"])
    return float(hw * hw * ch * 27 + num_features(cfg) * l1 + l1 * l2
                 + l2 * l3 + l3 * nc)
