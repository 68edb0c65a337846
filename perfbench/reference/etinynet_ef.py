"""The plain engine-friendly EtinyNet in quantization-aware training: its
parameters and norm statistics, its forward in float32, and its count of
multiply-adds.

Part of the benchmark's yardstick: it imports nothing of the program. The
network is EtinyNet (Xu et al., AAAI 2022) at the widths of
`reference/etinynet.py`, in the form marict/nnue-vision trains for its
int8 engine (`engine_friendly`, progressive QAT past the warm-up): no
residual or dense path; the depthwise and project norms scale-only; every
weight fake-quantized on the int8 grid that the serializer folds it onto;
learned-step-size (LSQ; Esser et al., ICLR 2020) activations on the
engine's 7 levels; every block boundary on the engine's 1/16 grid. The
forward, in training mode, in the order it is published:

* the stem's weight on its folded ×16 grid, the 3×3 stride-2 conv, a full
  norm, the 1/16 grid (the engine's stem has no ReLU6);
* per block, first the three folds, from the running statistics as they
  were before this step (f = g·rsqrt(var + eps) times the LSQ multipliers
  the serializer folds in: 1/s1 on the expand's output channels, s1/s2 on
  the depthwise's, s2 on the project's input channels; the weight is
  clip(round(w·f·64), ±127) / (64·f), straight through), then the expand,
  a full norm, the round activation clip(round(x/s1), 0, 6)·s1, the 3×3
  depthwise, a scale-only norm x·g·rsqrt(E[x²] + eps) (the running mean
  square kept in `var`), the floor activation with s2, the project, a
  scale-only norm, the 1/16 grid trunc(16·clip(x, ±127/16))/16;
* the final 1×1 conv folded with 1/s3 (s3 = clip(exp(final_qlog), 1/64,
  127/64)), a full norm, the round activation restored by the deployed
  round(64·s3)/64 (straight through to s3), the global mean, and the
  classifier on its plain clip(round(w·64), ±127)/64 grid.

s1 = exp(qlog1) and s2 = exp(qlog2) per channel. A full norm normalizes by
the batch mean and biased variance; every norm updates its running
statistics as 0.9·old + 0.1·batch. The residual and dense parameters, the
scale-only norms' biases and their running means are carried unused: the
optimizer steps them by the weight decay alone.

Written where float32 makes a choice, as the published code writes it:

* a straight-through step is x + (q − x).detach(), which in float32 is not
  always q;
* x/s with an LSQ scale s takes JAX's gradient for the divisor,
  −((g·(1/(s·s)))·x), summed over the broadcast dimensions (autograd's own
  rule is −g·((x/s)/s));
* a clip is max then min, which passes half the gradient to a value that
  equals a bound (`jnp.clip`), and that decides the LSQ scales' gradient on
  the rails 0 and 6.

Float32 only (the grids are float32's), with TF32 off: the control's TF32
is switched around a whole run by `perfbench/readings.py`.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch.nn import functional as F

from perfbench.reference.etinynet import EPS, MOMENTUM, VARIANTS, blocks

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

GRID16 = 127.0 / 16.0  # the block boundary's int8 range at 16× the value


def _block_params(b: str, cin: int, mid: int, out: int, proj: bool):
    """A block's (name, shape, init): its own weights first, then its
    norms', as the program's module lists them."""
    own = [(f"{b}.pw_expand_w", (1, 1, cin, mid), ("uniform", cin)),
           (f"{b}.qlog1", (mid,), ("const", 0.0)),
           (f"{b}.qlog2", (mid,), ("const", 0.0)),
           (f"{b}.dw_w", (3, 3, 1, mid), ("uniform", 9)),
           (f"{b}.pw_project_w", (1, 1, mid, out), ("uniform", mid))]
    norms = [(f"{b}.bn1", mid, 1.5), (f"{b}.bn2", mid, 0.0),
             (f"{b}.bn3", out, 0.0)]
    if proj:
        own.append((f"{b}.dense_proj_w", (1, 1, cin + out, out),
                    ("uniform", cin + out)))
        norms.append((f"{b}.dense_bn", out, 0.0))
    return own + _norm_params(norms)


def _norm_params(norms) -> list:
    return [spec for prefix, ch, bias in norms
            for spec in ((f"{prefix}.scale", (ch,), ("const", 1.0)),
                         (f"{prefix}.bias", (ch,), ("const", bias)))]


def param_specs(cfg: dict) -> List[Tuple[str, tuple, tuple]]:
    """(name, shape, init) of every parameter, in the program's order (the
    order its optimizer sums the clip's norm in): every conv U(±1/√(kh·kw·in))
    in HWIO, the classifier U(±1/√final), norms at scale 1 and bias 0
    except each block's first norm at bias 1.5 (its pre-activations start
    inside the 7-level grid), the LSQ scales' logs at 0."""
    t = VARIANTS[cfg["variant"]]
    c0, fin = t["conv_channels"], t["final_channels"]
    last = blocks(cfg)[-1][2]
    specs = [("stem_w", (3, 3, 3, c0), ("uniform", 27)),
             ("final_w", (1, 1, last, fin), ("uniform", last)),
             ("final_qlog", (fin,), ("const", 0.0)),
             ("cls_w", (cfg["num_classes"], fin), ("uniform", fin)),
             ("cls_b", (cfg["num_classes"],), ("uniform", fin))]
    specs += _norm_params([("stem_bn", c0, 0.0)])
    for i, (cin, mid, out, _, _, proj) in enumerate(blocks(cfg)):
        specs += _block_params(f"blocks.{i}", cin, mid, out, proj)
    return specs + _norm_params([("final_bn", fin, 0.0)])


def init_stats(cfg: dict, device) -> Dict[str, torch.Tensor]:
    """Running statistics at their init, mean 0 and var 1, for every norm
    (`param_specs` lists the norms in forward order)."""
    out = {}
    for name, shape, _ in param_specs(cfg):
        if name.endswith(".scale"):
            prefix = name[:-len(".scale")]
            out[f"{prefix}.mean"] = torch.zeros(shape, device=device)
            out[f"{prefix}.var"] = torch.ones(shape, device=device)
    return out


class _Div(torch.autograd.Function):
    """x / s with the divisor's gradient −((g·(1/(s·s)))·x)."""

    @staticmethod
    def forward(ctx, x, s):
        ctx.save_for_backward(x, s)
        return x / s

    @staticmethod
    def backward(ctx, g):
        x, s = ctx.saved_tensors
        return g / s, (-((g * (1.0 / (s * s))) * x)).sum_to_size(s.shape)


def _ste(x, q):
    return x + (q - x).detach()


def _clip(x, lo, hi):
    lo = lo if isinstance(lo, torch.Tensor) else torch.tensor(lo, dtype=x.dtype)
    hi = hi if isinstance(hi, torch.Tensor) else torch.tensor(hi, dtype=x.dtype)
    return torch.minimum(torch.maximum(x, lo), hi)


class _Net:
    """One forward's norms and weight grids over the leaves `p` and the
    running statistics `stats` (updated in place in training)."""

    def __init__(self, p, stats, train: bool):
        self.p, self.stats, self.train = p, stats, train

    def fold(self, name: str, prefix: str, scale: float,
             out_mul=None, in_mul=None):
        """The weight `name` on the grid the norm `prefix` folds it onto,
        straight through."""
        w = self.p[name]
        with torch.no_grad():
            f = self.p[f"{prefix}.scale"] * torch.rsqrt(
                self.stats[f"{prefix}.var"] + EPS)
            if out_mul is not None:
                f = f * out_mul
            f = f.reshape(1, 1, 1, -1)
            if in_mul is not None:
                f = f * in_mul.reshape(1, 1, -1, 1)
            q = torch.clamp(torch.round(w * f * scale), -127.0, 127.0) / (scale * f)
        return _ste(w, q)

    def _update(self, prefix: str, key: str, batch):
        with torch.no_grad():
            s = self.stats[f"{prefix}.{key}"]
            s.copy_(MOMENTUM * s + (1 - MOMENTUM) * batch.detach())

    def bn(self, x, prefix: str):
        if self.train:
            mean = x.mean(dim=(0, 1, 2))
            var = x.var(dim=(0, 1, 2), unbiased=False)
            self._update(prefix, "mean", mean)
            self._update(prefix, "var", var)
        else:
            mean, var = self.stats[f"{prefix}.mean"], self.stats[f"{prefix}.var"]
        inv = torch.rsqrt(var + EPS)
        return (x - mean) * (inv * self.p[f"{prefix}.scale"]) + self.p[f"{prefix}.bias"]

    def scale_only(self, x, prefix: str):
        if self.train:
            ms = (x * x).mean(dim=(0, 1, 2))
            self._update(prefix, "var", ms)
        else:
            ms = self.stats[f"{prefix}.var"]
        return x * (self.p[f"{prefix}.scale"] * torch.rsqrt(ms + EPS))


def _pw(x, w):
    return x @ w[0, 0]


def _conv(x, w, stride: int, groups: int = 1):
    return F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                    stride=stride, padding=1, groups=groups).permute(0, 2, 3, 1)


def _act(x, s, round_fn, restore=None):
    """The LSQ 7-level activation: clip(round_fn(x/s), 0, 6)·s (or
    ·`restore`), the rounding straight through before the clip."""
    z = _Div.apply(x, s)
    zq = _clip(_ste(z, round_fn(z)), 0.0, 6.0)
    return zq * (s if restore is None else restore)


def _grid16(x):
    return _ste(x, torch.trunc(torch.clamp(x, -GRID16, GRID16) * 16.0) / 16.0)


def forward(p: Dict[str, torch.Tensor], stats: Dict[str, torch.Tensor],
            images: torch.Tensor, cfg: dict, *, train: bool = True,
            low: bool = False) -> torch.Tensor:
    """Logits (B, classes) float32 of normalized (B, H, W, 3) float32 images
    (see the module docstring). In training the norms use batch statistics
    and update `stats` in place, after the folds have read them. `low` is refused: a float32 configuration's control is TF32,
    switched around the run."""
    if cfg["dtype"] != "float32" or low:
        raise ValueError("the engine-friendly reference runs float32 alone, "
                         f"not {cfg['dtype']!r} (low={low})")
    net = _Net(p, stats, train)
    x = images.to(torch.float32)
    x = _grid16(net.bn(_conv(x, net.fold("stem_w", "stem_bn", 16.0), 2),
                       "stem_bn"))
    for i, (_, mid, _, stride, _, _) in enumerate(blocks(cfg)):
        b = f"blocks.{i}"
        s1, s2 = torch.exp(p[f"{b}.qlog1"]), torch.exp(p[f"{b}.qlog2"])
        we = net.fold(f"{b}.pw_expand_w", f"{b}.bn1", 64.0, out_mul=1.0 / s1)
        wd = net.fold(f"{b}.dw_w", f"{b}.bn2", 64.0, out_mul=s1 / s2)
        wp = net.fold(f"{b}.pw_project_w", f"{b}.bn3", 64.0, in_mul=s2)
        h = _act(net.bn(_pw(x, we), f"{b}.bn1"), s1, torch.round)
        h = _conv(h, wd, stride, groups=mid)
        h = _act(net.scale_only(h, f"{b}.bn2"), s2, torch.floor)
        x = _grid16(net.scale_only(_pw(h, wp), f"{b}.bn3"))
    s3 = _clip(torch.exp(p["final_qlog"]), 1.0 / 64.0, 127.0 / 64.0)
    wf = net.fold("final_w", "final_bn", 64.0, out_mul=1.0 / s3)
    cls_w = p["cls_w"]
    with torch.no_grad():
        cls_q = torch.clamp(torch.round(cls_w * 64.0), -127.0, 127.0) / 64.0
    restore = _ste(s3, torch.round(s3 * 64.0) / 64.0)
    x = _act(net.bn(_pw(x, wf), "final_bn"), s3, torch.round, restore=restore)
    x = x.mean(dim=(1, 2))
    return x @ _ste(cls_w, cls_q).T + p["cls_b"]


def forward_macs(cfg: dict) -> float:
    """Multiply-adds of one forward at cfg["input_size"]: the stem; per
    block the expand at its input size, the depthwise and project at the
    strided size (no residual add, no dense projection); the final 1×1
    conv; the classifier."""
    t = VARIANTS[cfg["variant"]]
    h = (cfg["input_size"] - 1) // 2 + 1
    macs = h * h * t["conv_channels"] * 27
    for cin, mid, out, stride, _, _ in blocks(cfg):
        macs += h * h * cin * mid
        h = (h - 1) // stride + 1
        macs += h * h * (mid * 9 + mid * out)
    macs += h * h * blocks(cfg)[-1][2] * t["final_channels"]
    return float(macs + t["final_channels"] * cfg["num_classes"])
