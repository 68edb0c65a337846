"""Split the int8 NNUE serve path by stage and time each at serving batch.

    python -m nnue_vision_tpu_torch.profile_nnue_split [BATCH] [--device cuda]

Port of `scripts/profile_nnue_split.py`, at the flagship widths of
`config/train_nnue.py` (800 features, L1 1024, L2 128, L3 32, 10 classes,
32×32) with weights from `nnue_init` (torch generator, seed 0) through
`nnue_quantize`. The inputs are four buffers of `normalize_images` of
numpy-random images (seed 0), cycled through by the reps. Stages:

  conv_f32              the exact integer conv as the port serves it: one
                        float64 GEMM of the quantized patches
                        (`engine_sim._int_conv3x3`)
  conv_bf16             the same conv with bfloat16 feeds and float32 sums
                        (JAX's bf16 MXU conv; built here, not in the
                        package): one bf16 tensor-core GEMM, `torch.mm`
                        with `out_dtype=float32`, on the card; on the CPU
                        the same sums in float32. Exact while |qx| ≤ 256
  head_pallas           the head kernel (K2) alone on precomputed conv
                        accumulators (`nnue_kernels.fused_head_call`, JAX
                        `_fused_head_call`)
  xla_full              the plain sim (`engine_sim.nnue_engine_forward`)
  xla_full_bf16conv     the plain sim on the bf16 conv
  pallas_full           `nnue_engine_forward_fused`: the exact conv, then K2
  pallas_full_bf16conv  the bf16 conv, then K2
  pallas_serve_bf16conv the same without the active counts
  mega_full             `nnue_engine_forward_mega` (K1), image to logits
  mega_serve            the same without the active counts

and the flags `bf16_conv_exact` (conv_bf16 equal to conv_f32 on the first
buffer) and `mega_exact` (K1's logits equal to the sim's there). The JAX
probe's `mega_serve_tile*` and `pallas_tile*` rows swept a Pallas batch
tile; K1 and K2 choose their own tile from the batch and the shared memory,
so `mega_tile` reports K1's (images per tile, product rows, ring slots,
staged pairs, blocks per tile, shared-memory bytes) once, and no knob
exists.

Each stage is timed by `ops/timing.py`: a CUDA graph of 400 calls,
best of 3 replays. Prints one JSON object: each stage's `*_ms`,
`*_images_per_sec` and `*_bound_ms` (the images read once, the weights the
stage reads and its output written once over the card's 3.35 TB/s, or its
work where that takes longer: the conv's multiply-adds and the head's
active FT rows and dense layers, counted on this run's images, at the
dense int8 rate, the bf16 conv's at the dense bf16 rate), the mean active
features per image, the flags, and the card's name and power limit (null
on the CPU, whose host-clock times are for the tests only).
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import sys
from typing import Callable, Dict

import numpy as np
import torch

from nnue_vision_tpu_torch.data.augment import normalize_images
from nnue_vision_tpu_torch.models.nnue import (
    GridFeatureSet,
    NNUEConfig,
    nnue_init,
    nnue_quantize,
)
from nnue_vision_tpu_torch.ops import nnue_kernels as nk
from nnue_vision_tpu_torch.ops.engine_sim import (
    NNUESimCfg,
    _int_conv3x3,
    _quantize_input,
    conv_epilogue,
    conv_out_hw,
    engine_conv_stride,
    grid_buffer,
    nnue_engine_forward,
    nnue_sim_params,
    nnue_tail,
)
from nnue_vision_tpu_torch.ops.timing import bound_ms, card, chained_best_ms, nbytes

FLAGSHIP = NNUEConfig(  # config/train_nnue.py
    feature_set=GridFeatureSet(grid_size=10, num_features_per_square=8),
    l1_size=1024, l2_size=128, l3_size=32, num_classes=10, input_size=32,
)
N_BUF = 4
STAGES = ("conv_f32", "conv_bf16", "head_pallas", "xla_full",
          "xla_full_bf16conv", "pallas_full", "pallas_full_bf16conv",
          "pallas_serve_bf16conv", "mega_full", "mega_serve")
# the JAX rows with no counterpart, and why
NOTES = {
    "conv_f32": "the port's exact conv is a float64 GEMM, not XLA's f32 conv",
    "conv_bf16": "built in the probe (the package has no conv_mode): a bf16 "
                 "tensor-core GEMM with float32 output",
    "xla_full": "the plain-torch sim (`nnue_engine_forward`), not XLA",
    "mega_serve_tile": "no counterpart: K1 picks its tile from the batch; "
                       "mega_tile is that tile",
    "pallas_tile": "no counterpart: K2 picks its tile from the batch",
}


def serve_model(model_cfg: NNUEConfig, device, seed: int = 0):
    """(sim params, sim cfg, K2 head params) of `model_cfg` at `nnue_init`
    weights (torch generator `seed`) through `nnue_quantize`."""
    model = nnue_init(model_cfg, torch.Generator().manual_seed(seed),
                      device=device)
    sim, cfg = nnue_sim_params(nnue_quantize(model), device=device)
    return sim, cfg, nk.pallas_head_params(sim)


def input_buffers(batch: int, h: int, w: int, device, seed: int = 0,
                  n_buf: int = N_BUF) -> torch.Tensor:
    """(n_buf, batch, h, w, 3) normalized float32 images."""
    raw = np.random.default_rng(seed).random((n_buf, batch, h, w, 3),
                                             dtype=np.float32)
    return normalize_images(torch.from_numpy(raw).to(device)).contiguous()


def conv_f32(sim: Dict, x: torch.Tensor, cfg: NNUESimCfg) -> torch.Tensor:
    """The exact conv accumulator (B, oh, ow, C) with bias, as float32."""
    stride = engine_conv_stride(x.shape[1], cfg.grid_size)
    qin = _quantize_input(x, cfg.conv_scale)
    return _int_conv3x3(qin, sim["conv_w"], sim["conv_b"], stride).to(
        torch.float32)


def conv_bf16(sim: Dict, x: torch.Tensor, cfg: NNUESimCfg) -> torch.Tensor:
    """The conv with the quantized input and the weights rounded to
    bfloat16 and the products summed in float32 (JAX `conv_bf16`): one
    GEMM of the (B·oh·ow, 27) patches. Every sum is exact below 2^24, so
    the card's bf16 tensor cores and the CPU's float32 give the same bits."""
    b, h, w, cin = x.shape
    stride = engine_conv_stride(h, cfg.grid_size)
    oh, ow = conv_out_hw(h, w, stride)
    c = sim["conv_w"].shape[0]
    qpad = torch.zeros((b, h + 2, w + 2, cin), dtype=torch.bfloat16,
                       device=x.device)
    qpad[:, 1:h + 1, 1:w + 1] = _quantize_input(x, cfg.conv_scale)
    patches = qpad.unfold(1, 3, stride).unfold(2, 3, stride).reshape(
        b * oh * ow, cin * 9)
    wt = sim["conv_w"].reshape(c, cin * 9).to(torch.bfloat16).T
    if x.is_cuda:
        acc = torch.mm(patches, wt, out_dtype=torch.float32)
    else:
        acc = patches.to(torch.float32) @ wt.to(torch.float32)
    return acc.reshape(b, oh, ow, c) + sim["conv_b"].to(torch.float32)


def _acc_i32(conv: torch.Tensor) -> torch.Tensor:
    """(B, oh, ow, C) float32 accumulator → (B, FR) int32, K2's input."""
    return conv.reshape(conv.shape[0], -1).to(torch.int32).contiguous()


def sim_bf16conv(sim: Dict, x: torch.Tensor, cfg: NNUESimCfg) -> torch.Tensor:
    """The plain sim's logits on the bf16 conv (JAX `nnue_engine_forward`
    with `conv_mode="bf16"`)."""
    vals = conv_epilogue(_acc_i32(conv_bf16(sim, x, cfg)), cfg.conv_scale)
    logits, _ = nnue_tail(sim, grid_buffer(vals, cfg.num_features),
                          sim["visual_threshold"], cfg)
    return logits


def head_on(head: Dict, acc: torch.Tensor, cfg: NNUESimCfg,
            with_count: bool = True) -> torch.Tensor:
    """K2's logits on a (B, FR) int32 accumulator."""
    return nk.fused_head_call(head, acc, cfg=cfg,
                              n_pad=cfg.num_features - acc.shape[1],
                              conv_scale=cfg.conv_scale,
                              with_count=with_count)[0]


def stages(sim: Dict, cfg: NNUESimCfg, head: Dict, mega: Dict,
           data: torch.Tensor) -> Dict[str, Callable]:
    """{stage: a call of no argument} cycling through the buffers of
    `data` (n_buf, B, H, W, 3); `head_pallas` cycles through their conv
    accumulators, the mega stages through their flat (B, H·W·3) views."""
    h, w = data.shape[2], data.shape[3]
    kw = dict(cfg=cfg, image_h=h, image_w=w)

    def cycle(fn, bufs):
        it = itertools.cycle(list(bufs))
        return lambda: fn(next(it))

    accs = [_acc_i32(conv_f32(sim, x, cfg)) for x in data]
    flat = data.reshape(data.shape[0], data.shape[1], h * w * 3)
    return {
        "conv_f32": cycle(lambda x: conv_f32(sim, x, cfg), data),
        "conv_bf16": cycle(lambda x: conv_bf16(sim, x, cfg), data),
        "head_pallas": cycle(lambda a: head_on(head, a, cfg), accs),
        "xla_full": cycle(lambda x: nnue_engine_forward(sim, x, **kw)[0], data),
        "xla_full_bf16conv": cycle(lambda x: sim_bf16conv(sim, x, cfg), data),
        "pallas_full": cycle(
            lambda x: nk.nnue_engine_forward_fused(sim, head, x, **kw)[0], data),
        "pallas_full_bf16conv": cycle(
            lambda x: head_on(head, _acc_i32(conv_bf16(sim, x, cfg)), cfg), data),
        "pallas_serve_bf16conv": cycle(
            lambda x: head_on(head, _acc_i32(conv_bf16(sim, x, cfg)), cfg,
                              with_count=False), data),
        "mega_full": cycle(
            lambda x: nk.nnue_engine_forward_mega(mega, x, **kw)[0], flat),
        "mega_serve": cycle(
            lambda x: nk.nnue_engine_forward_mega(mega, x, with_count=False,
                                                  **kw)[0], flat),
    }


def stage_bounds(sim: Dict, cfg: NNUESimCfg, x: torch.Tensor,
                 active: float) -> Dict[str, tuple]:
    """{stage: (ms, "bytes" or "operations")} for one buffer `x`
    (B, H, W, 3), `active` the mean active features per image: what each
    stage reads once and writes once, and its multiply-adds (two
    operations each) at the dense int8 rate, or the bf16 conv's at the
    dense bf16 rate."""
    b, h, w, _ = x.shape
    oh, ow = conv_out_hw(h, w, engine_conv_stride(h, cfg.grid_size))
    fr = oh * ow * cfg.channels
    conv_w = nbytes(sim["conv_w"], sim["conv_b"])
    head_w = nbytes(*(sim[k] for k in ("ft_w", "ft_b", "fc1_w", "fc1_b",
                                       "fc2_w", "fc2_b", "out_w", "out_b")))
    conv_ops = 2 * b * fr * 27
    dense = cfg.l1 * cfg.l2 + cfg.l2 * cfg.l3 + cfg.l3 * cfg.num_classes
    head_ops = b * active * cfg.l1 + 2 * b * dense
    logits, count = b * cfg.num_classes * 4, b * 4
    acc = b * fr * 4
    full_bytes = nbytes(x) + conv_w + head_w + logits + count
    full = bound_ms(full_bytes, int8_ops=conv_ops + head_ops)
    full_bf16 = bound_ms(full_bytes, bf16_flops=conv_ops, int8_ops=head_ops)
    return {"conv_f32": bound_ms(nbytes(x) + conv_w + acc, int8_ops=conv_ops),
            "conv_bf16": bound_ms(nbytes(x) + conv_w + acc, bf16_flops=conv_ops),
            "head_pallas": bound_ms(acc + head_w + logits + count,
                                    int8_ops=head_ops),
            "xla_full": full, "xla_full_bf16conv": full_bf16, "pallas_full": full,
            "pallas_full_bf16conv": full_bf16,
            "pallas_serve_bf16conv": bound_ms(full_bytes - count,
                                              bf16_flops=conv_ops,
                                              int8_ops=head_ops),
            "mega_full": full,
            "mega_serve": bound_ms(full_bytes - count, int8_ops=conv_ops + head_ops)}


def mega_tile(batch: int, cfg: NNUESimCfg, h: int, w: int, device):
    """K1's tile at this batch, as the launcher picks it (null on the CPU)."""
    if torch.device(device).type != "cuda":
        return None
    from nnue_vision_tpu_torch.ops._build import load_library

    oh, ow = conv_out_hw(h, w, engine_conv_stride(h, cfg.grid_size))
    info = (ctypes.c_int * 6)()
    if load_library().lib.nnue_mega_tile(batch, oh * ow * cfg.channels, cfg.l1,
                                         cfg.l2, cfg.l3, cfg.channels, h, w,
                                         info) != 0:
        raise RuntimeError("nnue_mega_tile: no tile fits")
    return dict(zip(("images", "rows", "slots", "pair_bufs", "split",
                     "smem_bytes"), list(info)))


def run(batch: int = 8192, device="cuda", reps: int = 400,
        model_cfg: NNUEConfig = FLAGSHIP) -> dict:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA asked for, but not available on this host")
    h = w = model_cfg.input_size
    sim, cfg, head = serve_model(model_cfg, dev)
    mega = nk.mega_head_params(sim, cfg, h, w)
    data = input_buffers(batch, h, w, dev)
    x0 = data[0]
    ref, _, count = nnue_engine_forward(sim, x0, cfg=cfg, image_h=h, image_w=w)
    mega_logits = nk.nnue_engine_forward_mega(
        mega, x0.reshape(batch, -1), cfg=cfg, image_h=h, image_w=w)[0]
    active = float(count.double().mean())
    out = {"batch": batch, "device": str(dev), "card": card(dev), "reps": reps,
           "bf16_conv_exact": bool(torch.equal(conv_f32(sim, x0, cfg),
                                               conv_bf16(sim, x0, cfg))),
           "mega_exact": bool(torch.equal(mega_logits, ref)),
           "active_features_per_image": active,
           "mega_tile": mega_tile(batch, cfg, h, w, dev), "notes": NOTES}
    bounds = stage_bounds(sim, cfg, x0, active)
    for name, fn in stages(sim, cfg, head, mega, data).items():
        ms = chained_best_ms(fn, reps)
        out[name + "_ms"] = ms
        out[name + "_images_per_sec"] = batch / (ms / 1e3)
        out[name + "_bound_ms"], out[name + "_bound_by"] = bounds[name]
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("batch", nargs="?", type=int, default=8192)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    print(json.dumps(run(args.batch, args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
