#!/usr/bin/env python3
"""Drive the PyTorch port's int8 NNUE serving path, its NNUE training path,
its EtinyNet int8 serving path, its EtinyNet training path and its
profiling path once on one CUDA card.

    python3 chip_smoke.py        # from the repository root

Phases, one line each (any failure raises and exits non-zero):

1. device    require CUDA; print the card (nvidia-smi), torch and CUDA versions
2. build     nvcc-build the kernels from nnue_vision_tpu_torch/csrc
3. model     flagship-width NNUE (config/train_nnue.py widths) from a numpy
             seed → nnue_quantize → write_nnue → read_nnue → nnue_sim_params
4. serve     batches of 1, 37, 512 and 8192 normalized 32×32 images through
             every entry point; each result torch.equal to its plain version
5. stress    phase 4 at batch 512 for a random int model at full width, with
             a negative threshold and int16 FT weights (padding features
             active, FT sums wrap)
6. evaluate  evaluate_int8_sim with use_pallas="mega" and True equal to False
7. launches  both kernels launched during phases 4-6 (the main path)
8. timing    kernel vs plain version at batch 8192 (and the mega kernel at 1
             and 512), CUDA events, median of 20 in turns
9. pipeline  the light-pipeline kernel (K3) on the 20,000 synthetic-hard
             training images at batch 512 and 37, with flips, holes and
             brightness/contrast drawn, torch.equal to its plain version;
             identity params equal normalize_images of the gathered rows
10. train    train_model on config/train_nnue_hard.py (full width, batch
             512), one epoch = 39 fused steps, compiled_backend "mega"; K3
             launched 39 times and K1 in the int8 eval, finite losses,
             best_model.ckpt written; on the checkpointed model the mega int8
             metrics and counts equal the plain sim's
11. launches all three kernels launched on their paths (serving: 4-6,
             training: 10)
12. timing   K3 vs plain at batch 512 and 8192 (CUDA events, median of 20 in
             turns); ms per train step over a 39-step chunk (host clock, one
             sync at the end)
13. etiny-serve  a 0.98M-width EtinyNet from a numpy seed (random weights and
             norm statistics) → etinynet_quantize → write_etiny → read_etiny,
             and a stress model at full int8 ranges; batches 1, 37, 1024 and
             8192 through etiny_forward_kernel (K6, one launch per LB block),
             each torch.equal to the engine sim
14. augment  on synthetic-hard 32×32 images at batch 1024 and 37: K4 on drawn
             heavy-tier maps, rot90/flip-only maps and out-of-frame maps; K5,
             both variants, with every gate on, drawn, and off (identity);
             each torch.equal to its plain version
15. etiny-train  train_model on config/train_etinynet.py (0.98M, bf16, heavy
             tier, batch 1024) on 50,000 synthetic-hard images for one epoch
             of 48 steps: K4 and K5 each launched 96 times, finite losses,
             best_model.ckpt written; on the checkpointed model K6's int8
             logits equal the sim's on the val split
16. launches the three kernels launched on their paths (serving: 13,
             training: 15)
17. timing   K4, K5 (each variant) and K6 (the whole int8 forward, and its 12
             LB blocks alone) vs plain at batch 1024 and 8192; ms per EtinyNet train step at batch 1024
             over 48 steps (host clock, one sync at the end)
18. mega-bisect  the cut mega kernel (K7) at levels 0-3 on the flagship and
             the stress model (negative threshold: the padding sum is on) at
             batch 8192 and 37, each torch.equal to nnue_mega_stage_reference;
             then profile_mega_bisect's timing at batch 8192 (counted)
19. warp-split  lerp_pass and nogather_pass (K8) on drawn heavy-tier maps and
             out-of-frame maps (zero fill) at batch 1024 and 37, each
             torch.equal to its plain version, and the five-stage
             composition equal to warp_bilinear; then profile_warp_split's
             variants at batch 1024 (counted)
20. trace    train_model on config/train_nnue_test.py with the light tier on
             (the fused K3 path) and profile_dir: the trace file names
             light_pipeline_kernel among its CUDA kernels
21. launches the three probe kernels launched on their paths (18, 19); the
             counts are host calls: a CUDA graph's replays add none

Then one JSON line with each kernel's launches, error and times (kernel,
plain version, the card's bound for the same work and, where one PyTorch
call computes the same function, that call; K6's are its 12 LB blocks
alone at batch 8192, K7's level 3), the card's name and power limit, and
the last line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from nnue_vision_tpu_torch import (
    QConv,
    QFeatureTransformer,
    QLBBlock,
    QLinear,
    QuantizedEtinyNet,
    QuantizedNNUE,
    read_etiny,
    read_nnue,
    write_etiny,
    write_nnue,
)
from config import load_config
from nnue_vision_tpu_torch import profile_mega_bisect, profile_warp_split
from nnue_vision_tpu_torch.bridge import nnue_from_jax_params
from nnue_vision_tpu_torch.data import augment as aug
from nnue_vision_tpu_torch.data.augment import normalize_images
from nnue_vision_tpu_torch.data.datasets import GenericVisionDataset
from nnue_vision_tpu_torch.models.etinynet import (
    EtinyNet,
    EtinyNetConfig,
    etinynet_quantize,
)
from nnue_vision_tpu_torch.models.nnue import (
    GridFeatureSet,
    NNUEConfig,
    nnue_quantize,
)
from nnue_vision_tpu_torch.ops import etiny_kernels as ek
from nnue_vision_tpu_torch.ops import input_pipeline as ip
from nnue_vision_tpu_torch.ops import nnue_kernels as nk
from nnue_vision_tpu_torch.ops import photometric_kernel as pk
from nnue_vision_tpu_torch.ops import warp_kernel as wk
from nnue_vision_tpu_torch.ops._build import load_library
from nnue_vision_tpu_torch.ops.timing import HBM_BYTES_PER_S, nbytes
from nnue_vision_tpu_torch.ops.engine_sim import (
    conv_out_hw,
    engine_conv_stride,
    etiny_engine_forward,
    etiny_sim_params,
    etiny_stem,
    nnue_conv_buffer,
    nnue_engine_forward,
    nnue_sim_params,
)
from nnue_vision_tpu_torch.training.checkpoint import (
    etinynet_from_checkpoint,
    load_checkpoint,
    nnue_from_checkpoint,
)
from nnue_vision_tpu_torch.training.evaluate import evaluate_int8_sim
from nnue_vision_tpu_torch.training.loop import train_model
from nnue_vision_tpu_torch.training.optim import create_optimizer
from nnue_vision_tpu_torch.training.step import (
    gathered_train_step,
    make_train_state,
    scanned_train_steps_fused,
)

SEED = 42
H = W = 32
SERVE_BATCHES = (1, 37, 512, 8192)
TIMING_BATCH = 8192
TIMING_RUNS = 20
FLAGSHIP = NNUEConfig(  # config/train_nnue.py
    feature_set=GridFeatureSet(grid_size=10, num_features_per_square=8),
    l1_size=1024, l2_size=128, l3_size=32, num_classes=10, input_size=32,
    qat=True,
)
TRAIN_CONFIG = "config/train_nnue_hard.py"
PIPELINE_BATCHES = (512, 37)
PIPELINE_TIMING_BATCHES = (512, 8192)
ETINY_CONFIG = "config/train_etinynet.py"
ETINY_TRAIN_SIZE = 50000  # CIFAR-10's train split, in synthetic-hard images
ETINY_SERVE_BATCHES = (1, 37, 1024, 8192)
AUGMENT_BATCHES = (1024, 37)
ETINY_TIMING_BATCHES = (1024, 8192)
GATES = {"medium": [0, 3, 7, 8, 10, 11, 15, 20, 22, 23],
         "heavy_extra": [0, 3, 7, 8, 10, 11]}
SOURCES = {
    "nnue_mega_kernel": "nnue_vision_tpu_torch/csrc/nnue_head.cu",
    "nnue_head_kernel": "nnue_vision_tpu_torch/csrc/nnue_head.cu",
    "light_pipeline_kernel": "nnue_vision_tpu_torch/csrc/light_pipeline.cu",
    "warp_kernel": "nnue_vision_tpu_torch/csrc/warp.cu",
    "photometric_kernel": "nnue_vision_tpu_torch/csrc/photometric.cu",
    "etiny_block_kernel": "nnue_vision_tpu_torch/csrc/etiny_block.cu",
    "nnue_mega_stage_kernel": "nnue_vision_tpu_torch/csrc/nnue_head.cu",
    "lerp_pass_kernel": "nnue_vision_tpu_torch/csrc/warp.cu",
    "nogather_pass_kernel": "nnue_vision_tpu_torch/csrc/warp.cu",
}
REPLACES = {
    "nnue_mega_kernel": "nnue_vision_tpu/ops/pallas_kernels.py:161",
    "nnue_head_kernel": "nnue_vision_tpu/ops/pallas_kernels.py:156",
    "light_pipeline_kernel": "nnue_vision_tpu/ops/input_pipeline.py:147",
    "warp_kernel": "nnue_vision_tpu/ops/warp_kernel.py:46",
    "photometric_kernel": "nnue_vision_tpu/ops/photometric_kernel.py:114",
    "etiny_block_kernel": "nnue_vision_tpu/ops/etiny_pallas.py:105",
    "nnue_mega_stage_kernel": "scripts/profile_mega_bisect.py:96",
    "lerp_pass_kernel": "nnue_vision_tpu/ops/warp_kernel.py:46",
    "nogather_pass_kernel": "scripts/profile_warp_split.py:51",
}
# The card's published rates (NVIDIA's data sheet; H100 SXM, 700 W) beside
# HBM_BYTES_PER_S: dense int8 tensor-core operations (the highest integer
# rate, so a time from it is a lower bound) and float32 outside the tensor
# cores.
INT_OPS_PER_S = 1979e12
F32_OPS_PER_S = 67e12
BISECT_REPS = 100
WARP_SPLIT_REPS = "100"
TRACE_CONFIG = "config/train_nnue_test.py"


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def flagship_params(rng: np.random.Generator, cfg: NNUEConfig) -> dict:
    """Random float params with the JAX package's init distributions."""
    fs = cfg.feature_set
    ch, l1, l2, l3, c = (fs.num_features_per_square, cfg.l1_size, cfg.l2_size,
                         cfg.l3_size, cfg.num_classes)

    def u(shape, fan_in):
        b = 1.0 / math.sqrt(fan_in)
        return rng.uniform(-b, b, shape).astype(np.float32)

    return {
        "conv_w": u((ch, 3, 3, 3), 27),
        "visual_threshold": np.full((ch,), 0.1, np.float32),
        "ft_w": (rng.standard_normal((fs.num_features, l1)) * 0.1).astype(np.float32),
        "ft_b": np.zeros((l1,), np.float32),
        "fc1_w": u((l2, l1), l1), "fc1_b": u((l2,), l1),
        "fc2_w": u((l3, l2), l2), "fc2_b": u((l3,), l2),
        "out_w": u((c, l3), l3), "out_b": u((c,), l3),
        "nnue2score": np.float32(600.0),
    }


def stress_model(rng: np.random.Generator, q):
    """conftest-style random integers at the flagship widths, with int16 FT
    weights large enough that the FT sums wrap, and a negative threshold."""
    def i8(*s):
        return rng.integers(-127, 128, s).astype(np.int8)

    def i32(*s, lo=-2000, hi=2000):
        return rng.integers(lo, hi, s).astype(np.int32)

    f, l1, l2, l3, c = q.num_features, q.l1, q.l2, q.l3, q.num_classes
    ch = q.num_features_per_square
    return QuantizedNNUE(
        grid_size=q.grid_size, num_features_per_square=ch, l1=l1, l2=l2, l3=l3,
        nnue2score=600.0, visual_threshold=-0.25,
        conv=QConv(weight=i8(ch, 3, 3, 3), bias=i32(ch, lo=-500, hi=500)),
        ft=QFeatureTransformer(
            weight=rng.integers(-30000, 30000, (f, l1)).astype(np.int16),
            bias=i32(l1)),
        fc1=QLinear(weight=i8(l2, l1), bias=i32(l2)),
        fc2=QLinear(weight=i8(l3, l2), bias=i32(l3)),
        out=QLinear(weight=i8(c, l3), bias=i32(c)),
    ).validate()


class Errors:
    """Largest |kernel - plain| seen per kernel (logits and counts)."""

    def __init__(self):
        self.max = {name: 0.0 for name in SOURCES}

    def equal(self, kernel: str, what: str, got, ref) -> None:
        if ref is None:
            check(got is None, f"{what}: expected None")
            return
        check(got.shape == ref.shape and got.dtype == ref.dtype,
              f"{what}: {got.dtype}{tuple(got.shape)} vs "
              f"{ref.dtype}{tuple(ref.shape)}")
        err = float((got.double() - ref.double()).abs().max()) if got.numel() else 0.0
        self.max[kernel] = max(self.max[kernel], err)
        check(torch.equal(got, ref), f"{what}: differs from plain (max {err})")
        if got.is_floating_point():
            check(bool(torch.isfinite(got).all()), f"{what}: non-finite values")

    def outputs(self, kernel: str, what: str, got, ref) -> None:
        names = ("logits", "density", "count") if len(ref) == 3 else \
            ("logits", "count")
        for name, g, r in zip(names, got, ref, strict=True):
            self.equal(kernel, f"{what} {name}", g, r)


def serve(errs: Errors, sim, cfg, batch: int, gen: torch.Generator,
          heads, tag: str) -> None:
    """One request batch through every entry point, each held to its plain
    version and to the engine sim."""
    mega, head = heads
    x = normalize_images(
        torch.rand((batch, H, W, 3), generator=gen, device="cuda")
    ).contiguous()
    flat = x.reshape(batch, -1)
    kw = dict(cfg=cfg, image_h=H, image_w=W)
    sim_out = nnue_engine_forward(sim, x, **kw)

    out = nk.nnue_engine_forward_mega(mega, flat, **kw)
    errs.outputs("nnue_mega_kernel", f"{tag} mega f32",
                 out, nk.nnue_engine_forward_mega_reference(mega, flat, **kw))
    errs.outputs("nnue_mega_kernel", f"{tag} mega vs sim", out, sim_out)
    check(out[0].shape == (batch, cfg.num_classes), "logits shape")

    lo = nk.nnue_engine_forward_mega(mega, flat, with_count=False, **kw)
    errs.outputs("nnue_mega_kernel", f"{tag} mega logits-only", lo,
                 (sim_out[0], None, None))

    qb = nk.quantize_images_for_mega(flat, cfg)
    qo = nk.nnue_engine_forward_mega(mega, qb, input_mode="qbf16", **kw)
    errs.outputs("nnue_mega_kernel", f"{tag} mega qbf16", qo,
                 nk.nnue_engine_forward_mega_reference(
                     mega, qb, input_mode="qbf16", **kw))
    errs.outputs("nnue_mega_kernel", f"{tag} mega qbf16 vs sim", qo, sim_out)

    fo = nk.nnue_engine_forward_fused(sim, head, x, **kw)
    errs.outputs("nnue_head_kernel", f"{tag} fused", fo,
                 nk.nnue_engine_forward_fused_reference(sim, head, x, **kw))
    errs.outputs("nnue_head_kernel", f"{tag} fused vs sim", fo, sim_out)

    buf = nnue_conv_buffer(sim, x, cfg=cfg, image_h=H)
    ho = nk.fused_nnue_head(head, buf, cfg=cfg)
    errs.outputs("nnue_head_kernel", f"{tag} fused_nnue_head", ho,
                 nk.fused_nnue_head_reference(head, buf, cfg=cfg))
    errs.outputs("nnue_head_kernel", f"{tag} fused_nnue_head vs sim", ho,
                 (sim_out[0], sim_out[2]))
    torch.cuda.synchronize()


def time_ms(fn) -> float:
    """One call's device time, CUDA events around it."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def time_pair(kernel_fn, plain_fn) -> tuple:
    """Median ms of each, measured in turns (plain, kernel, kernel, plain)."""
    for fn in (kernel_fn, plain_fn, kernel_fn, plain_fn):  # warm-up
        fn()
    torch.cuda.synchronize()
    k, p = [], []
    for i in range(TIMING_RUNS):
        order = ((p, plain_fn), (k, kernel_fn)) if i % 2 == 0 else \
            ((k, kernel_fn), (p, plain_fn))
        for sink, fn in order:
            sink.append(time_ms(fn))
    return statistics.median(k), statistics.median(p)


def time_median(fn) -> float:
    """Median ms of one call over TIMING_RUNS, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    return statistics.median(time_ms(fn) for _ in range(TIMING_RUNS))


def bound(moved: int, int_ops: float = 0.0, f32_ops: float = 0.0) -> tuple:
    """(ms, "bytes" or "operations"): the least time the card could take to
    move `moved` bytes (each input read once, each output written once) and
    do the operations, at the published rates."""
    t_bytes = moved / HBM_BYTES_PER_S
    t_ops = int_ops / INT_OPS_PER_S + f32_ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def head_int_ops(cfg, batch: int, n_act: int) -> int:
    """Integer operations of the NNUE head: the sparse FT row sum over the
    `n_act` active features of the batch, and the three dense layers."""
    dense = cfg.l1 * cfg.l2 + cfg.l2 * cfg.l3 + cfg.l3 * cfg.num_classes
    return n_act * cfg.l1 + 2 * batch * dense


def active_rows(count: torch.Tensor, head: dict, cfg) -> int:
    """Active features the FT sums in rows for this batch: the counts less
    the padding features, which the padding sum covers."""
    oh, ow = conv_out_hw(H, W, engine_conv_stride(H, cfg.grid_size))
    n_pad = cfg.num_features - oh * ow * cfg.channels
    pad = n_pad if head["thresh"] < 0 else 0
    return int(count.sum()) - pad * count.numel()


def pipeline(errs: Errors, dataset: torch.Tensor, gen: torch.Generator,
             batch: int) -> None:
    """K3 on one batch of drawn params, held to its plain version; every
    branch (flip, hole, brightness/contrast) must occur."""
    n, h, w, _ = dataset.shape
    params = ip.draw_light_params(gen, 1, batch, h, w)
    flip, pf, pi = params.flip[0], params.pf[0], params.pi[0]
    if batch < 100:  # force every branch into a small batch
        flip[:3] = torch.tensor([True, False, True])
        pf[0] = torch.tensor([1.08, -0.03])
        pi[1] = torch.tensor([3, 4, 10, 11], dtype=torch.int32)
    check(bool(flip.any()) and bool((~flip).any())
          and bool((pf[:, 0] != 1.0).any())
          and bool((pi[:, 1] > pi[:, 0]).any()), "a branch was not drawn")
    idx = torch.randint(0, n, (batch,), generator=gen)
    idx_eff = (idx + n * flip.to(torch.int64)).to(torch.int32).cuda()
    pf, pi = pf.cuda(), pi.cuda()
    got = ip.fused_light_pipeline(dataset, idx_eff, pf, pi, h=h, w=w)
    ref = ip.fused_light_pipeline_reference(dataset, idx_eff, pf, pi, h=h, w=w)
    errs.equal("light_pipeline_kernel", f"pipeline B={batch}", got, ref)
    check(got.shape == (batch, h, w, 3), "pipeline output shape")

    ident = ip.identity_light_params(1, batch)
    idx_c = idx.to(torch.int32).cuda()
    got = ip.fused_light_pipeline(dataset, idx_c, ident.pf[0].cuda(),
                                  ident.pi[0].cuda(), h=h, w=w)
    errs.equal("light_pipeline_kernel", f"pipeline identity B={batch}", got,
               normalize_images(dataset[idx.cuda()]))
    torch.cuda.synchronize()


def train(tmp: Path) -> dict:
    """One epoch of train_model on the training config at full width,
    counted from here: returns what the phase checks and prints."""
    cfg = load_config(TRAIN_CONFIG)
    cfg.max_epochs = 1
    cfg.compiled_backend = "mega"
    cfg.log_dir = str(tmp / "logs")
    os.environ["NV_SKIP_ENGINE"] = "1"
    nk.reset_launch_counts()
    ip.reset_launch_counts()
    t0 = time.perf_counter()
    check(train_model(cfg, "nnue", device="cuda") == 0, "train_model failed")
    seconds = time.perf_counter() - t0
    launches = {**nk.LAUNCHES, **ip.LAUNCHES}
    metrics = next((tmp / "logs" / "runs").glob("*/metrics.jsonl"))
    records = [json.loads(line) for line in metrics.read_text().splitlines()]
    losses = [r["train/loss"] for r in records if "train/loss" in r]
    epoch = next(r for r in records if "compiled/f1" in r)
    ckpt = next((tmp / "logs" / "checkpoints").glob("*/best_model.ckpt"))
    return dict(cfg=cfg, seconds=seconds, launches=launches, losses=losses,
                epoch=epoch, ckpt=ckpt)


def etiny_model(rng: np.random.Generator) -> EtinyNet:
    """A 0.98M-width EtinyNet with random weights in the JAX package's init
    ranges and random norm affines and running statistics."""
    model = EtinyNet(EtinyNetConfig(variant="0.98M", num_classes=10,
                                    input_size=H))
    state = {}
    for name, t in model.state_dict().items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("scale", "var"):
            value = rng.uniform(0.5, 1.5, t.shape)
        elif leaf in ("bias", "mean"):
            value = rng.uniform(-0.3, 0.3, t.shape)
        else:
            fan_in = t.shape[1] if leaf == "cls_w" else (
                t.shape[0] if leaf == "cls_b" else t.shape[0] * t.shape[1] * t.shape[2])
            b = 1.0 / math.sqrt(fan_in)
            value = rng.uniform(-b, b, t.shape)
        state[name] = torch.from_numpy(value.astype(np.float32))
    model.load_state_dict(state)
    return model


def etiny_stress_model(rng: np.random.Generator, q: QuantizedEtinyNet):
    """Random int8 weights over the full range and wide pw-expand biases at
    the widths and strides of `q`."""
    def i8(*s):
        return rng.integers(-127, 128, s).astype(np.int8)

    blocks = [QLBBlock(pw_expand=i8(b.mid_channels, b.in_channels),
                       dw=i8(b.mid_channels, 3, 3),
                       pw_project=i8(b.out_channels, b.mid_channels),
                       stride=b.stride, is_dense=b.is_dense,
                       pw_expand_bias=rng.integers(-300000, 300000, b.mid_channels
                                                   ).astype(np.int32))
              for b in q.blocks]
    return QuantizedEtinyNet(
        variant=q.variant, num_classes=q.num_classes, input_size=q.input_size,
        conv_channels=q.conv_channels, final_channels=q.final_channels,
        stem=QConv(weight=i8(*q.stem.weight.shape),
                   bias=rng.integers(-2000, 2000, q.conv_channels).astype(np.int32)),
        blocks=blocks,
        classifier=QLinear(weight=i8(*q.classifier.weight.shape),
                           bias=rng.integers(-30000, 30000, q.num_classes
                                             ).astype(np.int32),
                           scale=q.classifier.scale),
    ).validate()


def etiny_serve(errs: Errors, kp, sim, cfg, x: torch.Tensor, tag: str) -> None:
    """One batch through the EtinyNet serving entry point, held to the sim."""
    kw = dict(cfg=cfg, image_h=H, image_w=W)
    got = ek.etiny_forward_kernel(kp, x, **kw)
    errs.equal("etiny_block_kernel", f"{tag} etiny_forward_kernel vs sim", got,
               etiny_engine_forward(sim, x, **kw))
    check(got.shape == (x.shape[0], cfg.num_classes), "EtinyNet logits shape")


def augment(errs: Errors, images: torch.Tensor, gen: torch.Generator) -> None:
    """K4 and K5 on one batch, every case held to its plain version."""
    b = images.shape[0]
    draws = aug.draw_tier(gen, "heavy", b, H, W, "cuda")
    eye = torch.eye(2).expand(b, 2, 2)
    zero = torch.zeros((b, 2))

    def maps(m, v):
        return wk.pack_warp_params(*wk.warp_coefficients(
            m.contiguous(), v.contiguous(), H, W)).cuda()

    rot = aug.geom_rot90(torch.ones(b, dtype=torch.bool),
                         torch.randint(0, 4, (b,), generator=gen))
    flip = aug.geom_hflip(torch.rand(b, generator=gen) < 0.5)
    cases = {
        "heavy-tier maps (block 1)": draws.warp1,
        "heavy-tier maps (block 2)": draws.warp2,
        "rot90 maps": maps(*aug._mv_compose(flip, rot)),
        "out-of-frame maps": maps(eye, zero + torch.tensor([70.0, -90.0])),
    }
    for name, params in cases.items():
        got = wk.warp_bilinear(images, params)
        errs.equal("warp_kernel", f"B={b} warp {name}", got,
                   wk.warp_bilinear_reference(images, params))
    check(torch.equal(got, torch.zeros_like(got)), "out-of-frame warp not zero")
    rot_only = maps(*rot)
    k = torch.randint(0, 4, (1,), generator=gen).item()
    rot1 = maps(aug._ROT90[k].expand(b, 2, 2), zero)
    check(torch.equal(wk.warp_bilinear(images, rot1),
                      torch.rot90(images, k, (1, 2))),
          "rot90 warp differs from torch.rot90")
    errs.equal("warp_kernel", f"B={b} warp rot90-only", wk.warp_bilinear(
        images, rot_only), wk.warp_bilinear_reference(images, rot_only))

    noise = torch.randn(images.shape, generator=torch.Generator(
        device="cuda").manual_seed(b), device="cuda")
    for variant, (f, i) in (("medium", draws.photo1),
                            ("heavy_extra", draws.photo2)):
        on, off = f.clone(), f.clone()
        on[:, GATES[variant]] = 1.0
        off[:, GATES[variant]] = 0.0
        for gates, fp in (("on", on), ("drawn", f), ("off", off)):
            got = pk.photometric_block(images, noise, fp, i, variant=variant)
            errs.equal("photometric_kernel", f"B={b} {variant} gates {gates}",
                       got, pk.photometric_block_reference(
                           images, noise, fp, i, variant=variant))
        check(torch.equal(got, images), f"{variant} with every gate off "
              "is not the identity")
    torch.cuda.synchronize()


def etiny_train(tmp: Path) -> dict:
    """One epoch of train_model on the EtinyNet production config, counted
    from here: returns what the phase checks and prints."""
    cfg = load_config(ETINY_CONFIG)
    cfg.dataset_name = "synthetic-hard"
    cfg.synthetic_size = ETINY_TRAIN_SIZE
    cfg.max_epochs = 1
    cfg.log_dir = str(tmp / "logs")
    os.environ["NV_SKIP_ENGINE"] = "1"
    for module in (wk, pk, ek, ip, nk):
        module.reset_launch_counts()
    t0 = time.perf_counter()
    check(train_model(cfg, "etinynet", device="cuda") == 0,
          "train_model failed on the EtinyNet config")
    seconds = time.perf_counter() - t0
    launches = {**wk.LAUNCHES, **pk.LAUNCHES, **ek.LAUNCHES, **ip.LAUNCHES}
    metrics = next((tmp / "logs" / "runs").glob("*/metrics.jsonl"))
    records = [json.loads(line) for line in metrics.read_text().splitlines()]
    losses = [r["train/loss"] for r in records if "train/loss" in r]
    epoch = next(r for r in records if "compiled/f1" in r)
    ckpt = next((tmp / "logs" / "checkpoints").glob("*/best_model.ckpt"))
    return dict(cfg=cfg, seconds=seconds, launches=launches, losses=losses,
                epoch=epoch, ckpt=ckpt)


def main() -> int:
    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing run",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say("device", f"{smi} | torch {torch.__version__} | CUDA "
        f"{torch.version.cuda} | {torch.cuda.device_count()} device(s)")

    # 2. build
    built = load_library()
    ptxas = [ln.strip() for ln in built.log.splitlines()
             if "registers" in ln or "Compiling entry" in ln]
    say("build", f"{built.path.name} built in {built.seconds:.1f} s; "
        + " | ".join(ptxas))

    # 3. model
    rng = np.random.default_rng(SEED)
    model = nnue_from_jax_params(flagship_params(rng, FLAGSHIP), FLAGSHIP,
                                 device="cuda")
    q0 = nnue_quantize(model)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "flagship.nnue"
        write_nnue(q0, path)
        size = path.stat().st_size
        q = read_nnue(path)
    check(np.array_equal(q.ft.weight, q0.ft.weight)
          and q.visual_threshold == np.float32(q0.visual_threshold),
          ".nnue round trip changed the model")
    sim, cfg = nnue_sim_params(q, device="cuda")
    heads = (nk.mega_head_params(sim, cfg, H, W), nk.pallas_head_params(sim))
    say("model", f"F={q.num_features} L1={q.l1} L2={q.l2} L3={q.l3} "
        f"classes={q.num_classes} threshold={q.visual_threshold} "
        f"via {size}-byte .nnue")

    # 4. serve — the main path, counted from here to phase 7
    errs = Errors()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    nk.reset_launch_counts()
    for batch in SERVE_BATCHES:
        t0 = time.perf_counter()
        serve(errs, sim, cfg, batch, gen, heads, f"B={batch}")
        say("serve", f"B={batch}: mega f32/logits-only/qbf16, fused, "
            f"fused_nnue_head all equal to plain and sim (tolerance: none, "
            f"torch.equal) ({time.perf_counter() - t0:.2f} s)")

    # 5. stress
    qs = stress_model(np.random.default_rng(SEED + 1), q)
    ssim, scfg = nnue_sim_params(qs, device="cuda")
    sheads = (nk.mega_head_params(ssim, scfg, H, W), nk.pallas_head_params(ssim))
    serve(errs, ssim, scfg, 512, gen, sheads, "stress")
    x = normalize_images(torch.rand((512, H, W, 3), generator=gen, device="cuda"))
    _, _, count = nnue_engine_forward(ssim, x, cfg=scfg, image_h=H, image_w=W)
    oh, ow = conv_out_hw(H, W, engine_conv_stride(H, scfg.grid_size))
    n_pad = scfg.num_features - oh * ow * scfg.channels
    check(int(count.min()) >= n_pad, "padding features not active")
    say("stress", f"negative threshold, int16 FT weights: all equal; "
        f"counts {int(count.min())}..{int(count.max())} (n_pad {n_pad})")

    # 6. evaluate
    images = torch.rand((3, 256, H, W, 3), generator=gen, device="cuda")
    labels = torch.randint(0, cfg.num_classes, (3, 256), generator=gen,
                           device="cuda")
    loader = [(images[i].cpu().numpy(), labels[i].cpu().numpy())
              for i in range(3)]
    results = {mode: evaluate_int8_sim(model, loader, use_pallas=mode)
               for mode in (False, True, "mega")}
    keys = ("acc", "f1", "precision", "recall", "latent_density")
    for mode in (True, "mega"):
        check(all(results[mode][k] == results[False][k] for k in keys),
              f"evaluate_int8_sim use_pallas={mode!r} differs: "
              f"{results[mode]} vs {results[False]}")
    say("evaluate", "use_pallas=True and 'mega' equal False: "
        + json.dumps({k: results["mega"][k] for k in keys}))

    # 7. launches
    launches = {k: nk.LAUNCHES[k] for k in ("nnue_mega_kernel", "nnue_head_kernel")}
    check(all(n > 0 for n in launches.values()),
          f"a kernel of the path never launched: {launches}")
    say("launches", json.dumps(launches))

    # 8. timing
    x = normalize_images(
        torch.rand((TIMING_BATCH, H, W, 3), generator=gen, device="cuda")
    ).contiguous()
    flat = x.reshape(TIMING_BATCH, -1)
    kw = dict(cfg=cfg, image_h=H, image_w=W)
    mega, head = heads
    acc = nk._fused_acc(sim, x, cfg, H, W)
    hkw = dict(cfg=cfg, n_pad=cfg.num_features - acc.shape[1],
               conv_scale=cfg.conv_scale, with_count=True)
    ms = {}
    ms["nnue_mega_kernel"] = time_pair(
        lambda: nk.nnue_engine_forward_mega(mega, flat, **kw),
        lambda: nk.nnue_engine_forward_mega_reference(mega, flat, **kw))
    ms["nnue_head_kernel"] = time_pair(
        lambda: nk._head_launch(head, acc, **hkw),
        lambda: nk._head_plain(head, acc, **hkw))
    qb = nk.quantize_images_for_mega(flat, cfg)
    ms_qbf16 = time_pair(
        lambda: nk.nnue_engine_forward_mega(mega, qb, input_mode="qbf16", **kw),
        lambda: nk.nnue_engine_forward_mega_reference(
            mega, qb, input_mode="qbf16", **kw))
    ms_fused = time_pair(
        lambda: nk.nnue_engine_forward_fused(sim, head, x, **kw),
        lambda: nk.nnue_engine_forward_fused_reference(sim, head, x, **kw))
    rows = [(TIMING_BATCH, "mega f32", ms["nnue_mega_kernel"]),
            (TIMING_BATCH, "mega qbf16", ms_qbf16),
            (TIMING_BATCH, "head kernel", ms["nnue_head_kernel"]),
            (TIMING_BATCH, "fused (conv + head)", ms_fused)]
    for batch in (1, 512):  # small batches: host cost per call shows here
        rows.append((batch, "mega f32", time_pair(
            lambda b=batch: nk.nnue_engine_forward_mega(mega, flat[:b], **kw),
            lambda b=batch: nk.nnue_engine_forward_mega_reference(
                mega, flat[:b], **kw))))
    for batch, name, (k, p) in rows:
        say("timing", f"B={batch} {name}: kernel {k:.4f} ms "
            f"({batch / k * 1e3:,.0f} img/s), plain {p:.4f} ms "
            f"({batch / p * 1e3:,.0f} img/s) on {smi}")
    # the card's bound for the timed calls; no single PyTorch call computes
    # the int8 engine, so neither kernel has a library time
    n_act = active_rows(nk.nnue_engine_forward_mega(mega, flat, **kw)[2], mega, cfg)
    head_bytes = nbytes(*(mega[k] for k in nk._HEAD_KEYS), mega["padsum"])
    out_bytes = TIMING_BATCH * (cfg.num_classes + 1) * 4  # logits, count
    head_ops = head_int_ops(cfg, TIMING_BATCH, n_act)
    conv_ops = 2 * 27 * acc.numel()
    bounds = {
        "nnue_mega_kernel": bound(
            nbytes(flat, mega["conv_w"], mega["conv_b"]) + head_bytes + out_bytes,
            int_ops=conv_ops + head_ops, f32_ops=flat.numel()),
        "nnue_head_kernel": bound(nbytes(acc) + head_bytes + out_bytes,
                                  int_ops=head_ops),
    }
    library = {"nnue_mega_kernel": None, "nnue_head_kernel": None}

    # 9. pipeline
    ds = GenericVisionDataset("synthetic-hard", split="train",
                              synthetic_size=20000, seed=42)
    dataset = ip.prepare_gather_dataset(torch.from_numpy(ds.images).cuda())
    pgen = torch.Generator().manual_seed(SEED)
    for batch in PIPELINE_BATCHES:
        pipeline(errs, dataset, pgen, batch)
    say("pipeline", f"N={dataset.shape[0]} ({dataset.numel() * 4 / 1e6:.1f} MB "
        f"on the card), B={PIPELINE_BATCHES}: kernel equal to plain and "
        "identity equal to normalize_images (tolerance: none, torch.equal)")

    # 10. train — the training path, counted from here to its end
    with tempfile.TemporaryDirectory() as tmp:
        tr = train(Path(tmp))
        losses = tr["losses"]
        check(len(losses) == 39 and all(math.isfinite(v) for v in losses),
              f"expected 39 finite losses, got {losses}")
        check(tr["launches"]["light_pipeline_kernel"] == 39,
              f"K3 launched {tr['launches']['light_pipeline_kernel']} times, "
              "not once per fused step")
        check(tr["launches"]["nnue_mega_kernel"] > 0, "K1 not launched by the eval")
        payload = load_checkpoint(tr["ckpt"])
    trained = nnue_from_checkpoint(payload, device="cuda")
    val = GenericVisionDataset("synthetic-hard", split="test",
                               synthetic_size=20000, seed=42)
    vloader = [(val.images[i:i + 1024], val.labels[i:i + 1024])
               for i in range(0, len(val.labels), 1024)]
    int8 = {mode: evaluate_int8_sim(trained, vloader, use_pallas=mode)
            for mode in ("mega", False)}
    keys = ("acc", "f1", "precision", "recall", "latent_density")
    check(all(int8["mega"][k] == int8[False][k] for k in keys),
          f"mega int8 metrics differ from sim: {int8}")
    tsim, tqcfg = nnue_sim_params(nnue_quantize(trained), device="cuda")
    thead = nk.mega_head_params(tsim, tqcfg, H, W)
    for i in range(0, len(val.labels), 1024):
        x = normalize_images(torch.from_numpy(val.images[i:i + 1024]).cuda())
        _, _, c_mega = nk.nnue_engine_forward_mega(
            thead, x.reshape(x.shape[0], -1).contiguous(), cfg=tqcfg,
            image_h=H, image_w=W)
        _, _, c_sim = nnue_engine_forward(tsim, x, cfg=tqcfg, image_h=H, image_w=W)
        errs.equal("nnue_mega_kernel", "trained model counts", c_mega, c_sim)
    say("train", f"{TRAIN_CONFIG}, 1 epoch of {len(losses)} fused steps at "
        f"batch {tr['cfg'].batch_size} in {tr['seconds']:.2f} s (train_model, "
        f"data generation included); loss first {losses[0]:.4f} last "
        f"{losses[-1]:.4f}; val acc {tr['epoch']['val/accuracy']:.4f}, "
        f"compiled acc {tr['epoch']['compiled/accuracy']:.4f}; checkpoint "
        "int8 mega == sim: " + json.dumps({k: int8["mega"][k] for k in keys}))

    # 11. launches
    train_launches = tr["launches"]
    say("launches", "serving " + json.dumps(launches) + "; training "
        + json.dumps(train_launches))
    launches["light_pipeline_kernel"] = train_launches["light_pipeline_kernel"]

    # 12. timing
    for batch in PIPELINE_TIMING_BATCHES:
        params = ip.draw_light_params(pgen, 1, batch, H, W)
        idx = torch.randint(0, dataset.shape[0], (batch,), generator=pgen)
        args = ((idx + dataset.shape[0] * params.flip[0]).to(torch.int32).cuda(),
                params.pf[0].cuda(), params.pi[0].cuda())
        k, p = time_pair(
            lambda a=args: ip.fused_light_pipeline(dataset, *a, h=H, w=W),
            lambda a=args: ip.fused_light_pipeline_reference(dataset, *a, h=H, w=W))
        if batch == 512:
            ms["light_pipeline_kernel"] = (k, p)
            # the gathered rows read and the output written; per value a
            # multiply-add, two clamps, a subtract and a divide
            values = batch * H * W * 3
            bounds["light_pipeline_kernel"] = bound(
                2 * 4 * values + nbytes(*args), f32_ops=6 * values)
            library["light_pipeline_kernel"] = None  # gather + affine + cutout
        say("timing", f"K3 B={batch}: kernel {k:.4f} ms ({batch / k * 1e3:,.0f} "
            f"img/s), plain {p:.4f} ms ({batch / p * 1e3:,.0f} img/s) on {smi}")
    cfg = tr["cfg"]
    opt = create_optimizer(cfg, 39)
    state = make_train_state(trained, opt)
    labels = torch.from_numpy(ds.labels).cuda()
    chunk = np.random.default_rng(SEED).permutation(len(ds.labels))[:39 * 512]
    chunk = chunk.reshape(39, 512)
    for run in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = scanned_train_steps_fused(state, dataset, labels, chunk, pgen,
                                      optimizer=opt, height=H, width=W)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / 39 * 1e3
        check(bool(torch.isfinite(m["loss"]).all()), "non-finite timing losses")
        say("timing", f"train step (39-step fused chunk {run + 1}/2, batch 512): "
            f"{step_ms:.3f} ms/step ({512 / step_ms * 1e3:,.0f} img/s), host "
            f"clock, one sync, on {smi}")

    # 13. etiny-serve — the EtinyNet serving path, counted from here to 16
    rng = np.random.default_rng(SEED)
    q0 = etinynet_quantize(etiny_model(rng))
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "etinynet.etiny"
        write_etiny(q0, path)
        esize = path.stat().st_size
        qe = read_etiny(path)
    etiny_models = {"0.98M": qe, "stress": etiny_stress_model(rng, qe)}
    etiny_params = {}
    for tag, qm in etiny_models.items():
        esim, ecfg = etiny_sim_params(qm, device="cuda")
        etiny_params[tag] = (ek.etiny_kernel_params(esim, ecfg), esim, ecfg)
    ek.reset_launch_counts()
    for batch in ETINY_SERVE_BATCHES:
        t0 = time.perf_counter()
        x = normalize_images(torch.rand((batch, H, W, 3), generator=gen,
                                        device="cuda")).contiguous()
        for tag, (kp, esim, ecfg) in etiny_params.items():
            etiny_serve(errs, kp, esim, ecfg, x * (4.0 if tag == "stress" else 1.0),
                        f"{tag} B={batch}")
        torch.cuda.synchronize()
        say("etiny-serve", f"B={batch}: 0.98M model ({len(qe.blocks)} LB blocks "
            f"via a {esize}-byte .etiny) and stress model: etiny_forward_kernel "
            f"equal to the sim (tolerance: none, torch.equal) "
            f"({time.perf_counter() - t0:.2f} s)")
    serve_launches = dict(ek.LAUNCHES)
    check(serve_launches["etiny_block_kernel"]
          == 2 * len(ETINY_SERVE_BATCHES) * len(qe.blocks),
          f"K6 launches {serve_launches} are not one per LB block and call")

    # 14. augment
    agen = torch.Generator().manual_seed(SEED)
    for batch in AUGMENT_BATCHES:
        images = torch.from_numpy(ds.images[:batch]).cuda()
        augment(errs, images, agen)
        say("augment", f"B={batch}: K4 on heavy-tier, rot90/flip and "
            "out-of-frame maps, K5 medium and heavy_extra with gates on, "
            "drawn and off, all equal to plain (tolerance: none, torch.equal)")

    # 15. etiny-train — the EtinyNet training path, counted from here to its end
    with tempfile.TemporaryDirectory() as tmp:
        et = etiny_train(Path(tmp))
        elosses = et["losses"]
        steps = ETINY_TRAIN_SIZE // et["cfg"].batch_size
        check(len(elosses) == steps and all(math.isfinite(v) for v in elosses),
              f"expected {steps} finite losses, got {elosses}")
        for name in ("warp_kernel", "photometric_kernel"):
            check(et["launches"][name] == 2 * steps,
                  f"{name} launched {et['launches'][name]} times, not twice "
                  "per heavy-tier step")
        epayload = load_checkpoint(et["ckpt"])
    trained_e = etinynet_from_checkpoint(epayload, device="cuda")
    check(trained_e.cfg.dtype == "bfloat16", "the checkpoint lost its dtype")
    tsim_e, tcfg_e = etiny_sim_params(etinynet_quantize(trained_e), device="cuda")
    tkp_e = ek.etiny_kernel_params(tsim_e, tcfg_e)
    eval_val = GenericVisionDataset("synthetic-hard", split="test",
                                    synthetic_size=ETINY_TRAIN_SIZE, seed=42)
    hits = 0
    for i in range(0, len(eval_val.labels), 1024):
        x = normalize_images(torch.from_numpy(eval_val.images[i:i + 1024]).cuda())
        got = ek.etiny_forward_kernel(tkp_e, x.contiguous(), cfg=tcfg_e,
                                      image_h=H, image_w=W)
        errs.equal("etiny_block_kernel", "trained EtinyNet logits vs sim", got,
                   etiny_engine_forward(tsim_e, x, cfg=tcfg_e, image_h=H,
                                        image_w=W))
        hits += int((got.argmax(1).cpu().numpy()
                     == eval_val.labels[i:i + 1024]).sum())
    int8_acc = hits / len(eval_val.labels)
    check(int8_acc == et["epoch"]["compiled/accuracy"],
          f"K6 int8 val accuracy {int8_acc} differs from the loop's sim "
          f"{et['epoch']['compiled/accuracy']}")
    say("etiny-train", f"{ETINY_CONFIG} on {ETINY_TRAIN_SIZE} synthetic-hard "
        f"images, 1 epoch of {len(elosses)} steps at batch "
        f"{et['cfg'].batch_size} in {et['seconds']:.2f} s (train_model, data "
        f"generation included); loss first {elosses[0]:.4f} last "
        f"{elosses[-1]:.4f}; val acc {et['epoch']['val/accuracy']:.4f}; "
        f"checkpoint int8 val accuracy through K6 {int8_acc:.4f} == sim")

    # 16. launches
    say("launches", "EtinyNet serving " + json.dumps(serve_launches)
        + "; EtinyNet training " + json.dumps(et["launches"]))
    launches["etiny_block_kernel"] = serve_launches["etiny_block_kernel"]
    launches["warp_kernel"] = et["launches"]["warp_kernel"]
    launches["photometric_kernel"] = et["launches"]["photometric_kernel"]

    # 17. timing
    tgen = torch.Generator().manual_seed(SEED + 2)
    for batch in ETINY_TIMING_BATCHES:
        images = torch.from_numpy(ds.images[:batch]).cuda()
        draws = aug.draw_tier(tgen, "heavy", batch, H, W, "cuda")
        noise = torch.randn(images.shape, device="cuda")
        x = normalize_images(images).contiguous()
        kp, esim, ecfg = etiny_params["0.98M"]
        ekw = dict(cfg=ecfg, image_h=H, image_w=W)
        rows = {
            "warp_kernel": time_pair(
                lambda: wk.warp_bilinear(images, draws.warp1),
                lambda: wk.warp_bilinear_reference(images, draws.warp1)),
            "photometric_kernel": time_pair(
                lambda: pk.photometric_block(images, noise, *draws.photo1,
                                             variant="medium"),
                lambda: pk.photometric_block_reference(
                    images, noise, *draws.photo1, variant="medium")),
            "photometric_kernel heavy_extra": time_pair(
                lambda: pk.photometric_block(images, noise, *draws.photo2,
                                             variant="heavy_extra"),
                lambda: pk.photometric_block_reference(
                    images, noise, *draws.photo2, variant="heavy_extra")),
            "etiny_block_kernel": time_pair(
                lambda: ek.etiny_forward_kernel(kp, x, **ekw),
                lambda: etiny_engine_forward(esim, x, **ekw)),
        }
        block_inputs = [etiny_stem(kp, x, ecfg).to(torch.int8)]
        for blk, bs in zip(kp["blocks"], ecfg.blocks):
            block_inputs.append(ek.lb_block(block_inputs[-1], blk, bs))
        blocks = list(zip(block_inputs, kp["blocks"], ecfg.blocks))
        rows["etiny_block_kernel, the LB blocks alone"] = time_pair(
            lambda: [ek.lb_block(a, blk, bs) for a, blk, bs in blocks],
            lambda: [ek.lb_block_reference(a, blk, bs) for a, blk, bs in blocks])
        for name, (k, p) in rows.items():
            what = ("the whole int8 forward (12 K6 launches + plain stem/tail) "
                    "vs the sim" if name == "etiny_block_kernel" else name)
            say("timing", f"B={batch} {what}: kernel {k:.4f} ms "
                f"({batch / k * 1e3:,.0f} img/s), plain {p:.4f} ms "
                f"({batch / p * 1e3:,.0f} img/s) on {smi}")
        if batch == 1024:
            for name in ("warp_kernel", "photometric_kernel"):
                ms[name] = rows[name]
            # per value: two passes of a position (two multiplies, two adds)
            # and a lerp (floor, three subtracts, two multiplies, an add)
            bounds["warp_kernel"] = bound(
                2 * nbytes(images) + nbytes(draws.warp1),
                f32_ops=18 * images.numel())
            # ~60 float operations per value (csrc/photometric.cu)
            bounds["photometric_kernel"] = bound(
                2 * nbytes(images) + nbytes(noise, *draws.photo1),
                f32_ops=60 * images.numel())
            # grid_sample is a one-pass bilinear warp, not the two-pass
            # result; no single call runs the gated photometric chain
            library["warp_kernel"] = library["photometric_kernel"] = None
        else:
            ms["etiny_block_kernel"] = rows["etiny_block_kernel, the LB blocks alone"]
            moved, ops = 0, 0
            for a, blk, bs in blocks:
                b, h, w, cin = a.shape
                oh, ow = conv_out_hw(h, w, bs.stride)
                mid, cout = blk["dw"].shape[0], blk["wp"].shape[0]
                moved += nbytes(a, blk["we"], blk["be"], blk["dw"], blk["wp"])
                moved += b * oh * ow * cout  # the int8 output
                ops += 2 * b * (h * w * mid * cin + oh * ow * mid * (9 + cout))
            bounds["etiny_block_kernel"] = bound(moved, int_ops=ops)
            library["etiny_block_kernel"] = None  # expand, depthwise, project
    ecfg_t = et["cfg"]
    eopt = create_optimizer(ecfg_t, steps)
    estate = make_train_state(trained_e, eopt)
    eimages = torch.from_numpy(ds.images).cuda()
    elabels = torch.from_numpy(ds.labels).cuda()
    noise_gen = aug.device_generator(tgen, "cuda")
    erng = np.random.default_rng(SEED)
    for run in range(2):
        idx = erng.integers(0, len(ds.labels), (steps, ecfg_t.batch_size))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step_losses = torch.stack([
            gathered_train_step(estate, eimages, elabels, i, tgen, optimizer=eopt,
                                strength="heavy", noise_gen=noise_gen)["loss"]
            for i in idx])
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / steps * 1e3
        check(bool(torch.isfinite(step_losses).all()), "non-finite timing losses")
        say("timing", f"EtinyNet train step ({steps} steps, run {run + 1}/2, "
            f"batch {ecfg_t.batch_size}, bf16, heavy tier): {step_ms:.3f} ms/step "
            f"({ecfg_t.batch_size / step_ms * 1e3:,.0f} img/s), host clock, one "
            f"sync, on {smi}")

    # 18. mega-bisect — the profiling path's cut kernel, counted in the probe
    _, fcfg = nnue_sim_params(q, device="cuda")
    for tag, hd, c in (("flagship", heads[0], fcfg), ("stress", sheads[0], scfg)):
        for batch in (TIMING_BATCH, 37):
            xb = normalize_images(torch.rand((batch, H, W, 3), generator=gen,
                                             device="cuda"))
            xb = xb.reshape(batch, -1).contiguous()
            for level in range(len(nk.STAGES)):
                skw = dict(cfg=c, image_h=H, image_w=W, level=level)
                got = nk.nnue_mega_stage(hd, xb, **skw)
                check(got.shape == (batch, nk.STAGE_OUT), "stage output shape")
                errs.equal("nnue_mega_stage_kernel",
                           f"{tag} B={batch} level {level}", got,
                           nk.nnue_mega_stage_reference(hd, xb, **skw))
        torch.cuda.synchronize()
    say("mega-bisect", "levels 0-3 (" + ", ".join(nk.STAGES) + ") on the "
        "flagship and the stress model at B=8192 and 37: kernel equal to "
        "plain (tolerance: none, torch.equal)")
    nk.reset_launch_counts()
    bis = profile_mega_bisect.run(TIMING_BATCH, "cuda", reps=BISECT_REPS)
    probe_launches = {"nnue_mega_stage_kernel": nk.LAUNCHES["nnue_mega_stage_kernel"]}
    check(all(bis[v + "_ms"] > 0 for v in profile_mega_bisect.VARIANTS),
          f"a probe time is not positive: {bis}")
    say("mega-bisect", "profile_mega_bisect " + json.dumps(bis))
    skw = dict(cfg=fcfg, image_h=H, image_w=W, level=3)
    ms["nnue_mega_stage_kernel"] = time_pair(
        lambda: nk.nnue_mega_stage(mega, flat, **skw),
        lambda: nk.nnue_mega_stage_reference(mega, flat, **skw))
    bounds["nnue_mega_stage_kernel"] = bound(
        nbytes(flat, mega["conv_w"], mega["conv_b"], mega["ft_w"], mega["ft_b"],
               mega["padsum"]) + TIMING_BATCH * nk.STAGE_OUT * 4,
        int_ops=conv_ops + n_act * fcfg.l1, f32_ops=flat.numel())
    library["nnue_mega_stage_kernel"] = None  # no call stops the engine at the FT
    say("timing", f"B={TIMING_BATCH} cut mega kernel, level 3 (ft): kernel "
        f"{ms['nnue_mega_stage_kernel'][0]:.4f} ms, plain "
        f"{ms['nnue_mega_stage_kernel'][1]:.4f} ms on {smi}")

    # 19. warp-split — the single passes, counted in the probe
    for batch in AUGMENT_BATCHES:
        images = torch.from_numpy(ds.images[:batch]).cuda()
        packed = images.reshape(batch, H, W * 3)
        draws = aug.draw_tier(agen, "heavy", batch, H, W, "cuda")
        frame_out = wk.pack_warp_params(*wk.warp_coefficients(
            torch.eye(2).expand(batch, 2, 2).contiguous(),
            torch.tensor([70.0, -90.0]).expand(batch, 2).contiguous(), H, W))
        cases = {"heavy-tier maps (block 1)": draws.warp1,
                 "heavy-tier maps (block 2)": draws.warp2,
                 "out-of-frame maps": frame_out.cuda()}
        for name, params in cases.items():
            zero_fill = False
            for coef in (params[:, 1:4].contiguous(), params[:, 4:7].contiguous()):
                for kernel, fn, ref in (
                        ("lerp_pass_kernel", wk.lerp_pass, wk.lerp_pass_reference),
                        ("nogather_pass_kernel", wk.nogather_pass,
                         wk.nogather_pass_reference)):
                    got = fn(packed, coef, n=W, c=3)
                    errs.equal(kernel, f"B={batch} {name} {fn.__name__}", got,
                               ref(packed, coef, n=W, c=3))
                    zero_fill |= torch.equal(got, torch.zeros_like(got))
            check(zero_fill or name != "out-of-frame maps",
                  "no pass of the out-of-frame maps is zero")
        w1 = draws.warp1
        check(torch.equal(profile_warp_split.five_stage_warp(
            images, w1[:, 0] > 0.5, w1[:, 1:4].contiguous(), w1[:, 4:7].contiguous()),
            wk.warp_bilinear(images, w1)), "five-stage warp differs from warp_kernel")
        torch.cuda.synchronize()
        if batch != 1024:
            continue
        coef1 = w1[:, 1:4].contiguous()
        for kernel, fn, ref in (
                ("lerp_pass_kernel", wk.lerp_pass, wk.lerp_pass_reference),
                ("nogather_pass_kernel", wk.nogather_pass,
                 wk.nogather_pass_reference)):
            ms[kernel] = time_pair(lambda f=fn: f(packed, coef1, n=W, c=3),
                                   lambda f=ref: f(packed, coef1, n=W, c=3))
            # per value: a position (two multiplies, two adds) and a lerp
            # (floor, three subtracts, two multiplies, an add)
            bounds[kernel] = bound(2 * nbytes(packed) + nbytes(coef1),
                                   f32_ops=9 * packed.numel())
        # one library call computes a single pass: grid_sample on the rows
        # as a (B, C, R, N) image, its grid holding the same positions
        rows = torch.arange(H, device="cuda", dtype=torch.float32)[None, :, None]
        cols = torch.arange(W, device="cuda", dtype=torch.float32)[None, None, :]
        pos = (coef1[:, 0, None, None] * rows + coef1[:, 1, None, None] * cols
               + coef1[:, 2, None, None])
        grid = torch.stack([pos * (2.0 / (W - 1)) - 1.0,
                            (rows * (2.0 / (H - 1)) - 1.0).expand_as(pos)], dim=-1)
        src = images.permute(0, 3, 1, 2)

        def sample():
            return torch.nn.functional.grid_sample(
                src, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True)
        check(torch.allclose(sample().permute(0, 2, 3, 1).reshape(packed.shape),
                             wk.lerp_pass(packed, coef1, n=W, c=3), atol=1e-4),
              "grid_sample does not compute the lerp pass")
        library["lerp_pass_kernel"] = time_median(sample)
        library["nogather_pass_kernel"] = None  # no call reads in place of taps
    say("warp-split", f"B={AUGMENT_BATCHES}: lerp_pass and nogather_pass on "
        "heavy-tier and out-of-frame maps equal to plain (tolerance: none, "
        "torch.equal); the five-stage composition equal to warp_kernel")
    for kernel in ("lerp_pass_kernel", "nogather_pass_kernel"):
        k, p = ms[kernel]
        say("timing", f"B=1024 {kernel}: kernel {k:.4f} ms, plain {p:.4f} ms"
            + (f", grid_sample {library[kernel]:.4f} ms" if library[kernel]
               else "") + f" on {smi}")
    os.environ["WARP_SPLIT_REPS"] = WARP_SPLIT_REPS
    wk.reset_launch_counts()
    split = profile_warp_split.run(AUGMENT_BATCHES[0], "cuda")
    for kernel in ("lerp_pass_kernel", "nogather_pass_kernel"):
        probe_launches[kernel] = wk.LAUNCHES[kernel]
    check(all(v > 0 for v in split["ms"].values()),
          f"a probe time is not positive: {split}")
    say("warp-split", "profile_warp_split " + json.dumps(split))

    # 20. trace
    with tempfile.TemporaryDirectory() as tmp:
        tcfg = load_config(TRACE_CONFIG)
        tcfg.use_augmentation = True  # the light tier: the fused K3 path
        tcfg.log_dir = str(Path(tmp) / "logs")
        tcfg.profile_dir = str(Path(tmp) / "trace")
        os.environ["NV_SKIP_ENGINE"] = "1"
        check(train_model(tcfg, "nnue", device="cuda") == 0,
              "train_model with profile_dir failed")
        trace = Path(tcfg.profile_dir) / "train_epoch0.trace.json"
        events = json.loads(trace.read_text())["traceEvents"]
        kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
        check(any("light_pipeline_kernel" in k for k in kernels),
              f"light_pipeline_kernel is not in the trace's kernels: {kernels}")
        say("trace", f"{TRACE_CONFIG} with the light tier: {trace.name}, "
            f"{trace.stat().st_size} bytes, {len(events)} events, "
            f"{len(kernels)} distinct CUDA kernels, light_pipeline_kernel "
            "among them")

    # 21. launches
    check(all(n > 0 for n in probe_launches.values()),
          f"a probe kernel never launched: {probe_launches}")
    say("launches", "profiling " + json.dumps(probe_launches) + " (host calls "
        "in the probes: each warm-up and each call captured in a CUDA graph; "
        "the graph's replays add none)")
    launches.update(probe_launches)

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name],
         "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": errs.max[name], "ms": ms[name][0],
         "plain_ms": ms[name][1], "bound_ms": bounds[name][0],
         "bound_by": bounds[name][1], "library_ms": library[name]}
        for name in SOURCES]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
