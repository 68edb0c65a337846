#!/usr/bin/env python3
"""Drive the PyTorch port's int8 NNUE serving path, its NNUE training path,
its EtinyNet int8 serving path, its EtinyNet training path, its
engine_friendly EtinyNet path (progressive QAT → LSQ-folded `.etiny` →
K6), its profiling path, the train loop's engine probe and engine
backend, bf16 NNUE, distillation and resume, EtinyNet-1.0 at ImageNet's
224×224, data-parallel training and sharded serving over spawned
ranks, the deployment entry points (the serialize, evaluate and stream
CLIs, the model facade, the upstream import), the train chunk as one
CUDA graph (K3, or K4 and K5, inside it), and the user tools (the
engine-speed comparison, the upstream interchange check, the MCU/TinyML
analysis), the ten profiling probes and the benchmark once on one CUDA
card.

    python3 chip_smoke.py        # from the repository root

Phases, one line each (any failure raises and exits non-zero):

1. device    require CUDA; print the card (nvidia-smi), torch and CUDA versions
2. build     nvcc-build the kernels from nnue_vision_tpu_torch/csrc; ptxas
             registers per kernel, and in the built library's SASS the count
             of int8 tensor-core (IMMA) and cp.async (LDGSTS) instructions of
             the serving kernels (K1, K2, K6, K7), which must reach both, and
             of bulk copies (UBLKCP) of the ring kernels (K3, K4, its single
             pass, K8, K5), which must reach them and spill nothing (K3's
             count and registers on a line of their own); beside nvcc,
             in a thread, compile_cpp_engine builds the C++ engine's two
             inference tools (cmake + ninja into build/torch_engine/)
3. model     flagship-width NNUE (config/train_nnue.py widths) from a numpy
             seed → nnue_quantize → write_nnue → read_nnue → nnue_sim_params
4. serve     batches of 1, 37, 512 and 8192 normalized 32×32 images through
             every entry point; each result torch.equal to its plain version
5. stress    phase 4 at the same batches for a random int model at full
             width, with a negative threshold and int16 FT weights (padding
             features active, FT sums wrap)
6. evaluate  evaluate_int8_sim with use_pallas="mega" and True equal to False
7. launches  both kernels launched during phases 4-6 (the main path)
8. timing    kernel vs plain version at batch 8192 (and the mega kernel at 1
             and 512), CUDA events, median of 20 in turns; the mega kernel at
             8192 also graph-timed (ops/timing.py)
9. pipeline  the light-pipeline kernel (K3) on the 20,000 synthetic-hard
             training images at batch 512, 256 (a rank's shard in 31) and
             37, and on 255 random images each at 77×77 (not whole 16-byte
             units) at batch 37 and at 224×224 (56 bands an image) at batch
             64, with flips, holes and
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
             turns), each also graph-timed with its bytes bound and its host
             cost per call, and where a block's time goes (the SM cycles of a
             block's first item: scalars, copy, compute, store; median over
             the blocks of 5 launches, ops/input_pipeline.py
             light_pipeline_phases); ms
             per train step over a 39-step chunk (host clock, one sync at the
             end): eager, captured and replayed, replayed
13. etiny-serve  a 0.98M-width EtinyNet from a numpy seed (random weights and
             norm statistics) → etinynet_quantize → write_etiny → read_etiny,
             and a stress model at full int8 ranges; batches 1, 37, 1024 and
             8192 through etiny_forward_kernel (the stem kernel, K6 one launch
             per LB block, the tail kernel), each torch.equal to the engine sim
14. augment  on synthetic-hard 32×32 images at batch 1024, 512 (a rank's
             shard in 32) and 37: K4 on drawn
             heavy-tier maps, rot90/flip-only maps and out-of-frame maps; K5,
             both variants, with every gate on, drawn, and off (identity);
             each torch.equal to its plain version
15. etiny-train  train_model on config/train_etinynet.py (0.98M, bf16, heavy
             tier, batch 1024) on 50,000 synthetic-hard images for one epoch
             of 48 steps: K4 and K5 each launched 96 times, finite losses,
             best_model.ckpt written; on the checkpointed model K6's int8
             logits equal the sim's on the val split
16. launches the kernels launched on their paths (serving: 13, the stem
             and tail once a call; training: 15)
17. timing   K4, K5 (each variant) and K6 (the whole int8 forward, and its 12
             LB blocks alone) vs plain at batch 1024 and 8192; K4 and K5 also
             graph-timed with their host cost per call (the host clock over
             many enqueues, no sync inside), the 12 blocks at 8192 graph-timed;
             the stem and tail kernels at 8192×32×32 (0.98M) and at
             1024×224×224 (EtinyNet-1.0, 1,000 classes), each torch.equal to
             its plain version, event-, graph- and host-timed beside it;
             ms per EtinyNet train step at batch 1024 over 48 steps (host
             clock, one sync at the end)
18. ef-etiny  train_model on config/train_etinynet_anchor_qat.py (0.75
             widths, engine_friendly, float32, light tier, batch 256, its 5,000
             synthetic-hard images), cut to 3 epochs (max_epochs 60 → 3) with
             1 warm-up epoch (ef_warmup_epochs 25 → 1): epoch 0 trains the
             continuous engine-structured model, epochs 1-2 the quantized one;
             finite losses, the quantizer switch logged, the 23 qlog
             parameters trained away from 0, best_model.ckpt from a quantized
             epoch; on that checkpoint etinynet_quantize → write_etiny →
             read_etiny → K6 (12 launches per call): on the 1,250 val images
             K6's logits torch.equal to the sim's and its accuracy equal to
             the loop's int8 eval; the float model's eval logits finite, and
             printed beside K6's: float and int8 accuracy, the share of
             agreeing predictions, and the relative logit error per image
             (not held to JAX's bar of 0.1: neither package's float model
             meets it on a trained model, PERF.md §6); the C++ engine's
             logits on the val split equal to K6's as the engine prints
             them (phase 23); K6 on this .etiny
             at batch 8192 event-timed
             (whole forward and the 12 blocks) and graph-timed (the blocks);
             ms per train step of the warm-up and of the quantized function
             at batch 256 (host clock, one sync per 19 steps)
19. mega-bisect  the cut mega kernel (K7) at levels 0-3 on the flagship and
             the stress model (negative threshold: the padding sum is on) at
             batch 8192 and 37, each torch.equal to nnue_mega_stage_reference;
             then profile_mega_bisect's timing at batch 8192 (counted)
20. warp-split  lerp_pass and nogather_pass (K8) on drawn heavy-tier maps and
             out-of-frame maps (zero fill) at batch 1024, 512 and 37, each
             torch.equal to its plain version, and the five-stage
             composition equal to warp_bilinear; the passes timed at batch
             1024 with CUDA events and graph-timed beside grid_sample both
             ways, with their host cost; then profile_warp_split's variants
             at batch 1024 (counted)
21. trace    train_model on config/train_nnue_test.py with the light tier on
             (the fused K3 path) and profile_dir: the trace file names
             light_pipeline_kernel among its CUDA kernels
22. launches the three probe kernels launched on their paths (19, 20); the
             counts are host calls: a CUDA graph's replays add none
23. engine   the train loop's start-up probe (engine_probe: the build, then
             four training images through the engine) on the flagship
             model; the engine's logits equal to K1's on it at batch 37 and
             512, and to K6's on the 0.98M model of phase 13 at batch 37
             and 1024, each kernel's equal to the sim's (the engine prints
             %.10f, which moves a logit below 2^-10 by up to 1 ulp: the
             kernel's logits are compared as the engine prints them)
24. nnue-bf16  train_model on config/train_nnue_qat_bf16.py (full width, QAT,
             bf16 compute, light tier) on 50,000 synthetic-hard images, one
             epoch of 390 steps at batch 128, compiled_backend "engine", the
             probe on: K3 once per fused step (48 chunks of 8; the last 6
             steps unfused), finite losses; the best checkpoint's .nnue
             through the engine on the 12,500 val images equal to K1's as
             printed, K1's equal to the sim's, and the engine's accuracy
             equal to the loop's; the engine's
             compiled/ms_per_sample beside K1's (evaluate_int8_sim "mega")
             on the same batches; ms per fused step in bf16 and float32 at
             batch 128 (39-step chunks as CUDA graph replays, host clock, one
             sync, in turns)
25. distill  the teacher: one epoch of config/train_etinynet_hard_float.py
             (micro, float); the student: config/train_etinynet_distill.py
             (micro, engine_friendly, alpha 0.3, T 4) with distill_from that
             teacher, cut to 2 epochs (1 warm-up); the student's .etiny
             through K6, the sim and the engine on the 5,000 val images (K6
             equal to the sim, the engine to K6 as printed), and K6's
             accuracy equal to the loop's; ms per student
             step with and without the teacher (host clock, in turns)
26. resume   train_model on config/train_nnue_hard.py for 2 epochs with
             checkpoint_backend "orbax", then resume=True with max_epochs 3:
             restored at epoch 2, exactly one epoch (39 steps, 39 K3
             launches) run, the first resumed step's LR the schedule's value
             at step 78; seconds per step-checkpoint write
27. launches the kernels launched on the paths of 23-26
28. imagenet  K5's band path (images past one shared-memory slot) at
             (256, 224, 224, 3), (37, 224, 224, 3) and (37, 160, 200, 3),
             both variants, every gate on, drawn and off, each torch.equal
             to its plain version; K5 at 256×224 event- and graph-timed with
             its host cost and bytes bound, and the gather warp's time
             there; train_model on config/train_etinynet_imagenet.py
             (EtinyNet-1.0 at full width, 1000 classes, 224×224, batch 256,
             float32, medium tier) on its synthetic fallback of 2,560 images
             (640 val), 300 epochs cut to 1 (10 steps), with step checkpoints:
             K5 launched 10 times on the band path, K4 and K6 never (the
             gather warp; the int8 eval on the sim), finite losses, the
             engine probe at 224, best_model.ckpt written iff the epoch's val
             F1 beats 0 (a model at chance after 10 steps need not); the
             epoch's model → etinynet_quantize → write_etiny → read_etiny: on
             64 val images the sim's logits equal the C++ engine's as it
             prints them, and so do K6's through etiny_forward_kernel (14
             launches, 9 of them on row bands; torch.equal to the sim); ms
             per step, images/s and peak device memory
29. launches K5's band path on the 224 run, and K6's on the served .etiny
30. dp-init  NCCL at world size 1 in this process; two gloo ranks spawned
             on the one card (NCCL refuses two ranks on one card; gloo takes
             CUDA tensors for all_reduce and broadcast), which run 30-33;
             NCCL with two ranks only where there are two cards: the port's
             zero-slot all_gather of float32 and int32 bit-equal to the
             concatenation, the differentiable all_reduce's sum and
             gradient, a broadcast and a barrier on CUDA tensors
31. dp-nnue  train_model on config/train_nnue_hard.py (full width, batch
             512, light tier, compiled_backend "mega") over the two ranks of
             256, one epoch cut to 20 fused steps (two chunks of 10), against
             one process on the same seed: K3 once per step on each rank, K1
             in each rank's int8 eval; the losses of every step and the
             params after the last step within 1e-6 of one process, equal on
             both ranks; the dp run's int8 eval equal to one process's K1 on
             its checkpoint; ms per fused step for one rank (the other
             waiting) and two, host clock, in turns, and the step's
             all_reduces replayed alone
32. dp-etiny  the heavy tier on each rank's 512 rows of a global batch of
             1024 (the global draws and noise) torch.equal to the plain
             chain; train_model on config/train_etinynet.py (0.98M, bf16,
             heavy tier, batch 1024) over the two ranks, cut to 10 steps:
             K4 and K5 twice per step on each rank's shard; the first
             step's loss within one bf16 ulp (2^-8) of one process; the
             BatchNorm running statistics equal on both ranks; the same
             run in float32 against one process in float32 at the CPU
             tests' EtinyNet bar: the losses of steps 1-2 to rel 1e-5, and
             a first step's loss (rel 1e-5), norm statistics (1e-5) and
             update (1e-4 of max(LR, its largest magnitude)); the config's
             SGD at 0.5 diverges on synthetic-hard, so the later steps, and
             the bf16 first update beside one process's bf16-vs-float32
             and bf16-vs-bf16 gaps, are printed; ms per step as in 31
33. dp-serve  the flagship-width .nnue (phase 3) through K1 and the 0.98M
             .etiny (phase 13) through K6 at batch 8192, 4096 per rank: the
             gathered logits (and K1's densities and counts) torch.equal to
             one process's kernel and to the plain version
34. dp-tp    four gloo ranks on the card, data 2 × model 2: one flagship QAT
             train step at batch 512 (images with every conv output 1e-4
             from the threshold), L1 split over the model axis; loss and
             params within 1e-5 of one process
35. launches the kernels launched on each rank in 31-33
36. serialize  python -m nnue_vision_tpu_torch.serialize as four subprocesses
             at once, on the card: (a) phase 10's best_model.ckpt (flagship
             widths), (b) an upstream-layout state dict at those widths
             (seeded torch.Generator, under "state_dict", torch.save),
             (c) phase 18's engine_friendly best_model.ckpt, (d) phase 15's
             0.98M one without --force (the deployment warning on stderr);
             each file's bytes equal to the in-process quantize + write;
             the .nnue files through K1 and the .etiny files through K6 at
             batch 8192, torch.equal to the sim; the C++ engine held to K1 on
             64 val images (as phase 23); the CLIs' wall seconds
37. evaluate python -m nnue_vision_tpu_torch.evaluate on (a) with --compiled
             on phase 10's 5,000 held-out images: its int8-sim metrics
             (all but ms_per_sample) equal to evaluate_int8_sim with
             use_pallas="mega" (K1) to every printed digit, its engine
             accuracy and F1 equal to its int8-sim ones; wall seconds
38. stream   the stream demo's pan on (a)'s .nnue, 256 streams × 64 frames:
             every frame's incremental logits torch.equal to K1's full
             forward and the sim's; python -m
             nnue_vision_tpu_torch.stream_inference_demo exits 0; after 40,
             ms per frame of the full forward through K1, through the sim
             and of the incremental forward (CUDA events around the frame
             loop, median of 20)
39. facade   models.api.NNUE at flagship widths on the card: its call
             torch.equal to its module's forward, its .quantize() through K1
             torch.equal to the sim; models.api.EtinyNet("0.98M")'s
             count_flops and count_parameters; (b) through
             torch_import.load_torch_checkpoint_auto onto the card, every
             param equal to the saved tensor
40. launches K1 and K6 launched in 36-39 (every count set to 0 before 36)
41. graph-nnue  config/train_nnue_hard.py (full width, batch 512), 39-step
             fused chunks (K3 inside): with cuDNN's deterministic algorithms,
             one eager warm-up chunk, then two chunks through the state's
             CUDA graph (captured on the first, each one replay) torch.equal
             to two eager chunks from a copy of the state (losses,
             accuracies, params, optimizer state, generator), K3's launches
             equal; then at the loop's cuDNN setting a new capture (its
             seconds, nodes, peak memory), the eager path's own spread over
             one chunk beside the graph's gap to it (printed: by default a
             conv's weight gradient may sum with atomics), and ms per step
             eager and graphed in turns, with peak device memory
42. graph-etiny  the same for config/train_etinynet.py (0.98M, bf16, heavy
             tier, batch 1024), 8-step chunks through scanned_train_steps (K4
             and K5 inside) against 8 gathered_train_step calls
43. launches K3, K4 and K5 launched by 41-42's graphed chunks, counted through
             the replays (each replay adds the launches its wrappers made
             during capture)
44. compare-engine-speed  python -m nnue_vision_tpu_torch.compare_engine_speed
             --samples 64 --iters 20, in process: the C++ engine's ms per
             image and benchmark_engine's lines, then K1 and K6 beside the
             sims on the tool's images (each graph-timed), K1's and K6's
             outputs torch.equal to the sims'
45. upstream-e2e  upstream_e2e_check on phase 10's best_model.ckpt, --n 64,
             in process, against build/torch_engine/nnue_inference (the
             port's own engine build: the card's host has no upstream
             checkout): bit_exact 64/64 against K1 and against the sim
46. mcu      run_mcu_benchmarks --max-samples 256, in process, on phase 10's
             checkpoint and on phase 13's 0.98M EtinyNet: both JSON files
             written; the report's accuracy (its first 100 images, as
             run_mlperf_tiny_benchmark scores) equal to evaluate_model's on
             those images, and evaluate_model_accuracy on the whole test
             split (128 images: CIFAR-10's synthetic stand-in caps it at a
             quarter of its 512) equal to evaluate_model's
47. example  python -m nnue_vision_tpu_torch.run_example_benchmark exits 0;
             then K1's and K6's launches in 44-47 (every count set to 0
             before 44)
48-57. probes  the ten profilers ported from scripts/, each `run` in
             process at its widths, cut only in depth (PROBES): 48
             profile_nnue_split at 8192 (K1, K2; mega_exact and
             bf16_conv_exact), 49 profile_etiny_pallas (micro, 2048: K6,
             its bit-equality to the sim), 50 profile_train_roofline (512,
             64-step chunks), 51 profile_train_sweep --fused (512-4096: K3),
             52 profile_scaled_train (grid 20, L1 4096, 77×77, 2048: K3;
             0 < MFU < 1), 53 profile_etiny_roofline (0.98M, 1024), 54
             profile_etiny_train (no-aug and the three tiers: K4, K5; the
             production eager step, two runs of 8), 55
             profile_heavy_aug, 56 profile_photometric_rng and 57
             profile_batched_draws (1024: K4, K5); every count set to 0
             before each, the kernels of its path launched, every time
             positive and finite, each probe's JSON on a line of its own
58. bench    python -m nnue_vision_tpu_torch.bench at its defaults (the
             JAX bench.py's sizes), a subprocess on the card: exit 0, its
             last line the metric's JSON (printed on a line of its own),
             every *_images_per_sec positive and finite, every *_mfu in
             (0, 1), its device the nvidia-smi line, and its `# launches`
             line K1-K5 each above 0 (added to the totals); wall seconds

Every train_model run (phases 10, 15, 18, 21, 24-26, 28) builds the C++ engine
(a no-op after phase 2) and probes it before its first step, as a user's
run does. Its full chunks run through scanned_train_steps(_fused): on the
card each signature's first full chunk runs eagerly, the second is captured
as one CUDA graph and every later one replays it (in 15, 18's quantized
epochs, 24 and 26's first run; 10, 26's resumed epoch and 28 have one full
chunk, the eager one); phase 12 times a fused chunk eagerly, with its
capture and as a replay, phase 24 its chunks as replays, and phase 31's
one-rank turns stay eager, as the ranks run.

Then one JSON line with each kernel's launches, error and times (kernel,
plain version, the card's bound for the same work and, where one PyTorch
call computes the same function, that call; K6's are its 12 LB blocks
alone at batch 8192, graph-timed too, once on the 0.98M model and again,
as a second entry, on the engine_friendly 0.75 `.etiny` of phase 18, whose
launches the first entry's count includes; K7's level 3; K1, K2, K3, K4,
K5, K6, K7, the single pass and K8 also graph-timed, with their host cost
per call,
and the single pass's grid_sample graph-timed as `library_graph_ms`; K5's
band path at 224 as a second K5 entry; K3 at batch 8192 as a second K3 entry,
with the first entry's launches; each kernel of 31-33 also its
launches per rank, which its `launches` includes), the card's name and
power limit, and the last line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import copy
import ctypes
import dataclasses
import functools
import io
import json
import math
import os
import pickle
import re
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
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
from nnue_vision_tpu_torch import (
    compare_engine_speed,
    deploy_etiny,
    profile_batched_draws,
    profile_etiny_pallas,
    profile_etiny_roofline,
    profile_etiny_train,
    profile_heavy_aug,
    profile_mega_bisect,
    profile_nnue_split,
    profile_photometric_rng,
    profile_scaled_train,
    profile_train_roofline,
    profile_train_sweep,
    profile_warp_split,
    run_mcu_benchmarks,
    upstream_e2e_check,
)
from nnue_vision_tpu_torch.benchmarks import evaluate_model_accuracy
from nnue_vision_tpu_torch import stream_inference_demo as sid
from nnue_vision_tpu_torch import torch_import
from nnue_vision_tpu_torch.data.loaders import create_data_loaders, head_subset_loader
from nnue_vision_tpu_torch.models import api
from nnue_vision_tpu_torch.profile_augment import grid_sample_pass, host_ms
from nnue_vision_tpu_torch.quantize import quantize_weight_i8
from nnue_vision_tpu_torch.bridge import nnue_from_jax_params
from nnue_vision_tpu_torch.data import augment as aug
from nnue_vision_tpu_torch.data.augment import normalize_images
from nnue_vision_tpu_torch.data.datasets import GenericVisionDataset
from nnue_vision_tpu_torch.models.etinynet import (
    EtinyNet,
    EtinyNetConfig,
    count_parameters,
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
from nnue_vision_tpu_torch.ops._build import _nvcc, load_library
from nnue_vision_tpu_torch.ops.timing import (
    bound_ms,
    chained_best_ms,
    nbytes,
)
from nnue_vision_tpu_torch.ops.engine_sim import (
    conv_out_hw,
    engine_conv_stride,
    etiny_engine_forward,
    etiny_sim_params,
    etiny_stem,
    etiny_tail,
    nnue_conv_buffer,
    nnue_engine_forward,
    nnue_sim_params,
)
from nnue_vision_tpu_torch.training.checkpoint import (
    StepCheckpointer,
    etinynet_from_checkpoint,
    load_checkpoint,
    nnue_from_checkpoint,
    save_checkpoint,
)
from nnue_vision_tpu_torch.serialize import load_checkpoint_auto
from nnue_vision_tpu_torch.training.engine_build import BUILD_DIR as ENGINE_BUILD_DIR
from nnue_vision_tpu_torch.training.engine_build import compile_cpp_engine
from nnue_vision_tpu_torch.training.evaluate import (
    as_engine_prints,
    engine_logits,
    evaluate_int8_sim,
    evaluate_model,
    normalize_host,
)
from nnue_vision_tpu_torch.training.loop import engine_probe, train_model
from nnue_vision_tpu_torch.training.optim import (
    Optimizer,
    create_optimizer,
    make_schedule,
)
from nnue_vision_tpu_torch.training.step import (
    Teacher,
    TrainState,
    gathered_train_step,
    make_train_state,
    scanned_train_steps,
    scanned_train_steps_fused,
    train_step,
)
from nnue_vision_tpu_torch.parallel import mesh as tmesh
from nnue_vision_tpu_torch.parallel.distributed import initialize_distributed, spawn
from nnue_vision_tpu_torch.training import loop as tloop
import torch.distributed as dist

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
PIPELINE_BATCHES = (512, 256, 37)  # 256: a rank's shard in phase 31
# K3 past the flagship's shape: not whole 16-byte units, and in bands
PIPELINE_SHAPES = ((77, 77, 37), (224, 224, 64))
PIPELINE_TIMING_BATCHES = (512, 8192)
ETINY_CONFIG = "config/train_etinynet.py"
ETINY_TRAIN_SIZE = 50000  # CIFAR-10's train split, in synthetic-hard images
ETINY_SERVE_BATCHES = (1, 37, 1024, 8192)
AUGMENT_BATCHES = (1024, 512, 37)  # 512: a rank's shard in phase 32
ETINY_TIMING_BATCHES = (1024, 8192)
EF_CONFIG = "config/train_etinynet_anchor_qat.py"
EF_EPOCHS = 3  # the config's 60, cut
EF_WARMUP = 1  # the config's 25, cut: epoch 0 warms up, epochs 1-2 quantized
EF_K6 = "etiny_block_kernel (0.75 engine_friendly .etiny)"
K5_BAND = "photometric_band_kernel"  # K5's band path, at 224×224
# the stem and tail kernels timed on EtinyNet-1.0 at 224×224 (phase 17)
STEM_224 = "etiny_stem_kernel (B=1024, 224x224)"
TAIL_224 = "etiny_tail_kernel (B=1024, 224x224)"
STEM_TAIL_224_BATCH = 1024
K3_8192 = "light_pipeline_kernel (B=8192)"  # K3 timed at batch 8192
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
    EF_K6: "nnue_vision_tpu_torch/csrc/etiny_block.cu",
    K5_BAND: "nnue_vision_tpu_torch/csrc/photometric.cu",
    K3_8192: "nnue_vision_tpu_torch/csrc/light_pipeline.cu",
    "etiny_stem_kernel": "nnue_vision_tpu_torch/csrc/etiny_stem.cu",
    "etiny_tail_kernel": "nnue_vision_tpu_torch/csrc/etiny_stem.cu",
    STEM_224: "nnue_vision_tpu_torch/csrc/etiny_stem.cu",
    TAIL_224: "nnue_vision_tpu_torch/csrc/etiny_stem.cu",
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
    EF_K6: "nnue_vision_tpu/ops/etiny_pallas.py:105",
    K5_BAND: "nnue_vision_tpu/ops/photometric_kernel.py:114",
    K3_8192: "nnue_vision_tpu/ops/input_pipeline.py:147",
    # no TPU kernel: the JAX package runs the stem conv, the pool and the
    # classifier in XLA (etiny_forward_pallas)
    "etiny_stem_kernel": "none (XLA: nnue_vision_tpu/ops/etiny_pallas.py:301)",
    "etiny_tail_kernel": "none (XLA: nnue_vision_tpu/ops/etiny_pallas.py:333)",
    STEM_224: "none (XLA: nnue_vision_tpu/ops/etiny_pallas.py:301)",
    TAIL_224: "none (XLA: nnue_vision_tpu/ops/etiny_pallas.py:333)",
}
BISECT_REPS = 100
GRAPH_REPS = 50  # calls per CUDA graph in the graph-timed rows
K6_HOST_CALLS = 40  # 480 launches: within the launch queue
# the tensor-core kernels and the bulk-copy kernels, as their names appear
# (mangled) in the SASS, and the instructions counted there
TENSOR_CORE_KERNELS = ("etiny_block_kernel", "nnue_mega_kernel", "nnue_head_kernel")
BULK_KERNELS = ("light_pipeline_kernel", "warp_kernel", "lerp_pass_kernel",
                "photometric_kernel")
SASS_KERNELS = TENSOR_CORE_KERNELS + BULK_KERNELS
SASS_OPS = ("IMMA", "LDGSTS", "UBLKCP")
WARP_SPLIT_REPS = "100"
TRACE_CONFIG = "config/train_nnue_test.py"
ENGINE_BATCHES = (37, 512)
BF16_CONFIG = "config/train_nnue_qat_bf16.py"
BF16_TRAIN_SIZE = 50000  # CIFAR-10's train split, in synthetic-hard images
TEACHER_CONFIG = "config/train_etinynet_hard_float.py"
DISTILL_CONFIG = "config/train_etinynet_distill.py"
DISTILL_EPOCHS = 2  # the config's 150, cut
DISTILL_WARMUP = 1  # the config's 25, cut
STEP_TIMING = 39  # steps per timed run in phases 24 and 25
IMAGENET_CONFIG = "config/train_etinynet_imagenet.py"
IMAGENET_TRAIN_SIZE = 2560  # 10 steps of the config's batch 256
IMAGENET_K5_SHAPES = ((256, 224, 224), (37, 224, 224), (37, 160, 200))
IMAGENET_ENGINE_IMAGES = 64
IMAGENET_STEPS = 5  # steps per timed run in phase 28
DP_TIMEOUT_S = 300.0  # a collective of the spawned ranks that waits longer raises
DP_JOIN_S = 600.0  # the spawned ranks' time limit, per group
DP_NNUE_STEPS = 20  # phase 31: config/train_nnue_hard.py's 39 steps an epoch, cut
DP_NNUE_CHUNK = 10  # fused steps per chunk: two chunks
DP_ETINY_STEPS = 10  # phase 32: config/train_etinynet.py's 48 steps an epoch, cut
DP_ETINY_HELD = 2  # phase 32: the float64 losses held to one process, before divergence
DTYPES = ("float64", "float32", "bfloat16")  # phase 32's first steps
DP_SERVE_BATCH = 8192
DP_TP_BATCH = 512
DP_TP_MARGIN = 1e-4  # phase 34's images: every conv output this far from the threshold
DP_TURNS = ("one", "two", "two", "one")


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


def sass_counts(lib_path: Path) -> dict:
    """{kernel<args>: {mnemonic: count}} for SASS_KERNELS in the built
    library's SASS (cuobjdump -sass): int8 tensor-core products (IMMA),
    asynchronous global-to-shared copies (LDGSTS) and bulk copies (UBLKCP)."""
    tool = Path(_nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = kernel_name(line.split("Function :")[1].strip())
            if name is not None:
                counts[name] = dict.fromkeys(SASS_OPS, 0)
        elif name is not None:
            for op in SASS_OPS:
                counts[name][op] += op in line
    return dict(sorted(counts.items()))


def kernel_name(mangled: str):
    """`kernel<template args>` of a SASS_KERNELS kernel's mangled name, or
    None for another function."""
    name = next((k for k in SASS_KERNELS if k in mangled), None)
    if name is not None:
        args = re.findall(r"L[ib](\d+)E", mangled.split(name, 1)[1])
        name += f"<{','.join(args)}>" if args else ""
    return name


def ptxas_usage(log: str) -> dict:
    """{kernel<args>: (registers, spill store bytes, spill load bytes)} for
    SASS_KERNELS from nvcc's -Xptxas -v output."""
    usage, entry, props = {}, None, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = kernel_name(line.split("'")[1])
        elif "Function properties for" in line:
            props = kernel_name(line.split("for", 1)[1].strip())
        elif "spill stores" in line and props is not None:
            nums = [int(v) for v in re.findall(r"(\d+) bytes", line)]
            regs = usage.get(props, (0, 0, 0))[0]
            usage[props] = (regs, nums[1], nums[2])
        elif "Used" in line and "registers" in line and entry is not None:
            regs = int(re.search(r"Used (\d+) registers", line).group(1))
            old = usage.get(entry, (0, 0, 0))
            usage[entry] = (regs, old[1], old[2])
    return dict(sorted(usage.items()))


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
    """`ops/timing.bound_ms` at the card's published rates: integer work at
    the dense int8 tensor-core rate (the highest integer rate, so a time
    from it is a lower bound), float32 outside the tensor cores."""
    return bound_ms(moved, int8_ops=int_ops, f32_flops=f32_ops)


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


def train_config():
    """The training config at full width, cut to one epoch, int8 eval
    through K1."""
    cfg = load_config(TRAIN_CONFIG)
    cfg.max_epochs = 1
    cfg.compiled_backend = "mega"
    return cfg


def etiny_model(rng: np.random.Generator, variant: str = "0.98M",
                classes: int = 10, side: int = H) -> EtinyNet:
    """An EtinyNet (0.98M-width, 10 classes, 32×32 unless told otherwise)
    with random weights in the JAX package's init ranges and random norm
    affines and running statistics."""
    model = EtinyNet(EtinyNetConfig(variant=variant, num_classes=classes,
                                    input_size=side), device="cpu")
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
    rot1 = maps(aug._ROT90[:, k].reshape(2, 2).expand(b, 2, 2), zero)
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


def etiny_config():
    """The EtinyNet production config on synthetic-hard images, one epoch."""
    cfg = load_config(ETINY_CONFIG)
    cfg.dataset_name = "synthetic-hard"
    cfg.synthetic_size = ETINY_TRAIN_SIZE
    cfg.max_epochs = 1
    return cfg


def ef_config():
    """The engine_friendly anchor config at full width, cut to EF_EPOCHS
    epochs of which EF_WARMUP warm up."""
    cfg = load_config(EF_CONFIG)
    cfg.max_epochs = EF_EPOCHS
    cfg.ef_warmup_epochs = EF_WARMUP
    return cfg


def k6_blocks(kp, ecfg, x: torch.Tensor) -> list:
    """[(int8 input, block params, block cfg)] of the model's LB blocks on
    images x, each input made by the block before it (K6 launches)."""
    inputs = [etiny_stem(kp, x, ecfg).to(torch.int8)]
    for blk, bs in zip(kp["blocks"], ecfg.blocks):
        inputs.append(ek.lb_block(inputs[-1], blk, bs))
    return list(zip(inputs, kp["blocks"], ecfg.blocks))


def etiny_launch_shapes(kp: dict, ecfg, side: int) -> list:
    """(h, w, cin, mid, cout, stride) of each K6 launch of a square input
    of `side`."""
    h = (side - 1) // 2 + 1
    out = []
    for blk, bs in zip(kp["blocks"], ecfg.blocks):
        mid, cout = blk["dw"].shape[0], blk["pw_project_w"].shape[0]
        out.append((h, h, blk["pw_expand_w"].shape[1], mid, cout, bs.stride))
        h = (h - 1) // bs.stride + 1
    return out


def k6_graph_ms(blocks: list, smi: str, tag: str) -> float:
    """The LB blocks graph-timed together, and each block's tile, shared
    memory and graph-timed ms printed; returns the blocks' ms."""
    lib = load_library().lib
    block_ms = chained_best_ms(
        lambda: [ek.lb_block(a, blk, bs) for a, blk, bs in blocks][-1], GRAPH_REPS)
    tiles = []
    for a, blk, bs in blocks:
        one_ms = chained_best_ms(lambda a=a, blk=blk, bs=bs: ek.lb_block(a, blk, bs),
                                 GRAPH_REPS)
        b, h, w, cin = a.shape
        oh, ow = conv_out_hw(h, w, bs.stride)
        mid, cout = blk["dw"].shape[0], blk["pw_project_w"].shape[0]
        shape = (h, w, cin, mid, cout, oh, ow)
        t = lib.etiny_block_tile(b, *shape)
        tiles.append(f"{h}x{w}x{cin}->{mid}->{cout}: T={t}, "
                     f"{lib.etiny_block_smem(t, *shape)} B with 2 ring slots, "
                     f"{one_ms:.4f} ms")
    say("timing", f"{tag} B={blocks[0][0].shape[0]} the {len(blocks)} LB blocks, "
        f"graph-timed ({GRAPH_REPS} calls per CUDA graph, best of 3): "
        f"{block_ms:.4f} ms on {smi}; tile, shared memory and graph-timed ms "
        "per block: " + "; ".join(tiles))
    return block_ms


def k6_host_ms(blocks: list) -> float:
    """The host's cost of one call of the LB blocks (12 K6 launches), over
    K6_HOST_CALLS calls with no sync inside."""
    return host_ms(lambda: [ek.lb_block(a, blk, bs) for a, blk, bs in blocks][-1],
                   K6_HOST_CALLS)


def k6_bound(blocks: list) -> tuple:
    """The card's bound for the LB blocks: their int8 inputs, the weights
    as the model holds them (not the kernel's padded tiles) and the int8
    outputs moved once; two operations per multiply-add of the expand,
    depthwise and project products."""
    moved, ops = 0, 0
    for a, blk, bs in blocks:
        b, h, w, cin = a.shape
        oh, ow = conv_out_hw(h, w, bs.stride)
        mid, cout = blk["pw_expand_w"].shape[0], blk["pw_project_w"].shape[0]
        moved += nbytes(a, blk["pw_expand_w"], blk["be"], blk["dw"],
                        blk["pw_project_w"])
        moved += b * oh * ow * cout
        ops += 2 * b * (h * w * mid * cin + oh * ow * mid * (9 + cout))
    return bound(moved, int_ops=ops)


def stem_tail_timing(errs: Errors, smi: str, kp, ecfg, x: torch.Tensor,
                     names: tuple, tables: tuple) -> None:
    """Phase 17's rows of the stem and tail kernels on images x: the stem
    held to the sim's stem, the tail to the sim's tail on K6's output of x
    (torch.equal); each event-timed beside its plain version, graph-timed
    with its host cost per call, and its bound (the images, the int8
    activations and the weights moved once; two operations a
    multiply-add)."""
    stem_name, tail_name = names
    ms, bounds, extra, library = tables
    s = ek.etiny_stem_int8(kp, x, ecfg)
    tag = f"B={x.shape[0]} {x.shape[1]}x{x.shape[2]}"
    errs.equal(stem_name, f"{tag} etiny_stem_int8 vs plain", s,
               etiny_stem(kp, x, ecfg).to(torch.int8))
    a = s
    for blk, bs in zip(kp["blocks"], ecfg.blocks):
        a = ek.lb_block(a, blk, bs)
    t = ek.etiny_tail_logits(kp, a, ecfg)
    errs.equal(tail_name, f"{tag} etiny_tail_logits vs plain", t, etiny_tail(kp, a, ecfg))
    rows = {stem_name: (lambda: ek.etiny_stem_int8(kp, x, ecfg),
                        lambda: etiny_stem(kp, x, ecfg).to(torch.int8)),
            tail_name: (lambda: ek.etiny_tail_logits(kp, a, ecfg),
                        lambda: etiny_tail(kp, a, ecfg))}
    b, oh, ow, c = s.shape
    # the model's int8 weights (27 a channel) and int32 bias
    bounds[stem_name] = bound(nbytes(x, s) + 31 * c, int_ops=2 * b * oh * ow * c * 27)
    hw, k = a.shape[1] * a.shape[2], t.shape[1]
    bounds[tail_name] = bound(nbytes(a, kp["cls_w"], kp["cls_b"], t),
                              int_ops=2 * b * (hw * a.shape[3] + a.shape[3] * k))
    for name, (kernel, plain) in rows.items():
        ms[name] = time_pair(kernel, plain)
        extra[name] = (chained_best_ms(kernel, GRAPH_REPS), host_ms(kernel))
        library[name] = None  # no single call computes the exact integers
        say("timing", f"{tag} {name}: event {ms[name][0]:.4f} ms, graph "
            f"{extra[name][0]:.4f} ms ({GRAPH_REPS} calls per CUDA graph, best of "
            f"3), host {extra[name][1]:.4f} ms per call, plain {ms[name][1]:.4f} "
            f"ms, bound {bounds[name][0]:.4f} ms ({bounds[name][1]}) on {smi}")


def reset_launches() -> None:
    for module in (wk, pk, ek, ip, nk):
        module.reset_launch_counts()


def launch_counts() -> dict:
    return {**nk.LAUNCHES, **ip.LAUNCHES, **ek.LAUNCHES, **wk.LAUNCHES,
            **pk.LAUNCHES}


def train_run(cfg, model_type: str, log_dir: Path, run_id: str) -> dict:
    """train_model on `cfg` with the engine probe on, its log captured and
    printed: returns what the phases check and print, the kernels'
    launches in the run included (every count set to 0 just before it)."""
    cfg.log_dir = str(log_dir)
    os.environ.pop("NV_SKIP_ENGINE", None)
    reset_launches()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = train_model(cfg, model_type, run_id, device="cuda")
    seconds = time.perf_counter() - t0
    print(out.getvalue(), end="", flush=True)
    check(rc == 0, f"train_model failed on {cfg.name}")
    launches = launch_counts()
    metrics = log_dir / "runs" / run_id / "metrics.jsonl"
    records = [json.loads(line) for line in metrics.read_text().splitlines()]
    losses = [r["train/loss"] for r in records if "train/loss" in r]
    check(losses and all(math.isfinite(v) for v in losses),
          f"{cfg.name}: non-finite or no losses")
    best = log_dir / "checkpoints" / run_id / "best_model.ckpt"
    return dict(cfg=cfg, seconds=seconds, log=out.getvalue(), launches=launches,
                losses=losses, epochs=[r for r in records if "compiled/f1" in r],
                payload=load_checkpoint(best) if best.is_file() else None)


def hold_engine(errs: Errors, model, images: np.ndarray, labels: np.ndarray,
                batch: int, tag: str) -> dict:
    """The C++ engine's logits over raw `images` in batches of `batch`
    against the card's kernel (K1 for an NNUE, K6 for an EtinyNet) and the
    sim, on the same host-normalized images: the kernel's equal to the
    sim's, and the engine's equal to the kernel's as the engine prints them
    (`%.10f`, which moves a logit below 2^-10 by up to 1 ulp; `print_err` is
    the largest such move)."""
    loader = [(images[i:i + batch], labels[i:i + batch])
              for i in range(0, len(labels), batch)]
    got, lab, _, seconds = engine_logits(model, loader)
    etiny = isinstance(model, EtinyNet)
    kw = dict(image_h=H, image_w=W)
    if etiny:
        kernel = "etiny_block_kernel"
        sim, kw["cfg"] = etiny_sim_params(etinynet_quantize(model), device="cuda")
        kp = ek.etiny_kernel_params(sim, kw["cfg"])
    else:
        kernel = "nnue_mega_kernel"
        sim, kw["cfg"] = nnue_sim_params(nnue_quantize(model), device="cuda")
        kp = nk.mega_head_params(sim, kw["cfg"], H, W)
    outs = []
    for imgs, _ in loader:
        x = torch.from_numpy(normalize_host(imgs)).cuda()
        if etiny:
            k, ref = (ek.etiny_forward_kernel(kp, x, **kw),
                      etiny_engine_forward(sim, x, **kw))
        else:
            k = nk.nnue_engine_forward_mega(kp, x.reshape(len(x), -1), **kw)[0]
            ref = nnue_engine_forward(sim, x, **kw)[0]
        errs.equal(kernel, f"{tag} B={len(x)} kernel vs sim", k, ref)
        outs.append(k.cpu().numpy())
    k_all = np.concatenate(outs)
    err = float(np.abs(got.astype(np.float64) - k_all).max())
    np.testing.assert_array_equal(
        got, as_engine_prints(k_all),
        err_msg=f"{tag}: the engine's logits differ from {kernel}'s as the "
        "engine prints them (%.10f)")
    return dict(acc=float(np.mean(got.argmax(1) == lab)), n=len(lab),
                engine_ms=seconds / len(lab) * 1e3, kernel=kernel, print_err=err)


def step_ms_in_turns(runs: dict) -> dict:
    """{name: [ms per step, ...]} of each `runs[name]()` (STEP_TIMING steps,
    returning their losses), timed with the host clock and one sync, in the
    turns a, b, b, a."""
    names = list(runs)
    times = {n: [] for n in names}
    for name in names + names[::-1]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = runs[name]()
        torch.cuda.synchronize()
        times[name].append((time.perf_counter() - t0) / STEP_TIMING * 1e3)
        check(bool(torch.isfinite(losses).all()), f"non-finite {name} losses")
    return times


def loop_phases(errs: Errors, smi: str, model, emodel, ds, dataset,
                pgen: torch.Generator, tgen: torch.Generator) -> dict:
    """Phases 23-27: the train loop's engine probe and engine backend, bf16
    NNUE, distillation and resume; returns their kernels' launches. `model`
    is the flagship NNUE of phase 3, `emodel` the 0.98M EtinyNet of phase
    13, `ds` the synthetic-hard training set of phase 9 and `dataset` its
    gather copy (K3's input)."""
    # 23. engine — the start-up probe, and the engine held to K1 and K6;
    # each counted part of 23-26 starts from counts of 0; timing runs are
    # not counted
    reset_launches()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        engine_probe(model, ds, "nnue")
    check("Engine OK" in out.getvalue(), "the probe did not report")
    say("engine", "engine_probe on the flagship model: " + " | ".join(
        out.getvalue().strip().splitlines()))
    for tag, m, batches in (("flagship NNUE", model, ENGINE_BATCHES),
                            ("0.98M EtinyNet", emodel, (37, 1024))):
        for b in batches:
            he = hold_engine(errs, m, ds.images[:b], ds.labels[:b], b, tag)
            say("engine", f"{tag} B={b}: the engine's logits equal to "
                f"{he['kernel']}'s as printed (%.10f; raw max "
                f"{he['print_err']:.3g}), the kernel's equal to the sim's, "
                f"{he['engine_ms']:.4f} ms per image (host CPU)")
    new_launches = {k: launch_counts()[k] for k in (
        "nnue_mega_kernel", "etiny_block_kernel", "light_pipeline_kernel")}

    # 24. nnue-bf16 — the bf16 QAT NNUE through the engine backend
    with tempfile.TemporaryDirectory() as tmp:
        bcfg = load_config(BF16_CONFIG)
        bcfg.dataset_name = "synthetic-hard"
        bcfg.synthetic_size = BF16_TRAIN_SIZE
        bcfg.max_epochs = 1
        bcfg.compiled_backend = "engine"
        bf = train_run(bcfg, "nnue", Path(tmp), "bf16")
    bsteps = BF16_TRAIN_SIZE // bcfg.batch_size
    chunk = int(getattr(bcfg, "steps_per_dispatch", 8))
    check(len(bf["losses"]) == bsteps, f"expected {bsteps} losses")
    check(bf["launches"]["light_pipeline_kernel"] == chunk * (bsteps // chunk),
          f"K3 launched {bf['launches']['light_pipeline_kernel']} times, not once "
          "per fused step")
    check("Engine OK" in bf["log"] and "fused input pipeline active" in bf["log"],
          "the probe or the fused K3 path did not run")
    bpayload = bf["payload"]
    check(bpayload["model_config"]["dtype"] == "bfloat16"
          and all(v.dtype == np.float32 for v in bpayload["params"].values()),
          "the checkpoint is not a bf16 model with float32 params")
    reset_launches()
    btrained = nnue_from_checkpoint(bpayload, device="cuda")
    bval = GenericVisionDataset("synthetic-hard", split="test",
                                synthetic_size=BF16_TRAIN_SIZE, seed=42)
    bhold = hold_engine(errs, btrained, bval.images, bval.labels,
                        bcfg.batch_size, "bf16-trained NNUE")
    bepoch = bf["epochs"][0]
    check(bhold["acc"] == bepoch["compiled/accuracy"],
          f"engine val accuracy {bhold['acc']} differs from the loop's "
          f"{bepoch['compiled/accuracy']}")
    vloader = [(bval.images[i:i + bcfg.batch_size], bval.labels[i:i + bcfg.batch_size])
               for i in range(0, len(bval.labels), bcfg.batch_size)]
    k1_eval = evaluate_int8_sim(btrained, vloader, use_pallas="mega")
    check(k1_eval["acc"] == bhold["acc"], "K1's accuracy differs from the engine's")
    say("nnue-bf16", f"{BF16_CONFIG} (full width, QAT, bf16) on {BF16_TRAIN_SIZE} "
        f"synthetic-hard images, 1 epoch of {bsteps} steps at batch "
        f"{bcfg.batch_size} in {bf['seconds']:.2f} s (train_model, probe and data "
        f"generation included); loss first {bf['losses'][0]:.4f} last "
        f"{bf['losses'][-1]:.4f}; val acc {bepoch['val/accuracy']:.4f}, engine "
        f"acc {bepoch['compiled/accuracy']:.4f}; best .nnue through the engine on "
        f"the {bhold['n']} val images equal to K1's as printed (%.10f; raw max "
        f"{bhold['print_err']:.3g}), K1's equal to the sim's; compiled/ms_per_sample at batch {bcfg.batch_size}: engine "
        f"backend {bepoch['compiled/ms_per_sample']:.4f} (loop), K1 "
        f"{k1_eval['ms_per_sample']:.4f} (evaluate_int8_sim 'mega', same "
        f"batches), on {smi}")
    hold_launches = launch_counts()
    m32 = nnue_from_checkpoint(bpayload, device="cuda")
    m32.cfg = dataclasses.replace(m32.cfg, dtype="float32")
    bopt = create_optimizer(bcfg, bsteps)
    tlabels = torch.from_numpy(ds.labels).cuda()
    tchunk = np.random.default_rng(SEED).permutation(len(ds.labels))[
        :STEP_TIMING * bcfg.batch_size].reshape(STEP_TIMING, bcfg.batch_size)
    runs = {name: (lambda st=make_train_state(m, bopt): scanned_train_steps_fused(
        st, dataset, tlabels, tchunk, pgen, optimizer=bopt, height=H,
        width=W)["loss"]) for name, m in (("float32", m32), ("bfloat16", btrained))}
    for run in runs.values():  # the eager warm-up, then the capture
        run(), run()
    times = step_ms_in_turns(runs)
    say("timing", "NNUE train step at batch "
        f"{bcfg.batch_size} ({STEP_TIMING}-step fused chunks as CUDA graph "
        "replays, QAT, full width, host clock, one sync, turns f32 bf16 bf16 "
        "f32): " + "; ".join(
            f"{k} " + ", ".join(f"{v:.3f}" for v in vs) + " ms/step"
            for k, vs in times.items()) + f" on {smi}")
    for part in (bf["launches"], hold_launches):
        for k in new_launches:
            new_launches[k] += part[k]

    # 25. distill — a float teacher into an engine_friendly student
    with tempfile.TemporaryDirectory() as tmp:
        tcfg_d = load_config(TEACHER_CONFIG)
        tcfg_d.max_epochs = 1
        teacher = train_run(tcfg_d, "etinynet", Path(tmp) / "teacher", "teacher")
        check(teacher["payload"] is not None, "the teacher wrote no checkpoint")
        tpath = Path(tmp) / "teacher" / "checkpoints" / "teacher" / "best_model.ckpt"
        dcfg = load_config(DISTILL_CONFIG)
        dcfg.distill_from = str(tpath)
        dcfg.max_epochs = DISTILL_EPOCHS
        dcfg.ef_warmup_epochs = DISTILL_WARMUP
        student = train_run(dcfg, "etinynet", Path(tmp) / "student", "student")
    dsteps = dcfg.synthetic_size // dcfg.batch_size
    check(len(student["losses"]) == DISTILL_EPOCHS * dsteps,
          f"expected {DISTILL_EPOCHS * dsteps} student losses")
    check(f"distilling from {tpath}" in student["log"]
          and f"alpha={dcfg.distill_alpha}" in student["log"],
          "the student did not distil")
    spayload = student["payload"]
    check(spayload["epoch"] >= DISTILL_WARMUP
          and spayload["model_config"]["ef_quantizers"],
          "the student's best model is a warm-up epoch")
    reset_launches()
    smodel = etinynet_from_checkpoint(spayload, device="cuda").eval()
    sval = GenericVisionDataset("synthetic-hard", split="test",
                                synthetic_size=dcfg.synthetic_size, seed=42)
    shold = hold_engine(errs, smodel, sval.images, sval.labels, 1024,
                        "distilled ef EtinyNet")
    sbest = student["epochs"][spayload["epoch"]]
    check(shold["acc"] == sbest["compiled/accuracy"],
          f"K6 val accuracy {shold['acc']} differs from the loop's sim "
          f"{sbest['compiled/accuracy']}")
    say("distill", f"teacher {TEACHER_CONFIG}, 1 epoch in "
        f"{teacher['seconds']:.2f} s, val acc "
        f"{teacher['epochs'][0]['val/accuracy']:.4f}; student {DISTILL_CONFIG} "
        f"(alpha {dcfg.distill_alpha}, T {dcfg.distill_temp}), {DISTILL_EPOCHS} "
        f"epochs ({DISTILL_WARMUP} warm-up) of {dsteps} steps at batch "
        f"{dcfg.batch_size} in {student['seconds']:.2f} s; per epoch val acc "
        + ", ".join(f"{r['val/accuracy']:.4f}" for r in student["epochs"])
        + ", compiled acc " + ", ".join(f"{r['compiled/accuracy']:.4f}"
                                        for r in student["epochs"])
        + f"; the student's .etiny on the {shold['n']} val images: K6 equal to "
        "the sim, the engine equal to K6 as printed (%.10f; raw max "
        f"{shold['print_err']:.3g})")
    for part in (teacher["launches"], student["launches"], launch_counts()):
        for k in new_launches:
            new_launches[k] += part[k]
    tmodel = etinynet_from_checkpoint(teacher["payload"], device="cuda")
    tmodel.eval().requires_grad_(False)
    dimages = torch.from_numpy(ds.images).cuda()
    dlabels = torch.from_numpy(ds.labels).cuda()
    didx = np.random.default_rng(SEED).integers(
        0, len(ds.labels), (STEP_TIMING, dcfg.batch_size))
    dopt = create_optimizer(dcfg, dsteps)
    dstate = make_train_state(etinynet_from_checkpoint(spayload, device="cuda"), dopt)
    dteacher = Teacher(tmodel, dcfg.distill_alpha, dcfg.distill_temp)
    times = step_ms_in_turns({
        name: (lambda kw=kw: torch.stack([
            gathered_train_step(dstate, dimages, dlabels, i, tgen, optimizer=dopt,
                                strength="light", **kw)["loss"] for i in didx]))
        for name, kw in (("without the teacher", {}),
                         ("with the teacher", {"teacher": dteacher}))})
    say("timing", f"distilled ef EtinyNet train step at batch {dcfg.batch_size} "
        f"({STEP_TIMING} steps, quantized, light tier, host clock, one sync, "
        "in turns): " + "; ".join(f"{k} " + ", ".join(f"{v:.3f}" for v in vs)
                                  + " ms/step" for k, vs in times.items())
        + f" on {smi}")

    # 26. resume — two epochs with step checkpoints, then one resumed
    with tempfile.TemporaryDirectory() as tmp:
        rcfg = load_config(TRAIN_CONFIG)
        rcfg.max_epochs = 2
        rcfg.checkpoint_backend = "orbax"
        rcfg.orbax_dir = str(Path(tmp) / "steps")
        first = train_run(rcfg, "nnue", Path(tmp) / "logs", "first")
        rcfg.resume = True
        rcfg.max_epochs = 3
        seen = []
        real_step = Optimizer.step

        def spy(self, params, grads, state, **kw):
            seen.append((state["count"], self.schedule(state["count"])))
            return real_step(self, params, grads, state, **kw)

        Optimizer.step = spy
        try:
            second = train_run(rcfg, "nnue", Path(tmp) / "logs", "second")
        finally:
            Optimizer.step = real_step
    rsteps = len(first["losses"]) // 2
    check("resumed from step checkpoint 1 → epoch 2" in second["log"],
          "the run did not resume at epoch 2")
    check(len(second["losses"]) == rsteps == len(seen)
          and second["launches"]["light_pipeline_kernel"] == rsteps
          and [r["step"] for r in second["epochs"]] == [3 * rsteps - 1],
          "the resumed run did not train exactly one epoch")
    want_lr = make_schedule(rcfg, rsteps)(2 * rsteps)
    check(seen[0] == (2 * rsteps, want_lr),
          f"first resumed step (count, LR) {seen[0]}, schedule (count, LR) "
          f"({2 * rsteps}, {want_lr})")
    writes = [float(v) for v in re.findall(
        r"step checkpoint \d+ written in ([0-9.]+) s", first["log"] + second["log"])]
    check(len(writes) == 3, f"expected 3 step checkpoint writes, got {writes}")
    say("resume", f"{TRAIN_CONFIG}: 2 epochs of {rsteps} steps with step "
        f"checkpoints in {first['seconds']:.2f} s, resumed at epoch 2 for one "
        f"epoch of {len(second['losses'])} steps "
        f"({second['launches']['light_pipeline_kernel']} K3 launches) in "
        f"{second['seconds']:.2f} s; first resumed step: count {seen[0][0]}, LR "
        f"{seen[0][1]!r} == the schedule's; val acc per epoch "
        + ", ".join(f"{r['val/accuracy']:.4f}" for r in first["epochs"]
                    + second["epochs"])
        + "; seconds per step-checkpoint write " + ", ".join(
            f"{v:.4f}" for v in writes) + f" on {smi}")
    for part in (first["launches"], second["launches"]):
        for k in new_launches:
            new_launches[k] += part[k]

    # 27. launches
    check(all(v > 0 for v in new_launches.values()),
          f"a kernel of 23-26 never launched: {new_launches}")
    say("launches", "engine, bf16, distillation and resume "
        + json.dumps(new_launches))
    return new_launches


def imagenet_phases(errs: Errors, smi: str) -> dict:
    """Phases 28-29: K5's band path at 224, and EtinyNet-1.0 trained, its
    int8 eval run and its `.etiny` held to the engine at 224×224; returns
    K5_BAND's JSON fields (launches, times, bound)."""
    # 28. imagenet — K5's band path held to its plain version (not counted)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    pgen = torch.Generator().manual_seed(SEED)
    for b, h, w in IMAGENET_K5_SHAPES:
        x = torch.rand((b, h, w, 3), generator=gen, device="cuda")
        noise = torch.randn(x.shape, generator=gen, device="cuda")
        for variant in ("medium", "heavy_extra"):
            draw = (aug.draw_medium_photometric if variant == "medium"
                    else aug.draw_heavy_photometric)
            f, i = (t.cuda() for t in draw(pgen, b, h, w))
            on, off = f.clone(), f.clone()
            on[:, GATES[variant]] = 1.0
            off[:, GATES[variant]] = 0.0
            for gates, fp in (("on", on), ("drawn", f), ("off", off)):
                got = pk.photometric_block(x, noise, fp, i, variant=variant)
                errs.equal(K5_BAND, f"B={b} {h}x{w} {variant} gates {gates}", got,
                           pk.photometric_block_reference(x, noise, fp, i,
                                                          variant=variant))
            check(torch.equal(got, x), f"{h}x{w} {variant} with every gate off "
                  "is not the identity")
    torch.cuda.synchronize()
    say("imagenet", f"K5 band path at {IMAGENET_K5_SHAPES} (B, H, W), medium and "
        "heavy_extra with gates on, drawn and off: all equal to plain "
        "(tolerance: none, torch.equal)")

    # K5 at 256×224 (the run's block) and the gather warp there
    b = IMAGENET_K5_SHAPES[0][0]
    x = torch.rand((b, 224, 224, 3), generator=gen, device="cuda")
    noise = torch.randn(x.shape, generator=gen, device="cuda")
    f, i = (t.cuda() for t in aug.draw_medium_photometric(pgen, b, 224, 224))

    def k5():
        return pk.photometric_block(x, noise, f, i, variant="medium")

    k, p = time_pair(k5, lambda: pk.photometric_block_reference(
        x, noise, f, i, variant="medium"))
    graph_host = (chained_best_ms(k5, GRAPH_REPS), host_ms(k5))
    # one read and one write of the batch, the params, and the noise of the
    # images whose gate 8 is on; ~60 float operations per value
    gated = int((f[:, 8] > 0.5).sum())
    k5_bound = bound(2 * nbytes(x) + nbytes(f, i) + nbytes(noise) * gated // b,
                     f32_ops=60 * x.numel())
    wparams = aug.draw_tier(pgen, "medium", b, 224, 224, "cuda").warp1
    gather_ms = time_median(lambda: aug.warp(x, wparams))
    say("timing", f"K5 band path B={b} 224x224 medium: kernel {k:.4f} ms "
        f"({b / k * 1e3:,.0f} img/s), graph-timed {graph_host[0]:.4f} ms "
        f"({GRAPH_REPS} calls per CUDA graph, best of 3), host {graph_host[1]:.4f} "
        f"ms per call, plain {p:.4f} ms; bound {k5_bound[0]:.4f} ms "
        f"({k5_bound[1]}); the gather warp (plain torch, no K4) "
        f"{gather_ms:.4f} ms; on {smi}")
    del x, noise

    # the config's one epoch, counted from here to its end
    with tempfile.TemporaryDirectory() as tmp:
        cfg = load_config(IMAGENET_CONFIG)
        cfg.synthetic_size = IMAGENET_TRAIN_SIZE
        cfg.max_epochs = 1
        cfg.checkpoint_backend = "orbax"
        cfg.orbax_dir = str(Path(tmp) / "steps")
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()  # the earlier phases' tensors
        im = train_run(cfg, "etinynet", Path(tmp) / "logs", "imagenet")
        run_peak = torch.cuda.max_memory_allocated() - base
        saved, meta = StepCheckpointer(Path(cfg.orbax_dir)).restore()
    steps = IMAGENET_TRAIN_SIZE // cfg.batch_size
    launches = im["launches"]
    check(len(im["losses"]) == steps, f"expected {steps} losses, got {im['losses']}")
    check(launches[K5_BAND] == steps and launches["photometric_kernel"] == 0,
          f"K5 launches {launches} are not one band-path launch per step")
    check(launches["warp_kernel"] == 0 and launches["etiny_block_kernel"] == 0,
          f"K4 or K6 launched on the 224 run: {launches}")
    check("Engine OK" in im["log"], "the engine probe did not run at 224")
    epoch = im["epochs"][0]
    check(all(math.isfinite(epoch[k]) for k in ("val/loss", "compiled/f1")),
          f"non-finite eval metrics: {epoch}")
    payload = im["payload"]
    check((payload is not None) == (epoch["val/f1"] > 0),
          "best_model.ckpt written against the val F1 gate")
    mcfg = EtinyNetConfig(variant=cfg.etinynet_variant, num_classes=cfg.num_classes,
                          input_size=224)
    model = EtinyNet(mcfg, device="cuda")
    model.load_state_dict(saved["model"])
    model.eval()
    check(meta["epoch"] == 0 and model.cls_w.shape == (1000, 1280)
          and model.stem_w.shape[-1] == 32, "the step checkpoint is not the "
          "EtinyNet-1.0 of epoch 0")
    if payload is not None:
        check(np.array_equal(payload["params"]["cls_w"], saved["model"]["cls_w"].numpy()),
              "best_model.ckpt differs from the epoch's step checkpoint")

    # the epoch's model through the .etiny, the sim and the engine
    val = GenericVisionDataset("imagenet", split="test",
                               synthetic_size=IMAGENET_TRAIN_SIZE, seed=cfg.seed)
    images = val.images[:IMAGENET_ENGINE_IMAGES]
    labels = val.labels[:IMAGENET_ENGINE_IMAGES]
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "etinynet_imagenet.etiny"
        q0 = etinynet_quantize(model)
        write_etiny(q0, path)
        qi = read_etiny(path)
        write_etiny(qi, Path(tmp) / "again.etiny")
        check((Path(tmp) / "again.etiny").read_bytes() == path.read_bytes(),
              ".etiny round trip changed the model")
        isize = path.stat().st_size
    check(qi.input_size == 224 and qi.num_classes == 1000, "the .etiny's header")
    isim, icfg = etiny_sim_params(qi, device="cuda")
    xs = torch.from_numpy(normalize_host(images)).cuda()
    sim_logits = etiny_engine_forward(isim, xs, cfg=icfg, image_h=224,
                                      image_w=224).cpu().numpy()
    eng, _, _, eng_s = engine_logits(model, [(images, labels)])
    np.testing.assert_array_equal(
        eng, as_engine_prints(sim_logits),
        err_msg="224: the engine's logits differ from the sim's as printed")
    # the same .etiny served through K6: 14 launches, the blocks past shared
    # memory (112, 56 and 28 on a side) on row bands
    ikp = ek.etiny_kernel_params(isim, icfg)
    bands = sum(bool(ek.band_plan(*shape)) for shape in etiny_launch_shapes(ikp, icfg, 224))
    before = dict(ek.LAUNCHES)
    k6_logits = ek.etiny_forward_kernel(ikp, xs, cfg=icfg, image_h=224, image_w=224)
    torch.cuda.synchronize()
    k6_launches = ek.LAUNCHES["etiny_block_kernel"] - before["etiny_block_kernel"]
    k6_bands = ek.LAUNCHES["band_launches"] - before["band_launches"]
    errs.equal("etiny_block_kernel", "224 K6 vs sim", k6_logits,
               torch.from_numpy(sim_logits).cuda())
    np.testing.assert_array_equal(
        eng, as_engine_prints(k6_logits.cpu().numpy()),
        err_msg="224: the engine's logits differ from K6's as printed")
    check(k6_launches == len(icfg.blocks) == 14 and k6_bands == bands == 9,
          f"224 K6: {k6_launches} launches, {k6_bands} on bands (the plan: {bands}) "
          f"for {len(icfg.blocks)} blocks")
    say("imagenet", f"{IMAGENET_CONFIG} (EtinyNet-1.0, {count_parameters(model):,} "
        f"params, 1000 classes, 224x224, float32, medium tier) on "
        f"{IMAGENET_TRAIN_SIZE} synthetic images, 1 epoch of {steps} steps at batch "
        f"{cfg.batch_size} in {im['seconds']:.2f} s (train_model: data generation, "
        f"probe and evals included); loss first {im['losses'][0]:.4f} last "
        f"{im['losses'][-1]:.4f}; val acc {epoch['val/accuracy']:.4f}, int8 (sim) "
        f"acc {epoch['compiled/accuracy']:.4f}; best_model.ckpt "
        + ("written" if payload is not None else "not written (val F1 0: at "
           "chance after 10 steps)")
        + f"; the epoch's model via a {isize}-byte .etiny: on "
        f"{IMAGENET_ENGINE_IMAGES} val images the engine's logits equal the "
        f"sim's as printed (%.10f; raw max "
        f"{float(np.abs(eng.astype(np.float64) - sim_logits).max()):.3g}), and "
        f"K6's ({k6_launches} launches, {k6_bands} on row bands) equal the sim's "
        "(torch.equal) and the engine's as printed, "
        f"{eng_s / len(labels) * 1e3:.2f} ms per image (engine, host CPU); "
        f"peak device memory of the run {run_peak / 1e9:.2f} GB (over the "
        f"{base / 1e9:.2f} GB the earlier phases hold) on {smi}")

    # ms per step at batch 256 on the val images, the epoch's model
    timg = torch.from_numpy(val.images).cuda()
    tlab = torch.from_numpy(val.labels).cuda()
    tmodel = EtinyNet(mcfg, device="cuda")
    tmodel.load_state_dict(saved["model"])
    topt = create_optimizer(cfg, steps)
    tstate = make_train_state(tmodel, topt)
    sgen = torch.Generator().manual_seed(SEED)
    noise_gen = aug.device_generator(sgen, "cuda")
    srng = np.random.default_rng(SEED)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    for run in range(2):
        idx = srng.integers(0, len(tlab), (IMAGENET_STEPS, cfg.batch_size))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step_losses = torch.stack([
            gathered_train_step(tstate, timg, tlab, i, sgen, optimizer=topt,
                                strength="medium", noise_gen=noise_gen)["loss"]
            for i in idx])
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / IMAGENET_STEPS * 1e3
        check(bool(torch.isfinite(step_losses).all()), "non-finite timing losses")
        say("timing", f"EtinyNet-1.0 train step at 224x224 ({IMAGENET_STEPS} steps, "
            f"run {run + 1}/2, batch {cfg.batch_size}, float32, medium tier): "
            f"{step_ms:.3f} ms/step ({cfg.batch_size / step_ms * 1e3:,.0f} img/s), "
            f"host clock, one sync; peak device memory of the steps "
            f"{(torch.cuda.max_memory_allocated() - base) / 1e9:.2f} GB over the "
            f"{base / 1e9:.2f} GB held; on {smi}")

    # 29. launches
    band = {K5_BAND: launches[K5_BAND], "warp_kernel": launches["warp_kernel"],
            "etiny_block_kernel": k6_launches, "band_launches": k6_bands}
    say("launches", "ImageNet-224 " + json.dumps(band))
    return dict(launches=launches[K5_BAND], k6_launches=k6_launches, ms=(k, p),
                bound=k5_bound, extra=graph_host)


# ---------------------------------------------------------------------------
# phases 30-35: data parallelism, the ranks spawned on the one card
# ---------------------------------------------------------------------------


def dp_nnue_config(log_dir) -> object:
    """Phase 31's run: config/train_nnue_hard.py at full width, one epoch cut
    to DP_NNUE_STEPS fused steps in chunks of DP_NNUE_CHUNK, int8 eval
    through K1, data-parallel over every rank."""
    cfg = train_config()
    cfg.synthetic_size = DP_NNUE_STEPS * cfg.batch_size
    cfg.steps_per_dispatch = DP_NNUE_CHUNK
    cfg.log_dir = str(log_dir)
    return cfg


def dp_etiny_config(log_dir, dtype: str = "bfloat16") -> object:
    """Phase 32's run: config/train_etinynet.py (0.98M, heavy tier, batch
    1024) on synthetic-hard images, one epoch cut to DP_ETINY_STEPS steps."""
    cfg = etiny_config()
    cfg.synthetic_size = DP_ETINY_STEPS * cfg.batch_size
    cfg.dtype = dtype
    cfg.log_dir = str(log_dir)
    return cfg


def train_kept(cfg, model_type: str, run_id: str):
    """train_model with the engine probe on (rank 0's, in a group), its
    TrainState kept: (state, seconds)."""
    kept = []
    real = tloop.make_train_state
    tloop.make_train_state = lambda *a, **k: kept.append(real(*a, **k)) or kept[-1]
    os.environ.pop("NV_SKIP_ENGINE", None)
    try:
        t0 = time.perf_counter()
        check(train_model(cfg, model_type, run_id, device="cuda") == 0,
              f"train_model failed on {cfg.name}")
        return kept[-1], time.perf_counter() - t0
    finally:
        tloop.make_train_state = real


def run_records(log_dir, run_id: str) -> tuple:
    """(the step losses, the last epoch's record) of a run's metrics."""
    path = Path(log_dir) / "runs" / run_id / "metrics.jsonl"
    records = [json.loads(line) for line in path.read_text().splitlines()]
    return ([r["train/loss"] for r in records if "train/loss" in r],
            [r for r in records if "compiled/f1" in r][-1])


def cpu_state(model) -> dict:
    return {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}


def collective_checks(axis: tmesh.Axis) -> str:
    """The port's collectives on CUDA tensors over `axis`: the zero-slot
    all_gather of float32 and int32 tensors bit-equal to the concatenation
    of every rank's tensor (each rank makes every rank's from its seed),
    the differentiable all_reduce's sum and gradient, a broadcast and a
    barrier; raises on any difference."""
    def tensors(r):
        g = torch.Generator(device="cuda").manual_seed(100 + r)
        return (torch.randn((3, 7), generator=g, device="cuda"),
                torch.randint(-2**30, 2**30, (5,), generator=g, device="cuda",
                              dtype=torch.int32))

    f, i = tensors(axis.index)
    every = [tensors(r) for r in range(axis.size)]
    gathered = tmesh.all_gather(f, axis)
    check(torch.equal(gathered.view(torch.int32),
                      torch.cat([e[0] for e in every]).view(torch.int32)),
          "all_gather of float32 is not bit-equal to the concatenation")
    check(torch.equal(tmesh.all_gather(i, axis), torch.cat([e[1] for e in every])),
          "all_gather of int32 is not equal to the concatenation")
    x = f.clone().requires_grad_(True)
    y = tmesh.all_reduce(x, axis)
    check(torch.equal(y.detach(), sum(e[0] for e in every)), "all_reduce sum differs")
    (y * (axis.index + 1)).sum().backward()
    check(torch.equal(x.grad, torch.full_like(f, axis.size * (axis.size + 1) / 2)),
          "all_reduce gradient differs")
    ref = f.clone() if axis.index == 0 else torch.zeros_like(f)
    dist.broadcast(ref, src=0, group=axis.group)
    check(torch.equal(ref, every[0][0]), "broadcast differs from rank 0's tensor")
    dist.barrier(group=axis.group)
    return (f"all_gather f32/i32 bit-equal to the concatenation, all_reduce sum "
            f"and gradient ({axis.size}·{axis.size + 1}/2), broadcast, barrier on "
            f"CUDA tensors over {axis.size} rank(s) ({dist.get_backend(axis.group)})")


def collective_calls(fn) -> list:
    """(numel, dtype) of every all_reduce that fn() makes."""
    calls = []
    real = dist.all_reduce

    def spy(t, *a, **k):
        calls.append((t.numel(), t.dtype))
        return real(t, *a, **k)

    dist.all_reduce = spy
    try:
        fn()
    finally:
        dist.all_reduce = real
    return calls


def replay_ms(mesh: tmesh.Mesh, calls: list, reps: int = 3) -> float:
    """Host ms of `calls`' all_reduces alone over the mesh (median of reps,
    one sync each)."""
    bufs = [torch.zeros(n, dtype=dtype, device="cuda") for n, dtype in calls]
    times = []
    for _ in range(reps):
        mesh.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in bufs:
            dist.all_reduce(b, group=mesh.group)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def dp_turns(mesh: tmesh.Mesh, make_run, steps: int) -> dict:
    """ms per step of `make_run(two)()` (`steps` steps that return their
    losses) for one rank (rank 0 alone, the other waiting at a barrier) and
    for two ranks, host clock and one sync per run, in the turns one, two,
    two, one after one untimed run of each; with the all_reduces of one
    two-rank run replayed alone (their count and ms per step)."""
    times = {"one": [], "two": []}
    for n, mode in enumerate(("one", "two") + DP_TURNS):
        mesh.barrier()
        if mode == "one" and not mesh.first:
            continue
        run = make_run(mode == "two")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = run()
        torch.cuda.synchronize()
        check(bool(torch.isfinite(losses).all()), f"non-finite {mode}-rank losses")
        if n >= 2:
            times[mode].append((time.perf_counter() - t0) / steps * 1e3)
    mesh.barrier()
    calls = collective_calls(make_run(True))
    return dict(times, collectives=len(calls) / steps,
                collective_ms=replay_ms(mesh, calls) / steps,
                collective_bytes=sum(n * torch.tensor([], dtype=d).element_size()
                                     for n, d in calls) / steps)


def nnue_turns(mesh: tmesh.Mesh) -> dict:
    """Phase 31's timing: fused chunks of DP_NNUE_STEPS steps of the full
    width NNUE at the global batch of 512."""
    cfg = dp_nnue_config("unused")
    ds = GenericVisionDataset("synthetic-hard", split="train",
                              synthetic_size=cfg.synthetic_size, seed=42)
    dataset = ip.prepare_gather_dataset(torch.from_numpy(ds.images).cuda())
    labels = torch.from_numpy(ds.labels).cuda()
    idx = np.random.default_rng(SEED).permutation(len(ds.labels)).reshape(
        DP_NNUE_STEPS, cfg.batch_size)

    def make_run(two: bool):
        model, _ = tloop.build_model(cfg, "nnue", torch.Generator().manual_seed(SEED),
                                     "cuda")
        opt = create_optimizer(cfg, DP_NNUE_STEPS)
        state = make_train_state(model, opt, mesh if two else None)

        def run():
            state.chunk_graph = None  # eager, as a mesh's chunks run
            return scanned_train_steps_fused(
                state, dataset, labels, idx, torch.Generator().manual_seed(SEED),
                optimizer=opt, height=H, width=W)["loss"]

        return run

    return dp_turns(mesh, make_run, DP_NNUE_STEPS)


@functools.lru_cache(maxsize=1)
def etiny_data() -> tuple:
    """Phase 32's direct steps' data on the card: the synthetic-hard images
    and labels of its run, and DP_ETINY_STEPS global batches of indices."""
    cfg = dp_etiny_config("unused")
    ds = GenericVisionDataset("synthetic-hard", split="train",
                              synthetic_size=cfg.synthetic_size, seed=42)
    idx = np.random.default_rng(SEED).permutation(len(ds.labels)).reshape(
        DP_ETINY_STEPS, cfg.batch_size)
    return torch.from_numpy(ds.images).cuda(), torch.from_numpy(ds.labels).cuda(), idx


def etiny_steps(mesh, dtype: str = "bfloat16", steps: int = DP_ETINY_STEPS):
    """`steps` gathered heavy-tier steps of the 0.98M EtinyNet in `dtype` at
    the global batch of 1024, from the seed's params, with its norms bound
    to `mesh` (None: one process): (state, a function that runs the steps
    and returns their losses)."""
    cfg = dp_etiny_config("unused", dtype)
    images, labels, idx = etiny_data()
    model, _ = tloop.build_model(cfg, "etinynet", torch.Generator().manual_seed(SEED),
                                 "cuda")
    tmesh.bind_data_axis(model, mesh)
    opt = create_optimizer(cfg, DP_ETINY_STEPS)
    state = make_train_state(model, opt, mesh)
    gen = torch.Generator().manual_seed(SEED)
    noise_gen = aug.device_generator(gen, "cuda")
    return state, lambda: torch.stack([gathered_train_step(
        state, images, labels, i, gen, optimizer=opt, strength="heavy",
        noise_gen=noise_gen)["loss"] for i in idx[:steps]])


def etiny_turns(mesh: tmesh.Mesh) -> dict:
    """Phase 32's timing: DP_ETINY_STEPS gathered heavy-tier steps of the
    bf16 0.98M EtinyNet at the global batch of 1024."""
    return dp_turns(mesh, lambda two: etiny_steps(mesh if two else None)[1],
                    DP_ETINY_STEPS)


def etiny_first_step(mesh, dtype: str) -> dict:
    """The first of etiny_steps' steps: its loss, and the params and norm
    statistics before and after it."""
    state, run = etiny_steps(mesh, dtype, steps=1)
    init = cpu_state(state.model)
    loss = float(run()[0])
    return dict(loss=loss, init=init, params=cpu_state(state.model))


def etiny_step_gap(got: dict, want: dict) -> tuple:
    """Two first steps from the same params: (the loss's relative
    difference, the norm statistics' largest absolute difference, the
    largest difference of a parameter's update over max(LR, that
    update's largest magnitude)), which the CPU tests' EtinyNet bar holds
    to 1e-5, 1e-5 and 1e-4."""
    lr = dp_etiny_config("unused").learning_rate
    stats = update = 0.0
    for k, w in want["params"].items():
        g, w = got["params"][k].double(), w.double()
        if k.endswith((".mean", ".var")):
            stats = max(stats, float((g - w).abs().max()))
            continue
        d_want = w - want["init"][k].double()
        d_got = g - got["init"][k].double()
        scale = max(lr, float(d_want.abs().max()))
        update = max(update, float((d_got - d_want).abs().max()) / scale)
    return rel_diff(got["loss"], want["loss"]), stats, update


def shard_augment_check(rank: int) -> str:
    """Phase 32's heavy tier on this rank's rows of a global batch of 1024
    (K4 and K5 at 512): apply_tier on the shard's rows of the global draws
    and noise, torch.equal to the plain chain (warp_bilinear_reference,
    photometric_block_reference) on the same rows."""
    b, shard = etiny_config().batch_size, (rank, 2)
    rows = aug.shard_rows(b, shard)
    ds = GenericVisionDataset("synthetic-hard", split="train", synthetic_size=b,
                              seed=42)
    x0 = torch.from_numpy(ds.images[rows]).cuda()
    draws = aug.draw_tier(torch.Generator().manual_seed(SEED + 32), "heavy", b, H, W,
                          "cuda", shard)
    got = aug.apply_tier(x0, draws, torch.Generator(device="cuda").manual_seed(SEED),
                         shard)
    noise_gen = torch.Generator(device="cuda").manual_seed(SEED)

    def noise():
        return torch.randn((b, H, W, 3), generator=noise_gen, device="cuda")[rows]

    x = wk.warp_bilinear_reference(x0, draws.warp1)
    x = pk.photometric_block_reference(x, noise(), *draws.photo1, variant="medium")
    x = wk.warp_bilinear_reference(x, draws.warp2)
    want = pk.photometric_block_reference(x, noise(), *draws.photo2,
                                          variant="heavy_extra")
    check(got.shape == (b // 2, H, W, 3) and torch.equal(got, want),
          f"rank {rank}: the heavy tier on its shard differs from the plain chain "
          "on the global draws' rows")
    return (f"heavy tier on rows {rows.start}-{rows.stop - 1} of {b} (K4, K5 at "
            f"{b // 2}) == the plain chain on the global draws and noise")


def dp_serve_inputs() -> torch.Tensor:
    gen = torch.Generator(device="cuda").manual_seed(SEED + 33)
    return normalize_images(torch.rand((DP_SERVE_BATCH, H, W, 3), generator=gen,
                                       device="cuda")).contiguous()


def dp_serve_fns(tmp: Path) -> dict:
    """{name: (kernel forward of a batch, its plain version)} of the
    flagship .nnue through K1 and the 0.98M .etiny through K6, each giving
    a tuple of tensors."""
    sim, cfg = nnue_sim_params(read_nnue(tmp / "flagship.nnue"), device="cuda")
    mega = nk.mega_head_params(sim, cfg, H, W)
    esim, ecfg = etiny_sim_params(read_etiny(tmp / "etinynet.etiny"), device="cuda")
    kp = ek.etiny_kernel_params(esim, ecfg)
    kw = dict(image_h=H, image_w=W)
    return {
        "nnue_mega_kernel": (
            lambda t: nk.nnue_engine_forward_mega(mega, t.reshape(len(t), -1),
                                                  cfg=cfg, **kw),
            lambda t: nnue_engine_forward(sim, t, cfg=cfg, **kw)),
        "etiny_block_kernel": (
            lambda t: (ek.etiny_forward_kernel(kp, t, cfg=ecfg, **kw),),
            lambda t: (etiny_engine_forward(esim, t, cfg=ecfg, **kw),)),
    }


def dp_pair_rank(rank: int, tmp: str) -> None:
    """One of two gloo ranks that share the card (NCCL refuses two ranks on
    one card): phase 30's collectives, 31's and 32's data-parallel
    train_model runs with their timing in turns, 32's heavy tier on the
    rank's shard against the plain chain, its float32 run and first steps,
    and 33's sharded serving; its results and its launches per phase go
    to tmp."""
    tmp = Path(tmp)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    initialize_distributed(f"file://{tmp}/rdv_pair", 2, rank, backend="gloo",
                           timeout_s=DP_TIMEOUT_S)
    mesh = tmesh.make_mesh(2, device="cuda")
    out = {"collectives": collective_checks(mesh.axis(tmesh.DATA_AXIS)),
           "shard_augment": shard_augment_check(rank)}
    for key, model_type, cfg in (
            ("nnue", "nnue", dp_nnue_config(tmp / "dp_nnue")),
            ("etiny", "etinynet", dp_etiny_config(tmp / "dp_etiny"))):
        reset_launches()
        state, seconds = train_kept(cfg, model_type, f"dp_{key}")
        out[key] = dict(seconds=seconds, launches=launch_counts(),
                        state=cpu_state(state.model))
        out[key]["timing"] = (nnue_turns if key == "nnue" else etiny_turns)(mesh)
    train_kept(dp_etiny_config(tmp / "dp_etiny32", "float32"), "etinynet",
               "dp_etiny32")
    out["etiny_first"] = {dtype: etiny_first_step(mesh, dtype) for dtype in DTYPES}
    out["etiny64_losses"] = etiny_steps(mesh, "float64", DP_ETINY_HELD)[1]().cpu()
    reset_launches()
    x = dp_serve_inputs()
    out["serve"] = {name: tuple(t.cpu() for t in tmesh.shard_map(fn, mesh)(x))
                    for name, (fn, _) in dp_serve_fns(tmp).items()}
    torch.cuda.synchronize()
    out["serve_launches"] = launch_counts()
    torch.save(out, tmp / f"pair_rank{rank}.pt")
    dist.destroy_process_group()


def dp_nccl_rank(rank: int, tmp: str) -> None:
    """One of two NCCL ranks, one card each: phase 30's collectives."""
    initialize_distributed(f"file://{tmp}/rdv_nccl2", 2, rank, backend="nccl",
                           timeout_s=DP_TIMEOUT_S)
    collective_checks(tmesh.make_mesh(2, device="cuda").axis(tmesh.DATA_AXIS))
    dist.destroy_process_group()


def dp_tp_model():
    """Phase 34's flagship QAT NNUE (numpy seed 42) and its optimizer."""
    model = nnue_from_jax_params(flagship_params(np.random.default_rng(SEED), FLAGSHIP),
                                 FLAGSHIP, device="cuda")
    return model, create_optimizer(train_config(), 39)


def dp_tp_rank(rank: int, tmp: str) -> None:
    """One of four gloo ranks on the card, a (data 2, model 2) mesh: one
    train step of the flagship NNUE with its L1 split over the model axis."""
    tmp = Path(tmp)
    initialize_distributed(f"file://{tmp}/rdv_tp", 4, rank, backend="gloo",
                           timeout_s=DP_TIMEOUT_S)
    mesh = tmesh.make_mesh(4, (tmesh.DATA_AXIS, tmesh.MODEL_AXIS), shape=(2, 2),
                           device="cuda")
    model, opt = dp_tp_model()
    tmesh.shard_params(mesh, model)
    state = make_train_state(model, opt, mesh)
    x, y = torch.load(tmp / "tp_batch.pt")
    x, y = tmesh.shard_batch(mesh, (x.cuda(), y.cuda()))
    loss = float(train_step(state, x, y, optimizer=opt)["loss"])
    params = {k: v.cpu() for k, v in tmesh.unshard_params(mesh, model).items()}
    torch.save(dict(loss=loss, params=params, ft_w=tuple(model.ft_w.shape)),
               tmp / f"tp_rank{rank}.pt")
    dist.destroy_process_group()


def clear_batch(model, n: int) -> tuple:
    """n normalized images whose every conv output (the QAT model's rounded
    weights and mean threshold, in float64) lies DP_TP_MARGIN or more from
    the threshold, and labels: no feature then flips on a last-bit
    difference between the sharded and the whole conv."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 34)
    x = normalize_images(torch.rand((4 * n, H, W, 3), generator=gen, device="cuda"))
    w = model.conv_w.detach().double()
    w = torch.round(torch.clamp(w, -127 / 64, 127 / 64) * 64) / 64
    t = float(model.visual_threshold.detach().double().mean())
    conv = torch.nn.functional.conv2d(x.double().permute(0, 3, 1, 2), w,
                                      stride=model.cfg.conv_stride, padding=1)
    keep = (conv - t).abs().amin(dim=(1, 2, 3)) > DP_TP_MARGIN
    check(int(keep.sum()) >= n, f"only {int(keep.sum())} clear images of {4 * n}")
    labels = torch.randint(0, FLAGSHIP.num_classes, (n,), generator=gen, device="cuda")
    return x[keep][:n].contiguous().cpu(), labels.cpu()


def rel_diffs(a, b) -> np.ndarray:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b) / np.maximum(np.abs(b), 1e-30)


def rel_diff(a, b) -> float:
    return float(np.max(rel_diffs(a, b)))


def param_diff(got: dict, want: dict) -> float:
    return max(float((got[k].double().cpu() - want[k].double().cpu()).abs().max())
               for k in want)


def dp_phases(errs: Errors, smi: str, model, qe) -> dict:
    """Phases 30-35; `model` is the flagship NNUE of phase 3, `qe` the 0.98M
    .etiny of phase 13. Returns {kernel: [launches of rank 0, rank 1]} of
    the data-parallel paths 31-33."""
    tmp_dir = tempfile.TemporaryDirectory()
    tmp = Path(tmp_dir.name)
    write_nnue(nnue_quantize(model), tmp / "flagship.nnue")
    write_etiny(qe, tmp / "etinynet.etiny")

    # 30. dp-init — NCCL at world size 1 here, gloo with two ranks on the card
    # (in the ranks of 31-33), NCCL with two ranks where there are two cards
    initialize_distributed(f"file://{tmp}/rdv_nccl1", 1, 0, backend="nccl",
                           timeout_s=DP_TIMEOUT_S)
    try:
        nccl1 = collective_checks(tmesh.Axis(tmesh.DATA_AXIS, 1, 0, dist.group.WORLD))
    finally:
        dist.destroy_process_group()
    say("dp-init", f"NCCL, world size 1: {nccl1}")
    ran = ["nccl world 1", "gloo 2 ranks on card 0"]
    if torch.cuda.device_count() >= 2:
        spawn(dp_nccl_rank, 2, (str(tmp),), timeout_s=DP_JOIN_S)
        ran.append("nccl 2 ranks on 2 cards")
    t0 = time.perf_counter()
    spawn(dp_pair_rank, 2, (str(tmp),), timeout_s=DP_JOIN_S)
    pair_s = time.perf_counter() - t0
    ranks = [torch.load(tmp / f"pair_rank{r}.pt", weights_only=False) for r in range(2)]
    say("dp-init", f"gloo, two ranks on one card: {ranks[0]['collectives']}; ran: "
        f"{', '.join(ran)}; NCCL two ranks "
        + ("ran" if len(ran) == 3 else f"not run ({torch.cuda.device_count()} card)")
        + f"; the two ranks' phases 30-33 took {pair_s:.1f} s")

    # 31. dp-nnue — one process on the same seed, against the two ranks
    state1, seconds1 = train_kept(dp_nnue_config(tmp / "one_nnue"), "nnue", "one_nnue")
    losses1, _ = run_records(tmp / "one_nnue", "one_nnue")
    losses2, epoch2 = run_records(tmp / "dp_nnue", "dp_nnue")
    one_params = cpu_state(state1.model)
    for r in ranks:
        check(r["nnue"]["launches"]["light_pipeline_kernel"] == DP_NNUE_STEPS,
              f"K3 launched {r['nnue']['launches']['light_pipeline_kernel']} "
              f"times on a rank, not once per step ({DP_NNUE_STEPS})")
        check(r["nnue"]["launches"]["nnue_mega_kernel"] > 0, "K1 not run on a rank")
    check(all(torch.equal(ranks[0]["nnue"]["state"][k], ranks[1]["nnue"]["state"][k])
              for k in one_params), "the two ranks' NNUE params differ")
    loss_rel = rel_diff(losses2, losses1)
    p_diff = param_diff(ranks[0]["nnue"]["state"], one_params)
    check(len(losses2) == len(losses1) == DP_NNUE_STEPS, "step counts differ")
    check(loss_rel <= 1e-6 and p_diff <= 1e-6,
          f"dp NNUE differs from one process: losses rel {loss_rel:.3g}, params "
          f"{p_diff:.3g} (tolerance 1e-6 each)")
    dp_model = nnue_from_jax_params(
        {k: v.numpy() for k, v in ranks[0]["nnue"]["state"].items()},
        state1.model.cfg, device="cuda")
    val = GenericVisionDataset("synthetic-hard", split="test",
                               synthetic_size=DP_NNUE_STEPS * 512, seed=42)
    vloader = [(val.images[i:i + 1024], val.labels[i:i + 1024])
               for i in range(0, len(val.labels), 1024)]
    int8 = evaluate_int8_sim(dp_model, vloader, use_pallas="mega")
    for k in ("accuracy", "f1", "latent_density"):
        got = epoch2[f"compiled/{k}"]
        want = int8["acc" if k == "accuracy" else k]
        check(got == want, f"dp int8 {k} {got} differs from one process's K1 {want}")
    nt = ranks[0]["nnue"]["timing"]
    say("dp-nnue", f"{TRAIN_CONFIG}, {DP_NNUE_STEPS} fused steps at batch 512 "
        f"(two ranks of 256, gloo on one card) in {ranks[0]['nnue']['seconds']:.2f} s "
        f"vs one process in {seconds1:.2f} s (train_model, data and evals "
        f"included); K3 per rank {[r['nnue']['launches']['light_pipeline_kernel'] for r in ranks]}, "
        f"K1 per rank {[r['nnue']['launches']['nnue_mega_kernel'] for r in ranks]}; "
        f"losses equal one process to rel {loss_rel:.3g}, params to {p_diff:.3g} "
        f"(tolerance 1e-6); the dp run's int8 eval (K1 on each shard) == one "
        f"process's K1 on its checkpoint: "
        + json.dumps({k: epoch2[f'compiled/{k}'] for k in ('accuracy', 'f1', 'latent_density')}))
    say("dp-nnue", f"ms per fused step at batch 512, host clock, one sync per "
        f"{DP_NNUE_STEPS} steps, in turns: one rank {[round(v, 4) for v in nt['one']]}, "
        f"two ranks {[round(v, 4) for v in nt['two']]}; the two-rank step's "
        f"{nt['collectives']:.0f} all_reduce(s) of {nt['collective_bytes'] / 1e6:.3f} MB "
        f"replayed alone: {nt['collective_ms']:.4f} ms per step; on {smi}")

    # 32. dp-etiny — one process in bf16 and in float32 on the same seed
    state1e, seconds1e = train_kept(dp_etiny_config(tmp / "one_etiny"), "etinynet",
                                    "one_etiny")
    elosses1, _ = run_records(tmp / "one_etiny", "one_etiny")
    train_kept(dp_etiny_config(tmp / "one_etiny32", "float32"), "etinynet",
               "one_etiny32")
    elosses32, _ = run_records(tmp / "one_etiny32", "one_etiny32")
    elosses2, _ = run_records(tmp / "dp_etiny", "dp_etiny")
    elosses2_32, _ = run_records(tmp / "dp_etiny32", "dp_etiny32")
    for r in ranks:
        for name in ("warp_kernel", "photometric_kernel"):
            check(r["etiny"]["launches"][name] == 2 * DP_ETINY_STEPS,
                  f"{name} launched {r['etiny']['launches'][name]} times on a "
                  f"rank, not twice per step")
    buffers = [k for k in ranks[0]["etiny"]["state"] if k.endswith((".mean", ".var"))]
    check(buffers and all(torch.equal(ranks[0]["etiny"]["state"][k],
                                      ranks[1]["etiny"]["state"][k]) for k in buffers),
          "the ranks' BatchNorm running statistics differ")
    check(all(len(v) == DP_ETINY_STEPS for v in (elosses1, elosses2, elosses32,
                                                 elosses2_32)), "step counts differ")
    # every first step against one process's on the same params and images,
    # and one process's bf16 against its float32 and against its rerun
    first = {d: etiny_first_step(None, d) for d in DTYPES}
    gaps = {f"dp {d} vs one {d}": tuple(np.max(
        [etiny_step_gap(r["etiny_first"][d], first[d]) for r in ranks], axis=0))
        for d in DTYPES}
    gaps["one bf16 vs one float32"] = etiny_step_gap(first["bfloat16"],
                                                     first["float32"])
    gaps["one bf16 vs its rerun"] = etiny_step_gap(etiny_first_step(None, "bfloat16"),
                                                   first["bfloat16"])
    l64 = rel_diffs(ranks[0]["etiny64_losses"],
                    etiny_steps(None, "float64", DP_ETINY_HELD)[1]().cpu())
    f_rel = rel_diffs(elosses2_32, elosses32)
    e_rel, spread = rel_diffs(elosses2, elosses1), rel_diffs(elosses1, elosses32)
    say("dp-etiny", f"{ranks[0]['shard_augment']} on both ranks (tolerance: none, "
        f"torch.equal); first step (loss rel, norm statistics, update over "
        f"max(LR, its largest)): " + "; ".join(
            f"{k} {v[0]:.3g}, {v[1]:.3g}, {v[2]:.3g}" for k, v in gaps.items())
        + f"; float64 losses of steps 1-{DP_ETINY_HELD}, two ranks vs one "
        f"process: rel {np.array2string(l64, precision=3)}; float32 train_model, "
        f"two ranks vs one process: rel {np.array2string(f_rel, precision=3)}")
    # float64 compute (float32 params), held to the CPU tests' EtinyNet bar:
    # the first step's loss, norm statistics and update, and the losses of
    # the steps before the config's SGD at 0.5 diverges on synthetic-hard.
    # In float32 at batch 1024 the order of a sum alone moves the first
    # update by ~3e-3 of its scale (ReLU6's and the norms' amplification;
    # PERF.md), past the bar, so float32 and bf16 are printed above.
    g64 = gaps["dp float64 vs one float64"]
    check(g64[0] <= 1e-5 and g64[1] <= 1e-5 and g64[2] <= 1e-4,
          f"dp float64 EtinyNet's first step differs from one process: loss rel "
          f"{g64[0]:.3g}, norm statistics {g64[1]:.3g}, update {g64[2]:.3g} "
          "(bar 1e-5, 1e-5, 1e-4)")
    check(float(l64.max()) <= 1e-5,
          f"dp float64 EtinyNet's losses of steps 1-{DP_ETINY_HELD} differ from "
          f"one process by rel {l64} (bar 1e-5)")
    # bf16: the first step's loss (the same params and images) within one
    # bf16 ulp, 2^-8 relative
    check(e_rel[0] <= 2.0 ** -8,
          f"dp bf16 EtinyNet's first loss differs from one process by rel "
          f"{e_rel[0]:.3g}, past one bf16 ulp (2^-8)")
    et = ranks[0]["etiny"]["timing"]
    say("dp-etiny", f"{ETINY_CONFIG} (0.98M, bf16, heavy tier), {DP_ETINY_STEPS} "
        f"steps at batch 1024 (two ranks of 512) in {ranks[0]['etiny']['seconds']:.2f} s "
        f"vs one process in {seconds1e:.2f} s; K4 per rank "
        f"{[r['etiny']['launches']['warp_kernel'] for r in ranks]}, K5 per rank "
        f"{[r['etiny']['launches']['photometric_kernel'] for r in ranks]}; "
        f"losses {elosses2[0]:.4f} → {elosses2[-1]:.4f}; from one process rel "
        f"{e_rel[0]:.3g} at step 1 (bar 2^-8), then "
        f"{np.array2string(e_rel[1:], precision=3)} (one process's bf16 vs "
        f"float32: {np.array2string(spread, precision=3)}); {len(buffers)} "
        "BatchNorm statistics equal on both ranks")
    say("dp-etiny", f"ms per step at batch 1024, host clock, one sync per "
        f"{DP_ETINY_STEPS} steps, in turns: one rank {[round(v, 3) for v in et['one']]}, "
        f"two ranks {[round(v, 3) for v in et['two']]}; the two-rank step's "
        f"{et['collectives']:.0f} all_reduce(s) of {et['collective_bytes'] / 1e6:.3f} MB "
        f"replayed alone: {et['collective_ms']:.3f} ms per step; on {smi}")

    # 33. dp-serve — the gathered shards against one process's kernel and plain
    x = dp_serve_inputs()
    for name, (fn, plain) in dp_serve_fns(tmp).items():
        whole, ref = fn(x), plain(x)
        for r in ranks:
            got = [t.cuda() for t in r["serve"][name]]
            check(len(got) == len(whole), f"{name}: gathered outputs differ in number")
            for g, w, p in zip(got, whole, ref):
                errs.equal(name, f"dp-serve B={DP_SERVE_BATCH} gathered vs one "
                           "process", g, w)
                errs.equal(name, f"dp-serve B={DP_SERVE_BATCH} gathered vs plain",
                           g, p)
        check(all(r["serve_launches"][name] > 0 for r in ranks),
              f"{name} not launched on a rank's shard")
    say("dp-serve", f"flagship .nnue through K1 and 0.98M .etiny through K6 at "
        f"batch {DP_SERVE_BATCH}, {DP_SERVE_BATCH // 2} per rank: the gathered "
        "logits (and K1's densities and counts) equal one process's kernel and "
        "the plain version (tolerance: none, torch.equal); launches per rank "
        + json.dumps({k: [r["serve_launches"][k] for r in ranks]
                      for k in ("nnue_mega_kernel", "etiny_block_kernel")}))

    # 34. dp-tp — four ranks, data 2 × model 2, one flagship step
    tp_model, tp_opt = dp_tp_model()
    xb, yb = clear_batch(tp_model, DP_TP_BATCH)
    torch.save((xb, yb), tmp / "tp_batch.pt")
    spawn(dp_tp_rank, 4, (str(tmp),), timeout_s=DP_JOIN_S)
    tp_state = make_train_state(tp_model, tp_opt)
    tp_loss = float(train_step(tp_state, xb.cuda(), yb.cuda(), optimizer=tp_opt)["loss"])
    tp_params = cpu_state(tp_model)
    worst = (0.0, 0.0)
    for r in range(4):
        got = torch.load(tmp / f"tp_rank{r}.pt", weights_only=False)
        check(got["ft_w"] == (FLAGSHIP.feature_set.num_features, FLAGSHIP.l1_size // 2),
              f"rank {r} holds ft_w {got['ft_w']}, not half of L1")
        worst = max(worst[0], rel_diff(got["loss"], tp_loss)), max(
            worst[1], param_diff(got["params"], tp_params))
    check(worst[0] <= 1e-5 and worst[1] <= 1e-5,
          f"dp×tp step differs from one process: loss rel {worst[0]:.3g}, params "
          f"{worst[1]:.3g} (tolerance 1e-5)")
    say("dp-tp", f"four gloo ranks on the card (data 2 × model 2), one flagship "
        f"QAT step at batch {DP_TP_BATCH} (images with every conv output "
        f"{DP_TP_MARGIN} from the threshold): loss {tp_loss:.6f}, equal to one "
        f"process to rel {worst[0]:.3g}, params to {worst[1]:.3g} (tolerance 1e-5)")

    # 35. launches
    dp = {name: [r[key]["launches"][name] for r in ranks]
          for key, name in (("nnue", "light_pipeline_kernel"),
                            ("nnue", "nnue_mega_kernel"),
                            ("etiny", "warp_kernel"), ("etiny", "photometric_kernel"))}
    for name in ("nnue_mega_kernel", "etiny_block_kernel"):
        dp[name] = [a + r["serve_launches"][name]
                    for a, r in zip(dp.get(name, [0, 0]), ranks)]
    check(all(n > 0 for v in dp.values() for n in v),
          f"a kernel of 31-33 never launched on a rank: {dp}")
    say("launches", "data-parallel, per rank " + json.dumps(dp))
    tmp_dir.cleanup()
    return dp


# ---------------------------------------------------------------------------
# phases 36-40: the deployment entry points
# ---------------------------------------------------------------------------

# a few requests: the CLIs on checkpoints of earlier phases (the evaluate
# CLI on phase 10's held-out split: its dataset, size and seed), the stream
# at the demo's defaults
EVAL_SPLIT = ("--dataset", "synthetic-hard", "--synthetic_size", "20000",
              "--batch_size", "1024", "--seed", str(SEED))
STREAM_FRAMES, STREAM_BATCH = 64, 256
ENGINE_IMAGES = 64
UPSTREAM_KEYS = {  # the port's NNUE parameter → its upstream state-dict key
    "conv_w": "conv.weight", "visual_threshold": "visual_threshold",
    "ft_w": "input.weight", "ft_b": "input.bias",
    "fc1_w": "classifier.classifier.0.weight",
    "fc1_b": "classifier.classifier.0.bias",
    "fc2_w": "classifier.classifier.2.weight",
    "fc2_b": "classifier.classifier.2.bias",
    "out_w": "classifier.classifier.4.weight",
    "out_b": "classifier.classifier.4.bias", "nnue2score": "nnue2score",
}


def port_cli(module: str, *args) -> tuple:
    """`python -m nnue_vision_tpu_torch.<module> ARGS` from the repository
    root, on the card (the default): (stdout, stderr, wall seconds); a
    non-zero exit fails the run."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", f"nnue_vision_tpu_torch.{module}", *map(str, args)],
        cwd=Path(__file__).resolve().parent, capture_output=True, text=True,
        timeout=600)
    seconds = time.perf_counter() - t0
    check(proc.returncode == 0, f"{module} {args} exited {proc.returncode}: "
          f"{proc.stderr[-3000:]}")
    return proc.stdout, proc.stderr, seconds


def cli_lines(out: str) -> dict:
    """{"float" | "int8-sim" | "engine": {metric: printed text}}."""
    lines = {}
    for line in out.splitlines():
        tag, _, rest = line.partition(": ")
        if tag in ("float", "int8-sim", "engine"):
            lines[tag] = dict(kv.split("=") for kv in rest.split())
    return lines


def upstream_state_dict(cfg: NNUEConfig, gen: torch.Generator) -> dict:
    """An upstream NNUE state dict at `cfg`'s widths (`input.weight` is
    (F, L1)), with the JAX package's init ranges, from `gen`."""
    fs = cfg.feature_set
    ch, l1, l2, l3, c = (fs.num_features_per_square, cfg.l1_size, cfg.l2_size,
                         cfg.l3_size, cfg.num_classes)

    def u(fan_in, *shape):
        return (torch.rand(shape, generator=gen) * 2 - 1) / math.sqrt(fan_in)

    return {
        "conv.weight": u(27, ch, 3, 3, 3),
        "visual_threshold": torch.full((ch,), 0.1),
        "input.weight": torch.randn((fs.num_features, l1), generator=gen) * 0.1,
        "input.bias": torch.randn((l1,), generator=gen) * 0.05,
        "classifier.classifier.0.weight": u(l1, l2, l1),
        "classifier.classifier.0.bias": u(l1, l2),
        "classifier.classifier.2.weight": u(l2, l3, l2),
        "classifier.classifier.2.bias": u(l2, l3),
        "classifier.classifier.4.weight": u(l3, c, l3),
        "classifier.classifier.4.bias": u(l3, c),
        "nnue2score": torch.tensor(600.0),
    }


def serve_file(errs: Errors, path: Path, gen: torch.Generator, tag: str) -> None:
    """A written `.nnue` through K1, or `.etiny` through K6, at the timing
    batch, torch.equal to the sim."""
    x = normalize_images(torch.rand((TIMING_BATCH, H, W, 3), generator=gen,
                                    device="cuda")).contiguous()
    kw = dict(image_h=H, image_w=W)
    if path.suffix == ".nnue":
        sim, kw["cfg"] = nnue_sim_params(read_nnue(path), device="cuda")
        head = nk.mega_head_params(sim, kw["cfg"], H, W)
        errs.outputs("nnue_mega_kernel", f"{tag} K1 vs sim",
                     nk.nnue_engine_forward_mega(head, x.reshape(len(x), -1), **kw),
                     nnue_engine_forward(sim, x, **kw))
    else:
        sim, kw["cfg"] = etiny_sim_params(read_etiny(path), device="cuda")
        errs.equal("etiny_block_kernel", f"{tag} K6 vs sim",
                   ek.etiny_forward_kernel(ek.etiny_kernel_params(sim, kw["cfg"]), x,
                                           **kw),
                   etiny_engine_forward(sim, x, **kw))
    torch.cuda.synchronize()


def stream_check(errs: Errors, sim, cfg, head, frames: torch.Tensor) -> None:
    """Every frame's incremental logits torch.equal to K1's full forward and
    to the plain sim's."""
    kw = dict(cfg=cfg, image_h=H, image_w=W)
    flat = frames.reshape(len(frames), len(frames[0]), -1)
    for t, inc in enumerate(sid.incremental_logits(sim, cfg, frames), start=1):
        k1 = nk.nnue_engine_forward_mega(head, flat[t], **kw)[0]
        errs.equal("nnue_mega_kernel", f"stream frame {t}: K1 vs incremental",
                   k1, inc)
        check(torch.equal(inc, sid.full_logits(sim, cfg, frames[t])),
              f"stream frame {t}: incremental differs from the sim")
    torch.cuda.synchronize()


def state_copy(state) -> TrainState:
    """An independent copy of a train state (model, optimizer state, step),
    without its graph: its next full chunk runs eagerly."""
    opt = {k: v if k == "count" else {n: t.clone() for n, t in v.items()}
           for k, v in state.opt_state.items()}
    return TrainState(copy.deepcopy(state.model), opt, state.step)


def state_restore(state, saved) -> None:
    """Write `saved` (a `state_copy`) into `state`'s own tensors, so that a
    captured graph keeps writing the same buffers."""
    state.model.load_state_dict(saved.model.state_dict())
    for k, v in saved.opt_state.items():
        if k == "count":
            state.opt_state[k] = v
        else:
            for n, t in v.items():
                state.opt_state[k][n].copy_(t)
    state.step = saved.step


def gen_copy(gen: torch.Generator) -> torch.Generator:
    g = torch.Generator(device=gen.device)
    g.set_state(gen.get_state())
    return g


def state_gap(a, b) -> float:
    """The largest |a - b| over two states' params, norm statistics and
    optimizer buffers."""
    pairs = list(zip(a.model.state_dict().values(), b.model.state_dict().values()))
    pairs += [(t, b.opt_state[k][n]) for k, v in a.opt_state.items()
              if k != "count" for n, t in v.items()]
    return max(float((t.double() - u.double()).abs().max()) for t, u in pairs)


def states_equal(a, b) -> bool:
    return (a.step == b.step and a.opt_state["count"] == b.opt_state["count"]
            and all(torch.equal(t, u) for t, u in zip(
                a.model.state_dict().values(), b.model.state_dict().values()))
            and all(torch.equal(t, b.opt_state[k][n]) for k, v in a.opt_state.items()
                    if k != "count" for n, t in v.items()))


def graph_phase(tag: str, smi: str, state, gens: list, chunks: np.ndarray,
                graphed, eager, kernels: dict) -> dict:
    """Phases 41-42 on one path: `graphed(state, chunk, gens)` runs a chunk
    through the state's CUDA graph, `eager(state, chunk, gens)` the same
    steps eagerly; `kernels` {name: launches per chunk}.

    With cuDNN's deterministic algorithms (by default a conv's weight
    gradient may sum with atomics, so two eager runs from one state differ
    in the last bits): after an eager warm-up chunk, two graphed chunks and
    two eager chunks from a copy of the state equal bit for bit (metrics,
    params, norm statistics, optimizer state, generators), each graphed
    chunk exactly one replay, and the graphed chunks' launches of each
    kernel equal the eager ones'. Then at the loop's setting: a new capture
    (its seconds, nodes and peak memory), one chunk graphed beside two
    eager chunks from one state (the eager path's own spread and the
    graph's gap to it, printed), and ms per step graphed and eager in
    turns, each run from the same saved state."""
    steps, batch = chunks.shape[1:]
    torch.backends.cudnn.deterministic = True
    try:
        graphed(state, chunks[0], gens)  # the signature's eager warm-up
        check(state.chunk_graph.graph is None, f"{tag}: the first chunk captured")
        ref, ref_gens = state_copy(state), [gen_copy(g) for g in gens]
        got, want, launched = [], [], {}
        for which, st, gs, fn, out in (("graphed", state, gens, graphed, got),
                                       ("eager", ref, ref_gens, eager, want)):
            reset_launches()
            for n, c in enumerate(chunks[1:3]):
                out.append(fn(st, c, gs))
                if which == "graphed":
                    check(st.chunk_graph.replays == n + 1,
                          f"{tag}: chunk {n + 1} is not one replay")
            launched[which] = {k: launch_counts()[k] for k in kernels}
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = False
    for n, (g, w) in enumerate(zip(got, want)):
        for key in ("loss", "accuracy"):
            check(torch.equal(g[key], w[key]), f"{tag}: graphed chunk {n + 1}'s "
                  f"{key} differs from the eager chunk's (max "
                  f"{float((g[key] - w[key]).abs().max())})")
    check(states_equal(state, ref), f"{tag}: the graphed state differs from the "
          f"eager one (max {state_gap(state, ref)})")
    check(all(torch.equal(a.get_state(), b.get_state())
              for a, b in zip(gens, ref_gens)), f"{tag}: the generators differ")
    check(launched["graphed"] == launched["eager"]
          == {k: 2 * n for k, n in kernels.items()},
          f"{tag}: launches graphed {launched['graphed']}, eager "
          f"{launched['eager']}, expected {kernels} per chunk")
    losses = torch.cat([g["loss"] for g in got])
    check(bool(torch.isfinite(losses).all()), f"{tag}: non-finite losses")
    say(tag, f"deterministic cuDNN: 2 graphed chunks of {steps} steps at batch "
        f"{batch} (after 1 eager warm-up) torch.equal to 2 eager chunks from "
        "the same copied state: losses, accuracies, params, norm statistics, "
        "optimizer state, generators (tolerance: none); one replay per chunk; "
        f"launches graphed {launched['graphed']} == eager {launched['eager']}; "
        f"losses {float(losses[0]):.4f} .. {float(losses[-1]):.4f}")

    # the loop's setting: a new capture
    state.chunk_graph = None
    graphed(state, chunks[3], gens)  # eager warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    graphed(state, chunks[4], gens)  # capture, instantiate, replay
    torch.cuda.synchronize()
    graph = state.chunk_graph
    capture = dict(capture_s=graph.capture_s, instantiate_s=graph.instantiate_s,
                   nodes=graph.nodes, nodes_per_step=graph.nodes / steps,
                   capture_peak_gb=(torch.cuda.max_memory_allocated() - base) / 1e9,
                   held_gb=base / 1e9)
    # the eager path's own spread beside the graph's gap to it
    e1, e2 = state_copy(state), state_copy(state)
    g1, g2 = [gen_copy(g) for g in gens], [gen_copy(g) for g in gens]
    graphed(state, chunks[5], gens)
    eager(e1, chunks[5], g1)
    eager(e2, chunks[5], g2)
    spread, gap = state_gap(e1, e2), state_gap(state, e1)
    say(tag, f"the loop's cuDNN setting: one chunk, two eager runs from one "
        f"state differ by up to {spread!r}, the graph from the first by "
        f"{gap!r} (params, norm statistics, optimizer state)")

    # ms per step in turns (eager, graphed, graphed, eager) from one state
    saved = state_copy(state)
    saved_gens = [gen_copy(g) for g in gens]
    times = {"eager": [], "graphed": []}
    peaks = {"eager": 0.0, "graphed": 0.0}
    for which in ("eager", "graphed", "graphed", "eager"):
        st = e1 if which == "eager" else state
        state_restore(st, saved)
        for g, s in zip(gens if which == "graphed" else g1, saved_gens):
            g.set_state(s.get_state())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        out = (graphed(state, chunks[6], gens) if which == "graphed"
               else eager(e1, chunks[6], g1))
        torch.cuda.synchronize()
        times[which].append((time.perf_counter() - t0) / steps * 1e3)
        peaks[which] = max(peaks[which],
                           (torch.cuda.max_memory_allocated() - base) / 1e9)
        check(out["loss"].shape == (steps,), f"{tag}: {which} chunk's losses")
    say("timing", f"{tag}: ms per step at batch {batch} over {steps}-step "
        "chunks (host clock, one sync, turns eager graphed graphed eager): "
        + "; ".join(f"{k} " + ", ".join(f"{v:.3f}" for v in vs)
                    for k, vs in times.items())
        + f"; peak device memory above the {base / 1e9:.2f} GB held: eager "
        f"{peaks['eager']:.3f} GB, graphed replay {peaks['graphed']:.3f} GB; "
        f"capture {capture['capture_s']:.3f} s, instantiate "
        f"{capture['instantiate_s']:.3f} s, {capture['nodes']} graph nodes "
        f"({capture['nodes_per_step']:.1f} per step), the capture's peak "
        f"{capture['capture_peak_gb']:.3f} GB on {smi}")
    return dict(launches=launched["graphed"], times=times, capture=capture,
                spread=spread, gap=gap)


def graph_phases(smi: str, dataset: torch.Tensor, labels: torch.Tensor) -> dict:
    """Phases 41-43 on phase 9's synthetic-hard images (`dataset`, its
    labels); returns the graphed chunks' kernel launches."""
    rng = np.random.default_rng(SEED + 41)
    n = labels.shape[0]

    # 41. graph-nnue — the fused chunk of config/train_nnue_hard.py
    cfg = load_config(TRAIN_CONFIG)
    steps = int(cfg.steps_per_dispatch)
    model, _ = tloop.build_model(cfg, "nnue", torch.Generator().manual_seed(SEED),
                                 "cuda")
    opt = create_optimizer(cfg, steps)
    kw = dict(optimizer=opt, height=H, width=W)

    def fused(st, chunk, gens):
        return scanned_train_steps_fused(st, dataset, labels, chunk, gens[0], **kw)

    def fused_eager(st, chunk, gens):
        st.chunk_graph = None  # a state without a graph runs its chunk eagerly
        return fused(st, chunk, gens)

    nnue = graph_phase(
        "graph-nnue", smi, make_train_state(model, opt),
        [torch.Generator().manual_seed(SEED)],
        rng.integers(0, n, (7, steps, cfg.batch_size)), fused, fused_eager,
        {"light_pipeline_kernel": steps})

    # 42. graph-etiny — config/train_etinynet.py on the heavy tier
    ecfg = load_config(ETINY_CONFIG)
    esteps = int(getattr(ecfg, "steps_per_dispatch", 8))
    emodel, _ = tloop.build_model(ecfg, "etinynet",
                                  torch.Generator().manual_seed(SEED), "cuda")
    eopt = create_optimizer(ecfg, ETINY_TRAIN_SIZE // ecfg.batch_size)
    ekw = dict(optimizer=eopt, strength=ecfg.augmentation_strength)

    def heavy(st, chunk, gens):
        return scanned_train_steps(st, dataset, labels, chunk, gens[0],
                                   noise_gen=gens[1], **ekw)

    def heavy_eager(st, chunk, gens):
        ms = [gathered_train_step(st, dataset, labels, i, gens[0],
                                  noise_gen=gens[1], **ekw) for i in chunk]
        return {k: torch.stack([m[k] for m in ms]) for k in ms[0]}

    egen = torch.Generator().manual_seed(SEED)
    etiny = graph_phase(
        "graph-etiny", smi, make_train_state(emodel, eopt),
        [egen, aug.device_generator(egen, "cuda")],
        rng.integers(0, n, (7, esteps, ecfg.batch_size)), heavy, heavy_eager,
        {"warp_kernel": 2 * esteps, "photometric_kernel": 2 * esteps})

    # 43. launches
    launched = {**nnue["launches"], **etiny["launches"]}
    check(all(v > 0 for v in launched.values()),
          f"a kernel of 41-42 never launched: {launched}")
    say("launches", "graphed chunks (the counts a replay adds: the launches "
        "its wrapper made during capture) " + json.dumps(launched))
    return launched


def deploy_phases(errs: Errors, smi: str, nnue_payload: dict, ef_payload: dict,
                  etiny_payload: dict, val) -> dict:
    """Phases 36-40: the serialize, evaluate and stream CLIs, the facade and
    the upstream import on the card. `nnue_payload` is phase 10's
    best_model.ckpt (flagship widths), `ef_payload` phase 18's
    engine_friendly one, `etiny_payload` phase 15's 0.98M one (not
    engine_friendly); `val` phase 10's val split. Returns K1's and K6's
    launches in 36-39."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 36)
    tmp_dir = tempfile.TemporaryDirectory()
    tmp = Path(tmp_dir.name)
    reset_launches()

    # 36. serialize — (a) phase 10's checkpoint, (b) an upstream state
    # dict, (c) phase 18's ef checkpoint, (d) phase 15's 0.98M, no --force
    ckpts = {}
    for name, payload in (("a", nnue_payload), ("c", ef_payload),
                          ("d", etiny_payload)):
        ckpts[name] = tmp / f"{name}.ckpt"
        with open(ckpts[name], "wb") as f:
            pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
    up_cfg = nnue_from_checkpoint(nnue_payload, device="cuda").cfg
    up_sd = upstream_state_dict(up_cfg, torch.Generator().manual_seed(SEED))
    ckpts["b"] = tmp / "b.pt"
    torch.save({"state_dict": up_sd}, ckpts["b"])
    outs = {k: tmp / f"{k}.{'etiny' if k in 'cd' else 'nnue'}" for k in ckpts}
    with ThreadPoolExecutor(len(ckpts)) as pool:  # the four CLIs at once
        runs = dict(zip(ckpts, pool.map(
            lambda k: port_cli("serialize", ckpts[k], outs[k]), ckpts)))
    models = {
        "a": nnue_from_checkpoint(nnue_payload, device="cuda"),
        "b": torch_import.load_torch_checkpoint_auto(ckpts["b"], device="cuda")[1],
        "c": etinynet_from_checkpoint(ef_payload, device="cuda"),
        "d": etinynet_from_checkpoint(etiny_payload, device="cuda"),
    }
    for k, model in models.items():
        ref = tmp / f"{k}.inprocess{outs[k].suffix}"
        if outs[k].suffix == ".nnue":
            write_nnue(nnue_quantize(model), ref)
        else:
            write_etiny(etinynet_quantize(model), ref)
        check(outs[k].read_bytes() == ref.read_bytes(),
              f"serialize ({k}): the CLI's bytes differ from the in-process ones")
        serve_file(errs, outs[k], gen, f"serialized ({k})")
    warning = "NOT trained engine_friendly"
    check(warning in runs["d"][1], "no deployment warning for the 0.98M checkpoint")
    check(all(warning not in runs[k][1] for k in "abc"), "a warning for an "
          "NNUE or an engine_friendly checkpoint")
    engine = hold_engine(errs, models["a"], val.images[:ENGINE_IMAGES],
                         val.labels[:ENGINE_IMAGES], ENGINE_IMAGES,
                         "serialized (a)")
    say("serialize", "python -m nnue_vision_tpu_torch.serialize, wall seconds "
        "(the four at once): " + ", ".join(
            f"({k}) {outs[k].stat().st_size}-byte {outs[k].suffix} "
            f"{runs[k][2]:.2f} s" for k in ckpts)
        + "; each file's bytes equal to the in-process quantize + write; the "
        f".nnue files through K1 and the .etiny files through K6 at B="
        f"{TIMING_BATCH} equal to the sim (tolerance: none, torch.equal); the "
        "0.98M checkpoint's deployment warning on stderr; the C++ engine on "
        f"{engine['n']} val images equal to K1 as printed")

    # 37. evaluate — the CLI on (a) against K1 in process
    out, _, seconds = port_cli("evaluate", ckpts["a"], *EVAL_SPLIT, "--compiled")
    lines = cli_lines(out)
    kw = dict(zip(EVAL_SPLIT[::2], EVAL_SPLIT[1::2]))
    loader = create_data_loaders(
        dataset_name=kw["--dataset"], batch_size=int(kw["--batch_size"]),
        use_augmentation=False, seed=SEED,
        synthetic_size=int(kw["--synthetic_size"]))[2]
    mega = evaluate_int8_sim(models["a"], loader, use_pallas="mega")
    for k in ("acc", "f1", "precision", "recall", "latent_density"):
        check(lines["int8-sim"][k] == f"{mega[k]:.4f}", f"evaluate CLI int8-sim "
              f"{k} {lines['int8-sim'][k]} differs from K1's {mega[k]:.4f}")
    for k in ("acc", "f1"):
        check(lines["engine"][k] == lines["int8-sim"][k],
              f"evaluate CLI: engine {k} differs from int8-sim")
    say("evaluate", f"python -m nnue_vision_tpu_torch.evaluate (a) --compiled on "
        f"{len(loader.dataset.labels)} synthetic-hard held-out images in "
        f"{seconds:.2f} s: " + " | ".join(
            f"{tag}: " + " ".join(f"{k}={v}" for k, v in m.items())
            for tag, m in lines.items())
        + "; int8-sim equal to evaluate_int8_sim(use_pallas='mega') (K1) to "
        "every printed digit, engine accuracy and F1 equal to int8-sim")

    # 38. stream — the demo's pan on (a)'s .nnue, incremental against K1
    sim, cfg = nnue_sim_params(read_nnue(outs["a"]), device="cuda")
    head = nk.mega_head_params(sim, cfg, H, W)
    frames = torch.from_numpy(sid.pan_frames(STREAM_FRAMES, STREAM_BATCH)).cuda()
    stream_check(errs, sim, cfg, head, frames)
    demo, _, demo_s = port_cli("stream_inference_demo")
    check(f"{STREAM_FRAMES - 1} frames × {STREAM_BATCH} streams, 0 mismatches"
          in demo, f"stream demo: {demo}")
    say("stream", f"{STREAM_BATCH} streams × {STREAM_FRAMES} frames on (a)'s "
        ".nnue: every frame's incremental logits equal to K1's and the sim's "
        "(tolerance: none, torch.equal); python -m "
        f"nnue_vision_tpu_torch.stream_inference_demo exit 0 in {demo_s:.2f} s: "
        + " | ".join(demo.strip().splitlines()[:4]))

    # 39. facade and import
    fac = api.NNUE(num_classes=10, seed=SEED, device="cuda")
    x = normalize_images(torch.rand((TIMING_BATCH, H, W, 3), generator=gen,
                                    device="cuda")).contiguous()
    with torch.no_grad():
        check(torch.equal(fac(x), fac.module(x)), "facade differs from its module")
    fsim, fcfg = nnue_sim_params(fac.quantize(), device="cuda")
    fkw = dict(cfg=fcfg, image_h=H, image_w=W)
    errs.outputs("nnue_mega_kernel", "facade .quantize() K1 vs sim",
                 nk.nnue_engine_forward_mega(nk.mega_head_params(fsim, fcfg, H, W),
                                             x.reshape(len(x), -1), **fkw),
                 nnue_engine_forward(fsim, x, **fkw))
    efac = api.EtinyNet("0.98M", num_classes=10, input_size=32, device="cuda")
    imported = models["b"]
    check(next(imported.parameters()).is_cuda, "the import is not on the card")
    for name, key in UPSTREAM_KEYS.items():
        check(torch.equal(getattr(imported, name).detach().cpu(), up_sd[key]),
              f"imported {name} differs from the saved {key}")
    say("facade", f"models.api.NNUE (flagship widths, {fac.count_parameters()} "
        "params) on the card: its call equal to its module's forward, its "
        f".quantize() through K1 at B={TIMING_BATCH} equal to the sim; "
        f"models.api.EtinyNet('0.98M', 10 classes, 32x32): count_flops "
        f"{efac.count_flops()}, count_parameters {efac.count_parameters()}; "
        "torch_import of (b) on the card: every param equal to the saved tensor")

    # 40. launches
    counts = {k: launch_counts()[k] for k in ("nnue_mega_kernel", "etiny_block_kernel")}
    check(all(n > 0 for n in counts.values()),
          f"a kernel of 36-39 never launched: {counts}")
    say("launches", "deployment " + json.dumps(counts))

    # 38's timing, after the count: ms per frame of the three forwards
    flat = frames.reshape(STREAM_FRAMES, STREAM_BATCH, -1)
    skw = dict(cfg=cfg, image_h=H, image_w=W)
    stream_ms = {name: time_median(fn) / STREAM_FRAMES for name, fn in {
        "full forward, K1": lambda: [nk.nnue_engine_forward_mega(head, f, **skw)
                                     for f in flat],
        "full forward, sim": lambda: [sid.full_logits(sim, cfg, f) for f in frames],
        "incremental": lambda: list(sid.incremental_logits(sim, cfg, frames)),
    }.items()}
    say("timing", f"stream, {STREAM_BATCH} streams, ms per frame (CUDA events "
        f"around the {STREAM_FRAMES}-frame loop, median of {TIMING_RUNS}): "
        + ", ".join(f"{k} {v:.4f}" for k, v in stream_ms.items()) + f" on {smi}")
    tmp_dir.cleanup()
    return counts


# ---------------------------------------------------------------------------
# phases 44-47: the user tools (MCU/TinyML analysis, engine-speed comparison,
# the upstream interchange check), each on checkpoints of earlier phases
# ---------------------------------------------------------------------------

TOOL_SAMPLES, TOOL_ITERS = 64, 20  # phase 44's --samples and --iters
E2E_IMAGES = 64  # phase 45's --n: PARITY.md's 64/64
MCU_SAMPLES = 256  # phase 46's --max-samples
MCU_SCORED = 100  # run_mlperf_tiny_benchmark's num_samples: the report's accuracy


def in_process(fn, *args) -> tuple:
    """(return value, stdout, wall seconds) of a tool's entry point called
    in this process, so that its kernel launches are counted; its printed
    lines are captured and returned."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        value = fn(*args)
    return value, buf.getvalue(), time.perf_counter() - t0


def tool_phases(errs: Errors, smi: str, nnue_payload: dict, emodel) -> dict:
    """Phases 44-47: compare_engine_speed, upstream_e2e_check,
    run_mcu_benchmarks and run_example_benchmark on the card.
    `nnue_payload` is phase 10's best_model.ckpt (flagship widths), `emodel`
    phase 13's 0.98M EtinyNet. Returns K1's and K6's launches in 44-47."""
    tmp_dir = tempfile.TemporaryDirectory()
    tmp = Path(tmp_dir.name)
    nnue_ckpt = tmp / "nnue.ckpt"
    with open(nnue_ckpt, "wb") as f:
        pickle.dump(nnue_payload, f, protocol=pickle.HIGHEST_PROTOCOL)
    etiny_ckpt = tmp / "etinynet.ckpt"
    save_checkpoint(etiny_ckpt, model_type="etinynet", model_config=emodel.cfg,
                    model=emodel, epoch=0, metrics={})
    reset_launches()

    # 44. compare-engine-speed — the C++ engine, K1, K6 and the sims
    result, out, seconds = in_process(compare_engine_speed.run, TOOL_SAMPLES,
                                      TOOL_ITERS)
    outputs = result["outputs"]
    errs.outputs("nnue_mega_kernel", "compare_engine_speed K1 vs sim",
                 outputs["K1"], outputs["nnue sim"])
    errs.equal("etiny_block_kernel", "compare_engine_speed K6 vs sim",
               outputs["K6"], outputs["etinynet sim"])
    check(len(result["engine_lines"]) == 7, "benchmark_engine printed "
          f"{result['engine_lines']}")
    say("compare-engine-speed", f"--samples {TOOL_SAMPLES} --iters {TOOL_ITERS} "
        f"in {seconds:.2f} s (in process): K1 and K6 on the tool's images "
        "equal to the sims (tolerance: none, torch.equal) | "
        + " | ".join(out.strip().splitlines()))

    # 45. upstream-e2e — phase 10's checkpoint through the engine binary
    rc, out, seconds = in_process(upstream_e2e_check.main, [
        "--ckpt", str(nnue_ckpt), "--ref-build", str(ENGINE_BUILD_DIR),
        "--n", str(E2E_IMAGES)])
    e2e = json.loads(out.strip().splitlines()[-1])
    check(rc == 0 and e2e["bit_exact_vs_k1"] == e2e["bit_exact_vs_our_sim"]
          == E2E_IMAGES, f"upstream_e2e_check exited {rc}: {e2e}")
    say("upstream-e2e", f"--n {E2E_IMAGES} in {seconds:.2f} s (in process) "
        f"against {ENGINE_BUILD_DIR}/nnue_inference, the port's own engine "
        "build (the card's host has no upstream checkout): " + json.dumps(e2e))

    # 46. mcu — both checkpoints, the report's accuracy against the float eval
    for tag, ckpt in (("nnue", nnue_ckpt), ("etinynet", etiny_ckpt)):
        out_dir = tmp / f"mcu_{tag}"
        rc, out, seconds = in_process(run_mcu_benchmarks.main, [
            "--checkpoint", str(ckpt), "--max-samples", str(MCU_SAMPLES),
            "--output-dir", str(out_dir)])
        check(rc == 0 and all((out_dir / name).is_file() for name in (
            "mcu_benchmark.json", "tinyml_report.json")),
            f"run_mcu_benchmarks on the {tag} checkpoint exited {rc} or wrote "
            "no JSON")
        report = json.loads((out_dir / "tinyml_report.json").read_text())
        accuracy = {r["accuracy"] for r in report["mlperf_results"].values()}
        loader = create_data_loaders(dataset_name="cifar10", batch_size=16,
                                     max_samples_per_split=MCU_SAMPLES,
                                     use_augmentation=False)[2]
        module = load_checkpoint_auto(ckpt, device="cuda")[1]
        scored = evaluate_model(module, head_subset_loader(loader, MCU_SCORED))[1]
        check(accuracy == {scored["acc"]},
              f"mcu ({tag}): the report's accuracy {accuracy} differs from the "
              f"float eval's {scored['acc']} on its {MCU_SCORED} images")
        facade = run_mcu_benchmarks.load_model(
            run_mcu_benchmarks.parse_arguments(["--checkpoint", str(ckpt)]))
        full = evaluate_model(module, loader)[1]
        acc = evaluate_model_accuracy(facade, loader)
        check(acc["accuracy"] == full["acc"] and acc["f1_score"] == full["f1"],
              f"mcu ({tag}): evaluate_model_accuracy {acc} differs from the "
              f"float eval {full}")
        best = report["summary"]
        say("mcu", f"run_mcu_benchmarks --max-samples {MCU_SAMPLES} on the {tag} "
            f"checkpoint in {seconds:.2f} s (in process): both JSON files "
            f"written; the report's accuracy {scored['acc']:.4f} equal to "
            f"evaluate_model on its {MCU_SCORED} images and "
            f"evaluate_model_accuracy {acc['accuracy']:.4f} on the split's "
            f"{len(loader.dataset.labels)} (the synthetic stand-in's test "
            "split) equal to evaluate_model's; best "
            f"{best['best_platform']} {best['best_latency_ms']:.4f} ms (simulated) | "
            + " | ".join(out.strip().splitlines()[:4]))

    # 47. example — the walkthrough as a user runs it
    out, _, seconds = port_cli("run_example_benchmark")
    check("Best platform:" in out, f"run_example_benchmark: {out}")
    say("example", f"python -m nnue_vision_tpu_torch.run_example_benchmark exit 0 "
        f"in {seconds:.2f} s: " + " | ".join(
            line for line in out.strip().splitlines() if line))

    counts = {k: launch_counts()[k] for k in ("nnue_mega_kernel", "etiny_block_kernel")}
    check(all(n > 0 for n in counts.values()),
          f"a kernel of 44-47 never launched: {counts}")
    say("launches", "tools " + json.dumps(counts))
    ms = result["device_ms"]
    engine = result["engine_ms"]
    say("timing", f"compare_engine_speed, ms per image at batch {TOOL_SAMPLES}: "
        f"C++ engine nnue {engine['nnue']:.4f}, etinynet {engine['etinynet']:.4f} "
        "(one process, wall clock); " + ", ".join(
            f"{k} {v:.6f}" for k, v in ms.items())
        + f" ({compare_engine_speed.REPS} calls per CUDA graph, best of 3) on {smi}")
    tmp_dir.cleanup()
    return counts


# ---------------------------------------------------------------------------
# phases 48-57: the ten profiling probes, in process at their widths, each
# cut only in depth (fewer reps, chunks, dispatches or sweep points)
# ---------------------------------------------------------------------------

# phase tag: (probe module, its run's arguments, the kernels it must launch);
# each at its widths and its own defaults but for the depth cut here
PROBES = {
    "nnue-split": (profile_nnue_split, dict(batch=TIMING_BATCH, reps=50),
                   ("nnue_mega_kernel", "nnue_head_kernel")),
    "etiny-pallas": (profile_etiny_pallas, dict(batch=2048, reps=50),
                     ("etiny_block_kernel",)),
    "train-roofline": (profile_train_roofline, dict(batch=512, spd=64, chunks=4), ()),
    "train-sweep": (profile_train_sweep, dict(batches=(512, 1024, 2048, 4096),
                                              fused=True, spds=(64,),
                                              images=1 << 18),
                    ("light_pipeline_kernel",)),
    "scaled-train": (profile_scaled_train, dict(batch=2048, spd=8, dispatches=4),
                     ("light_pipeline_kernel",)),
    "etiny-roofline": (profile_etiny_roofline, dict(batch=1024, steps=16, chunks=4),
                       ()),
    "etiny-train": (profile_etiny_train, dict(spds=(16,), batch=1024, dispatches=4,
                                              production_steps=8),
                    ("warp_kernel", "photometric_kernel")),
    "heavy-aug": (profile_heavy_aug, dict(batch=1024, reps=32),
                  ("warp_kernel", "photometric_kernel")),
    "photometric-rng": (profile_photometric_rng, dict(batch=1024, reps=50),
                        ("warp_kernel", "photometric_kernel")),
    "batched-draws": (profile_batched_draws, dict(batch=1024, reps=50),
                      ("warp_kernel", "photometric_kernel")),
}


def timings(out, timed: bool = False) -> list:
    """Every number under a key that names a time in a probe's result, a
    list of times under such a key included."""
    if isinstance(out, dict):
        return [v for k, x in out.items() for v in timings(
            x, k.endswith(("ms", "ms_per_step", "ms_per_batch")))]
    if isinstance(out, list):
        return [v for x in out for v in timings(x, timed)]
    return [out] if timed and out is not None else []


def probe_phases(smi: str) -> dict:
    """Phases 48-57: each probe's `run` on the card, its exactness flags
    checked, every time positive and finite, the kernels on its path
    launched. Returns each kernel's launches over the ten."""
    totals = {}
    for phase, (tag, (module, kwargs, kernels)) in enumerate(PROBES.items(), 48):
        reset_launches()
        t0 = time.perf_counter()
        out = module.run(device="cuda", **kwargs)
        seconds = time.perf_counter() - t0
        counts = {k: v for k, v in launch_counts().items() if v}
        check(all(counts.get(k, 0) > 0 for k in kernels),
              f"{tag}: a kernel of its path never launched: {counts}")
        times = timings(out)
        check(times and all(math.isfinite(t) and t > 0 for t in times),
              f"{tag}: a time is not positive and finite: {out}")
        flags = {k: out[k] for k in ("mega_exact", "bf16_conv_exact", "bit_exact")
                 if k in out}
        check(all(flags.values()), f"{tag}: {flags}")
        if "train_mfu" in out:
            check(0 < out["train_mfu"] < 1, f"{tag}: MFU {out['train_mfu']}")
        say(tag, f"phase {phase}: {module.__name__}.run({kwargs}) in "
            f"{seconds:.1f} s; flags {flags or 'none'} (tolerance: none, "
            f"torch.equal); launches {json.dumps(counts)} on {smi}")
        say(tag, json.dumps(out))
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
    say("launches", "probes " + json.dumps(totals))
    return totals


def bench_phase(smi: str) -> dict:
    """Phase 58: `python -m nnue_vision_tpu_torch.bench` at its defaults,
    its line checked. Returns K1-K5's launches over the run."""
    out, _, seconds = port_cli("bench")
    lines = out.strip().splitlines()
    line = json.loads(lines[-1])
    check(line["metric"] == "cifar10_nnue_train_images_per_sec_per_chip"
          and line["unit"] == "images/s", f"bench: not the metric's line: {line}")
    extras = line["extras"]
    rates = {"value": line["value"], **{k: v for k, v in extras.items()
                                        if k.endswith("_images_per_sec")}}
    check(all(math.isfinite(v) and v > 0 for v in rates.values()),
          f"bench: an images/s is not positive and finite: {rates}")
    mfus = {k: v for k, v in extras.items() if k.endswith("_mfu")}
    check(len(mfus) == 3 and all(0 < v < 1 for v in mfus.values()),
          f"bench: an MFU outside (0, 1): {mfus}")
    check(extras["device"] == smi, f"bench: device {extras['device']!r}")
    counts = json.loads(next(ln for ln in lines
                             if ln.startswith("# launches "))[len("# launches "):])
    check(len(counts) == 5 and all(n > 0 for n in counts.values()),
          f"bench: a kernel of K1-K5 never launched: {counts}")
    say("bench", lines[-1])
    say("bench", f"phase 58: python -m nnue_vision_tpu_torch.bench in "
        f"{seconds:.1f} s; launches {json.dumps(counts)}; headline "
        f"{line['value']:,.0f} images/s, train MFU {extras['train_mfu']:.4f} "
        f"on {smi}")
    return counts


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

    # 2. build — the C++ engine's tools beside nvcc, in a thread
    def build_engine():
        t0 = time.perf_counter()
        exes = {t: compile_cpp_engine(t) for t in ("nnue", "etinynet")}
        return exes, time.perf_counter() - t0

    with ThreadPoolExecutor(1) as pool:
        engine_job = pool.submit(build_engine)
        built = load_library()
        engine_exes, engine_seconds = engine_job.result()
    say("build", "C++ engine (cmake + ninja): " + ", ".join(
        p.name for p in engine_exes.values()) + f" in "
        f"{engine_exes['nnue'].parent} built in {engine_seconds:.1f} s beside nvcc")
    ptxas = [ln.strip() for ln in built.log.splitlines()
             if "registers" in ln or "Compiling entry" in ln]
    say("build", f"{built.path.name} built in {built.seconds:.1f} s; "
        + " | ".join(ptxas))
    sass = sass_counts(built.path)
    say("build", "SASS (IMMA, LDGSTS, UBLKCP) per kernel: " + json.dumps(sass))
    for name in ("etiny_block_kernel<0>", "etiny_block_kernel<1>", "nnue_mega_kernel<4,2,2>",
                 "nnue_mega_kernel<4,1,1>", "nnue_head_kernel<2,2>"):
        check(name in sass and sass[name]["IMMA"] > 0 and sass[name]["LDGSTS"] > 0,
              f"{name}: no int8 tensor-core or cp.async instruction in its SASS")
    usage = ptxas_usage(built.log)
    for name in ("light_pipeline_kernel", "warp_kernel", "lerp_pass_kernel<1>",
                 "lerp_pass_kernel<0>", "photometric_kernel"):
        check(name in sass and sass[name]["UBLKCP"] > 0,
              f"{name}: no bulk-copy (UBLKCP) instruction in its SASS")
        check(name in usage and usage[name][1:] == (0, 0),
              f"{name}: spills ({usage.get(name)}: registers, spill store and "
              "load bytes)")
    say("build", "ptxas (registers, spill store bytes, spill load bytes): "
        + json.dumps({k: v for k, v in usage.items()
                      if k.split("<")[0] in BULK_KERNELS}))
    say("build", f"K3 light_pipeline_kernel: {sass['light_pipeline_kernel']['UBLKCP']} "
        f"bulk copies (UBLKCP) in its SASS, "
        f"{usage['light_pipeline_kernel'][0]} registers")

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
    for batch in SERVE_BATCHES:
        serve(errs, ssim, scfg, batch, gen, sheads, f"stress B={batch}")
    x = normalize_images(torch.rand((512, H, W, 3), generator=gen, device="cuda"))
    _, _, count = nnue_engine_forward(ssim, x, cfg=scfg, image_h=H, image_w=W)
    oh, ow = conv_out_hw(H, W, engine_conv_stride(H, scfg.grid_size))
    n_pad = scfg.num_features - oh * ow * scfg.channels
    check(int(count.min()) >= n_pad, "padding features not active")
    say("stress", f"B={SERVE_BATCHES}, negative threshold, int16 FT weights: "
        f"all equal; "
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
    extra = {}  # (graph-timed ms, host ms per call) of the ring kernels
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
    for name, fn in (
            ("nnue_mega_kernel", lambda: nk.nnue_engine_forward_mega(mega, flat, **kw)[0]),
            ("nnue_head_kernel", lambda: nk._head_launch(head, acc, **hkw)[0])):
        extra[name] = (chained_best_ms(fn, GRAPH_REPS), host_ms(fn))
        say("timing", f"B={TIMING_BATCH} {name}, graph-timed ({GRAPH_REPS} calls "
            f"per CUDA graph, best of 3): {extra[name][0]:.4f} ms, host "
            f"{extra[name][1]:.4f} ms per call on {smi}")
    info = (ctypes.c_int * 6)()
    for batch in (TIMING_BATCH, 512, 1):
        check(load_library().lib.nnue_mega_tile(
            batch, acc.shape[1], cfg.l1, cfg.l2, cfg.l3, cfg.channels, H, W,
            info) == 0, "no mega kernel tile fits")
        say("timing", f"B={batch} mega kernel tile: {info[0]} images, "
            f"{info[1]} product rows, {info[2]} ring slots, {info[3]} staged "
            f"image pairs, {info[4]} block(s) per tile, {info[5]} bytes of "
            "shared memory per block")
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
    library_graph = {}  # the library call graph-timed as the kernel is

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
    for h, w, batch in PIPELINE_SHAPES:
        images = np.random.default_rng(SEED + h).random((256, h, w, 3), np.float32)
        # the view from row 1: an unaligned shape's rows start off 16 bytes
        shaped = ip.prepare_gather_dataset(torch.from_numpy(images).cuda())[1:]
        pipeline(errs, shaped, torch.Generator().manual_seed(SEED + h), batch)
        say("pipeline", f"{h}x{w}, N={shaped.shape[0]}, B={batch}: "
            f"{ip.band_plan(h, w)} kernel equal to plain and identity equal "
            "to normalize_images (torch.equal)")
        del images, shaped

    # 10. train — the training path, counted from here to its end
    with tempfile.TemporaryDirectory() as tmp:
        tr = train_run(train_config(), "nnue", Path(tmp), "train")
        losses = tr["losses"]
        check(len(losses) == 39 and all(math.isfinite(v) for v in losses),
              f"expected 39 finite losses, got {losses}")
        check(tr["launches"]["light_pipeline_kernel"] == 39,
              f"K3 launched {tr['launches']['light_pipeline_kernel']} times, "
              "not once per fused step")
        check(tr["launches"]["nnue_mega_kernel"] > 0, "K1 not launched by the eval")
        payload = tr["payload"]
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
        f"{losses[-1]:.4f}; val acc {tr['epochs'][0]['val/accuracy']:.4f}, "
        f"compiled acc {tr['epochs'][0]['compiled/accuracy']:.4f}; checkpoint "
        "int8 mega == sim: " + json.dumps({k: int8["mega"][k] for k in keys}))

    # 11. launches
    train_launches = tr["launches"]
    say("launches", "serving " + json.dumps(launches) + "; training "
        + json.dumps(train_launches))
    launches["light_pipeline_kernel"] = train_launches["light_pipeline_kernel"]

    # 12. timing
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout.split()[0])
    for batch in PIPELINE_TIMING_BATCHES:
        name = "light_pipeline_kernel" if batch == 512 else K3_8192
        params = ip.draw_light_params(pgen, 1, batch, H, W)
        idx = torch.randint(0, dataset.shape[0], (batch,), generator=pgen)
        args = ((idx + dataset.shape[0] * params.flip[0]).to(torch.int32).cuda(),
                params.pf[0].cuda(), params.pi[0].cuda())
        errs.equal(name, f"pipeline timing B={batch}",
                   ip.fused_light_pipeline(dataset, *args, h=H, w=W),
                   ip.fused_light_pipeline_reference(dataset, *args, h=H, w=W))
        ms[name] = time_pair(
            lambda a=args: ip.fused_light_pipeline(dataset, *a, h=H, w=W),
            lambda a=args: ip.fused_light_pipeline_reference(dataset, *a, h=H, w=W))
        extra[name] = (chained_best_ms(
            lambda a=args: ip.fused_light_pipeline(dataset, *a, h=H, w=W),
            GRAPH_REPS), host_ms(
            lambda a=args: ip.fused_light_pipeline(dataset, *a, h=H, w=W)))
        # the gathered rows read and the output written; per value a
        # multiply-add, two clamps, a subtract and a divide
        values = batch * H * W * 3
        bounds[name] = bound(2 * 4 * values + nbytes(*args), f32_ops=6 * values)
        library[name] = None  # gather + affine + cutout
        k, p = ms[name]
        say("timing", f"K3 B={batch}: kernel {k:.4f} ms ({batch / k * 1e3:,.0f} "
            f"img/s), plain {p:.4f} ms ({batch / p * 1e3:,.0f} img/s); graph-timed "
            f"{extra[name][0]:.4f} ms ({GRAPH_REPS} calls per CUDA graph, best of "
            f"3, {bounds[name][0] / extra[name][0]:.0%} of the {bounds[name][0]:.4f} ms "
            f"bound), host {extra[name][1]:.4f} ms per call on {smi}")
        phases = [ip.light_pipeline_phases(dataset, *args, h=H, w=W)
                  for _ in range(6)][1:]
        cycles = {k: statistics.median(d[k] for d in phases) for k in ip.PHASES}
        say("timing", f"K3 B={batch}, a block's first item (median over the blocks "
            "and 5 launches), SM cycles and us at the "
            f"{clock_mhz:.0f} MHz maximum SM clock: " + ", ".join(
                f"{k} {v:,.0f} ({v / clock_mhz:.3f} us)" for k, v in cycles.items()))
    cfg = tr["cfg"]
    opt = create_optimizer(cfg, 39)
    state = make_train_state(trained, opt)
    labels = torch.from_numpy(ds.labels).cuda()
    chunk = np.random.default_rng(SEED).permutation(len(ds.labels))[:39 * 512]
    chunk = chunk.reshape(39, 512)
    for run in ("eager warm-up", "capture + replay", "replay"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = scanned_train_steps_fused(state, dataset, labels, chunk, pgen,
                                      optimizer=opt, height=H, width=W)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / 39 * 1e3
        check(bool(torch.isfinite(m["loss"]).all()), "non-finite timing losses")
        say("timing", f"train step (39-step fused chunk, {run}, batch 512): "
            f"{step_ms:.3f} ms/step ({512 / step_ms * 1e3:,.0f} img/s), host "
            f"clock, one sync, on {smi}")

    # 13. etiny-serve — the EtinyNet serving path, counted from here to 16
    rng = np.random.default_rng(SEED)
    emodel = etiny_model(rng)
    q0 = etinynet_quantize(emodel)
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
    check(serve_launches["etiny_stem_kernel"] == serve_launches["etiny_tail_kernel"]
          == 2 * len(ETINY_SERVE_BATCHES),
          f"stem and tail launches {serve_launches} are not one per call")

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
        et = train_run(etiny_config(), "etinynet", Path(tmp), "etiny")
        elosses = et["losses"]
        steps = ETINY_TRAIN_SIZE // et["cfg"].batch_size
        check(len(elosses) == steps and all(math.isfinite(v) for v in elosses),
              f"expected {steps} finite losses, got {elosses}")
        for name in ("warp_kernel", "photometric_kernel"):
            check(et["launches"][name] == 2 * steps,
                  f"{name} launched {et['launches'][name]} times, not twice "
                  "per heavy-tier step")
        epayload = et["payload"]
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
    check(int8_acc == et["epochs"][0]["compiled/accuracy"],
          f"K6 int8 val accuracy {int8_acc} differs from the loop's sim "
          f"{et['epochs'][0]['compiled/accuracy']}")
    say("etiny-train", f"{ETINY_CONFIG} on {ETINY_TRAIN_SIZE} synthetic-hard "
        f"images, 1 epoch of {len(elosses)} steps at batch "
        f"{et['cfg'].batch_size} in {et['seconds']:.2f} s (train_model, data "
        f"generation included); loss first {elosses[0]:.4f} last "
        f"{elosses[-1]:.4f}; val acc {et['epochs'][0]['val/accuracy']:.4f}; "
        f"checkpoint int8 val accuracy through K6 {int8_acc:.4f} == sim")

    # 16. launches
    say("launches", "EtinyNet serving " + json.dumps(serve_launches)
        + "; EtinyNet training " + json.dumps(et["launches"]))
    for name in ("etiny_block_kernel", "etiny_stem_kernel", "etiny_tail_kernel"):
        launches[name] = serve_launches[name]
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
        blocks = k6_blocks(kp, ecfg, x)
        rows["etiny_block_kernel, the LB blocks alone"] = time_pair(
            lambda: [ek.lb_block(a, blk, bs) for a, blk, bs in blocks],
            lambda: [ek.lb_block_reference(a, blk, bs) for a, blk, bs in blocks])
        if batch == TIMING_BATCH:
            extra["etiny_block_kernel"] = (k6_graph_ms(blocks, smi, "0.98M"),
                                           k6_host_ms(blocks))
            stem_tail_timing(errs, smi, kp, ecfg, x,
                             ("etiny_stem_kernel", "etiny_tail_kernel"),
                             (ms, bounds, extra, library))
        for name, (k, p) in rows.items():
            what = ("the whole int8 forward (the stem kernel, 12 K6 launches, the "
                    "tail kernel) vs the sim" if name == "etiny_block_kernel" else name)
            say("timing", f"B={batch} {what}: kernel {k:.4f} ms "
                f"({batch / k * 1e3:,.0f} img/s), plain {p:.4f} ms "
                f"({batch / p * 1e3:,.0f} img/s) on {smi}")
        for name, fn in (
                ("warp_kernel", lambda: wk.warp_bilinear(images, draws.warp1)),
                ("photometric_kernel", lambda: pk.photometric_block(
                    images, noise, *draws.photo1, variant="medium")),
                ("photometric_kernel heavy_extra", lambda: pk.photometric_block(
                    images, noise, *draws.photo2, variant="heavy_extra"))):
            graph_host = (chained_best_ms(fn, GRAPH_REPS), host_ms(fn))
            if batch == 1024:
                extra[name] = graph_host
            say("timing", f"B={batch} {name}: graph-timed {graph_host[0]:.4f} ms "
                f"({GRAPH_REPS} calls per CUDA graph, best of 3), host "
                f"{graph_host[1]:.4f} ms per call (host clock over many "
                f"enqueues, no sync inside) on {smi}")
        if batch == 1024:
            for name in ("warp_kernel", "photometric_kernel"):
                ms[name] = rows[name]
            # per value: two passes of a position (two multiplies, two adds)
            # and a lerp (floor, three subtracts, two multiplies, an add)
            bounds["warp_kernel"] = bound(
                2 * nbytes(images) + nbytes(draws.warp1),
                f32_ops=18 * images.numel())
            # ~60 float operations per value (csrc/photometric.cu); the
            # kernel reads the noise only of the images whose gate 8 is on
            gated = int((draws.photo1[0][:, 8] > 0.5).sum())
            bounds["photometric_kernel"] = bound(
                2 * nbytes(images) + nbytes(*draws.photo1)
                + nbytes(noise) * gated // batch,
                f32_ops=60 * images.numel())
            # grid_sample is a one-pass bilinear warp, not the two-pass
            # result; no single call runs the gated photometric chain
            library["warp_kernel"] = library["photometric_kernel"] = None
        else:
            ms["etiny_block_kernel"] = rows["etiny_block_kernel, the LB blocks alone"]
            bounds["etiny_block_kernel"] = k6_bound(blocks)
            library["etiny_block_kernel"] = None  # expand, depthwise, project
    # the stem and tail kernels on EtinyNet-1.0 at 224×224, 1,000 classes
    qi = etinynet_quantize(etiny_model(np.random.default_rng(SEED), "1.0", 1000, 224))
    isim, icfg = etiny_sim_params(qi, device="cuda")
    xi = normalize_images(torch.rand(
        (STEM_TAIL_224_BATCH, 224, 224, 3), device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(SEED))).contiguous()
    stem_tail_timing(errs, smi, ek.etiny_kernel_params(isim, icfg), icfg, xi,
                     (STEM_224, TAIL_224), (ms, bounds, extra, library))
    del xi
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

    # 18. ef-etiny — the engine_friendly EtinyNet path, counted from its
    # training to the end of its K6 pass over the val split
    with tempfile.TemporaryDirectory() as tmp:
        ef = train_run(ef_config(), "etinynet", Path(tmp), "ef")
    efcfg, flosses = ef["cfg"], ef["losses"]
    ef_steps = load_config(EF_CONFIG).synthetic_size // efcfg.batch_size
    check(len(flosses) == EF_EPOCHS * ef_steps
          and all(math.isfinite(v) for v in flosses),
          f"expected {EF_EPOCHS * ef_steps} finite losses, got {flosses}")
    check(f"quantizer switch at epoch {EF_WARMUP}" in ef["log"],
          "the quantizer switch was not logged")
    efpayload = ef["payload"]
    check(efpayload["epoch"] >= EF_WARMUP and efpayload["model_config"]["ef_quantizers"],
          f"best_model.ckpt from epoch {efpayload['epoch']}, a warm-up epoch")
    fparams = efpayload["params"]
    qlogs = [float(np.abs(v).max()) for v in [fparams["final_qlog"]] + [
        b[k] for b in fparams["blocks"] for k in ("qlog1", "qlog2")]]
    check(len(qlogs) == 23 and all(v > 0 for v in qlogs),
          f"LSQ scales untrained: {qlogs}")
    trained_f = etinynet_from_checkpoint(efpayload, device="cuda").eval()
    check(trained_f.cfg.engine_friendly and trained_f.cfg.dtype == "float32",
          "the checkpoint lost its engine_friendly config")
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "etinynet_ef.etiny"
        qf, fkp, fsim, fcfg_e = deploy_etiny.deploy(trained_f, path)
        fsize = path.stat().st_size
        write_etiny(qf, Path(tmp) / "again.etiny")
        check((Path(tmp) / "again.etiny").read_bytes() == path.read_bytes(),
              ".etiny round trip changed the model")
    s3 = np.clip(np.exp(fparams["final_qlog"].astype(np.float64)),
                 1 / 64, 127 / 64)
    check(len(qf.blocks) == 12 and np.array_equal(
        qf.blocks[-1].pw_project, quantize_weight_i8(np.diag(s3))),
          "the final block's projection is not diag(64·s3)")
    ef_val = GenericVisionDataset("synthetic-hard", split="test",
                                  synthetic_size=efcfg.synthetic_size, seed=42)
    st = deploy_etiny.score(trained_f, fkp, fsim, fcfg_e, ef_val.images, ef_val.labels)
    errs.max[EF_K6] = st["k6_max_abs_err_vs_sim"]
    check(st["k6_max_abs_err_vs_sim"] == 0.0, "trained ef EtinyNet: K6 differs "
          f"from the sim (max {st['k6_max_abs_err_vs_sim']})")
    calls = -(-len(ef_val.labels) // 1024)
    ef_launches = {"etiny_block_kernel": ek.LAUNCHES["etiny_block_kernel"]}
    check(ef_launches["etiny_block_kernel"] == 12 * calls,
          f"K6 launches {ef_launches} are not 12 per call")
    n_val = len(ef_val.labels)
    best = ef["epochs"][efpayload["epoch"]]
    check(st["int8_acc"] == best["compiled/accuracy"],
          f"K6 int8 val accuracy {st['int8_acc']} differs from the loop's sim "
          f"{best['compiled/accuracy']}")
    say("ef-etiny", f"{EF_CONFIG} (0.75, engine_friendly, float32, light tier) on "
        f"{efcfg.synthetic_size} synthetic-hard images, {EF_EPOCHS} epochs "
        f"({EF_WARMUP} warm-up) of {ef_steps} steps at batch {efcfg.batch_size} in "
        f"{ef['seconds']:.2f} s (train_model, data generation included); loss "
        f"first {flosses[0]:.4f}, at the switch {flosses[EF_WARMUP * ef_steps]:.4f}, "
        f"last {flosses[-1]:.4f}; per epoch val acc "
        + ", ".join(f"{r['val/accuracy']:.4f}" for r in ef["epochs"])
        + ", compiled acc "
        + ", ".join(f"{r['compiled/accuracy']:.4f}" for r in ef["epochs"])
        + f"; best_model.ckpt from epoch {efpayload['epoch']}; |qlog| max "
        f"{max(qlogs):.4f}")
    say("ef-etiny", f"checkpoint → etinynet_quantize → {fsize}-byte .etiny → "
        f"read_etiny → K6 ({len(qf.blocks)} blocks): on the {n_val} val images K6 "
        f"equal to the sim (tolerance: none, torch.equal); val accuracy float "
        f"{st['float_acc']:.4f}, int8 through K6 {st['int8_acc']:.4f}, predictions "
        f"agree on {st['agree']:.4f}; float against int8 relative logit error "
        f"per image median {st['rel_err_median']:.4f}, 90th percentile "
        f"{st['rel_err_p90']:.4f}, max {st['rel_err_max']:.4f}, above 0.1 on "
        f"{st['rel_err_share_above_0.1']:.4f} of the images")
    say("launches", "engine_friendly EtinyNet " + json.dumps(ef_launches))
    ef_engine = hold_engine(errs, trained_f, ef_val.images, ef_val.labels, 1024,
                            "trained ef EtinyNet")
    check(ef_engine["acc"] == st["int8_acc"], "the engine's accuracy differs "
          f"from K6's: {ef_engine['acc']} vs {st['int8_acc']}")
    say("ef-etiny", f"the C++ engine on the {ef_engine['n']} val images: logits "
        f"equal to K6's as printed (%.10f; raw max {ef_engine['print_err']:.3g}), "
        "K6's equal to the sim's, "
        f"{ef_engine['engine_ms']:.4f} ms per image (host CPU)")
    launches["etiny_block_kernel"] += ef_launches["etiny_block_kernel"]
    launches[EF_K6] = ef_launches["etiny_block_kernel"]
    # K6 on this .etiny at the timing batch: the whole int8 forward and the
    # 12 blocks alone event-timed, the blocks graph-timed
    xf = normalize_images(torch.from_numpy(ds.images[:TIMING_BATCH]).cuda()).contiguous()
    fkw = dict(cfg=fcfg_e, image_h=H, image_w=W)
    whole = time_pair(lambda: ek.etiny_forward_kernel(fkp, xf, **fkw),
                      lambda: etiny_engine_forward(fsim, xf, **fkw))
    fblocks = k6_blocks(fkp, fcfg_e, xf)
    ms[EF_K6] = time_pair(
        lambda: [ek.lb_block(a, blk, bs) for a, blk, bs in fblocks],
        lambda: [ek.lb_block_reference(a, blk, bs) for a, blk, bs in fblocks])
    extra[EF_K6] = (k6_graph_ms(fblocks, smi, "0.75 ef"), k6_host_ms(fblocks))
    bounds[EF_K6] = k6_bound(fblocks)
    library[EF_K6] = None  # expand, depthwise, project
    for name, (k, p) in (("the whole int8 forward (12 K6 launches + plain stem/"
                          "tail) vs the sim", whole),
                         ("the 12 LB blocks alone", ms[EF_K6])):
        say("timing", f"0.75 ef B={TIMING_BATCH} {name}: kernel {k:.4f} ms "
            f"({TIMING_BATCH / k * 1e3:,.0f} img/s), plain {p:.4f} ms on {smi}; "
            f"bound {bounds[EF_K6][0]:.4f} ms ({bounds[EF_K6][1]})")
    # ms per train step of the warm-up and of the quantized function
    fds = GenericVisionDataset("synthetic-hard", split="train",
                               synthetic_size=efcfg.synthetic_size, seed=42)
    fmodel = etinynet_from_checkpoint(efpayload, device="cuda")
    fopt = create_optimizer(efcfg, ef_steps)
    fstate = make_train_state(fmodel, fopt)
    fimages = torch.from_numpy(fds.images).cuda()
    flabels = torch.from_numpy(fds.labels).cuda()
    frng = np.random.default_rng(SEED)
    for mode, mcfg in (("warm-up", dataclasses.replace(fmodel.cfg,
                                                       ef_quantizers=False)),
                       ("quantized", fmodel.cfg)):
        fmodel.cfg = mcfg
        for run in range(2):
            idx = frng.integers(0, len(fds.labels), (ef_steps, efcfg.batch_size))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step_losses = torch.stack([
                gathered_train_step(fstate, fimages, flabels, i, tgen, optimizer=fopt,
                                    strength="light")["loss"] for i in idx])
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t0) / ef_steps * 1e3
            check(bool(torch.isfinite(step_losses).all()), "non-finite timing losses")
            say("timing", f"ef EtinyNet train step, {mode} ({ef_steps} steps, run "
                f"{run + 1}/2, batch {efcfg.batch_size}, float32, light tier): "
                f"{step_ms:.3f} ms/step ({efcfg.batch_size / step_ms * 1e3:,.0f} "
                f"img/s), host clock, one sync, on {smi}")

    # 19. mega-bisect — the profiling path's cut kernel, counted in the probe
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
    stage3 = functools.partial(nk.nnue_mega_stage, mega, flat, **skw)
    extra["nnue_mega_stage_kernel"] = (chained_best_ms(stage3, GRAPH_REPS),
                                       host_ms(stage3))
    say("timing", f"B={TIMING_BATCH} cut mega kernel, level 3 (ft): kernel "
        f"{ms['nnue_mega_stage_kernel'][0]:.4f} ms, plain "
        f"{ms['nnue_mega_stage_kernel'][1]:.4f} ms; graph-timed kernel "
        f"{extra['nnue_mega_stage_kernel'][0]:.4f} ms, host "
        f"{extra['nnue_mega_stage_kernel'][1]:.4f} ms per call on {smi}")

    # 20. warp-split — the single passes, counted in the probe
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
            extra[kernel] = (chained_best_ms(lambda f=fn: f(packed, coef1, n=W, c=3),
                                             GRAPH_REPS),
                             host_ms(lambda f=fn: f(packed, coef1, n=W, c=3)))
            # per value: a position (two multiplies, two adds) and a lerp
            # (floor, three subtracts, two multiplies, an add)
            bounds[kernel] = bound(2 * nbytes(packed) + nbytes(coef1),
                                   f32_ops=9 * packed.numel())
        # one library call computes a single pass: grid_sample on the rows
        # as a (B, C, R, N) image, its grid holding the same positions
        sample = grid_sample_pass(images, coef1)
        check(torch.allclose(sample().permute(0, 2, 3, 1).reshape(packed.shape),
                             wk.lerp_pass(packed, coef1, n=W, c=3), atol=1e-4),
              "grid_sample does not compute the lerp pass")
        library["lerp_pass_kernel"] = time_median(sample)
        library_graph["lerp_pass_kernel"] = chained_best_ms(sample, GRAPH_REPS)
        library["nogather_pass_kernel"] = None  # no call reads in place of taps
    say("warp-split", f"B={AUGMENT_BATCHES}: lerp_pass and nogather_pass on "
        "heavy-tier and out-of-frame maps equal to plain (tolerance: none, "
        "torch.equal); the five-stage composition equal to warp_kernel")
    for kernel in ("lerp_pass_kernel", "nogather_pass_kernel"):
        k, p = ms[kernel]
        say("timing", f"B=1024 {kernel}: kernel {k:.4f} ms, plain {p:.4f} ms"
            + (f", grid_sample {library[kernel]:.4f} ms" if library[kernel]
               else "") + f"; graph-timed kernel {extra[kernel][0]:.4f} ms"
            + (f", grid_sample {library_graph[kernel]:.4f} ms" if library[kernel]
               else "") + f"; host {extra[kernel][1]:.4f} ms per call on {smi}")
    os.environ["WARP_SPLIT_REPS"] = WARP_SPLIT_REPS
    wk.reset_launch_counts()
    split = profile_warp_split.run(AUGMENT_BATCHES[0], "cuda")
    for kernel in ("lerp_pass_kernel", "nogather_pass_kernel"):
        probe_launches[kernel] = wk.LAUNCHES[kernel]
    check(all(v > 0 for v in split["ms"].values()),
          f"a probe time is not positive: {split}")
    say("warp-split", "profile_warp_split " + json.dumps(split))

    # 21. trace
    with tempfile.TemporaryDirectory() as tmp:
        tcfg = load_config(TRACE_CONFIG)
        tcfg.use_augmentation = True  # the light tier: the fused K3 path
        tcfg.log_dir = str(Path(tmp) / "logs")
        tcfg.profile_dir = str(Path(tmp) / "trace")
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

    # 22. launches
    check(all(n > 0 for n in probe_launches.values()),
          f"a probe kernel never launched: {probe_launches}")
    say("launches", "profiling " + json.dumps(probe_launches) + " (host calls "
        "in the probes: each warm-up and each call captured in a CUDA graph; "
        "the graph's replays add none)")
    launches.update(probe_launches)

    for name, count in loop_phases(errs, smi, model, emodel, ds, dataset, pgen,
                                   tgen).items():
        launches[name] += count
    band = imagenet_phases(errs, smi)
    launches[K5_BAND] = band["launches"]
    launches["etiny_block_kernel"] += band["k6_launches"]
    ms[K5_BAND], bounds[K5_BAND], extra[K5_BAND] = band["ms"], band["bound"], band["extra"]
    library[K5_BAND] = None  # no single call runs the gated photometric chain
    dp = dp_phases(errs, smi, model, qe)
    for name, per_rank in dp.items():
        launches[name] += sum(per_rank)
    for name, count in deploy_phases(errs, smi, payload, efpayload, epayload,
                                     val).items():
        launches[name] += count
    for name, count in graph_phases(smi, dataset,
                                    torch.from_numpy(ds.labels).cuda()).items():
        launches[name] += count
    for name, count in tool_phases(errs, smi, payload, emodel).items():
        launches[name] += count
    for name, count in probe_phases(smi).items():
        launches[name] += count
    for name, count in bench_phase(smi).items():
        launches[name] += count

    # the 8192 entry is the same kernel timed at another batch: its
    # launches are the main path's
    launches[K3_8192] = launches["light_pipeline_kernel"]
    launches[STEM_224] = launches["etiny_stem_kernel"]
    launches[TAIL_224] = launches["etiny_tail_kernel"]
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name],
         "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": errs.max[name], "ms": ms[name][0],
         "plain_ms": ms[name][1], "bound_ms": bounds[name][0],
         "bound_by": bounds[name][1], "library_ms": library[name],
         **({"graph_ms": extra[name][0], "host_ms": extra[name][1]}
            if name in extra else {}),
         **({"library_graph_ms": library_graph[name]}
            if name in library_graph else {}),
         **({"dp_launches_per_rank": dp[name]} if name in dp else {})}
        for name in SOURCES]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
