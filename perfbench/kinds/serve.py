"""Serving traffic: a closed loop of one client with one call in flight.

A mix file gives the batch of a call and the number of device-resident
image buffers the calls cycle through. Each call runs from its submission
to its logits on the host: the family's serving entry on the next buffer,
then the logits copied into the client's pinned host buffer and waited
for. Images are made on the device (a deployment's
decoder puts frames there), so the upload is not in a call.

Set-up makes the float weights from the seed (with the family's running
statistics), builds the program's model, lets the program derive its int8
serving parameters, makes the buffers and calls each once. The window
calls until `--seconds` have passed. A sample of the calls, drawn from the
seed over the whole window, keeps its logits for the check: the reference
quantizes the same float weights anew and computes the engine's logits of
the same buffers, which must be equal.
"""

from __future__ import annotations

import gc
import math
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from perfbench import inputs, spec, trace
from perfbench.reference import augment as ref_aug

SAMPLE = 8           # calls whose logits the check compares
TRACE_SECONDS = 1.0
REF_ROWS = 2048      # rows of one block of the reference's forward


class Setup:
    """The program's serving entry and everything the window and the check
    read."""


def build(cell: spec.Cell, seed: int, device: torch.device) -> Setup:
    cfg, traffic = cell.config, cell.traffic
    fam = spec.family(cfg)
    s = Setup()
    s.cfg, s.traffic, s.fam, s.device, s.seed = cfg, traffic, fam, device, seed
    s.batch = traffic["batch"]
    hw = cfg["input_size"]
    s.weights = inputs.make_params(fam.param_specs(cfg), seed, device)
    s.stats = fam.serving_stats(s.weights, cfg, seed, device)
    model = fam.port_model(cfg, device)
    model.load_state_dict({**s.weights, **s.stats}, strict=True)
    s.call = fam.port_serving(model.eval(), cfg, device)
    n = traffic["buffers"]
    frames = inputs.make_images(n * s.batch, hw, seed, "serving", device)
    s.buffers = list(ref_aug.normalize(frames).reshape(n, s.batch, hw, hw, 3))
    s.pinned = (torch.empty((s.batch, cfg["num_classes"]), pin_memory=True)
                if device.type == "cuda" else None)
    return s


def _read(s: Setup, out: torch.Tensor) -> torch.Tensor:
    """The call's logits on the host: copied into the client's pinned
    buffer, then waited for (on the CPU, the logits themselves)."""
    if s.pinned is None:
        return out
    s.pinned.copy_(out, non_blocking=True)
    torch.cuda.current_stream(s.device).synchronize()
    return s.pinned


def warm(s: Setup) -> None:
    """One call on every buffer, its logits read: the kernels are built
    and every shape the window uses has run."""
    for buf in s.buffers:
        _read(s, s.call(buf))
    s.graph = None


def window(s: Setup, seconds: float) -> dict:
    rng = np.random.default_rng(inputs.sub_seed(s.seed, "sample"))
    kept: List[tuple] = []
    lat: List[float] = []
    host: List[float] = []
    n = 0
    nb = len(s.buffers)
    t0 = time.perf_counter()
    while True:
        a = time.perf_counter()
        out = s.call(s.buffers[n % nb])
        b = time.perf_counter()
        logits = _read(s, out)
        c = time.perf_counter()
        lat.append(c - a)
        host.append(b - a)
        # a uniform sample of all calls (reservoir), drawn from the seed
        if n < SAMPLE:
            kept.append((n % nb, logits.clone()))
        else:
            j = int(rng.integers(0, n + 1))
            if j < SAMPLE:
                kept[j] = (n % nb, logits.clone())
        n += 1
        if c - t0 >= seconds:
            break
    s.kept = kept
    # a call that raises ends the run; the values are the check's to judge
    return {"seconds": c - t0, "calls": n, "failed": 0,
            "images_per_s": n * s.batch / (c - t0), "latency_s": lat,
            "host_s": host}


def traced_window(s: Setup, w: dict) -> dict:
    n = max(2, math.ceil(TRACE_SECONDS * w["calls"] / w["seconds"]))
    nb = len(s.buffers)

    def body():
        for i in range(n):
            _read(s, s.call(s.buffers[i % nb]))
    out = trace.traced(body, s.device)
    out["calls"] = n
    return out


def release(s: Setup) -> None:
    """Free the program's serving state before the reference runs."""
    s.call = None
    gc.collect()
    if s.device.type == "cuda":
        torch.cuda.empty_cache()


def end_to_end(s: Setup, w: dict, setup_s: float) -> Dict[str, float]:
    return {"serve_images_per_s": w["images_per_s"],
            "serve_call_ms_p95": float(np.percentile(w["latency_s"], 95)) * 1e3,
            "setup_s": setup_s}


def _ref_logits(s: Setup, q, buf: torch.Tensor) -> torch.Tensor:
    return torch.cat([s.fam.ref_engine(q, buf[i:i + REF_ROWS], s.cfg).cpu()
                      for i in range(0, buf.shape[0], REF_ROWS)])


def reference(s: Setup, bits: int = 8) -> Dict[int, torch.Tensor]:
    """The reference's logits of each buffer a sampled call served, the
    float weights quantized anew to `bits`-bit weights."""
    q = s.fam.ref_quantize(s.weights, s.stats, s.cfg, bits=bits)
    return {i: _ref_logits(s, q, s.buffers[i]) for i in sorted({k for k, _ in s.kept})}


def compare(s: Setup, got: Optional[List[tuple]] = None) -> Dict[str, float]:
    """`logit_gap`: the largest |program − reference| over every logit of
    the sampled calls (or of `got`, a stand-in's [(buffer, logits)]). The
    engine is exact, so the limit is 0."""
    want = reference(s)
    got = s.kept if got is None else got
    return {"logit_gap": max(float((g - want[i]).abs().max()) for i, g in got)}
