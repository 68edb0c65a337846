"""Training traffic: the trainer's own chunk call, as `training/loop.py`
drives it, over a device-resident dataset, for `--seconds`.

A mix file gives the augmentation `tier` ("none", "light", "medium" or
"heavy"; "none" trains on the gathered images as they are) and whether
the chunk is the fused light path (`fused`: `scanned_train_steps_fused`,
one K3 launch a step; the light tier only) or the loop's general chunk
(`scanned_train_steps`). The reference follows each tier by its name
(`reference/augment.py`'s `draw_<tier>` and `apply_<tier>`). The
configuration gives the model, the recipe (batch, steps a dispatch, the
optimizer and its schedule) and the dataset's size. The reference steps
with the optimizer the recipe's `optimizer_type` names
(`reference/optim.py`: "sgd" or "adam"; any other raises at set-up).

Set-up makes the weights, the data and the trainer's draw generator from
the seed, builds the program's model and optimizer state, and drives that
one state through its first steps with the same call the window makes: a
chunk of one step, then one of two (the three steps the reference
follows), then a full chunk (on the card the chunk graph's eager warm-up)
and a second one (its capture and first replay; the program's state
before and after it, the optimizer's whole state with it, is kept for the
replay check). The window then calls the chunk on fresh index chunks with
no sync until the last, whose final loss it reads: images trained over
the window's seconds.

After the window the program's state is freed and the reference follows
the same steps from the same inputs (see `compare`).
"""

from __future__ import annotations

import gc
import math
import statistics
import time
from types import SimpleNamespace
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.nn import functional as F

from perfbench import inputs, spec, trace
from perfbench.reference import augment as ref_aug
from perfbench.reference import optim as ref_optim

# a traced window holds at most this many device operations
TRACE_EVENTS = 200_000
TRACE_SECONDS = 1.0
TIERS = ("none", "light", "medium", "heavy")


class Setup:
    """The program's state and everything the window and the check read."""


def _clone(d: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in d.items()}


def _opt_snapshot(state: dict) -> dict:
    """An optimizer state's whole copy: its count and every buffer dict."""
    return {k: int(v) if k == "count" else _clone(v) for k, v in state.items()}


def build(cell: spec.Cell, seed: int, device: torch.device) -> Setup:
    from nnue_vision_tpu_torch.data.augment import device_generator
    from nnue_vision_tpu_torch.ops.input_pipeline import prepare_gather_dataset
    from nnue_vision_tpu_torch.training.optim import create_optimizer
    from nnue_vision_tpu_torch.training.step import (
        make_train_state,
        scanned_train_steps,
        scanned_train_steps_fused,
    )

    cfg, traffic = cell.config, cell.traffic
    rec = cfg["recipe"]
    fam = spec.family(cfg)
    s = Setup()
    s.cfg, s.traffic, s.fam, s.device, s.seed = cfg, traffic, fam, device, seed
    s.moment = ref_optim.FIRST_MOMENT[ref_optim.kind(rec)]
    s.batch, s.steps = rec["batch_size"], rec["steps_per_dispatch"]
    hw, n = cfg["input_size"], cfg["train_images"]
    s.weights = inputs.make_params(fam.param_specs(cfg), seed, device)
    s.stats0 = fam.init_stats(cfg, device)
    model = fam.port_model(cfg, device)
    model.load_state_dict({**s.weights, **s.stats0}, strict=True)
    optimizer = create_optimizer(SimpleNamespace(**rec), rec["steps_per_epoch"])
    s.state = make_train_state(model, optimizer)
    s.images = inputs.make_images(n, hw, seed, "data", device)
    s.labels = inputs.make_labels(n, cfg["num_classes"], seed, device)
    s.batches = inputs.Batches(seed, n, s.batch)
    gen = torch.Generator().manual_seed(inputs.sub_seed(seed, "draws"))
    tier = traffic["tier"]
    if tier not in TIERS:
        raise ValueError(f"a train mix's tier is one of {TIERS}, not {tier!r}")
    if traffic["fused"] and tier != "light":
        raise ValueError("the fused chunk runs the light tier only, not "
                         f"{tier!r}")
    noise_gen = (device_generator(gen, device)
                 if ref_aug.NOISE_DRAWS[tier] else None)
    if traffic["fused"]:
        data = prepare_gather_dataset(s.images)

        def call(idx):
            return scanned_train_steps_fused(
                s.state, data, s.labels, idx, gen, optimizer=optimizer,
                height=hw, width=hw)["loss"]
    else:
        def call(idx):
            return scanned_train_steps(
                s.state, s.images, s.labels, idx, gen, optimizer=optimizer,
                strength="light" if tier == "none" else tier,
                augment=tier != "none", noise_gen=noise_gen)["loss"]
    s.call = call
    s.chunks = [s.batches.chunk(1), s.batches.chunk(2),
                s.batches.chunk(s.steps), s.batches.chunk(s.steps)]
    return s


def warm(s: Setup) -> None:
    """Set-up's program steps (see the module docstring)."""
    def params():
        return _clone(dict(s.state.model.named_parameters()))

    losses = [s.call(s.chunks[0])]
    s.opt1 = _opt_snapshot(s.state.opt_state)
    losses.append(s.call(s.chunks[1]))
    s.params3 = params()
    s.loss13 = [float(v) for t in losses for v in t.tolist()]
    s.call(s.chunks[2])
    s.snap = params()
    s.snap_opt = _opt_snapshot(s.state.opt_state)
    s.snap_stats = _clone(dict(s.state.model.named_buffers()))
    s.replay_losses = [float(v) for v in s.call(s.chunks[3]).tolist()]
    s.replay_params = params()
    graph = s.state.chunk_graph
    s.graph = (None if graph is None or graph.graph is None
               else {"nodes": graph.nodes, "steps": graph.steps,
                     "capture_s": graph.capture_s,
                     "instantiate_s": graph.instantiate_s})


def window(s: Setup, seconds: float) -> dict:
    """The chunk call on fresh index chunks until `seconds` have passed,
    then one read of the last loss; all losses are checked once read."""
    losses: List[torch.Tensor] = []
    host: List[float] = []
    t0 = time.perf_counter()
    while True:
        idx = s.batches.chunk(s.steps)
        a = time.perf_counter()
        losses.append(s.call(idx))
        b = time.perf_counter()
        host.append(b - a)
        if b - t0 >= seconds:
            break
    losses[-1][-1].item()  # the one sync: the chunks ran in order
    t1 = time.perf_counter()
    failed = int((~torch.isfinite(torch.cat(losses).cpu())).sum())
    images = len(losses) * s.steps * s.batch
    return {"seconds": t1 - t0, "dispatches": len(losses),
            "steps": len(losses) * s.steps, "failed": failed,
            "images_per_s": images / (t1 - t0), "host_s": host}


def traced_window(s: Setup, w: dict) -> dict:
    """A few dispatches under the profiler: about TRACE_SECONDS of them, and
    no more than TRACE_EVENTS device operations."""
    nodes = s.graph["nodes"] if s.graph else 1
    n = max(2, min(math.ceil(TRACE_SECONDS * w["dispatches"] / w["seconds"]),
                   TRACE_EVENTS // max(1, nodes)))
    chunks = [s.batches.chunk(s.steps) for _ in range(n)]

    def body():
        for idx in chunks:
            s.call(idx)
    out = trace.traced(body, s.device)
    out["dispatches"], out["steps"] = n, n * s.steps
    return out


def release(s: Setup) -> None:
    """Free the program's state before the reference runs."""
    s.state = s.call = None
    gc.collect()
    if s.device.type == "cuda":
        torch.cuda.empty_cache()


def end_to_end(s: Setup, w: dict, setup_s: float) -> Dict[str, float]:
    return {"train_images_per_s": w["images_per_s"], "setup_s": setup_s}


# ---------------------------------------------------------------------------
# the check
# ---------------------------------------------------------------------------


class Ref:
    """The reference trainer: its parameters, norm statistics, optimizer
    state (the step count and the recipe's optimizer's buffers), its draw
    generators, and one step. A stand-in for the program
    (`perfbench/readings.py`) overrides `inputs` or `logits`."""

    def __init__(self, s: Setup, params, stats, opt: dict):
        self.s = s
        self.p = {k: v.clone() for k, v in params.items()}
        self.stats = {k: v.clone() for k, v in stats.items()}
        self.opt = _opt_snapshot(opt)
        tier = s.traffic["tier"]
        self.fused = s.traffic["fused"]
        self.draw_step = getattr(ref_aug, f"draw_{tier}")
        self.apply_step = getattr(ref_aug, f"apply_{tier}")
        self.noise_draws = ref_aug.NOISE_DRAWS[tier]
        self.gen = torch.Generator().manual_seed(inputs.sub_seed(s.seed, "draws"))
        self.noise = (ref_aug.noise_generator(self.gen, s.device)
                      if self.noise_draws else None)

    def draws(self, steps: int):
        """The draws of one chunk of `steps` steps, in the trainer's order."""
        hw, b = self.s.cfg["input_size"], self.s.batch
        if self.fused:  # the fused chunk draws all steps at once
            d = ref_aug.draw_light_chunk(self.gen, steps, b, hw, hw)
            return [{k: v[j] for k, v in d.items()} for j in range(steps)]
        return [self.draw_step(self.gen, b, hw, hw) for _ in range(steps)]

    def skip(self, steps: int) -> None:
        """Advance the generators past a chunk the reference does not
        follow."""
        self.draws(steps)
        hw, b = self.s.cfg["input_size"], self.s.batch
        for _ in range(self.noise_draws * steps):
            torch.randn((b, hw, hw, 3), generator=self.noise,
                        device=self.s.device)

    def inputs(self, idx: np.ndarray, draw):
        """One step's normalized batch and its labels."""
        s, dev = self.s, self.s.device
        i = torch.as_tensor(idx, dtype=torch.int64, device=dev)
        x = s.images.index_select(0, i)
        if self.fused:
            x = ref_aug.apply_light_fused(x, _to(draw, dev))
        else:
            x = self.apply_step(x, _to(draw, dev), self.noise)
        return ref_aug.normalize(x), s.labels.index_select(0, i)

    def logits(self, leaves, x):
        s = self.s
        return s.fam.ref_forward(leaves, self.stats, x, s.cfg, train=True)

    def step(self, idx: np.ndarray, draw) -> Dict[str, object]:
        s = self.s
        x, labels = self.inputs(idx, draw)
        leaves = {k: v.detach().requires_grad_(True) for k, v in self.p.items()}
        loss = F.cross_entropy(self.logits(leaves, x), labels)
        grads = dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values()), allow_unused=True)))
        ref_optim.step(self.p, grads, self.opt, s.cfg["recipe"])
        s.fam.ref_after_update(self.p)
        return {"loss": float(loss.detach()),
                "grad_norms": {k: 0.0 if g is None else float(g.norm())
                               for k, g in grads.items()}}

    def chunk(self, idx: np.ndarray) -> List[Dict[str, object]]:
        return [self.step(row, d) for row, d in zip(idx, self.draws(len(idx)))]


def _to(draw, device):
    """A step's draws (a tensor, or a dict, list or tuple of them, or None)
    on `device`."""
    if isinstance(draw, torch.Tensor):
        return draw.to(device)
    if isinstance(draw, dict):
        return {k: _to(v, device) for k, v in draw.items()}
    if isinstance(draw, (list, tuple)):
        return type(draw)(_to(v, device) for v in draw)
    return draw


def _norms(d: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in d.items()}


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float], keep) -> float:
    """The worst leaf's |‖prog‖ − ‖ref‖| over the larger of ‖ref‖ and the
    median leaf's ‖ref‖, over the leaves in `keep`."""
    median = statistics.median(ref[k] for k in keep)
    return max(abs(prog[k] - ref[k]) / max(ref[k], median, 1e-30) for k in keep)


def loss_gap(prog: List[float], ref: List[float]) -> float:
    return max(abs(p - r) / abs(r) for p, r in zip(prog, ref))


def _diff(a, b):
    return {k: a[k] - b[k] for k in a}


def follow(s: Setup, ref_cls=Ref) -> dict:
    """What `ref_cls` makes of the steps the check compares, from the same
    weights, data and draws as the program: the first three steps' losses,
    the optimizer's first moment after step 1 and the parameters after
    step 3, from a zero optimizer state; the losses and parameters of the
    chunk that captured the graph and ran its first replay, followed from
    the program's state before that call, its whole optimizer state with
    it (the chunk in between is skipped); and each leaf's gradient norm at
    step 1."""
    ref = ref_cls(s, s.weights, s.stats0,
                  ref_optim.init(s.cfg["recipe"], s.weights))
    r1 = ref.chunk(s.chunks[0])
    moment1 = _clone(ref.opt[s.moment])
    r23 = ref.chunk(s.chunks[1])
    ref.skip(s.steps)
    rr = ref_cls(s, s.snap, s.snap_stats, s.snap_opt)
    rr.gen, rr.noise = ref.gen, ref.noise
    rl = rr.chunk(s.chunks[3])
    return {"loss13": [r["loss"] for r in r1 + r23], "moment1": moment1,
            "params3": _clone(ref.p), "grad_norms1": r1[0]["grad_norms"],
            "replay_losses": [r["loss"] for r in rl], "replay_params": rr.p}


def program(s: Setup) -> dict:
    """The program's readings of the steps `follow` follows, kept by
    `warm`."""
    return {"loss13": s.loss13, "moment1": s.opt1[s.moment],
            "params3": s.params3, "replay_losses": s.replay_losses,
            "replay_params": s.replay_params}


def compare(s: Setup, prog: Optional[dict] = None) -> Dict[str, float]:
    """The numbers the check compares, of the program (or of `prog`, a
    stand-in's `follow`) against the reference:

    * `loss_gap`: the worst relative gap of the first three steps' losses;
    * `grad_gap`: the worst leaf's gap of the optimizer's first moment
      after step 1, the first gradient as the optimizer takes it (clipped,
      decayed): SGD's momentum trace, Adam's `mu`, (1 − b1) times it;
    * `update_gap`: the worst leaf's gap of the parameters' change over the
      first three steps;
    * `replay_loss_gap`, `replay_update_gap`: the same for the first three
      losses and the whole chunk's change of the chunk whose call captured
      the graph and ran its first replay.

    Every leaf gap, under SGD and Adam alike, is the gap of two norms
    (`leaf_gap`), not the norm of the two changes' difference.

    Leaves whose reference gradient at step 1 is under a thousandth of the
    median leaf's (the NNUE's `nnue2score`, which no loss reaches; the
    EtinyNet's norm scales and biases that a following norm cancels) count
    in no leaf gap: they move by the weight decay, or under Adam by its
    scaling of their rounding, alone."""
    prog = program(s) if prog is None else prog
    ref = follow(s)
    g1 = ref["grad_norms1"]
    med = statistics.median(g1.values())
    keep = [k for k, v in g1.items() if v >= 1e-3 * med]
    start = s.snap
    return {
        "loss_gap": loss_gap(prog["loss13"], ref["loss13"]),
        "grad_gap": leaf_gap(_norms(prog["moment1"]), _norms(ref["moment1"]),
                             keep),
        "update_gap": leaf_gap(_norms(_diff(prog["params3"], s.weights)),
                               _norms(_diff(ref["params3"], s.weights)), keep),
        "replay_loss_gap": loss_gap(prog["replay_losses"][:3],
                                    ref["replay_losses"][:3]),
        "replay_update_gap": leaf_gap(_norms(_diff(prog["replay_params"], start)),
                                      _norms(_diff(ref["replay_params"], start)),
                                      keep),
    }
