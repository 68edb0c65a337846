"""The readings a cell's correctness limits are set from: for each seed, the
numbers the check compares for the program (a full set-up, a short window,
the check), for the control ("low": the reference in the next lower
precision than the configuration states standing in the program's place:
float32 → TF32, bfloat16 → float8 operands, int8 → int4 weights), and for
a training cell's fault ("half_batch": a step that leaves half its batch
out). Each stand-in is the plain reference with one change (`STAND_INS`,
by kind of traffic), so the check in `kinds/<kind>.py` carries none. Not
part of a benchmark run.

    python3 -m perfbench.readings --workload <name> --seeds <n> [<n> ...]
        [--seconds 2]

One JSON line per seed: {"seed", "program": {...}, "low": {...}, ...}. On
the card only, as the benchmark.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

from perfbench import spec
from perfbench.kinds import train


class _TF32:
    """TF32 on for the convs and matmuls inside, off again after."""

    def __enter__(self):
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


class _LowRef(train.Ref):
    """The control: the reference one precision below the configuration's,
    TF32 for float32 (switched around the whole run by `train_low`),
    float8 operands for bfloat16."""

    def logits(self, leaves, x):
        s = self.s
        return s.fam.ref_forward(leaves, self.stats, x, s.cfg, train=True,
                                 low=s.cfg["dtype"] != "float32")


class _HalfBatchRef(train.Ref):
    """The fault: a step that leaves half its batch out and takes the mean
    over the rest."""

    def inputs(self, idx, draw):
        x, labels = super().inputs(idx, draw)
        return x[:len(x) // 2], labels[:len(x) // 2]


def train_low(s) -> dict:
    """The control's readings; only the stand-in runs under TF32, the
    reference it is held to runs with TF32 off."""
    if s.cfg["dtype"] == "float32":
        with _TF32():
            low = train.follow(s, _LowRef)
    else:
        low = train.follow(s, _LowRef)
    return train.compare(s, low)


def train_half_batch(s) -> dict:
    return train.compare(s, train.follow(s, _HalfBatchRef))


def serve_low(s) -> dict:
    """The control: the reference's own logits with int4 weights."""
    from perfbench.kinds import serve
    return serve.compare(s, list(serve.reference(s, bits=4).items()))


STAND_INS = {"train": {"low": train_low, "half_batch": train_half_batch},
             "serve": {"low": serve_low}}


def readings(cell: spec.Cell, seed: int, seconds: float, device) -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = spec.kind(cell.traffic)
    s = kind.build(cell, seed, device)
    kind.warm(s)
    kind.window(s, seconds)
    kind.release(s)
    out = {"seed": seed, "program": kind.compare(s)}
    for name, stand_in in STAND_INS[cell.traffic["kind"]].items():
        out[name] = stand_in(s)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    cell = spec.load_cell(Path.cwd(), args.workload)
    for seed in args.seeds:
        print(json.dumps(readings(cell, seed, args.seconds,
                                  torch.device(args.device))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
