"""The `quant` phase of a captured train step's node count
(`training/step.py` `PHASES`, marked by `tracing.phase_end` around the
quantizer calls of `models/etinynet.py`), and the engine-friendly
EtinyNet's multiply-add count that the benchmark's `mfu.train` reads
(`perfbench/reference/etinynet_ef.py` `forward_macs`), both on the CPU.

A capture counts nodes through the CUDA driver; here each dispatched
operation stands in for a graph node that depends on the one before, as
on one stream, so the same marks and the same count run without a card.
"""

from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from nnue_vision_tpu_torch import tracing
from nnue_vision_tpu_torch.training import step
from nnue_vision_tpu_torch.training.optim import create_optimizer
from perfbench import inputs, spec
from perfbench.families import etinynet, etinynet_ef, nnue
from perfbench.reference import etinynet_ef as ref_ef

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def test_ef_forward_count_by_hand():
    """EtinyNet-0.75 engine-friendly at 32: the stem at 16x16; per stage the
    first block's expand at its input size, every depthwise and project at
    the strided size; no residual add, no dense projection; the final 1x1
    conv at 2x2; the classifier."""
    cfg = spec.load_cell(REPO, "etiny_ef_qat_train_light").config
    stem = 16 * 16 * 24 * 27
    lb1 = 16 * 16 * 24 * 24 + 8 * 8 * (24 * 9 + 24 * 24) \
        + 2 * 8 * 8 * (24 * 24 + 24 * 9 + 24 * 24)
    lb2 = 8 * 8 * 24 * 96 + 4 * 4 * (96 * 9 + 96 * 96) \
        + 2 * 4 * 4 * (96 * 96 + 96 * 9 + 96 * 96)
    dlb3 = 4 * 4 * 96 * 144 + 2 * 2 * (144 * 9 + 144 * 144) \
        + 2 * 2 * 2 * (144 * 144 + 144 * 9 + 144 * 144)
    dlb4 = 2 * 2 * 144 * 192 + 1 * 1 * (192 * 9 + 192 * 192) \
        + 1 * 1 * (192 * 192 + 192 * 9 + 192 * 192)
    final, head = 1 * 1 * 192 * 960, 960 * 10
    total = stem + lb1 + lb2 + dlb3 + dlb4 + final + head
    assert ref_ef.forward_macs(cfg) == total == 2_535_360


def _phase_model(kind):
    """A tiny model of each kind: the engine-friendly EtinyNet with its
    quantizers on (the ef cell's) and off (its warm-up), the plain
    EtinyNet, the NNUE."""
    if kind == "nnue":
        cfg = dict(spec.load_cell(REPO, "nnue_train_light").config,
                   l1_size=64, l2_size=16, l3_size=8)
        fam = nnue
    elif kind == "etinynet":
        cfg = dict(spec.load_cell(REPO, "etiny_train_heavy").config,
                   variant="micro", dtype="float32")
        fam = etinynet
    else:
        cfg = dict(spec.load_cell(REPO, "etiny_ef_qat_train_light").config,
                   variant="micro", ef_quantizers=kind == "ef_quantized")
        fam = etinynet_ef
    model = fam.port_model(cfg, CPU)
    model.load_state_dict({**inputs.make_params(fam.param_specs(cfg), 5, CPU),
                           **fam.init_stats(cfg, CPU)}, strict=True)
    return model, cfg


PHASE_KINDS = {"ef_quantized": True, "ef_warm_up": False, "etinynet": False,
               "nnue": False}


@pytest.mark.parametrize("kind", list(PHASE_KINDS))
def test_quant_phase_adds_up_with_the_others(kind):
    """One train step with its phase marks counted as a capture counts
    them: the phases add up to every operation of the step; `quant` is
    there, and more than zero, only for the engine-friendly model with its
    quantizers on."""

    class Ops(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Ops.n += 1
            return func(*args, **(kwargs or {}))

    class Counted(step._PhaseNodes):
        def where(self):  # the n-th operation stands for a node
            return (Ops.n,) if Ops.n else ()

    model, cfg = _phase_model(kind)
    opt = create_optimizer(SimpleNamespace(**cfg["recipe"]), 1)
    state = step.make_train_state(model, opt)
    g = torch.Generator().manual_seed(1)
    x = torch.randn((4, 32, 32, 3), generator=g)
    y = torch.randint(0, 10, (4,), generator=g)
    phases = Counted(SimpleNamespace(cuda_stream=0))
    with tracing.phase_marks(phases.mark), Ops():
        step.train_step(state, x, y, optimizer=opt)
    nodes = phases.count(lambda i: (i - 1,) if i > 1 else ())
    assert sum(nodes.values()) == Ops.n > 0
    assert nodes["model"] > 0 and nodes["update"] > 0
    assert ("quant" in nodes) is PHASE_KINDS[kind]
    if PHASE_KINDS[kind]:
        assert list(nodes) == ["input", "model", "update", "tail", "quant"]
        assert 0 < nodes["quant"] < nodes["model"]


def test_phase_marks_reach_only_the_capture_running():
    """Outside `phase_marks` a mark does nothing; inside, the marker takes
    each phase in order; after it, nothing again."""
    seen = []
    tracing.phase_end("model")
    with tracing.phase_marks(seen.append):
        tracing.phase_end("input")
        tracing.phase_end("quant")
    tracing.phase_end("update")
    assert seen == ["input", "quant"]
