"""The harness on the CPU at tiny sizes: files found by name, a new
configuration, traffic mix and per-layer metric each added as files
alone, the counts of work against numbers
worked by hand, the result line's keys, and the check failing for each
fault a cell can have."""

from __future__ import annotations

import importlib
import json
import math

import pytest
import torch

from perfbench import run, spec
from perfbench.tests.tiny import REPO, make_root

SEED = 2**31 + 12345  # above 32 signed bits, as the driver's seeds are
CPU = torch.device("cpu")
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
TRAIN = [w["name"] for w in BENCH["workloads"] if w["traffic"].startswith("train")]
SERVE = [w["name"] for w in BENCH["workloads"] if w["traffic"].startswith("serve")]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("checkout"))


def _quiet(_msg):
    pass


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_load_by_name(name):
    cell = spec.load_cell(REPO, name)
    assert spec.family(cell.config).param_specs(cell.config)
    kind = spec.kind(cell.traffic)
    for fn in ("build", "warm", "window", "traced_window", "release",
               "end_to_end", "compare"):
        assert callable(getattr(kind, fn))
    assert cell.limits and all(v >= 0 for v in cell.limits.values())
    for m in cell.per_layer:
        assert callable(spec.metric_reader(REPO, m["name"]).read)
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}


def test_every_metric_has_a_reader_or_is_end_to_end():
    for m in BENCH["per_layer"]:
        assert (REPO / "perfbench" / "metrics" / f"{m['name']}.py").is_file()
    for c in BENCH["configs"]:
        assert (REPO / c["file"]).is_file()
    for w in BENCH["workloads"]:
        assert (REPO / "perfbench" / "traffic" / f"{w['traffic']}.json").is_file()
        assert (REPO / "perfbench" / "limits" / f"{w['name']}.json").is_file()


def test_new_configuration_is_found_with_no_edit(root, tmp_path):
    """A throwaway configuration, cell and limits written as files into a
    copy of the checkout run with no change to any harness file."""
    import shutil
    new = tmp_path / "checkout"
    shutil.copytree(root, new)
    cfg = json.loads((new / "perfbench/configs/nnue_hard.json").read_text())
    cfg["l1_size"] = 32
    (new / "perfbench/configs/nnue_tiny.json").write_text(json.dumps(cfg))
    bench = json.loads((new / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "nnue_tiny", "source": "test",
                             "file": "perfbench/configs/nnue_tiny.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "nnue_tiny.serve", "config": "nnue_tiny",
                               "traffic": "serve_closed_b8192", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "nnue_serve_b8192" in m.get("workloads", ()):
            m["workloads"].append("nnue_tiny.serve")
    (new / "BENCHMARK.json").write_text(json.dumps(bench))
    (new / "perfbench/limits/nnue_tiny.serve.json").write_text('{"logit_gap": 0.0}')
    line = run.execute(spec.load_cell(new, "nnue_tiny.serve"), SEED, 0.2, False,
                       CPU, _quiet)
    assert line["correct"] and line["attempted"] > 0
    assert set(line["metrics"]) == {"serve_images_per_s", "serve_call_ms_p95",
                                    "setup_s"}


def _add_cell(root, tmp_path, cell, config, mix, limits_of):
    """A copy of the checkout `root` with the traffic mix `mix` (a dict)
    and a cell `cell` of `config` on it added as files and entries alone,
    its limits those of the cell `limits_of`, every metric of `limits_of`
    also reported by it."""
    import shutil
    new = tmp_path / "checkout"
    shutil.copytree(root, new)
    (new / f"perfbench/traffic/{cell}.mix.json").write_text(json.dumps(mix))
    bench = json.loads((new / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": cell, "config": config,
                               "traffic": f"{cell}.mix", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if limits_of in m.get("workloads", ()):
            m["workloads"].append(cell)
    (new / "BENCHMARK.json").write_text(json.dumps(bench))
    shutil.copy(new / f"perfbench/limits/{limits_of}.json",
                new / f"perfbench/limits/{cell}.json")
    return new


MIXES = [("etinynet_cifar10", "none", "etiny_train_heavy"),
         ("etinynet_cifar10", "medium", "etiny_train_heavy"),
         ("nnue_hard", "light", "nnue_train_light")]


@pytest.mark.parametrize("config,tier,limits_of", MIXES,
                         ids=[f"{c}-{t}" for c, t, _ in MIXES])
def test_new_train_mix_is_found_with_no_edit(root, tmp_path, monkeypatch,
                                            config, tier, limits_of):
    """A train mix of another tier, on the general chunk, added as files
    alone: the program runs that tier, the reference follows it by name,
    and the check holds (and fails when the step returns its state
    unchanged)."""
    new = _add_cell(root, tmp_path, "new_mix", config,
                    {"kind": "train", "tier": tier, "fused": False,
                     "why": "test"}, limits_of)
    cell = spec.load_cell(new, "new_mix")
    line = run.execute(cell, SEED, 0.2, False, CPU, _quiet)
    assert line["correct"], line["compared"]
    assert set(line["metrics"]) == {"train_images_per_s", "setup_s"}
    _unchanged(monkeypatch)
    assert not run.execute(cell, SEED, 0.2, False, CPU, _quiet)["correct"]


def test_train_cell_past_the_two_pass_rule_is_added_as_files(root, tmp_path,
                                                            monkeypatch):
    """A medium-tier train cell of the etinynet_imagenet family at 64×64
    (micro widths), where the warp takes the gather, added as a
    configuration file, a mix file and entries alone: it reads correct
    under `etiny_train_medium`'s limits, and the half-batch fault does
    not."""
    import shutil
    from perfbench.reference.augment import two_pass
    base = tmp_path / "base"
    shutil.copytree(root, base)
    cfg = json.loads((base / "perfbench/configs/etinynet_imagenet.json").read_text())
    cfg["input_size"] = 64
    assert not two_pass(64, 64)
    (base / "perfbench/configs/imagenet_64.json").write_text(json.dumps(cfg))
    bench = json.loads((base / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "imagenet_64", "source": "test",
                             "file": "perfbench/configs/imagenet_64.json",
                             "reduced": [], "why": "test"})
    (base / "BENCHMARK.json").write_text(json.dumps(bench))
    mix = json.loads((REPO / "perfbench/traffic/train_medium.json").read_text())
    new = _add_cell(base, tmp_path, "imagenet_train_medium", "imagenet_64",
                    mix, "etiny_train_medium")
    cell = spec.load_cell(new, "imagenet_train_medium")
    line = run.execute(cell, SEED, 0.2, False, CPU, _quiet)
    assert line["correct"], line["compared"]
    assert set(line["metrics"]) == {"train_images_per_s", "setup_s"}
    _half_batch(monkeypatch)
    line = run.execute(cell, SEED, 0.2, False, CPU, _quiet)
    assert line["correct"] is False, line["compared"]


def _repo_with_config(tmp_path, name, cfg, cell, traffic, limits,
                      metrics_of):
    """A copy of the repository's benchmark files with one more
    configuration `name` (the dict `cfg`) and its cell `cell` on the mix
    `traffic`, as files and entries alone: the cell's limits `limits`, its
    metrics those of the cell `metrics_of`. Then a checkout root that
    `make_root` cuts from that copy."""
    import shutil
    src = tmp_path / "src"
    src.mkdir()
    shutil.copy(REPO / "BENCHMARK.json", src / "BENCHMARK.json")
    for sub in ("metrics", "limits", "traffic", "configs"):
        shutil.copytree(REPO / "perfbench" / sub, src / "perfbench" / sub)
    (src / f"perfbench/configs/{name}.json").write_text(json.dumps(cfg))
    (src / f"perfbench/limits/{cell}.json").write_text(json.dumps(limits))
    bench = json.loads((src / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": name, "source": "test",
                             "file": f"perfbench/configs/{name}.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": cell, "config": name,
                               "traffic": traffic, "chips": 1, "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if metrics_of in m.get("workloads", ()):
            m["workloads"].append(cell)
    (src / "BENCHMARK.json").write_text(json.dumps(bench))
    out = tmp_path / "root"
    out.mkdir()
    return make_root(out, repo=src)


def _adam_config(**recipe):
    """EtinyNet-0.98M in float32 with the engine-friendly anchor's Adam
    recipe (`config/train_etinynet_anchor_qat.py`: lr 8e-4, decay 1e-4,
    clip 1.0, cosine, batch 256, 19 steps a dispatch, 5,000 images)."""
    cfg = json.loads((REPO / "perfbench/configs/etinynet_cifar10.json").read_text())
    cfg.update(dtype="float32", train_images=5000)
    cfg["recipe"].update({"optimizer_type": "adam", "learning_rate": 8e-4,
                          "weight_decay": 1e-4, "max_grad_norm": 1.0,
                          "max_epochs": 35, "batch_size": 256,
                          "steps_per_epoch": 19, "steps_per_dispatch": 19,
                          **recipe})
    return cfg


# on the CPU the program reads at most float32 rounding against the
# reference at the micro cut (0 to 2.5e-5, the most on the change of the
# first three steps), the half-batch fault 0.04 (loss) to 1.6 (that change)
ADAM_LIMITS = {"loss_gap": 1e-5, "grad_gap": 1e-5, "update_gap": 1e-3,
               "replay_loss_gap": 1e-5, "replay_update_gap": 1e-3}


def test_adam_train_cell_is_added_as_files(tmp_path, monkeypatch):
    """A train cell whose recipe names Adam, of a configuration that the
    tiny cut names nowhere, added as a configuration file, a limits file
    and entries alone on the existing light unfused mix: set-up, window
    and check run with the reference stepping Adam and read correct, and
    the half-batch fault does not."""
    from perfbench.tests import tiny
    assert "etiny_adam" not in tiny.RECIPE
    root = _repo_with_config(tmp_path, "etiny_adam", _adam_config(),
                             "etiny_adam_train", "train_light_unfused",
                             ADAM_LIMITS, "nnue_train_light_unfused")
    cell = spec.load_cell(root, "etiny_adam_train")
    assert cell.config["recipe"]["batch_size"] == tiny.DEFAULT_RECIPE["batch_size"]
    line = run.execute(cell, SEED, 0.2, False, CPU, _quiet)
    assert line["correct"], line["compared"]
    assert set(line["metrics"]) == {"train_images_per_s", "setup_s"}
    _half_batch(monkeypatch)
    line = run.execute(cell, SEED, 0.2, False, CPU, _quiet)
    assert line["correct"] is False, line["compared"]


def test_unknown_optimizer_is_refused_at_set_up(tmp_path):
    root = _repo_with_config(tmp_path, "etiny_lamb",
                             _adam_config(optimizer_type="lamb"),
                             "etiny_lamb_train", "train_light_unfused",
                             ADAM_LIMITS, "nnue_train_light_unfused")
    cell = spec.load_cell(root, "etiny_lamb_train")
    from perfbench.kinds import train
    with pytest.raises(ValueError, match="optimizer_type 'lamb'"):
        train.build(cell, SEED, CPU)


def test_new_configuration_file_alone_is_cut_by_make_root(tmp_path):
    """A configuration file that the tiny cut does not name is cut by its
    family's widths and the default recipe, and a cell of it runs."""
    from perfbench.tests import tiny
    cfg = json.loads((REPO / "perfbench/configs/nnue_hard.json").read_text())
    root = _repo_with_config(tmp_path, "nnue_other", cfg, "nnue_other_train",
                             "train_light_fused",
                             json.loads((REPO / "perfbench/limits/nnue_train_light.json")
                                        .read_text()), "nnue_train_light")
    cell = spec.load_cell(root, "nnue_other_train")
    assert cell.config["l1_size"] == tiny.NNUE["l1_size"]
    assert cell.config["recipe"]["steps_per_dispatch"] == \
        tiny.DEFAULT_RECIPE["steps_per_dispatch"]
    line = run.execute(cell, SEED, 0.2, False, CPU, _quiet)
    assert line["correct"], line["compared"]


def test_fused_mix_of_another_tier_is_refused(root, tmp_path):
    new = _add_cell(root, tmp_path, "fused_medium", "nnue_hard",
                    {"kind": "train", "tier": "medium", "fused": True,
                     "why": "test"}, "nnue_train_light")
    with pytest.raises(ValueError, match="light tier only"):
        run.execute(spec.load_cell(new, "fused_medium"), SEED, 0.2, False,
                    CPU, _quiet)


def test_new_per_layer_metric_is_found_with_no_edit(root, tmp_path):
    """A per-layer metric added as its reader's file and an entry alone is
    read in the cells it lists and in no other."""
    import shutil
    new = tmp_path / "checkout"
    shutil.copytree(root, new)
    (new / "perfbench/metrics/steps_in_window.py").write_text(
        "def read(ctx):\n    return float(ctx['window']['steps'])\n")
    bench = json.loads((new / "BENCHMARK.json").read_text())
    bench["per_layer"].append({
        "name": "steps_in_window", "unit": "steps", "better": "higher",
        "source": "host_clock", "layer": "test", "moves": "train_images_per_s",
        "workloads": ["nnue_train_light"]})
    (new / "BENCHMARK.json").write_text(json.dumps(bench))
    line = run.execute(spec.load_cell(new, "nnue_train_light"), SEED, 0.2,
                       True, CPU, _quiet)
    assert line["metrics"]["steps_in_window"]["value"] == line["attempted"] > 0
    assert line["metrics"]["steps_in_window"]["unit"] == "steps"
    line = run.execute(spec.load_cell(new, "etiny_train_heavy"), SEED, 0.2,
                       True, CPU, _quiet)
    assert "steps_in_window" not in line["metrics"]


def test_nnue_reference_follows_its_dtype():
    """The NNUE's reference computes in the configuration's dtype, as the
    program does, and its float8 control departs from it."""
    from perfbench import inputs
    from perfbench.families import nnue as fam
    from perfbench.reference import nnue
    cfg = dict(spec.load_cell(REPO, "nnue_train_light").config, l1_size=64,
               l2_size=16, l3_size=8)
    p = inputs.make_params(nnue.param_specs(cfg), 3, CPU)
    x = torch.randn((16, 32, 32, 3), generator=torch.Generator().manual_seed(3))
    bf16 = dict(cfg, dtype="bfloat16")
    model = fam.port_model(bf16, CPU)
    model.load_state_dict(p, strict=True)
    with torch.no_grad():
        prog = model(x)
        ref16 = nnue.forward(p, x, bf16)
        ref32 = nnue.forward(p, x, cfg)
        low = nnue.forward(p, x, bf16, low=True)
    assert ref16.dtype == torch.float32
    gap = float((prog - ref16).abs().max())
    assert gap < 0.1 * float((ref32 - ref16).abs().max())
    assert float((low - ref16).abs().max()) > 10 * max(gap, 1e-6)
    with pytest.raises(ValueError):
        nnue.forward(p, x, dict(cfg, dtype="float16"))


def test_control_holds_a_tf32_stand_in_to_a_reference_without_it(root, monkeypatch):
    """For a float32 cell the control's stand-in runs under TF32 and the
    reference it is compared with does not (on the CPU TF32 changes no
    number, so the switch itself is watched)."""
    from perfbench import readings
    from perfbench.kinds import train
    active, seen = [False], []

    class Watch:
        def __enter__(self):
            active[0] = True

        def __exit__(self, *exc):
            active[0] = False
    logits = train.Ref.logits

    def watched(self, leaves, x):
        seen.append((type(self).__name__, active[0]))
        return logits(self, leaves, x)
    monkeypatch.setattr(readings, "_TF32", Watch)
    monkeypatch.setattr(train.Ref, "logits", watched)
    monkeypatch.setattr(readings._LowRef, "logits", lambda self, leaves, x:
                        (seen.append(("_LowRef", active[0])),
                         logits(self, leaves, x))[1])
    cell = spec.load_cell(root, "nnue_train_light")
    s = train.build(cell, SEED, CPU)
    train.warm(s)
    train.release(s)
    readings.train_low(s)
    assert {a for n, a in seen if n == "_LowRef"} == {True}
    assert {a for n, a in seen if n == "Ref"} == {False}


def _reader(name):
    return spec.metric_reader(REPO, name)


def test_k1_count_by_hand():
    cfg = spec.load_cell(REPO, "nnue_serve_b8192").config
    nbytes, ops = _reader("k1_roofline").work(cfg, 8192)
    images = 8192 * 32 * 32 * 3 * 4
    assert images == 100_663_296  # 100.7 MB in
    weights = 8 * 27 + 800 * 1024 * 2 + 128 * 1024 + 32 * 128 + 10 * 32 \
        + 4 * (8 + 1024 + 128 + 32 + 10)
    assert nbytes == images + weights + 8192 * 10 * 4
    # conv 8x8 cells x 8 channels x 27, FT 800 x 1024, 1024x128, 128x32, 32x10
    assert ops == 2 * 8192 * (8 * 8 * 8 * 27 + 800 * 1024 + 1024 * 128
                              + 128 * 32 + 32 * 10)


def test_k3_count_by_hand():
    nbytes, ops = _reader("k3_roofline").work(512, 32)
    one_way = 512 * 32 * 32 * 3 * 4
    assert one_way == 6_291_456  # 6.3 MB in, 6.3 MB out
    assert nbytes == 2 * one_way + 512 * (4 + 8 + 16) and ops == 0


def test_k6_count_by_hand():
    cfg = spec.load_cell(REPO, "etiny_serve_b8192").config
    nbytes, ops = _reader("k6_roofline").work(cfg, 8192)
    stage_in = 8192 * 16 * 16 * 28       # the stem's int8 output
    stage_out = 8192 * 1 * 1 * 1120      # the final block's int8 output
    assert stage_in + stage_out < nbytes < stage_in + stage_out + 3_000_000
    # the final block at 1x1: expand 224 -> 1120, then one multiply-add a
    # value for its identity depthwise and its diagonal project
    from perfbench.reference import etinynet
    stem, stage, head = etinynet.engine_macs(cfg)
    assert stem == 16 * 16 * 28 * 27 and head == 1120 * 10
    assert stage > 224 * 1120 + 2 * 1120
    assert ops == 2 * 8192 * stage == 2 * 8192 * 3_194_464


def test_forward_counts_by_hand():
    from perfbench.reference import etinynet, nnue
    cfg = spec.load_cell(REPO, "nnue_train_light").config
    assert nnue.forward_macs(cfg) == 968_512
    e = spec.load_cell(REPO, "etiny_train_heavy").config
    # the stem at 16x16, then per block expand (input size), depthwise and
    # project (output size), the dense projections, the final conv, the head
    stem = 16 * 16 * 28 * 27
    assert etinynet.forward_macs(e) > stem
    assert etinynet.forward_macs(e) == 3_948_896


def test_imagenet_forward_count_by_hand():
    """EtinyNet-1.0 at 224 by the base reference's rule over its own table:
    the stem at 112; per stage the first block's expand at its input size,
    every depthwise, project and dense projection at the strided size; the
    final 1×1 conv at 7×7; the classifier."""
    from perfbench.reference import etinynet, etinynet_imagenet
    cfg = spec.load_cell(REPO, "etiny_imagenet_serve_b1024").config
    stem = 112 * 112 * 32 * 27
    lb1 = 112 * 112 * 32 * 32 + 56 * 56 * (32 * 9 + 32 * 32) \
        + 3 * 56 * 56 * (32 * 32 + 32 * 9 + 32 * 32)
    lb2 = 56 * 56 * 32 * 128 + 28 * 28 * (128 * 9 + 128 * 128) \
        + 3 * 28 * 28 * (128 * 128 + 128 * 9 + 128 * 128)
    dlb3 = 28 * 28 * 128 * 192 + 14 * 14 * (192 * 9 + 192 * 192) \
        + 2 * 14 * 14 * (192 * 192 + 192 * 9 + 192 * 192 + 384 * 192)
    dlb4 = 14 * 14 * 192 * 256 + 7 * 7 * (256 * 9 + 256 * 256) \
        + 7 * 7 * (256 * 256 + 256 * 9 + 256 * 256 + 512 * 256)
    final, head = 7 * 7 * 256 * 1280, 1280 * 1000
    total = stem + lb1 + lb2 + dlb3 + dlb4 + final + head
    assert etinynet_imagenet.forward_macs(cfg) == total == 284_711_680
    micro = dict(cfg, variant="micro", input_size=64, num_classes=10)
    assert etinynet_imagenet.forward_macs(micro) == etinynet.forward_macs(micro)


def test_peaks_and_bound():
    from perfbench import peaks
    t, kind = peaks.bound_s(3.35e12, 0.0, "int8")
    assert math.isclose(t, 1.0) and kind == "bytes"
    t, kind = peaks.bound_s(0.0, 67e12, "float32")
    assert math.isclose(t, 1.0) and kind == "operations"


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_result_line_keys(root, name, traced):
    line = run.execute(spec.load_cell(root, name), SEED, 0.2, traced, CPU, _quiet)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    keys += ["breakdown", "compared"] if traced else ["compared"]
    assert list(line) == keys
    assert line["correct"] is True and line["failed"] == 0
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    cell = spec.load_cell(root, name)
    if traced:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        # on the CPU no device metric is read
        assert set(line["metrics"]) <= {m["name"] for m in cell.per_layer}
        assert not any(k.startswith(("mfu", "k", "device_idle"))
                       for k in line["metrics"])
    else:
        assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    for name_, c in line["compared"].items():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]


# ---------------------------------------------------------------------------
# the faults a cell can have: the check must read each as not correct
# ---------------------------------------------------------------------------


def _unchanged(monkeypatch):
    """A step that returns its state unchanged: the optimizer's update
    never lands."""
    from nnue_vision_tpu_torch.training import optim
    monkeypatch.setattr(optim.Optimizer, "step", lambda self, *a, **k: None)


def _half_batch(monkeypatch):
    """Half of the batch left out, the mean taken over the rest."""
    step = importlib.import_module("nnue_vision_tpu_torch.training.step")
    orig = step.train_step

    def half(state, images, labels, **kw):
        n = images.shape[0] // 2
        return orig(state, images[:n], labels[:n], **kw)
    monkeypatch.setattr(step, "train_step", half)


def _altered(monkeypatch):
    """An answer altered where it is produced: one logit of every call."""
    from nnue_vision_tpu_torch.ops import etiny_kernels, nnue_kernels

    def bump(fn, first):
        def wrapped(*a, **k):
            out = fn(*a, **k)
            logits = out[0] if first else out
            logits[0, 0] += 1.0 / 64
            return out
        return wrapped
    monkeypatch.setattr(nnue_kernels, "nnue_engine_forward_mega",
                        bump(nnue_kernels.nnue_engine_forward_mega, True))
    monkeypatch.setattr(etiny_kernels, "etiny_forward_kernel",
                        bump(etiny_kernels.etiny_forward_kernel, False))


FAULTS = [(c, f) for c in TRAIN for f in (_unchanged, _half_batch)]
FAULTS += [(c, _altered) for c in SERVE]


@pytest.mark.parametrize("name,fault", FAULTS,
                         ids=[f"{c}-{f.__name__.strip('_')}" for c, f in FAULTS])
def test_fault_is_not_correct(root, monkeypatch, name, fault):
    fault(monkeypatch)
    line = run.execute(spec.load_cell(root, name), SEED, 0.2, False, CPU, _quiet)
    assert line["correct"] is False, line["compared"]
