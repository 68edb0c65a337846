"""The port's MCU/TinyML analysis (`nnue_vision_tpu_torch/benchmarks/`)
held to the repository's `benchmarks/` package on the JAX facade, with
identical params carried across by `bridge.py`: the small NNUE of
tests/test_benchmarks.py and EtinyNet-micro, each on the same 40-image
synthetic loader, on the CPU.

Counts, MACs, bytes and `ModelStats` are equal; sparsity, accuracy,
precision, recall and F1 agree within atol 1e-6 (the float forwards of the
two frameworks differ in the last bits, the metrics are counts); the
report's JSON matches key for key except the host-timed fields, and
`key_advantages`, where the port names the GPU in place of the TPU."""

import dataclasses
import json

import numpy as np
import pytest

import benchmarks as jbench
from nnue_vision_tpu.data.datasets import GenericVisionDataset as JDataset
from nnue_vision_tpu.data.loaders import ArrayLoader as JLoader
from nnue_vision_tpu.models import api as japi
from nnue_vision_tpu.models.nnue import GridFeatureSet as JGrid
from nnue_vision_tpu_torch import benchmarks as tbench
from nnue_vision_tpu_torch.data.datasets import GenericVisionDataset as TDataset
from nnue_vision_tpu_torch.data.loaders import ArrayLoader as TLoader
from nnue_vision_tpu_torch.models import api as tapi
from nnue_vision_tpu_torch.models.nnue import GridFeatureSet as TGrid

ATOL = 1e-6
FAMILIES = ["nnue", "etinynet"]
# measured on the host clock, so they differ from run to run
HOST_TIMED = {"incremental_speedup", "full_recompute_avg_ms",
              "incremental_avg_ms", "speedup"}


def _models(family):
    if family == "nnue":
        kw = dict(l1_size=64, l2_size=8, l3_size=16, num_classes=10, input_size=32)
        j = japi.NNUE(feature_set=JGrid(4, 8), **kw)
        t = tapi.NNUE(feature_set=TGrid(4, 8), params=j.params, device="cpu", **kw)
    else:
        kw = dict(variant="micro", num_classes=10, input_size=32)
        j = japi.EtinyNet(**kw)
        t = tapi.EtinyNet(params=j.params, batch_stats=j.batch_stats, device="cpu",
                          **kw)
    return j, t


@pytest.fixture(scope="module", params=FAMILIES)
def pair(request):
    """(family, JAX facade, port facade, JAX loader, port loader)."""
    kw = dict(dataset_name="cifar10", split="test", max_samples=40,
              synthetic_size=64)
    jds, tds = JDataset(**kw), TDataset(**kw)
    np.testing.assert_array_equal(jds.images, tds.images)
    np.testing.assert_array_equal(jds.labels, tds.labels)
    j, t = _models(request.param)
    return request.param, j, t, JLoader(jds, batch_size=8), TLoader(tds, batch_size=8)


def assert_close(ours, theirs, path="", skip=()):
    """Equal structure; floats within ATOL, everything else equal."""
    if isinstance(theirs, dict):
        assert set(ours) == set(theirs), (path, set(ours) ^ set(theirs))
        for k in theirs:
            if k not in skip:
                assert_close(ours[k], theirs[k], f"{path}.{k}", skip)
    elif isinstance(theirs, (list, tuple)):
        assert len(ours) == len(theirs), path
        for i, (a, b) in enumerate(zip(ours, theirs)):
            assert_close(a, b, f"{path}[{i}]", skip)
    elif isinstance(theirs, float) and not isinstance(theirs, bool):
        assert abs(ours - theirs) <= ATOL, (path, ours, theirs)
    else:
        assert ours == theirs, (path, ours, theirs)


def test_registries_match():
    assert {k: dataclasses.asdict(v) for k, v in tbench.MCU_SPECS.items()} == \
        {k: dataclasses.asdict(v) for k, v in jbench.MCU_SPECS.items()}
    assert {k: [dataclasses.asdict(b) for b in v]
            for k, v in tbench.TINYML_BASELINES.items()} == \
        {k: [dataclasses.asdict(b) for b in v]
         for k, v in jbench.TINYML_BASELINES.items()}
    public = {n for n in dir(jbench) if not n.startswith("_")}
    assert public - {"mcu_simulation", "tinyml_benchmarks"} <= set(dir(tbench))


def test_counts_macs_bytes_and_stats_equal(pair):
    _, j, t, _, _ = pair
    assert tbench.count_model_parameters(t) == jbench.count_model_parameters(j)
    assert tbench.count_model_parameters(t)[0] == j.count_parameters()
    assert tbench.count_mac_operations(t) == jbench.count_mac_operations(j)
    assert tbench.estimate_memory_usage(t) == jbench.estimate_memory_usage(j)
    assert tbench.estimate_quantized_model_size(t) == \
        jbench.estimate_quantized_model_size(j)
    for target in (0.0, 0.5, 0.9):
        assert dataclasses.asdict(tbench.generate_model_stats(t, None, target)) \
            == dataclasses.asdict(jbench.generate_model_stats(j, None, target))


def test_sparsity_and_measured_stats(pair):
    family, j, t, jl, tl = pair
    if family != "nnue":
        for bench, model, loader in ((tbench, t, tl), (jbench, j, jl)):
            with pytest.raises(ValueError, match="NNUE"):
                bench.analyze_sparsity(model, loader)
        return
    for n in (100, 12):
        assert_close(tbench.analyze_sparsity(t, tl, num_samples=n),
                     jbench.analyze_sparsity(j, jl, num_samples=n))
    ours = dataclasses.asdict(tbench.generate_model_stats(t, tl))
    theirs = dataclasses.asdict(jbench.generate_model_stats(j, jl))
    assert_close(ours, theirs, skip=("effective_macs",))
    # one rounding of the sparsity at atol 1e-6 moves int(total·(1-s)) ≤ 1
    assert abs(ours["effective_macs"] - theirs["effective_macs"]) <= 1


def test_accuracy_metrics_agree(pair):
    _, j, t, jl, tl = pair
    for n in (None, 20, 13, 0):
        assert_close(tbench.evaluate_model_accuracy(t, tl, num_samples=n),
                     jbench.evaluate_model_accuracy(j, jl, num_samples=n))


def test_mcu_benchmark_and_latency_energy(pair):
    _, j, t, jl, tl = pair
    ours = tbench.run_mcu_benchmark(t, tl, target_sparsity=0.5, verbose=False)
    theirs = jbench.run_mcu_benchmark(j, jl, target_sparsity=0.5, verbose=False)
    assert dataclasses.asdict(ours["model_stats"]) == \
        dataclasses.asdict(theirs["model_stats"])
    assert ours["mcu_results"] == theirs["mcu_results"]
    stats = ours["model_stats"]
    for key, spec in tbench.MCU_SPECS.items():
        jspec = jbench.MCU_SPECS[key]
        assert tbench.simulate_mcu_latency(stats, spec, use_sparsity=False) == \
            jbench.simulate_mcu_latency(stats, jspec, use_sparsity=False)
        assert tbench.estimate_energy_consumption(1.5, spec) == \
            jbench.estimate_energy_consumption(1.5, jspec)


def test_mlperf_result_and_incremental_updates(pair):
    family, j, t, jl, tl = pair
    spec = tbench.MCU_SPECS["cortex_m7"]
    ours = tbench.run_mlperf_tiny_benchmark(t, "cifar10", tl, mcu_spec=spec)
    theirs = jbench.run_mlperf_tiny_benchmark(j, "cifar10", jl,
                                              mcu_spec=jbench.MCU_SPECS["cortex_m7"])
    assert_close(ours.to_dict(), theirs.to_dict(), skip=HOST_TIMED)
    assert_close(tbench.compare_with_baselines(ours, "cifar10"),
                 jbench.compare_with_baselines(theirs, "cifar10"))
    if family != "nnue":
        with pytest.raises(ValueError, match="NNUE"):
            tbench.benchmark_incremental_updates(t, tl)
        return
    inc = tbench.benchmark_incremental_updates(t, tl, num_sequences=3,
                                               sequence_length=4)
    jinc = jbench.benchmark_incremental_updates(j, jl, num_sequences=3,
                                                sequence_length=4)
    assert_close(inc, jinc, skip=HOST_TIMED)
    assert inc["sequences_tested"] == 3
    assert 0.0 < inc["incremental_avg_ms"] <= inc["full_recompute_avg_ms"]


def test_tinyml_report_json_matches(pair, tmp_path):
    family, j, t, jl, tl = pair
    specs = [tbench.MCU_SPECS["cortex_m4"], tbench.MCU_SPECS["cortex_m33"]]
    jspecs = [jbench.MCU_SPECS["cortex_m4"], jbench.MCU_SPECS["cortex_m33"]]
    ours = tbench.generate_tinyml_report(t, "cifar10", tl, mcu_specs=specs,
                                         output_path=tmp_path / "t" / "r.json")
    theirs = jbench.generate_tinyml_report(j, "cifar10", jl, mcu_specs=jspecs,
                                           output_path=tmp_path / "j" / "r.json")
    on_disk = json.loads((tmp_path / "t" / "r.json").read_text())
    assert on_disk == json.loads(json.dumps(ours, default=str))
    their_disk = json.loads((tmp_path / "j" / "r.json").read_text())
    advantages = [a.replace("TPU", "GPU")
                  for a in their_disk["summary"]["key_advantages"]]
    assert on_disk["summary"]["key_advantages"] == advantages
    assert_close(on_disk, their_disk, skip=HOST_TIMED | {"key_advantages"})
    assert on_disk["model_info"]["name"] == (
        "NNUE-Vision" if family == "nnue" else "EtinyNet")
    assert_close(tbench.create_pareto_plot_data(ours["mlperf_results"]),
                 jbench.create_pareto_plot_data(theirs["mlperf_results"]),
                 skip=HOST_TIMED)
