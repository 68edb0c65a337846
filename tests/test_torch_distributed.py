"""The port's process-group layer (`nnue_vision_tpu_torch/parallel/
distributed.py`) and the train CLI's data-parallel flags, on the CPU with
gloo: initialization as a no-op without configuration, torchrun's
variables, idempotence, the JAX package's local-slice split, a two-process
CLI run equal to one process, and no fallback: a rank that raises, a group
that never forms, and workers that outlast their limit all end every
process and raise.

Spawned workers join with a limit of 60 s and meet at a file:// rendezvous
under the test's tmp dir; they import no jax.
"""

import datetime
import json
import os
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from nnue_vision_tpu_torch import train as tcli
from nnue_vision_tpu_torch.parallel import distributed as tdist
from nnue_vision_tpu_torch.parallel import mesh as tmesh

REPO = Path(__file__).resolve().parent.parent
TEST_CONFIG = str(REPO / "config" / "train_nnue_test.py")
JOIN_S = 60.0
TORCHRUN_VARS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")


@pytest.fixture
def no_torchrun(monkeypatch):
    for var in TORCHRUN_VARS:
        monkeypatch.delenv(var, raising=False)


@pytest.fixture
def recorded_init(monkeypatch):
    """dist.init_process_group replaced by a recorder (no group forms)."""
    calls = []
    monkeypatch.setattr(tdist.dist, "init_process_group",
                        lambda **kw: calls.append(kw))
    return calls


def test_initialize_noop_without_config(no_torchrun):
    assert tdist.initialize_distributed() is False
    assert not dist.is_initialized()
    assert tdist.rank_and_world() == (0, 1)


def test_initialize_reads_torchrun_variables(monkeypatch, recorded_init):
    for var, value in zip(TORCHRUN_VARS, ("10.1.2.3", "29500", "4", "2", "1")):
        monkeypatch.setenv(var, value)
    assert tdist.initialize_distributed() is True
    (kw,) = recorded_init
    assert kw["init_method"] == "tcp://10.1.2.3:29500"
    assert (kw["world_size"], kw["rank"]) == (4, 2)
    assert kw["backend"] == ("nccl" if torch.cuda.is_available() else "gloo")
    assert kw["timeout"] == datetime.timedelta(seconds=tdist.DEFAULT_TIMEOUT_S)


def test_initialize_explicit_arguments(no_torchrun, recorded_init, tmp_path):
    """Arguments win over nothing; a URL passes as it is; the backend is the
    caller's when named; a group without a rank is refused."""
    tdist.initialize_distributed("127.0.0.1:29511", 2, 1, backend="gloo",
                                 timeout_s=7)
    tdist.initialize_distributed(f"file://{tmp_path}/rdv", 2, 0, backend="gloo")
    assert [c["init_method"] for c in recorded_init] == [
        "tcp://127.0.0.1:29511", f"file://{tmp_path}/rdv"]
    assert recorded_init[0]["timeout"] == datetime.timedelta(seconds=7)
    assert all(c["backend"] == "gloo" for c in recorded_init)
    with pytest.raises(ValueError, match="process"):
        tdist.initialize_distributed("127.0.0.1:29511", 2)


def test_initialize_is_idempotent(no_torchrun, tmp_path):
    """A real one-rank gloo group: a second call keeps it and returns True."""
    rdv = f"file://{tmp_path}/rdv"
    try:
        assert tdist.initialize_distributed(rdv, 1, 0, backend="gloo") is True
        assert tdist.initialize_distributed(rdv, 1, 0, backend="gloo") is True
        assert tdist.rank_and_world() == (0, 1)
        mesh = tdist.make_global_mesh()
        assert mesh.size == 1 and mesh.group is None
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("world", [1, 3, 4])
def test_process_local_slice_matches_jax_split(monkeypatch, world):
    """The JAX package's split: equal shares, the last rank takes the rest."""
    n = 10
    per = n // world
    got = []
    for rank in range(world):
        monkeypatch.setattr(tdist, "rank_and_world", lambda r=rank: (r, world))
        got.append(tdist.process_local_slice(n))
    want = [(r * per, n if r == world - 1 else (r + 1) * per) for r in range(world)]
    assert got == want
    assert got[-1][1] == n and all(a[1] == b[0] for a, b in zip(got, got[1:]))


def test_host_batch_to_global_is_the_local_shard(rng):
    mesh = tmesh.make_mesh()
    x = rng.random((16, 4), dtype=np.float32)
    images, labels = tdist.host_batch_to_global(mesh, (x, np.arange(16)))
    assert isinstance(images, torch.Tensor) and images.device.type == "cpu"
    np.testing.assert_array_equal(images.numpy(), x)
    np.testing.assert_array_equal(labels.numpy(), np.arange(16))


def test_cli_starts_one_worker_per_card(monkeypatch, no_torchrun):
    """A plain run on a host with several cards starts one worker each;
    max_devices=1, a given group, torchrun, --device cpu and one card
    do not."""
    parse = tcli.setup_argument_parser().parse_args
    monkeypatch.setattr(tcli.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(tcli.torch.cuda, "device_count", lambda: 4)
    cfg = types.SimpleNamespace(max_devices=0)
    assert tcli._one_worker_per_card(parse(["nnue"]), cfg) == 4
    assert tcli._one_worker_per_card(
        parse(["nnue"]), types.SimpleNamespace(max_devices=1)) == 0
    assert tcli._one_worker_per_card(parse(["nnue", "--device", "cpu"]), cfg) == 0
    assert tcli._one_worker_per_card(
        parse(["nnue", "--coordinator", "h:1", "--num-hosts", "4"]), cfg) == 0
    monkeypatch.setenv("WORLD_SIZE", "4")
    assert tcli._one_worker_per_card(parse(["nnue"]), cfg) == 0
    monkeypatch.delenv("WORLD_SIZE")
    monkeypatch.setattr(tcli.torch.cuda, "device_count", lambda: 1)
    assert tcli._one_worker_per_card(parse(["nnue"]), cfg) == 0


def _losses(log_dir: Path):
    (metrics,) = list((log_dir / "runs").rglob("metrics.jsonl"))
    records = [json.loads(line) for line in metrics.read_text().splitlines()]
    return [r["train/loss"] for r in records if "train/loss" in r]


def test_two_process_cli_matches_one_process(tmp_path):
    """Two CLI processes on config/train_nnue_test.py (batch 4, two images
    per rank) log the one-process losses; only rank 0 writes."""
    env = {k: v for k, v in os.environ.items()
           if k not in TORCHRUN_VARS and k != "PYTHONPATH"}
    env.update(NV_SKIP_ENGINE="1", OMP_NUM_THREADS="1")
    base = [sys.executable, "-m", "nnue_vision_tpu_torch.train", "nnue",
            "--config", TEST_CONFIG, "--device", "cpu"]
    group = ["--coordinator", f"file://{tmp_path}/rdv", "--num-hosts", "2"]
    procs = [subprocess.Popen(
        base + group + ["--process-id", str(r), "--log_dir", str(tmp_path / "dp")],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    one = subprocess.run(base + ["--log_dir", str(tmp_path / "one")], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=JOIN_S)[0])
        finally:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], outs
    assert one.returncode == 0, one.stderr
    assert "Data-parallel over 2 of 2 ranks" in outs[0]
    assert "Epoch 1/1" not in outs[1]  # rank 1 logs nothing
    assert len(list((tmp_path / "dp" / "runs").iterdir())) == 1
    got, want = _losses(tmp_path / "dp"), _losses(tmp_path / "one")
    assert len(got) == len(want) == 8
    np.testing.assert_allclose(got, want, rtol=1e-6)


def _raising_worker(rank, tmp):
    torch.set_num_threads(1)
    tdist.initialize_distributed(f"file://{tmp}/rdv", 2, rank, backend="gloo",
                                 timeout_s=JOIN_S)
    if rank == 1:
        raise RuntimeError("rank 1 failed mid-step")
    dist.all_reduce(torch.ones(4))  # waits for rank 1, which never comes


def _lonely_worker(rank, tmp):
    tdist.initialize_distributed(f"file://{tmp}/rdv", 2, rank, backend="gloo",
                                 timeout_s=3)


def _sleeping_worker(rank):
    time.sleep(60)


@pytest.mark.parametrize("case", ["rank-raises", "group-never-forms", "time-limit"])
def test_no_fallback(tmp_path, case):
    """A failure on any rank ends every worker and raises in the caller:
    a rank that raises while its peer waits in a collective, a group whose
    second rank never joins (its 3 s timeout), and workers that outlast
    the join limit."""
    t0 = time.monotonic()
    if case == "rank-raises":
        with pytest.raises(Exception, match="rank 1 failed mid-step"):
            tdist.spawn(_raising_worker, 2, (str(tmp_path),), timeout_s=JOIN_S)
    elif case == "group-never-forms":
        with pytest.raises(Exception, match="(?i)timeout|timed out"):
            tdist.spawn(_lonely_worker, 1, (str(tmp_path),), timeout_s=JOIN_S)
    else:
        with pytest.raises(TimeoutError):
            tdist.spawn(_sleeping_worker, 2, (), timeout_s=3)
    assert time.monotonic() - t0 < 45
