"""The port's cloud launcher (`nnue_vision_tpu_torch/cloud/launcher.py`):
the twelve cases of `tests/test_cloud.py` for a GPU VM with one H100 (the
dry-run backend, git gating, the bootstrap script, gcloud argv goldens),
fully offline; and the training loop's `stop_cloud`, called when a run
ends unless `keep_alive`, never raising."""

import subprocess

import pytest

from nnue_vision_tpu_torch.cloud import launcher
from nnue_vision_tpu_torch.cloud.launcher import (
    CloudError,
    LaunchSpec,
    check_git_status,
    gcloud_create_argv,
    gcloud_delete_argv,
    make_bootstrap_script,
    start_cloud_training,
    stop_instance,
)
from nnue_vision_tpu_torch.training import loop as tloop


class FakeRun:
    name = "fake-run-1"


class Res:
    returncode = 0
    stdout = ""
    stderr = ""


def test_check_git_status_clean_repo():
    # this repo is a git repo; the call must return a commit hash or raise
    # CloudError about dirtiness — both acceptable, never other errors.
    try:
        commit = check_git_status()
        assert len(commit) == 40
    except CloudError as e:
        assert "dirty" in str(e)


def test_dirty_tree_rejected(tmp_path, monkeypatch):
    subprocess.run(["git", "init", "-q", str(tmp_path)], check=True)
    (tmp_path / "f.txt").write_text("x")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(CloudError, match="dirty|repository"):
        check_git_status()


def test_bootstrap_script_contents():
    script = make_bootstrap_script(
        "https://example.com/repo.git", "abc123", "nnue", "run-42",
        config="config/train_nnue.py", extra_args="--batch_size 64",
    )
    assert "git clone" in script
    assert "git checkout abc123" in script
    assert "python -m nnue_vision_tpu_torch.train nnue" in script
    assert "--config config/train_nnue.py" in script
    assert "--wandb-run-id=run-42" in script
    assert "--batch_size 64" in script
    # the loop builds the engine itself (training/engine_build.py)
    assert "ninja" not in script and "train.py" not in script


def test_bootstrap_script_quotes_safely():
    script = make_bootstrap_script(
        "https://example.com/r.git", "abc", "nnue", "run; rm -rf /",
    )
    assert "'run; rm -rf /'" in script  # shell-quoted, not interpolated


def test_start_cloud_training_dryrun(monkeypatch, capsys):
    monkeypatch.setattr(launcher, "check_git_status", lambda: "deadbeef")
    spec = LaunchSpec(model_type="nnue", config="config/train_nnue.py",
                      repo_url="https://example.com/repo.git")
    info = start_cloud_training(spec, backend="dryrun", run=FakeRun())
    assert info["state"] == "dryrun"
    assert info["commit"] == "deadbeef"
    assert info["run"] == "fake-run-1"
    out = capsys.readouterr().out
    assert "would create GPU VM" in out and "a3-highgpu-1g" in out


def test_unknown_backend_rejected(monkeypatch):
    monkeypatch.setattr(launcher, "check_git_status", lambda: "deadbeef")
    spec = LaunchSpec(model_type="nnue")
    with pytest.raises(CloudError, match="unknown backend"):
        start_cloud_training(spec, backend="aws", run=FakeRun())


def test_stop_instance_noop_without_env(monkeypatch):
    monkeypatch.delenv("NV_INSTANCE_NAME", raising=False)
    monkeypatch.setattr(launcher.subprocess, "run", lambda *a, **k: pytest.fail(
        "stop_instance ran a command off the cloud"))
    stop_instance("test")  # must be a silent no-op locally


# ---------------------------------------------------------------------------
# gcloud argv goldens: the real provider cannot be exercised offline, so the
# exact CLI shape is pinned (`gcloud compute instances create/delete`).
# ---------------------------------------------------------------------------

def test_gcloud_create_argv_golden():
    spec = LaunchSpec(model_type="nnue", machine_type="a3-highgpu-1g",
                      zone="us-east5-b", name="nv-train-golden")
    assert gcloud_create_argv(spec, "#!/bin/bash\necho hi") == [
        "gcloud", "compute", "instances", "create", "nv-train-golden",
        "--zone=us-east5-b",
        "--machine-type=a3-highgpu-1g",
        "--maintenance-policy=TERMINATE",
        "--image-family=pytorch-latest-gpu",
        "--image-project=deeplearning-platform-release",
        "--metadata=startup-script=#!/bin/bash\necho hi",
    ]


def test_gcloud_delete_argv_golden():
    assert gcloud_delete_argv("nv-train-golden", "us-east5-b") == [
        "gcloud", "compute", "instances", "delete", "nv-train-golden",
        "--zone=us-east5-b", "--quiet",
    ]


def test_gcloud_backend_invokes_pinned_argv(monkeypatch):
    """End-to-end through start_cloud_training with the gcloud backend,
    subprocess mocked: the argv handed to subprocess.run must be exactly
    the golden construction, with the bootstrap script inline in the
    startup-script metadata."""
    calls = []
    monkeypatch.setattr(launcher, "check_git_status", lambda: "deadbeef")
    monkeypatch.setattr(launcher.subprocess, "run",
                        lambda cmd, **k: calls.append(cmd) or Res())
    spec = LaunchSpec(model_type="etinynet", name="nv-x", zone="z",
                      machine_type="a3-highgpu-1g",
                      repo_url="https://example.com/r.git")
    info = start_cloud_training(spec, backend="gcloud", run=FakeRun())
    assert info == {"instance": "nv-x", "state": "creating",
                    "run": "fake-run-1", "commit": "deadbeef"}
    (cmd,) = calls
    script = make_bootstrap_script(
        "https://example.com/r.git", "deadbeef", "etinynet", "fake-run-1"
    )
    assert cmd == gcloud_create_argv(spec, script)
    assert cmd[:5] == ["gcloud", "compute", "instances", "create", "nv-x"]


def test_gcloud_backend_create_failure_raises(monkeypatch):
    class Failed(Res):
        returncode = 1
        stderr = "quota exceeded"

    monkeypatch.setattr(launcher, "check_git_status", lambda: "deadbeef")
    monkeypatch.setattr(launcher.subprocess, "run", lambda *a, **k: Failed())
    spec = LaunchSpec(model_type="nnue", repo_url="u")
    with pytest.raises(CloudError, match="quota exceeded"):
        start_cloud_training(spec, backend="gcloud", run=FakeRun())


def test_stop_instance_uses_pinned_delete_argv(monkeypatch):
    calls = []
    monkeypatch.setattr(launcher.subprocess, "run",
                        lambda cmd, **k: calls.append(cmd) or Res())
    monkeypatch.setenv("NV_INSTANCE_NAME", "nv-train-golden")
    monkeypatch.setenv("NV_ZONE", "us-east5-b")
    stop_instance("done")
    assert calls == [gcloud_delete_argv("nv-train-golden", "us-east5-b")]


def test_start_cloud_training_pre_creates_the_run(monkeypatch, tmp_path, capsys):
    """Without a run, the launcher creates the port's local run first and
    hands its name to the instance."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(launcher, "check_git_status", lambda: "deadbeef")
    info = start_cloud_training(LaunchSpec(model_type="nnue", name="nv-y",
                                           repo_url="u"), backend="dryrun")
    run_dir = tmp_path / "logs" / "runs" / info["run"]
    assert (run_dir / "config.json").is_file()
    assert f"--wandb-run-id={info['run']}" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the training loop's stop_cloud
# ---------------------------------------------------------------------------


def _tiny_config(tmp_path, **kw):
    from config import load_config

    cfg = load_config("config/train_nnue_test.py")
    cfg.log_dir = str(tmp_path / "logs")
    cfg.max_epochs = 1
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


@pytest.mark.parametrize("keep_alive", [False, True])
def test_train_model_stops_the_instance_unless_keep_alive(tmp_path, monkeypatch,
                                                         keep_alive):
    monkeypatch.setenv("NV_SKIP_ENGINE", "1")
    calls = []
    monkeypatch.setattr(launcher, "stop_instance",
                        lambda reason="": calls.append(reason))
    cfg = _tiny_config(tmp_path, keep_alive=keep_alive)
    assert tloop.train_model(cfg, "nnue", device="cpu") == 0
    assert calls == ([] if keep_alive else ["training finished"])


def test_stop_cloud_never_raises(monkeypatch, capsys):
    def broken(reason=""):
        raise RuntimeError("metadata server unreachable")

    monkeypatch.setattr(launcher, "stop_instance", broken)
    tloop.stop_cloud("training finished")  # logs and swallows
    assert "cloud stop failed (ignored): metadata server unreachable" in \
        capsys.readouterr().out


def test_stop_instance_failure_does_not_mask_the_run(tmp_path, monkeypatch):
    """A failing delete at the end of a run: train_model still returns 0."""
    monkeypatch.setenv("NV_SKIP_ENGINE", "1")
    monkeypatch.setenv("NV_INSTANCE_NAME", "nv-z")

    def no_gcloud(*a, **k):
        raise FileNotFoundError("gcloud")

    monkeypatch.setattr(launcher.subprocess, "run", no_gcloud)
    assert tloop.train_model(_tiny_config(tmp_path), "nnue", device="cpu") == 0
