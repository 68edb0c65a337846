"""The port's run utilities (`nnue_vision_tpu_torch/training/utils.py`:
`get_git_info`, `generate_run_name`, `check_disk_space`,
`emergency_cleanup`, `disk_space_guard`, `enable_nan_debugging`) held to
the JAX package's on a temporary git repository and temporary checkpoint
folders."""

import os
import subprocess
import time

import pytest
import torch

from nnue_vision_tpu.training import utils as jutils
from nnue_vision_tpu_torch.training import logging as tlogging
from nnue_vision_tpu_torch.training import utils as tutils


def _git(repo, *args):
    subprocess.run(["git", "-C", str(repo), *args], check=True, capture_output=True,
                   env={**os.environ, "GIT_AUTHOR_NAME": "t", "GIT_AUTHOR_EMAIL": "t@t",
                        "GIT_COMMITTER_NAME": "t", "GIT_COMMITTER_EMAIL": "t@t"})


@pytest.fixture
def repo(tmp_path, monkeypatch):
    """A git repository with one commit, a branch and a remote, as cwd."""
    r = tmp_path / "repo"
    r.mkdir()
    _git(r, "init", "-q", "-b", "trunk")
    (r / "a.txt").write_text("a")
    _git(r, "add", "a.txt")
    _git(r, "commit", "-q", "-m", "one")
    _git(r, "remote", "add", "origin", "https://example.com/r.git")
    monkeypatch.chdir(r)
    return r


def test_git_info_equals_jax(repo):
    info = tutils.get_git_info()
    assert info == jutils.get_git_info()
    assert info["branch"] == "trunk" and info["dirty"] == "false"
    assert info["remote"] == "https://example.com/r.git"
    assert len(info["commit"]) == 40 and info["commit"].startswith(info["commit_short"])
    (repo / "b.txt").write_text("b")
    assert tutils.get_git_info() == jutils.get_git_info()
    assert tutils.get_git_info()["dirty"] == "true"


def test_git_info_outside_a_repository_equals_jax(tmp_path, monkeypatch):
    (tmp_path / "plain").mkdir()
    monkeypatch.chdir(tmp_path / "plain")
    monkeypatch.setenv("GIT_CEILING_DIRECTORIES", str(tmp_path))
    info = tutils.get_git_info()
    assert info == jutils.get_git_info()
    assert info["commit"] == "" and info["dirty"] == "false"


@pytest.mark.parametrize("args", [("nnue", "cfg", "my note"), ("etinynet", "", ""),
                                  ("nnue", "hard", "x" * 40)],
                         ids=["note", "bare", "long-note"])
def test_generate_run_name_equals_jax(repo, monkeypatch, args):
    monkeypatch.setattr(time, "strftime", lambda fmt, *a: "0102_030405")
    name = tutils.generate_run_name(*args)
    assert name == jutils.generate_run_name(*args)
    commit = tutils.get_git_info()["commit_short"]
    assert name.startswith("-".join(p for p in (args[0], args[1], commit) if p))
    assert " " not in name
    # not the loop's default rule, which stays as it is
    assert not name.startswith("run_")
    assert tlogging.default_run_name() == "run_0102_030405"


def test_check_disk_space_equals_jax(tmp_path):
    for need in (0.0, 1e12):
        got = tutils.check_disk_space(str(tmp_path), min_free_gb=need)
        want = jutils.check_disk_space(str(tmp_path), min_free_gb=need)
        assert set(got) == set(want) == {"free_gb", "total_gb", "critical"}
        assert got["critical"] == want["critical"] == (need > 0)
        assert got["total_gb"] == want["total_gb"] > 0


def _checkpoint_tree(root, names=("r1", "r2", "r3", "r4")):
    """`root/checkpoints/<run>/best_model.ckpt`, oldest first, and a stray
    file among the runs."""
    ck = root / "checkpoints"
    ck.mkdir(parents=True)
    for i, name in enumerate(names):
        (ck / name).mkdir()
        (ck / name / "best_model.ckpt").write_bytes(b"x")
        os.utime(ck / name, (1_000_000 + i * 10, 1_000_000 + i * 10))
    (ck / "notes.txt").write_text("n")
    os.utime(ck / "notes.txt", (999_000, 999_000))
    return ck


@pytest.mark.parametrize("keep_latest", [2, 1, 0])
def test_emergency_cleanup_equals_jax(tmp_path, keep_latest):
    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    _checkpoint_tree(ours)
    _checkpoint_tree(theirs)
    got = tutils.emergency_cleanup(str(ours), keep_latest=keep_latest)
    want = jutils.emergency_cleanup(str(theirs), keep_latest=keep_latest)
    assert [p.name for p in got] == [p.name for p in want]
    assert sorted(p.name for p in (ours / "checkpoints").iterdir()) == \
        sorted(p.name for p in (theirs / "checkpoints").iterdir())
    kept = {p.name for p in (ours / "checkpoints").iterdir() if p.is_dir()}
    assert kept == ({"r3", "r4"} if keep_latest == 2 else
                    {"r4"} if keep_latest == 1 else set())


def test_emergency_cleanup_without_checkpoints_equals_jax(tmp_path):
    assert tutils.emergency_cleanup(str(tmp_path)) == \
        jutils.emergency_cleanup(str(tmp_path)) == []


def test_disk_space_guard_equals_jax(tmp_path):
    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    _checkpoint_tree(ours)
    _checkpoint_tree(theirs)
    # space is fine: nothing removed
    assert tutils.disk_space_guard(str(ours), min_free_gb=0.0) is True
    assert jutils.disk_space_guard(str(theirs), min_free_gb=0.0) is True
    assert len(list((ours / "checkpoints").iterdir())) == 5
    # critical: the old runs go, and space is still short
    assert tutils.disk_space_guard(str(ours), min_free_gb=1e12) is False
    assert jutils.disk_space_guard(str(theirs), min_free_gb=1e12) is False
    assert sorted(p.name for p in (ours / "checkpoints").iterdir()) == \
        sorted(p.name for p in (theirs / "checkpoints").iterdir()) == \
        ["notes.txt", "r3", "r4"]


def test_enable_nan_debugging_turns_on_anomaly_detection():
    """The port's counterpart of `jax_debug_nans`: autograd's anomaly mode,
    which raises where a backward op produces NaN."""
    was = torch.is_anomaly_enabled()
    try:
        tutils.enable_nan_debugging()
        assert torch.is_anomaly_enabled()
        x = torch.tensor([-1.0], requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x).sum().backward()
    finally:
        torch.autograd.set_detect_anomaly(was)
