"""Cloud training launcher: a GPU VM with one H100, the upstream RunPod
service's workflow (port of `nnue_vision_tpu/cloud/launcher.py`).

Workflow parity with nnue_runpod_service.py:112-240 upstream:
  1. refuse to launch from a dirty git tree (:47-66),
  2. pre-create the experiment-tracker run locally so the instance resumes
     it by id (:152-167),
  3. compose a bootstrap script that clones the repo at the current commit
     and runs `python -m nnue_vision_tpu_torch.train <model_type>
     --wandb-run-id=<id>` (:100-110); the training loop builds the C++
     engine itself (`training/engine_build.py`),
  4. create the instance through a provider backend,
  5. `stop_instance` for end-of-training auto-shutdown (:209-240).

Provider backends are pluggable callables; the default `gcloud` backend
shells out to the gcloud CLI (a Compute Engine VM of machine type
`a3-highgpu-1g`, one H100, on a Deep Learning VM image with PyTorch for
CUDA), and a `dryrun` backend prints what it would create and run. No
provider SDK is imported.
"""

from __future__ import annotations

import os
import shlex
import subprocess
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

from nnue_vision_tpu_torch.training.logging import init_run

DEFAULT_MACHINE_TYPE = "a3-highgpu-1g"  # one H100 80GB
DEFAULT_IMAGE_FAMILY = "pytorch-latest-gpu"
DEFAULT_IMAGE_PROJECT = "deeplearning-platform-release"
DEFAULT_ZONE = "us-central1-a"


class CloudError(RuntimeError):
    pass


def check_git_status() -> str:
    """Refuse to launch with uncommitted changes; returns current commit."""
    dirty = subprocess.run(
        ["git", "status", "--porcelain"], capture_output=True, text=True
    )
    if dirty.returncode != 0:
        raise CloudError("not a git repository")
    if dirty.stdout.strip():
        raise CloudError(
            "git tree is dirty — commit or stash before launching cloud "
            f"training:\n{dirty.stdout}"
        )
    rev = subprocess.run(
        ["git", "rev-parse", "HEAD"], capture_output=True, text=True
    )
    return rev.stdout.strip()


def make_bootstrap_script(
    repo_url: str, commit: str, model_type: str, run_id: str,
    config: Optional[str] = None, extra_args: str = "",
) -> str:
    """The instance-side bootstrap (upstream container_setup.sh workflow)."""
    config_arg = f"--config {shlex.quote(config)}" if config else ""
    return "\n".join(
        [
            "#!/usr/bin/env bash",
            "set -euo pipefail",
            "mkdir -p /workspace && cd /workspace",
            f"git clone {shlex.quote(repo_url)} repo || (cd repo && git fetch)",
            "cd repo",
            f"git checkout {shlex.quote(commit)}",
            f"python -m nnue_vision_tpu_torch.train {shlex.quote(model_type)} "
            f"{config_arg} --wandb-run-id={shlex.quote(run_id)} "
            f"{extra_args}".strip(),
        ]
    )


@dataclass
class LaunchSpec:
    model_type: str
    config: Optional[str] = None
    machine_type: str = DEFAULT_MACHINE_TYPE
    zone: str = os.environ.get("NV_ZONE", DEFAULT_ZONE)
    name: str = field(default_factory=lambda: f"nv-train-{int(time.time())}")
    repo_url: str = ""
    extra_args: str = ""
    keep_alive: bool = False


def _backend_dryrun(spec: LaunchSpec, script: str) -> Dict[str, str]:
    print(f"[dryrun] would create GPU VM {spec.name} ({spec.machine_type}, "
          f"{spec.zone}) and run:\n{script}")
    return {"instance": spec.name, "state": "dryrun"}


def gcloud_create_argv(spec: LaunchSpec, script: str) -> list[str]:
    """The exact `gcloud compute instances create` argv.

    Pure so tests can pin it against a golden (the drift detector for the
    Compute Engine CLI shape:
    https://cloud.google.com/sdk/gcloud/reference/compute/instances/create).
    A GPU VM cannot live-migrate, hence `--maintenance-policy=TERMINATE`.
    """
    return [
        "gcloud", "compute", "instances", "create", spec.name,
        f"--zone={spec.zone}", f"--machine-type={spec.machine_type}",
        "--maintenance-policy=TERMINATE",
        f"--image-family={DEFAULT_IMAGE_FAMILY}",
        f"--image-project={DEFAULT_IMAGE_PROJECT}",
        f"--metadata=startup-script={script}",
    ]


def gcloud_delete_argv(name: str, zone: str) -> list[str]:
    """The exact `gcloud compute instances delete` argv
    (https://cloud.google.com/sdk/gcloud/reference/compute/instances/delete)."""
    return [
        "gcloud", "compute", "instances", "delete", name,
        f"--zone={zone}", "--quiet",
    ]


def _backend_gcloud(spec: LaunchSpec, script: str) -> Dict[str, str]:
    res = subprocess.run(
        gcloud_create_argv(spec, script),
        capture_output=True, text=True, timeout=600,
    )
    if res.returncode != 0:
        raise CloudError(f"gcloud create failed: {res.stderr}")
    return {"instance": spec.name, "state": "creating"}


BACKENDS: Dict[str, Callable[[LaunchSpec, str], Dict[str, str]]] = {
    "dryrun": _backend_dryrun,
    "gcloud": _backend_gcloud,
}


def start_cloud_training(
    spec: LaunchSpec, backend: str = "dryrun", run=None
) -> Dict[str, str]:
    """Validate git state, pre-create the tracker run, launch the instance."""
    commit = check_git_status()
    if run is None:
        run = init_run(
            project=f"nnue_vision_tpu_{spec.model_type}",
            config={"launch": spec.name, "commit": commit},
        )
    repo_url = spec.repo_url or subprocess.run(
        ["git", "remote", "get-url", "origin"], capture_output=True, text=True
    ).stdout.strip() or "."
    script = make_bootstrap_script(
        repo_url, commit, spec.model_type, run.name,
        config=spec.config, extra_args=spec.extra_args,
    )
    if backend not in BACKENDS:
        raise CloudError(f"unknown backend {backend}; have {list(BACKENDS)}")
    info = BACKENDS[backend](spec, script)
    info["run"] = run.name
    info["commit"] = commit
    return info


def stop_instance(reason: str = "") -> None:
    """Delete the instance this process runs on, if the environment names
    it (`NV_INSTANCE_NAME`, in zone `NV_ZONE`), as upstream stops its
    RunPod pod by the env-provided RUNPOD_POD_ID
    (nnue_runpod_service.py:209-240); a no-op when unset (local runs)."""
    name = os.environ.get("NV_INSTANCE_NAME")
    if not name:
        return
    zone = os.environ.get("NV_ZONE", DEFAULT_ZONE)
    print(f"Stopping instance {name} ({reason})")
    subprocess.run(
        gcloud_delete_argv(name, zone),
        capture_output=True, text=True, timeout=600,
    )
