"""Cloud orchestration: a one-H100 GPU VM launcher with the upstream
workflow (port of `nnue_vision_tpu/cloud/`)."""

from nnue_vision_tpu_torch.cloud.launcher import (  # noqa: F401
    check_git_status,
    start_cloud_training,
    stop_instance,
)
