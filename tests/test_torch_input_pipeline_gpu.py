"""The light-pipeline Hopper kernel (K3) held bit-equal to its plain version
on a card.

Marked `gpu`; each test skips where there is no CUDA device. The file
imports no jax, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_input_pipeline_gpu.py
"""

import numpy as np
import pytest
import torch

from nnue_vision_tpu_torch.data.augment import normalize_images
from nnue_vision_tpu_torch.ops import input_pipeline as ip

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _dataset(n, h, w, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.random((n, h, w, 3), np.float32))


@pytest.mark.parametrize("h,w,batch", [(32, 32, 512), (32, 32, 256), (16, 16, 37),
                                       (10, 10, 12)])
def test_kernel_equals_plain(cuda, h, w, batch):
    n = 64
    ds = ip.prepare_gather_dataset(_dataset(n, h, w).to(cuda))
    gen = torch.Generator().manual_seed(batch)
    for _ in range(3):
        p = ip.draw_light_params(gen, 1, batch, h, w)
        idx = torch.randint(0, n, (batch,), generator=gen)
        idx_eff = (idx + n * p.flip[0]).to(torch.int32).to(cuda)
        args = (ds, idx_eff, p.pf[0].to(cuda), p.pi[0].to(cuda))
        before = ip.LAUNCHES["light_pipeline_kernel"]
        got = ip.fused_light_pipeline(*args, h=h, w=w)
        assert ip.LAUNCHES["light_pipeline_kernel"] == before + 1
        want = ip.fused_light_pipeline_reference(*args, h=h, w=w)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


def test_identity_equals_normalize(cuda):
    n, batch = 40, 64
    ds = ip.prepare_gather_dataset(_dataset(n, 32, 32, seed=1).to(cuda))
    idx = torch.arange(batch, dtype=torch.int32, device=cuda) % n
    p = ip.identity_light_params(1, batch)
    got = ip.fused_light_pipeline(ds, idx, p.pf[0].to(cuda), p.pi[0].to(cuda),
                                  h=32, w=32)
    assert torch.equal(got, normalize_images(ds[idx.long()]))


def test_out_of_range_index_writes_nan(cuda):
    ds = ip.prepare_gather_dataset(_dataset(8, 32, 32).to(cuda))
    idx = torch.tensor([0, 16, -1, 15], dtype=torch.int32, device=cuda)
    p = ip.identity_light_params(1, 4)
    got = ip.fused_light_pipeline(ds, idx, p.pf[0].to(cuda), p.pi[0].to(cuda),
                                  h=32, w=32)
    assert torch.isfinite(got[[0, 3]]).all()
    assert torch.isnan(got[[1, 2]]).all()


def test_wrong_dtype_raises(cuda):
    ds = ip.prepare_gather_dataset(_dataset(8, 32, 32).to(cuda))
    idx = torch.zeros(4, dtype=torch.int64, device=cuda)
    p = ip.identity_light_params(1, 4)
    with pytest.raises(ValueError, match="idx_eff"):
        ip.fused_light_pipeline(ds, idx, p.pf[0].to(cuda), p.pi[0].to(cuda),
                                h=32, w=32)
