"""The two Hopper kernels held bit-equal to their plain versions on a card.

Marked `gpu`; each test skips where there is no CUDA device. The file
imports no jax, so it also runs on a machine without it (the package's
`tests/conftest.py` imports jax, hence `--noconftest`):

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_nnue_kernels_gpu.py
"""

import numpy as np
import pytest
import torch

from nnue_vision_tpu_torch.formats import (
    QConv,
    QFeatureTransformer,
    QLinear,
    QuantizedNNUE,
    read_nnue,
    write_nnue,
)
from nnue_vision_tpu_torch.models.nnue import nnue_from_quantized
from nnue_vision_tpu_torch.ops import engine_sim as tsim
from nnue_vision_tpu_torch.ops import nnue_kernels as nk
from nnue_vision_tpu_torch.training.evaluate import evaluate_int8_sim

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _model(rng, grid, ch, l1, l2, l3, nc, thresh, ft_range=(-127, 128)):
    """Random valid integers, as tests/conftest.random_quantized_nnue."""
    def i8(*s):
        return rng.integers(-127, 128, s).astype(np.int8)

    def i32(*s, lo=-2000, hi=2000):
        return rng.integers(lo, hi, s).astype(np.int32)

    f = grid * grid * ch
    return QuantizedNNUE(
        grid_size=grid, num_features_per_square=ch, l1=l1, l2=l2, l3=l3,
        nnue2score=600.0, visual_threshold=thresh,
        conv=QConv(weight=i8(ch, 3, 3, 3), bias=i32(ch, lo=-500, hi=500)),
        ft=QFeatureTransformer(
            weight=rng.integers(*ft_range, (f, l1)).astype(np.int16),
            bias=i32(l1)),
        fc1=QLinear(weight=i8(l2, l1), bias=i32(l2)),
        fc2=QLinear(weight=i8(l3, l2), bias=i32(l3)),
        out=QLinear(weight=i8(nc, l3), bias=i32(nc)),
    ).validate()


def _same(got, ref):
    for g, r in zip(got, ref, strict=True):
        if r is None:
            assert g is None
        else:
            assert g.device.type == "cuda" and g.dtype == r.dtype
            assert torch.equal(g, r)


def _check_all(q, h, w, b, dev, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.rand((b, h, w, 3), generator=gen, device=dev) * 2 - 0.5)
    flat = x.reshape(b, -1)
    sim, cfg = tsim.nnue_sim_params(q, device=dev)
    mega = nk.mega_head_params(sim, cfg, h, w)
    head = nk.pallas_head_params(sim)
    kw = dict(cfg=cfg, image_h=h, image_w=w)
    ref = tsim.nnue_engine_forward(sim, x, **kw)

    nk.reset_launch_counts()
    got = nk.nnue_engine_forward_mega(mega, flat, **kw)
    _same(got, nk.nnue_engine_forward_mega_reference(mega, flat, **kw))
    _same(got, ref)
    _same(nk.nnue_engine_forward_mega(mega, flat, with_count=False, **kw),
          (ref[0], None, None))
    qb = nk.quantize_images_for_mega(flat, cfg)
    _same(nk.nnue_engine_forward_mega(mega, qb, input_mode="qbf16", **kw), ref)
    assert nk.LAUNCHES["nnue_mega_kernel"] == 3

    got = nk.nnue_engine_forward_fused(sim, head, x, **kw)
    _same(got, nk.nnue_engine_forward_fused_reference(sim, head, x, **kw))
    _same(got, ref)
    buf = tsim.nnue_conv_buffer(sim, x, cfg=cfg, image_h=h)
    got = nk.fused_nnue_head(head, buf, cfg=cfg)
    _same(got, nk.fused_nnue_head_reference(head, buf, cfg=cfg))
    _same(got, (ref[0], ref[2]))
    assert nk.LAUNCHES["nnue_head_kernel"] == 2
    torch.cuda.synchronize()


@pytest.mark.parametrize("grid,ch,l1,l2,l3,nc,h,w,thresh,b", [
    pytest.param(4, 6, 16, 8, 4, 3, 12, 12, 0.07, 5, id="n_pad42"),
    pytest.param(4, 6, 16, 8, 4, 3, 12, 12, -0.25, 5, id="negative-threshold"),
    pytest.param(4, 6, 16, 8, 4, 3, 13, 13, 0.07, 3, id="n_pad0"),
    pytest.param(4, 4, 16, 8, 4, 3, 20, 12, 0.07, 4, id="non-square"),
    pytest.param(10, 8, 1024, 128, 32, 10, 32, 32, 6.4, 37, id="flagship"),
    pytest.param(10, 8, 1024, 128, 32, 10, 32, 32, -0.25, 37,
                 id="flagship-negative-threshold"),
])
def test_kernels_match_plain(cuda, grid, ch, l1, l2, l3, nc, h, w, thresh, b):
    q = _model(np.random.default_rng(61), grid, ch, l1, l2, l3, nc, thresh)
    _check_all(q, h, w, b, cuda)


def test_int16_wrap_and_large_ft_weights(cuda):
    q = _model(np.random.default_rng(62), 10, 8, 1024, 128, 32, 10, -0.25,
               ft_range=(-30000, 30000))
    _check_all(q, 32, 32, 64, cuda, seed=1)


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q = _model(np.random.default_rng(63), 4, 6, 16, 8, 4, 3, 0.07)
    sim, cfg = tsim.nnue_sim_params(q, device=cuda)
    mega = nk.mega_head_params(sim, cfg, 12, 12)
    kw = dict(cfg=cfg, image_h=12, image_w=12)
    x = torch.zeros((4, 432), device=cuda)
    with pytest.raises(ValueError, match="images_flat"):
        nk.nnue_engine_forward_mega(mega, x.double(), **kw)
    with pytest.raises(ValueError, match="contiguous"):
        nk.nnue_engine_forward_mega(mega, torch.zeros((432, 4), device=cuda).T,
                                    **kw)
    with pytest.raises(ValueError, match="images_flat"):
        nk.nnue_engine_forward_mega(mega, x, input_mode="qbf16", **kw)
    cpu_sim, _ = tsim.nnue_sim_params(q, device="cpu")
    with pytest.raises(ValueError, match="on cuda"):
        nk.nnue_engine_forward_mega(nk.mega_head_params(cpu_sim, cfg, 12, 12),
                                    x, **kw)


def test_empty_batch_launches_nothing(cuda):
    q = _model(np.random.default_rng(64), 4, 6, 16, 8, 4, 3, 0.07)
    sim, cfg = tsim.nnue_sim_params(q, device=cuda)
    nk.reset_launch_counts()
    logits, density, count = nk.nnue_engine_forward_mega(
        nk.mega_head_params(sim, cfg, 12, 12), torch.zeros((0, 432), device=cuda),
        cfg=cfg, image_h=12, image_w=12)
    assert logits.shape == (0, 3) and count.shape == (0,)
    assert nk.LAUNCHES["nnue_mega_kernel"] == 0


def test_quantized_model_evaluates_on_the_card(cuda, tmp_path):
    """F7: a read .nnue rebuilt with no device argument evaluates through
    K1 (on the parent it was built on the CPU and took the plain path)."""
    q = _model(np.random.default_rng(65), 10, 8, 1024, 128, 32, 10, 6.4)
    write_nnue(q, tmp_path / "m.nnue")
    model = nnue_from_quantized(read_nnue(tmp_path / "m.nnue"))
    assert next(model.parameters()).device.type == "cuda"
    rng = np.random.default_rng(66)
    loader = [(rng.random((64, 32, 32, 3), dtype=np.float32),
               rng.integers(0, 10, 64)) for _ in range(2)]
    plain = evaluate_int8_sim(model, loader, use_pallas=False)
    nk.reset_launch_counts()
    got = evaluate_int8_sim(model, loader, use_pallas="mega")
    assert nk.LAUNCHES["nnue_mega_kernel"] > 0
    for key in ("acc", "f1", "precision", "recall", "latent_density"):
        assert got[key] == plain[key]
