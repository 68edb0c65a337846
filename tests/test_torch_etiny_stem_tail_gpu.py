"""EtinyNet int8 serving's stem and tail kernels (`csrc/etiny_stem.cu`)
held bit-equal to the engine sim on a card: `etiny_stem_kernel` to
`etiny_stem(...).to(torch.int8)` at batches 1, 37 and 1024, sides 32, 33,
56, 218 and 224 and 8, 24, 28 and 32 stem channels, and on inputs whose
largest |q| lies just under, at and over the int32 path's bound and past
__dp2a's int16 operand (the blocks past it sum in int64); `etiny_tail_kernel` to `etiny_tail` at 10
and 1,000 classes, on the pool's 16-byte and byte paths, and with a
classifier bias that forces its int64 instance; each wrapper's launch
counted once a call.

Marked `gpu`; each test skips where there is no CUDA device. The file
imports no jax:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_etiny_stem_tail_gpu.py
"""

import numpy as np
import pytest
import torch

from nnue_vision_tpu_torch.data.augment import normalize_images
from nnue_vision_tpu_torch.ops import etiny_kernels as ek
from nnue_vision_tpu_torch.ops.engine_sim import EtinySimCfg, etiny_stem, etiny_tail

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _stem_params(w, b):
    """The stem's entries of `etiny_kernel_params` for (C, 3, 3, 3) int8
    weights and (C,) biases, int32 tensors on the card."""
    wp = ek.stem_pack(w)
    bp = torch.zeros(wp.shape[0] * 8, dtype=torch.int32, device=w.device)
    bp[:b.shape[0]] = b
    return {"stem_w": w, "stem_b": b, "stem_wp": wp, "stem_bp": bp,
            "stem_q_max": ek.stem_q_max(w, b)}


def _random_stem(rng, c, dev):
    w = torch.from_numpy(rng.integers(-128, 128, (c, 3, 3, 3))).to(torch.int32)
    b = torch.from_numpy(rng.integers(-500, 501, c)).to(torch.int32)
    return _stem_params(w.to(dev), b.to(dev))


CFG = EtinySimCfg(stem_scale=64, cls_scale=64.0, num_classes=10, blocks=())


def _stem_equal(kp, x):
    before = ek.LAUNCHES["etiny_stem_kernel"]
    got = ek.etiny_stem_int8(kp, x, CFG)
    assert ek.LAUNCHES["etiny_stem_kernel"] == before + 1
    want = etiny_stem(kp, x, CFG).to(torch.int8)
    torch.cuda.synchronize()
    assert got.shape == want.shape and torch.equal(got, want)


@pytest.mark.parametrize("c", [8, 24, 28, 32])
@pytest.mark.parametrize("batch,side", [(1, 32), (37, 32), (1024, 32), (37, 33),
                                        (1, 56), (37, 56), (3, 218), (1, 224),
                                        (37, 224), (1024, 224)])
def test_stem_equals_sim(cuda, c, batch, side):
    kp = _random_stem(np.random.default_rng(c * side + batch), c, cuda)
    gen = torch.Generator(device=cuda).manual_seed(batch)
    x = normalize_images(torch.rand((batch, side, side, 3), generator=gen,
                                    device=cuda)).contiguous()
    _stem_equal(kp, x)


@pytest.mark.parametrize("side", [32, 224])
def test_stem_on_a_view_at_an_odd_offset(cuda, side):
    """An input whose data start is 4-byte but not 16-byte aligned takes
    the scalar loads."""
    kp = _random_stem(np.random.default_rng(side), 28, cuda)
    x = normalize_images(torch.rand((5, side, side, 3), device=cuda))
    flat = torch.empty(x.numel() + 1, device=cuda)
    flat[1:] = x.reshape(-1)
    view = flat[1:].view(x.shape)
    assert view.data_ptr() % 16 == 4
    _stem_equal(kp, view)


def _with_q(x, img, q):
    """x with one value of image `img` set so that its quantized value is
    q exactly (q / 64 is a float32)."""
    x = x.clone()
    x[img, 3, 5, 1] = q / 64.0
    return x


@pytest.mark.parametrize("side", [32, 224])
@pytest.mark.parametrize("step", [-1, 0, 1])
def test_stem_at_the_int32_bound(cuda, side, step):
    """A model whose bias leaves room for |q| ≤ 1000 in int32: one image
    with a value at 1000 + step (−1 just under, 0 at, +1 over); its block
    of threads sums in int64 when over, the others in int32."""
    rng = np.random.default_rng(side)
    w = torch.from_numpy(rng.integers(-128, 128, (32, 3, 3, 3))).to(torch.int32)
    l1 = w.to(torch.int64).abs().reshape(32, -1).sum(1)
    c = int(l1.argmax())
    b = torch.from_numpy(rng.integers(-500, 501, 32)).to(torch.int64)
    b[c] = -(2**31 - 1 - 1000 * int(l1[c]))  # room for exactly 1000
    kp = _stem_params(w.to(cuda), b.to(torch.int32).to(cuda))
    assert kp["stem_q_max"] == 1000
    x = normalize_images(torch.rand((3, side, side, 3), device=cuda))
    for sign in (1, -1):
        _stem_equal(kp, _with_q(x, 1, sign * (1000 + step)).contiguous())


@pytest.mark.parametrize("q", [32767, 32768, -32769, 10**6, 2**31 - 128, -2**31])
def test_stem_past_the_int16_operand(cuda, q):
    """Past 32767 the tap pairs no longer fit int16: the block sums in
    int64, up to the int32 range of q."""
    kp = _random_stem(np.random.default_rng(5), 28, cuda)
    assert kp["stem_q_max"] == ek.STEM_Q_CAP
    x = normalize_images(torch.rand((4, 56, 56, 3), device=cuda))
    _stem_equal(kp, _with_q(x, 2, q).contiguous())


def _tail_params(w, b):
    return {"cls_w": w, "cls_b": b, "cls_wt": ek.tail_pack(w),
            "tail_int64": ek.tail_needs_int64(w, b)}


@pytest.mark.parametrize("batch", [1, 37, 1024])
@pytest.mark.parametrize("hw,c,classes", [(1, 1120, 10), (7, 1280, 1000), (2, 960, 10),
                                          (3, 28, 10), (4, 40, 1000)])
@pytest.mark.parametrize("wide", [False, True])
def test_tail_equals_sim(cuda, batch, hw, c, classes, wide):
    """Random int8 activations; with `wide`, one class's bias leaves less
    room than 127·Σ|w| (the int64 instance), and image 0 is that class's
    worst case, pooled 127·sign(w), whose sum passes 2^31 − 1."""
    rng = np.random.default_rng(batch + c)
    w = torch.from_numpy(rng.integers(-128, 128, (classes, c))).to(torch.int8).to(cuda)
    b = torch.from_numpy(rng.integers(-5000, 5000, classes)).to(torch.int32).to(cuda)
    k = classes // 2
    if wide:
        b[k] = 2**31 - 1 - 100 * int(w[k].to(torch.int64).abs().sum())
    kp = _tail_params(w, b)
    assert kp["tail_int64"] is wide
    cfg = EtinySimCfg(stem_scale=64, cls_scale=64.0 * 1.37, num_classes=classes,
                      blocks=())
    gen = torch.Generator(device=cuda).manual_seed(c)
    x = torch.randint(-127, 128, (batch, hw, hw, c), generator=gen, device=cuda,
                      dtype=torch.int8)
    if wide:
        x[0] = (127 * torch.sign(w[k].to(torch.int32))).to(torch.int8)
    before = ek.LAUNCHES["etiny_tail_kernel"]
    got = ek.etiny_tail_logits(kp, x, cfg)
    assert ek.LAUNCHES["etiny_tail_kernel"] == before + 1
    want = etiny_tail(kp, x, cfg)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    if wide:
        assert float(got[0, k]) * cfg.cls_scale > 2**31


def test_wrappers_refuse_wrong_inputs(cuda):
    w = torch.zeros((10, 32), dtype=torch.int8, device=cuda)
    kp = {**_random_stem(np.random.default_rng(0), 8, cuda),
          **_tail_params(w, torch.zeros(10, dtype=torch.int32, device=cuda))}
    with pytest.raises(ValueError, match="images"):
        ek.etiny_stem_int8(kp, torch.zeros((2, 8, 8, 3), dtype=torch.float64,
                                           device=cuda), CFG)
    with pytest.raises(ValueError, match="cls_wt"):
        ek.etiny_tail_logits(kp, torch.zeros((2, 2, 2, 48), dtype=torch.int8,
                                             device=cuda), CFG)
