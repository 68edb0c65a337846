"""EtinyNet int8 serving's stem and tail wrappers on the CPU
(`ops/etiny_kernels.py` `etiny_stem_int8`, `etiny_tail_logits`): a CPU
tensor takes the plain sim code, bit for bit; the layouts the kernels read
(`stem_pack`, `tail_pack`), unpacked by the kernels' own indexing and held
to the model's weights, and the stem's packed taps summed pair by pair
against the plain stem; and the per-model bounds that pick int32 or int64
sums (`stem_q_max`, `tail_needs_int64`) at their edges, held to int64
arithmetic done by hand. The kernels themselves run on the card only:
`tests/test_torch_etiny_stem_tail_gpu.py`. The file imports no jax.
"""

import numpy as np
import pytest
import torch

from nnue_vision_tpu_torch.formats import QConv, QLBBlock, QLinear, QuantizedEtinyNet
from nnue_vision_tpu_torch.ops import etiny_kernels as ek
from nnue_vision_tpu_torch.ops.engine_sim import (
    etiny_sim_params,
    etiny_stem,
    etiny_tail,
)

INT32_MAX = 2**31 - 1


def _model(rng, conv=8, final=24, classes=10, cls_bias=2000):
    """A one-block random int8 EtinyNet with `conv` stem channels and
    `final` channels at the tail."""
    def i8(*s):
        return rng.integers(-128, 128, s).astype(np.int8)

    blk = QLBBlock(pw_expand=i8(16, conv), dw=i8(16, 3, 3), pw_project=i8(final, 16),
                   stride=2, is_dense=False,
                   pw_expand_bias=rng.integers(-9000, 9000, 16).astype(np.int32))
    return QuantizedEtinyNet(
        variant="micro", num_classes=classes, input_size=32, conv_channels=conv,
        final_channels=final,
        stem=QConv(weight=i8(conv, 3, 3, 3),
                   bias=rng.integers(-500, 500, conv).astype(np.int32)),
        blocks=[blk],
        classifier=QLinear(weight=i8(classes, final),
                           bias=rng.integers(-cls_bias, cls_bias, classes).astype(np.int32)),
    ).validate()


def _params(seed, **kw):
    sim, cfg = etiny_sim_params(_model(np.random.default_rng(seed), **kw), device="cpu")
    return ek.etiny_kernel_params(sim, cfg), cfg


@pytest.mark.parametrize("conv,side,batch", [(8, 32, 3), (28, 33, 2), (32, 17, 1),
                                             (24, 9, 4)])
def test_stem_wrapper_on_cpu_is_the_plain_stem(conv, side, batch):
    kp, cfg = _params(conv + side, conv=conv)
    gen = torch.Generator().manual_seed(side)
    x = torch.randn((batch, side, side, 3), generator=gen) * 3
    got = ek.etiny_stem_int8(kp, x, cfg)
    assert got.dtype == torch.int8
    assert got.shape == (batch, (side - 1) // 2 + 1, (side - 1) // 2 + 1, conv)
    assert torch.equal(got, etiny_stem(kp, x, cfg).to(torch.int8))


@pytest.mark.parametrize("final,hw,classes", [(24, 1, 10), (40, 7, 1000), (1120, 1, 10)])
def test_tail_wrapper_on_cpu_is_the_plain_tail(final, hw, classes):
    kp, cfg = _params(final + hw, final=final, classes=classes)
    gen = torch.Generator().manual_seed(hw)
    x = torch.randint(-127, 128, (5, hw, hw, final), generator=gen, dtype=torch.int8)
    got = ek.etiny_tail_logits(kp, x, cfg)
    assert got.dtype == torch.float32 and got.shape == (5, classes)
    assert torch.equal(got, etiny_tail(kp, x, cfg))


def _stem_w_at(wp: torch.Tensor, c: int, t: int) -> int:
    """csrc/etiny_stem.cu stem_w: channel c's weight at tap t (kh, kw, ci
    order) in the packed words."""
    b = wp.reshape(-1)
    return int(b[((c // 8) * 14 + t // 2) * 16 + ((c % 8) // 2) * 4 + (c % 2) * 2 + t % 2])


@pytest.mark.parametrize("conv", [8, 24, 28, 32, 5])
def test_stem_pack_is_the_kernels_layout(conv):
    kp, _ = _params(conv, conv=conv)
    wp, w = kp["stem_wp"], kp["stem_w"]
    chunks = -(-conv // 8)
    assert wp.shape == (chunks, 14, 16) and wp.dtype == torch.int8
    for c in range(8 * chunks):
        for t in range(28):
            want = int(w[c, t % 3, t // 9, (t // 3) % 3]) if c < conv and t < 27 else 0
            assert _stem_w_at(wp, c, t) == want, (c, t)
    assert kp["stem_bp"].shape == (8 * chunks,)
    assert torch.equal(kp["stem_bp"][:conv], kp["stem_b"])
    assert not kp["stem_bp"][conv:].any()


@pytest.mark.parametrize("scale", [1, 3, 200])
def test_packed_stem_summed_by_pairs_is_the_plain_stem(scale):
    """The kernel's arithmetic on the packed words, in int64: each pixel's
    27 taps in (kh, kw, ci) order as 14 pairs, each pair's two products
    summed (as __dp2a does), + bias, truncating /64, clamp ±127."""
    kp, cfg = _params(scale, conv=28)
    x = torch.randn((2, 11, 11, 3), generator=torch.Generator().manual_seed(3)) * scale
    q = torch.trunc(x * 64.0).to(torch.int64)
    qp = torch.nn.functional.pad(q, (0, 0, 1, 1, 1, 1))
    oh = 6
    # (B, oh, ow, kh, kw, ci) patches at stride 2, flattened in tap order
    taps = torch.stack([torch.stack([qp[:, kh:kh + 2 * oh - 1:2, kw:kw + 2 * oh - 1:2]
                                     for kw in range(3)], 3) for kh in range(3)], 3)
    taps = torch.nn.functional.pad(taps.reshape(2, oh, oh, 27), (0, 1))
    w = torch.tensor([[_stem_w_at(kp["stem_wp"], c, t) for t in range(28)]
                      for c in range(32)], dtype=torch.int64)
    acc = kp["stem_bp"].to(torch.int64).clone().expand(2, oh, oh, 32).clone()
    for p in range(14):
        acc += taps[..., 2 * p, None] * w[:, 2 * p] + taps[..., 2 * p + 1, None] * w[:, 2 * p + 1]
    got = torch.clamp(torch.div(acc, 64, rounding_mode="trunc"), -127, 127)[..., :28]
    assert torch.equal(got, etiny_stem(kp, x, cfg))


def test_tail_pack_is_class_minor():
    kp, _ = _params(4, final=40, classes=7)
    wt, w = kp["cls_wt"], kp["cls_w"]
    assert wt.shape == (3, 7, 16) and wt.dtype == torch.int8
    for j in range(3):
        for k in range(7):
            for i in range(16):
                c = 16 * j + i
                assert int(wt[j, k, i]) == (int(w[k, c]) if c < 40 else 0)


def _stem(l1_rows, bias):
    """A stem whose channel c's weights sum to l1_rows[c] in absolute
    value (spread over the 27 taps, at most 127 each, signs alternating)."""
    w = torch.zeros((len(l1_rows), 27), dtype=torch.int64)
    for c, n in enumerate(l1_rows):
        for t in range(27):
            v = min(127, n - int(w[c].abs().sum()))
            w[c, t] = v if t % 2 == 0 else -v
    assert w.abs().sum(1).tolist() == list(l1_rows)
    return (w.reshape(-1, 3, 3, 3).to(torch.int32),
            torch.tensor(bias, dtype=torch.int32))


def _worst_sum(w_row, b, q):
    """By hand, in Python's integers: the channel's sum on the input that
    makes it largest, every tap q·sign(w), and the bias of the same sign
    (every partial sum lies below it)."""
    return sum(q * abs(int(v)) for v in w_row.reshape(-1)) + abs(int(b))


@pytest.mark.parametrize("l1_rows,bias,want", [
    ([3429, 100, 7], [0, 0, 0], 32767),                         # the int16 cap binds
    ([3429, 1000, 5], [-(INT32_MAX - 1000 * 3429), 7, 0], 1000),
    ([3429, 1000, 5], [2**31 - 1000 * 3429, 7, -9], 999),       # one short of 1000
    ([27 * 127, 27 * 127], [INT32_MAX - 5000, -3], 1),
    ([1, 0], [INT32_MAX, 3], 0),                                # room only for q = 0
    ([0, 0], [-(2**31), 0], -1),                                # not even q = 0
])
def test_stem_q_max_at_its_edge(l1_rows, bias, want):
    w, b = _stem(l1_rows, bias)
    q = ek.stem_q_max(w, b)
    assert q == want
    n = len(l1_rows)
    if q < 0:  # not even q = 0 is within the bound
        assert max(_worst_sum(w[c], b[c], 0) for c in range(n)) > INT32_MAX
        return
    assert max(_worst_sum(w[c], b[c], q) for c in range(n)) <= INT32_MAX
    if q < ek.STEM_Q_CAP:  # and one channel leaves it at q_max + 1
        assert max(_worst_sum(w[c], b[c], q + 1) for c in range(n)) > INT32_MAX
    # the kernel's sums at |q| = q_max, by hand, tap pair by tap pair from
    # the bias (as __dp2a adds them): every partial sum within int32
    for c in range(n):
        wc = [int(v) for v in w[c].permute(1, 2, 0).reshape(-1)] + [0]
        for sign in (1, -1):
            qs = [sign * q * (1 if v >= 0 else -1) for v in wc]
            acc = sign * abs(int(b[c]))
            for t in range(0, 28, 2):
                acc += qs[t] * wc[t] + qs[t + 1] * wc[t + 1]
                assert abs(acc) <= INT32_MAX
            assert acc == sign * (abs(int(b[c])) + sum(q * abs(v) for v in wc))


@pytest.mark.parametrize("sign", [1, -1])
def test_tail_int64_at_its_edge(sign):
    w = torch.full((3, 1120), 0, dtype=torch.int8)
    w[1, :] = -128
    w[1, :7] = 127
    l1 = int(w[1].to(torch.int64).abs().sum())
    edge = INT32_MAX - 127 * l1  # 127·L1 + |b| = 2^31 − 1: still int32
    for b1, wide in ((edge, False), (edge + 1, True)):
        b = torch.tensor([5, sign * b1, -5], dtype=torch.int32)
        assert ek.tail_needs_int64(w, b) is wide
        # by hand: the class's largest |sum| over pooled values in ±127
        assert (127 * l1 + b1 > INT32_MAX) is wide
    assert ek.tail_needs_int64(torch.zeros((2, 8), dtype=torch.int8),
                               torch.tensor([INT32_MAX, -INT32_MAX], dtype=torch.int32)) is False


def test_launchers_refuse_cpu_tensors():
    kp, cfg = _params(9)
    with pytest.raises(ValueError, match="etiny_stem_kernel runs on CUDA"):
        ek._launch_stem(kp, torch.zeros((1, 8, 8, 3)), cfg)
    with pytest.raises(ValueError, match="etiny_tail_kernel runs on CUDA"):
        ek._launch_tail(kp, torch.zeros((1, 2, 2, 24), dtype=torch.int8), cfg)


def test_stem_weights_outside_int8_are_refused():
    w = torch.zeros((8, 3, 3, 3), dtype=torch.int32)
    w[3, 0, 1, 2] = 200
    with pytest.raises(ValueError, match="int8"):
        ek.stem_pack(w)


def test_no_launch_on_the_cpu():
    kp, cfg = _params(11)
    before = dict(ek.LAUNCHES)
    x = torch.randn((2, 32, 32, 3))
    ek.etiny_forward_kernel(kp, x, cfg=cfg, image_h=32, image_w=32)
    assert ek.LAUNCHES == before
