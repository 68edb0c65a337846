"""The tensor-core layouts of the serving kernels (K1/K2: the FT as two byte
planes and fc1; K6: the pointwise weights), held on the CPU to the JAX
package's sim with numpy-seeded inputs, and the default device of the
serving builders (F6) and of the float-model builders (F7).

The kernels multiply these layouts on the card; here a plain torch product
of the same bytes, in the kernels' order (chunk by chunk, lo and hi planes
apart, K zero padded), must give the JAX sim's FT and logits exactly. The
kernels themselves are held to their plain versions on the card
(`tests/test_torch_nnue_kernels_gpu.py`, `tests/test_torch_etiny_gpu.py`).
Tolerance: none.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnue_vision_tpu.formats import QConv, QLBBlock, QLinear, QuantizedEtinyNet
from nnue_vision_tpu.ops import engine_sim as jsim
from nnue_vision_tpu_torch.bridge import (
    etinynet_from_jax,
    etinynet_to_numpy,
    nnue_from_jax_params,
    nnue_to_numpy,
)
from nnue_vision_tpu_torch.models.etinynet import EtinyNetConfig, etinynet_init
from nnue_vision_tpu_torch.models.nnue import (
    GridFeatureSet,
    NNUEConfig,
    nnue_from_quantized,
    nnue_init,
)
from nnue_vision_tpu_torch.ops import engine_sim as tsim
from nnue_vision_tpu_torch.ops import etiny_kernels as ek
from nnue_vision_tpu_torch.ops import nnue_kernels as nk
from nnue_vision_tpu_torch.training import checkpoint as tckpt
from tests.conftest import random_quantized_nnue

H = 12  # FR 54 of F 96 at grid 4, 6 channels: 42 padding features


def _untile(tiles: torch.Tensor) -> torch.Tensor:
    """`nk.mma_tiles` undone: (N/128, K/128, 128, 128) → (N, K) padded."""
    nc, ks = tiles.shape[:2]
    return tiles.permute(0, 2, 1, 3).reshape(nc * 128, ks * 128)


def _wrap16(a):
    return ((a & 0xFFFF) ^ 0x8000) - 0x8000


@pytest.mark.parametrize("kind", ["random", "full-range", "stress"])
def test_byte_planes_rebuild_ft_w(kind):
    rng = np.random.default_rng(31)
    if kind == "random":
        w = rng.integers(-32768, 32768, (96, 64))
    elif kind == "full-range":
        w = np.array([[-32768, 32767, -1, 0, 1, 255, 256, -256, -255, 127, -128,
                       128, -129, 32512, -32513, 12345]])
    else:  # the stress model's range
        w = rng.integers(-30000, 30000, (800, 32))
        w[0, :2] = (-30000, 29999)
    ft_w = torch.from_numpy(w.astype(np.int16))
    lo, hi = nk.ft_byte_planes(ft_w)
    assert lo.dtype == torch.uint8 and hi.dtype == torch.int8
    rebuilt = 256 * hi.to(torch.int32) + lo.to(torch.int32)
    assert torch.equal(rebuilt, ft_w.to(torch.int32))


def _ft_from_tiles(head, mask_fr, pad_active: bool, cfg) -> torch.Tensor:
    """The kernels' FT from `ft_tiles`: per chunk, mask · lo (u8) and
    mask · hi (s8) over K = FR padded to 32, then lo + 256·hi + ft_b
    (+ padsum), low 16 bits, clipped ReLU. (B, L1) int64. The mask is
    zero from FR to the K stages' end (128), as the kernels keep it."""
    b, fr = mask_fr.shape
    w = _untile(head["ft_tiles"])
    signed = w.view(torch.int8).to(torch.int64)
    unsigned = w.to(torch.int64)
    lo_part = (torch.arange(w.shape[0]) % 128) < 64
    w = torch.where(lo_part[:, None], unsigned, signed)
    k = -(-fr // 128) * 128
    mask = torch.nn.functional.pad(mask_fr.to(torch.int64), (0, k - fr))
    sums = (mask.double() @ w[:, :k].T.double()).to(torch.int64)  # exact
    half = cfg.l1 // 2
    ft = torch.zeros((b, cfg.l1), dtype=torch.int64)
    pad = head["padsum"].to(torch.int64) if pad_active else 0
    for c in range(-(-half // 32)):
        for i in range(32):
            j = c * 32 + i
            if j >= half:
                break
            for col, off in ((j, 0), (half + j, 32)):
                lo = sums[:, c * 128 + off + i]
                hi = sums[:, c * 128 + 64 + off + i]
                ft[:, col] = lo + 256 * hi
    ft = ft + head["ft_b"].to(torch.int64) + pad
    return torch.clamp(_wrap16(ft), 0, cfg.quantized_one)


def _logits_from_ft(head, ft, cfg) -> torch.Tensor:
    """Pairwise, fc1 from `fc1_tiles` (K = L1 padded to 128), fc2, out."""
    half = cfg.l1 // 2
    a, b = ft[:, :half], ft[:, half:]
    pw = torch.cat([torch.clamp(torch.div(a * b, 128, rounding_mode="trunc"),
                                0, 127), torch.clamp(a, 0, 127)], dim=1)
    k = -(-cfg.l1 // 128) * 128
    w1 = _untile(head["fc1_tiles"]).to(torch.int64)[:cfg.l2, :k]
    pw = torch.nn.functional.pad(pw, (0, k - cfg.l1))
    h1 = (pw.double() @ w1.T.double()).to(torch.int64) + head["fc1_b"]
    h1 = torch.clamp(torch.div(h1, cfg.fc1_scale, rounding_mode="trunc"), 0, 127)
    h2 = h1 @ head["fc2_w"].to(torch.int64).T + head["fc2_b"]
    h2 = torch.clamp(torch.div(h2, cfg.fc2_scale, rounding_mode="trunc"), 0, 127)
    out = h2 @ head["out_w"].to(torch.int64).T + head["out_b"]
    return out.to(torch.float32) / torch.tensor(cfg.out_scale, dtype=torch.float32)


@pytest.mark.parametrize("ft_range", ["int8", "int16"])
@pytest.mark.parametrize("thresh", [0.07, -0.25], ids=["positive", "negative"])
def test_ft_from_planes_matches_jax_sim(thresh, ft_range):
    rng = np.random.default_rng(32)
    q = random_quantized_nnue(rng, grid=4, ch=6, l1=16, visual_threshold=thresh)
    if ft_range == "int16":  # FT sums wrap; F = 96 keeps JAX's f32 sum exact
        w = rng.integers(-32768, 32768, q.ft.weight.shape).astype(np.int16)
        w[:2, :2] = ((-32768, 32767), (32767, -32768))
        q.ft.weight = w
    imgs = (rng.random((5, H, H, 3), dtype=np.float32) * 2 - 0.5).astype(np.float32)
    jp, jcfg = jsim.nnue_sim_params(q)
    jmask = np.array(jsim.nnue_feature_mask(jp, jnp.asarray(imgs), cfg=jcfg,
                                            image_h=H, image_w=H))
    jacc = jsim.nnue_accumulator_refresh(jp, jnp.asarray(jmask))
    jft = np.clip(_wrap16(np.asarray(jacc).astype(np.int64)), 0,
                  int(q.quantized_one))
    jlogits = np.asarray(jsim.nnue_head_from_accumulator(jp, jacc, cfg=jcfg))

    tp, tcfg = tsim.nnue_sim_params(q, device="cpu")
    head = nk.mega_head_params(tp, tcfg, H, H)
    fr = 54
    assert (jmask[:, fr:] == (thresh < 0)).all()  # the padding features
    ft = _ft_from_tiles(head, torch.from_numpy(jmask[:, :fr]), thresh < 0, tcfg)
    np.testing.assert_array_equal(ft.numpy(), jft)
    np.testing.assert_array_equal(_logits_from_ft(head, ft, tcfg).numpy(), jlogits)


def test_ft_tiles_layout():
    """Chunk c holds lo of columns 32c.. and half+32c.., then hi of both,
    zero past half; K (the features) padded to 32 with zeros."""
    ft_w = torch.arange(40 * 72, dtype=torch.int64).reshape(40, 72)
    ft_w = (ft_w * 997 % 65536 - 32768).to(torch.int16)
    tiles = nk.ft_tiles(ft_w)
    assert tiles.shape == (2, 1, 128, 128) and tiles.dtype == torch.uint8
    w = _untile(tiles)
    lo, hi = nk.ft_byte_planes(ft_w)
    half = 36
    for c in range(2):
        for i in range(32):
            j = c * 32 + i
            cols = (w[c * 128 + i, :40], w[c * 128 + 32 + i, :40],
                    w[c * 128 + 64 + i, :40].view(torch.int8),
                    w[c * 128 + 96 + i, :40].view(torch.int8))
            if j < half:
                want = (lo[:, j], lo[:, half + j], hi[:, j], hi[:, half + j])
                for got, ref in zip(cols, want):
                    assert torch.equal(got, ref)
            else:
                assert all(int(x.abs().sum()) == 0 for x in cols)
    assert int(w[:, 40:].abs().sum()) == 0


def _etiny_model(rng, variant):
    """Random int8 blocks at the variant's widths (stride-2 dense blocks
    tagged as LB, as the quantizer writes them), with wide biases."""
    cfg = EtinyNetConfig(variant=variant, num_classes=10, input_size=32)

    def i8(*s):
        return rng.integers(-127, 128, s).astype(np.int8)

    blocks = [QLBBlock(pw_expand=i8(mid, cin), dw=i8(mid, 3, 3),
                       pw_project=i8(out, mid), stride=stride,
                       is_dense=dense and stride == 1,
                       pw_expand_bias=rng.integers(-200000, 200000, mid
                                                   ).astype(np.int32))
              for _, cin, mid, out, stride, dense in cfg.block_specs()]
    ch = cfg.table["conv_channels"]
    return QuantizedEtinyNet(
        variant=variant, num_classes=10, input_size=32, conv_channels=ch,
        final_channels=blocks[-1].out_channels,
        stem=QConv(weight=i8(ch, 3, 3, 3),
                   bias=rng.integers(-500, 500, ch).astype(np.int32)),
        blocks=blocks,
        classifier=QLinear(weight=i8(10, blocks[-1].out_channels),
                           bias=rng.integers(-2000, 2000, 10).astype(np.int32)),
    ).validate()


def _block_from_layouts(x, blk, bs):
    """One LB block with its pointwise products taken from the kernel's
    `we`/`wp` tiles (K zero padded to 128) in plain torch."""
    b, h, w, cin = x.shape
    mid, cout = blk["dw"].shape[0], blk["pw_project_w"].shape[0]

    def product(a, tiles, n):
        wt = _untile(tiles).view(torch.int8).to(torch.float64)
        a = torch.nn.functional.pad(a, (0, wt.shape[1] - a.shape[1]))
        return (a.to(torch.float64) @ wt.T).to(torch.int64)[:, :n]

    def tdiv(a, s):
        return torch.div(a, s, rounding_mode="trunc")

    acc = product(x.reshape(-1, cin), blk["we"], mid) + blk["be"]
    hid = torch.clamp(tdiv(acc, bs.s_expand), 0, 6).reshape(b, h, w, mid)
    s = bs.stride
    oh, ow = (h - 1) // s + 1, (w - 1) // s + 1
    pad = torch.nn.functional.pad(hid, (0, 0, 1, 1, 1, 1))
    dwacc = torch.zeros((b, oh, ow, mid), dtype=torch.int64)
    for kh in range(3):
        for kw in range(3):
            dwacc += pad[:, kh:kh + (oh - 1) * s + 1:s,
                         kw:kw + (ow - 1) * s + 1:s] * blk["dw"][:, kh, kw].to(torch.int64)
    hid = torch.clamp(tdiv(dwacc, bs.s_dw), 0, 6).reshape(-1, mid)
    out = product(hid, blk["wp"], cout)
    return torch.clamp(tdiv(out, bs.s_project), -127, 127).reshape(b, oh, ow, cout)


@pytest.mark.parametrize("variant", ["micro", "0.98M"])
def test_etiny_layouts_give_the_jax_sim(variant):
    rng = np.random.default_rng(33)
    q = _etiny_model(rng, variant)
    imgs = rng.standard_normal((3, 32, 32, 3)).astype(np.float32)
    params, cfg = tsim.etiny_sim_params(q, device="cpu")
    kp = ek.etiny_kernel_params(params, cfg)
    for blk in kp["blocks"]:
        mid, cin = blk["pw_expand_w"].shape
        cout = blk["pw_project_w"].shape[0]
        assert blk["we"].shape == (-(-mid // 128), -(-cin // 128), 128, 128)
        assert blk["wp"].shape == (-(-cout // 128), -(-mid // 128), 128, 128)
    x = tsim.etiny_stem(kp, torch.from_numpy(imgs), cfg)
    for blk, bs in zip(kp["blocks"], cfg.blocks):
        got = _block_from_layouts(x, blk, bs)
        assert torch.equal(got, tsim.lb_block_plain(x, blk, bs))
        x = got
    jp, jcfg = jsim.etiny_sim_params(q)
    want = np.asarray(jsim.etiny_engine_forward(jp, jnp.asarray(imgs), cfg=jcfg,
                                                image_h=32, image_w=32))
    np.testing.assert_array_equal(tsim.etiny_tail(kp, x, cfg).numpy(), want)


# ---------------------------------------------------------------------------
# F6, F7: the serving and float-model builders default to the card
# ---------------------------------------------------------------------------


NNUE_CFG = NNUEConfig(feature_set=GridFeatureSet(grid_size=4,
                                                 num_features_per_square=6),
                      l1_size=16, l2_size=8, l3_size=4, num_classes=3,
                      input_size=12)
ETINY_CFG = EtinyNetConfig(variant="micro", num_classes=10, input_size=32)


def _nnue_payload():
    model = nnue_init(NNUE_CFG, torch.Generator().manual_seed(0), device="cpu")
    return {"model_config": dataclasses.asdict(NNUE_CFG),
            "params": nnue_to_numpy(model)}


def _etiny_payload():
    model = etinynet_init(ETINY_CFG, torch.Generator().manual_seed(0),
                          device="cpu")
    params, stats = etinynet_to_numpy(model)
    return {"model_config": dataclasses.asdict(ETINY_CFG), "params": params,
            "batch_stats": stats}


def _first(model):
    return next(model.parameters())


BUILDERS = {
    "nnue_sim_params": lambda **kw: tsim.nnue_sim_params(
        random_quantized_nnue(np.random.default_rng(34)), **kw)[0]["ft_w"],
    "etiny_sim_params": lambda **kw: tsim.etiny_sim_params(
        _etiny_model(np.random.default_rng(35), "micro"), **kw)[0]["stem_w"],
    "nnue_from_checkpoint": lambda **kw: next(
        tckpt.nnue_from_checkpoint(_nnue_payload(), **kw).parameters()),
    "etinynet_from_checkpoint": lambda **kw: next(
        tckpt.etinynet_from_checkpoint(_etiny_payload(), **kw).parameters()),
    # F7: the float-model builders
    "nnue_init": lambda **kw: _first(
        nnue_init(NNUE_CFG, torch.Generator().manual_seed(0), **kw)),
    "nnue_from_quantized": lambda **kw: _first(nnue_from_quantized(
        random_quantized_nnue(np.random.default_rng(36)), **kw)),
    "etinynet_init": lambda **kw: _first(
        etinynet_init(ETINY_CFG, torch.Generator().manual_seed(0), **kw)),
    "nnue_from_jax_params": lambda **kw: _first(
        nnue_from_jax_params(_nnue_payload()["params"], NNUE_CFG, **kw)),
    "etinynet_from_jax": lambda **kw: _first(etinynet_from_jax(
        _etiny_payload()["params"], _etiny_payload()["batch_stats"], ETINY_CFG,
        **kw)),
}


@pytest.mark.parametrize("name", list(BUILDERS))
def test_builder_defaults_to_the_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BUILDERS[name]()


@pytest.mark.parametrize("name", list(BUILDERS))
def test_builder_on_the_cpu_when_asked(name):
    assert BUILDERS[name](device="cpu").device == torch.device("cpu")
