"""Sharded int8 serving on a card: two gloo ranks that share the card each
run K1 (`nnue_engine_forward_mega`), K2 (`nnue_engine_forward_fused`) and
K6 (`etiny_forward_kernel`) on their rows of a batch of 13 (padded to 14),
and the gathered logits and counts are `torch.equal` to the one-process
kernel and to the plain version. NCCL refuses two ranks on one card, so
the ranks name gloo, which takes CUDA tensors for the all-reduce the
gather is built from.

Marked `gpu`; each test skips where there is no CUDA device. The file
imports no jax, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_parallel_gpu.py
"""

from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from nnue_vision_tpu_torch.data.augment import normalize_images
from nnue_vision_tpu_torch.formats import (
    QConv,
    QFeatureTransformer,
    QLBBlock,
    QLinear,
    QuantizedEtinyNet,
    QuantizedNNUE,
)
from nnue_vision_tpu_torch.models.etinynet import EtinyNetConfig
from nnue_vision_tpu_torch.ops import etiny_kernels as ek
from nnue_vision_tpu_torch.ops import nnue_kernels as nk
from nnue_vision_tpu_torch.ops.engine_sim import (
    etiny_engine_forward,
    etiny_sim_params,
    nnue_engine_forward,
    nnue_sim_params,
)
from nnue_vision_tpu_torch.parallel import distributed as tdist
from nnue_vision_tpu_torch.parallel import mesh as tmesh

pytestmark = pytest.mark.gpu

JOIN_S = 120.0
B, NH, EH = 13, 12, 32


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _i8(rng, *s):
    return rng.integers(-127, 128, s).astype(np.int8)


def _nnue(rng):
    grid, ch, l1, l2, l3, nc = 4, 6, 16, 8, 4, 3
    return QuantizedNNUE(
        grid_size=grid, num_features_per_square=ch, l1=l1, l2=l2, l3=l3,
        nnue2score=600.0, visual_threshold=0.07,
        conv=QConv(weight=_i8(rng, ch, 3, 3, 3),
                   bias=rng.integers(-500, 500, ch).astype(np.int32)),
        ft=QFeatureTransformer(
            weight=rng.integers(-127, 128, (grid * grid * ch, l1)).astype(np.int16),
            bias=rng.integers(-2000, 2000, l1).astype(np.int32)),
        fc1=QLinear(weight=_i8(rng, l2, l1),
                    bias=rng.integers(-2000, 2000, l2).astype(np.int32)),
        fc2=QLinear(weight=_i8(rng, l3, l2),
                    bias=rng.integers(-2000, 2000, l3).astype(np.int32)),
        out=QLinear(weight=_i8(rng, nc, l3),
                    bias=rng.integers(-2000, 2000, nc).astype(np.int32)),
    ).validate()


def _etiny(rng):
    cfg = EtinyNetConfig(variant="micro", num_classes=10, input_size=EH)
    t = cfg.table
    blocks = [QLBBlock(pw_expand=_i8(rng, mid, cin), dw=_i8(rng, mid, 3, 3),
                       pw_project=_i8(rng, out, mid), stride=stride,
                       is_dense=dense and stride == 1,
                       pw_expand_bias=rng.integers(-200000, 200000, mid).astype(np.int32))
              for _, cin, mid, out, stride, dense in cfg.block_specs()]
    return QuantizedEtinyNet(
        variant="micro", num_classes=10, input_size=EH,
        conv_channels=t["conv_channels"], final_channels=blocks[-1].out_channels,
        stem=QConv(weight=_i8(rng, t["conv_channels"], 3, 3, 3),
                   bias=rng.integers(-500, 500, t["conv_channels"]).astype(np.int32)),
        blocks=blocks,
        classifier=QLinear(weight=_i8(rng, 10, blocks[-1].out_channels),
                           bias=rng.integers(-2000, 2000, 10).astype(np.int32)),
    ).validate()


def _serve(mesh=None):
    """{name: outputs} of K1, K2 and K6 on the batch (split over `mesh`)."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(33)
    sim, cfg = nnue_sim_params(_nnue(rng), device=dev)
    esim, ecfg = etiny_sim_params(_etiny(rng), device=dev)
    x = normalize_images(torch.from_numpy(
        rng.random((B, NH, NH, 3), dtype=np.float32)).to(dev)).contiguous()
    ex = normalize_images(torch.from_numpy(
        rng.random((B, EH, EH, 3), dtype=np.float32)).to(dev)).contiguous()
    mega = nk.mega_head_params(sim, cfg, NH, NH)
    head = nk.pallas_head_params(sim)
    kp = ek.etiny_kernel_params(esim, ecfg)
    kw = dict(cfg=cfg, image_h=NH, image_w=NH)
    fns = {
        "mega": (lambda t: nk.nnue_engine_forward_mega(
            mega, t.reshape(len(t), -1), **kw), x),
        "fused": (lambda t: nk.nnue_engine_forward_fused(sim, head, t, **kw), x),
        "etiny": (lambda t: ek.etiny_forward_kernel(
            kp, t, cfg=ecfg, image_h=EH, image_w=EH), ex),
        "nnue_plain": (lambda t: nnue_engine_forward(sim, t, **kw), x),
        "etiny_plain": (lambda t: etiny_engine_forward(
            esim, t, cfg=ecfg, image_h=EH, image_w=EH), ex),
    }
    out = {}
    for name, (fn, batch) in fns.items():
        got = (fn if mesh is None else tmesh.shard_map(fn, mesh))(batch)
        got = got if isinstance(got, tuple) else (got,)
        out[name] = [None if t is None else t.cpu() for t in got]
    torch.cuda.synchronize()
    return out


def _rank(rank, tmp):
    tdist.initialize_distributed(f"file://{tmp}/rdv", 2, rank, backend="gloo",
                                 timeout_s=JOIN_S)
    nk.reset_launch_counts()
    ek.reset_launch_counts()
    out = _serve(tmesh.make_mesh(2, device="cuda"))
    out["launches"] = {**nk.LAUNCHES, **ek.LAUNCHES}
    torch.save(out, Path(tmp) / f"rank{rank}.pt")
    dist.destroy_process_group()


def _equal(got, want):
    for g, w in zip(got, want, strict=True):
        assert (g is None) == (w is None)
        if w is not None:
            assert g.dtype == w.dtype and torch.equal(g, w)


def test_sharded_int8_serving_equals_one_process(cuda, tmp_path):
    tdist.spawn(_rank, 2, (str(tmp_path),), timeout_s=JOIN_S)
    one = _serve()
    for rank in range(2):
        got = torch.load(tmp_path / f"rank{rank}.pt", weights_only=False)
        launches = got.pop("launches")
        assert launches["nnue_mega_kernel"] >= 1
        assert launches["nnue_head_kernel"] >= 1
        assert launches["etiny_block_kernel"] >= 1
        for name in got:
            _equal(got[name], one[name])
        _equal(got["mega"], one["nnue_plain"])
        _equal(got["fused"], one["nnue_plain"])
        _equal(got["etiny"], one["etiny_plain"])
