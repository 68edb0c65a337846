"""EtinyNet int8 serving with hand-written Hopper kernels: the stem, the LB
blocks (K6) in runs of consecutive blocks, and the pool and classifier.

Port of `nnue_vision_tpu/ops/etiny_pallas.py:90-339`. `etiny_forward_kernel`
is the counterpart of `etiny_forward_pallas`: the stem conv is one launch of
`etiny_stem_kernel`; the LB blocks are launches of `etiny_block_kernel`
(`csrc/etiny_block.cu`), which computes each block at its stride in int32
with C truncating division, one launch per run of `run_plan`; and the
global pool and the classifier one launch of `etiny_tail_kernel`
(`csrc/etiny_stem.cu`; the JAX package runs the stem, pool and classifier
in XLA). The logits equal `etiny_engine_forward`'s, and the C++
`etinynet_inference` binary's, bit for bit.

A run of several blocks is one launch whose every block of threads carries
a tile of images through all of them, each block's output written into
shared memory as the next block's input; only the run's last output goes
to device memory. `run_plan` cuts the blocks into runs from their shapes
and the batch alone: a band-path block runs alone; a block joins the run
before it while the run's tile keeps every product of the run at least
`_SUPER_ROWS` GEMM rows, fills the SMs and fits in shared memory with 2
weight-ring slots at every block boundary (`run_smem`, the library's
layout); a run of one block is the single-block launch, unchanged.

As in the JAX package, a model with a stride-2 dense block (the engine's
dim-preservation quirk, which the serializer never emits) is refused by
`etiny_kernel_params` with ValueError: such a model takes the engine sim.

A block takes any side and stride. Where one image's block fits in the
kernel's shared memory, a block of threads takes a tile of whole images;
where it does not (EtinyNet-1.0 at 224×224: the blocks at 112, 56 and
28), it takes a band of output rows of one image with the input rows its
depthwise needs, a halo of one row each side (`band_plan`, which the
wrapper hands the launcher; `block_smem` is the kernel's shared-memory
layout, so the plan is computed and tested without the card).

The stem and the tail sum in int32 where that is provably exact, and in
int64 where it is not: `etiny_kernel_params` derives the bounds once per
model (`stem_q_max`, `tail_needs_int64`), and each of the stem kernel's
blocks of threads compares its input's largest |q| with the stem's.

`etiny_stem_int8`, `lb_block` and `etiny_tail_logits` dispatch on the
device of their input: a CPU tensor takes the plain version (the sim's
`etiny_stem`, block and `etiny_tail`), a CUDA tensor the kernel, which
launches or raises. There is no fallback. The plain version of the whole
forward is the sim, `etiny_engine_forward`.
"""

from __future__ import annotations

import functools
from typing import Dict, List, NamedTuple, Tuple

import torch

from nnue_vision_tpu_torch import tracing
from nnue_vision_tpu_torch.ops import _build
from nnue_vision_tpu_torch.ops.engine_sim import (
    EtinyBlockCfg,
    EtinySimCfg,
    conv_out_hw,
    etiny_stem,
    etiny_tail,
    lb_block_plain,
)
from nnue_vision_tpu_torch.ops.nnue_kernels import mma_tiles
from nnue_vision_tpu_torch.tracing import span

# Launches since the last reset_launch_counts(), counted by `_build.launch`;
# `band_launches` counts the K6 launches that took the band path,
# `run_launches` those that carried more than one block.
LAUNCHES = tracing.counters("etiny_kernels", "etiny_block_kernel", "band_launches",
                            "run_launches", "etiny_stem_kernel", "etiny_tail_kernel")

INT32_MAX = 2**31 - 1
# csrc/etiny_stem.cu: the stem's int16 operand of __dp2a caps its int32
# path's |q|; its packed weights hold 8 channels by 14 tap pairs a chunk
STEM_Q_CAP = 32767
_STEM_CHUNK, _STEM_PAIRS = 8, 14

# csrc/etiny_block.cu's shared memory (kMaxSmem, its Smem regions), GEMM
# rows a tile aims for (kRowTarget), blocks a run carries at most
# (kMaxRun), the widest product that takes the narrow warp layout
# (kNarrow, held to the library's `etiny_narrow_columns` by a gpu test),
# and int8_mma.cuh's ring slots, in bytes
MAX_SMEM = 232448
_SUPER_ROWS = 64
_ROW_TARGET = 256
MAX_RUN = 16
NARROW = 32
_SLOT_BYTES = 128 * (128 + 16)
# the SMs of the H100, for a plan made for a tensor on no card
H100_SMS = 132


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _a_region(rows: int, k: int) -> int:
    return rows * (_round_up(k, 32) + 16) + 128


def block_smem(tile: int, h: int, w: int, cin: int, mid: int, cout: int,
               oh: int, ow: int, slots: int = 2) -> int:
    """Shared memory of one block of threads of the kernel, in bytes: a
    tile of `tile` images of h×w input and oh×ow output positions (a band:
    one image of its input and output rows), with `slots` weight-ring slots
    at most (`etiny_block_smem` of the library, which gives 2)."""
    rows = _round_up(tile * h * w, _SUPER_ROWS)
    orows = _round_up(tile * oh * ow, _SUPER_ROWS)
    x_and_h2 = _round_up(max(_a_region(rows, cin), _a_region(orows, mid)), 128)
    h1 = _round_up(max(rows * mid, orows * cout), 128)
    consts = _round_up(4 * mid, 128) + _round_up(9 * mid, 128)
    expand = min(-(-mid // 128) * (_round_up(cin, 128) // 128), slots)
    project = min(-(-cout // 128) * (_round_up(mid, 128) // 128), slots)
    return x_and_h2 + h1 + consts + max(expand, project) * _SLOT_BYTES


def _ring_slots(n: int, k: int, slots: int) -> int:
    """Ring slots of a product of n columns over k bytes (int8_mma.cuh
    ring_slots): its stages a super-tile, `slots` at most."""
    return min(-(-n // 128) * (_round_up(k, 128) // 128), slots)


def block_tile(batch: int, h: int, w: int, cin: int, mid: int, cout: int,
               oh: int, ow: int, sms: int = H100_SMS) -> int:
    """Images per block of threads of a single-block launch on the tile
    path (the library's `etiny_block_tile` on a card of `sms` SMs): about
    `_ROW_TARGET` GEMM rows, no more than fill the SMs, no more than fit
    with 2 ring slots; 0 where one image does not fit."""
    tile = min(max(1, _ROW_TARGET // (h * w)), -(-batch // sms))
    while tile > 0 and block_smem(tile, h, w, cin, mid, cout, oh, ow) > MAX_SMEM:
        tile -= 1
    return tile


def run_smem(tile: int, shapes, slots: int = 2) -> int:
    """Shared memory of one block of threads of a run launch, in bytes (the
    library's `etiny_run_smem` gives it at 2 slots): `tile` images through
    the blocks of `shapes`, each (h, w, cin, mid, cout, stride). Two
    regions take turns: block k's input and depthwise output in one, its
    expansion and output (as the next block's operand; the last block's
    densely) in the other; then every block's bias and depthwise weights,
    then the weight ring."""
    reg = [0, 0]
    consts = ring = 0
    for k, (h, w, cin, mid, cout, stride) in enumerate(shapes):
        oh, ow = conv_out_hw(h, w, stride)
        rows = _round_up(tile * h * w, _SUPER_ROWS)
        orows = _round_up(tile * oh * ow, _SUPER_ROWS)
        last = k + 1 == len(shapes)
        reg[k & 1] = max(reg[k & 1], _a_region(rows, cin), _a_region(orows, mid))
        reg[~k & 1] = max(reg[~k & 1], rows * mid,
                          orows * cout if last else _a_region(orows, cout))
        consts += _round_up(4 * mid, 128) + _round_up(9 * mid, 128)
        ring = max(ring, _ring_slots(mid, cin, slots), _ring_slots(cout, mid, slots))
    return (_round_up(reg[0], 128) + _round_up(reg[1], 128) + consts
            + ring * _SLOT_BYTES)


class Run(NamedTuple):
    """One K6 launch: blocks first .. first + count − 1, at `tile` images
    a block of threads (a single block's tile path: `block_tile`), or on
    row bands of `band` output rows (a single block)."""
    first: int
    count: int
    tile: int
    band: int


@functools.lru_cache(maxsize=None)
def run_plan(shapes: Tuple[Tuple[int, ...], ...], batch: int,
             sms: int = H100_SMS) -> Tuple[Run, ...]:
    """The K6 launches of the blocks of `shapes` (consecutive, each (h, w,
    cin, mid, cout, stride)) at `batch` images on a card of `sms` SMs. A
    band-path block is a run of its own. A tile-path block opens a run at
    its own tile (`block_tile`); the next block joins while the run, at the
    smallest tile that gives each of its products at least `_SUPER_ROWS`
    GEMM rows (and no less than the first block's tile), still fills the
    SMs (at most ⌈batch / sms⌉ images a tile) and fits in shared memory
    with 2 ring slots (`run_smem`); at most MAX_RUN blocks a run."""
    fill = -(-batch // sms)
    runs = []
    i = 0
    while i < len(shapes):
        h, w, cin, mid, cout, stride = shapes[i]
        band = band_plan(h, w, cin, mid, cout, stride)
        if band:
            runs.append(Run(i, 1, 1, band))
            i += 1
            continue
        oh, ow = conv_out_hw(h, w, stride)
        tile = block_tile(batch, h, w, cin, mid, cout, oh, ow, sms)
        need = tile
        j = i + 1
        while j < len(shapes) and j - i < MAX_RUN and not band_plan(*shapes[j]):
            jh, jw, *_, js = shapes[j]
            joh, jow = conv_out_hw(jh, jw, js)
            need = max(need, -(-_SUPER_ROWS // (oh * ow)), -(-_SUPER_ROWS // (joh * jow)))
            if need > fill or run_smem(need, shapes[i:j + 1]) > MAX_SMEM:
                break
            tile = need
            j += 1
        runs.append(Run(i, j - i, tile, 0))
        i = j
    return tuple(runs)


def block_shapes(specs: Tuple[Tuple[int, int, int, int], ...], h: int, w: int
                 ) -> Tuple[Tuple[int, ...], ...]:
    """(h, w, cin, mid, cout, stride) of each block for a stem output of
    h×w, from the blocks' (cin, mid, cout, stride) (`k6_specs`)."""
    out = []
    for cin, mid, cout, stride in specs:
        out.append((h, w, cin, mid, cout, stride))
        h, w = conv_out_hw(h, w, stride)
    return tuple(out)


def band_in_rows(rows: int, h: int, stride: int) -> int:
    """The most input rows a band of `rows` output rows reads: an interior
    band's (rows − 1)·stride + 3, at most the image's h."""
    return min(h, (rows - 1) * stride + 3)


@functools.lru_cache(maxsize=None)
def band_plan(h: int, w: int, cin: int, mid: int, cout: int, stride: int
              ) -> int:
    """Output rows a band of one image for a block of this shape: 0 where
    one image's tile fits in shared memory (the tile path), else the most
    rows that fit with 2 weight-ring slots. Raises ValueError where one row
    does not fit."""
    oh, ow = conv_out_hw(h, w, stride)
    if block_smem(1, h, w, cin, mid, cout, oh, ow) <= MAX_SMEM:
        return 0
    rows = 0
    while rows < oh and block_smem(1, band_in_rows(rows + 1, h, stride), w, cin,
                                   mid, cout, rows + 1, ow) <= MAX_SMEM:
        rows += 1
    if rows == 0:
        raise ValueError(
            f"one output row of a {h}x{w}x{cin}->{mid}->{cout} block needs "
            f"{block_smem(1, band_in_rows(1, h, stride), w, cin, mid, cout, 1, ow)} "
            f"bytes of shared memory; the card gives a block {MAX_SMEM}")
    return rows


def band_windows(h: int, stride: int, rows: int
                 ) -> List[Tuple[int, int, int, int]]:
    """(oy0, oy1, iy0, iy1) of each band of `rows` output rows of an image
    of height h: the output rows it writes, [oy0, oy1), and the input rows
    it reads, [iy0, iy1), one halo row each side clipped to the image
    (csrc/etiny_block.cu band_first_in, band_end_in). The last band may be
    shorter."""
    oh = (h - 1) // stride + 1
    out = []
    for oy0 in range(0, oh, rows):
        oy1 = min(oh, oy0 + rows)
        out.append((oy0, oy1, max(0, oy0 * stride - 1),
                    min(h, (oy1 - 1) * stride + 2)))
    return out


@functools.lru_cache(maxsize=None)
def rows_read(h: int, w: int, cin: int, mid: int, cout: int, stride: int
              ) -> int:
    """Input rows the kernel's blocks of threads read for one image of a
    block of this shape: h on the tile path, each band's rows with its halo
    on the band path."""
    rows = band_plan(h, w, cin, mid, cout, stride)
    if rows == 0:
        return h
    return sum(iy1 - iy0 for _, _, iy0, iy1 in band_windows(h, stride, rows))


def _tiles_shape(n: int, k: int) -> tuple:
    """Shape of `mma_tiles` of an (n, k) weight."""
    return (-(-n // 128), -(-k // 128), 128, 128)


def stem_q_max(stem_w: torch.Tensor, stem_b: torch.Tensor) -> int:
    """The largest |q| (quantized input) for which every partial sum of the
    stem's channels, |q|·Σ_t |w[c][t]| + |b[c]| at most, fits int32, capped
    at STEM_Q_CAP; −1 where even q = 0 does not."""
    l1 = stem_w.to(torch.int64).abs().reshape(stem_w.shape[0], -1).sum(1).cpu()
    room = INT32_MAX - stem_b.to(torch.int64).abs().cpu()
    q = STEM_Q_CAP
    for n, r in zip(l1.tolist(), room.tolist()):
        if r < 0:
            return -1
        if n:
            q = min(q, r // n)
    return q


def tail_needs_int64(cls_w: torch.Tensor, cls_b: torch.Tensor) -> bool:
    """Can a class's sum over pooled values in −127..127, 127·Σ_c |w[k][c]|
    + |b[k]| at most, pass int32? Then the tail sums in int64."""
    l1 = cls_w.to(torch.int64).abs().sum(1)
    return bool((127 * l1 + cls_b.to(torch.int64).abs() > INT32_MAX).any())


def stem_pack(stem_w: torch.Tensor) -> torch.Tensor:
    """(C, 3, 3, 3) OIHW stem weights as the stem kernel's words: taps in
    (kh, kw, ci) order padded to 28, channels padded to a multiple of 8;
    (chunks, 14, 16) int8, where a chunk's 16 bytes at a tap pair t are
    four channel pairs j, each (w[2j][2t], w[2j][2t+1], w[2j+1][2t],
    w[2j+1][2t+1]). Raises ValueError for a weight outside int8."""
    c = stem_w.shape[0]
    if int(stem_w.max()) > 127 or int(stem_w.min()) < -128:
        raise ValueError("the stem's weights must fit int8")
    cp = _round_up(c, _STEM_CHUNK)
    w = torch.zeros((cp, 2 * _STEM_PAIRS), dtype=torch.int8, device=stem_w.device)
    w[:c, :27] = stem_w.permute(0, 2, 3, 1).reshape(c, 27)
    # [chunk, j, channel of the pair, pair t, tap of the pair] → [chunk, t, j, ...]
    w = w.reshape(cp // _STEM_CHUNK, _STEM_CHUNK // 2, 2, _STEM_PAIRS, 2)
    return w.permute(0, 3, 1, 2, 4).reshape(cp // _STEM_CHUNK, _STEM_PAIRS, 16).contiguous()


def tail_pack(cls_w: torch.Tensor) -> torch.Tensor:
    """(classes, C) int8 classifier weights class-minor for the tail
    kernel: C padded to a multiple of 16, (C/16, classes, 16) int8."""
    k, c = cls_w.shape
    w = torch.zeros((k, _round_up(c, 16)), dtype=torch.int8, device=cls_w.device)
    w[:, :c] = cls_w
    return w.reshape(k, -1, 16).permute(1, 0, 2).contiguous()


def etiny_kernel_params(sim_params: Dict, cfg: EtinySimCfg) -> Dict:
    """`etiny_sim_params` arrays plus the kernels' layouts, built once per
    model. Per block: `we` (pw-expand, (mid, in)) and `wp` (pw-project,
    (out, mid)) as `mma_tiles`, K zero padded to a multiple of 128, in the
    operand order of the tensor-core products; `be` int32; `dw` (mid, 3, 3)
    int8. The stem: `stem_wp` (`stem_pack`), `stem_bp` (the bias, int32,
    zero padded to the packed channels) and `stem_q_max`; the tail:
    `cls_wt` (`tail_pack`) and `tail_int64` (`tail_needs_int64`). Raises
    ValueError for a stride-2 dense block. `k6_specs`: each block's (cin,
    mid, cout, stride), for `block_shapes` and `run_plan`."""
    blocks = []
    for blk, bs in zip(sim_params["blocks"], cfg.blocks):
        if bs.is_dense and bs.stride != 1:
            raise ValueError(
                "stride-2 dense block (engine dim-preservation quirk) — "
                "use the XLA engine sim for this model"
            )
        blocks.append({
            **blk,
            "we": mma_tiles(blk["pw_expand_w"]),
            "be": blk["pw_expand_b"].to(torch.int32).contiguous(),
            "dw": blk["dw_w"].contiguous(),
            "wp": mma_tiles(blk["pw_project_w"]),
        })
    stem_wp = stem_pack(sim_params["stem_w"])
    stem_bp = torch.zeros(stem_wp.shape[0] * _STEM_CHUNK, dtype=torch.int32,
                          device=stem_wp.device)
    stem_bp[:sim_params["stem_b"].shape[0]] = sim_params["stem_b"]
    specs = tuple((blk["pw_expand_w"].shape[1], blk["pw_expand_w"].shape[0],
                   blk["pw_project_w"].shape[0], bs.stride)
                  for blk, bs in zip(sim_params["blocks"], cfg.blocks))
    return {**sim_params, "blocks": blocks, "k6_specs": specs, "stem_wp": stem_wp,
            "stem_bp": stem_bp,
            "stem_q_max": stem_q_max(sim_params["stem_w"], sim_params["stem_b"]),
            "cls_wt": tail_pack(sim_params["cls_w"]),
            "tail_int64": tail_needs_int64(sim_params["cls_w"], sim_params["cls_b"])}


def lb_block_reference(x: torch.Tensor, blk: Dict, bs: EtinyBlockCfg
                       ) -> torch.Tensor:
    """What etiny_block_kernel computes, in plain torch (the engine sim's
    block): (B, H, W, in) int8 → (B, oh, ow, out) int8."""
    return lb_block_plain(x, blk, bs).to(torch.int8)


def _require(kernel: str, dev: torch.device, *args) -> None:
    """Raise ValueError unless `dev` is a card and each (name, tensor,
    dtype, alignment) is a contiguous tensor of that dtype on it, its data
    aligned to that many bytes."""
    if dev.type != "cuda":
        raise ValueError(f"{kernel} runs on CUDA tensors only (got {dev}); "
                         "CPU tensors take the plain version")
    for name, t, dtype, align in args:
        if t.device != dev or t.dtype != dtype or not t.is_contiguous() \
                or t.data_ptr() % align:
            raise ValueError(
                f"{name}: {kernel} takes a contiguous, {align}-byte aligned "
                f"{dtype} tensor on {dev}; got {t.dtype} on {t.device}")


def _check_block(dev: torch.device, blk: Dict, cin: int) -> Tuple[int, int]:
    """A block's (mid, cout), its weights checked against an input of
    `cin` channels on `dev`; raises ValueError."""
    mid, cout = blk["dw"].shape[0], blk["pw_project_w"].shape[0]
    if (tuple(blk["we"].shape) != _tiles_shape(mid, cin)
            or tuple(blk["wp"].shape) != _tiles_shape(cout, mid)
            or tuple(blk["dw"].shape) != (mid, 3, 3)
            or tuple(blk["be"].shape) != (mid,)):
        raise ValueError("block weights do not match the input's channels")
    _require("etiny_block_kernel", dev,
             ("we", blk["we"], torch.int8, 16), ("be", blk["be"], torch.int32, 16),
             ("dw", blk["dw"], torch.int8, 16), ("wp", blk["wp"], torch.int8, 16))
    return mid, cout


def _launch_block(x: torch.Tensor, blk: Dict, bs: EtinyBlockCfg
                  ) -> torch.Tensor:
    dev = x.device
    b, h, w, cin = x.shape
    _require("etiny_block_kernel", dev, ("x", x, torch.int8, 16))
    mid, cout = _check_block(dev, blk, cin)
    oh, ow = conv_out_hw(h, w, bs.stride)
    out = torch.empty((b, oh, ow, cout), dtype=torch.int8, device=dev)
    if b == 0:
        return out
    band = band_plan(h, w, cin, mid, cout, bs.stride)
    _build.launch(dev, LAUNCHES, "etiny_block_kernel", "etiny_block_launch", (
        x.data_ptr(), b, h, w, cin, mid, cout, bs.stride, oh, ow,
        bs.s_expand, bs.s_dw, bs.s_project, band, blk["we"].data_ptr(),
        blk["be"].data_ptr(), blk["dw"].data_ptr(), blk["wp"].data_ptr(),
        out.data_ptr()))
    if band:
        LAUNCHES["band_launches"] += 1
    return out


def _launch_run(x: torch.Tensor, blks, bss, tile: int) -> torch.Tensor:
    """One launch of consecutive blocks `blks` (configs `bss`) at `tile`
    images a block of threads: (B, H, W, in) int8 → the last block's (B,
    oh, ow, out) int8."""
    dev = x.device
    b, h, w, cin = x.shape
    _require("etiny_block_kernel", dev, ("x", x, torch.int8, 16))
    words = [x.data_ptr(), b, tile, len(blks)]
    for blk, bs in zip(blks, bss):
        mid, cout = _check_block(dev, blk, cin)
        words += [h, w, cin, mid, cout, bs.stride, bs.s_expand, bs.s_dw,
                  bs.s_project, blk["we"].data_ptr(), blk["be"].data_ptr(),
                  blk["dw"].data_ptr(), blk["wp"].data_ptr()]
        (h, w), cin = conv_out_hw(h, w, bs.stride), cout
    out = torch.empty((b, h, w, cin), dtype=torch.int8, device=dev)
    if b == 0:
        return out
    words.append(out.data_ptr())
    _build.launch(dev, LAUNCHES, "etiny_block_kernel", "etiny_run_launch", words)
    LAUNCHES["run_launches"] += 1
    return out


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The SMs of card `index`."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def _plan(kparams: Dict, x: torch.Tensor) -> Tuple[Run, ...]:
    """`run_plan` of the model's blocks for a stem output x."""
    b, h, w, _ = x.shape
    sms = sm_count(x.device.index or 0) if x.device.type == "cuda" else H100_SMS
    return run_plan(block_shapes(kparams["k6_specs"], h, w), b, sms)


def lb_block(x: torch.Tensor, blk: Dict, bs: EtinyBlockCfg) -> torch.Tensor:
    """One LB block at its stride: (B, H, W, in) int8 → (B, oh, ow, out)
    int8, `blk` from `etiny_kernel_params`."""
    if x.device.type == "cpu":
        return lb_block_reference(x, blk, bs)
    return _launch_block(x.contiguous(), blk, bs)


def _launch_stem(kparams: Dict, images: torch.Tensor, cfg: EtinySimCfg
                 ) -> torch.Tensor:
    dev = images.device
    if images.dim() != 4 or images.shape[3] != 3:
        raise ValueError(f"the stem takes (B, H, W, 3) images; got "
                         f"{tuple(images.shape)}")
    b, h, w, _ = images.shape
    c = kparams["stem_b"].shape[0]
    wp, bp = kparams["stem_wp"], kparams["stem_bp"]
    if tuple(wp.shape) != (-(-c // _STEM_CHUNK), _STEM_PAIRS, 16) \
            or tuple(bp.shape) != (wp.shape[0] * _STEM_CHUNK,):
        raise ValueError("stem_wp and stem_bp do not match the stem's channels")
    _require("etiny_stem_kernel", dev, ("images", images, torch.float32, 4),
             ("stem_wp", wp, torch.int8, 16), ("stem_bp", bp, torch.int32, 16))
    oh, ow = conv_out_hw(h, w, 2)
    out = torch.empty((b, oh, ow, c), dtype=torch.int8, device=dev)
    if b == 0:
        return out
    _build.launch(dev, LAUNCHES, "etiny_stem_kernel", "etiny_stem_launch", (
        images.data_ptr(), b, h, w, c, cfg.stem_scale, kparams["stem_q_max"],
        wp.data_ptr(), bp.data_ptr(), out.data_ptr()))
    return out


def etiny_stem_int8(kparams: Dict, images: torch.Tensor, cfg: EtinySimCfg
                    ) -> torch.Tensor:
    """The stem conv: (B, H, W, 3) float32 normalized images → (B, oh, ow,
    C) int8, `kparams` from `etiny_kernel_params`; the plain version is
    the sim's `etiny_stem`."""
    if images.device.type == "cpu":
        return etiny_stem(kparams, images, cfg).to(torch.int8)
    return _launch_stem(kparams, images.contiguous(), cfg)


def _launch_tail(kparams: Dict, x: torch.Tensor, cfg: EtinySimCfg
                 ) -> torch.Tensor:
    dev = x.device
    if x.dim() != 4:
        raise ValueError(f"the tail takes (B, H, W, C) int8; got {tuple(x.shape)}")
    b, h, w, c = x.shape
    k = kparams["cls_b"].shape[0]
    wt = kparams["cls_wt"]
    if tuple(wt.shape) != (-(-c // 16), k, 16):
        raise ValueError("cls_wt does not match the input's channels")
    _require("etiny_tail_kernel", dev, ("x", x, torch.int8, 16),
             ("cls_wt", wt, torch.int8, 16),
             ("cls_b", kparams["cls_b"], torch.int32, 4))
    out = torch.empty((b, k), dtype=torch.float32, device=dev)
    if b == 0:
        return out
    _build.launch(dev, LAUNCHES, "etiny_tail_kernel", "etiny_tail_launch", (
        x.data_ptr(), b, h * w, c, k, int(kparams["tail_int64"]),
        wt.data_ptr(), kparams["cls_b"].data_ptr(), _build.f32(cfg.cls_scale),
        out.data_ptr()))
    return out


def etiny_tail_logits(kparams: Dict, x: torch.Tensor, cfg: EtinySimCfg
                      ) -> torch.Tensor:
    """The global pool and the classifier: (B, H, W, C) int8 → logits (B,
    classes) float32, `kparams` from `etiny_kernel_params`; the plain
    version is the sim's `etiny_tail`."""
    if x.device.type == "cpu":
        return etiny_tail(kparams, x, cfg)
    return _launch_tail(kparams, x.contiguous(), cfg)


def lb_blocks(x: torch.Tensor, kparams: Dict, cfg: EtinySimCfg) -> torch.Tensor:
    """Every LB block of the model on a stem output x, one launch per run
    of `run_plan` (the plain blocks for a CPU tensor)."""
    blocks = kparams["blocks"]
    if x.device.type == "cpu":
        for blk, bs in zip(blocks, cfg.blocks):
            x = lb_block_reference(x, blk, bs)
        return x
    x = x.contiguous()
    for run in _plan(kparams, x):
        end = run.first + run.count
        if run.count == 1:
            x = _launch_block(x, blocks[run.first], cfg.blocks[run.first])
        else:
            x = _launch_run(x, blocks[run.first:end], cfg.blocks[run.first:end],
                            run.tile)
    return x


def narrow_products(shapes) -> int:
    """The products of at most NARROW columns among the blocks of `shapes`
    (each (h, w, cin, mid, cout, stride)): a block's pw-expand has mid
    columns and its pw-project cout. Both kernels give such a product the
    layout in which every warp holds columns that exist."""
    return sum((mid <= NARROW) + (cout <= NARROW) for _, _, _, mid, cout, _ in shapes)


def _row_counts(kparams: Dict, x: torch.Tensor) -> Dict[str, int]:
    """`rows`, the image rows of the blocks' inputs (Σ B·H), and `rows_read`,
    the rows the single-block launches' blocks of threads read, for a stem
    output x, from the band plan alone; `k6_launches`, the call's K6
    launches, from the run plan; and `k6_narrow_products`, the call's K6
    products of at most NARROW columns (every block lies in one launch of
    the plan), from the shapes."""
    b, h, w, _ = x.shape
    shapes = block_shapes(kparams["k6_specs"], h, w)
    return {"rows": b * sum(s[0] for s in shapes),
            "rows_read": b * sum(rows_read(*s) for s in shapes),
            "k6_launches": len(_plan(kparams, x)),
            "k6_narrow_products": narrow_products(shapes)}


def etiny_forward_kernel(kparams: Dict, images: torch.Tensor, *,
                         cfg: EtinySimCfg, image_h: int, image_w: int
                         ) -> torch.Tensor:
    """Bit-exact EtinyNet int8 inference, one kernel launch for the stem,
    one per run of LB blocks (`run_plan`) and one for the pool and
    classifier: (B, H, W, 3) float32 normalized images → logits (B,
    classes) float32, `kparams` from `etiny_kernel_params`. Its plain
    version is the engine sim, `etiny_engine_forward`. The `serve.kernels`
    span counts `rows`, the image rows of the blocks' inputs (Σ B·H),
    `rows_read`, the rows the kernel's blocks of threads read (a band's
    halo rows each time), `k6_launches`, the K6 launches of the call, and
    `k6_narrow_products`, its products of at most NARROW columns, from the
    plans and shapes alone."""
    del image_h, image_w  # read from the images
    with span("serve.stem"):
        x = etiny_stem_int8(kparams, images, cfg)
    with span("serve.kernels") as sp:
        if sp.recording:
            sp.count(**_row_counts(kparams, x))
        # a stride-1 dense block keeps its dims: the engine's quirk is the
        # identity (stride-2 dense blocks were refused at parameter build)
        x = lb_blocks(x, kparams, cfg)
    with span("serve.tail"):
        return etiny_tail_logits(kparams, x, cfg)
