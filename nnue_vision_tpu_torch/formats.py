"""Byte-exact `.nnue` v2 / `.etiny` v1 model formats.

The port's own copy of `nnue_vision_tpu/formats.py`, so that the port
imports nothing of the JAX package; the two must write the same bytes
(`tests/test_torch_formats.py` holds them to that). The writers and
readers read the records by their fields, so records built by either
package serialize alike.

These are the on-disk contracts shared with the int8 C++ inference engine.
The layouts reproduce the reference serializer byte for byte
(reference: serialize.py:30-136 header+conv, :394-497 FT+layer stack,
:66-100,:139-186,:356-391 etiny; readers engine/src/nnue_engine.cpp:11-46,
:161-186, :283-380, :829-877, :1075-1211). Everything is little-endian.

Pure numpy — no JAX, no torch — so serialization is host-side and
deterministic. Arrays are stored C-contiguous in the exact dtype written.

Notable format facts (verified against the reference reader):

* The `.nnue` classifier is stored in a chess-legacy "layer stack"
  container: L1 gets a zero pad row (written as `(L2+1, L1)`), a 127·I
  "factorization" identity block of shape `(L1, L1)` follows, L2 is
  written `(L3, 2·L2)` with zeros in the second half, then the output
  layer `(num_classes, L3)`. Readers here undo the padding.
* `.etiny` conv layers carry TWO type tags: the outer sequence tag and an
  inner tag consumed by the conv reader (serialize.py:112 writes the inner
  one inside `write_conv_layer`).
* FT weights are int8-valued but stored as int16 (serialize.py:408-412).
* LB/DLB biases on disk are always zero (BatchNorm is not folded by the
  reference; serialize.py:267-269,:183-186) — but the format carries them,
  so we preserve the fields.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from pathlib import Path
from typing import BinaryIO, List, Union

import numpy as np

NNUE_MAGIC = b"NNUE"
NNUE_VERSION = 2
ETINY_MAGIC = b"ETNY"
ETINY_VERSION = 1

# Layer type tags in the .etiny layer sequence.
LT_CONV = 0
LT_LB = 1
LT_DLB = 2
LT_LINEAR = 3

PathLike = Union[str, Path]


class FormatError(ValueError):
    """Raised when a model file violates the format contract."""


# ---------------------------------------------------------------------------
# low-level helpers
# ---------------------------------------------------------------------------


def _u32(f: BinaryIO) -> int:
    return struct.unpack("<I", f.read(4))[0]


def _f32(f: BinaryIO) -> float:
    return struct.unpack("<f", f.read(4))[0]


def _wu32(f: BinaryIO, v: int) -> None:
    f.write(struct.pack("<I", v))


def _wf32(f: BinaryIO, v: float) -> None:
    f.write(struct.pack("<f", float(v)))


def _read_arr(f: BinaryIO, dtype: str, shape: tuple) -> np.ndarray:
    n = int(np.prod(shape)) if shape else 1
    dt = np.dtype(dtype)
    buf = f.read(n * dt.itemsize)
    if len(buf) != n * dt.itemsize:
        raise FormatError(f"truncated file: wanted {n} x {dtype}")
    return np.frombuffer(buf, dtype=dt).reshape(shape).copy()


def _write_arr(f: BinaryIO, arr: np.ndarray, dtype: str) -> None:
    f.write(np.ascontiguousarray(arr, dtype=np.dtype(dtype)).tobytes())


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise FormatError(msg)


# ---------------------------------------------------------------------------
# quantized layer records
# ---------------------------------------------------------------------------


@dataclass
class QConv:
    """int8 3x3 conv over 3 input channels (reference conv contract)."""

    weight: np.ndarray  # int8 (out_c, in_c=3, 3, 3)
    bias: np.ndarray  # int32 (out_c,)
    scale: float = 64.0

    def validate(self) -> "QConv":
        _check(self.weight.ndim == 4, "conv weight must be 4-D")
        _check(self.weight.shape[1] == 3, "conv in_channels must be 3")
        _check(self.weight.shape[2:] == (3, 3), "conv kernel must be 3x3")
        _check(self.bias.shape == (self.weight.shape[0],), "conv bias shape")
        return self


@dataclass
class QFeatureTransformer:
    weight: np.ndarray  # int16 (num_features, l1); values fit int8 range
    bias: np.ndarray  # int32 (l1,)
    scale: float = 64.0

    def validate(self) -> "QFeatureTransformer":
        _check(self.weight.ndim == 2, "FT weight must be 2-D")
        _check(self.bias.shape == (self.weight.shape[1],), "FT bias shape")
        return self


@dataclass
class QLinear:
    weight: np.ndarray  # int8 (out_features, in_features)
    bias: np.ndarray  # int32 (out_features,)
    scale: float = 64.0

    def validate(self) -> "QLinear":
        _check(self.weight.ndim == 2, "linear weight must be 2-D")
        _check(self.bias.shape == (self.weight.shape[0],), "linear bias shape")
        return self


@dataclass
class QLBBlock:
    """Quantized LinearDepthwiseBlock (pw-expand → dw 3x3 → pw-project)."""

    pw_expand: np.ndarray  # int8 (mid, in)
    dw: np.ndarray  # int8 (mid, 3, 3)
    pw_project: np.ndarray  # int8 (out, mid)
    stride: int = 1
    is_dense: bool = False  # True → serialized with the DLB tag
    pw_expand_scale: float = 64.0
    dw_scale: float = 64.0
    pw_project_scale: float = 64.0
    # On-disk bias fields; the reference always writes zeros here.
    pw_expand_bias: np.ndarray = field(default=None)  # int32 (mid,)
    pw_project_bias: np.ndarray = field(default=None)  # int32 (out,)

    @property
    def in_channels(self) -> int:
        return int(self.pw_expand.shape[1])

    @property
    def mid_channels(self) -> int:
        return int(self.pw_expand.shape[0])

    @property
    def out_channels(self) -> int:
        return int(self.pw_project.shape[0])

    def validate(self) -> "QLBBlock":
        mid = self.mid_channels
        _check(self.dw.shape == (mid, 3, 3), "dw conv must be (mid, 3, 3)")
        _check(self.pw_project.shape[1] == mid, "pw_project in = mid")
        if self.pw_expand_bias is None:
            self.pw_expand_bias = np.zeros(mid, dtype=np.int32)
        if self.pw_project_bias is None:
            self.pw_project_bias = np.zeros(self.out_channels, dtype=np.int32)
        return self


# ---------------------------------------------------------------------------
# whole-model records
# ---------------------------------------------------------------------------


@dataclass
class QuantizedNNUE:
    """Everything a `.nnue` v2 file carries, in logical (unpadded) form."""

    grid_size: int
    num_features_per_square: int
    l1: int
    l2: int
    l3: int
    nnue2score: float
    visual_threshold: float
    conv: QConv
    ft: QFeatureTransformer
    fc1: QLinear  # l1 -> l2
    fc2: QLinear  # l2 -> l3
    out: QLinear  # l3 -> num_classes
    quantized_one: float = 127.0

    @property
    def num_features(self) -> int:
        return self.grid_size * self.grid_size * self.num_features_per_square

    @property
    def num_classes(self) -> int:
        return int(self.out.weight.shape[0])

    def validate(self) -> "QuantizedNNUE":
        for layer in (self.conv, self.ft, self.fc1, self.fc2, self.out):
            layer.validate()
        _check(
            self.ft.weight.shape == (self.num_features, self.l1),
            f"FT shape {self.ft.weight.shape} != ({self.num_features}, {self.l1})",
        )
        _check(self.fc1.weight.shape == (self.l2, self.l1), "fc1 shape")
        _check(self.fc2.weight.shape == (self.l3, self.l2), "fc2 shape")
        _check(self.out.weight.shape[1] == self.l3, "out in_features")
        _check(
            self.conv.weight.shape[0] == self.num_features_per_square,
            "conv out_channels must equal features per square",
        )
        return self


@dataclass
class QuantizedEtinyNet:
    """Everything a `.etiny` v1 file carries."""

    variant: str
    num_classes: int
    input_size: int
    conv_channels: int
    final_channels: int
    stem: QConv
    blocks: List[QLBBlock]
    classifier: QLinear
    use_asq: bool = False
    asq_bits: int = 4
    lambda_param: float = 2.0

    def validate(self) -> "QuantizedEtinyNet":
        self.stem.validate()
        for b in self.blocks:
            b.validate()
        self.classifier.validate()
        _check(
            self.classifier.weight.shape[0] == self.num_classes,
            "classifier rows must equal num_classes",
        )
        return self


# ---------------------------------------------------------------------------
# .nnue v2
# ---------------------------------------------------------------------------


def _write_conv_payload(f: BinaryIO, conv: QConv) -> None:
    """Write a conv layer in the byte order the ENGINE actually reads.

    Quirk preserved deliberately: the reference serializer writes weights in
    torch (out, in, kh, kw) order (serialize.py:123-128) but the engine
    indexes the same bytes as (out, kh, kw, in)
    (nnue_engine.cpp:69: `((out_c*3 + kh)*3 + kw)*in_channels + in_c`) —
    the reference thus feeds the engine permuted kernels, one of the root
    causes of its approximate parity. We hold `QConv.weight` in true OIHW
    semantics and permute at the byte boundary so the engine computes the
    conv the model intends. Header dims are written exactly as the reference
    does (the reader only validates in=3, k=3x3).
    """
    _wu32(f, 0)  # inner STANDARD_CONV tag
    _wf32(f, conv.scale)
    out_c, in_c, kh, kw = conv.weight.shape
    for v in (out_c, in_c, kh, kw):
        _wu32(f, v)
    _write_arr(f, conv.weight.transpose(0, 2, 3, 1), "i1")  # (out, kh, kw, in)
    _wu32(f, out_c)
    _write_arr(f, conv.bias, "<i4")


def _read_conv_payload(f: BinaryIO) -> QConv:
    inner = _u32(f)
    _check(inner == 0, f"unexpected inner conv tag {inner}")
    scale = _f32(f)
    out_c, in_c, kh, kw = (_u32(f) for _ in range(4))
    _check(in_c == 3 and kh == 3 and kw == 3, "conv must be 3ch 3x3")
    # Bytes are engine order (out, kh, kw, in); return true OIHW.
    weight = _read_arr(f, "i1", (out_c, kh, kw, in_c)).transpose(0, 3, 1, 2)
    bias_count = _u32(f)
    _check(bias_count == out_c, "conv bias count mismatch")
    bias = _read_arr(f, "<i4", (out_c,))
    return QConv(weight=np.ascontiguousarray(weight), bias=bias, scale=scale)


def write_nnue(model: QuantizedNNUE, path: PathLike) -> None:
    """Write a `.nnue` v2 file byte-identical to the reference layout."""
    model.validate()
    l1, l2, l3 = model.l1, model.l2, model.l3
    with open(path, "wb") as f:
        f.write(NNUE_MAGIC)
        _wu32(f, NNUE_VERSION)
        _wu32(f, model.num_features)
        _wu32(f, l1)
        _wu32(f, l2)
        _wu32(f, l3)
        _wu32(f, 1)  # num_ls_buckets (always 1 in this architecture)
        _wf32(f, model.nnue2score)
        _wf32(f, model.quantized_one)
        _wf32(f, model.visual_threshold)

        _write_conv_payload(f, model.conv)

        # Feature transformer: int8-valued weights stored as int16.
        _wf32(f, model.ft.scale)
        _wu32(f, model.num_features)
        _wu32(f, l1)
        _write_arr(f, model.ft.weight, "<i2")
        _wu32(f, l1)
        _write_arr(f, model.ft.bias, "<i4")

        # Layer stack container.
        _wf32(f, model.fc1.scale)  # l1_scale
        _wf32(f, model.fc2.scale)  # l2_scale
        _wf32(f, model.out.scale)  # output_scale
        _wf32(f, model.fc1.scale)  # l1_fact_scale (mirrors l1)

        # L1 with a zero pad row: (l2 + 1, l1).
        _wu32(f, l2 + 1)
        _wu32(f, l1)
        padded_w = np.zeros((l2 + 1, l1), dtype=np.int8)
        padded_w[:l2] = model.fc1.weight
        _write_arr(f, padded_w, "i1")
        _wu32(f, l2 + 1)
        padded_b = np.zeros(l2 + 1, dtype=np.int32)
        padded_b[:l2] = model.fc1.bias
        _write_arr(f, padded_b, "<i4")

        # Factorization block: 127 * identity, zero bias.
        _wu32(f, l1)
        _wu32(f, l1)
        _write_arr(f, np.eye(l1, dtype=np.int8) * 127, "i1")
        _wu32(f, l1)
        _write_arr(f, np.zeros(l1, dtype=np.int32), "<i4")

        # L2 doubled on the input side: (l3, 2*l2), second half zero.
        _wu32(f, l3)
        _wu32(f, 2 * l2)
        wide = np.zeros((l3, 2 * l2), dtype=np.int8)
        wide[:, :l2] = model.fc2.weight
        _write_arr(f, wide, "i1")
        _wu32(f, l3)
        _write_arr(f, model.fc2.bias, "<i4")

        # Output layer.
        _wu32(f, model.num_classes)
        _wu32(f, l3)
        _write_arr(f, model.out.weight, "i1")
        _wu32(f, model.num_classes)
        _write_arr(f, model.out.bias, "<i4")


def read_nnue(path: PathLike) -> QuantizedNNUE:
    """Read a `.nnue` v2 file back into logical (unpadded) form."""
    with open(path, "rb") as f:
        _check(f.read(4) == NNUE_MAGIC, "bad .nnue magic")
        _check(_u32(f) == NNUE_VERSION, "unsupported .nnue version")
        num_features = _u32(f)
        l1, l2, l3 = _u32(f), _u32(f), _u32(f)
        buckets = _u32(f)
        _check(buckets == 1, f"expected 1 layer-stack bucket, got {buckets}")
        nnue2score = _f32(f)
        quantized_one = _f32(f)
        visual_threshold = _f32(f)

        conv = _read_conv_payload(f)
        ch = conv.weight.shape[0]
        _check(num_features % ch == 0, "features not divisible by channels")
        grid = int(round((num_features // ch) ** 0.5))
        _check(grid * grid * ch == num_features, "non-square feature grid")

        ft_scale = _f32(f)
        _check(_u32(f) == num_features and _u32(f) == l1, "FT dims mismatch")
        ft_weight = _read_arr(f, "<i2", (num_features, l1))
        _check(_u32(f) == l1, "FT bias count mismatch")
        ft_bias = _read_arr(f, "<i4", (l1,))

        l1_scale, l2_scale, out_scale, _l1_fact_scale = (
            _f32(f),
            _f32(f),
            _f32(f),
            _f32(f),
        )
        l1_out, l1_in = _u32(f), _u32(f)
        _check(l1_out == l2 + 1 and l1_in == l1, "layer-stack L1 dims")
        fc1_w = _read_arr(f, "i1", (l1_out, l1_in))[:l2]
        _check(_u32(f) == l1_out, "L1 bias count")
        fc1_b = _read_arr(f, "<i4", (l1_out,))[:l2]

        fact_out, fact_in = _u32(f), _u32(f)
        _check(fact_in == l1 and fact_out == l1, "factorization dims")
        f.seek(fact_out * fact_in, 1)  # skip 127*I weights
        _check(_u32(f) == l1, "factorization bias count")
        f.seek(l1 * 4, 1)  # skip zero biases

        l2_out, l2_in = _u32(f), _u32(f)
        _check(l2_out == l3 and l2_in == 2 * l2, "layer-stack L2 dims")
        fc2_w = _read_arr(f, "i1", (l3, 2 * l2))[:, :l2]
        _check(_u32(f) == l3, "L2 bias count")
        fc2_b = _read_arr(f, "<i4", (l3,))

        out_out, out_in = _u32(f), _u32(f)
        _check(out_in == l3, "output layer in_features")
        out_w = _read_arr(f, "i1", (out_out, out_in))
        _check(_u32(f) == out_out, "output bias count")
        out_b = _read_arr(f, "<i4", (out_out,))

    return QuantizedNNUE(
        grid_size=grid,
        num_features_per_square=ch,
        l1=l1,
        l2=l2,
        l3=l3,
        nnue2score=nnue2score,
        visual_threshold=visual_threshold,
        quantized_one=quantized_one,
        conv=conv,
        ft=QFeatureTransformer(weight=ft_weight, bias=ft_bias, scale=ft_scale),
        fc1=QLinear(weight=fc1_w, bias=fc1_b, scale=l1_scale),
        fc2=QLinear(weight=fc2_w, bias=fc2_b, scale=l2_scale),
        out=QLinear(weight=out_w, bias=out_b, scale=out_scale),
    ).validate()


# ---------------------------------------------------------------------------
# .etiny v1
# ---------------------------------------------------------------------------


def write_etiny(model: QuantizedEtinyNet, path: PathLike) -> None:
    """Write a `.etiny` v1 file byte-identical to the reference layout."""
    model.validate()
    with open(path, "wb") as f:
        f.write(ETINY_MAGIC)
        _wu32(f, ETINY_VERSION)
        variant = model.variant.encode("utf-8")
        _wu32(f, len(variant))
        f.write(variant)
        _wu32(f, model.num_classes)
        _wu32(f, model.input_size)
        _wu32(f, model.conv_channels)
        _wu32(f, model.final_channels)
        f.write(struct.pack("<?", model.use_asq))
        if model.use_asq:
            _wu32(f, model.asq_bits)
            _wf32(f, model.lambda_param)

        # stem + blocks + classifier
        _wu32(f, 1 + len(model.blocks) + 1)

        _wu32(f, LT_CONV)
        _write_conv_payload(f, model.stem)

        for blk in model.blocks:
            _wu32(f, LT_DLB if blk.is_dense else LT_LB)
            _wf32(f, blk.pw_expand_scale)
            _wf32(f, blk.dw_scale)
            _wf32(f, blk.pw_project_scale)
            _wu32(f, blk.in_channels)
            _wu32(f, blk.mid_channels)
            _wu32(f, blk.out_channels)
            _wu32(f, blk.stride)
            _write_arr(f, blk.pw_expand, "i1")
            _wu32(f, blk.mid_channels)
            _write_arr(f, blk.pw_expand_bias, "<i4")
            _write_arr(f, blk.dw, "i1")
            _write_arr(f, blk.pw_project, "i1")
            _wu32(f, blk.out_channels)
            _write_arr(f, blk.pw_project_bias, "<i4")

        _wu32(f, LT_LINEAR)
        _wf32(f, model.classifier.scale)
        _wu32(f, model.classifier.weight.shape[1])
        _wu32(f, model.classifier.weight.shape[0])
        _write_arr(f, model.classifier.weight, "i1")
        _wu32(f, model.classifier.weight.shape[0])
        _write_arr(f, model.classifier.bias, "<i4")


def read_etiny(path: PathLike) -> QuantizedEtinyNet:
    """Read a `.etiny` v1 file."""
    with open(path, "rb") as f:
        _check(f.read(4) == ETINY_MAGIC, "bad .etiny magic")
        _check(_u32(f) == ETINY_VERSION, "unsupported .etiny version")
        variant = f.read(_u32(f)).decode("utf-8")
        num_classes = _u32(f)
        input_size = _u32(f)
        conv_channels = _u32(f)
        final_channels = _u32(f)
        (use_asq,) = struct.unpack("<?", f.read(1))
        asq_bits, lambda_param = 4, 2.0
        if use_asq:
            asq_bits = _u32(f)
            lambda_param = _f32(f)

        total_layers = _u32(f)
        stem = None
        blocks: List[QLBBlock] = []
        classifier = None
        for _ in range(total_layers):
            tag = _u32(f)
            if tag == LT_CONV:
                stem = _read_conv_payload(f)
            elif tag in (LT_LB, LT_DLB):
                s0, s1, s2 = _f32(f), _f32(f), _f32(f)
                in_c, mid_c, out_c, stride = (_u32(f) for _ in range(4))
                pw_expand = _read_arr(f, "i1", (mid_c, in_c))
                _check(_u32(f) == mid_c, "LB pw_expand bias count")
                pw_expand_bias = _read_arr(f, "<i4", (mid_c,))
                dw = _read_arr(f, "i1", (mid_c, 3, 3))
                pw_project = _read_arr(f, "i1", (out_c, mid_c))
                _check(_u32(f) == out_c, "LB pw_project bias count")
                pw_project_bias = _read_arr(f, "<i4", (out_c,))
                blocks.append(
                    QLBBlock(
                        pw_expand=pw_expand,
                        dw=dw,
                        pw_project=pw_project,
                        stride=stride,
                        is_dense=(tag == LT_DLB),
                        pw_expand_scale=s0,
                        dw_scale=s1,
                        pw_project_scale=s2,
                        pw_expand_bias=pw_expand_bias,
                        pw_project_bias=pw_project_bias,
                    )
                )
            elif tag == LT_LINEAR:
                scale = _f32(f)
                in_f, out_f = _u32(f), _u32(f)
                weight = _read_arr(f, "i1", (out_f, in_f))
                _check(_u32(f) == out_f, "linear bias count")
                bias = _read_arr(f, "<i4", (out_f,))
                classifier = QLinear(weight=weight, bias=bias, scale=scale)
            else:
                raise FormatError(f"unknown .etiny layer tag {tag}")

        _check(stem is not None, "missing stem conv")
        _check(classifier is not None, "missing classifier")

    return QuantizedEtinyNet(
        variant=variant,
        num_classes=num_classes,
        input_size=input_size,
        conv_channels=conv_channels,
        final_channels=final_channels,
        stem=stem,
        blocks=blocks,
        classifier=classifier,
        use_asq=bool(use_asq),
        asq_bits=asq_bits,
        lambda_param=lambda_param,
    ).validate()
