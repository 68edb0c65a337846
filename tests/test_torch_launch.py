"""The one launch convention of the port's kernels, on the CPU.

Every launcher that `csrc/*.cu` exports takes one packed `const int64_t*`
(`csrc/launch_args.cuh` reads it in order), and `ops/_build.py` `launch`
is the one Python path to them: it packs the arguments and the current
stream's handle, raises on an error with the library's text, and counts
the launch. A float32 argument is its bits in a word's low 32 (`f32`).
The kernels themselves run only on a card (the `-m gpu` tests).
"""

import ctypes
import re
import struct
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from nnue_vision_tpu_torch.ops import _build, _ring
from nnue_vision_tpu_torch.ops import etiny_kernels as ek
from nnue_vision_tpu_torch.ops import nnue_kernels as nk

PKG = Path(__file__).resolve().parent.parent / "nnue_vision_tpu_torch"
LAUNCHERS = {
    "nnue_mega_launch", "nnue_mega_stage_launch", "nnue_head_launch",
    "light_pipeline_launch", "warp_launch", "lerp_pass_launch",
    "photometric_launch", "photometric_band_launch", "etiny_block_launch",
    "etiny_run_launch", "etiny_stem_launch", "etiny_tail_launch",
}


def _exported(src: str) -> str:
    """The text of a source's `extern "C"` blocks."""
    return "".join(re.findall(r'extern "C" \{(.*?)\}  // extern "C"', src,
                              flags=re.S))


def test_every_exported_launcher_takes_one_packed_array():
    found = {}
    for path in sorted((PKG / "csrc").glob("*.cu")):
        for name, params in re.findall(r"\bint (\w+_launch)\(([^)]*)\)",
                                       _exported(path.read_text())):
            found[name] = " ".join(params.split())
    assert set(found) == LAUNCHERS
    for name, params in found.items():
        assert re.fullmatch(r"const int64_t\* \w+", params), (name, params)
    # the queries keep their typed signatures; no launcher is among them
    assert not any(name.endswith("_launch") for name in _build.SIGNATURES)


def test_one_launch_in_the_package():
    defs = [p.relative_to(PKG).as_posix()
            for p in PKG.rglob("*.py")
            if re.search(r"^def launch\(", p.read_text(), flags=re.M)]
    assert defs == ["ops/_build.py"]
    assert not hasattr(_ring, "launch") and not hasattr(_ring, "library")
    assert not hasattr(nk, "_launch") and not hasattr(ek, "_check_launch")
    for module in ("nnue_kernels", "etiny_kernels"):
        text = (PKG / "ops" / f"{module}.py").read_text()
        assert "current_stream(" not in text
        assert "load_library().lib" not in text


@pytest.mark.parametrize("x", [0.1, -1.0, -0.0, 1.0 / 64, 3, 1e-40,
                               float("inf"), 2.0**-126, 65504.0])
def test_a_float32_is_its_bits_in_the_low_word(x):
    word = _build.f32(x)
    assert 0 <= word < 2**32
    assert word == int(np.array(x, dtype=np.float32).view(np.uint32))
    # through an int64 argument word and back, as the launcher reads it
    buf = (ctypes.c_int64 * 1)(word)
    low = ctypes.c_uint32(buf[0] & 0xFFFFFFFF).value
    assert struct.unpack("<f", struct.pack("<I", low))[0] == np.float32(x)


def _fake_library(monkeypatch, err: int):
    """`launch`'s library and device calls, replaced: the launcher records
    the words it was handed and returns `err`."""
    seen = []

    def launcher(buf):
        seen.append(list(buf))
        return err

    lib = types.SimpleNamespace(nnue_error_string=lambda e: b"invalid argument")
    monkeypatch.setattr(_build, "_launcher", lambda name: launcher)
    monkeypatch.setattr(_build, "load_library",
                        lambda: types.SimpleNamespace(lib=lib))
    monkeypatch.setattr(_build, "_current_device", lambda: 0)
    monkeypatch.setattr(_build, "_raw_stream", lambda index: 0x5EED)
    return seen


def test_launch_packs_the_words_and_the_stream_and_counts(monkeypatch):
    seen = _fake_library(monkeypatch, 0)
    counters = {"k": 0}
    args = (0x7F0000001000, 8192, -1, _build.f32(0.5))
    _build.launch(torch.device("cuda", 0), counters, "k", "k_launch", args)
    assert seen[0][:len(args) + 1] == [*args, 0x5EED]
    assert counters == {"k": 1}
    # the widest launcher's words fit
    wide = tuple(range(_build.WORDS - 1))
    _build.launch(torch.device("cuda", 0), counters, "k", "k_launch", wide)
    assert seen[1] == [*wide, 0x5EED] and counters == {"k": 2}


def test_launch_raises_with_the_library_text_and_counts_nothing(monkeypatch):
    _fake_library(monkeypatch, 1)
    counters = {"k": 0}
    with pytest.raises(RuntimeError, match="^k launch failed: invalid argument$"):
        _build.launch(torch.device("cuda", 0), counters, "k", "k_launch", (1,))
    assert counters == {"k": 0}
