"""The port's own `.nnue` / `.etiny` formats and quantizers
(`nnue_vision_tpu_torch/formats.py`, `quantize.py`) against the JAX
package's: the writers give the same bytes for the same records, each
reader reads the other's file to the same arrays and header fields, and
the quantizers give the same integers."""

import dataclasses

import numpy as np
import pytest

from nnue_vision_tpu import formats as jformats
from nnue_vision_tpu import quantize as jquant
from nnue_vision_tpu_torch import formats as tformats
from nnue_vision_tpu_torch import quantize as tquant
from tests.conftest import random_quantized_etiny, random_quantized_nnue


def _assert_records_equal(got, ref):
    """Field by field, arrays by value (the two packages' record classes
    differ, so dataclass equality does not apply)."""
    assert type(got).__name__ == type(ref).__name__
    for f in dataclasses.fields(ref):
        g, r = getattr(got, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(r):
            _assert_records_equal(g, r)
        elif isinstance(r, list):
            assert len(g) == len(r)
            for gi, ri in zip(g, r):
                _assert_records_equal(gi, ri)
        elif isinstance(r, np.ndarray):
            assert g.dtype == r.dtype and g.shape == r.shape, f.name
            np.testing.assert_array_equal(g, r)
        elif isinstance(r, float):  # stored as float32 on disk
            assert np.float32(g) == np.float32(r), f.name
        else:
            assert g == r, f.name


@pytest.mark.parametrize("seed,thresh", [(0, 0.07), (1, -0.25), (2, 0.5)])
def test_nnue_bytes_and_readers_match(tmp_path, seed, thresh):
    q = random_quantized_nnue(np.random.default_rng(seed), grid=5, ch=8,
                              l1=32, visual_threshold=thresh)
    jformats.write_nnue(q, tmp_path / "jax.nnue")
    tformats.write_nnue(q, tmp_path / "port.nnue")
    assert (tmp_path / "port.nnue").read_bytes() == \
        (tmp_path / "jax.nnue").read_bytes()
    port_read = tformats.read_nnue(tmp_path / "jax.nnue")
    jax_read = jformats.read_nnue(tmp_path / "port.nnue")
    _assert_records_equal(port_read, q)
    _assert_records_equal(jax_read, port_read)
    # a record of the port's own class writes the same bytes again
    tformats.write_nnue(port_read, tmp_path / "again.nnue")
    assert (tmp_path / "again.nnue").read_bytes() == \
        (tmp_path / "jax.nnue").read_bytes()


@pytest.mark.parametrize("seed", [0, 1])
def test_etiny_bytes_and_readers_match(tmp_path, seed):
    q = random_quantized_etiny(np.random.default_rng(seed))
    jformats.write_etiny(q, tmp_path / "jax.etiny")
    tformats.write_etiny(q, tmp_path / "port.etiny")
    assert (tmp_path / "port.etiny").read_bytes() == \
        (tmp_path / "jax.etiny").read_bytes()
    port_read = tformats.read_etiny(tmp_path / "jax.etiny")
    _assert_records_equal(port_read, q)
    _assert_records_equal(jformats.read_etiny(tmp_path / "port.etiny"),
                          port_read)


def test_quantizers_match():
    rng = np.random.default_rng(7)
    x = np.concatenate([rng.normal(0, 1.5, 4096),
                        np.arange(-8, 8) / 128.0]).astype(np.float32)  # ties
    for fn in ("quantize_weight_i8", "quantize_bias_i32"):
        got, ref = getattr(tquant, fn)(x), getattr(jquant, fn)(x)
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(tquant.clip_unit(x), jquant.clip_unit(x))
    a = rng.integers(-10**6, 10**6, 1000).astype(np.int32)
    np.testing.assert_array_equal(tquant.trunc_div(a, 64), jquant.trunc_div(a, 64))
    assert (tquant.QUANT_SCALE, tquant.QUANTIZED_ONE) == \
        (jquant.QUANT_SCALE, jquant.QUANTIZED_ONE)


def test_reader_rejects_a_bad_magic(tmp_path):
    (tmp_path / "bad.nnue").write_bytes(b"XXXX" + bytes(64))
    with pytest.raises(tformats.FormatError):
        tformats.read_nnue(tmp_path / "bad.nnue")
