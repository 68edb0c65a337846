"""The port's serializer CLI (`nnue_vision_tpu_torch/serialize.py`) held to
the repository's root `serialize.py` (the JAX package's, run on the CPU):
byte-identical `.nnue`/`.etiny` files from the port's checkpoints, the JAX
package's and upstream torch files; the EtinyNet deployment warning and
`--force`; `detect_model_type` and `infer_nnue_config`; one run of the
CLI as a subprocess."""

import dataclasses
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from nnue_vision_tpu.models import etinynet as jetiny
from nnue_vision_tpu.models import nnue as jnnue
from nnue_vision_tpu.training import checkpoint as jckpt
from nnue_vision_tpu_torch import serialize as tser
from nnue_vision_tpu_torch.bridge import nnue_from_jax_params
from nnue_vision_tpu_torch.models import etinynet as tetiny
from nnue_vision_tpu_torch.models import nnue as tnnue
from nnue_vision_tpu_torch.training import checkpoint as tckpt
from tests.test_torch_upstream_import import (
    upstream_etinynet_state_dict,
    upstream_nnue_state_dict,
)

REPO = Path(__file__).resolve().parent.parent
NNUE_CFG = tnnue.NNUEConfig(feature_set=tnnue.GridFeatureSet(4, 6), l1_size=16,
                            l2_size=8, l3_size=4, num_classes=3, input_size=12,
                            qat=True)


def _root():
    """The repository's root `serialize` module (the JAX package's CLI)."""
    sys.path.insert(0, str(REPO))
    try:
        import serialize
    finally:
        sys.path.remove(str(REPO))
    return serialize


def _nnue_params(seed):
    rng = np.random.default_rng(seed)

    def u(shape, fan_in):
        b = 1.0 / math.sqrt(fan_in)
        return rng.uniform(-b, b, shape).astype(np.float32)

    return {
        "conv_w": u((6, 3, 3, 3), 27),
        "visual_threshold": rng.uniform(0.05, 0.15, 6).astype(np.float32),
        "ft_w": (rng.standard_normal((96, 16)) * 0.3).astype(np.float32),
        "ft_b": (rng.standard_normal(16) * 0.05).astype(np.float32),
        "fc1_w": u((8, 16), 4), "fc1_b": u((8,), 16),
        "fc2_w": u((4, 8), 8), "fc2_b": u((4,), 8),
        "out_w": u((3, 4), 4), "out_b": u((3,), 4),
        "nnue2score": np.float32(612.5),
    }


def _port_nnue_ckpt(path, seed=0):
    model = nnue_from_jax_params(_nnue_params(seed), NNUE_CFG, device="cpu")
    tckpt.save_checkpoint(path, model_type="nnue", model_config=NNUE_CFG,
                          model=model, epoch=3, metrics={"val_f1": 0.5})
    return path


def _port_etiny_ckpt(path, engine_friendly, seed=0):
    cfg = tetiny.EtinyNetConfig(variant="micro", num_classes=10, input_size=32,
                                engine_friendly=engine_friendly)
    model = tetiny.etinynet_init(cfg, torch.Generator().manual_seed(seed),
                                 device="cpu")
    with torch.no_grad():  # non-trivial norms and LSQ scales
        g = torch.Generator().manual_seed(seed + 1)
        for name, t in model.state_dict().items():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("mean", "bias", "qlog1", "qlog2", "final_qlog"):
                t.copy_(torch.rand(t.shape, generator=g) * 0.6 - 0.3)
            elif leaf in ("var", "scale"):
                t.copy_(torch.rand(t.shape, generator=g) + 0.5)
    tckpt.save_checkpoint(path, model_type="etinynet", model_config=cfg,
                          model=model, epoch=1, metrics={})
    return path


def _both(src, tmp_path, suffix, **kw):
    """(the port's bytes, the root CLI's bytes)."""
    ours = tser.serialize_checkpoint(src, tmp_path / f"port{suffix}",
                                     device="cpu", **kw)
    theirs = _root().serialize_checkpoint(src, tmp_path / f"root{suffix}", **kw)
    assert ours.suffix == theirs.suffix == suffix
    return ours.read_bytes(), theirs.read_bytes()


@pytest.mark.parametrize("qat", [True, False])
def test_port_nnue_checkpoint_bytes_equal_root(tmp_path, qat):
    cfg = dataclasses.replace(NNUE_CFG, qat=qat)
    model = nnue_from_jax_params(_nnue_params(1), cfg, device="cpu")
    src = tmp_path / "best_model.ckpt"
    tckpt.save_checkpoint(src, model_type="nnue", model_config=cfg, model=model,
                          epoch=0, metrics={})
    ours, theirs = _both(src, tmp_path, ".nnue")
    assert ours == theirs


@pytest.mark.parametrize("engine_friendly", [True, False], ids=["ef", "plain"])
def test_port_etinynet_checkpoint_bytes_equal_root(tmp_path, engine_friendly):
    src = _port_etiny_ckpt(tmp_path / "best_model.ckpt", engine_friendly, seed=2)
    ours, theirs = _both(src, tmp_path, ".etiny", force=True)
    assert ours == theirs


def test_jax_checkpoints_bytes_equal_root(tmp_path):
    """The JAX package's own best-model checkpoints, NNUE and EtinyNet."""
    jcfg = jnnue.NNUEConfig(feature_set=jnnue.GridFeatureSet(4, 6), l1_size=16,
                            l2_size=8, l3_size=4, num_classes=3, input_size=12)
    src = tmp_path / "jax_nnue.ckpt"
    jckpt.save_checkpoint(src, model_type="nnue", model_config=jcfg, epoch=0,
                          metrics={}, params=jax.device_get(
                              jnnue.nnue_init(jax.random.PRNGKey(3), jcfg)))
    ours, theirs = _both(src, tmp_path, ".nnue")
    assert ours == theirs

    ecfg = jetiny.EtinyNetConfig(variant="micro", num_classes=10, input_size=32)
    params, stats = jax.device_get(jetiny.etinynet_init(jax.random.PRNGKey(4), ecfg))
    src = tmp_path / "jax_etiny.ckpt"
    jckpt.save_checkpoint(src, model_type="etinynet", model_config=ecfg, epoch=0,
                          metrics={}, params=params, batch_stats=stats)
    ours, theirs = _both(src, tmp_path, ".etiny", force=True)
    assert ours == theirs


def test_upstream_files_bytes_equal_root(tmp_path):
    src = tmp_path / "upstream_nnue.pt"
    torch.save({"state_dict": upstream_nnue_state_dict(seed=5)}, src)
    ours, theirs = _both(src, tmp_path, ".nnue")
    assert ours == theirs
    src = tmp_path / "upstream_etiny.pt"
    torch.save(upstream_etinynet_state_dict("micro", seed=6), src)
    ours, theirs = _both(src, tmp_path, ".etiny", force=True)
    assert ours == theirs


def test_nnue_checkpoint_without_config_is_inferred(tmp_path):
    """A bare params payload: the config comes from the shapes, as in the
    root CLI."""
    src = tmp_path / "bare.ckpt"
    with open(src, "wb") as f:
        import pickle

        pickle.dump({"params": _nnue_params(7)}, f, protocol=pickle.HIGHEST_PROTOCOL)
    model_type, model, cfg = tser.load_checkpoint_auto(src, device="cpu")
    assert model_type == "nnue" and cfg.feature_set == tnnue.GridFeatureSet(4, 6)
    ours, theirs = _both(src, tmp_path, ".nnue")
    assert ours == theirs


def test_etinynet_warning_and_force(tmp_path, capsys):
    plain = _port_etiny_ckpt(tmp_path / "plain.ckpt", engine_friendly=False)
    ef = _port_etiny_ckpt(tmp_path / "ef.ckpt", engine_friendly=True)
    tser.serialize_checkpoint(plain, tmp_path / "a.etiny", device="cpu")
    assert tser.ETINY_TRAP_WARNING in capsys.readouterr().err
    assert tser.ETINY_TRAP_WARNING == _root().ETINY_TRAP_WARNING
    tser.serialize_checkpoint(plain, tmp_path / "b.etiny", force=True, device="cpu")
    tser.serialize_checkpoint(ef, tmp_path / "c.etiny", device="cpu")
    assert "WARNING" not in capsys.readouterr().err
    # the warned file is written all the same
    assert (tmp_path / "a.etiny").read_bytes() == (tmp_path / "b.etiny").read_bytes()


def test_suffix_follows_the_model_type(tmp_path):
    src = _port_nnue_ckpt(tmp_path / "m.ckpt")
    assert tser.serialize_checkpoint(src, tmp_path / "out.xyz",
                                     device="cpu").name == "out.nnue"
    assert tser.serialize_checkpoint(src, tmp_path / "out.bin",
                                     device="cpu").name == "out.bin"


PAYLOADS = {
    "explicit-nnue": {"model_type": "nnue", "params": {}},
    "explicit-etinynet": {"model_type": "etinynet", "params": {}},
    "nnue-by-keys": {"params": {"ft_w": 0, "conv_w": 0}},
    "nnue-by-threshold": {"visual_threshold": 0},
    "etinynet-by-stem": {"params": {"stem_w": 0}},
    "etinynet-by-blocks": {"blocks": []},
}


@pytest.mark.parametrize("name", list(PAYLOADS))
def test_detect_model_type_matches_root(name):
    assert tser.detect_model_type(PAYLOADS[name]) == \
        _root().detect_model_type(PAYLOADS[name])


def test_detect_model_type_raises_like_root():
    for mod in (tser, _root()):
        with pytest.raises(ValueError, match="cannot determine model type"):
            mod.detect_model_type({"params": {"foo": 1}})


def test_infer_nnue_config_matches_root():
    p = _nnue_params(8)
    ours, theirs = tser.infer_nnue_config(p), _root().infer_nnue_config(p)
    assert (ours.feature_set.grid_size, ours.feature_set.num_features_per_square,
            ours.l1_size, ours.l2_size, ours.l3_size, ours.num_classes) == (
        theirs.feature_set.grid_size, theirs.feature_set.num_features_per_square,
        theirs.l1_size, theirs.l2_size, theirs.l3_size, theirs.num_classes)
    bad = dict(p, ft_w=np.zeros((97, 16), np.float32))
    for mod in (tser, _root()):
        with pytest.raises(ValueError, match="cannot infer grid"):
            mod.infer_nnue_config(bad)


def test_cli_subprocess_writes_the_root_bytes(tmp_path):
    src = _port_nnue_ckpt(tmp_path / "best_model.ckpt", seed=9)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, "-m", "nnue_vision_tpu_torch.serialize", str(src),
         str(tmp_path / "cli.nnue"), "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "Serialization complete!" in proc.stdout
    theirs = _root().serialize_checkpoint(src, tmp_path / "root.nnue")
    assert (tmp_path / "cli.nnue").read_bytes() == theirs.read_bytes()
