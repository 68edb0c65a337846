"""The reference's warp against the program's, on the CPU: the choice
between two passes and the gather by JAX `_warp`'s size rule; past the
rule the program's draws carry the reference's inverse map and the
reference's gather is the program's `warp_gather`; and at 32×32 the
medium and heavy tiers draw and make what the two-pass path alone did."""

from __future__ import annotations

import pytest
import torch

from nnue_vision_tpu_torch.data import augment as prog
from perfbench.reference import augment as ref

B = 4
TIERS = ("medium", "heavy")


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _images(side):
    return torch.rand((B, side, side, 3), generator=_gen(1))


@pytest.mark.parametrize("side", (32, 48, 64, 224))
def test_choice_of_warp_is_the_programs(side):
    assert ref.two_pass(side, side) == prog.two_pass_warp(side, side)
    assert ref.two_pass(side, side) == (side <= 50)
    assert not ref.two_pass(side, side + 1)


@pytest.mark.parametrize("side", (64, 224))
@pytest.mark.parametrize("tier", TIERS)
def test_gather_past_the_rule_is_the_programs(side, tier):
    blocks = getattr(ref, f"draw_{tier}")(_gen(side), B, side, side)
    x = _images(side)
    for (m, v), _, _ in blocks:
        got = ref.warp(x, (m, v))
        want = prog.warp_gather(x, prog.pack_gather_params(m, v))
        assert float((got - want).abs().max()) <= 1e-6


@pytest.mark.parametrize("side", (32, 64))
@pytest.mark.parametrize("tier", TIERS)
def test_programs_draws_carry_the_references_warp(side, tier):
    """The warp params of the program's packed draws (one host call a
    chunk) are the reference's, packed as the program packs them."""
    blocks = getattr(ref, f"draw_{tier}")(_gen(9), B, side, side)
    draws = prog.batch_draws(prog.draw_batch(_gen(9), tier, B, side, side),
                             tier, B)
    got = [draws.warp1] + ([draws.warp2] if tier == "heavy" else [])
    for (wp, _, _), packed in zip(blocks, got, strict=True):
        if prog.two_pass_warp(side, side):  # [swap, coef1, coef2, 0]
            assert torch.equal(packed[:, :7], wp) and not packed[:, 7].any()
        else:
            assert torch.equal(packed, prog.pack_gather_params(*wp))


def _two_pass_draws(tier, gen, side):
    """The tiers' draws as the reference made them at every size before it
    followed the size rule: two-pass coefficients in each block."""
    def coef(mv):
        return ref._warp_coefficients(*mv, side, side)
    blocks = [(coef(ref._geometry(gen, B, side, side, 0.5, 0.5, 0.3, 15.0,
                                  0.1, 0.9, 1.1)),
               *ref._medium_photometric(gen, B, side, side))]
    if tier == "heavy":
        blocks.append((coef(ref._geometry(gen, B, side, side, 0.1, 0.1, 0.2,
                                          25.0, 0.15, 0.85, 1.15)),
                       *ref._heavy_photometric(gen, B, side, side)))
    return blocks


def _two_pass_apply(x, blocks, noise_gen):
    x = x.float()
    for k, (wp, fp, ip) in enumerate(blocks):
        x = ref._two_pass_warp(x, wp)
        noise = torch.randn(x.shape, generator=noise_gen, dtype=torch.float32)
        x = ref.photometric(x, noise, fp, ip, medium=k == 0)
    return x


@pytest.mark.parametrize("tier", TIERS)
def test_within_the_rule_nothing_changes(tier):
    side = 32
    gen, old_gen = _gen(5), _gen(5)
    blocks = getattr(ref, f"draw_{tier}")(gen, B, side, side)
    old = _two_pass_draws(tier, old_gen, side)
    assert torch.equal(gen.get_state(), old_gen.get_state())
    for block, old_block in zip(blocks, old, strict=True):
        assert all(torch.equal(a, b) for a, b in zip(block, old_block,
                                                     strict=True))
    x = _images(side)
    got = getattr(ref, f"apply_{tier}")(x, blocks, _gen(3))
    assert torch.equal(got, _two_pass_apply(x, old, _gen(3)))
