"""``repro_torch.models.blockcheck``: one block's backward on the card held
against the CPU's, every parameter's and the input's gradient within twice
a noise floor measured in the same run.

On the CPU the check's "card" is the CPU too, so every distance is 0; the
CPU tests show that it covers every leaf of each block kind and that a
fault on the checked side only (a dropped SSD gradient in the first two
backwards, the card's) fails it. Tests marked ``cuda`` run the check as
``chip_smoke.py`` phase 7c does, at full width, and with
``SSDFunction.backward`` dropping ddt for CUDA tensors: the check fails.

The kinds with cross attention, MLA and the MoE MLP (whisper-small's
``enc`` and ``dec_cross``, llama-vision's ``cross``, deepseek-v2's ``mla``
and mixtral's ``local`` with experts) are checked the same way, the
memory's gradient and the routing included: a dropped dv in the flash
backward (MLA's zero-padded v) fails the mla block, and a perturbation
large enough to move the routing fails the MoE block on "routing".

In bf16 (stablelm-3b's ``global`` block, hd 80, and hymba-1.5b's
``hybrid`` block: the flash kernels in bf16, the SSD in f32 as the model
casts it) the check covers every leaf the same way, with its noise floor
at bf16's scale, and the dropped SSD gradient fails it.
"""
import dataclasses

import pytest
import torch

from repro_torch import configs as TC
from repro_torch.models import reduce_config
from repro_torch.models.blockcheck import FLOOR_FACTOR, block_backward_check
from repro_torch.kernels.flash_attention import kernel as FA
from repro_torch.kernels.ssd import kernel as SK

KINDS = [("stablelm-3b", "global"), ("mamba2-370m", "ssm"),
         ("hymba-1.5b", "hybrid")]
BF16_KINDS = [("stablelm-3b", "global"), ("hymba-1.5b", "hybrid")]
MEMORY_MOE_KINDS = [("whisper-small", "enc"), ("whisper-small", "dec_cross"),
                    ("llama-3.2-vision-90b", "cross"),
                    ("deepseek-v2-236b", "mla"), ("mixtral-8x7b", "local")]


def _drop_ddt(monkeypatch, when):
    """SSDFunction.backward with ddt replaced by zeros where ``when(dy,
    call)`` holds (call counts from 1)."""
    orig = SK.SSDFunction.backward
    calls = []

    def faulty(ctx, dy, dstate):
        calls.append(1)
        grads = list(orig(ctx, dy, dstate))
        if when(dy, len(calls)):
            grads[1] = torch.zeros_like(grads[1])
        return tuple(grads)

    monkeypatch.setattr(SK.SSDFunction, "backward", staticmethod(faulty))
    return calls


@pytest.mark.parametrize("arch,kind", KINDS)
def test_check_covers_every_leaf_on_the_cpu(arch, kind):
    cfg = reduce_config(TC.get_config(arch))
    rep = block_backward_check(cfg, kind, "cpu", seq=32)
    assert rep["ok"] and not rep["failed"]
    assert "x" in rep["leaves"]
    assert any(k.startswith("ssm/") for k in rep["leaves"]) == (
        kind != "global")
    assert any(k.startswith("attn/") for k in rep["leaves"]) == (
        kind != "ssm")
    for row in rep["leaves"].values():
        assert row["max_abs_diff"] == 0.0 and row["finite"]
        assert row["noise_floor"] > 0.0


@pytest.mark.parametrize("arch,kind", BF16_KINDS)
def test_bf16_check_covers_every_leaf_on_the_cpu(arch, kind):
    """bf16: every leaf compared (bf16 gradients, distances in f32), card
    and CPU one computation here, the floor at perturb 2^-8 above 0."""
    cfg = reduce_config(TC.get_config(arch))
    rep = block_backward_check(cfg, kind, "cpu", seq=32,
                               dtype=torch.bfloat16)
    assert rep["ok"] and not rep["failed"]
    assert "x" in rep["leaves"]
    assert any(k.startswith("ssm/") for k in rep["leaves"]) == (
        kind == "hybrid")
    for row in rep["leaves"].values():
        assert row["max_abs_diff"] == 0.0 and row["finite"]
        assert row["noise_floor"] > 0.0


def test_bf16_check_fails_a_fault_on_the_checked_side(monkeypatch):
    """bf16 hybrid block, ddt dropped on the checked side only: the SSD's
    dt leaves and the input fail."""
    cfg = reduce_config(TC.get_config("hymba-1.5b"))
    calls = _drop_ddt(monkeypatch, lambda dy, n: n <= 2)
    rep = block_backward_check(cfg, "hybrid", "cpu", seq=32,
                               dtype=torch.bfloat16)
    assert len(calls) == 3
    assert not rep["ok"]
    assert {"ssm/dt_bias", "ssm/wdt", "x"} <= set(rep["failed"])


@pytest.mark.parametrize("arch,kind", KINDS[1:])
def test_check_fails_a_fault_on_the_checked_side(arch, kind, monkeypatch):
    """ddt dropped in the first two backwards (the checked one and its
    noise floor) and not in the third (the reference's): the SSD's dt
    leaves and the input fail."""
    cfg = reduce_config(TC.get_config(arch))
    calls = _drop_ddt(monkeypatch, lambda dy, n: n <= 2)
    rep = block_backward_check(cfg, kind, "cpu", seq=32)
    assert len(calls) == 3
    assert not rep["ok"]
    assert {"ssm/dt_bias", "ssm/wdt", "x"} <= set(rep["failed"])
    row = rep["leaves"]["ssm/wdt"]
    assert row["max_abs_diff"] > FLOOR_FACTOR * row["noise_floor"]


@pytest.mark.parametrize("arch,kind", MEMORY_MOE_KINDS)
def test_check_covers_memory_and_moe_kinds_on_the_cpu(arch, kind):
    cfg = reduce_config(TC.get_config(arch))
    rep = block_backward_check(cfg, kind, "cpu", seq=32)
    assert rep["ok"] and not rep["failed"] and rep["routing_equal"]
    assert "x" in rep["leaves"]
    assert ("memory" in rep["leaves"]) == (kind in ("cross", "dec_cross"))
    assert any(k.startswith("moe/") for k in rep["leaves"]) == bool(
        cfg.n_experts)
    assert (rep["min_gate_gap"] is not None) == bool(cfg.n_experts)
    for row in rep["leaves"].values():
        assert row["max_abs_diff"] == 0.0 and row["finite"]


def _drop_dv(monkeypatch, when):
    """FlashAttentionFunction.backward with dv replaced by zeros where
    ``when(call)`` holds (call counts from 1)."""
    orig = FA.FlashAttentionFunction.backward
    calls = []

    def faulty(ctx, dout):
        calls.append(1)
        grads = list(orig(ctx, dout))
        if when(len(calls)):
            grads[2] = torch.zeros_like(grads[2])
        return tuple(grads)

    monkeypatch.setattr(FA.FlashAttentionFunction, "backward",
                        staticmethod(faulty))
    return calls


def test_check_fails_a_dropped_dv_in_mla(monkeypatch):
    """dv dropped in the first two backwards (the checked one and its noise
    floor): MLA's wv_b, whose gradient comes only through the padded v,
    fails."""
    cfg = reduce_config(TC.get_config("deepseek-v2-236b"))
    calls = _drop_dv(monkeypatch, lambda n: n <= 2)
    rep = block_backward_check(cfg, "mla", "cpu", seq=32)
    assert len(calls) == 3 and not rep["ok"]
    assert "mla/wv_b" in rep["failed"]


def test_check_fails_on_a_routing_change():
    """Weights moved far enough to change some token's experts: the check
    fails on the routing before any gradient, and reports the smallest
    gap between a token's k-th and (k+1)-th gate."""
    cfg = reduce_config(TC.get_config("mixtral-8x7b"))
    rep = block_backward_check(cfg, "local", "cpu", seq=32, perturb=0.5)
    assert not rep["routing_equal"] and rep["failed"][0] == "routing"
    assert 0 <= rep["min_gate_gap"] < 1


# ------------------------------ on the card -----------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels are CUDA C++ for "
                    "sm_90a, built with nvcc, with no interpret mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("arch,kind", KINDS)
def test_cuda_block_backward_matches_cpu(card, arch, kind):
    """A full-width block, B 1 x S 2048, f32: every gradient within twice
    its noise floor of the CPU's."""
    rep = block_backward_check(TC.get_config(arch), kind, card)
    assert rep["ok"], rep["failed"]


@pytest.mark.cuda
@pytest.mark.parametrize("arch,kind", BF16_KINDS)
def test_cuda_bf16_block_backward_matches_cpu(card, arch, kind):
    """A full-width bf16 block, B 1 x S 2048 (the bf16 flash kernels,
    forward with lse and backward): every gradient within twice its noise
    floor (perturb 2^-8) of the CPU's."""
    rep = block_backward_check(TC.get_config(arch), kind, card,
                               dtype=torch.bfloat16)
    assert rep["ok"], rep["failed"]


@pytest.mark.cuda
@pytest.mark.parametrize("arch,kind", KINDS[1:])
def test_cuda_block_check_catches_a_dropped_ssd_gradient(card, arch, kind,
                                                        monkeypatch):
    """SSDFunction's backward dropping ddt on the card only (a fault in the
    glue around the SSD kernels): the full-width check fails, naming the
    dt leaves and the input."""
    _drop_ddt(monkeypatch, lambda dy, n: dy.is_cuda)
    rep = block_backward_check(TC.get_config(arch), kind, card)
    assert not rep["ok"]
    assert {"ssm/dt_bias", "ssm/wdt", "x"} <= set(rep["failed"])


@pytest.mark.cuda
@pytest.mark.parametrize("arch,kind", MEMORY_MOE_KINDS)
def test_cuda_memory_and_moe_block_backward_matches_cpu(card, arch, kind):
    """A full-width block, B 1 x S 1024, f32, the model's memory length;
    deepseek's mla block with 16 of its 160 experts (one layer of 160 is
    3.97 B params, too much for the CPU side of a test): every gradient
    within twice its noise floor of the CPU's, the routing equal."""
    cfg = TC.get_config(arch)
    if kind == "mla":
        cfg = dataclasses.replace(cfg, n_experts=16)
    rep = block_backward_check(cfg, kind, card, seq=1024)
    assert rep["routing_equal"], rep["min_gate_gap"]
    assert rep["ok"], rep["failed"]
