"""The MoE layer and the MoE decoder (granite-moe-3b-a800m's smoke config)
of the port against the live JAX package on the CPU.

``moe_apply`` alone, fp32, at group 8 on 13 tokens (two groups, three
padding rows, capacity 2 a group): the routed expert indices (JAX's read
from its ``lax.top_k`` call at run time) and the drop masks (from the
queue positions JAX hands ``jax.nn.one_hot``) are equal, some choices are
dropped; y within rtol = atol = 1e-5, the aux loss within 1e-6. The whole
model (``_torch_lm.check_against_jax``) in fp32 and bf16 at
``test_torch_lm_models.py``'s tolerances; the port's decode against its
forward; the converter; the serve CLI and ``Server.run``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import moe as JMOE
from repro.models.model import build_model as jbuild
import repro_torch.configs as tconfigs
from repro_torch.convert import lm_params_from_jax
from repro_torch.models import moe as MOE

import _torch_lm as H

pytestmark = pytest.mark.torch_port

ARCH = "granite-moe-3b-a800m"
GROUP, SEQ = 8, 13


def _jax_moe_routing(monkeypatch, params, x, cfg):
    """Run JAX's ``moe_apply``; return (y, aux, [(idx, kept) a group])
    with JAX's own top-k indices and queue positions, read at run time
    from its ``lax.top_k`` and ``jax.nn.one_hot`` calls (debug callbacks
    in the scanned group body)."""
    tops, positions = [], []
    top_k, one_hot = jax.lax.top_k, jax.nn.one_hot

    def rec_top_k(operand, k):
        out = top_k(operand, k)
        jax.debug.callback(lambda i: tops.append(np.asarray(i)), out[1],
                           ordered=True)
        return out

    def rec_one_hot(v, n, **kw):
        if v.ndim == 4:      # one_hot(pos, cap); the other is of gate_idx
            jax.debug.callback(lambda p: positions.append(np.asarray(p)), v,
                               ordered=True)
            rec_one_hot.cap = n
        return one_hot(v, n, **kw)

    monkeypatch.setattr(jax.lax, "top_k", rec_top_k)
    monkeypatch.setattr(jax.nn, "one_hot", rec_one_hot)
    y, aux = JMOE.moe_apply(params, x, cfg, group=GROUP)
    jax.effects_barrier()
    monkeypatch.undo()
    routing = []
    for idx, pos in zip(tops, positions):
        chosen = np.take_along_axis(pos, idx[..., None], axis=-1)[..., 0]
        routing.append((idx, chosen < rec_one_hot.cap))
    assert len(routing) == len(tops) == len(positions) == -(-SEQ // GROUP)
    return y, aux, routing


@pytest.mark.parametrize("arch", (ARCH, "deepseek-v2-lite-16b"))
def test_moe_apply_matches_jax(arch, monkeypatch):
    """granite's experts, and deepseek's with a shared expert."""
    jcfg, cfg = H.pair(arch, "float32")
    ffn = jbuild(jcfg).init(jax.random.key(0))["layers"]["ffn"]
    jp = jax.tree.map(lambda a: a[0], ffn)
    assert ("shared" in jp) == (arch != ARCH)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    x = np.random.default_rng(3).standard_normal(
        (2, SEQ, cfg.d_model)).astype(np.float32)

    want, jaux, jrouting = _jax_moe_routing(monkeypatch, jp, jnp.asarray(x),
                                            jcfg.moe)
    with MOE.record_routing() as tape:
        got, aux = MOE.moe_apply(tp, torch.from_numpy(x), cfg.moe,
                                 group=GROUP)
    assert len(tape) == len(jrouting)
    drops = 0
    for rec, (idx, kept) in zip(tape, jrouting):
        np.testing.assert_array_equal(rec["idx"].numpy(), idx)
        np.testing.assert_array_equal(rec["kept"].numpy(), kept)
        drops += int((~kept).sum())
    assert drops > 0
    assert [rec["rows"] for rec in tape] == [GROUP, SEQ - GROUP]
    assert got.shape == (2, SEQ, cfg.d_model) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6, atol=1e-6)


def test_router_ties_go_to_the_lower_expert():
    """Equal probabilities: ``lax.top_k``'s order, lower index first."""
    router = torch.zeros(4, 6)
    router[:, 3] = 1.0
    x = torch.tensor([[[1.0, 0.0, 0.0, 0.0], [0.0] * 4]])
    _, vals, idx = MOE.route(router, x, 3)
    _, jidx = jax.lax.top_k(jax.nn.softmax(
        jnp.asarray(x.numpy()) @ jnp.asarray(router.numpy()), axis=-1), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert idx.tolist() == [[[3, 0, 1], [0, 1, 2]]]
    np.testing.assert_allclose(vals.sum(-1).numpy(), 1.0, rtol=1e-6)


def test_capacity_and_padding_follow_the_reference():
    """cap = max(1, int(factor * g * K / E)) on g = min(group, S); a
    group of one token keeps one slot per expert."""
    cfg = tconfigs.get_smoke_config(ARCH).moe
    assert cfg.capacity_factor == 1.25
    p = MOE.moe_init(torch.Generator().manual_seed(0), 16, cfg, 64,
                     torch.float32, device="cpu")
    x = torch.randn(1, 1, 16, generator=torch.Generator().manual_seed(1))
    with MOE.record_routing() as tape:
        y, _ = MOE.moe_apply(p, x, cfg, group=GROUP)
    assert len(tape) == 1 and bool(tape[0]["kept"].all())
    assert y.shape == (1, 1, 16)
    # outside a recorder nothing is kept
    assert MOE._ROUTING.get() is None


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_model_matches_jax(dtype):
    H.check_against_jax(ARCH, dtype)


def test_decode_matches_forward():
    H.check_decode_matches_forward(ARCH)


def test_converter_keeps_every_array_bit_for_bit():
    tree, cfg = H.check_converter_bits(ARCH, {"layers": 1})
    assert tree["layers"]["ffn"]["router"].dtype == np.float32
    assert tree["layers"]["ffn"]["w_gate"].shape == (
        cfg.num_layers, cfg.moe.num_experts, cfg.d_model, cfg.moe.d_expert)


@pytest.mark.parametrize("arch, edit", (
    (ARCH, lambda t: t["layers"]["ffn"].pop("router")),              # missing
    (ARCH, lambda t: t["layers"]["ffn"].update(
        router=t["layers"]["ffn"]["router"].astype(jnp.bfloat16))),  # dtype
    (ARCH, lambda t: t["layers"]["ffn"].update(
        w_up=t["layers"]["ffn"]["w_up"][:, :-1])),                    # shape
    (ARCH, lambda t: t["layers"]["ffn"].update(
        shared=t["layers"]["ffn"].copy())),                           # extra
    ("deepseek-v2-lite-16b",
     lambda t: t["layers"]["ffn"].pop("shared")),                     # missing
))
def test_converter_refuses_a_bad_moe_tree(arch, edit):
    jcfg, cfg = H.pair(arch, "bfloat16")
    tree = H.np_tree(jbuild(jcfg).init(jax.random.key(0)))
    edit(tree)
    with pytest.raises(ValueError, match="lm_params_from_jax"):
        lm_params_from_jax(cfg, tree, device="cpu")


def test_cli_matches_jax(capsys):
    H.check_cli(ARCH, capsys)


def test_server_run_matches_jax():
    H.check_server(ARCH)


def test_configs_carry_the_moe_fields():
    for arch in (ARCH, "deepseek-v2-lite-16b"):
        got, want = (tconfigs.get_config(arch).moe,
                     jconfigs.get_config(arch).moe)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
