"""The LM serving slice on a card: ``dot_centrality`` at the width of a
vocabulary (the embedding rounds of ``examples/embedding_medoid_torch.py``)
on both of its paths against the plain version, and the dense, MoE, MLA,
VLM, enc-dec, xLSTM and Mamba2-hybrid models on the card against the same
weights on the CPU.

Marked ``gpu``: the ``cuda`` fixture skips each test where no card exists
(decided inside the fixture). On a card: ``PYTHONPATH=src python -m pytest
-q --noconftest tests/test_torch_lm_gpu.py`` (no JAX needed).

Tolerances: centrality sums rtol 1e-5 with a floor of 1e-5 of the largest
value, plus for l2 the self-pair allowance 1e-3 x max row norm x R (as
``chip_smoke.py``); two launches bit-equal. Model logits card vs CPU, fp32
with TF32 off: rtol = atol = 1e-4; a MoE layer's routed experts equal
wherever the K-th and (K+1)-th router probabilities are more than 1e-4
apart. The recurrent families' states: rtol 1e-4 and, for zamba2, atol
1e-4; for xLSTM atol 1e-4 of the state's largest |value| (its exponential
gates amplify a last-bit difference step by step: on the CPU, the JAX
reference against itself with half its f32 weights moved by one ulp parts
by up to 1.0e-4 of a state's largest |value|, and sLSTM's n is at least
1; the readings are in ``tests/_torch_lm.py``'s docstring). The card's
decode against its own forward within 2e-3.
"""
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ops
from repro_torch.kernels import pairwise_distance as pk
from repro_torch.models import moe as MOE
from repro_torch.models import recurrent as R
from repro_torch.models.model import build_model, cache_leaves

pytestmark = [pytest.mark.torch_port, pytest.mark.gpu]

V = 92544           # internlm2-1.8b's vocabulary: its embedding width


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


@pytest.mark.parametrize("metric", ("l2", "cosine"))
@pytest.mark.parametrize("c, r", ((2048, 20), (20, 1024), (3, 2048),
                                  (256, 64), (40, 40)))
def test_dot_centrality_at_vocab_width(cuda, metric, c, r):
    """Forced stream (crossover 32) and tile (0) paths and the wrapper's
    plan, with and without a reference mask."""
    assert not torch.backends.cuda.matmul.allow_tf32
    g = torch.Generator(device=cuda).manual_seed(c * 7 + r)
    x = torch.randn(c, V, device=cuda, generator=g) * 0.1
    y = torch.randn(r, V, device=cuda, generator=g) * 0.1
    w = (torch.rand(r, device=cuda, generator=g) > 0.3).float()
    if metric == "cosine":
        x, y, xn2, yn2 = ops._unit_rows(x), ops._unit_rows(y), None, None
    else:
        xn2, yn2 = ops._norms_sq(x), ops._norms_sq(y)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for mask in (None, w):
        want = pk.dot_centrality_plain(x, y, xn2, yn2, mask, metric=metric)
        tol = 1e-5 * want.abs() + 1e-5 * want.abs().max()
        if metric == "l2":
            norm = max(float(x.norm(dim=1).max()), float(y.norm(dim=1).max()))
            tol = tol + 1e-3 * norm * r
        for forced in (32, 0):
            plan = pk.centrality_plan(c, r, V, sms, crossover=forced)
            got = pk.launch_dot_centrality(x, y, xn2, yn2, mask, plan, metric)
            again = pk.launch_dot_centrality(x, y, xn2, yn2, mask, plan,
                                             metric)
            assert torch.equal(got, again), plan
            assert bool(((got - want).abs() <= tol).all()), (
                plan, float((got - want).abs().max()))
        before = pk.LAUNCHES["dot_centrality"]
        got = pk.dot_centrality(x, y, xn2, yn2, mask, metric=metric)
        assert pk.LAUNCHES["dot_centrality"] == before + 1
        assert bool(((got - want).abs() <= tol).all())


@pytest.mark.parametrize("arch", ("internlm2-1.8b", "gemma3-27b"))
def test_dense_model_card_matches_cpu(cuda, arch):
    """The smoke config in fp32, the same weights on the card and on the
    CPU: prefill logits and cache, then three decode steps."""
    cfg = get_smoke_config(arch).scaled(dtype="float32")
    model = build_model(cfg)
    cpu = model.init(0, "cpu")
    card = model.init(0, "cpu").to(cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, 20),
                         generator=torch.Generator().manual_seed(1))
    lc, cc = model.prefill(cpu, {"tokens": toks[:, :17]}, 24)
    lg, cg = model.prefill(card, {"tokens": toks[:, :17].to(cuda)}, 24)
    torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(cg["k"].cpu(), cc["k"], rtol=1e-4, atol=1e-4)
    for pos in (17, 18, 19):
        lc, cc = model.decode_step(cpu, toks[:, pos], cc, pos)
        lg, cg = model.decode_step(card, toks[:, pos].to(cuda), cg, pos)
        torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ("granite-moe-3b-a800m",
                                  "deepseek-v2-lite-16b",
                                  "llama-3.2-vision-11b", "whisper-small"))
def test_other_families_card_match_cpu(cuda, arch):
    """The smoke config in fp32 (a VLM's cross gates at 0.5, seeded image
    embeddings or frames): prefill logits and every cache, then three
    decode steps; the routed experts of every MoE group."""
    cfg = get_smoke_config(arch).scaled(dtype="float32")
    model = build_model(cfg)
    cpu = model.init(0, "cpu")
    if cfg.cross_attn_every:
        for p in cpu.groups.cross:
            p.gate.fill_(0.5)
    card = model.init(0, "cpu")
    card.load_state_dict(cpu.state_dict())
    card = card.to(cuda)
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 20), generator=g)
    batch = {"tokens": toks[:, :17]}
    if cfg.family == "vlm":
        batch["image_embed"] = torch.randn(2, cfg.num_image_tokens,
                                           cfg.d_model, generator=g)
    if cfg.family == "audio":
        batch["frames"] = torch.randn(2, cfg.num_audio_frames, cfg.d_model,
                                      generator=g)
    on_card = {k: v.to(cuda) for k, v in batch.items()}
    with MOE.record_routing() as rc:
        lc, cc = model.prefill(cpu, batch, 24)
    with MOE.record_routing() as rg:
        lg, cg = model.prefill(card, on_card, 24)
    torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-4)
    for name in cc:
        torch.testing.assert_close(cg[name].cpu(), cc[name], rtol=1e-4,
                                   atol=1e-4)
    assert len(rc) == len(rg) == (cfg.num_layers if cfg.moe else 0)
    K = cfg.moe.top_k if cfg.moe else 0
    for a, b in zip(rc, rg):
        top = torch.sort(a["probs"], dim=-1, descending=True).values
        clear = (top[..., K - 1] - top[..., K]) > 1e-4
        assert bool(clear.any())
        assert torch.equal(a["idx"][clear], b["idx"].cpu()[clear])
    for pos in (17, 18, 19):
        lc, cc = model.decode_step(cpu, toks[:, pos], cc, pos, batch=batch)
        lg, cg = model.decode_step(card, toks[:, pos].to(cuda), cg, pos,
                                   batch=on_card)
        torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-4)


def _states_close(got, want, family):
    for (name, g), (_, w) in zip(cache_leaves(got), cache_leaves(want)):
        atol = 1e-4 * (float(w.abs().max()) if family == "ssm" else 1.0)
        torch.testing.assert_close(g.cpu(), w, rtol=1e-4, atol=atol,
                                   msg=lambda m: f"{name}: {m}")


@pytest.mark.parametrize("arch", ("xlstm-1.3b", "zamba2-2.7b"))
def test_recurrent_families_card_match_cpu(cuda, arch):
    """The smoke config in fp32: prefill on 20 tokens (zamba2: a whole SSD
    chunk of 16 and a ragged one) with every state, then three decode
    steps; then the card's prefill and a decode step against its own
    forward."""
    cfg = get_smoke_config(arch).scaled(dtype="float32")
    model = build_model(cfg)
    cpu = model.init(0, "cpu")
    card = model.init(0, "cpu").to(cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, 24),
                         generator=torch.Generator().manual_seed(1))
    lc, cc = model.prefill(cpu, {"tokens": toks[:, :20]}, 24)
    lg, cg = model.prefill(card, {"tokens": toks[:, :20].to(cuda)}, 24)
    torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-4)
    _states_close(cg, cc, cfg.family)
    for pos in (20, 21, 22):
        lc, cc = model.decode_step(cpu, toks[:, pos], cc, pos)
        lg, cg = model.decode_step(card, toks[:, pos].to(cuda), cg, pos)
        torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-4)
        _states_close(cg, cc, cfg.family)
    fwd = R.xlstm_forward if cfg.family == "ssm" else R.hybrid_forward
    full = fwd(card, cfg, toks.to(cuda))[0]
    lp, cache = model.prefill(card, {"tokens": toks[:, :20].to(cuda)}, 24)
    torch.testing.assert_close(lp, full[:, 19], rtol=2e-3, atol=2e-3)
    ld, _ = model.decode_step(card, toks[:, 20].to(cuda), cache, 20)
    torch.testing.assert_close(ld, full[:, 20], rtol=2e-3, atol=2e-3)
