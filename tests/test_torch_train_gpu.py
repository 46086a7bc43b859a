"""The training slice on a card: ``FlashTrain`` on the card against the
CPU, the data pipeline's draw on the card against the CPU's, a train step
of the smoke internlm2 card against CPU, and a checkpoint written from
card tensors restored onto the card.

Marked ``gpu``: the ``cuda`` fixture skips each test where no card exists.
On a card: ``PYTHONPATH=src python -m pytest -q --noconftest
tests/test_torch_train_gpu.py`` (no JAX needed).

Tolerances (fp32, TF32 off): FlashTrain's output and gradients within rtol
1e-4 and atol 1e-5 of the largest |value|; the train step's loss within
rtol 1e-5 and its grad norm rtol 1e-4, the params after it within 2 lr of
the CPU's (AdamW's first step moves an element by about lr in the sign of
its gradient, which rounding can turn where the gradient is noise).
"""
import pytest
import torch

from repro_torch.checkpoint import manager as ckpt
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import InputShape
from repro_torch.data.pipeline import _categorical, _zipf_logits, batch_at
from repro_torch.engine import rng
from repro_torch.models.flash import flash_attention_trainable
from repro_torch.models.model import build_model, weights_init
from repro_torch.optim import adamw
from repro_torch.train import train_step as TS

pytestmark = [pytest.mark.torch_port, pytest.mark.gpu]

# (B, Sq, Skv, H, KV, Dh, causal, window, q_offset, bq, bkv)
CASES = [(2, 37, 37, 4, 2, 16, True, 0, 0, 8, 16),
         (2, 50, 50, 4, 2, 16, True, 10, 0, 8, 16),
         (1, 21, 40, 2, 1, 8, True, 6, 19, 4, 8),
         (2, 19, 45, 4, 4, 8, False, 0, 0, 8, 16),
         (1, 300, 300, 16, 8, 128, True, 0, 0, 128, 256)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _run(dev, case, seed=0):
    B, Sq, Skv, H, KV, Dh, causal, window, q_offset, bq, bkv = case
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(B, s, h, Dh, generator=g)
               for s, h in ((Sq, H), (Skv, KV), (Skv, KV)))
    cot = torch.randn(B, Sq, H, Dh, generator=g)
    ins = [t.to(dev).requires_grad_(True) for t in (q, k, v)]
    out = flash_attention_trainable(*ins, causal=causal, window=window,
                                    q_offset=q_offset, block_q=bq,
                                    block_kv=bkv)
    (out * cot.to(dev)).sum().backward()
    return [t.detach().cpu() for t in (out, *(x.grad for x in ins))]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_flash_train_card_vs_cpu(cuda, case):
    for got, want in zip(_run(cuda, case), _run("cpu", case)):
        torch.testing.assert_close(got, want, rtol=1e-4,
                                   atol=1e-5 * float(want.abs().max()))


def test_categorical_draw_card_vs_cpu(cuda):
    """The threefry words are integer ops; the gumbel's logs may part by
    an ulp between the card and the CPU, so the tokens are compared where
    the best two values of a row are apart by more than 1e-5."""
    V, rows = 1000, 300
    k = rng.key(3)
    got = _categorical(k.to(cuda), _zipf_logits(V, cuda), rows,
                       chunk=7 * V + 11).cpu()
    want = _categorical(k, _zipf_logits(V), rows, chunk=rows * V)
    torch.testing.assert_close(rng.bits(k.to(cuda), rows * V).cpu(),
                               rng.bits(k, rows * V), rtol=0, atol=0)
    assert int((got != want).sum()) <= 1, (got != want).sum()


def test_train_step_card_vs_cpu(cuda):
    cfg = get_smoke_config("internlm2-1.8b").scaled(dtype="float32")
    model = build_model(cfg)
    tcfg = TS.TrainCfg(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    card = model.init(0, device=cuda).requires_grad_(True)
    cpu = weights_init(cfg, None, "meta")
    cpu.load_state_dict({k: v.detach().to("cpu", copy=True)
                         for k, v in card.state_dict().items()}, assign=True)
    cpu = cpu.requires_grad_(True)
    batch = batch_at(cfg, InputShape("t", 32, 4, "train"), 0, device=cuda)
    out = {}
    for name, params, b in (("card", card, batch),
                            ("cpu", cpu, {k: v.cpu() for k, v in
                                          batch.items()})):
        state = TS.TrainState(params, adamw.init(params), None,
                              torch.zeros((), dtype=torch.int32,
                                          device=b["tokens"].device))
        out[name] = TS.make_train_step(model, tcfg)(state, b)[1]
    m, w = out["card"], out["cpu"]
    assert float(m["loss"]) == pytest.approx(float(w["loss"]), rel=1e-5)
    assert float(m["grad_norm"]) == pytest.approx(float(w["grad_norm"]),
                                                  rel=1e-4)
    lr = float(w["lr"])
    for (k, a), (_, b) in zip(card.named_parameters(),
                              cpu.named_parameters()):
        assert float((a.detach().cpu() - b.detach()).abs().max()) <= 2 * lr


def test_checkpoint_from_and_onto_the_card(cuda, tmp_path):
    tree = {"w": torch.randn(64, 32, device=cuda).to(torch.bfloat16),
            "step": torch.tensor(5, dtype=torch.int32, device=cuda)}
    ckpt.save(str(tmp_path), 5, tree)
    got, meta = ckpt.restore(str(tmp_path), tree)
    assert meta["step"] == 5 and got["w"].device.type == "cuda"
    assert got["w"].dtype == torch.bfloat16
    torch.testing.assert_close(got["w"], tree["w"], rtol=0, atol=0)
    assert int(got["step"]) == 5
