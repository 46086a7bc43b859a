"""The port's training loss against the JAX package's: ``fused_xent`` and
``_xent`` values and gradients on the cases of ``tests/test_fused_xent.py``
(its hypothesis strategy, drawn from a seed), and ``Model.loss`` with every
parameter's gradient against ``jax.value_and_grad`` of the reference's
loss on JAX's weights converted bit for bit (``tests/_torch_train.py``),
for the fp32 smoke configs of internlm2 (dense), gemma3 (sliding windows),
deepseek-v2-lite (MLA and MoE, with its aux term) and whisper-small
(enc-dec); ``tests/test_torch_train_loss_families.py`` holds the VLM,
xlstm and zamba2 (the split keeps each file under a minute). Remat changes
memory, never values: the port's loss and gradients with ``remat=True``
equal those with ``remat=False`` bit for bit.

Tolerances: a loss within rtol 1e-5; a fused or plain CE within rtol =
atol = 1e-5 of JAX's and its gradients within rtol 1e-4, atol 1e-6 (the
original test's); a model's gradient, each parameter's, within rtol 2e-3
and atol 2e-4 of the model's largest |gradient| (a gradient that is zero
in exact arithmetic, as a key bias's under softmax, is rounding noise in
both packages). Read on this suite's inputs: the loss within 4.8e-7, the
gradients within 3e-6 of the largest everywhere but xLSTM (2.9e-4
absolute; its exponential gates amplify last bits, ``tests/_torch_lm.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_train import check_model_loss
from repro.models.model import _xent as jxent
from repro.models.model import fused_xent as jfused
from repro_torch.models.model import _xent, fused_xent

pytestmark = pytest.mark.torch_port


def _xent_cases(n=8, seed=0):
    """``test_fused_equals_plain``'s strategy: B in 1..4, S in 2..70, d in
    1..32, V in 2..100, chunk in 1..64."""
    rs = np.random.RandomState(seed)
    return [tuple(int(rs.randint(lo, hi + 1)) for lo, hi in
                  ((1, 4), (2, 70), (1, 32), (2, 100), (1, 64)))
            for _ in range(n)]


def _case(B, S, d, V, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(B, S, d).astype(np.float32),
            (rs.randn(V, d) * 0.1).astype(np.float32),
            rs.randint(0, V, (B, S)).astype(np.int32))


def _grads(f, *arrays):
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    out = f(*ts)
    out.backward()
    return float(out), [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("B,S,d,V,chunk", _xent_cases())
def test_fused_xent_matches_jax(B, S, d, V, chunk):
    x, head, tokens = _case(B, S, d, V, seed=B * 1000 + S)
    tt = torch.tensor(tokens)
    got, (gx, gh) = _grads(lambda x, h: fused_xent(x, tt, h, chunk=chunk),
                           x, head)
    want, (wx, wh) = jax.value_and_grad(
        lambda x, h: jfused(x, jnp.asarray(tokens), h, chunk=chunk),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(head))
    np.testing.assert_allclose(got, float(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gx, np.asarray(wx), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(gh, np.asarray(wh), rtol=1e-4, atol=1e-6)
    # and the port's fused loss equals its plain one
    plain = float(_xent(torch.tensor(x) @ torch.tensor(head).T, tt))
    np.testing.assert_allclose(got, plain, rtol=1e-5, atol=1e-5)


def test_xent_and_grads_match_jax():
    x, head, tokens = _case(2, 33, 16, 50)
    logits = x @ head.T
    got, (g,) = _grads(lambda lg: _xent(lg, torch.tensor(tokens)), logits)
    want, w = jax.value_and_grad(lambda lg: jxent(lg, jnp.asarray(tokens)))(
        jnp.asarray(logits))
    np.testing.assert_allclose(got, float(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-6)
    # test_fused_grads_match: the chunked gradients equal the plain ones
    tt = torch.tensor(tokens)
    _, plain = _grads(lambda x, h: _xent(x @ h.T, tt), x, head)
    _, fused = _grads(lambda x, h: fused_xent(x, tt, h, chunk=8), x, head)
    for a, b in zip(fused, plain):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)




@pytest.mark.parametrize("arch", ["internlm2-1.8b", "gemma3-27b",
                                  "deepseek-v2-lite-16b", "whisper-small"])
def test_model_loss_and_grads_match_jax(arch):
    check_model_loss(arch)
