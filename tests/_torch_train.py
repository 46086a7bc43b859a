"""Shared check of the port's ``Model.loss`` against the JAX package's
(``tests/test_torch_train_loss.py`` and
``tests/test_torch_train_loss_families.py``, whose docstrings state the
tolerances): the loss, its metrics and every parameter's gradient against
``jax.value_and_grad`` of the reference's loss on JAX's weights converted
bit for bit, then the port's own ``remat=True`` against ``remat=False``,
bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_lm import jax_params, np_tree, pair
from repro.models.model import build_model as jbuild
from repro_torch.convert import _unstack, lm_params_from_jax
from repro_torch.models.model import build_model

B, S = 2, 32
LOSS_RTOL = 1e-5
GRAD_TOL = (2e-3, 2e-4)     # rtol, atol of the model's largest |gradient|


def loss_batch(jcfg, seed=0):
    """Seeded tokens (B, S), plus image embeddings or frames."""
    rs = np.random.RandomState(seed)
    batch = {"tokens": rs.randint(0, jcfg.vocab_size, (B, S)).astype(
        np.int32)}
    if jcfg.family == "vlm":
        batch["image_embed"] = rs.randn(B, jcfg.num_image_tokens,
                                        jcfg.d_model).astype(np.float32)
    if jcfg.family == "audio":
        batch["frames"] = rs.randn(B, jcfg.num_audio_frames,
                                   jcfg.d_model).astype(np.float32)
    return batch


def port_loss(tcfg, params, batch, remat):
    """(loss, metrics, {name: gradient}) of the port's ``Model.loss``."""
    for p in params.parameters():
        p.grad = None
    loss, metrics = build_model(tcfg).loss(
        params, {k: torch.as_tensor(v) for k, v in batch.items()},
        remat=remat)
    loss.backward()
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
        {k: p.grad.clone() for k, p in params.named_parameters()}


def check_model_loss(arch):
    jcfg, tcfg = pair(arch, "float32")
    jp = jax_params(jcfg)
    batch = loss_batch(jcfg)
    (jl, jm), jg = jax.jit(jax.value_and_grad(jbuild(jcfg).loss,
                                              has_aux=True),
                           static_argnames="remat")(
        jp, {k: jnp.asarray(v) for k, v in batch.items()}, remat=True)
    want = {k: np.asarray(v) for k, v in _unstack(tcfg, np_tree(jg)).items()}
    params = lm_params_from_jax(tcfg, np_tree(jp),
                                device="cpu").requires_grad_(True)
    loss, metrics, grads = port_loss(tcfg, params, batch, remat=True)

    np.testing.assert_allclose(float(loss), float(jl), rtol=LOSS_RTOL)
    assert set(metrics) == set(jm)
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k]), float(jm[k]),
                                   rtol=LOSS_RTOL, atol=1e-6)
    assert set(grads) == set(want)
    top = max(float(np.abs(w).max()) for w in want.values())
    rtol, atol = GRAD_TOL
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[k], rtol=rtol,
                                   atol=atol * top, err_msg=k)

    # remat changes memory, never values
    loss0, _, grads0 = port_loss(tcfg, params, batch, remat=False)
    assert torch.equal(loss0, loss)
    for k in grads:
        torch.testing.assert_close(grads0[k], grads[k], rtol=0, atol=0)
