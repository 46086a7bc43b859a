"""The port's synthetic data pipeline against the JAX package's:
``repro_torch.data.pipeline.batch_at`` gives the tokens of
``repro.data.pipeline.batch_at`` bit for bit, for the smoke config of each
family and for several steps and data-parallel ranks; the frames and image
embeddings too (bf16 bit-equal; in f32 within ``erfinv``'s last bits,
rtol 1e-5 and atol 1e-5 of the largest |value|). The categorical draw made
range by range, with range edges inside rows, equals the whole draw. Plus
the cases of ``tests/test_data_pipeline.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.configs.base import InputShape as JShape
from repro.data import pipeline as jpipe
import repro_torch.configs as tconfigs
from repro_torch.configs.base import InputShape
from repro_torch.data.pipeline import (DataCfg, _categorical, _zipf_logits,
                                       batch_at, stream)
from repro_torch.engine import rng

pytestmark = pytest.mark.torch_port

CFG = tconfigs.get_smoke_config("internlm2-1.8b")
SHAPE = InputShape("t", 32, 8, "train")
ARCHS = ("internlm2-1.8b", "gemma3-27b", "deepseek-v2-lite-16b",
         "llama-3.2-vision-11b", "whisper-small", "xlstm-1.3b",
         "zamba2-2.7b")


def _batch(cfg, step, data=DataCfg()):
    return batch_at(cfg, SHAPE, step, data, device="cpu")


@pytest.mark.parametrize("arch,dtype", [
    *((a, "bfloat16") for a in ARCHS),
    # the stubs' f32 draw (the tokens do not depend on the dtype)
    ("whisper-small", "float32"), ("llama-3.2-vision-11b", "float32")])
def test_batch_at_equals_jax(arch, dtype):
    jc = jconfigs.get_smoke_config(arch).scaled(dtype=dtype)
    tc = tconfigs.get_smoke_config(arch).scaled(dtype=dtype)
    for step, data in ((0, DataCfg()), (7, DataCfg(seed=3)),
                       (2, DataCfg(dp_rank=1, dp_size=2))):
        want = jpipe.batch_at(jc, JShape("t", 32, 8, "train"), step,
                              jpipe.DataCfg(**vars(data)))
        got = _batch(tc, step, data)
        assert set(got) == set(want)
        assert got["tokens"].dtype == torch.int32
        np.testing.assert_array_equal(got["tokens"].numpy(),
                                      np.asarray(want["tokens"]))
        for k in set(got) - {"tokens"}:
            w = np.asarray(jnp.asarray(want[k]).astype(jnp.float32))
            assert str(got[k].dtype).endswith(dtype)
            g = got[k].float().numpy()
            if dtype == "bfloat16":
                np.testing.assert_array_equal(g, w)
            else:
                np.testing.assert_allclose(g, w, rtol=1e-5,
                                           atol=1e-5 * np.abs(w).max())


@pytest.mark.parametrize("V,rows,chunk", [(100, 50, 7 * 100 + 13),
                                          (100, 50, 37), (33, 9, 33),
                                          (256, 64, 1 << 30)])
def test_ranged_draw_equals_whole_draw(V, rows, chunk):
    k = rng.fold_in(rng.key(11), 2)
    logits = _zipf_logits(V)
    whole = _categorical(k, logits, rows, chunk=rows * V)
    got = _categorical(k, logits, rows, chunk=chunk)
    torch.testing.assert_close(got, whole, rtol=0, atol=0)
    bits = rng.bits(k, rows * V)
    for a in range(0, rows * V, chunk):
        b = min(a + chunk, rows * V)
        torch.testing.assert_close(rng.bits_range(k, a, b), bits[a:b],
                                   rtol=0, atol=0)


def test_categorical_ties_keep_the_first_index():
    """Equal logits over a range edge: the first maximum wins, as
    ``argmax`` picks it over the whole row."""
    k = rng.key(5)
    logits = torch.zeros(64)
    rows = 16
    got = _categorical(k, logits, rows, chunk=29)
    want = _categorical(k, logits, rows, chunk=rows * 64)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_device_rule():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is CUDA")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        batch_at(CFG, SHAPE, 0)


# ---- the cases of tests/test_data_pipeline.py -----------------------------

def test_deterministic():
    torch.testing.assert_close(_batch(CFG, 5)["tokens"],
                               _batch(CFG, 5)["tokens"], rtol=0, atol=0)


def test_steps_differ():
    assert not torch.equal(_batch(CFG, 5)["tokens"], _batch(CFG, 6)["tokens"])


def test_skip_to_step_resume():
    it0 = stream(CFG, SHAPE, start_step=0, device="cpu")
    full = [next(it0)["tokens"] for _ in range(6)]
    it3 = stream(CFG, SHAPE, start_step=3, device="cpu")
    for t in range(3, 6):
        torch.testing.assert_close(next(it3)["tokens"], full[t], rtol=0,
                                   atol=0)


def test_dp_ranks_disjoint_and_shaped():
    r0 = _batch(CFG, 2, DataCfg(dp_rank=0, dp_size=4))["tokens"]
    r1 = _batch(CFG, 2, DataCfg(dp_rank=1, dp_size=4))["tokens"]
    assert r0.shape == (2, 32)
    assert not torch.equal(r0, r1)


def test_tokens_in_vocab():
    t = _batch(CFG, 0)["tokens"]
    assert int(t.min()) >= 0 and int(t.max()) < CFG.vocab_size


def test_modality_stubs():
    wcfg = tconfigs.get_smoke_config("whisper-small")
    b = _batch(wcfg, 0)
    assert b["frames"].shape == (8, wcfg.num_audio_frames, wcfg.d_model)
    vcfg = tconfigs.get_smoke_config("llama-3.2-vision-11b")
    b = _batch(vcfg, 0)
    assert b["image_embed"].shape == (8, vcfg.num_image_tokens,
                                      vcfg.d_model)
