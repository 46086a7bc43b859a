"""The port's quantized arithmetic against ``repro.quant`` and the JAX
kernels' bf16 mode on the same numpy inputs: storage rounding, int8
quantization and the int8 Gram bit for bit; the quantized blocks, the bf16
centrality sums and pairwise block, and the error model to rtol 1e-5 (see
``_torch_compare``). The JAX kernels run in Pallas interpret mode."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_compare import assert_close, case
from repro import quant as jquant
from repro.kernels import ops as jops
from repro.kernels import pairwise_distance as jpk
from repro.quant import backends as jqb
from repro_torch import quant as tquant
from repro_torch.core import backend as tbackend
from repro_torch.kernels import ops as tops
from repro_torch.kernels import pairwise_distance as tpk
from repro_torch.quant import backends as tqb
from repro_torch.quant import error as terror

pytestmark = pytest.mark.torch_port

METRICS = ("l1", "l2", "sql2", "cosine")
QUANT = ("bf16", "int8")


def _rows(kind: str) -> np.ndarray:
    """Rows that probe the rounding: halfway values between neighbouring
    bf16 values, zero rows, rows at +-127, wide dynamic ranges, d = 2048."""
    rng = np.random.default_rng(11)
    if kind == "halfway":
        # 1 + (2k + 1) 2^-8 lies halfway between two bf16 values, at every
        # binade and sign; nearest-even rounding decides each one
        k = np.arange(128, dtype=np.float32)
        base = np.float32(1.0) + (2 * k + 1) * np.float32(2.0 ** -8)
        scale = np.float32(2.0) ** np.arange(-6, 7, dtype=np.float32)
        x = (base[None, :] * scale[:, None]).astype(np.float32)
        return np.concatenate([x, -x, np.zeros((1, 128), np.float32)])
    if kind == "pm127":
        x = rng.choice(np.array([-127.0, 127.0], np.float32), (9, 2048))
        x[3] = 0.0                              # a zero row
        return x.astype(np.float32)
    if kind == "wide":
        x = rng.standard_normal((40, 37)).astype(np.float32)
        x *= np.float32(10.0) ** rng.uniform(-3, 3, (40, 1)).astype(
            np.float32)
        x[5] = 0.0
        return x.astype(np.float32)
    return case(50, 2048, seed=3)               # "d2048"


ROW_KINDS = ("halfway", "pm127", "wide", "d2048")


@pytest.mark.parametrize("kind", ROW_KINDS)
def test_rounding_quantization_and_int8_gram_bit_equal(kind):
    x = _rows(kind)
    y = x[::-1].copy()
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    np.testing.assert_array_equal(
        tqb._bf16(tx).float().numpy(),
        np.asarray(jqb._bf16(jnp.asarray(x)).astype(jnp.float32)))
    q, s = jquant.quantize_rows_int8(jnp.asarray(x))
    tq, ts = tquant.quantize_rows_int8(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(q))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(s))
    np.testing.assert_array_equal(
        tquant.dequantize_rows_int8(tx).numpy(),
        np.asarray(jquant.dequantize_rows_int8(jnp.asarray(x))))
    np.testing.assert_array_equal(
        tquant.gram_int8(tx, ty).numpy(),
        np.asarray(jquant.gram_int8(jnp.asarray(x), jnp.asarray(y))))


def test_int8_gram_is_exact_past_float32_integers():
    # 127^2 * 2048 = 33,032,192 > 2^24: a float32 sum of the int8 products
    # would round; the int32 one is exact
    x = _rows("pm127")
    q, _ = tquant.quantize_rows_int8(torch.from_numpy(x))
    want = q.numpy().astype(np.int64) @ q.numpy().astype(np.int64).T
    assert np.abs(want).max() > 2 ** 24
    np.testing.assert_array_equal(tqb._int_gram(q, q).numpy(), want)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("precision", QUANT)
def test_quant_pairwise_matches_jax(metric, precision):
    x = case(30, 24, seed=5, positive=metric == "cosine")
    y = case(17, 24, seed=6, positive=metric == "cosine")
    want = jquant.quant_pairwise(metric, precision)(jnp.asarray(x),
                                                    jnp.asarray(y))
    got = tquant.quant_pairwise(metric, precision)(torch.from_numpy(x),
                                                   torch.from_numpy(y))
    assert_close(got, np.asarray(want), metric, np.concatenate([x, y]))


@pytest.mark.parametrize("metric", ("l2", "sql2", "cosine"))
@pytest.mark.parametrize("masked", (False, True))
def test_bf16_centrality_sums_match_jax(metric, masked):
    """``kernel_centrality_sums(compute_dtype="bfloat16")`` (the plain
    version on the CPU) against the JAX kernel's bf16 mode in interpret
    mode, on a d that crosses its 256-wide d tile."""
    x = case(40, 300, seed=8, positive=metric == "cosine")
    y = case(70, 300, seed=9, positive=metric == "cosine")
    m = (np.random.default_rng(1).random(70) > 0.3).astype(np.float32) \
        if masked else None
    want = jops.kernel_centrality_sums(
        jnp.asarray(x), jnp.asarray(y), metric=metric, interpret=True,
        ref_mask=None if m is None else jnp.asarray(m),
        compute_dtype="bfloat16")
    got = tops.kernel_centrality_sums(
        torch.from_numpy(x), torch.from_numpy(y), metric=metric,
        ref_mask=None if m is None else torch.from_numpy(m),
        compute_dtype="bfloat16")
    assert_close(got, np.asarray(want), metric, np.concatenate([x, y]),
                 per_value_refs=70)
    # the rounding shows: the fp32 sums differ beyond the tolerance
    fp32 = tops.kernel_centrality_sums(
        torch.from_numpy(x), torch.from_numpy(y), metric=metric,
        ref_mask=None if m is None else torch.from_numpy(m))
    assert not torch.equal(fp32, got)


@pytest.mark.parametrize("metric", METRICS)
def test_fused_bf16_backend_matches_jax(metric):
    """``quant_bf16_fused``'s centrality (ℓ1: the fp32 kernel on rounded
    rows) against the JAX backend's, with a reference mask."""
    x = case(33, 20, seed=12, positive=metric == "cosine")
    y = case(45, 20, seed=13, positive=metric == "cosine")
    m = (np.random.default_rng(2).random(45) > 0.4).astype(np.float32)
    want = jqb._fused_bf16_centrality(metric)(
        jnp.asarray(x), jnp.asarray(y), ref_mask=jnp.asarray(m))
    got = tbackend.get_backend("quant_bf16_fused").centrality_sums(metric)(
        torch.from_numpy(x), torch.from_numpy(y),
        ref_mask=torch.from_numpy(m))
    assert_close(got, np.asarray(want), metric, np.concatenate([x, y]),
                 per_value_refs=45)


@pytest.mark.parametrize("metric", ("l2", "sql2", "cosine"))
def test_bf16_dot_centrality_plain_matches_jax_kernel(metric):
    """``dot_centrality_plain(compute_dtype="bfloat16")`` against the JAX
    kernel ``dot_centrality`` itself in its bf16 mode (interpret mode; its
    inputs zero-padded to the block, the padded references masked off), with
    a reference mask, at a d that crosses its 256-wide d tile."""
    x = case(40, 300, seed=16, positive=metric == "cosine")
    y = case(90, 300, seed=17, positive=metric == "cosine")
    m = (np.random.default_rng(3).random(90) > 0.3).astype(np.float32)
    tx, ty, tm = (torch.from_numpy(a) for a in (x, y, m))
    if metric == "cosine":
        tx, ty = tops._unit_rows(tx), tops._unit_rows(ty)
        xn2 = yn2 = None
    else:
        xn2, yn2 = tops._norms_sq(tx), tops._norms_sq(ty)
    pad = lambda a, r: np.pad(a, ((0, -a.shape[0] % r),   # noqa: E731
                                  (0, -a.shape[1] % jpk.BD)))
    xp, yp = pad(tx.numpy(), jpk.BC), pad(ty.numpy(), jpk.BR)
    # squared norms of the unrounded rows (zeros for cosine), zero-padded
    xn = np.zeros((xp.shape[0], 1), np.float32)
    yn = np.zeros((1, yp.shape[0]), np.float32)
    if xn2 is not None:
        xn[:40, 0], yn[0, :90] = xn2.numpy(), yn2.numpy()
    want = np.asarray(jpk.dot_centrality(
        jnp.asarray(xp), jnp.asarray(yp), jnp.asarray(xn), jnp.asarray(yn),
        90, metric=metric,
        ref_mask=jnp.asarray(np.pad(m, (0, yp.shape[0] - 90))),
        compute_dtype="bfloat16", interpret=True))[:40, 0]
    got = tpk.dot_centrality_plain(tx, ty, xn2, yn2, tm, metric=metric,
                                   compute_dtype="bfloat16")
    assert_close(got, want, metric, np.concatenate([x, y]),
                 per_value_refs=90)


def test_bf16_dot_pairwise_matches_jax():
    """``dot_pairwise(compute_dtype="bfloat16")`` against the JAX kernel's
    bf16 mode (interpret mode; its inputs zero-padded to the block)."""
    x = case(40, 300, seed=14)
    y = case(90, 300, seed=15)
    pad = lambda a, r: np.pad(a, ((0, -a.shape[0] % r),   # noqa: E731
                                  (0, -a.shape[1] % jpk.BD)))
    want = np.asarray(jpk.dot_pairwise(
        jnp.asarray(pad(x, jpk.BC)), jnp.asarray(pad(y, jpk.BR)),
        compute_dtype="bfloat16", interpret=True))[:40, :90]
    got = tpk.dot_pairwise(torch.from_numpy(x), torch.from_numpy(y),
                           compute_dtype="bfloat16")
    assert_close(got, want, "block", np.concatenate([x, y]))
    assert not torch.equal(got, tpk.dot_pairwise(torch.from_numpy(x),
                                                 torch.from_numpy(y)))
    with pytest.raises(ValueError, match="compute_dtype"):
        tpk.dot_pairwise(torch.from_numpy(x), torch.from_numpy(y),
                         compute_dtype="float16")


def test_probe_rows_equal_jax_linspace():
    for n in list(range(2, 5001)) + [6424, 20000]:
        p = min(n, tquant.DEFAULT_PROBE)
        want = np.asarray(jnp.linspace(0.0, float(n - 1), p).round()
                          .astype(jnp.int32))
        np.testing.assert_array_equal(terror.probe_rows(n), want,
                                      err_msg=str(n))
    np.testing.assert_array_equal(terror.probe_rows(1), [0])


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("precision", QUANT)
def test_error_model_matches_jax(metric, precision):
    """The analytic bound to rtol 1e-5. The probe bound is a mean of
    ``|d_q - d_f|``, differences of two fp32 distances that each package
    rounds in its own summation order: each difference is known to a few
    ulps of the distances, not of itself (measured: 1e-6 to 3e-4 relative
    to the bound on random rows). So it is held to rtol 1e-5 with the floor
    of 1e-5 of the largest value taken over the probe block's distances,
    the values that enter it, and the probe margin to the same times
    ``2 * DEFAULT_SAFETY``."""
    x = case(150, 12, seed=21, positive=metric == "cosine")
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    want = np.asarray(jquant.analytic_distance_bound(jx, metric, precision))
    got = tquant.analytic_distance_bound(tx, metric, precision)
    assert got.shape == () and float(got) > 0
    assert_close(got, want, "bound", x)
    assert_close(tquant.margin(tx, metric, precision, model="analytic"),
                 np.asarray(jquant.margin(jx, metric, precision,
                                          model="analytic")), "margin", x)

    rows = jnp.asarray(x[terror.probe_rows(150)])
    scale = float(jnp.abs(jquant.quant_pairwise(metric, "fp32")(rows,
                                                                 rows)).max())
    for got, want, factor in (
            (tquant.probe_distance_bound(tx, metric, precision),
             jquant.probe_distance_bound(jx, metric, precision), 1.0),
            (tquant.margin(tx, metric, precision),
             jquant.margin(jx, metric, precision),
             2 * tquant.DEFAULT_SAFETY)):
        want = float(want)
        assert got.shape == () and float(got) > 0 and want > 0
        assert abs(float(got) - want) <= 1e-5 * want + 1e-5 * factor * scale
    assert float(tquant.margin(tx, metric, "fp32")) == 0.0
    with pytest.raises(ValueError, match="unknown error model"):
        tquant.margin(tx, metric, precision, model="nope")
