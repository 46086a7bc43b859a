"""The port's optimizer, checkpoints and runtime against the JAX package:
``repro_torch.optim.{schedule,adamw,compress}`` on the same inputs as
``repro.optim`` (a mixed tree of bf16 and f32 leaves, 1-D and 2-D), the
block quantizer bit for bit, the cases of ``tests/test_{optim,
fault_tolerance,checkpoint}.py`` ported (all but the sharded restore,
which comes with the meshes), and checkpoints that each package restores
from the other.

Tolerances: the schedules and AdamW's f32 results agree with JAX's within
rtol = atol = 1e-6 (XLA and PyTorch evaluate ``pow``, ``cos`` and
``sqrt`` to within an ulp of each other); a bf16 parameter after an update
within one bf16 ulp (rtol 2**-7), since an f32 value an ulp apart can round
to the neighbouring bf16 value; the quantizer's int8 values and scales are
bit-equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as jckpt
from repro.optim import adamw as jadamw
from repro.optim import compress as jcompress
from repro.optim import schedule as jschedule
from repro_torch.checkpoint import manager as ckpt
from repro_torch.convert import _numpy_to_torch
from repro_torch.optim import adamw, compress, schedule
from repro_torch.runtime.fault_tolerance import (StepWatchdog,
                                                 elastic_mesh_shape,
                                                 run_with_restarts)

pytestmark = pytest.mark.torch_port

F32_TOL = dict(rtol=1e-6, atol=1e-6)
BF16_TOL = dict(rtol=2 ** -7, atol=1e-6)

# name: (shape, dtype) of a mixed tree; the names sort as JAX sorts keys
LEAVES = {"a.w": ((16, 24), "float32"), "b.bias": ((24,), "float32"),
          "c.embed": ((40, 8), "bfloat16"), "d.norm": ((8,), "bfloat16"),
          "e.stack": ((2, 3, 4), "float32")}


def _tree(seed, scale=1.0):
    rs = np.random.RandomState(seed)
    return {k: (rs.randn(*shape) * scale).astype(np.float32).astype(
        jnp.bfloat16 if dt == "bfloat16" else np.float32)
        for k, (shape, dt) in LEAVES.items()}


def _jax(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _torch(tree):
    return {k: _numpy_to_torch(np.asarray(v)) for k, v in tree.items()}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, dtype="float32"):
    np.testing.assert_allclose(_np(got), _np(want),
                               **(BF16_TOL if "bfloat16" in str(dtype)
                                  else F32_TOL))


@pytest.mark.parametrize("step", [0, 1, 5, 10, 11, 55, 100, 140])
def test_schedules_match_jax(step):
    kw = dict(peak_lr=3e-4, warmup_steps=10, total_steps=100)
    _close(schedule.cosine_with_warmup(step, **kw),
           jschedule.cosine_with_warmup(step, **kw))
    _close(schedule.cosine_with_warmup(torch.tensor(step, dtype=torch.int32),
                                       final_frac=0.3, **kw),
           jschedule.cosine_with_warmup(step, final_frac=0.3, **kw))
    _close(schedule.inverse_sqrt(step, peak_lr=1e-3, warmup_steps=10),
           jschedule.inverse_sqrt(step, peak_lr=1e-3, warmup_steps=10))


@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_clip_by_global_norm_matches_jax(max_norm):
    g = _tree(1, scale=3.0)
    got, gnorm = adamw.clip_by_global_norm(_torch(g), max_norm)
    want, wnorm = jadamw.clip_by_global_norm(_jax(g), max_norm)
    _close(gnorm, wnorm)
    for k, (_, dt) in LEAVES.items():
        assert str(got[k].dtype).endswith(dt)     # scaled in its own dtype
        _close(got[k], want[k], dt)


def test_adamw_update_matches_jax_over_steps():
    """Four updates of the mixed tree with clipping active: params, the f32
    moments, the step and the grad norm; decay on ndim >= 2 only."""
    p_np = _tree(2)
    tp, jp = _torch(p_np), _jax(p_np)
    ts, js = adamw.init(tp), jadamw.init(jp)
    assert all(m.dtype == torch.float32 for m in ts.mu.values())
    for t in range(4):
        g = _tree(10 + t, scale=0.5)
        lr = jschedule.cosine_with_warmup(t + 1, peak_lr=1e-2,
                                          warmup_steps=2, total_steps=10)
        tp, ts, tm = adamw.update(_torch(g), ts, tp,
                                  lr=torch.tensor(float(lr)),
                                  weight_decay=0.1, max_grad_norm=1.0)
        jp, js, jm = jadamw.update(_jax(g), js, jp, lr=lr,
                                   weight_decay=0.1, max_grad_norm=1.0)
        _close(tm["grad_norm"], jm["grad_norm"])
        assert int(ts.step) == int(js.step) == t + 1
        for k, (_, dt) in LEAVES.items():
            assert str(tp[k].dtype).endswith(dt)
            _close(tp[k], jp[k], dt)
            _close(ts.mu[k], js.mu[k])
            _close(ts.nu[k], js.nu[k])


def test_adamw_updates_in_place():
    """The new params and moments are the given tensors, written in place
    (the trainer holds no second copy), and the grads are not touched."""
    p = _torch(_tree(3))
    s = adamw.init(p)
    g = _torch(_tree(4))
    g0 = {k: v.clone() for k, v in g.items()}
    before = {k: v.clone() for k, v in p.items()}
    got, gs, _ = adamw.update(g, s, p, lr=1e-2)
    for k in p:
        assert got[k] is p[k] and gs.mu[k] is s.mu[k] and gs.nu[k] is s.nu[k]
        assert not torch.equal(p[k], before[k])
        torch.testing.assert_close(g[k], g0[k], rtol=0, atol=0)


def test_no_weight_decay_on_vectors():
    p = {"v": torch.ones(4), "m": torch.ones(2, 2)}
    g = {k: torch.zeros_like(v) for k, v in p.items()}
    new, _, _ = adamw.update(g, adamw.init(p), p, lr=0.5, weight_decay=0.1)
    assert torch.equal(new["v"], torch.ones(4))
    assert float(new["m"][0, 0]) == pytest.approx(1 - 0.5 * 0.1)


@pytest.mark.parametrize("n", [1, 255, 256, 257, 1000, 4096])
def test_quantize_bit_equal_to_jax(n):
    rs = np.random.RandomState(n)
    g = (rs.randn(n) * 10).astype(np.float32)
    g[::7] = 0.0
    g[n // 2] = 127.5 * abs(g).max() / 127    # near a rounding tie
    q, s = compress._quantize(torch.tensor(g))
    jq, js = jcompress._quantize(jnp.asarray(g))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        compress.compress_decompress(torch.tensor(g)).numpy(),
        np.asarray(jcompress.compress_decompress(jnp.asarray(g))))


def test_round_half_to_even_like_jnp():
    x = torch.tensor([0.5, 1.5, 2.5, -0.5, -1.5, -2.5])
    np.testing.assert_array_equal(torch.round(x).numpy(),
                                  np.asarray(jnp.round(jnp.asarray(x))))


def test_error_feedback_matches_jax():
    tree = _tree(5)
    te, je = compress.init_error_feedback(_torch(tree)), \
        jcompress.init_error_feedback(_jax(tree))
    for t in range(3):
        g = _tree(20 + t)
        ts, te = compress.apply_error_feedback(_torch(g), te)
        js, je = jcompress.apply_error_feedback(_jax(g), je)
        for k, (_, dt) in LEAVES.items():
            assert str(ts[k].dtype).endswith(dt)
            _close(ts[k], js[k], dt)
            _close(te.error[k], je.error[k], "bfloat16" if dt == "bfloat16"
                   else "float32")


# ---- the cases of tests/test_optim.py -------------------------------------

def test_adamw_converges_on_quadratic():
    params = {"w": torch.tensor([5.0, -3.0, 2.0])}
    target = torch.tensor([1.0, 2.0, -1.0])
    state = adamw.init(params)
    for _ in range(300):
        g = {"w": 2 * (params["w"] - target)}
        params, state, _ = adamw.update(g, state, params, lr=5e-2,
                                        weight_decay=0.0)
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(),
                               atol=1e-2)


def test_grad_clip():
    g = {"a": torch.full((10,), 100.0)}
    clipped, norm = adamw.clip_by_global_norm(g, 1.0)
    assert float(norm) > 1.0
    assert abs(float(adamw.global_norm(clipped)) - 1.0) < 1e-5


def test_schedule_warmup_and_decay():
    kw = dict(peak_lr=1.0, warmup_steps=10, total_steps=100)
    assert float(schedule.cosine_with_warmup(0, **kw)) == 0.0
    assert abs(float(schedule.cosine_with_warmup(10, **kw)) - 1.0) < 1e-6
    assert float(schedule.cosine_with_warmup(100, **kw)) < 0.2


@pytest.mark.parametrize("seed", range(0, 10_000, 1000))
def test_quantize_roundtrip_bounded(seed):
    g = torch.randn(1000, generator=torch.Generator().manual_seed(seed)) * 10
    rt = compress.compress_decompress(g)
    scale = g.reshape(-1, 250).abs().amax(dim=1)
    assert float((rt - g).abs().max()) <= float(scale.max()) / 127.0 + 1e-6


def test_error_feedback_is_unbiased_over_time():
    gen = torch.Generator().manual_seed(0)
    ef = compress.init_error_feedback({"w": torch.zeros(256)})
    total_true = torch.zeros(256)
    total_sent = torch.zeros(256)
    for _ in range(50):
        g = {"w": torch.randn(256, generator=gen)}
        sent, ef = compress.apply_error_feedback(g, ef)
        total_true += g["w"]
        total_sent += sent["w"]
    resid = ef.error["w"]
    np.testing.assert_allclose((total_sent + resid).numpy(),
                               total_true.numpy(), rtol=1e-4, atol=1e-4)
    assert float(resid.abs().max()) < 0.2


# ---- the cases of tests/test_fault_tolerance.py ---------------------------

def test_watchdog_flags_straggler():
    wd = StepWatchdog(min_samples=8)
    for _ in range(20):
        assert not wd.record(1.0)
    assert wd.record(30.0)
    assert wd.stragglers == 1


def test_watchdog_tolerates_jitter():
    import random
    rnd = random.Random(0)
    wd = StepWatchdog(min_samples=8)
    assert sum(wd.record(1.0 + rnd.random() * 0.02) for _ in range(50)) == 0


def test_run_with_restarts_resumes():
    crashes = {"n": 0}
    log = []

    def step(t):
        if t == 5 and crashes["n"] < 2:
            crashes["n"] += 1
            raise RuntimeError("node died")
        log.append(t)
        return t + 1

    final = run_with_restarts(step, start_step=0, total_steps=10,
                              max_restarts=3, on_restart=lambda t, e: 3)
    assert final == 10 and crashes["n"] == 2
    assert log.count(4) == 3


def test_run_with_restarts_gives_up():
    def step(t):
        raise RuntimeError("hard fail")

    with pytest.raises(RuntimeError):
        run_with_restarts(step, start_step=0, total_steps=3, max_restarts=1,
                          on_restart=lambda t, e: t)


def test_elastic_mesh_shape():
    assert elastic_mesh_shape(256, 16) == (16, 16)
    assert elastic_mesh_shape(192, 16) == (12, 16)
    assert elastic_mesh_shape(100, 16) == (25, 4)
    assert elastic_mesh_shape(7, 16) == (7, 1)


# ---- the cases of tests/test_checkpoint.py, and across the packages -------

def _ctree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn(8, 16, generator=g),
            "nested": {"b": torch.arange(5, dtype=torch.float32),
                       "scale": torch.ones(3, dtype=torch.bfloat16)}}


def _meta(tree):
    return {k: _meta(v) if isinstance(v, dict) else
            torch.empty(v.shape, dtype=v.dtype, device="meta")
            for k, v in tree.items()}


def test_roundtrip(tmp_path):
    t = _ctree()
    ckpt.save(str(tmp_path), 7, t)
    got, meta = ckpt.restore(str(tmp_path), _meta(t))
    assert meta["step"] == 7
    for x, y in ((t["w"], got["w"]), (t["nested"]["b"], got["nested"]["b"]),
                 (t["nested"]["scale"], got["nested"]["scale"])):
        assert x.dtype == y.dtype
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_rotation_keeps_newest(tmp_path):
    for s in range(6):
        ckpt.save(str(tmp_path), s, _ctree(), keep=3)
    assert ckpt.all_steps(str(tmp_path)) == [3, 4, 5]
    assert ckpt.latest_step(str(tmp_path)) == 5


def test_crashed_writer_does_not_corrupt(tmp_path):
    t = _ctree()
    ckpt.save(str(tmp_path), 1, t)
    stale = tmp_path / "step_00000002.tmp"
    stale.mkdir()
    (stale / "arrays.npz").write_bytes(b"garbage")
    assert ckpt.latest_step(str(tmp_path)) == 1
    _, meta = ckpt.restore(str(tmp_path), _meta(t))
    assert meta["step"] == 1
    ckpt.save(str(tmp_path), 2, t)
    assert ckpt.latest_step(str(tmp_path)) == 2


def test_restore_casts_dtype(tmp_path):
    ckpt.save(str(tmp_path), 0, {"w": torch.ones(4, 4)})
    got, _ = ckpt.restore(str(tmp_path), {
        "w": torch.empty(4, 4, dtype=torch.bfloat16, device="meta")})
    assert got["w"].dtype == torch.bfloat16 and got["w"].device.type == "cpu"


def test_lazy_leaves_and_namedtuples(tmp_path):
    """A callable leaf is written as its value; a NamedTuple's fields and a
    list's indices name their leaves as jax.tree_util does."""
    st = adamw.AdamWState(step=torch.tensor(3, dtype=torch.int32),
                          mu={"x": torch.ones(2)}, nu={"x": torch.zeros(2)})
    tree = {"opt": st, "xs": [lambda: torch.full((2,), 5.0), None]}
    ckpt.save(str(tmp_path), 1, tree)
    meta = ckpt.restore(str(tmp_path), {"opt": {"step": torch.tensor(0)}})[1]
    assert meta["keys"] == ["opt/mu/x", "opt/nu/x", "opt/step", "xs/[0]"]
    got, _ = ckpt.restore(str(tmp_path), {"xs": [torch.empty(2)]})
    assert got["xs"][0].tolist() == [5.0, 5.0]


def test_checkpoints_cross_between_packages(tmp_path):
    """JAX's writer, the port's reader, and the other way round: the same
    keys, values and dtypes (bf16 stored as f32)."""
    t = _ctree(3)
    jt = jax.tree.map(lambda x: jnp.asarray(x.float().numpy()).astype(
        jnp.bfloat16 if x.dtype == torch.bfloat16 else jnp.float32), t)
    jckpt.save(str(tmp_path / "j"), 4, jt, extra={"who": "jax"})
    got, meta = ckpt.restore(str(tmp_path / "j"), _meta(t))
    assert meta["extra"] == {"who": "jax"}
    torch.testing.assert_close(got["w"], t["w"], rtol=0, atol=0)
    assert got["nested"]["scale"].dtype == torch.bfloat16

    ckpt.save(str(tmp_path / "t"), 5, t, extra={"who": "torch"})
    shape = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                         jt)
    jgot, jmeta = jckpt.restore(str(tmp_path / "t"), shape)
    assert jmeta["step"] == 5 and jmeta["extra"] == {"who": "torch"}
    assert jgot["nested"]["scale"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(jgot["w"]), t["w"].numpy())
    np.testing.assert_array_equal(np.asarray(jgot["nested"]["b"]),
                                  t["nested"]["b"].numpy())


def test_npz_members_read_from_their_offsets(tmp_path):
    """The direct reader of stored members gives ``np.load``'s arrays
    (Fortran order, 0-d, empty), and a compressed member still reads."""
    from repro_torch.checkpoint.manager import _read_member

    arrays = {"f": np.asfortranarray(np.arange(12.0).reshape(3, 4)),
              "s": np.int32(7), "e": np.zeros((0, 3), np.float32)}
    path = str(tmp_path / "a.npz")
    np.savez(path, **arrays)
    for k, v in arrays.items():
        got = _read_member(path, k)
        assert got.dtype == np.asarray(v).dtype and got.shape == np.shape(v)
        np.testing.assert_array_equal(got, v)
    np.savez_compressed(path, **arrays)
    np.testing.assert_array_equal(_read_member(path, "f"), arrays["f"])
