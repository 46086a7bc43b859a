"""``fused_xent``'s mesh branch, ``roofline.op_cost`` and the dry run
against the JAX package.

* ``fused_xent`` under a mesh's logical rules, with the vocab axis (the
  chunked branch, its last chunk padded) and without it (one full logits
  block): JAX's value and gradients on a 1-device mesh, the port's on
  plain tensors here and on DTensors over a 1-rank gloo mesh, within
  ``LOSS_RTOL`` (1e-5) and ``GRAD_TOL`` (rtol 2e-3, atol 2e-4 of the
  largest gradient; read: 1.0e-7 on the loss, 2.3e-7 of the largest
  gradient).
* ``op_cost`` against ``hlo_cost`` on ``tests/test_hlo_cost.py``'s cases:
  one matmul, a batched one, a loop of 13 products, nested loops of 5 x 3,
  and ten iterations, which count ten (eager runs every iteration; XLA's
  ``cost_analysis`` counts a while body once); the all-reduce and the
  all-gather of that file's HLO, run on a fake world of 256 ranks.
* Per rank, not global: a (256, 4096, 2048) @ (2048, 8192) product sharded
  on the (16, 16) mesh counts 1/256 of ``FlopCounterMode``'s global figure.
* The dry run's internlm2-1.8b x decode_32k row: its per-rank argument
  bytes are the sum over JAX's params and cache of each leaf's bytes over
  its spec's shard factor, plus the replicated token batch.
* ``dryrun_medoid_engine`` for v1 (n = 2^12) and v2 (n = 2^14), d = 64,
  on the fake world: an ``ok`` row each, flops counted, the argument bytes
  rank 0's shard of rows, (n / 256) * d * 4, and the engines' own
  ``torch.distributed`` collectives counted as DTensor's are.
* The dry run's internlm2-1.8b x train_4k row, cut to one layer, on
  (16, 16) and (2, 16, 16): twice the cards split the same step, so a
  rank's flops fall (its tokens halve: 1 row of 4096 against 8 rows of
  256), and the flops of one rank times the ranks stay within 1.2x of the
  model's. A step whose products ran the whole sequence on each of the
  16 ranks of the model axis counted ~7.6x more on (2, 16, 16) instead.
  The (2, 16, 16) row's temporaries stay within the (16, 16) row's: its
  loss no longer gathers a chunk's logits gradient (12.1 of 13.4 GB).
* ``fused_xent`` alone on the fake (16, 16) world, laid out as the
  (2, 16, 16) train cell lays it out (x by batch and sequence, the head
  by vocab rows, at ``_torch_mesh_probe.XENT``'s widths): forward and
  backward peak at most 6 local chunk blocks (B_loc, c, V / 16) in f32
  (4.76; 35.8 when DTensor's ``logsumexp`` gathered the vocab), every
  all-reduce is of one (B_loc, c) row, and no collective moves logits
  (the one all-gather and reduce-scatter carry x and its gradient).

The process groups live in ``_torch_mesh_probe.py``'s two processes (the
256-rank world, the 512-rank one), started first and read last."""
import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_mesh_probe import XENT
from _torch_train import GRAD_TOL, LOSS_RTOL
from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget
from repro.configs.registry import cache_specs as jcache_specs
from repro.launch import partition as JP
from repro.launch.mesh import logical_rules as jlogical_rules
from repro.models.model import build_model as jbuild
from repro.models.model import fused_xent as jfused_xent
from repro.models.sharding import logical_axis_rules as jrules
from repro.roofline import hlo_cost
from repro_torch.models.model import fused_xent
from repro_torch.models.sharding import logical_axis_rules
from repro_torch.roofline import op_cost

pytestmark = pytest.mark.torch_port

TESTS = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(TESTS), "src")
TIMEOUT_S = 150
B, S, D, V, CHUNK = 2, 40, 16, 64, 16     # 39 targets: chunks 16, 16, 7 + 9
BRANCHES = {"chunked": "model", "full": None}
COLLECTIVES_HLO = """
ENTRY %main (p: f32[16]) -> f32[16] {
  %p = f32[16]{0} parameter(0)
  %all-reduce.1 = f32[1024,512]{1,0} all-reduce(%p), to_apply=%add
  %ag = bf16[2048]{0} all-gather(%p), dimensions={0}
  ROOT %r = f32[16]{0} copy(%p)
}
"""


def _inputs():
    rs = np.random.RandomState(0)
    return {"x": rs.randn(B, S, D).astype(np.float32),
            "head": rs.randn(V, D).astype(np.float32),
            "tokens": rs.randint(0, V, (B, S)).astype(np.int64),
            "chunk": np.asarray(CHUNK)}


def _jax_xent(data):
    """{branch: (loss, dx, dhead)} of JAX's fused_xent on a 1-device mesh
    under its logical rules."""
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))
    out = {}
    for name, vocab in BRANCHES.items():
        rules = dict(jlogical_rules(mesh), vocab=vocab)

        def f(x, h):
            with jrules(rules):
                return jfused_xent(x, jnp.asarray(data["tokens"], jnp.int32),
                                   h, chunk=CHUNK)
        with mesh:
            v, (gx, gh) = jax.jit(jax.value_and_grad(f, argnums=(0, 1)))(
                data["x"], data["head"])
        out[name] = (float(v), np.asarray(gx), np.asarray(gh))
    return out


@pytest.fixture(scope="module")
def probe(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_probe")
    data = _inputs()
    np.savez(tmp / "in.npz", **data)
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    probe = os.path.join(TESTS, "_torch_mesh_probe.py")
    procs = [subprocess.Popen(
        [sys.executable, probe, *args], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for args in (
            (str(tmp / "store"), str(tmp / "in.npz"), str(tmp / "out.json")),
            ("--multi-pod", str(tmp / "pod.json")))]
    try:
        want = _jax_xent(data)
        errs = [p.communicate(timeout=TIMEOUT_S)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err[-3000:]
    got = json.loads((tmp / "out.json").read_text())
    got["train_rows"] = {
        "16x16": got.pop("train_row"),
        "2x16x16": json.loads((tmp / "pod.json").read_text())["train_row"]}
    return data, want, got


def _close(loss, dx, dhead, want):
    wl, wx, wh = want
    np.testing.assert_allclose(loss, wl, rtol=LOSS_RTOL)
    rtol, atol = GRAD_TOL
    top = max(np.abs(wx).max(), np.abs(wh).max())
    np.testing.assert_allclose(dx, wx, rtol=rtol, atol=atol * top)
    np.testing.assert_allclose(dhead, wh, rtol=rtol, atol=atol * top)


@pytest.mark.parametrize("branch", BRANCHES)
def test_fused_xent_on_a_mesh_matches_jax(probe, branch):
    _, want, got = probe
    g = got["xent"][branch]
    _close(g["loss"], np.asarray(g["dx"]), np.asarray(g["dhead"]),
           want[branch])


@pytest.mark.parametrize("branch", BRANCHES)
def test_fused_xent_under_rules_on_plain_tensors_matches_jax(probe, branch):
    data, want, _ = probe
    x = torch.tensor(data["x"], requires_grad=True)
    head = torch.tensor(data["head"], requires_grad=True)
    rules = {"batch": ("data",), "model": "model", "vocab": BRANCHES[branch]}
    with logical_axis_rules(rules):
        loss = fused_xent(x, torch.from_numpy(data["tokens"]), head,
                          chunk=CHUNK)
    loss.backward()
    _close(float(loss.detach()), x.grad.numpy(), head.grad.numpy(),
           want[branch])


def test_fused_xent_on_one_rank_is_the_plain_branch_bit_for_bit(probe):
    """On the 1-rank mesh the vocab-parallel branch's all-reduces are the
    identity and its backward rounds as autograd does through the plain
    branch, so the sharded trainer's losses on one rank equal the
    unsharded ones exactly (``chip_smoke.py``'s phase 12a)."""
    data, _, got = probe
    x = torch.tensor(data["x"], requires_grad=True)
    head = torch.tensor(data["head"], requires_grad=True)
    loss = fused_xent(x, torch.from_numpy(data["tokens"]), head, chunk=CHUNK)
    loss.backward()
    g = got["xent"]["chunked"]
    assert np.float32(g["loss"]) == loss.detach().numpy()
    np.testing.assert_array_equal(np.asarray(g["dx"], np.float32),
                                  x.grad.numpy())
    np.testing.assert_array_equal(np.asarray(g["dhead"], np.float32),
                                  head.grad.numpy())


def _hlo(f, *shapes):
    args = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    return hlo_cost.analyze(jax.jit(f).lower(*args).compile().as_text())


def _scan(n, A):
    def f(x):
        y, _ = jax.lax.scan(lambda c, _: (c @ A, 0), x, jnp.arange(n))
        return y
    return f


def _nested(A):
    def f(x):
        def outer(c, _):
            y, _ = jax.lax.scan(lambda c2, _: (c2 @ A, 0), c, jnp.arange(3))
            return y, 0
        y, _ = jax.lax.scan(outer, x, jnp.arange(5))
        return y
    return f


def _loop(n, a, b):
    for _ in range(n):
        a = a @ b
    return a


CASES = {
    "single_matmul": (lambda: _hlo(lambda a, b: a @ b, (64, 128), (128, 32)),
                      lambda: torch.zeros(64, 128) @ torch.zeros(128, 32)),
    "batched_dot": (lambda: _hlo(lambda a, b: jnp.einsum("bij,bjk->bik", a, b),
                                 (4, 8, 16), (4, 16, 32)),
                    lambda: torch.einsum("bij,bjk->bik", torch.zeros(4, 8, 16),
                                         torch.zeros(4, 16, 32))),
    "scan_13": (lambda: _hlo(_scan(13, jnp.zeros((128, 128))), (8, 128)),
                lambda: _loop(13, torch.zeros(8, 128), torch.zeros(128, 128))),
    "nested_5x3": (lambda: _hlo(_nested(jnp.zeros((64, 64))), (4, 64)),
                   lambda: _loop(15, torch.zeros(4, 64), torch.zeros(64, 64))),
    "ten_iterations": (lambda: _hlo(_scan(10, jnp.zeros((128, 128))),
                                    (8, 128)),
                       lambda: _loop(10, torch.zeros(8, 128),
                                     torch.zeros(128, 128))),
}


@pytest.mark.parametrize("case", CASES)
def test_op_cost_flops_match_hlo_cost(case):
    jax_case, torch_case = CASES[case]
    want = jax_case()
    _, got = op_cost.analyze(torch_case)
    assert got.dot_flops == want.dot_flops
    if case == "ten_iterations":
        one = 2 * 8 * 128 * 128
        assert got.dot_flops == 10 * one and want.unknown_while == 0


def test_op_cost_collectives_match_hlo_cost(probe):
    _, _, got = probe
    want = hlo_cost.analyze(COLLECTIVES_HLO).collective_by_kind
    for kind in ("all-reduce", "all-gather"):
        assert got["collectives"][kind] == want[kind], kind
    assert got["collectives"]["all-reduce"] == 2 * 1024 * 512 * 4


def test_op_cost_counts_one_rank(probe):
    _, _, got = probe
    global_flops = 2 * 256 * 4096 * 2048 * 8192
    assert got["matmul"]["flop_counter"] == global_flops     # 7.04e13
    assert got["matmul"]["op_cost"] == global_flops / 256


def _shard_bytes(shapes, specs, sizes) -> int:
    total = 0
    leaves = jax.tree_util.tree_leaves(shapes)
    spec_leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
    assert len(leaves) == len(spec_leaves)
    for leaf, spec in zip(leaves, spec_leaves):
        n = math.prod(sizes[a] for ax in spec if ax is not None
                      for a in ((ax,) if isinstance(ax, str) else ax))
        nbytes = math.prod(leaf.shape) * leaf.dtype.itemsize
        assert nbytes % n == 0
        total += nbytes // n
    return total


def test_dryrun_decode_arguments_are_jax_shard_bytes(probe):
    _, _, got = probe
    row = got["decode_row"]
    assert row["status"] == "ok" and row["chips"] == 256
    cfg, shape = jget("internlm2-1.8b"), JSHAPES["decode_32k"]

    class Mesh:
        axis_names = ("data", "model")
        devices = np.empty((16, 16), dtype=np.int8)
    sizes = {"data": 16, "model": 16}
    params = jax.eval_shape(lambda: jbuild(cfg).init(jax.random.key(0)))
    cache = jcache_specs(cfg, shape)
    want = _shard_bytes(params, JP.param_specs(params, cfg, Mesh), sizes) \
        + _shard_bytes(cache, JP.cache_specs_tree(
            cache, cfg, Mesh, shape.global_batch, seq_len=shape.seq_len),
            sizes) + shape.global_batch * 4   # the replicated int32 tokens
    assert row["per_device_bytes"]["arguments"] == want
    assert row["flops"] > 0 and row["collective_bytes"] > 0


def test_op_cost_counts_torch_distributed_collectives(probe):
    _, _, got = probe
    c = got["c10d_collectives"]
    assert c["all-reduce"] == got["collectives"]["all-reduce"]
    assert c["all-gather"] == 256 * 8 * 2


@pytest.mark.parametrize("engine", ("v1", "v2"))
def test_dryrun_medoid_engine_row(probe, engine):
    _, _, got = probe
    row = got["engine_rows"][engine]
    n, d = {"v1": 1 << 12, "v2": 1 << 14}[engine], 64
    assert row["status"] == "ok" and row["chips"] == 256
    assert row["arch"] == f"corrsh-engine-{engine}"
    assert row["flops"] > 0
    assert row["per_device_bytes"]["arguments"] == (n // 256) * d * 4
    assert row["collectives"]["bytes"]["all-reduce"] > 0
    assert row["collectives"]["bytes"]["all-gather"] > 0


def test_dryrun_train_flops_fall_as_the_cards_grow(probe):
    _, _, got = probe
    rows = got["train_rows"]
    one, two = rows["16x16"], rows["2x16x16"]
    assert one["status"] == two["status"] == "ok"
    assert (one["chips"], two["chips"]) == (256, 512)
    assert two["seq_shard"] and not one["seq_shard"]
    assert two["flops"] < 0.75 * one["flops"], (one["flops"], two["flops"])
    for row in (one, two):
        assert row["flops"] * row["chips"] < 1.2 * row["model_flops"], row


def test_dryrun_train_temp_on_two_pods_within_one_pods(probe):
    _, _, got = probe
    one, two = (got["train_rows"][m]["per_device_bytes"]["temp"]
                for m in ("16x16", "2x16x16"))
    assert two <= one, (one, two)


def test_fused_xent_reduces_across_vocab_shards(probe):
    _, _, got = probe
    r, n = got["xent_fake"], XENT
    block = n["B_loc"] * n["c"] * (n["V"] // 16) * 4
    assert r["peak"] <= 6 * block, r["peak"] / block
    kinds = {}
    for kind, shape in r["collectives"]:
        kinds.setdefault(kind, []).append(shape)
        assert shape[-1] != n["V"] // 16, (kind, shape)    # no logits
    chunks = -(-(n["S"] - 1) // n["c"])
    # max, sum of exponentials, target logit: forward and recompute
    assert kinds.pop("all-reduce") == [[n["B_loc"], n["c"]]] * (
        3 * 2 * chunks)
    assert all(s[-1] == n["d"] for v in kinds.values() for s in v), kinds
