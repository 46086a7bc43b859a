"""Shared checks of the port's LM families against the live JAX package
(``tests/test_torch_lm_{moe,mla,vlm,encdec,xlstm,mamba2}.py``; the dense
decoders in ``tests/test_torch_lm_models.py``): the whole model's forward,
prefill and decode on JAX's weights converted bit for bit, the port's own
decode against its forward, the converter's bits, and the serve CLI. The
families: dense, moe (MoE and MLA), vlm, audio (enc-dec), ssm (xLSTM) and
hybrid (Zamba2); ``check_recurrent_against_jax`` is the last two's.

``TOL`` and ``OF_MAX`` are the tolerances of every LM parity test, the
dense ones of ``tests/test_torch_lm_models.py`` too (whose docstring says
why): fp32 logits rtol = atol = 2e-3, caches 1e-4; bf16 logits rtol 3e-2
and atol 3e-2 of the largest |logit|, caches rtol 3e-2 and atol 0.1.

xLSTM's bounds (``recurrent_tol``) are wider than ``TOL``: its
exponential gates, sLSTM's recurrence and mLSTM's normaliser amplify last
bits. Readings on xlstm-1.3b's smoke config at batch 3 over the forward,
the prefill and 11 decode steps, each as max |err| over the largest |value|
of its quantity: in fp32 the port against compiled JAX 5.8e-5 on the
logits and up to 1.2e-4 on the states (sLSTM h), and JAX against itself
with a seeded half of its weights moved one ulp up to 1.0e-4 (sLSTM h), so
``TOL``'s absolute 1e-4 cannot hold a state whose values exceed 1 (sLSTM n
is at least 1): the states get rtol 1e-4 and atol 1e-4 of each state's
largest |value|. In bf16 compiled JAX parts from op-by-op JAX by 27% on the
logits and 10-26% on the states, and the port from op-by-op JAX by 3.9% on
the logits and up to 6.4% on the states (6.7% at batch 1): rtol 3e-2 and
atol 8e-2 of the largest |value|, logits and states alike.

``eager_jax``: JAX runs under ``jax.disable_jit()``, each op as its own
computation (``lax.scan`` as a Python loop). The MoE family in bf16 needs
it: XLA's fusions of the compiled layer scan part bf16 roundings by an ulp
from the op-by-op values, a router input an ulp away can change an expert
choice, and a changed choice moves every later token's queue slot, so the
capacity drops cascade (deepseek's smoke config: 0.85 in layer 1's latent
cache between JAX's own compiled and eager runs). Against eager JAX the
port's bf16 layers are bit-equal (layer by layer, measured on deepseek's
smoke config).
"""
import contextlib
import dataclasses
import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.configs as jconfigs
import repro.launch.serve as jserve
from repro.models import encdec as JED
from repro.models import recurrent as JR
from repro.models import transformer as JT
from repro.models.model import build_model as jbuild
import repro_torch.configs as tconfigs
import repro_torch.launch.serve as tserve
from repro_torch.convert import lm_params_from_jax
from repro_torch.models import encdec as ED
from repro_torch.models import moe as MOE
from repro_torch.models import recurrent as R
from repro_torch.models import transformer as T
from repro_torch.models.model import build_model, cache_leaves

ROOT = Path(__file__).resolve().parents[1]
TOL = {"float32": dict(logits=(2e-3, 2e-3), cache=(1e-4, 1e-4)),
       "bfloat16": dict(logits=(3e-2, 3e-2), cache=(3e-2, 0.1))}
OF_MAX = {"float32": False, "bfloat16": True}     # logits' atol
DECODE_TOL = 2e-3       # tests/test_decode_consistency.py's bound
B, S = 2, 13
VLM_GATE = 0.5


def example(name):
    """``examples/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        f"_ex_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def pair(arch, dtype, **kw):
    """(JAX cfg, port cfg) of the smoke config in ``dtype``."""
    return (jconfigs.get_smoke_config(arch).scaled(dtype=dtype, **kw),
            tconfigs.get_smoke_config(arch).scaled(dtype=dtype, **kw))


def jax_params(jcfg, seed=0):
    """JAX's weights, a VLM's cross gates set to VLM_GATE (zero at init,
    which would leave the cross attention out of every output)."""
    params = jbuild(jcfg).init(jax.random.key(seed))
    if jcfg.cross_attn_every:
        cross = params["groups"]["cross"]
        cross["gate"] = jnp.full_like(cross["gate"], VLM_GATE)
    return params


def np_tree(params):
    return jax.tree.map(np.asarray, params)


def to_f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def close(got, want, tol, of_max=False):
    """``tol`` = (rtol, atol); ``of_max``: atol is a fraction of the
    largest |want|. Returns the largest |got - want|."""
    rtol, atol = tol
    want = to_f32(want)
    if of_max:
        atol *= float(np.abs(want).max())
    got = to_f32(got)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
    return float(np.abs(got - want).max())


def inputs(cfg, s, seed=1):
    """numpy tokens (B, s) and the family's stub input (image embeddings
    or frames, f32 normal draws), or None."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, s), dtype=np.int32)
    extra = None
    if cfg.family == "vlm":
        extra = rng.standard_normal((B, cfg.num_image_tokens, cfg.d_model))
    elif cfg.family == "audio":
        extra = rng.standard_normal((B, cfg.num_audio_frames, cfg.d_model))
    return toks, None if extra is None else extra.astype(np.float32)


def batches(cfg, toks, extra):
    """(JAX batch, port batch) of the same values in the model dtype."""
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if extra is not None:
        name = "image_embed" if cfg.family == "vlm" else "frames"
        jdt = jnp.bfloat16 if cfg.dtype == "bfloat16" else jnp.float32
        tdt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
        jb[name] = jnp.asarray(extra).astype(jdt)
        tb[name] = torch.from_numpy(extra).to(tdt)
    return jb, tb


def jax_forward(params, jcfg, batch):
    if jcfg.family == "ssm":
        return JR.xlstm_forward(params, jcfg, batch["tokens"])[0], 0.0
    if jcfg.family == "hybrid":
        return JR.hybrid_forward(params, jcfg, batch["tokens"])[0], 0.0
    if jcfg.family == "audio":
        enc = JED.encode(params, jcfg, batch["frames"])
        return JED.decode_train(params, jcfg, batch["tokens"], enc)[0], 0.0
    logits, aux, _ = JT.transformer_forward(
        params, jcfg, batch["tokens"], image_embed=batch.get("image_embed"))
    return logits, aux


def port_forward(model, cfg, batch):
    if cfg.family == "ssm":
        return R.xlstm_forward(model, cfg, batch["tokens"])[0], 0.0
    if cfg.family == "hybrid":
        return R.hybrid_forward(model, cfg, batch["tokens"])[0], 0.0
    if cfg.family == "audio":
        enc = ED.encode(model, cfg, batch["frames"])
        return ED.decode_train(model, cfg, batch["tokens"], enc)[0], 0.0
    logits, aux, _ = T.transformer_forward(
        model, cfg, batch["tokens"], image_embed=batch.get("image_embed"))
    return logits, aux


def prompt_of(batch, s):
    return {k: (v[:, :s] if k == "tokens" else v) for k, v in batch.items()}


def check_against_jax(arch, dtype, eager_jax=False, s=S):
    """The teacher-forced logits (and the MoE aux loss) on s + 1 tokens,
    the prefill's last-position logits and every cache padded to max_len,
    one decode step's logits and caches, on JAX's weights. The prompt is
    the first s tokens, or with ``eager_jax`` all s + 1 (the forward's
    shapes again: op-by-op JAX compiles each op once a shape). Returns the
    number of expert choices the port's forward dropped at capacity."""
    jcfg, cfg = pair(arch, dtype)
    params = jax_params(jcfg)
    model = lm_params_from_jax(cfg, np_tree(params), device="cpu")
    tol, of_max = TOL[dtype], OF_MAX[dtype]
    toks, extra = inputs(cfg, s + 2)
    jb, tb = batches(cfg, toks, extra)
    fwd = s + 1
    p = s + 1 if eager_jax else s
    mode = jax.disable_jit() if eager_jax else contextlib.nullcontext()
    jm, tm = jbuild(jcfg), build_model(cfg)
    max_len = s + 4
    with mode:
        want, jaux = jax_forward(params, jcfg, prompt_of(jb, fwd))
        jl, jc = jm.prefill(params, prompt_of(jb, p), max_len)
        jd, jc2 = jm.decode_step(params, jb["tokens"][:, p], jc, p,
                                 batch=jb)
    with MOE.record_routing() as tape:
        got, aux = port_forward(model, cfg, prompt_of(tb, fwd))
    assert got.dtype == torch.float32 and got.shape == (B, fwd,
                                                        cfg.vocab_size)
    close(got, want, tol["logits"], of_max)
    if cfg.moe is not None:
        assert aux.dtype == torch.float32
        np.testing.assert_allclose(float(aux), float(jaux),
                                   rtol=1e-6 if dtype == "float32" else 1e-3)

    tl, tc = tm.prefill(model, prompt_of(tb, p), max_len)
    close(tl, jl, tol["logits"], of_max)
    assert set(tc) == set(jc)
    for name in jc:
        assert tc[name].shape == jc[name].shape, name
        assert str(tc[name].dtype).endswith(jc[name].dtype.name)
        close(tc[name], jc[name], tol["cache"])
        if name not in ("xk", "xv"):          # the sequence axis is -2 / -3
            axis = tc[name].ndim - (2 if name in ("ckv", "krope") else 3)
            assert float(tc[name].narrow(axis, p, max_len - p).abs()
                         .max()) == 0.0, name
    tl, tc = tm.decode_step(model, tb["tokens"][:, p], tc, p, batch=tb)
    close(tl, jd, tol["logits"], of_max)
    for name in jc2:
        close(tc[name], jc2[name], tol["cache"])
    return sum(int((~rec["kept"]).sum()) for rec in tape)


RECURRENT_STEPS = 11
RECURRENT_BATCH = 3     # JAX's run; a smaller batch reads its first rows
# each recurrent cache leaf's batch axis, after its stacked layer axes
BATCH_AXIS = {"mlstm": 2, "slstm": 1, "mamba": 2, "k": 1, "v": 1}


def recurrent_tol(cfg):
    """((logits tol, of_max), (states tol, of_max)) of a recurrent family
    in its dtype (the module docstring gives xLSTM's readings)."""
    dt = cfg.dtype
    if cfg.family == "ssm":
        if dt == "float32":
            return (TOL[dt]["logits"], False), ((1e-4, 1e-4), True)
        return ((3e-2, 8e-2), True), ((3e-2, 8e-2), True)
    return (TOL[dt]["logits"], OF_MAX[dt]), (TOL[dt]["cache"], False)


def check_states(got, want, tol, of_max, what=""):
    """Every leaf of the port's cache against JAX's ``want``, a list of
    (name, array) as ``cache_leaves`` names them (a dict of arrays and
    state tuples): names, shapes, dtypes and values (``of_max``: atol a
    fraction of each leaf's largest |value|)."""
    g = cache_leaves(got)
    assert [n for n, _ in g] == [n for n, _ in want], what
    for (name, a), (_, b) in zip(g, want):
        assert tuple(a.shape) == b.shape, (what, name)
        assert str(a.dtype).endswith(b.dtype.name), (what, name)
        close(a, b, tol, of_max)


def jax_recurrent_run(jcfg, params, eager_jax=False, s=S):
    """JAX's side of :func:`check_recurrent_against_jax`, at
    RECURRENT_BATCH rows of seeded tokens: (tokens, forward logits, [(what,
    logits, state leaves)] of the prefill and each decode step). The
    prefill runs on the forward's s + 1 tokens (one set of shapes for
    op-by-op JAX); ``eager_jax``: op by op (``jax.disable_jit()``)."""
    toks = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (RECURRENT_BATCH, s + 1 + RECURRENT_STEPS),
        dtype=np.int32)
    jt, p = jnp.asarray(toks), s + 1
    jm = jbuild(jcfg)
    mode = jax.disable_jit() if eager_jax else contextlib.nullcontext()
    with mode:
        forward, _ = jax_forward(params, jcfg, {"tokens": jt[:, :p]})
        jl, jc = jm.prefill(params, {"tokens": jt[:, :p]},
                            p + RECURRENT_STEPS + 1)
        stages = [("prefill", jl, cache_leaves(jc))]
        for pos in range(p, p + RECURRENT_STEPS):
            jl, jc = jm.decode_step(params, jt[:, pos], jc, pos)
            stages.append((f"decode at {pos}", jl, cache_leaves(jc)))
    return toks, forward, stages


def rows(leaves, batch):
    """State leaves cut to their first ``batch`` rows (``BATCH_AXIS``)."""
    return [(name, a[(slice(None),) * BATCH_AXIS[name.split(".")[0]]
                     + (slice(0, batch),)]) for name, a in leaves]


def check_recurrent_against_jax(cfg, model, run, batch, s=S):
    """A recurrent family on JAX's weights (``model``, converted from
    JAX's params) against JAX's ``run`` (:func:`jax_recurrent_run`) on its
    first ``batch`` rows: the teacher-forced logits on s + 1 tokens, the
    prefill on the same s + 1 tokens with every state and its K/V zero
    past the prompt, then RECURRENT_STEPS decode steps, each step's logits
    and every state, at ``recurrent_tol``."""
    (ltol, lmax), (stol, smax) = recurrent_tol(cfg)
    toks, forward, stages = run
    tt, p = torch.from_numpy(toks[:batch]), s + 1
    tm = build_model(cfg)
    got, _ = port_forward(model, cfg, {"tokens": tt[:, :p]})
    assert got.dtype == torch.float32 and got.shape == (batch, p,
                                                        cfg.vocab_size)
    close(got, forward[:batch], ltol, lmax)
    tl, tc = tm.prefill(model, {"tokens": tt[:, :p]}, p + RECURRENT_STEPS + 1)
    if "k" in tc:
        for name in ("k", "v"):
            assert float(tc[name][:, :, p:].abs().max()) == 0.0, name
    for i, (what, jl, jleaves) in enumerate(stages):
        if i:
            tl, tc = tm.decode_step(model, tt[:, p + i - 1], tc, p + i - 1)
        close(tl, jl[:batch], ltol, lmax)
        check_states(tc, rows(jleaves, batch), stol, smax, what)


def lossless(cfg):
    """A MoE config whose capacity drops nothing (factor E >= E / K), as
    tests/test_decode_consistency.py takes it."""
    if cfg.moe is None:
        return cfg
    return cfg.scaled(moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.num_experts)))


def check_decode_matches_forward(arch, s=S, steps=1):
    """The port alone, fp32, seeded weights (a VLM's gates at VLM_GATE):
    prefill on s tokens and ``steps`` decode steps against the
    teacher-forced logits at positions s - 1, s, ..., within DECODE_TOL."""
    cfg = lossless(tconfigs.get_smoke_config(arch).scaled(dtype="float32"))
    m = build_model(cfg)
    model = m.init(0, "cpu")
    if cfg.cross_attn_every:
        for p in model.groups.cross:
            p.gate.fill_(VLM_GATE)
    _, tb = batches(cfg, *inputs(cfg, s + steps, seed=2))
    full, _ = port_forward(model, cfg, tb)
    lp, cache = m.prefill(model, prompt_of(tb, s), s + steps + 3)
    close(lp, full[:, s - 1], (DECODE_TOL, DECODE_TOL))
    for pos in range(s, s + steps):
        ld, cache = m.decode_step(model, tb["tokens"][:, pos], cache, pos,
                                  batch=tb)
        close(ld, full[:, pos], (DECODE_TOL, DECODE_TOL))
    return model


def jax_leaves(tree, stacks):
    """{port state_dict name: numpy array} of the JAX params ``tree``,
    each leaf under a stacked subtree (``stacks``: dotted path -> number of
    stacked axes) cut into its layers."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        names = [p.key for p in path]
        dotted = ".".join(names)
        for prefix, n_axes in stacks.items():
            if dotted.startswith(prefix + "."):
                rest = dotted[len(prefix) + 1:]
                for idx in np.ndindex(*leaf.shape[:n_axes]):
                    out[".".join([prefix, *map(str, idx), rest])] = leaf[idx]
                break
        else:
            out[dotted] = leaf
    return out


def check_converter_bits(arch, stacks):
    """Every array of JAX's bf16 tree lands in the port's state_dict under
    its name with its dtype and bits, and nothing else is there."""
    jcfg, cfg = pair(arch, "bfloat16")
    tree = np_tree(jbuild(jcfg).init(jax.random.key(0)))
    model = lm_params_from_jax(cfg, tree, device="cpu")
    sd = model.state_dict()
    want = jax_leaves(tree, stacks)
    assert set(sd) == set(want)
    for name, arr in want.items():
        arr = np.asarray(arr)
        t = sd[name]
        assert str(t.dtype).endswith(arr.dtype.name), name
        assert tuple(t.shape) == arr.shape, name
        if arr.dtype.name == "bfloat16":
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          arr.view(np.int16), err_msg=name)
        else:
            np.testing.assert_array_equal(t.numpy(), arr, err_msg=name)
    assert not any(p.requires_grad for p in model.parameters())
    return tree, cfg


def check_cli(arch, capsys):
    """The port's serve CLI on the CPU against JAX's: the same requests,
    decode steps and tokens."""
    flags = ["--arch", arch, "--smoke", "--requests", "3", "--max-new", "4"]
    tserve.main(["--device", "cpu"] + flags)
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    jserve.main(flags)
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(got) == set(want) == {"requests", "decode_steps", "wall_s",
                                     "tokens"}
    for k in ("requests", "decode_steps", "tokens"):
        assert got[k] == want[k], k


def check_server(arch, kw=None):
    """``Server.run`` in fp32 on JAX's weights (a VLM's gates at VLM_GATE)
    with the same prompts, as ``tests/test_torch_lm_serve.py`` runs the
    dense configs: 5 requests through 2 slots, prompts of 9 tokens, up to
    6 new tokens, max_len 14; every request's greedy tokens, the decode
    steps and the token count equal."""
    jcfg, cfg = pair(arch, "float32", **(kw or {}))
    params = jax_params(jcfg)
    model = lm_params_from_jax(cfg, np_tree(params), device="cpu")
    skw = dict(smoke=True, batch_slots=2, max_len=14)
    jsrv = jserve.Server(arch, **skw)
    jsrv.cfg, jsrv.model, jsrv.params = jcfg, jbuild(jcfg), params
    tsrv = tserve.Server(arch, device="cpu", **skw)
    tsrv.cfg, tsrv.model, tsrv.params = cfg, build_model(cfg), model
    key = jax.random.key(7)
    jprompts = [jax.random.randint(jax.random.fold_in(key, i), (9,), 0,
                                   cfg.vocab_size) for i in range(5)]
    tprompts = tserve.prompts(5, 9, cfg.vocab_size, "cpu")
    jreqs = [jserve.Request(rid=i, prompt=p, max_new=6 if i != 3 else 3)
             for i, p in enumerate(jprompts)]
    treqs = [tserve.Request(rid=i, prompt=p, max_new=6 if i != 3 else 3)
             for i, p in enumerate(tprompts)]
    want, got = jsrv.run(jreqs), tsrv.run(treqs)
    assert [r.out for r in treqs] == [r.out for r in jreqs]
    for k in ("requests", "decode_steps", "tokens"):
        assert got[k] == want[k], k
