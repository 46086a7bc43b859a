"""The port's partition specs, input specs and cache specs against the JAX
package's, on every registered config.

JAX's partition functions read only ``mesh.axis_names`` and
``mesh.devices.shape``, so a stand-in with those two attributes takes the
place of a 256- or 512-device mesh; the port's take the plain (axis names,
sizes) pair. The shapes come from JAX's ``eval_shape`` and the port's
``meta`` init. The port keeps one tensor a layer where JAX stacks the
layers on leading axes: a port spec is JAX's without its layer entries,
exactly, on (16, 16), (2, 16, 16) and (2, 4). The exceptions are listed
by name in ``LAYER_DIM_LEAVES``: the leaves whose ZeRO (``zero_specs``) or
pure-FSDP spec JAX puts on a layer dim, its "first divisible dim"; the port
shards the first free trailing dim its axes divide instead, which the test
derives from JAX's spec."""
import math

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec

from repro.configs import SHAPES as JSHAPES
from repro.configs import cell_is_supported as jsupported
from repro.configs import get_config as jget
from repro.configs.registry import ARCH_NAMES
from repro.configs.registry import cache_specs as jcache_specs
from repro.configs.registry import input_specs as jinput_specs
from repro.launch import partition as JP
from repro.models.model import build_model as jbuild
from repro_torch.configs import SHAPES, cache_specs, get_config, input_specs
from repro_torch.launch import partition as TP

pytestmark = pytest.mark.torch_port

MESHES = {"16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16)),
          "2x4": (("data", "model"), (2, 4))}

_ATTN = ["attn/wk", "attn/wo", "attn/wq", "attn/wv"]
_DENSE = [f"layers/{p}" for p in _ATTN] + [
    "layers/ffn/w_down", "layers/ffn/w_gate", "layers/ffn/w_up"]
_GRANITE = sorted(_DENSE + ["layers/ffn/router"])
_VLM = [f"groups/{g}/{p}" for g in ("cross", "self") for p in _ATTN + [
    "ffn/w_down", "ffn/w_gate", "ffn/w_up"]]
_ALL = ("16x16", "2x16x16", "2x4")
# (arch, "zero" | "fsdp") -> {mesh: reference paths whose spec JAX puts on a
# layer dim}
LAYER_DIM_LEAVES = {
    ("command-r-35b", "fsdp"): {"2x4": _DENSE},
    ("command-r-35b", "zero"): {"2x4": _DENSE},
    ("gemma3-27b", "zero"): {"2x4": _DENSE},
    ("granite-moe-3b-a800m", "fsdp"): {"2x4": _GRANITE},
    ("granite-moe-3b-a800m", "zero"): {m: _GRANITE for m in _ALL},
    ("internlm2-1.8b", "fsdp"): {"2x4": _DENSE},
    ("internlm2-1.8b", "zero"): {"2x4": _DENSE},
    ("llama-3.2-vision-11b", "fsdp"): {"2x4": _VLM},
    ("llama-3.2-vision-11b", "zero"): {"2x4": _VLM},
    ("qwen2.5-14b", "fsdp"): {"2x4": _DENSE},
    ("qwen2.5-14b", "zero"): {"16x16": _DENSE, "2x4": _DENSE},
    ("whisper-small", "zero"): {"2x4": [
        f"{s}/{p}" for s in ("dec/cross", "dec/self", "enc/attn")
        for p in ("wk", "wo", "wq", "wv")] + [
        f"{s}/{p}" for s in ("dec/mlp", "enc/mlp")
        for p in ("w_down", "w_up")]},
    ("xlstm-1.3b", "zero"): {"2x4": [
        f"groups/mlstm/{p}" for p in ("w_down", "w_k", "w_q", "w_up",
                                      "w_v")] + [
        f"groups/slstm/{p}" for p in ("R", "w_down", "w_in")]},
    ("zamba2-2.7b", "zero"): {"2x4": ["mamba/conv_w", "mamba/w_in",
                                      "mamba/w_out"]},
}


class JMesh:
    """What JAX's partition functions read of a mesh."""

    def __init__(self, names, sizes):
        self.axis_names = names
        self.devices = np.empty(sizes, dtype=np.int8)


def _is_spec(x):
    return isinstance(x, PartitionSpec)


def _jflat(tree) -> dict:
    return {JP._path_str(p): s for p, s in
            jax.tree_util.tree_flatten_with_path(tree, is_leaf=_is_spec)[0]}


def _tflat(tree, prefix="") -> dict:
    """{path: leaf} of the port's dicts and NamedTuples (a spec a leaf)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif hasattr(tree, "_fields") and not isinstance(tree, TP.P):
        items = zip(tree._fields, tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_tflat(v, f"{prefix}/{k}" if prefix else k))
    return out


def _moved(jspec, k, shape, sizes):
    """JAX's spec with its layer-dim axes moved to the first free trailing
    dim of the port's ``shape`` they divide (or dropped)."""
    full = tuple(jspec) + (None,) * (k + len(shape) - len(tuple(jspec)))
    out = list(full[k:])
    for ax in full[:k]:
        if ax is None:
            continue
        n = math.prod(sizes[a] for a in ((ax,) if isinstance(ax, str)
                                         else ax))
        for j, d in enumerate(shape):
            if out[j] is None and d % n == 0 and d >= n:
                out[j] = ax
                break
    return tuple(out)


@pytest.fixture(scope="module")
def shapes():
    cache = {}

    def get(arch):
        if arch not in cache:
            cfg = jget(arch)
            cache[arch] = (cfg, jax.eval_shape(
                lambda: jbuild(cfg).init(jax.random.key(0))),
                get_config(arch), TP.expected_params(get_config(arch)))
        return cache[arch]
    return get


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_specs_match_jax(arch, shapes):
    jcfg, jshape, tcfg, tparams = shapes(arch)
    for mesh, (names, sizes) in MESHES.items():
        jm, tm = JMesh(names, sizes), (names, sizes)
        jps = JP.param_specs(jshape, jcfg, jm)
        tps = TP.param_specs(tparams, tcfg, tm)
        got = {
            "param": (jps, tps),
            "zero": (JP.zero_specs(jshape, jps, jm),
                     TP.zero_specs(tparams, tps, tm, tcfg)),
            "fsdp": (JP.pure_fsdp_specs(jshape, jm),
                     TP.pure_fsdp_specs(tparams, tm, tcfg))}
        assert TP.moe_uses_ep(tcfg, tm) == JP.moe_uses_ep(jcfg, jm)
        size = dict(zip(names, sizes))
        for kind, (jt, tt) in got.items():
            jflat = _jflat(jt)
            listed = set(LAYER_DIM_LEAVES.get((arch, kind), {}).get(mesh, ()))
            moved = set()
            assert set(tt) == set(tparams)
            for name, spec in tt.items():
                path, k, _ = TP.stacked_leaf(tcfg, name, tparams[name].shape)
                js = tuple(jflat[path])
                shape = tuple(tparams[name].shape)
                if any(a is not None for a in js[:k]):
                    moved.add(path)
                    want = _moved(js, k, shape, size)
                    if all(a is None for a in want):
                        want = ()
                    assert tuple(spec) == want, (kind, mesh, name, js)
                elif js == ():
                    assert tuple(spec) == (), (kind, mesh, name)
                else:
                    assert tuple(spec) == js[k:], (kind, mesh, name, js)
            assert moved == listed, (kind, mesh, sorted(moved ^ listed))


def test_param_specs_divisible_on_production_mesh(shapes):
    """Every port spec divides its dim on the 2x16x16 mesh, for every
    architecture (the dry run's precondition)."""
    names, sizes = MESHES["2x16x16"]
    size = dict(zip(names, sizes))
    bad = []
    for arch in ARCH_NAMES:
        _, _, tcfg, tparams = shapes(arch)
        for name, spec in TP.param_specs(tparams, tcfg,
                                         (names, sizes)).items():
            for dim, ax in zip(tparams[name].shape, tuple(spec)):
                if ax is None:
                    continue
                n = math.prod(size[a] for a in ((ax,) if isinstance(ax, str)
                                                else ax))
                if dim % n:
                    bad.append((arch, name, dim, spec))
    assert not bad, bad


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_input_cache_and_batch_specs_match_jax(arch):
    jcfg, tcfg = jget(arch), get_config(arch)
    for sname, jshape in JSHAPES.items():
        shape = SHAPES[sname]
        jin, tin = jinput_specs(jcfg, jshape), input_specs(tcfg, shape)
        assert set(jin) == set(tin)
        for k in jin:
            assert tuple(tin[k].shape) == jin[k].shape
            assert tin[k].dtype.__str__().split(".")[-1] == jin[k].dtype.name
            assert tin[k].device.type == "meta"
        for names, sizes in MESHES.values():
            jm = JMesh(names, sizes)
            assert _tflat(TP.batch_specs(tin, (names, sizes))) == \
                _jflat(JP.batch_specs(jin, jm))
        if jshape.kind != "decode" or not jsupported(jcfg, jshape)[0]:
            continue
        jc, tc = jcache_specs(jcfg, jshape), cache_specs(tcfg, shape)
        jleaves = {JP._path_str(p): v for p, v in
                   jax.tree_util.tree_flatten_with_path(jc)[0]}
        tleaves = _tflat(tc)
        assert set(jleaves) == set(tleaves)
        for k, v in jleaves.items():
            assert tuple(tleaves[k].shape) == v.shape, k
            assert str(tleaves[k].dtype).split(".")[-1] == v.dtype.name, k
        for names, sizes in MESHES.values():
            jm = JMesh(names, sizes)
            for seq_len in (0, jshape.seq_len):
                assert _tflat(TP.cache_specs_tree(
                    tc, tcfg, (names, sizes), jshape.global_batch,
                    seq_len=seq_len)) == _jflat(JP.cache_specs_tree(
                        jc, jcfg, jm, jshape.global_batch, seq_len=seq_len))
