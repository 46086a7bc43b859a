"""Unified Model interface: init / prefill / decode for every family.

The port of ``repro.models.model``. ``build_model(cfg)`` returns a
:class:`Model` whose members are plain functions over the weights module
that ``init`` builds. Batches are dicts:

  {"tokens": (B, S) ints}                               dense, moe, ssm, hybrid
  {"tokens", "image_embed": (B, N_img, d_model)}        vlm (patch stub)
  {"tokens", "frames": (B, S_enc, d_model)}             audio (conv stub)

Every family runs: dense and moe (MoE and MLA layers) decoders, vlm,
audio (enc-dec), ssm (xLSTM) and hybrid (Zamba2: Mamba2 blocks with a
shared attention block). Loss is next-token cross entropy (the decoder's
tokens for enc-dec) through :func:`fused_xent`, plus 0.01 x the MoE
load-balancing aux; ``loss`` reads the weights' gradients where they
require them (the trainer turns that on; the constructors freeze them
for serving).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Union

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelCfg
from repro_torch.convert import resolve_device
from repro_torch.models import encdec as ED
from repro_torch.models import layers as L
from repro_torch.models import recurrent as R
from repro_torch.models import transformer as T
from repro_torch.models.sharding import _rules, constrain, grad_as_value

FAMILIES = ("dense", "moe", "vlm", "audio", "ssm", "hybrid")


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelCfg
    init: Callable[..., Any]            # (seed | generator, device=) -> weights
    loss: Callable[..., Any]            # (params, batch, remat=) -> (loss, metrics)
    prefill: Callable[..., Any]         # (params, batch, max_len) -> (logits, cache)
    decode_step: Callable[..., Any]     # (params, token, cache, pos, batch=) -> (logits, cache)
    init_cache: Callable[..., Any]      # (batch_size, max_len, device=) -> cache


def _generator(seed: Union[int, torch.Generator], device) -> torch.Generator:
    if isinstance(seed, torch.Generator):
        return seed
    return torch.Generator(device=device).manual_seed(int(seed))


class _VocabParallelXent(torch.autograd.Function):
    """``logsumexp(logits) - logits[targets]`` a token, on one rank's
    columns of logits whose vocab dim is cut across ranks (Megatron-LM's
    ``vocab_parallel_cross_entropy``; the reduction GSPMD makes of the
    reference's ``logsumexp`` and one-hot product over vocab-sharded
    logits). ``lo`` is this rank's first vocab column; ``groups`` the
    (mesh, dim) pairs that cut the vocab. The forward all-reduces three
    (B, c) rows: the max, the sum of exponentials and the target's logit
    (0 off the shard that holds it). The backward, ``g (softmax - onehot)``
    on the local columns, needs no collective, and rounds as autograd
    does through the plain branch's ``logsumexp`` and ``gather``: ``g
    softmax`` first, then ``-g`` added at the target."""

    @staticmethod
    def forward(ctx, logits, targets, lo, groups):
        from torch.distributed._functional_collectives import all_reduce

        def reduce(t, op):
            for g in groups:
                t = all_reduce(t, op, g)
            return t
        m = reduce(logits.amax(-1), "max")
        lse = m + torch.log(reduce(
            torch.exp(logits - m[..., None]).sum(-1), "sum"))
        col = targets - lo
        inside = (col >= 0) & (col < logits.shape[-1])
        col = torch.where(inside, col, 0)
        tl = torch.where(inside, logits.gather(-1, col[..., None])[..., 0],
                         0.0)
        ctx.save_for_backward(logits, lse, col, inside)
        return lse - reduce(tl, "sum")

    @staticmethod
    def backward(ctx, g):
        logits, lse, col, inside = ctx.saved_tensors
        grad = torch.exp(logits - lse[..., None]).mul_(g[..., None])
        grad.scatter_add_(-1, col[..., None],
                          torch.where(inside, -g, 0.0)[..., None])
        return grad, None, None, None


def _token_xent(logits: torch.Tensor, targets: torch.Tensor):
    """``logsumexp(logits) - logits[..., targets]`` a token. On a DTensor
    each rank computes on its own shard (``local_map``), so the backward
    meets the per-token gradient at its (B, S) size, not expanded to (B,
    S, V): where the vocab dim is whole on every rank (the full-logits
    branch) each rank computes its own rows; where it is sharded each rank
    its own columns, reduced across the vocab shards by
    :class:`_VocabParallelXent` (the chunk's vocab columns are never
    gathered)."""
    if not isinstance(logits, DTensor):
        tl = logits.gather(-1, targets[..., None])[..., 0]
        return torch.logsumexp(logits, dim=-1) - tl
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map
    vdim = logits.ndim - 1
    mesh = logits.device_mesh
    place = [Replicate() if p.is_partial() else p for p in logits.placements]
    rows = [Replicate() if p.is_shard(vdim) else p for p in place]
    if rows == place:
        return local_map(_token_xent, out_placements=place,
                         in_placements=(place, place), device_mesh=mesh,
                         redistribute_inputs=True)(logits, targets)
    lo, size = 0, logits.shape[vdim]
    for i, (p, k) in enumerate(zip(place, mesh.get_coordinate())):
        if p.is_shard(vdim):   # DTensor's nesting: mesh order, chunk sizes
            step = -(-size // mesh.size(i))
            lo += min(k * step, size)
            size = max(0, min(step, size - k * step))
    groups = [(mesh, i) for i, p in enumerate(place) if p.is_shard(vdim)]
    return local_map(
        lambda lg, tg: _VocabParallelXent.apply(lg, tg, lo, groups),
        out_placements=rows, in_placements=(place, rows), device_mesh=mesh,
        redistribute_inputs=True)(logits, targets)


def _xent(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Next-token CE on explicit logits (the small-vocab / test path)."""
    logits = constrain(logits.float(), "batch", None, "vocab")
    return _token_xent(logits[:, :-1], tokens[:, 1:].long()).mean()


def _xent_chunk(xc, tc, vc, head):
    """The masked CE sum of one (B, c) chunk; ``head`` (V, d) in f32."""
    logits = constrain(xc.float() @ head.T, "batch", None, "vocab")
    return (_token_xent(logits, tc) * vc[None, :]).sum()


def _pad_end(t: torch.Tensor, pad: int) -> torch.Tensor:
    """``t`` zero-padded by ``pad`` (< its length) at the end of dim 1; a
    DTensor by a ``cat`` of zeros laid out as it is (DTensor's ``pad``
    loses the mesh's placements)."""
    if isinstance(t, DTensor):
        return torch.cat([t, torch.zeros_like(t[:, :pad])], dim=1)
    widths = (0, 0) * (t.ndim - 2) + (0, pad)
    return torch.nn.functional.pad(t, widths)


def fused_xent(x: torch.Tensor, tokens: torch.Tensor, head: torch.Tensor,
               chunk: int = 256) -> torch.Tensor:
    """Fused unembed + next-token CE, chunked over the sequence.

    ``x``: final hidden states (B, S, d); ``head``: (V, d) unembedding,
    multiplied in f32. The logits exist only per (B, chunk, V) block,
    recomputed in the backward pass (``torch.utils.checkpoint``), so the
    full (B, S, V) f32 tensor never does. The sequence is zero-padded to
    whole chunks and the padded tail masked; the sum is divided by
    B (S - 1).

    Under logical rules that leave no mesh axis for the vocabulary (the
    pure-FSDP cells, where the batch takes every axis) the chunks' remat
    would re-gather the FSDP-sharded head every chunk, so one full
    (B_loc, S, V) logits block is computed instead, as the reference does.
    Otherwise the (V, d) head is laid out once by vocab rows, ``("vocab",
    None)`` (the reference's ``(None, "vocab")`` cuts its d, and DTensor
    then makes each rank's head gradient whole), and each chunk's logits
    vocab-sharded; each rank reduces its own columns and all-reduces the
    (B, c) max, sum of exponentials and target logit across the vocab
    shards, as the reference's GSPMD program does (see
    :class:`_VocabParallelXent`). On a DTensor ``x``'s gradient, a pending
    sum over the vocab shards, is reduced at ``x``
    (``sharding.grad_as_value``)."""
    x = grad_as_value(x)
    rules = _rules()
    if rules is not None and rules.get("vocab") is None:
        return _xent(x.float() @ head.float().T, tokens)
    B, S, d = x.shape
    head = constrain(head, "vocab", None).float()   # once, not per chunk
    xs = x[:, :-1]
    targets = tokens[:, 1:].long()
    n = S - 1
    c = min(chunk, n)
    pad = (-n) % c
    if pad:
        xs, targets = _pad_end(xs, pad), _pad_end(targets, pad)
    nc = (n + pad) // c
    valid = (torch.arange(nc * c, device=x.device) < n).float()
    acc = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(nc):
        cols = slice(i * c, (i + 1) * c)
        acc = acc + L.remat_call(True, _xent_chunk, xs[:, cols],
                                 targets[:, cols], valid[cols], head)
    return acc / (B * n)


def cache_leaves(cache: dict) -> list:
    """[(name, tensor)] of a family's cache: its tensors by key, and each
    field of its recurrent states (``mlstm.C``, ``slstm.m``, ``mamba.h``)."""
    out = []
    for k, v in cache.items():
        if isinstance(v, tuple):
            out += [(f"{k}.{f}", t) for f, t in zip(v._fields, v)]
        else:
            out.append((k, v))
    return out


def check_family(cfg: ModelCfg) -> None:
    """Raise ``ValueError`` for a family the port does not know."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}")


def weights_init(cfg: ModelCfg, gen, device=None):
    """The family's weights module from ``gen`` on ``device`` (the rule of
    ``transformer.transformer_init``; the meta device draws nothing)."""
    check_family(cfg)
    init = {"audio": ED.encdec_init, "ssm": R.xlstm_init,
            "hybrid": R.hybrid_init}.get(cfg.family, T.transformer_init)
    return init(gen, cfg, device)


def build_model(cfg: ModelCfg) -> Model:
    check_family(cfg)

    def init(seed: Union[int, torch.Generator] = 0, device=None):
        """The weights on ``device`` from a seed or a ``torch.Generator``
        (on that device): CUDA unless ``device`` (or the generator's
        device) says otherwise."""
        if device is None and isinstance(seed, torch.Generator):
            device = seed.device
        device = resolve_device(device)
        return weights_init(cfg, _generator(seed, device), device)

    if cfg.family == "ssm":        # xLSTM
        def loss(params, batch, remat: bool = True):
            x, _ = R.xlstm_forward(params, cfg, batch["tokens"], remat=remat,
                                   return_hidden=True)
            l = fused_xent(x, batch["tokens"], R.head_matrix(params, cfg))
            return l, {"xent": l}

        def prefill(params, batch, max_len):
            return R.xlstm_prefill(params, cfg, batch["tokens"], max_len)

        def decode_step(params, token, cache, pos, batch=None):
            return R.xlstm_decode_step(params, cfg, token, cache, pos)

        def init_cache(batch_size, max_len, device=None):
            return R.xlstm_init_cache(cfg, batch_size, device)
    elif cfg.family == "hybrid":   # zamba2
        def loss(params, batch, remat: bool = True):
            x, _ = R.hybrid_forward(params, cfg, batch["tokens"], remat=remat,
                                    return_hidden=True)
            l = fused_xent(x, batch["tokens"], R.head_matrix(params, cfg))
            return l, {"xent": l}

        def prefill(params, batch, max_len):
            return R.hybrid_prefill(params, cfg, batch["tokens"], max_len)

        def decode_step(params, token, cache, pos, batch=None):
            return R.hybrid_decode_step(params, cfg, token, cache, pos)

        def init_cache(batch_size, max_len, device=None):
            return R.hybrid_init_cache(cfg, batch_size, max_len, device)
    elif cfg.family == "audio":
        def loss(params, batch, remat: bool = True):
            enc_out = ED.encode(params, cfg, batch["frames"],
                                differentiable=True)
            x, _ = ED.decode_train(params, cfg, batch["tokens"], enc_out,
                                   remat=remat, return_hidden=True)
            l = fused_xent(x, batch["tokens"], params["embed"])
            return l, {"xent": l}

        def prefill(params, batch, max_len):
            return ED.encdec_prefill(params, cfg, batch["tokens"],
                                     batch["frames"], max_len)

        def decode_step(params, token, cache, pos, batch=None):
            return ED.encdec_decode_step(params, cfg, token, cache, pos)

        def init_cache(batch_size, max_len, device=None):
            return ED.encdec_init_cache(cfg, batch_size, max_len, device)
    else:
        def loss(params, batch, remat: bool = True):
            x, aux, _ = T.transformer_forward(
                params, cfg, batch["tokens"],
                image_embed=batch.get("image_embed"), remat=remat,
                return_hidden=True)
            l = fused_xent(x, batch["tokens"], T.head_matrix(params, cfg))
            aux = torch.as_tensor(aux, dtype=torch.float32, device=l.device)
            # the reference reports the loss with the aux term as "xent"
            l = l + 0.01 * aux
            return l, {"xent": l, "moe_aux": aux}

        def prefill(params, batch, max_len):
            return T.transformer_prefill(params, cfg, batch["tokens"],
                                         max_len,
                                         image_embed=batch.get("image_embed"))

        def decode_step(params, token, cache, pos, batch=None):
            img = None if batch is None else batch.get("image_embed")
            return T.transformer_decode_step(params, cfg, token, cache, pos,
                                             image_embed=img)

        def init_cache(batch_size, max_len, device=None):
            return T.init_kv_cache(cfg, batch_size, max_len, device)

    return Model(cfg=cfg, init=init, loss=loss, prefill=prefill,
                 decode_step=decode_step, init_cache=init_cache)
