"""The paper's technique wired into the LM stack: representative-example
selection over a transformer's outputs via Correlated Sequential Halving.
The PyTorch port of ``examples/embedding_medoid.py``, on an NVIDIA card
(``--cpu`` runs on the CPU instead); every family: the dense decoders, the
MoE / MLA decoders (granite-moe-3b-a800m, deepseek-v2-lite-16b), the VLM
(llama-3.2-vision-11b, on seeded image embeddings), the enc-dec
(whisper-small, on seeded frames), xLSTM (xlstm-1.3b) and the Mamba2 hybrid
(zamba2-2.7b).

Use case (data pruning / coreset selection): embed a pile of sequences with a
model, then pick the most-representative sequence = the medoid of the
embedding vectors, in O(n log n) distance evaluations instead of O(n^2). The
embedding is the mean of the f32 logits over positions, so its width is the
vocabulary's.

    PYTHONPATH=src python examples/embedding_medoid_torch.py --cpu

``--cluster K`` picks K representatives with bandit k-medoids; ``--queries
Q`` splits the corpus into Q uneven shards (per-topic / per-tenant
selection) and answers each shard's representative through the
continuous-batching ``MedoidServer`` (power-of-two shape buckets, the
ragged engine); both on ``--backend``.

    PYTHONPATH=src python examples/embedding_medoid_torch.py --cpu \\
        --cluster 4 --queries 6
"""
import argparse
import time

import torch

from repro_torch.api import find_medoid, kmedoids
from repro_torch.configs import get_smoke_config
from repro_torch.core.exact import exact_medoid
from repro_torch.engine import rng
from repro_torch.launch.serve_medoid import MedoidServer
from repro_torch.models import encdec as ED
from repro_torch.models import layers as L
from repro_torch.models import recurrent as R
from repro_torch.models import transformer as T
from repro_torch.models.model import build_model


@torch.no_grad()
def embed_sequences(cfg, params, tokens: torch.Tensor, frames=None,
                    image_embed=None) -> torch.Tensor:
    """(B, S) tokens -> (B, V) f32: the mean over positions of the f32
    logits (a model-agnostic embedding proxy); the audio family encodes
    ``frames`` first, the VLM reads ``image_embed``."""
    if cfg.family in ("dense", "moe", "vlm"):
        logits, _, _ = T.transformer_forward(params, cfg, tokens,
                                             image_embed=image_embed)
    elif cfg.family == "ssm":
        logits, _ = R.xlstm_forward(params, cfg, tokens)
    elif cfg.family == "hybrid":
        logits, _ = R.hybrid_forward(params, cfg, tokens)
    elif cfg.family == "audio":
        enc = ED.encode(params, cfg, frames)
        logits, _ = ED.decode_train(params, cfg, tokens, enc)
    else:
        raise ValueError(f"unknown family {cfg.family!r}")
    return torch.mean(logits.float(), dim=1)


def stub_inputs(cfg, i: int, bs: int, device) -> dict:
    """Batch ``i``'s frames (audio) or image embeddings (VLM): normal draws
    under ``fold_in(key(1), 1000 + i)`` as the reference's, in f32 then
    cast to the model dtype (the reference draws a bf16 config's in bf16,
    so there they are other values)."""
    key = rng.fold_in(rng.key(1, device), 1000 + i)
    dt = L.model_dtype(cfg)
    if cfg.family == "audio":
        return {"frames": rng.normal(
            key, (bs, cfg.num_audio_frames, cfg.d_model)).to(dt)}
    if cfg.family == "vlm":
        return {"image_embed": rng.normal(
            key, (bs, cfg.num_image_tokens, cfg.d_model)).to(dt)}
    return {}


def embed_corpus(cfg, params, num_seqs: int, seq_len: int, device,
                 bs: int = 32) -> torch.Tensor:
    """Synthesize ``num_seqs`` sequences in batches of ``bs`` (the
    reference's draws: ``randint(fold_in(key(1), i), (bs, seq_len), 0,
    V)``, with :func:`stub_inputs`) and embed them: (num_seqs // bs * bs,
    V) f32."""
    key = rng.key(1, device)
    embs = []
    for i in range(num_seqs // bs):
        toks = rng.randint(rng.fold_in(key, i), (bs, seq_len), 0,
                           cfg.vocab_size)
        embs.append(embed_sequences(cfg, params, toks,
                                    **stub_inputs(cfg, i, bs, device)))
        del toks
    return torch.cat(embs)


def representative(embs: torch.Tensor, backend: str = "reference"):
    """The medoid of the embeddings by correlated SH (key 2, 20 pulls per
    arm, l2): the facade's result."""
    return find_medoid(embs, rng.key(2, embs.device), metric="l2",
                       budget_per_arm=20, backend=backend)


def cluster(embs: torch.Tensor, k: int, backend: str):
    """K representatives: bandit k-medoids (key 3, l2) over the
    embeddings."""
    return kmedoids(embs, k, rng.key(3, embs.device), metric="l2",
                    backend=backend)


def shard_bounds(n: int, queries: int) -> list:
    """The reference's Q uneven shards [a, b) of n rows."""
    bounds = sorted({int(x) for x in
                     (n * (i + 1) ** 1.5 / queries ** 1.5
                      for i in range(queries - 1))} | {n})
    shards, lo = [], 0
    for hi in bounds:
        if hi > lo:
            shards.append((lo, hi))
            lo = hi
    return shards


def shard_representatives(embs: torch.Tensor, queries: int, backend: str):
    """Each shard's representative through a ``MedoidServer`` (l2, 24
    pulls per arm): (server, {rid: (a, b)})."""
    srv = MedoidServer(metric="l2", backend=backend, budget_per_arm=24,
                       max_batch=queries, device=embs.device)
    rids = {srv.submit(embs[a:b]): (a, b)
            for a, b in shard_bounds(embs.shape[0], queries)}
    srv.drain()
    return srv, rids


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--num-seqs", type=int, default=512)
    ap.add_argument("--seq-len", type=int, default=32)
    ap.add_argument("--queries", type=int, default=1,
                    help="split the corpus into Q uneven shards and answer "
                         "each through the batched medoid service")
    ap.add_argument("--cluster", type=int, default=0, metavar="K",
                    help="bandit k-medoids over the embeddings: K "
                         "representative sequences, one per cluster")
    ap.add_argument("--backend", default="reference")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)
    dev = torch.device("cpu" if args.cpu else "cuda")

    cfg = get_smoke_config(args.arch)
    params = build_model(cfg).init(0, dev)
    embs = embed_corpus(cfg, params, args.num_seqs, args.seq_len, dev)
    n = embs.shape[0]
    print(f"embedded {n} sequences with {args.arch} (dim {embs.shape[1]}) "
          f"on {dev}")

    t0 = time.time()
    res = representative(embs)
    t_corr = time.time() - t0
    truth = int(exact_medoid(embs, "l2"))
    print(f"representative sequence (corrSH): #{res.medoid}  "
          f"[{res.pulls:,} pulls, {t_corr:.2f}s]")
    print(f"representative sequence (exact):  #{truth}  [{n * n:,} pulls]")
    print(f"match: {res.medoid == truth}")

    if args.cluster > 1:
        t0 = time.time()
        km = cluster(embs, args.cluster, args.backend)
        labels = torch.as_tensor(km.labels)
        sizes = [int((labels == c).sum()) for c in range(args.cluster)]
        print(f"\n{args.cluster}-medoid clustering in {time.time() - t0:.2f}s "
              f"({km.pulls:,} pulls vs {n * n:,} exact, "
              f"{km.swaps} swaps, cost {km.cost:.1f}):")
        for c, (m, s) in enumerate(zip(km.medoids, sizes)):
            print(f"  cluster {c}: representative #{m}  ({s} sequences)")

    if args.queries > 1:
        t0 = time.time()
        srv, rids = shard_representatives(embs, args.queries, args.backend)
        print(f"\n{len(rids)} shard queries answered in "
              f"{srv.dispatches} dispatches "
              f"({srv.stats()['distinct_buckets']} buckets, "
              f"{srv.recompiles} compiles, {time.time() - t0:.2f}s):")
        for rid, (a, b) in rids.items():
            local = int(srv.done[rid].medoid)
            t_shard = int(exact_medoid(embs[a:b], "l2"))
            print(f"  shard [{a:4d},{b:4d}) n={b - a:4d}: "
                  f"representative #{a + local}  "
                  f"(exact match: {local == t_shard})")


if __name__ == "__main__":
    main()
