"""The LM server: prefill + decode loop with continuous batching.

The port of ``repro.launch.serve``. Requests enter a queue; the scheduler
packs them into the fixed set of slots, prefills new sequences, decodes one
token per step for every live sequence and retires finished ones
(continuous batching: slot reuse). As in the reference, the live slots are
decoded one after another at batch 1, each with its own cache, and sampling
is greedy.

Runs on CUDA unless ``--device cpu``; every family (see
``repro_torch.models.model``): the VLM and audio configs are fed zeroed
image embeddings or frames (``Server._extra``), as in the reference; the
recurrent ones (xLSTM, the Mamba2 hybrid) keep their states in each slot's
cache. Examples:

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --arch internlm2-1.8b --smoke --requests 6 --max-new 16
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --arch zamba2-2.7b --smoke --requests 6 --max-new 16
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Optional

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.registry import ARCH_NAMES
from repro_torch.convert import resolve_device
from repro_torch.engine import rng
from repro_torch.models.model import build_model
from repro_torch.models.layers import model_dtype


@dataclasses.dataclass
class Request:
    rid: int
    prompt: torch.Tensor           # (S,) ints
    max_new: int
    out: list = dataclasses.field(default_factory=list)
    done: bool = False


class Server:
    """Fixed-slot continuous-batching decode server (greedy sampling), its
    weights drawn from seed 0 on ``device`` (CUDA unless asked)."""

    def __init__(self, arch: str, *, smoke: bool = True, batch_slots: int = 4,
                 max_len: int = 256, device=None):
        self.cfg = get_smoke_config(arch) if smoke else get_config(arch)
        self.model = build_model(self.cfg)
        self.device = resolve_device(device)
        self.max_len = max_len
        self.slots = batch_slots
        self.params = self.model.init(0, self.device)
        # one cache per slot (slot-wise so prefill can replace one sequence)
        self.caches = [None] * batch_slots
        self.positions = [0] * batch_slots
        self.live: list[Optional[Request]] = [None] * batch_slots

    def _extra(self, batch_size: int) -> dict:
        """The stub inputs of the VLM and audio families: zeroed image
        embeddings or frames in the model dtype on the server's device."""
        extra = {}
        dt = model_dtype(self.cfg)
        if self.cfg.family == "audio":
            extra["frames"] = torch.zeros(
                (batch_size, self.cfg.num_audio_frames, self.cfg.d_model),
                dtype=dt, device=self.device)
        if self.cfg.family == "vlm":
            extra["image_embed"] = torch.zeros(
                (batch_size, self.cfg.num_image_tokens, self.cfg.d_model),
                dtype=dt, device=self.device)
        return extra

    @torch.no_grad()
    def admit(self, req: Request) -> bool:
        for i in range(self.slots):
            if self.live[i] is None:
                prompt = req.prompt.to(self.device)
                logits, cache = self.model.prefill(
                    self.params, {"tokens": prompt[None, :], **self._extra(1)},
                    self.max_len)
                req.out.append(int(torch.argmax(logits, -1)[0]))
                self.caches[i] = cache
                self.positions[i] = prompt.shape[0]
                self.live[i] = req
                return True
        return False

    @torch.no_grad()
    def step(self):
        """One decode step for every live slot, one slot after another at
        batch 1 (the reference's structure)."""
        for i, req in enumerate(self.live):
            if req is None:
                continue
            tok = torch.tensor([req.out[-1]], dtype=torch.int64,
                               device=self.device)
            logits, self.caches[i] = self.model.decode_step(
                self.params, tok, self.caches[i], self.positions[i])
            req.out.append(int(torch.argmax(logits, -1)[0]))
            self.positions[i] += 1
            if len(req.out) >= req.max_new or \
                    self.positions[i] >= self.max_len - 1:
                req.done = True
                self.live[i] = None
                self.caches[i] = None

    def run(self, requests: list[Request]) -> dict:
        pending = list(requests)
        t0 = time.time()
        steps = 0
        while pending or any(r is not None for r in self.live):
            while pending and self.admit(pending[0]):
                pending.pop(0)
            self.step()
            steps += 1
        return {"requests": len(requests), "decode_steps": steps,
                "wall_s": round(time.time() - t0, 2),
                "tokens": sum(len(r.out) for r in requests)}


def prompts(num: int, prompt_len: int, vocab: int, device, seed: int = 7):
    """The CLI's prompts, the reference's draws:
    ``randint(fold_in(key(seed), i), (prompt_len,), 0, vocab)``."""
    key = rng.key(seed, device)
    return [rng.randint(rng.fold_in(key, i), (prompt_len,), 0, vocab)
            for i in range(num)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(ARCH_NAMES))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA, which must exist)")
    args = ap.parse_args(argv)

    srv = Server(args.arch, smoke=args.smoke, device=args.device)
    reqs = [Request(rid=i, prompt=p, max_new=args.max_new)
            for i, p in enumerate(prompts(args.requests, args.prompt_len,
                                          srv.cfg.vocab_size, srv.device))]
    print(json.dumps(srv.run(reqs)))


if __name__ == "__main__":
    main()
