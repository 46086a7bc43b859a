"""End-to-end LM training driver, on the PyTorch port.

The counterpart of ``examples/train_lm.py``. Default: a reduced internlm2,
200 steps, with checkpoints and resume. ``--m100`` trains a ~100M-parameter
config (12 layers x 768, an 8192-token vocabulary) for a few hundred steps
(sized for a card; runs on the CPU too, slowly). Runs on CUDA unless
``--cpu``.

    PYTHONPATH=src python examples/train_lm_torch.py --cpu
    PYTHONPATH=src python examples/train_lm_torch.py --m100 --steps 300
"""
import argparse
import json
from pathlib import Path

import repro_torch.launch.train as launch_train
from repro_torch.configs import get_smoke_config


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--m100", action="store_true",
                    help="~100M-param config instead of the smoke config")
    ap.add_argument("--ckpt-dir", default=str(
        Path(__file__).resolve().parents[1] / "build" / "train_lm_torch"))
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: CUDA, which must exist)")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else None

    if args.m100:
        # ~100M params: 12L x 768 with an 8k-ish vocab
        cfg100 = get_smoke_config(args.arch).scaled(
            num_layers=12, d_model=768, num_heads=12, num_kv_heads=4,
            d_ff=3072, vocab_size=8192, head_dim=64)
        # inject it as the smoke config the driver reads
        launch_train.get_smoke_config = lambda name: cfg100
        out = launch_train.train(args.arch, smoke=True, steps=args.steps,
                                 batch_size=8, seq_len=512,
                                 ckpt_dir=args.ckpt_dir, ckpt_every=50,
                                 device=device)
    else:
        out = launch_train.train(args.arch, smoke=True, steps=args.steps,
                                 batch_size=8, seq_len=128,
                                 ckpt_dir=args.ckpt_dir, ckpt_every=50,
                                 device=device)
    print(json.dumps({k: out[k] for k in ("final_loss", "first_loss",
                                          "stragglers", "steps")},
                     indent=2))
    assert out["final_loss"] < out["first_loss"], "training must reduce loss"
    print("loss decreased — training works end to end "
          f"({out['first_loss']:.3f} -> {out['final_loss']:.3f})")
    return out


if __name__ == "__main__":
    main()
