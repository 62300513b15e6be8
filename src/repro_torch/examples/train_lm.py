"""End-to-end training example.

    PYTHONPATH=src python -m repro_torch.examples.train_lm --preset demo [--device cpu]
        ~2M-param llama-family model, 200 steps, shows the loss dropping on
        the synthetic affine-chain data, writes checkpoints, and with
        ``--inject-failure STEP`` restores from the last one mid-run.

    PYTHONPATH=src python -m repro_torch.examples.train_lm --preset 100m --steps 300
        the ~100M-param model (12 layers, d_model 768, vocab 32768).

    PYTHONPATH=src python -m repro_torch.examples.train_lm --arch llama3.2-1b --smoke
        any config of ``repro_torch.configs`` through the same script.

The counterpart of ``examples/train_lm.py``: the same presets, flags and
cadences (warmup, checkpoints and logging at a twentieth, a quarter and a
twentieth of the steps), through ``runtime.train.Trainer``.  On the card
every step after the first replays one CUDA graph of the step; ``--device
cpu`` runs each step eagerly.  Checkpoints go to ``--ckpt``, or to a new
temporary directory.
"""
from __future__ import annotations

import argparse
import tempfile
from typing import Optional, Sequence

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data.pipeline import DataConfig, batch_iterator
from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import build_model
from repro_torch.runtime.train import TrainConfig, Trainer

DEMO = ModelConfig(
    name="demo-2m", family="dense", num_layers=4, d_model=128,
    num_heads=4, num_kv_heads=2, d_ff=512, vocab_size=2048, head_dim=32,
    attn_chunk=128, tie_embeddings=True,
)

M100 = ModelConfig(
    name="repro-100m", family="dense", num_layers=12, d_model=768,
    num_heads=12, num_kv_heads=4, d_ff=3072, vocab_size=32768, head_dim=64,
    tie_embeddings=True,
)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", choices=["demo", "100m"], default="demo")
    ap.add_argument("--arch", default=None, help="a config name instead")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--inject-failure", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    if args.arch:
        cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    else:
        cfg = DEMO if args.preset == "demo" else M100
    steps = args.steps or (200 if args.preset == "demo" else 300)

    model = build_model(cfg)
    n = cfg.param_count()
    print(f"arch={cfg.name} params={n / 1e6:.1f}M steps={steps} device={device}")

    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                    global_batch=args.batch, seed=0)
    ckpt_dir = args.ckpt or tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    tc = TrainConfig(
        steps=steps, lr=args.lr, warmup=max(steps // 20, 5),
        ckpt_dir=ckpt_dir, ckpt_every=max(steps // 4, 10),
        log_every=max(steps // 20, 5),
        fail_at_step=args.inject_failure,
    )
    out = Trainer(model, tc, device=device).fit(
        torch.Generator(device=device).manual_seed(0), batch_iterator(dc))
    hist = out["history"]
    print(f"\nfirst logged loss {hist[0]['loss']:.4f} -> last "
          f"{hist[-1]['loss']:.4f}  (restarts: {out['restarts']})")
    print(f"checkpoints in {ckpt_dir}")
    return {"device": str(device), "arch": cfg.name, "params": n, "steps": steps,
            "history": hist, "first_loss": hist[0]["loss"], "last_loss": hist[-1]["loss"],
            "restarts": out["restarts"], "ckpt_dir": ckpt_dir}


if __name__ == "__main__":
    main()
