"""Training launcher for the port, on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
        --steps 30 --batch 8 --seq 256 --ckpt /path/to/ckpt

Counterpart of ``repro.launch.train``: random weights from ``--seed``,
synthetic data (``data.pipeline``, seeded by ``--seed`` too), AdamW with a
warmup-cosine schedule, asynchronous checkpoints and restore from
``--ckpt``.  Runs on ``cuda`` unless ``--device cpu`` is given (then every
product takes the kernel's plain version); ``--smoke`` selects the reduced
config.  ``--ranks N`` runs N rank threads on the device as a
(``data``, ``model``) mesh of (N // tp, tp) (``build_mesh``, the
reference's), and the trainer trains sharded on it: placed state, every
projection and its gradients planned products.  ``--ranks`` defaults to 1,
which builds no mesh, as the reference's launcher on one device: ``--tp``
alone is accepted and ignored with a note.  On the CPU, for example,

    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \
        --steps 4 --tp 2 --ranks 4

On ``cuda`` every step after the first replays one CUDA graph of the
whole step (``runtime.train.StaticStep``: the first step runs eagerly,
the second is captured and replayed), as the reference's launcher runs
one jitted step; ``--eager`` dispatches every step's kernels from Python
instead.  The CPU always runs the step eagerly.  The done line gives K1's
launches counted on the host (the eager step and the capture) and the
captured graph's, replays x its launches.

``--arch`` takes every config name: each family trains with its config's
remat policy (``"dots"`` for all but Llama and xLSTM), e.g.

    PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-2.7b \
        --steps 20 --batch 2 --seq 512
    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-350m --smoke --device cpu

except the encoder-decoder seamless-m4t-medium, which the launcher refuses:
the synthetic data has no source frames (in either package), so it trains
through ``runtime.train.Trainer`` on batches that carry a seeded
``src_embed`` beside the tokens, as ``EncDecLM.loss`` takes them.
"""
from __future__ import annotations

import argparse
import importlib
import sys
from typing import Optional

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data.pipeline import DataConfig, batch_iterator
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.dist.mesh import Mesh
from repro_torch.kernels.matmul import kernel as k1
from repro_torch.models.registry import build_model
from repro_torch.runtime.train import TrainConfig, Trainer


def build_mesh(tp: int, ranks: int, device: DeviceLike = None) -> Optional[Mesh]:
    """(dp, tp) rank threads over ("data", "model"), dp = ranks // tp; one
    rank builds no mesh."""
    if ranks <= 1:
        return None
    tp = min(tp, ranks)
    return Mesh((ranks // tp, tp), ("data", "model"), device=device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--tp", type=int, default=None,
                    help="the model axis of the mesh (ignored without --ranks)")
    ap.add_argument("--ranks", type=int, default=1,
                    help="rank threads sharing the device as a (data, model) mesh")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--eager", action="store_true",
                    help="dispatch every step from Python: no CUDA graph")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.family == "audio":
        ap.error(f"{cfg.name} needs source frames the synthetic data does not have: "
                 f"train it through Trainer with a src_embed in each batch")
    model = build_model(cfg)
    mesh = build_mesh(args.tp or 1, args.ranks, device)
    if mesh is None and args.tp is not None:
        print(f"[launch] --tp {args.tp} ignored: one device, no mesh")
    print(f"[launch] arch={cfg.name} params={cfg.param_count() / 1e6:.1f}M "
          f"device={device} mesh={'1 device' if mesh is None else dict(mesh.shape)}")

    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                    global_batch=args.batch, seed=args.seed)
    tc = TrainConfig(steps=args.steps, lr=args.lr,
                     warmup=max(args.steps // 20, 5),
                     ckpt_dir=args.ckpt, ckpt_every=max(args.steps // 4, 10),
                     log_every=max(args.steps // 20, 1))
    gen = torch.Generator(device=device).manual_seed(args.seed)
    trainer = Trainer(model, tc, mesh=mesh, device=device,
                      capture=False if args.eager else None)
    try:
        out = trainer.fit(gen, batch_iterator(dc))
    finally:
        if mesh is not None:
            mesh.close()
    h = out["history"]
    graph = trainer.graph_report()
    print(f"[launch] done: loss {h[0]['loss']:.4f} -> {h[-1]['loss']:.4f} "
          f"({out['restarts']} restarts); zorder_matmul launches: {k1.launches} "
          f"{ {r: n for r, n in k1.launches_by_route.items() if n} }")
    print(f"[launch] step {'captured' if trainer.capture else 'eager'}: "
          f"{graph['captures']} captures, {graph['replays']} replays of "
          f"{graph['k1_per_replay']} K1 launches (replayed {graph['k1_replayed']})")
    if mesh is not None:
        # the module, not the function ``repro_torch.plan.lower_dist`` of its name
        lower_dist = importlib.import_module("repro_torch.plan.lower_dist")
        print(f"[launch] planned products: {lower_dist.executions_snapshot()}; replayed "
              f"{graph['products_replayed']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
