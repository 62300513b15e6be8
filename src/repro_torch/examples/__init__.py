"""The reference's examples on the port, one module each:

  quickstart          -- solve, cost and simulate the torus schedule; K1 on the card
  distributed_matmul  -- every strategy on rank-thread meshes, collective bytes by kind
  serve_batched       -- bucketed serving, plan-routed on a 2x2 mesh or local
  train_lm            -- the training demo: a 2M or 100M model, checkpoints, a restart

Each runs as ``python -m repro_torch.examples.<name>`` on the card, or with
``--device cpu``; each ``main(argv)`` prints the reference script's lines
and returns the numbers behind them.
"""
