"""Multi-pod dry run: count every (architecture x input-shape) cell's
production step on the production meshes, on fake tensors, and record its
memory and roofline terms.

Counterpart of ``repro.launch.dryrun``:

    PYTHONPATH=src python -m repro_torch.launch.dryrun                 # all cells
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b \\
        --shape train_4k --mesh single,multi --device cpu
    PYTHONPATH=src python -m repro_torch.launch.dryrun --out results.json

The reference lowers and compiles each cell's step for 256 and 512 forced
host devices and reads XLA's memory analysis and the HLO.  The port
compiles nothing: ``lower_cell`` runs the step as the port runs it, on
fake tensors (``FakeTensorMode``: no memory, no card time), under the cost
counter (``roofline.hlo_stats``):

  train_4k     -> ``Trainer``'s step: the loss and its gradients under
                  ``planned_matmuls(mesh)`` (every projection and both of
                  its gradients a planned product), then AdamW on the
                  state's blocks placed by ``zero_shardings`` (or
                  ``param_shardings`` with ``zero=False``)
  prefill_32k  -> ``forward`` under ``planned_matmuls(mesh)``
  decode_32k / long_500k -> ``decode_step`` under ``planned_matmuls(mesh)``
                  (as ``Server(mesh=)`` decodes), the cache placed by
                  ``cache_shardings``

``--device`` picks the fake tensors' device: ``cuda`` by default, so the
card's routes and types are the ones traced (it needs a CUDA build of
torch where a card is present); ``cpu`` runs anywhere (the tests).  On
``--mesh single`` (16 x 16) and ``multi`` (2 x 16 x 16) each planned
product is priced by rank 0's program alone (``Counter(one_rank=True)``;
``threads=True`` runs every rank's thread instead, one rank at a time on
fake tensors, far slower on a 256-rank mesh: the oracle the
tests hold the priced count to on 2 x 2 and 2 x 2 x 2).

The record has the reference's keys, so one ``report.py`` reads either
package's JSON, and the CLI prints the reference's lines.  ``lower_s`` is
the time to build the abstract state (parameters, optimizer state or
cache, batch); ``compile_s`` (and "compile" in the printed lines) the time
of the counted fake run.  Per rank:

* ``argument_bytes``: the placed state (parameters, or the optimizer state
  for training, and the cache for decoding) plus the batch, block by
  block as the sharding rules place them;
* ``alias_bytes``: the donated state (train) or cache (decode);
* ``output_bytes``: what the step returns (the new state or cache and the
  loss, or the logits);
* ``peak_bytes``: the arguments plus the step's live bytes at their peak
  (the counter's tracker); ``temp_bytes`` the difference;
* ``fits_card``: the peak below the H100's 80 GiB (``analysis.HBM_BYTES``),
  in place of the reference's ``fits_hbm_16g``, a TPU v5e's 16 GiB.

The single controller holds global tensors and runs everything outside
the planned products itself; the record keeps its ops apart from one
rank's programs of the planned products and its optimizer blocks
(``counted.rank_program``).  The reference's GSPMD also shards the
controller's head- and vocab-parallel work over the ``model`` axis, as its
sharding rules place the weights (``models.sharding_rules``: the
column-parallel q/k/v outputs, the vocab-sharded embedding and head).  So
the dry run declares those tensors split (``hlo_stats.split_over_model``):
the query heads at RoPE and at the attention core's entry over
``n_heads``, its K/V (and a decode step's cache) over ``n_kv_heads``, the
head weight and the logits over the padded vocabulary.  A shard takes
whole heads: a count the model axis does not divide is split over their
greatest common divisor, and a K/V head that several shards need is
computed by each of them (Llama-3.2-1B's 8 K/V heads on 16 shards: 8).
The ops that read them -- the attention core and its
backward, the unembedding, the logits and the loss, and their backward --
are counted per model-axis shard (``counted.model_sharded``); the rest of
the controller's ops stay whole (``counted.controller``).  MLA's absorbed
decode (latent einsums outside ``chunked_attention``) and the MLP's
elementwise ops stay whole.  Per chip, the rule is the reference's split
of the batch (``_batch_shardings``): the controller's work and live bytes
shared over the batch axes when the cell shards its batch (``ways``), the
model-sharded part also over its model-axis shards, plus one rank's
programs whole:

    per chip = rank_program + (controller + model_sharded / shards) / ways
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib
import json
import math
import os
import time
import traceback
from typing import Dict, Optional, Union
from unittest import mock

import torch

from repro_torch.configs import (SHAPES, ShapeCell, canonical, get_config, runnable_cells,
                                 skipped_cells)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.layers.embed import padded_vocab
from repro_torch.launch.specs import (abstract_cache, abstract_opt_state, abstract_params,
                                      fake_mode, input_specs)
from repro_torch.models.sharding_rules import (cache_shardings, param_shardings,
                                               zero_shardings)
from repro_torch.optim import adamw
from repro_torch.plan.context import planned_matmuls
from repro_torch.plan.lower_dist import block_slices
from repro_torch.roofline import analysis, hlo_stats
from repro_torch.roofline.hlo_stats import Cost
from repro_torch.runtime.sharding import NamedSharding, Placed, resolve_axis, use_mesh
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def _ways(mesh) -> int:
    if mesh is None:
        return 1
    axes = resolve_axis("batch", mesh)
    return mesh.axis_size(axes) if axes else 1


# the modules that call the attention core and the unembedding by name
_CORE_CALLERS = ("repro_torch.layers.attention", "repro_torch.models.encdec")
_UNEMBED_CALLERS = ("repro_torch.models.lm", "repro_torch.models.hybrid",
                    "repro_torch.models.xlstm_model", "repro_torch.models.encdec")


def model_shards(count: int, mesh) -> int:
    """Model-axis shards of a dim of ``count`` heads (or vocabulary
    columns), each shard taking whole ones: the greatest common divisor of
    the count and the model axis."""
    return math.gcd(count, mesh.shape.get("model", 1) if mesh is not None else 1)


@contextlib.contextmanager
def model_split(mesh):
    """Within the scope, the head- and vocab-parallel tensors of the
    controller's ops are declared split over ``mesh``'s model axis (module
    docstring)."""
    from repro_torch.layers import attention

    def heads(*ts):
        for t in ts:
            hlo_stats.split_over_model([t], model_shards(t.shape[2], mesh))

    def split_rope(real):
        def rope(x, *args, **kwargs):
            heads(x)
            return real(x, *args, **kwargs)
        return rope

    def split_core(real):
        def core(q, k, v, *args, **kwargs):
            heads(q, k, v)
            out = real(q, k, v, *args, **kwargs)
            if out.requires_grad:
                # its gradient arrives whole from the planned dA of wo, and
                # is as split as the output
                counter, n = hlo_stats.current_counter(), model_shards(q.shape[2], mesh)
                out.register_hook(lambda g: counter.split_over_model([g], n))
            return out
        return core

    def split_unembed(real):
        def unembed(p, x, vocab):
            # the padded vocabulary: the head is (d, V), a tied table (V, d)
            w = p["lm_head"] if "lm_head" in p else p["embedding"]
            vp = w.shape[1] if "lm_head" in p else w.shape[0]
            hlo_stats.split_over_model([w], model_shards(vp, mesh), keep=vp)
            return real(p, x, vocab)
        return unembed

    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.object(attention, "apply_rope",
                                              split_rope(attention.apply_rope)))
        stack.enter_context(mock.patch.object(attention, "mha", split_core(attention.mha)))
        for name in _CORE_CALLERS:
            mod = importlib.import_module(name)
            stack.enter_context(mock.patch.object(mod, "chunked_attention",
                                                  split_core(mod.chunked_attention)))
        for name in _UNEMBED_CALLERS:
            mod = importlib.import_module(name)
            stack.enter_context(mock.patch.object(mod, "unembed", split_unembed(mod.unembed)))
        yield


def _block(x: torch.Tensor, sharding: Optional[NamedSharding]) -> torch.Tensor:
    """Rank 0's block of ``x`` under ``sharding`` (a view; the whole of
    ``x`` without one)."""
    if sharding is None:
        return x
    return x[block_slices(x.shape, sharding.spec, sharding.mesh, 0)]


def _bytes(tree, shardings=None) -> int:
    """Rank 0's bytes of ``tree`` placed by ``shardings`` (a tree of
    ``NamedSharding`` of the same structure, or None: whole)."""
    leaves = tree_leaves(tree)
    shs = tree_leaves(shardings) if shardings is not None else [None] * len(leaves)
    return sum(_block(x, sh).numel() * x.element_size() for x, sh in zip(leaves, shs))


def _batch_shardings(batch, mesh, *, shard_batch: bool):
    if mesh is None:
        return None
    baxes = resolve_axis("batch", mesh)
    return {k: NamedSharding(mesh, (baxes,) + (None,) * (v.ndim - 1))
            if shard_batch and k != "pos" and v.ndim else NamedSharding(mesh, ())
            for k, v in batch.items()}


def _rank0_state(state, shardings):
    """AdamW state holding rank 0's blocks only (``Placed``), as the rank
    updates them; ``step`` replicated."""
    mesh = tree_leaves(shardings)[0].mesh

    def one(x, sh):
        return Placed({0: _block(x, sh).contiguous()}, sh, tuple(x.shape), x.dtype)

    return {"step": one(state["step"], NamedSharding(mesh, ())),
            **{k: tree_map(one, state[k], shardings) for k in ("master", "m", "v")}}


def cell_arguments(model, aparams, batch, cfg, cell: ShapeCell, mesh, *, zero: bool = True,
                   device="cuda") -> Dict:
    """The step's fake arguments by part, each (tree, its shardings or None
    without a mesh): ``batch`` (along the batch axes when the cell shards
    its batch); ``state`` (train: step, master, m and v by
    ``zero_shardings``, or ``param_shardings`` with ``zero=False``) or
    ``params`` (``param_shardings``); ``cache`` (decode:
    ``cache_shardings``)."""
    shard_batch = mesh is not None and cell.global_batch >= mesh.shape.get("data", 1)
    out = {"batch": (batch, _batch_shardings(batch, mesh, shard_batch=shard_batch))}
    psh = param_shardings(aparams, mesh) if mesh is not None else None
    if cell.kind == "train":
        state = abstract_opt_state(aparams)
        osh = (zero_shardings(aparams, mesh) if zero else psh) if mesh is not None else None
        out["state"] = (state, None if osh is None else {
            "step": NamedSharding(mesh, ()), "master": osh, "m": osh, "v": osh})
        return out
    out["params"] = (aparams, psh)
    if cell.kind == "decode":
        cache = abstract_cache(model, cfg, cell, device)
        out["cache"] = (cache, cache_shardings(cache, mesh, shard_batch=shard_batch)
                        if mesh is not None else None)
    return out


def argument_bytes(arguments: Dict) -> Dict[str, int]:
    """Rank 0's bytes of each part of ``cell_arguments``."""
    return {name: _bytes(tree, sh) for name, (tree, sh) in arguments.items()}


def _cost_dict(c: Cost) -> Dict:
    return {"flops": c.flops, "bytes": c.bytes, "coll": dict(c.coll)}


def lower_cell(arch: str, shape: Union[str, ShapeCell], mesh, *, remat: str = "config",
               zero: bool = True, device="cuda", cfg=None, threads: bool = False,
               counter: Optional[hlo_stats.Counter] = None) -> Dict:
    """Count ``arch`` x ``shape``'s production step on ``mesh`` (None: one
    device) on fake tensors; the record of the module docstring.
    ``shape`` is a name of ``SHAPES`` or a cut ``ShapeCell``; ``cfg``
    replaces ``get_config(arch)`` (overrides); ``counter`` (a fresh
    ``hlo_stats.Counter``) is filled for a caller that reads its ops."""
    from repro_torch.runtime.serve import decode_step
    from repro_torch.runtime.train import TrainConfig, Trainer

    cfg = cfg if cfg is not None else get_config(arch)
    if remat != "config":
        cfg = dataclasses.replace(cfg, remat=remat)
    cell = SHAPES[shape] if isinstance(shape, str) else shape
    chips = mesh.size if mesh is not None else 1
    shard_batch = mesh is not None and cell.global_batch >= mesh.shape.get("data", 1)
    ways = _ways(mesh) if shard_batch else 1   # the controller's share (module docstring)
    if counter is None:
        counter = hlo_stats.Counter()
    counter.one_rank = not threads
    mode = fake_mode()
    planned = planned_matmuls(mesh) if mesh is not None else contextlib.nullcontext()
    meshed = use_mesh(mesh) if mesh is not None else contextlib.nullcontext()
    mem: Dict[str, int] = {}

    t0 = time.perf_counter()
    with mode:
        model, aparams = abstract_params(cfg, device)
        batch = input_specs(arch, cell, device, cfg=cfg)
        args = cell_arguments(model, aparams, batch, cfg, cell, mesh, zero=zero, device=device)
        parts = argument_bytes(args)
        mem["argument_bytes"] = sum(parts.values())
        if cell.kind == "train":
            state, shardings = args["state"]
            osh = shardings["master"] if shardings is not None else None
            mem.update(alias_bytes=parts["state"], output_bytes=parts["state"] + 4)
            trainer = Trainer(model, TrainConfig(), device=device)
            trainer._dtypes = tree_map(lambda p: p.dtype, aparams)
            del aparams
            tokens = cell.global_batch * cell.seq_len
            model_flops = analysis.train_model_flops(cfg.active_param_count(), tokens)
        elif cell.kind == "prefill":
            mem.update(alias_bytes=0)
            tokens = cell.global_batch * cell.seq_len
            model_flops = analysis.infer_model_flops(cfg.active_param_count(), tokens)
        else:
            cache = args["cache"][0]
            mem.update(alias_bytes=parts["cache"])
            tokens = cell.global_batch   # one token per sequence
            model_flops = analysis.infer_model_flops(cfg.active_param_count(), tokens)
        del args
    t_lower = time.perf_counter() - t0

    t0 = time.perf_counter()
    with mode, hlo_stats.counting(counter), model_split(mesh):
        if cell.kind == "train":
            lr = torch.full((), 1e-4, device=device)
            if mesh is None:
                trainer.make_train_step()(state, batch)
            else:
                with meshed, planned:
                    _, _, grads = trainer.loss_and_grads(state["master"], batch)
                with hlo_stats.paused():
                    rank0 = _rank0_state(state, osh)
                    grads = tree_leaves(tree_map(lambda g, w: Placed(
                        {0: _block(g, w.sharding).contiguous()}, w.sharding, tuple(g.shape),
                        g.dtype), tree_unflatten(state["master"], grads), rank0["master"]))
                with hlo_stats.as_rank(0):
                    adamw.step(rank0, grads, lr, trainer.opt_cfg)
                del grads, rank0
        else:
            with torch.no_grad(), meshed, planned:
                if cell.kind == "prefill":
                    arg = ({"tokens": batch["tokens"], "src_embed": batch["src_embed"]}
                           if cfg.family == "audio" else batch["tokens"])
                    logits, _ = model.forward(aparams, arg)
                else:
                    logits = decode_step(model, aparams, cache, batch["tokens"], batch["pos"])
            out_ways = ways
            if mesh is not None and logits.shape[-1] % mesh.shape.get("model", 1) == 0:
                out_ways *= mesh.shape.get("model", 1)
            mem["output_bytes"] = logits.numel() * logits.element_size() // out_ways + (
                mem["alias_bytes"])
            del logits
    t_count = time.perf_counter() - t0

    rank_program = counter.cost(0) if counter.ranks else Cost()
    per_chip = Cost()
    per_chip += counter.cost(None).scaled(1.0 / ways)
    per_chip += counter.split_cost().scaled(1.0 / ways)
    per_chip += rank_program
    live_peak = counter.split_peak_bytes() // ways + counter.peak_bytes(0)
    peak = mem["argument_bytes"] + live_peak
    roof = analysis.from_cost(per_chip, chips=chips, model_flops=model_flops)
    return {
        "arch": arch, "shape": cell.name,
        "mesh": "x".join(str(s) for s in mesh.devices.shape) if mesh is not None else "1",
        "chips": chips,
        "lower_s": round(t_lower, 2), "compile_s": round(t_count, 2),
        "memory": {  # per rank
            "argument_bytes": mem["argument_bytes"],
            "output_bytes": mem["output_bytes"],
            "temp_bytes": live_peak,
            "alias_bytes": mem["alias_bytes"],
            "peak_bytes": peak,
            "fits_card": bool(peak < analysis.HBM_BYTES),
        },
        "roofline": roof.summary(),
        "counted": {"controller": _cost_dict(counter.cost(None)),
                    "model_sharded": {
                        "whole": _cost_dict(counter.split_whole()),
                        "per_shard": _cost_dict(counter.split_cost()),
                        "shards": {"heads": model_shards(cfg.num_heads, mesh),
                                   "kv_heads": model_shards(cfg.num_kv_heads, mesh),
                                   "vocab": model_shards(padded_vocab(cfg.vocab_size), mesh)}},
                    "rank_program": _cost_dict(rank_program), "ways": ways,
                    "rule": "per chip = rank_program + (controller + model_sharded / "
                            "shards) / ways",
                    "priced": "one rank" if not threads else "every rank's thread"},
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default=None, help="one arch id (default: all)")
    ap.add_argument("--shape", default=None, help="one shape (default: all)")
    ap.add_argument("--mesh", default="single,multi")
    ap.add_argument("--out", default="dryrun_results.json")
    ap.add_argument("--append", action="store_true")
    ap.add_argument("--remat", default="config",
                    help="override remat policy: config|none|dots|full")
    ap.add_argument("--no-zero", action="store_true",
                    help="disable ZeRO-1 optimizer-state sharding")
    ap.add_argument("--device", default="cuda",
                    help="the fake tensors' device: cuda (the card's routes and types; "
                         "needs a card) or cpu")
    args = ap.parse_args(argv)

    meshes = {}
    if "single" in args.mesh:
        meshes["single"] = make_production_mesh(multi_pod=False, device=args.device)
    if "multi" in args.mesh:
        meshes["multi"] = make_production_mesh(multi_pod=True, device=args.device)

    cells = runnable_cells()
    if args.arch:
        cells = [c for c in cells if c[0] == canonical(args.arch)]
    if args.shape:
        cells = [c for c in cells if c[1] == args.shape]

    results = []
    if args.append and os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f).get("cells", [])
    done = {(r["arch"], r["shape"], r["mesh"]) for r in results if r.get("ok")}

    for arch, shape in cells:
        for mesh in meshes.values():
            mesh_id = "x".join(str(s) for s in mesh.devices.shape)
            if (arch, shape, mesh_id) in done:
                continue
            print(f"[dryrun] {arch} x {shape} on {mesh_id} ...", flush=True)
            try:
                rec = lower_cell(arch, shape, mesh, remat=args.remat,
                                 zero=not args.no_zero, device=args.device)
                rec["ok"] = True
                r = rec["roofline"]
                peak = rec["memory"]["peak_bytes"] or 0
                print(
                    f"  ok: compile {rec['compile_s']:.1f}s  "
                    f"dominant={r['dominant']}  "
                    f"compute={r['compute_s']:.3e}s memory={r['memory_s']:.3e}s "
                    f"coll={r['collective_s']:.3e}s  "
                    f"peak={peak/2**30:.2f}GiB",
                    flush=True,
                )
            except Exception as e:  # noqa: BLE001 -- record and continue
                rec = {"arch": arch, "shape": shape, "mesh": mesh_id,
                       "ok": False, "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-2000:]}
                print(f"  FAIL: {type(e).__name__}: {str(e)[:200]}", flush=True)
            results.append(rec)
            with open(args.out, "w") as f:
                json.dump({"cells": results,
                           "skipped": skipped_cells()}, f, indent=1)

    n_ok = sum(1 for r in results if r.get("ok"))
    print(f"[dryrun] {n_ok}/{len(results)} cells compiled; skips documented: "
          f"{len(skipped_cells())}")


if __name__ == "__main__":
    main()
