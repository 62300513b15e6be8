"""Decoder-only LM covering the dense, MoE and VLM (early-fusion) families
(counterpart of ``repro.models.lm``): GQA or MLA attention, dense or MoE
blocks, and deepseek-moe's leading dense layers in their own short stack
(``params["dense_layers"]``, ``cache["dense_layers"]``), run before the
others.

The reference stacks each parameter on a leading layer axis and runs the
layers with ``lax.scan``; here the layers are a Python list of parameter
dicts run in a Python loop, and the per-layer caches (GQA's K/V, MLA's
latent) are preallocated tensors written in place.  ``decode_step`` takes
the cache slot as an int or as a 0-d int64 tensor on the model's device
(the reference's traced ``pos``), so one captured CUDA graph serves every
step.

``forward`` and ``loss`` are differentiable: every projection's product is
the Z-order kernel's registered op (``torch.ops.repro_torch.zorder_matmul``,
``kernels.matmul.ops``), its backward two more kernel products.  The
reference's remat policies (``_remat``) map as (``remat``; every model
family wraps the blocks the reference wraps):

* ``"none"`` keeps every activation;
* ``"full"`` recomputes each block in the backward
  (``torch.utils.checkpoint``, non-reentrant);
* ``"dots"`` is ``jax.checkpoint_policies.checkpoint_dots_with_no_batch_dims``:
  non-reentrant ``checkpoint`` with a selective-checkpoint policy that
  saves the outputs of the 2-D products without batch dims, K1's op and
  ``aten.mm``, and recomputes everything else in the backward: ``bmm``,
  norms, RoPE and elementwise work.  Inside today's blocks every
  projection is K1 and no ``aten.mm`` runs: ``torch.einsum`` lowers to
  ``bmm`` even without batch dims, so the fp32 router and gate einsums
  (which the reference saves) are recomputed with the attention scores,
  the SSD and mLSTM scans and the expert products.  What is saved
  changes memory and time, never values; the backward re-runs no K1
  product.  Inside ``planned_matmuls`` a projection is a planned product
  (``dist.api._PlannedMatmul``, whose per-rank K1 calls run in the rank
  threads, out of the policy's sight), so ``"dots"`` recomputes it as
  ``"full"`` does, planned again: the recompute runs in the plan scope the
  block was wrapped in (``remat``), on whichever thread autograd runs it.

Without gradients every policy runs the block as is.
"""
from __future__ import annotations

from contextlib import ExitStack, contextmanager
from functools import partial
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts, noop_context_fn)

from repro_torch import obs
from repro_torch.device import DeviceLike, resolve_device
import repro_torch.kernels.matmul.ops  # noqa: F401  (registers the op ``_SAVED`` names)
from repro_torch.layers.attention import check_cache_write, gqa_cache, mla_cache
from repro_torch.layers.blocks import block_apply, block_params
from repro_torch.layers.embed import embed, embed_params, unembed
from repro_torch.layers.norms import rms_norm, rms_norm_params
from repro_torch.models.config import ModelConfig
from repro_torch.plan.context import current_scope, restore_scope

Params = Dict
Cache = Dict


def layer_stacks(cfg: ModelConfig) -> List[Tuple[str, str, int]]:
    """(key, block kind, layer count) of each per-layer stack of the params
    and the cache, in the order the layers run: deepseek-moe's leading
    dense layers, then the rest."""
    nd = cfg.first_dense_layers
    kind = "attn_moe" if cfg.num_experts else "attn_mlp"
    return ([("dense_layers", "attn_mlp", nd)] if nd else []) + [
        ("layers", kind, cfg.num_layers - nd)]


def decode_positions(pos, device) -> torch.Tensor:
    """The (1,) query position of a decode step at cache slot ``pos`` (an
    int, or a 0-d int64 tensor on the device, kept there)."""
    if torch.is_tensor(pos):
        return pos.reshape(1)
    return torch.full((1,), pos, dtype=torch.int64, device=device)


# the ops whose outputs ``"dots"`` keeps: the 2-D products without batch dims
_SAVED = (torch.ops.repro_torch.zorder_matmul.default, torch.ops.aten.mm.default)


def _dots_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat(fn, cfg: ModelConfig):
    """``fn`` (one uncached block) under the config's remat policy (module
    docstring); without gradients every policy runs the block as is."""
    policy = cfg.remat
    if policy not in ("none", "full", "dots"):
        raise ValueError(f"unknown remat policy {policy!r}")
    if policy == "none" or not torch.is_grad_enabled():
        return fn
    contexts = (partial(create_selective_checkpoint_contexts, _dots_policy)
                if policy == "dots" else noop_context_fn)
    scope = current_scope()

    def context_fn():
        # the recompute runs in the backward, on autograd's device thread
        # on CUDA: it takes the plan scope the block was wrapped in
        forward, recompute = contexts()
        return forward, _within(restore_scope(scope), recompute)

    # no op of a block draws random numbers, and a step captured as a CUDA
    # graph may not read the generator's state: none is stashed
    return lambda *args: checkpoint(fn, *args, use_reentrant=False, context_fn=context_fn,
                                    preserve_rng_state=False)


@contextmanager
def _within(*contexts):
    with ExitStack() as stack:
        for c in contexts:
            stack.enter_context(c)
        yield


class DecoderLM:
    # prefill / decode_step take per-row left-padding offsets (``generate``
    # passes them only to a model that says so, as the reference does)
    supports_position_offsets = True

    def __init__(self, cfg: ModelConfig):
        if cfg.attn_type not in ("gqa", "mla"):
            raise NotImplementedError(f"{cfg.name}: attention {cfg.attn_type!r} is not "
                                      f"ported yet")
        self.cfg = cfg
        self.dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32

    # -- params -------------------------------------------------------------
    def init(self, generator: torch.Generator, device: DeviceLike = None) -> Params:
        """Random parameters with the reference's distributions: embedding
        N(0, 0.02), projections N(0, 1/d_in), norms 1.  Numbers are drawn on
        ``generator``'s device and moved to ``device`` (default ``cuda``)."""
        device = resolve_device(device)
        cfg = self.cfg
        params = {
            "embed": embed_params(generator, cfg.vocab_size, cfg.d_model,
                                  cfg.tie_embeddings, self.dtype, device),
            "final_norm": rms_norm_params(cfg.d_model, device),
        }
        for key, kind, n in layer_stacks(cfg):
            params[key] = [block_params(generator, cfg, kind, self.dtype, device)
                           for _ in range(n)]
        return params

    def param_stacks(self) -> List[Tuple[str, int]]:
        """(key, layer count) of each per-layer list of the params (the
        reference stacks each on a leading axis)."""
        return [(key, n) for key, _, n in layer_stacks(self.cfg)]

    def stacks(self, tree: Dict) -> List[Tuple[str, list]]:
        """(block kind, per-layer list) of ``tree`` (params or cache) in the
        order the layers run (``layer_stacks``)."""
        return [(kind, tree[key]) for key, kind, _ in layer_stacks(self.cfg)]

    # -- forward ------------------------------------------------------------
    def forward(self, params: Params, tokens: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens: (B, S) -> (logits (B, S, V_padded) fp32, aux loss)."""
        with obs.span("model.forward"):
            cfg = self.cfg
            x = embed(params["embed"], tokens)
            positions = torch.arange(tokens.shape[1], device=tokens.device)
            aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
            block = remat(self._block, cfg)
            for kind, layers in self.stacks(params):
                for lp in layers:
                    x, a = block(lp, x, positions, kind)
                    aux = aux + a
            x = rms_norm(x, params["final_norm"], cfg.norm_eps)
            return unembed(params["embed"], x, cfg.vocab_size), aux

    def _block(self, lp: Params, x: torch.Tensor, positions: torch.Tensor, kind: str):
        x, a, _ = block_apply(lp, x, self.cfg, kind, positions)
        return x, a

    def loss(self, params: Params, batch: Dict) -> Tuple[torch.Tensor, Dict]:
        """Mean token cross-entropy over ``batch["labels"]`` (-100 =
        ignore) plus 0.01 x the aux loss, and the parts as {"ce", "aux"}.
        Differentiable with respect to ``params`` (module docstring)."""
        logits, aux = self.forward(params, batch["tokens"])
        ce = cross_entropy(logits, batch["labels"])
        return ce + 0.01 * aux, {"ce": ce, "aux": aux}

    # -- decode ---------------------------------------------------------------
    def init_cache(self, batch: int, max_seq: int, device) -> Cache:
        """One cache per layer: GQA's K/V or MLA's latent, with the leading
        dense layers' caches under ``"dense_layers"``."""
        cfg = self.cfg
        mk = mla_cache if cfg.attn_type == "mla" else gqa_cache
        return {key: [mk(cfg, batch, max_seq, self.dtype, device) for _ in range(n)]
                for key, _, n in layer_stacks(cfg)}

    def prefill(self, params: Params, cache: Cache, tokens: torch.Tensor,
                offsets: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Cache]:
        """One pass over the prompt: writes K/V at slots [0, S) of ``cache``
        in place and returns (last-token logits (B, V_padded), cache).

        ``offsets`` (B,) marks per-row left-padding: row i's logical
        positions are arange(S) - offsets[i], so its padding slots sit at
        negative positions and attention masks them out."""
        with obs.span("model.prefill"):
            positions = torch.arange(tokens.shape[1], device=tokens.device)
            if offsets is not None:
                positions = positions[None, :] - offsets[:, None]
            return self._cached_forward(params, cache, tokens, positions, 0, offsets)

    def decode_step(self, params: Params, cache: Cache, tokens: torch.Tensor,
                    pos, offsets: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, Cache]:
        """tokens: (B, 1); ``pos``: the absolute cache slot, an int or a
        0-d int64 tensor on the model's device.  Row i's logical query
        position is pos - offsets[i].  An int slot past the cache end
        raises; a tensor slot is not checked (that would wait for the
        device): check it with ``check_decode_pos`` first."""
        with obs.span("model.decode_step"):
            if offsets is not None:
                positions = pos - offsets[:, None]
            else:
                positions = decode_positions(pos, tokens.device)
            return self._cached_forward(params, cache, tokens, positions, pos, offsets)

    def check_decode_pos(self, cache: Cache, pos: int) -> None:
        """Raise where a decode step at slot ``pos`` (an int on the host)
        would write past the cache end: GQA's K/V or MLA's latent cache,
        the first layer's (every layer's cache has the same slots)."""
        _, first_stack = self.stacks(cache)[0]
        check_cache_write(self.cfg, first_stack[0], pos, 1)

    def _cached_forward(self, params: Params, cache: Cache, tokens: torch.Tensor,
                        positions: torch.Tensor, pos,
                        offsets: Optional[torch.Tensor]) -> Tuple[torch.Tensor, Cache]:
        cfg = self.cfg
        x = embed(params["embed"], tokens)
        for (kind, layers), (_, caches) in zip(self.stacks(params), self.stacks(cache)):
            for lp, lc in zip(layers, caches):
                x, _, _ = block_apply(lp, x, cfg, kind, positions, lc, pos, offsets)
        # only the last position's logits are returned: unembed just that row
        x = rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
        return unembed(params["embed"], x, cfg.vocab_size)[:, -1], cache


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """logits fp32 (B, S, V); labels (B, S) with -100 = ignore."""
    valid = labels >= 0
    gold = torch.gather(logits, -1, labels.clamp(min=0)[..., None])[..., 0]
    nll = (torch.logsumexp(logits, dim=-1) - gold) * valid
    return nll.sum() / valid.sum().clamp(min=1)
