"""A closed loop of uncached forwards: ``DecoderLM.forward`` over a batch
of sequences, the next batch sent when the last has returned.  The answer
judged is the last forward's logits, every row of every sequence, against
the plain reference's forward over the same tokens, a sequence at a time."""
from __future__ import annotations

import time
from typing import Dict

import torch

from portbench import spec, weights
from portbench.reference import compare


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx

    def setup(self) -> None:
        from repro_torch.models.config import ModelConfig
        from repro_torch.models.lm import DecoderLM

        ctx = self.ctx
        t0 = time.perf_counter()
        self.params = weights.make(ctx.model, ctx.seed, ctx.device)
        self.tree = weights.program_tree(self.params)
        self.model = DecoderLM(ModelConfig(**ctx.model))
        gen = spec.traffic_kind(ctx.traffic["kind"])
        self.seqs = [torch.from_numpy(s).to(ctx.device)
                     for s in gen.make(ctx.traffic, ctx.seed, ctx.model["vocab_size"])]
        t1 = time.perf_counter()
        self._forward(0)    # builds and loads the kernels, warms every shape
        self.phases = {"weights_s": t1 - t0, "warm_forward_s": time.perf_counter() - t1}
        self.last = None

    def _forward(self, i: int) -> torch.Tensor:
        with torch.no_grad():
            logits, _ = self.model.forward(self.tree, self.seqs[i])
        if logits.is_cuda:
            torch.cuda.synchronize(logits.device)
        return logits

    def _loop(self, seconds: float, forwards: int = 0) -> Dict:
        """Forwards until ``seconds`` have passed, or ``forwards`` of them."""
        n, t0 = 0, time.perf_counter()
        while True:
            i = n % len(self.seqs)
            self.last = (i, self._forward(i))
            n += 1
            if n == forwards or (not forwards and time.perf_counter() - t0 >= seconds):
                break
        elapsed = time.perf_counter() - t0
        batch, seq = self.seqs[0].shape
        return {"seconds": elapsed, "forwards": n, "tokens": n * batch * seq, "batch": batch,
                "seq": seq, "attempted": n * batch, "failed": 0}

    def window(self, seconds: float) -> Dict:
        return self._loop(seconds)

    def traced(self) -> Dict:
        """The traced stretch: one forward of each distinct batch."""
        return self._loop(0.0, len(self.seqs))

    def end_to_end(self, stats: Dict) -> Dict[str, float]:
        return {"prefill_tokens_per_s": stats["tokens"] / stats["seconds"]}

    def traced_extras(self) -> Dict:
        return {}

    def release(self) -> None:
        """Free the program's state; the answer and the weights stay."""
        self.model = None

    def check(self, control: bool = False) -> Dict[str, float]:
        """``logits_row_err``: the worst row's relative L2 gap between the
        last forward's logits and the reference's, over every sequence of
        the batch.  With ``control``, also the same number for the
        reference computed in float8."""
        ref_mod = spec.reference(self.ctx.config["reference"])
        i, logits = self.last
        out = {"logits_row_err": 0.0}
        if control:
            out["control.logits_row_err"] = 0.0
        for row, tokens in enumerate(self.seqs[i]):
            ref = ref_mod.prefill_logits(self.params, self.ctx.model, tokens)
            out["logits_row_err"] = max(out["logits_row_err"],
                                        compare.worst_row_rel_err(logits[row], ref))
            if control:
                low = ref_mod.prefill_logits(self.params, self.ctx.model, tokens, fp8=True)
                out["control.logits_row_err"] = max(out["control.logits_row_err"],
                                                    compare.worst_row_rel_err(low, ref))
                del low
            del ref
        return out

    def reseed(self, seed: int) -> None:
        """New weights and sequences from ``seed`` in the same tensors."""
        self.ctx.seed = seed
        weights.refill(self.params, seed)
        gen = spec.traffic_kind(self.ctx.traffic["kind"])
        for t, s in zip(self.seqs, gen.make(self.ctx.traffic, seed, self.ctx.model["vocab_size"])):
            t.copy_(torch.from_numpy(s))
