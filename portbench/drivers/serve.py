"""A closed loop of request batches through ``repro_torch``'s ``Server``:
one bucket, warmed and captured at set-up, each batch sent when the last
has come back.  The answers judged are served tokens: a sample of the
window's requests drawn from the seed, the longest prompt among them, each
read by the plain reference over its prompt and its served tokens."""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List

import numpy as np
import torch

from portbench import profiler, spec, weights
from portbench.reference import compare

PAD_ID = 0        # the server's default left-padding token
SAMPLE_STREAM = 3


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx

    def setup(self) -> None:
        from repro_torch.models.config import ModelConfig
        from repro_torch.models.lm import DecoderLM
        from repro_torch.runtime.serve import ServeConfig
        from repro_torch.serve import Server

        ctx, wl, tr = self.ctx, self.ctx.workload, self.ctx.traffic
        self.bucket = tuple(wl["bucket"])
        self.max_seq = int(wl["max_seq"])
        self.new_tokens = int(tr["max_new_tokens"])
        t0 = time.perf_counter()
        self.params = weights.make(ctx.model, ctx.seed, ctx.device)
        self.tree = weights.program_tree(self.params)
        t1 = time.perf_counter()
        self.model = DecoderLM(ModelConfig(**ctx.model))
        self.server = Server(self.model, self.tree,
                             ServeConfig(max_new_tokens=self.new_tokens, temperature=0.0,
                                         max_seq=self.max_seq),
                             buckets=[self.bucket])
        report = self.server.warmup([self.bucket])[f"{self.bucket[0]}x{self.bucket[1]}"]
        self.phases = {"weights_s": t1 - t0, "warm_s": report["warm_s"],
                       "capture_s": report.get("capture_s", 0.0)}
        self.gen = spec.traffic_kind(tr["kind"])
        self.batches = self.gen.Batches(tr, ctx.seed, self._vocab())
        self.served: List = []

    def _vocab(self) -> int:
        return int(self.ctx.model["vocab_size"])

    def window(self, seconds: float) -> Dict:
        """Batches until ``seconds`` have passed.  In a traced run
        (``ctx.traced``) each decode step also lies between two CUDA events,
        read once the window has closed: each step's device time, and the
        time from one step's end to the next one's start (sampling and the
        host's turn), on the device's clock and with no profiler."""
        self.served = []
        marks: List = []
        with self._timed_steps(marks) if self.ctx.traced else contextlib.nullcontext():
            t0 = time.perf_counter()
            while True:
                prompts = self.batches.next()
                res = self.server.generate(prompts)
                self.served.append((prompts, res))
                if time.perf_counter() - t0 >= seconds:
                    break
            elapsed = time.perf_counter() - t0
        requests = sum(len(p) for p, _ in self.served)
        failed = sum(len(t) != self.new_tokens for _, r in self.served for t in r.new_tokens)
        gaps = np.concatenate([np.repeat(r.step_latencies_s, len(p)) for p, r in self.served])
        stats = {"seconds": elapsed, "batches": len(self.served), "attempted": requests,
                 "failed": failed,
                 "generated": sum(len(t) for _, r in self.served for t in r.new_tokens),
                 "gaps_s": gaps,
                 "ttft_s": [r.ttft_s for p, r in self.served for _ in p],
                 "prompt_lens": [len(x) for p, _ in self.served for x in p],
                 "new_tokens": self.new_tokens}
        if marks:
            _sync(self.ctx.device)
            stats["step_device_ms"] = [a.elapsed_time(b) for batch in marks for a, b in batch]
            stats["between_steps_ms"] = [b0.elapsed_time(a1) for batch in marks
                                         for (_, b0), (a1, _) in zip(batch, batch[1:])]
        return stats

    @contextlib.contextmanager
    def _timed_steps(self, marks: List):
        """``token_loop`` with each decode step between two CUDA events; a
        list of (start, end) events a batch is appended to ``marks``."""
        from repro_torch.serve import server as server_mod

        real = server_mod.token_loop

        def timed_loop(*args, step, **kw):
            batch: List = []
            marks.append(batch)

            def timed_step(cur, pos):
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                out = step(cur, pos)
                end.record()
                batch.append((start, end))
                return out
            return real(*args, step=timed_step, **kw)

        server_mod.token_loop = timed_loop
        try:
            yield
        finally:
            server_mod.token_loop = real

    def end_to_end(self, stats: Dict) -> Dict[str, float]:
        return {"decode_tokens_per_s": stats["generated"] / stats["seconds"],
                "token_latency_p95_ms": float(np.percentile(stats["gaps_s"], 95)) * 1e3}

    def traced(self) -> Dict:
        """The traced stretch: one batch."""
        t0 = time.perf_counter()
        self.server.generate(self.batches.next())
        return {"seconds": time.perf_counter() - t0, "batches": 1}

    def traced_extras(self) -> Dict:
        """After the traced stretch: one eager decode step at the bucket's
        shape on a cache of its own, for the layers' ranges (a replay runs
        no Python a range could wrap)."""
        from repro_torch.runtime.serve import decode_step

        batch, seq = self.bucket
        dev = self.ctx.device
        cache = self.model.init_cache(batch, self.max_seq, dev)
        cur = torch.ones((batch, 1), dtype=torch.int64, device=dev)
        offsets = torch.zeros(batch, dtype=torch.int64, device=dev)
        pos = torch.full((), seq, dtype=torch.int64, device=dev)
        with torch.no_grad():
            decode_step(self.model, self.tree, cache, cur, pos, offsets)
            _sync(dev)
            with profiler.traced() as prof:
                decode_step(self.model, self.tree, cache, cur, pos, offsets)
                _sync(dev)
        return {"eager_step_ranges": profiler.Trace(prof).ranges(), "eager_step_rows": batch}

    def release(self) -> None:
        """Free the program's state (the server, its caches and graphs);
        the served tokens and the weights stay."""
        self.server = None
        self.model = None
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def _sample(self) -> List:
        """(prompt, served tokens) of the requests the check reads: drawn
        from the seed among those served, the longest prompt among them."""
        reqs = [(p, t) for prompts, r in self.served for p, t in zip(prompts, r.new_tokens)
                if len(t) == self.new_tokens]
        n = min(int(self.ctx.workload["sample_requests"]), len(reqs))
        rng = np.random.default_rng([int(self.ctx.seed), SAMPLE_STREAM])
        longest = max(range(len(reqs)), key=lambda i: len(reqs[i][0]))
        rest = [i for i in rng.permutation(len(reqs)) if i != longest][:n - 1]
        return [reqs[i] for i in [longest] + rest]

    def check(self, control: bool = False) -> Dict[str, float]:
        """Over the sampled requests' served tokens, against the
        reference's logits at their positions (``compare.gap_readings``):
        ``logit_gap``, the widest gap by which a served token's logit lies
        below the reference's best, in units of the logits' spread at its
        position; ``logit_gap_mean``, the mean gap;
        ``token_mismatch``, the share of tokens that are not the
        reference's best.  With ``control``, the same of the tokens that
        the reference computed in float8 puts first, under ``control.``."""
        ref_mod = spec.reference(self.ctx.config["reference"])
        dev = self.ctx.device
        plen = self.bucket[1]
        sample = self._sample()
        prompts = torch.full((len(sample), plen), PAD_ID, dtype=torch.int64)
        for i, (p, _) in enumerate(sample):
            prompts[i, plen - len(p):] = torch.tensor(p)
        offsets = torch.tensor([plen - len(p) for p, _ in sample])
        served = torch.tensor([t for _, t in sample], dtype=torch.int64)
        args = (self.params, self.ctx.model, prompts.to(dev), offsets.to(dev),
                served[:, :-1].to(dev), self.max_seq)
        ref = ref_mod.served_logits(*args)
        vocab = self._vocab()
        out = compare.gap_readings(ref, served, vocab)
        if control:
            low = ref_mod.served_logits(*args, fp8=True)
            out.update({f"control.{k}": v
                        for k, v in compare.gap_readings(ref, low.argmax(-1), vocab).items()})
        return out

    def reseed(self, seed: int) -> None:
        """New weights and traffic from ``seed``, in the same tensors the
        captured steps read."""
        self.ctx.seed = seed
        weights.refill(self.params, seed)
        self.batches = self.gen.Batches(self.ctx.traffic, seed, self._vocab())


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
