"""Serving entry point: batched prefill + decode with a KV cache for any zoo
arch, on CUDA unless --device cpu.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \
        --smoke --batch 4 --prompt-len 32 --gen 32 [--device cpu]

The port of ``repro.launch.serve``: the same flags and the same three
printed lines. Prompt, memory and images are drawn from
np.random.default_rng(0) in the reference's order; weights come from
init_params with a generator seeded 0 on the device. Prefill steps
through the prompt one token at a time (robust across cache families),
then decode is greedy. Each step ends in a device barrier, so the step
times are the device's.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.context import resolve_device
from repro_torch.models.config import ArchConfig
from repro_torch.models.model import DecodeModel


@dataclasses.dataclass
class ServeResult:
    cfg: ArchConfig
    model: DecodeModel
    generated: np.ndarray          # (batch, gen) greedy tokens
    step_s: List[float]            # every step's wall time, barrier included
    prefill_steps: int
    total_s: float
    cache: dict                    # the decode state after the last step
    last_tokens: torch.Tensor      # (batch,) the last step's greedy tokens

    @property
    def steps(self) -> int:
        return len(self.step_s)

    @property
    def decode_step_s(self) -> List[float]:
        return self.step_s[self.prefill_steps:]


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="torch device everything runs on; cuda fails "
                         "when no CUDA device is present")
    return ap.parse_args(argv)


def _barrier(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(args: argparse.Namespace,
          cfg: Optional[ArchConfig] = None) -> ServeResult:
    """Prefill and greedy decode of one batch. `cfg` overrides --arch and
    --smoke (a depth-cut configuration)."""
    device = resolve_device(args.device)
    cfg = cfg or get_config(args.arch, smoke=args.smoke)
    rng = np.random.default_rng(0)
    model = DecodeModel(cfg, device)
    b = args.batch
    s_max = args.prompt_len + args.gen

    cache = model.init_cache(b, s_max)
    if cfg.enc_dec:
        cache["memory"] = torch.as_tensor(
            rng.normal(size=(b, 4096, cfg.d_model)),
            dtype=torch.bfloat16).to(device)
    if cfg.xattn_period:
        cache["images"] = torch.as_tensor(
            rng.normal(size=(b, cfg.n_img_tokens, cfg.d_model)),
            dtype=torch.bfloat16).to(device)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab, (b, args.prompt_len)),
                             dtype=torch.int32).to(device)
    step_s = []

    def step(tok, pos):
        t = time.perf_counter()
        tok, new_cache = model.serve_step(cache, tok, pos)
        _barrier(device)
        step_s.append(time.perf_counter() - t)
        return tok, new_cache

    _barrier(device)
    t0 = time.perf_counter()
    for i in range(args.prompt_len - 1):
        _, cache = step(prompt[:, i], i)
    outs = []
    tok = prompt[:, -1]
    for i in range(args.gen):
        tok, cache = step(tok, args.prompt_len - 1 + i)
        outs.append(tok)
    gen = torch.stack(outs, dim=1).cpu().numpy()
    total_s = time.perf_counter() - t0
    return ServeResult(cfg, model, gen, step_s, args.prompt_len - 1,
                       total_s, cache, tok)


def report(res: ServeResult, batch: int) -> List[str]:
    """The reference's three lines."""
    return [f"arch={res.cfg.name} generated {res.generated.shape} tokens",
            str(res.generated[:, :16]),
            f"{res.steps} serve steps in {res.total_s:.2f}s -> "
            f"{batch * res.steps / res.total_s:.1f} tok/s (batch={batch})"]


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    res = serve(args)
    for line in report(res, args.batch):
        print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
