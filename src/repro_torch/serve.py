"""Batched serving on the port (counterpart of ``examples/serve.py``):
prefill a batch of prompts, then decode tokens greedily with the KV and
state caches, on the architecture's smoke variant with random parameters
from seed 0.  The decode loop is a ``models.Decoder``: on a card the step
is captured once into a CUDA graph and every token is one replay, as the
reference jits its decode step once for every position.

  python -m repro_torch.serve --arch gemma2-27b --tokens 16
  python -m repro_torch.serve --arch xlstm-350m --device cpu

``--device`` unset means the CUDA card (and an error without one), as for
every entry point of the port.  Times are host clock around work that ends
in a synchronize.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS
from repro_torch.device import resolve_device
from repro_torch.models import Decoder, Model

__all__ = ["main", "serve_inputs"]


def serve_inputs(cfg, B: int, S: int, rng: np.random.Generator, device):
    """(prompts (B, S), modality keyword inputs) drawn from ``rng`` as the
    example draws them: patch embeddings with text-like M-RoPE positions
    for a VLM, encoder frames for an encoder-decoder."""
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab, (B, S)),
                              dtype=torch.int32, device=device)
    kw = {}
    if cfg.n_patches:
        kw["patch_embeds"] = torch.as_tensor(
            rng.standard_normal((B, cfg.n_patches, cfg.d_vision)) * 0.02,
            dtype=torch.float32, device=device)
        kw["mrope_positions"] = torch.arange(
            S, dtype=torch.int32, device=device)[None, None].expand(3, B, S)
    if cfg.n_enc_layers:
        kw["enc_embeds"] = torch.as_tensor(
            rng.standard_normal((B, cfg.n_enc_frames, cfg.d_model)) * 0.02,
            dtype=torch.float32, device=device)
    return prompts, kw


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="gemma2-27b", choices=sorted(ARCHS))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = ARCHS[args.arch].smoke_variant()
    model = Model(cfg)
    params = model.init(0, device=device)
    rng = np.random.default_rng(0)

    B, S = args.batch, args.prompt_len
    prompts, kw = serve_inputs(cfg, B, S, rng, device)

    t0 = time.perf_counter()
    logits, caches = model.prefill(params, prompts,
                                   cache_len=S + args.tokens, **kw)
    _sync(device)
    t_prefill = time.perf_counter() - t0
    print(f"prefill: {B}x{S} in {t_prefill * 1e3:.0f} ms")

    tok = torch.argmax(logits[:, -1], dim=-1)[:, None].int()
    decoder = Decoder(params, cfg, B, S + args.tokens)
    decoder.load(caches, S)
    t0 = time.perf_counter()
    rest = decoder.generate(args.tokens - 1, token=tok)   # synchronizes
    dt = time.perf_counter() - t0
    toks = torch.cat([tok, rest], dim=1).cpu().numpy()
    print(f"decoded {args.tokens - 1} steps x batch {B} in {dt * 1e3:.0f} ms"
          f"  ({(args.tokens - 1) * B / max(dt, 1e-9):.1f} tok/s)")
    print("sample continuation token ids:", toks[0][:12])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
