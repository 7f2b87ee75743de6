"""Batched serving demo on the PyTorch port: prefill a batch of prompts,
decode greedily.

Exercises the serve path of ``repro_torch.models`` (KV caches, ring
buffers for SWA, SSM states for the attention-free archs) on any arch's
smoke config, on the GPU unless told otherwise:

    PYTHONPATH=src python examples/serve_lm_torch.py --arch mixtral-8x7b --tokens 32
    PYTHONPATH=src python examples/serve_lm_torch.py --device cpu
"""

import argparse
import time

import torch

import repro_torch.configs as cfgs
from repro_torch.models import EncDecConfig, build


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-14b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--tokens", type=int, default=48)
    ap.add_argument("--device", default=None,
                    help="torch device; default cuda, which raises "
                         "without a card")
    args = ap.parse_args()

    cfg = cfgs.get_smoke(args.arch)
    model = build(cfg, args.device)
    dev = model.device
    gen = torch.Generator(device=dev).manual_seed(0)
    params = model.init(gen)
    B, L = args.batch, args.prompt_len
    prompts = torch.randint(0, cfg.vocab, (B, L), generator=gen, device=dev)
    max_len = L + args.tokens + 1

    if isinstance(cfg, EncDecConfig):
        frames = torch.randn((B, cfg.enc_len, cfg.d_model), generator=gen,
                             device=dev)
        enc_out = model.encode(params, frames)
        cache = model.init_cache(params, enc_out, B, max_len)
    else:
        cache = model.init_cache(B, max_len)

    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, prompts, cache)
    tok = torch.argmax(logits, -1).to(torch.int32)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    out = [tok]
    t0 = time.perf_counter()
    for _ in range(args.tokens - 1):
        logits, cache = model.decode_step(params, tok, cache)
        tok = torch.argmax(logits, -1).to(torch.int32)
        out.append(tok)
    _sync(dev)
    t_decode = time.perf_counter() - t0

    gen_toks = torch.stack(out, 1).cpu()  # (B, tokens)
    print(f"arch={args.arch} ({cfg.name}) on {dev}")
    print(f"prefill: {B}x{L} tokens in {t_prefill*1e3:.1f} ms "
          f"({B*L/t_prefill:.0f} tok/s)")
    print(f"decode:  {args.tokens-1} steps x {B} seqs in {t_decode*1e3:.1f} ms "
          f"({B*(args.tokens-1)/max(t_decode,1e-9):.0f} tok/s)")
    print("first generated rows:", gen_toks[:2, :12].tolist())


if __name__ == "__main__":
    main()
