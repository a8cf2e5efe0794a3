"""Run any of the 10 assigned architectures: prefill + autoregressive decode
on a reduced config, demonstrating `--arch` selection and the shared
prefill/decode_step serving API (plus greedy sampling). The port's
counterpart of the JAX package's `examples/lm_inference.py`, with its
flags and output.

    python -m repro_torch.examples.lm_inference --arch rwkv6-7b --tokens 16 \\
        [--device cuda|cpu]

`--device cuda` (the default) needs a card; `--device cpu` runs on the
host. Run from a checkout with `src` on the path (`PYTHONPATH=src`).
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import LM_ARCHS, get_config, reduced
from repro_torch.models import build_model
from repro_torch.utils import resolve_device


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="phi4-mini-3.8b", choices=LM_ARCHS)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; needs a card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = reduced(get_config(args.arch))
    model = build_model(cfg, device=device, seed=0)
    print(f"arch={cfg.name} family={cfg.family} layers={cfg.num_layers} "
          f"d={cfg.d_model} vocab={cfg.vocab_size}")

    B = 1
    s_max = args.prompt_len + args.tokens
    gen = torch.Generator(device=device).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (B, args.prompt_len),
                           generator=gen, device=device)

    with torch.inference_mode():
        if cfg.is_encoder_decoder:
            frames = torch.randn((B, cfg.encoder_seq_len, cfg.d_model),
                                 generator=gen, device=device)
            enc = model.encode(frames)
            cache = model.init_cache(B, s_max, dtype=torch.float32)
            tok = prompt[:, :1]
            out = [tok]
            for t in range(args.tokens):
                logits, cache = model.decode(tok, enc, cache=cache,
                                             cache_pos=t)
                tok = torch.argmax(logits[:, -1:], dim=-1)
                out.append(tok)
            ids = torch.cat(out, dim=1)[0].tolist()   # one copy at the end
            print("decoded (audio->text ids):", ids)
            return {"cfg": cfg, "decoded": ids}

        cache = model.init_cache(B, s_max, dtype=torch.float32)
        logits, cache = model.prefill(prompt, cache)
        tok = torch.argmax(logits[:, -1:], dim=-1)
        out = [tok]
        for t in range(args.prompt_len, args.prompt_len + args.tokens - 1):
            logits, cache = model.decode_step(tok, cache, t)
            tok = torch.argmax(logits[:, -1:], dim=-1)
            out.append(tok)
    ids = torch.cat(out, dim=1)[0].tolist()
    print("prompt ids:", prompt[0].tolist())
    print("greedy continuation ids:", ids)
    return {"cfg": cfg, "prompt": prompt[0].tolist(), "continuation": ids}


if __name__ == "__main__":
    main()
