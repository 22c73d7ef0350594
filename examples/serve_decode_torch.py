"""Serving example (PyTorch port): prefill a prompt, then decode tokens
greedily against the KV cache.

    PYTHONPATH=src python examples/serve_decode_torch.py \\
        [--arch smollm-135m] [--tokens 32] [--prompt-len 16] [--batch 2] \\
        [--full] [--device cpu]

The twin of ``examples/serve_decode.py`` on ``repro_torch``: the prompt is
prefilled by teacher-forcing it through decode steps, then each step feeds
back its argmax.  The default is the arch's smoke config (``--full``: its
full config, SmolLM-135M's 30 layers at d 576) with random weights from
seed 0.  Runs on the CUDA card unless ``--device cpu`` is given.  The
port serves the dense archs (smollm, qwen2, phi3) and the MoE family
(deepseek-v2-lite-16b with its MLA latent cache, moonshot-v1-16b-a3b,
granite-moe-3b-a800m); the others raise ``NotImplementedError`` (ROADMAP
Queue 1: the rest of the model zoo), among them the reference example's
default, mamba2-370m.
"""

import argparse
import time

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.launch.serve import make_decode_step
from repro_torch.models import init_cache, init_model


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default=None)
    args = ap.parse_args()

    device = resolve_device(args.device)
    cfg = get_config(args.arch) if args.full else get_smoke_config(args.arch)
    params = init_model(cfg, 0, device)
    b = args.batch
    gen = torch.Generator().manual_seed(0)
    prompt = torch.randint(0, cfg.vocab_size, (b, args.prompt_len),
                           generator=gen).to(device)

    # --- prefill by teacher-forcing the prompt through decode steps -------
    caches = init_cache(cfg, b, args.prompt_len + args.tokens + 1,
                        torch.float32, device=device)
    dstep = make_decode_step(cfg, make_debug_mesh(data=1, model=1),
                             compute_dtype=torch.float32, device=device)
    logits = None
    for t in range(args.prompt_len):
        logits, caches = dstep(params, prompt[:, t:t + 1], caches)

    # --- greedy decode ------------------------------------------------------
    out_tokens = []
    tok = torch.argmax(logits[:, -1:], dim=-1)
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.tokens):
        out_tokens.append(tok[:, 0])
        logits, caches = dstep(params, tok, caches)
        tok = torch.argmax(logits[:, -1:], dim=-1)
    gen_tokens = torch.stack(out_tokens, dim=1).cpu()   # waits for the card
    dt = time.perf_counter() - t0

    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "CPU")
    print(f"arch={cfg.name}  batch={b}  generated {args.tokens} tokens/seq")
    print(f"first sequence: {gen_tokens[0][:16].tolist()} ...")
    print(f"decode throughput: {b * args.tokens / dt:.1f} tok/s "
          f"({1e3 * dt / args.tokens:.1f} ms/step) on {where} (fp32, "
          f"untuned)")


if __name__ == "__main__":
    main()
