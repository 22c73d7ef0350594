"""Serving example (PyTorch port): prefill a prompt, then decode tokens
greedily against the KV / state cache, for any of the 10 assigned
architectures.

    PYTHONPATH=src python examples/serve_decode_torch.py \\
        [--arch mamba2-370m] [--tokens 32] [--prompt-len 16] [--batch 2] \\
        [--full] [--device cpu]

The twin of ``examples/serve_decode.py`` on ``repro_torch``: an
encoder-decoder (whisper-medium) first encodes stub audio frames into the
memory its cross-attention reads; the prompt is prefilled by
teacher-forcing it through decode steps, then each step feeds back its
argmax.  The default is the arch's smoke config (``--full``: its full
config, Mamba-2-370M's 48 layers at d 1,024) with random weights from
seed 0.  Runs on the CUDA card unless ``--device cpu`` is given.
"""

import argparse
import time

import torch

from repro_torch.configs import get_config, get_smoke_config, stand_in_inputs
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.launch.serve import make_decode_step
from repro_torch.models import encode_frames, init_cache, init_model


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-370m")
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
    memory = None
    if cfg.encoder is not None:
        frames = stand_in_inputs(cfg, b, scale=0.1)["frames"]
        with torch.inference_mode():
            memory = encode_frames(params, cfg, frames.to(device))
        print(f"encoded {cfg.encoder.n_frames} audio frames")

    # --- prefill by teacher-forcing the prompt through decode steps -------
    caches = init_cache(cfg, b, args.prompt_len + args.tokens + 1,
                        torch.float32, device=device)
    dstep = make_decode_step(cfg, make_debug_mesh(data=1, model=1),
                             compute_dtype=torch.float32, device=device)
    logits = None
    for t in range(args.prompt_len):
        logits, caches = dstep(params, prompt[:, t:t + 1], caches,
                               memory=memory)

    # --- greedy decode ------------------------------------------------------
    out_tokens = []
    tok = torch.argmax(logits[:, -1:], dim=-1)
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.tokens):
        out_tokens.append(tok[:, 0])
        logits, caches = dstep(params, tok, caches, memory=memory)
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
