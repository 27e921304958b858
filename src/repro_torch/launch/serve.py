"""Batched serving: prefill + greedy decode over bucketed slots
(the port of ``repro.launch.serve``).

Requests arrive with different prompt lengths; batching goes through the
port's copy of :class:`~repro_torch.runtime.serving.SlotQueue`.  Each
drained slot is left-padded to its bucket, prefilled (attention through
the flash-attention kernel on the card, and Zamba2's Mamba2 layers
through the SSD-scan kernel), then decoded greedily until max-tokens;
rows land back at their original request index.

On the card (the default; it raises without one):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2_1_5b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2_2_7b
On the host, at the smoke size:
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --smoke \\
      --arch zamba2_2_7b --requests 6 --max-new 12
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.runtime.serving import SlotQueue


def make_requests(cfg, n, seed=0, lo=4, hi=24):
    rng = np.random.RandomState(seed)
    lens = rng.randint(lo, hi, size=n)
    return [rng.randint(1, cfg.vocab_size, size=L).astype(np.int32) for L in lens]


def pad_batch(cfg, prompts, bucket, device=None):
    B = len(prompts)
    toks = np.zeros((B, bucket), np.int32)
    for i, p in enumerate(prompts):
        toks[i, -len(p):] = p  # left-pad so decode continues from the end
    return {"tokens": torch.from_numpy(toks).to(device)}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_slot(cfg, prefill_fn, serve_fn, params, prompts, bucket, max_new):
    """Prefill one drained slot and decode it greedily.

    Returns ``(gen, logits, t_prefill, t_decode)`` where ``gen`` holds the
    ``(len(prompts), max_new)`` generated token ids and ``logits`` the last
    step's.  Runs on the device that holds ``params``; each time ends in a
    device sync.
    """
    device = params["embed"]["table"].device
    batch = pad_batch(cfg, prompts, bucket, device)
    t0 = time.perf_counter()
    logits, cache = prefill_fn(params, batch)
    next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
    _sync(device)
    t_prefill = time.perf_counter() - t0

    outs = [next_tok[:, 0]]
    t0 = time.perf_counter()
    for _ in range(max_new - 1):
        tok, logits, cache = serve_fn(params, cache, {"token": next_tok})
        next_tok = tok[:, None]
        outs.append(tok)
    gen = torch.stack(outs, dim=1).cpu().numpy()
    t_decode = time.perf_counter() - t0
    return gen, logits, t_prefill, t_decode


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2_1_5b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--bucket", type=int, default=32)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device; default the GPU (raises without one)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    # cache sized for the full generation so no decode write runs past it
    prefill_fn, model = make_prefill_step(cfg,
                                          cache_len=args.bucket + args.max_new)
    serve_fn, _ = make_serve_step(cfg)

    params = model.init(torch.Generator(device=device).manual_seed(args.seed))
    prompts = make_requests(cfg, args.requests, args.seed)

    queue = SlotQueue(buckets=(args.bucket,), max_batch=args.max_batch)
    for i, p in enumerate(prompts):
        queue.add(args.arch, len(p), i)

    gen = np.zeros((args.requests, args.max_new), np.int32)
    t_prefill = t_decode = 0.0
    n_slots = 0
    with torch.inference_mode():
        while len(queue):
            idxs = queue.drain(args.arch, args.bucket)
            rows, logits, tp, td = run_slot(cfg, prefill_fn, serve_fn, params,
                                            [prompts[i] for i in idxs],
                                            args.bucket, args.max_new)
            if not bool(torch.isfinite(logits.float()).all()):
                raise FloatingPointError(f"slot {n_slots}: non-finite logits")
            gen[np.asarray(idxs)] = rows
            t_prefill += tp
            t_decode += td
            n_slots += 1

    assert gen.shape == (args.requests, args.max_new)
    for i, p in enumerate(prompts):
        print(f"req{i}: prompt_len={len(p)} -> {gen[i, :8].tolist()}...")
    tps = args.requests * args.max_new / max(t_decode, 1e-9)
    print(f"{n_slots} slot(s)   prefill {t_prefill:.2f}s   "
          f"decode {t_decode:.2f}s ({tps:.1f} tok/s batch-aggregate)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
