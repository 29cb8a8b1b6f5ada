"""Serving driver: batched prefill + greedy decode against the KV cache.

Requests (one prompt per synthetic client) flow through the
``repro_torch.serve.MicroBatchScheduler``: prompts are submitted
individually, assembled into one bucket-padded batch, scored with a
single prefill + greedy-decode pipeline, and de-multiplexed back in
submission order. A port of ``repro.launch.serve`` with the same flags;
it runs on the card unless the caller passes ``device="cpu"``::

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
      --reduced --batch 4 --prompt-len 32 --gen 32

Every architecture of ``configs`` runs. The VLM (``llava-next-mistral-7b``)
gets zero patch embeddings and the audio family (``whisper-base``) zero
frame embeddings, the stub frontends' inputs, as in the reference. The
KV cache holds the patch prefix, the prompt and the generated tokens:
the reference sizes it ``prompt_len + gen + 1``, without the prefix, so
its ring-slot cache overwrites the prefix during decode.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.data import make_federated_lm_data
from repro_torch.models import init_cache, init_params, make_decode_step, make_prefill_step
from repro_torch.obs.trace import stopwatch
from repro_torch.serve import MicroBatchScheduler, ServeConfig
from repro_torch.utils.device import resolve_device
from repro_torch.utils.logging import get_logger

log = get_logger("serve")


def make_lm_score_fn(cfg, params, prefill, decode, gen: int):
    """Scheduler score_fn: (bucket, prompt_len) tokens -> (bucket, gen).

    Runs batched prefill then greedy decode on the device that holds
    ``params``; padded (all-zero) prompt rows decode garbage that the
    scheduler discards. The VLM's prefill gets zero patches and the
    encoder-decoder's zero frames, and the cache has room for the patch
    prefix. Each call appends ``{"bucket", "prompt_len",
    "gen", "prefill_seconds", "decode_seconds"}`` to ``score_fn.timings``:
    host seconds that end when the device is done (the first token's
    copy to the host ends the prefill; a synchronise ends the decode).
    """
    device = params.embed.device

    def score_fn(prompts: np.ndarray) -> np.ndarray:
        bucket, prompt_len = prompts.shape
        batch = {"tokens": torch.as_tensor(np.asarray(prompts, np.int32), device=device)}
        if cfg.n_patches:
            batch["patches"] = torch.zeros((bucket, cfg.n_patches, cfg.d_model), device=device)
        if cfg.is_encdec:
            batch["frames"] = torch.zeros((bucket, cfg.encoder_seq, cfg.d_model), device=device)
        cache = init_cache(cfg, bucket, kv_len=cfg.n_patches + prompt_len + gen + 1,
                           device=device)
        elapsed = stopwatch()
        logits, cache = prefill(params, batch, cache)
        tok = torch.argmax(logits, dim=-1)[:, None]
        first = tok.cpu().numpy()[:, 0]
        prefill_s = elapsed()
        log.info("prefill %d x %d tokens in %.2fs", bucket, prompt_len, prefill_s)
        out = []
        elapsed = stopwatch()
        for i in range(gen):
            out.append(first if i == 0 else tok.cpu().numpy()[:, 0])
            logits, cache = decode(params, tok, cache)
            tok = torch.argmax(logits, dim=-1)[:, None]
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = elapsed()
        log.info("decoded %d tokens/seq in %.2fs (%.1f tok/s total)", gen, dt,
                 bucket * gen / dt if dt > 0 else float("inf"))
        score_fn.timings.append({"bucket": bucket, "prompt_len": prompt_len, "gen": gen,
                                 "prefill_seconds": prefill_s, "decode_seconds": dt})
        return np.stack(out, axis=1)  # (bucket, gen)

    score_fn.timings = []
    return score_fn


def serve_prompts(cfg, params, prompts: np.ndarray, gen: int):
    """Serve ``prompts`` (n, prompt_len) int32, one request each, through
    one scheduler whose single bucket is the whole batch, as ``main``
    does. Returns (generated tokens (n, gen), the scheduler); the
    scheduler's ``score_fn.timings`` holds the prefill and decode
    seconds."""
    n = len(prompts)
    prefill = make_prefill_step(cfg)
    decode = make_decode_step(cfg)
    score_fn = make_lm_score_fn(cfg, params, prefill, decode, gen)
    sched = MicroBatchScheduler(
        score_fn, ServeConfig(max_batch=n, max_queue=4 * n, buckets=(n,)))
    out = sched.run(list(prompts))
    log.info("served %d requests in %d scoring batch(es), %d padded rows",
             sched.stats.submitted, sched.stats.batches, sched.stats.padded_rows)
    return out, sched


def main(argv=None, device="cuda"):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dev = resolve_device(device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced(max_decode_len=args.prompt_len + args.gen + 1)
    params = init_params(cfg, seed=args.seed, device=dev)

    # requests: prompts from distinct synthetic clients, batched by the
    # scheduler (one bucket == the serving batch; no partial batches here)
    clients = make_federated_lm_data(args.batch, cfg.vocab, args.prompt_len + 8, seed=args.seed)
    prompts = np.stack([c[: args.prompt_len] for c in clients]).astype(np.int32)
    gen, _ = serve_prompts(cfg, params, prompts, args.gen)
    for b in range(min(args.batch, 2)):
        print(f"req{b}: prompt={prompts[b, -8:].tolist()} -> gen={gen[b, :16].tolist()}")
    return gen


if __name__ == "__main__":
    main()
