"""Serving entry point: bucketed batch decode through the DecodeEngine,
the port of ``repro.launch.serve``.

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --full \
        --buckets 1x128,8x1024 --batch 8 --prompt-len 1000
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b \
        --full --buckets 1x128,8x1024 --batch 5 --prompt-len 1024
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \
        --full --buckets 1x128,8x1024 --batch 8 --prompt-len 1024
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch phi-3-vision-4.2b --full --buckets 1x128,8x1024 \
        --prompt-len 1000
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch whisper-large-v3 --full --buckets 1x128,8x384 \
        --prompt-len 384

Serves the reduced config of ``--arch`` (``list_archs()``) unless
``--full`` is given, on ``cuda`` unless ``--device cpu``. The weights are
drawn from ``--seed`` at the JAX package's init scales (no checkpoint is
loaded) and served from a ParamStore; the prompt is padded into the
tightest bucket. For the dense, MoE and vlm families (llama3.2-1b,
phi3.5-moe, phi-3-vision, ...) the seq is right-padded, so
``--prompt-len`` below the bucket's seq takes the rewind + re-feed path,
and prefill attention runs the CUDA flash kernel; the recurrent state of
rwkv6 and zamba2 would fold pads in, and whisper takes exact lengths as
in JAX, so there ``--prompt-len`` must equal a bucket's seq. rwkv6's
prefill and every decode step run the CUDA WKV kernel, zamba2's shared
attention block the flash kernel in prefill, whisper's encoder, decoder
and cross-attention the flash kernel in prefill. phi-3-vision's patch
features (B, 576, 1024) and whisper's frame embeddings (B, 1500, 1280)
are drawn from the seed too, as the stubbed image and audio frontends'
outputs, and passed as ``extras``. ``--full`` zamba2-7b (6.75B
parameters: 27 GB in f32 and a 13.5 GB bf16 copy), phi-3-vision and
whisper-large-v3 fit one 80 GB card; phi3.5-moe (42B) does not. The
prompt and the new tokens of whisper stay within 448 positions, the
published model's cap. Prints JAX's two lines, then one JSON line:
the prefill ms of a full bucket (no rewind step), the time to the first
token of the prompt as given (with the rewind step when it is shorter
than the bucket), decode ms per token, tokens/s, the engine's signature
counts and the kernel launches (``flash_attention``, ``rwkv_scan`` among
them).
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch._device import resolve_device
from repro_torch.configs import get_arch, get_reduced, list_archs
from repro_torch.kernels import ops
from repro_torch.models.registry import build_model, family_extras
from repro_torch.serve import DecodeEngine, ParamStore, select_bucket

CACHE_DTYPES = {None: None, "bfloat16": torch.bfloat16,
                "float32": torch.float32}


def parse_buckets(spec: str):
    """``"1x32,8x32"`` -> ((1, 32), (8, 32))."""
    out = []
    for part in spec.split(","):
        b, s = part.lower().split("x")
        out.append((int(b), int(s)))
    return tuple(out)


def _timed(fn, dev: torch.device):
    """(result, seconds) of ``fn()``, synchronised on a CUDA device."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out, time.perf_counter() - t0


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b", choices=list_archs())
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--buckets", default="1x32,8x32",
                    help="comma-separated batchxseq buckets")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--cache-dtype", default=None,
                    choices=[None, "bfloat16", "float32"],
                    help="KV-cache storage dtype (default: prefill dtype)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    arch = get_arch(args.arch) if args.full else get_reduced(args.arch)
    cfg = arch.model
    api = build_model(cfg)
    store = ParamStore()
    store.publish(api.init(torch.Generator(device=dev).manual_seed(
        args.seed)))
    engine = DecodeEngine(cfg, store, buckets=parse_buckets(args.buckets),
                          max_new_tokens=args.new_tokens,
                          cache_dtype=CACHE_DTYPES[args.cache_dtype])
    B, S = select_bucket(engine.buckets, args.batch, args.prompt_len,
                         pad_seq=engine.pad_seq)
    if args.batch > B:
        raise SystemExit(
            f"--batch {args.batch} exceeds the largest bucket batch {B}; "
            f"add a bigger bucket to --buckets (got {args.buckets})")
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    tokens = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=gen, device=dev, dtype=torch.int32)
    tokens = torch.nn.functional.pad(
        tokens, (0, S - args.prompt_len, 0, B - args.batch))

    full_bucket = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                                device=dev, dtype=torch.int32)
    extras = family_extras(cfg, B, gen) or None

    ops.reset_launches()

    def run(n):
        return engine.generate_batch(tokens, n, true_len=args.prompt_len,
                                     extras=extras)

    _, t_warm = _timed(lambda: run(args.new_tokens), dev)
    # prefill alone: a full bucket with one new token takes no decode step
    _, t_prefill = _timed(lambda: engine.generate_batch(
        full_bucket, 1, extras=extras), dev)
    _, t_first = _timed(lambda: run(1), dev)
    out, t_steady = _timed(lambda: run(args.new_tokens), dev)
    out = out[:args.batch]
    total = out.numel()
    decode_ms = ((t_steady - t_first) / max(args.new_tokens - 1, 1)
                 * 1e3)
    print(f"[serve] {args.arch} ({'full' if args.full else 'reduced'}) "
          f"batch={args.batch} prompt={args.prompt_len} "
          f"buckets={engine.buckets} v{engine.last_version}")
    print(f"[serve] warm {t_warm * 1e3:.0f} ms | steady "
          f"{t_steady / args.new_tokens * 1e3:.1f} ms/tok | "
          f"{total / t_steady:.1f} tok/s | compiles {engine.compile_counts}")
    rec = {"arch": args.arch, "full": args.full, "device": str(dev),
           "bucket": [B, S], "batch": args.batch,
           "prompt_len": args.prompt_len, "new_tokens": args.new_tokens,
           "prefill_ms": t_prefill * 1e3,
           "first_token_ms": t_first * 1e3,
           "decode_ms_per_token": decode_ms,
           "tokens_per_s": total / t_steady,
           "compile_counts": engine.compile_counts,
           "launches": ops.launch_counts(),
           "tokens_head": out[0, :8].tolist()}
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
