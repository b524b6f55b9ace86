"""Serving launcher CLI of the torch port.

    PYTHONPATH=src python -m repro_torch.launch.serve --device cuda
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --requests 4

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --mode continuous --trace --flush-every 4 --out runs/serve

Takes the flags and defaults of ``python -m repro.launch.serve`` for the
single-engine paths and serves ``reduced(get_config(arch))`` with random
weights from ``--seed`` through ``--mode unified``
(:class:`repro_torch.serve.step.UnifiedServeEngine`, the default),
``continuous`` (the grouped-prefill
:class:`repro_torch.serve.engine.ContinuousServeEngine`) or ``static``
(the fixed-batch :class:`repro_torch.serve.engine.ServeEngine`).
``--trace`` records the run with the port's tracer and writes the merged
Paraver trace to ``<--out>/serve.prv`` (``--flush-every N`` streams
segments to disk every N decode iterations first), then prints the
TTFT/TPOT summary read from it.  ``--device`` picks the card (default)
or, explicitly, the CPU.  Flags of paths not ported yet (meshes,
replicas, speculative decoding, forks, beams, sessions, quantized pools,
the two-deep overlap pipeline) stop with an error naming the flag.
"""
from __future__ import annotations

import argparse
import pathlib
import sys

import numpy as np

# flag -> the values the ported paths serve; any other value selects a
# path that is not ported yet
_PORTED_VALUES = {
    "mesh": ("",), "mp": (0,), "n": (1,), "best_of": (0,), "beam": (0,),
    "session": (False,), "spec": ("",), "kv_dtype": ("", "fp16"),
    "overlap": ("", "off", "auto"), "replicas": (0,), "disaggregate": (False,),
}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="granite-8b")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' must be asked for explicitly")
    p.add_argument("--mode", default="unified",
                   choices=["unified", "continuous", "static"])
    p.add_argument("--max-step-tokens", type=int, default=0,
                   help="unified-step token budget per scheduler iteration "
                        "(0 = slots + chunk-size * chunk-rows)")
    p.add_argument("--chunk-size", type=int, default=0,
                   help="prefill chunk length (0 = max(2*block-size, 16))")
    p.add_argument("--chunk-rows", type=int, default=2,
                   help="concurrent prefill streams per unified step")
    p.add_argument("--mixed-burst", type=int, default=4,
                   help="decode steps per chunk-carrying dispatch")
    p.add_argument("--mesh", default="")
    p.add_argument("--mp", type=int, default=0)
    p.add_argument("--requests", type=int, default=8)
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=32)
    p.add_argument("--gen", type=int, default=32)
    p.add_argument("--n", type=int, default=1)
    p.add_argument("--best-of", type=int, default=0)
    p.add_argument("--beam", type=int, default=0)
    p.add_argument("--session", action="store_true")
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--top-k", type=int, default=0)
    p.add_argument("--top-p", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=0,
                   help="weight-init and sampling seed")
    p.add_argument("--spec", default="")
    p.add_argument("--spec-k", type=int, default=4)
    p.add_argument("--spec-adaptive", action="store_true")
    p.add_argument("--block-size", type=int, default=16)
    p.add_argument("--num-blocks", type=int, default=0,
                   help="KV pool size in blocks (0 = slots * "
                        "ceil(max_len/block_size) + 1)")
    p.add_argument("--no-prefix-cache", action="store_true")
    p.add_argument("--kernel-mode", default="", choices=["auto", "pallas", "xla"],
                   help="auto/pallas = the CUDA kernels on the card, "
                        "xla = the plain torch path")
    p.add_argument("--kv-dtype", default="", choices=["fp16", "int8", "fp8"])
    p.add_argument("--overlap", default="", choices=["on", "off", "auto"])
    p.add_argument("--replicas", type=int, default=0)
    p.add_argument("--route", default="prefix",
                   choices=["prefix", "rr", "least-loaded"])
    p.add_argument("--disaggregate", action="store_true")
    p.add_argument("--trace", action="store_true")
    p.add_argument("--flush-every", type=int, default=0,
                   help="stream the trace to disk every N decode iterations")
    p.add_argument("--out", default="runs/serve")
    args = p.parse_args(argv)
    for flag, ported in _PORTED_VALUES.items():
        value = getattr(args, flag)
        if value not in ported:
            p.error(f"--{flag.replace('_', '-')}={value!r} is not ported to "
                    f"repro_torch yet (single-engine paths only)")
    if args.flush_every and not args.trace:
        p.error("--flush-every streams the trace and requires --trace")

    from repro_torch import core as xtrace
    from repro_torch.configs import all_arch_names, get_config, reduced
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import ContinuousServeEngine, ServeEngine
    from repro_torch.serve.step import UnifiedServeEngine

    if args.arch not in all_arch_names():
        p.error(f"unknown --arch {args.arch!r} (choose from "
                f"{', '.join(all_arch_names())})")
    cfg = reduced(get_config(args.arch))
    if cfg.family != "dense":
        p.error(f"--arch {args.arch} is family {cfg.family!r}; repro_torch "
                f"serves the dense family only")
    if args.kernel_mode:
        cfg = cfg.replace(kernel_mode=args.kernel_mode)
    model = build_model(cfg, device=args.device, seed=args.seed)
    out = pathlib.Path(args.out)
    slots = min(args.slots, args.requests)
    max_len = args.prompt_len + args.gen
    tracer = xtrace.init(f"serve-{args.arch}") if args.trace else None
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size,
                           (args.requests, args.prompt_len)).astype(np.int32)

    if args.mode == "static":
        engine = ServeEngine(cfg, model, device=args.device, max_len=max_len,
                             tracer=tracer)
        stats = engine.throughput_stats(prompts, num_tokens=args.gen,
                                        temperature=args.temperature,
                                        top_k=args.top_k, top_p=args.top_p,
                                        seed=args.seed)
    else:
        if args.flush_every:
            out.mkdir(parents=True, exist_ok=True)
        common = dict(
            device=args.device, num_slots=slots, max_len=max_len,
            block_size=args.block_size, num_blocks=args.num_blocks or None,
            prefix_cache=not args.no_prefix_cache, tracer=tracer,
            temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
            seed=args.seed, flush_every=args.flush_every,
            flush_base=out / "serve" if args.flush_every else None)
        if args.mode == "unified":
            engine = UnifiedServeEngine(
                cfg, model, max_step_tokens=args.max_step_tokens or None,
                chunk_size=args.chunk_size or None, chunk_rows=args.chunk_rows,
                mixed_burst=args.mixed_burst, **common)
        else:
            engine = ContinuousServeEngine(cfg, model, **common)
        # staggered prompt lengths exercise variable-length admission
        for i in range(args.requests):
            plen = max(1, args.prompt_len - (i % 4))
            engine.submit(prompts[i, :plen], args.gen)
        engine.run()
        stats = engine.throughput_stats()
    device = engine.device
    print(f"[serve] {args.arch} mode={args.mode} device={device}: "
          f"{stats['tokens']} tokens in {stats['seconds']:.2f}s = "
          f"{stats['tok_per_s']:.1f} tok/s (host syncs: {stats['host_syncs']})")
    if args.mode != "static":
        print(f"[serve] paged pool: {engine.num_blocks - 1} blocks x "
              f"{engine.block_size} tokens ({engine.kv_bytes_per_token} "
              f"B/token); peak {stats['peak_blocks']} in use, "
              f"{stats['prefix_hit_tokens']} prefix-hit tokens, "
              f"{stats['preemptions']} preemptions, "
              f"{stats['evictions']} cache evictions")
        counts = " ".join(f"{k}={v}" for k, v in sorted(
            stats["kernel_dispatch"].items())) or "none recorded"
        print(f"[serve] attention kernels (mode={cfg.kernel_mode}): {counts}")
    if args.mode == "unified":
        print(f"[serve] unified step: budget {engine.max_step_tokens} "
              f"tokens/iteration, chunk {engine.chunk_size}")
    if tracer:
        segments = list(tracer.segments)
        trace = xtrace.finish()
        out.mkdir(parents=True, exist_ok=True)
        paths = xtrace.write_prv(trace, out / "serve", segments=segments)
        seg_note = (f", merged {len(segments)} flushed segments" if segments
                    else "")
        print(f"[serve] trace: {paths['prv']}  ({trace.summary()}{seg_note})")
        # flushed events live in the segment files, not the in-memory
        # trace: summarize the MERGED .prv so every retired request counts
        lat = xtrace.serve_latency_summary(
            xtrace.parse_prv(paths["prv"]) if segments else trace)
        if lat["ttft_us"]["count"]:
            t, o = lat["ttft_us"], lat["tpot_us"]
            print(f"[serve] latency over {t['count']} requests: "
                  f"TTFT p50 {t['p50']:.0f}us / p95 {t['p95']:.0f}us / "
                  f"max {t['max']:.0f}us; TPOT p50 {o['p50']:.0f}us / "
                  f"p95 {o['p95']:.0f}us")
    return 0


if __name__ == "__main__":
    sys.exit(main())
