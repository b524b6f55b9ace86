"""Serving launcher CLI of the torch port.

    PYTHONPATH=src python -m repro_torch.launch.serve --device cuda
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --requests 4

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --mode continuous --trace --flush-every 4 --out runs/serve

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --arch mamba2-370m --requests 4 --slots 2 --prompt-len 12 --gen 4

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --spec ngram --spec-k 4 --spec-adaptive

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --arch deepseek-moe-16b --n 3 --temperature 0.8

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --beam 4 --requests 2 --gen 6

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --arch recurrentgemma-9b --mode continuous

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --arch internvl2-2b --mode static

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
or, explicitly, the CPU.  ``--kv-dtype int8|fp8`` quantizes the paged
pool of the unified and continuous modes (the pool line prints its
storage and bytes per token); ``--mode static`` keeps contiguous caches
in the model dtype, as the JAX CLI does.  ``--arch`` takes the dense
family, the moe family (deepseek-moe-16b, mixtral-8x22b: the same
attention kernels with a plain-torch expert FFN) and mamba2-370m (ssm),
which every mode serves: whole-prompt admission through the SSD scan
kernel, no pool and no prefix cache (the unified-step line says so and no
pool line is printed).  It takes recurrentgemma-9b (hybrid: RG-LRU layers
with slot-indexed state beside local-attention layers on the pool) and
internvl2-2b (vlm: each request carries seeded patch embeddings,
``default_rng(1)`` as in the JAX CLI, that prefill before its tokens and
shift its positions), both admitted whole in every mode, with no prefix
cache.  ``--spec
ngram|draft:<arch>`` turns on the speculative lane of ``--mode unified``
(``--spec-k`` drafts a slot, ``--spec-adaptive`` walks K with the
acceptance rate; a ``draft:`` model is the one-layer reduced ``<arch>``
with random weights from ``--seed + 1``, on ``--device``) and prints the
draft economy, read again from the trace under ``--trace``.  The unified
mode's fork path takes ``--n N`` (each prompt prefills once and forks
into N CoW decode streams; ``--best-of N`` is sugar for it), ``--beam W``
(beam search of each prompt, one at a time) and ``--session`` (each
prompt as a two-turn conversation whose turn 2 must hit the pinned
turn-1 context), with the JAX CLI's exclusions.  Flags of paths not
ported yet (meshes, replicas, the two-deep overlap pipeline) stop with
an error naming the flag.
"""
from __future__ import annotations

import argparse
import pathlib
import sys

import numpy as np

# flag -> the values the ported paths serve; any other value selects a
# path that is not ported yet
_PORTED_VALUES = {
    "mesh": ("",), "mp": (0,),
    "overlap": ("", "off", "auto"), "replicas": (0,), "disaggregate": (False,),
}


def _request_extras(cfg, rng, n):
    """Per-request prefill inputs beside the tokens: a vlm's patch
    embeddings [n, num_patches, vision_dim] (the JAX CLI's draws)."""
    extras = {}
    if cfg.family == "vlm":
        extras["patch_embeds"] = rng.standard_normal(
            (n, cfg.num_patches, cfg.vision_dim)).astype(np.float32)
    return extras


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
    p.add_argument("--n", type=int, default=1,
                   help="samples per prompt: one prefill, then n CoW decode "
                        "streams aliasing the prompt blocks (unified mode)")
    p.add_argument("--best-of", type=int, default=0,
                   help="candidate count: sugar for --n N (ranking the "
                        "candidates is the caller's job)")
    p.add_argument("--beam", type=int, default=0,
                   help="beam search width: fork-based beams on the CoW "
                        "pool, summed log-prob ranking (unified mode, "
                        "prompts one at a time)")
    p.add_argument("--session", action="store_true",
                   help="serve each prompt as a 2-turn conversation: turn 2 "
                        "re-submits the turn-1 context + 8 fresh tokens and "
                        "must hit the pinned blocks (unified mode)")
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
    if args.spec and args.mode != "unified":
        p.error("--spec is a unified-engine lane (--mode unified)")
    if args.best_of:
        if args.n > 1 and args.n != args.best_of:
            p.error("--best-of implies --n; pick one")
        args.n = args.best_of
    if (args.n > 1 or args.beam or args.session) and args.mode != "unified":
        p.error("--n/--best-of/--beam/--session ride the unified engine's "
                "CoW fork path (--mode unified)")
    if args.beam and (args.n > 1 or args.session):
        p.error("--beam is a standalone search (no --n/--session)")
    if args.session and args.n > 1:
        p.error("--session persists ONE stream; fan-out is per-request "
                "(--n) — they are mutually exclusive")

    from repro_torch import core as xtrace
    from repro_torch.configs import all_arch_names, get_config, reduced
    from repro_torch.models.params import FAMILIES
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import ContinuousServeEngine, ServeEngine
    from repro_torch.serve.spec import make_proposer
    from repro_torch.serve.step import UnifiedServeEngine

    if args.arch not in all_arch_names():
        p.error(f"unknown --arch {args.arch!r} (choose from "
                f"{', '.join(all_arch_names())})")
    cfg = reduced(get_config(args.arch))
    if cfg.family not in FAMILIES:
        p.error(f"--arch {args.arch} is family {cfg.family!r}; repro_torch "
                f"serves the {', '.join(FAMILIES)} families only")
    if args.kernel_mode:
        cfg = cfg.replace(kernel_mode=args.kernel_mode)
    if args.kv_dtype:
        cfg = cfg.replace(kv_dtype=args.kv_dtype)
    model = build_model(cfg, device=args.device, seed=args.seed)
    out = pathlib.Path(args.out)
    slots = min(args.slots, args.requests)
    if args.beam:
        slots = max(slots, args.beam)  # beams borrow the slot rows
    max_len = args.prompt_len + cfg.num_patches + args.gen
    if args.session:  # turn 2 = turn-1 context + 8 follow-up + gen more
        max_len += args.gen + 8
    tracer = xtrace.init(f"serve-{args.arch}") if args.trace else None
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size,
                           (args.requests, args.prompt_len)).astype(np.int32)
    extras = _request_extras(cfg, np.random.default_rng(1), args.requests)

    if args.mode == "static":
        engine = ServeEngine(cfg, model, device=args.device, max_len=max_len,
                             tracer=tracer)
        stats = engine.throughput_stats(prompts, num_tokens=args.gen,
                                        extras=extras,
                                        temperature=args.temperature,
                                        top_k=args.top_k, top_p=args.top_p,
                                        seed=args.seed)
    else:
        if args.flush_every:
            out.mkdir(parents=True, exist_ok=True)
        num_blocks = args.num_blocks or None
        if args.session and num_blocks is None:
            # each conversation's context stays pinned in the pool between
            # turns: room for one per request beside the slots' own blocks
            # (the JAX CLI keeps the slots-only default, which the pins
            # fill at its default flags until its loop stalls)
            num_blocks = ((slots + args.requests)
                          * -(-max_len // args.block_size) + 1)
        common = dict(
            device=args.device, num_slots=slots, max_len=max_len,
            block_size=args.block_size, num_blocks=num_blocks,
            prefix_cache=not args.no_prefix_cache, tracer=tracer,
            temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
            seed=args.seed, flush_every=args.flush_every,
            flush_base=out / "serve" if args.flush_every else None)
        if args.mode == "unified":
            spec = {}
            if args.spec:
                spec = dict(spec=make_proposer(
                    args.spec, cfg, num_slots=slots, max_len=max_len,
                    temperature=args.temperature, top_k=args.top_k,
                    top_p=args.top_p, seed=args.seed, device=args.device),
                    spec_k=args.spec_k, spec_adaptive=args.spec_adaptive)
            engine = UnifiedServeEngine(
                cfg, model, max_step_tokens=args.max_step_tokens or None,
                chunk_size=args.chunk_size or None, chunk_rows=args.chunk_rows,
                mixed_burst=args.mixed_burst, **spec, **common)
        else:
            engine = ContinuousServeEngine(cfg, model, **common)
        if args.beam:
            # standalone model-scored search: one prompt at a time on the
            # idle engine (beams borrow the slot rows)
            for i in range(args.requests):
                plen = max(1, args.prompt_len - (i % 4))
                beams = engine.beam_search(prompts[i, :plen], args.gen,
                                           width=args.beam)
                print(f"[serve] beam prompt {i}: width {args.beam}, best "
                      f"sum-log-prob {beams[0][1]:.3f} "
                      f"(worst kept {beams[-1][1]:.3f})")
        elif args.session:
            # 2-turn conversations: turn 2 extends turn 1's full context
            # and must serve it from the session's pinned blocks
            t1 = []
            for i in range(args.requests):
                plen = max(1, args.prompt_len - (i % 4))
                t1.append(engine.submit(prompts[i, :plen], args.gen,
                                        session=f"s{i}"))
            out1 = engine.run()
            t2 = []
            for i, r in enumerate(t1):
                follow = rng.integers(0, cfg.vocab_size, (8,)).astype(np.int32)
                ctx = np.concatenate([r.prompt, out1[r.rid], follow])
                t2.append(engine.submit(ctx, args.gen, session=f"s{i}"))
            engine.run()
            hit = sum(r.prefix_hit_tokens for r in t2)
            need = sum(r.prompt_len for r in t2)
            print(f"[serve] sessions: {len(t2)} turn-2 requests, "
                  f"{hit}/{need} prompt tokens served from pinned context")
            for i in range(args.requests):
                engine.close_session(f"s{i}")
        else:
            # staggered prompt lengths exercise variable-length admission
            for i in range(args.requests):
                plen = max(1, args.prompt_len - (i % 4))
                ex = {k: v[i] for k, v in extras.items()}
                engine.submit(prompts[i, :plen], args.gen, extras=ex,
                              n_samples=args.n)
            engine.run()
        stats = engine.throughput_stats()
    device = engine.device
    print(f"[serve] {args.arch} mode={args.mode} device={device}: "
          f"{stats['tokens']} tokens in {stats['seconds']:.2f}s = "
          f"{stats['tok_per_s']:.1f} tok/s (host syncs: {stats['host_syncs']})")
    if args.mode != "static" and engine.pool is not None:
        storage = str(engine.kv_storage).removeprefix("torch.")
        print(f"[serve] paged pool: {engine.num_blocks - 1} blocks x "
              f"{engine.block_size} tokens ({engine.pool.kv_dtype} storage, "
              f"{storage} K/V, {engine.kv_bytes_per_token} B/token); "
              f"peak {stats['peak_blocks']} in use, "
              f"{stats['prefix_hit_tokens']} prefix-hit tokens, "
              f"{stats['preemptions']} preemptions, "
              f"{stats['evictions']} cache evictions")
        counts = " ".join(f"{k}={v}" for k, v in sorted(
            stats["kernel_dispatch"].items())) or "none recorded"
        print(f"[serve] attention kernels (mode={cfg.kernel_mode}): {counts}")
        if stats.get("forks", 0):
            print(f"[serve] CoW forking: {stats['forks']} forks, "
                  f"{stats['cow_copies']} block copies, peak "
                  f"{stats['peak_shared']} blocks shared "
                  f"(n={args.beam or args.n} per prompt)")
    if args.mode == "unified":
        why = ("patch embeddings" if cfg.family == "vlm"
               else "state-carrying family")
        note = ("on" if engine.chunkable
                else f"off — {why}, whole-prompt admission")
        print(f"[serve] unified step: budget {engine.max_step_tokens} "
              f"tokens/iteration, chunk {engine.chunk_size} "
              f"(chunked prefill {note})")
        if args.spec:
            st = engine.stats
            drafted = max(st["spec_drafted"], 1)
            print(f"[serve] speculative ({args.spec}): "
                  f"{st['spec_dispatches']} verify dispatches, "
                  f"{st['spec_accepted']}/{st['spec_drafted']} drafts "
                  f"accepted ({st['spec_accepted'] / drafted:.0%}), "
                  f"{st['spec_rollback_blocks']} blocks rolled back, "
                  f"K={engine._spec_k}")
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
        if lat["spec"]["dispatches"]:
            sp = lat["spec"]
            print(f"[serve] spec (from trace): {sp['accepted']}/"
                  f"{sp['drafted']} drafts accepted "
                  f"({sp['acceptance']:.0%}) over {sp['dispatches']} "
                  f"verify dispatches")
        if lat["forks"]["count"]:
            fk = lat["forks"]
            print(f"[serve] forks (from trace): {fk['count']} children off "
                  f"{fk['parents']} parents, peak "
                  f"{fk['peak_shared_blocks']} blocks shared")
    return 0


if __name__ == "__main__":
    sys.exit(main())
