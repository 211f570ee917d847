"""Serving launcher — compress a model and serve a request trace.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
        --mode compressed --batch 8 --slots 3 --stagger 2 --max-new 16

Counterpart of ``repro/launch/serve.py`` on one device, with its flags,
defaults and printed summary.  Each of ``--batch`` prompts (from the
seeded ``train.data.DataPipeline``) is submitted as a ``serve.Request``,
``--stagger`` engine steps apart, to the continuous-batching
``serve.Engine`` over a paged KV pool of ``--slots`` decode slots;
requests join and leave the running decode loop per tick.  Overload knobs:
``--max-queue`` bounds the admission queue (overflow sheds per
``--shed-policy``) and ``--request-ttl`` expires requests that wait or run
too long; overload always surfaces as accounted-for completions.  With
compression on, the engine comes from ``ResilientEngine.scheduler()``:
every prefill and decode step walks the retry/degradation ladder, and the
health snapshot is printed.

``--tiles N`` stores every compressed weight but the expert stacks as N
column groups (``TiledPackedLinear``), which the fused kernel reads in one
launch (the dispatch summary shows ``tiled_fused``).  ``--verify`` gates
serving on the artifact's integrity.  ``--residency tiered`` backs a
compressed MoE model's expert planes in host memory under a device cache of
``--expert-cache-mib`` (0: sized from ``--hbm-budget-mib``).
``--pressure-trace`` replays a seeded budget trace against a
``serve.governor.MemoryGovernor`` attached to the engine.

It runs on the CUDA card unless ``--device cpu`` is given (the kernels'
plain versions).  Weights are the port's ``init_lm(cfg, seed=0)`` of the
arch's smoke config, as in the reference, unless the caller of
:func:`main` passes ``params``.

``--mesh DATA,MODEL`` serves on a mesh of DATA × MODEL ranks
(``launch.mesh``): the weights are packed with ``model_shards = MODEL``,
each rank keeps its share of them (``sharding.partition.place_params``;
the LUT and the other leaves replicated), every rank runs the same
engine, eagerly, and rank 0 prints the summary with ``mesh: {...}``.
Under ``torchrun`` (``RANK``/``WORLD_SIZE`` set) the ranks are the ones
it started, and a mesh of more ranks than that is refused; otherwise the
launcher starts the ranks itself (``launch.mesh.spawn``), over gloo,
all on one card where there is only one.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import math
import os
import sys
import time

import torch
import torch.distributed as dist

from .._device import resolve_device
from ..configs import get_config
from ..core.policy import CompressionPolicy, device_budget
from ..kernels import ops
from ..models import lm as LM
from ..serve.context import ServeContext
from ..serve.engine import _map_leaves, _tensors, build_serve_params
from ..serve.kv_cache import PagedKVPool
from ..serve.resilience import ResiliencePolicy, ResilientEngine
from ..serve.scheduler import Engine, Request
from ..train.data import DataConfig, DataPipeline
from . import mesh as M


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--mode", default="compressed",
                    choices=["dense", "quant", "compressed"])
    ap.add_argument("--batch", type=int, default=4,
                    help="number of requests in the trace")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=3,
                    help="decode slots in the paged-KV pool (requests "
                         "beyond this queue and join as slots free)")
    ap.add_argument("--page-size", type=int, default=8,
                    help="tokens per KV page")
    ap.add_argument("--stagger", type=int, default=2,
                    help="engine steps between request arrivals "
                         "(0 = all at once)")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="bound the admission queue: overflow sheds a "
                         "request per --shed-policy as a "
                         "Completion(finished='shed') (default: unbounded)")
    ap.add_argument("--shed-policy", default="reject-new",
                    choices=["reject-new", "drop-oldest"],
                    help="who sheds when the bounded queue overflows")
    ap.add_argument("--request-ttl", type=int, default=None,
                    help="engine-wide TTL in engine steps from submit; "
                         "expired requests complete with "
                         "finished='deadline' (default: no TTL)")
    ap.add_argument("--mesh", default=None,
                    help="DATA,MODEL mesh shape: serve on DATA x MODEL "
                         "ranks (started here, or by torchrun)")
    ap.add_argument("--tiles", type=int, default=0,
                    help="column groups for compressed weights "
                         "(TiledPackedLinear; 0 = plain PackedLinear)")
    ap.add_argument("--verify", default="off",
                    choices=["off", "fast", "full"],
                    help="integrity gate before serving: re-hash the "
                         "packed artifact against its manifest (fast = "
                         "sampled digests, full = every byte) plus the "
                         "device-side invariant check; corrupt leaves "
                         "refuse to serve (core/integrity.py)")
    ap.add_argument("--residency", default="hbm",
                    choices=["hbm", "tiered"],
                    help="expert residency: 'hbm' keeps every compressed "
                         "expert on the device; 'tiered' backs them in host "
                         "memory with a routing-aware device cache "
                         "(serve/residency.py; compressed MoE only)")
    ap.add_argument("--expert-cache-mib", type=int, default=0,
                    help="device expert-cache size for --residency tiered "
                         "(0 = auto from --hbm-budget-mib via "
                         "core.policy.device_budget)")
    ap.add_argument("--hbm-budget-mib", type=int, default=4096,
                    help="device memory budget used to auto-size the "
                         "expert cache (paper target: 4-8 GB edge)")
    ap.add_argument("--pressure-trace", default="none",
                    choices=["none", "step", "spike", "ramp", "oscillate"],
                    help="replay a seeded runtime memory-pressure trace "
                         "against the serving engine: the budget moves "
                         "per step and serve.governor.MemoryGovernor "
                         "walks the reclaim/regrow ladder "
                         "(testing.faults.pressure_trace; seeded via "
                         "REPRO_FAULT_SEED)")
    ap.add_argument("--pressure-low-mib", type=int, default=0,
                    help="the trace's low watermark (0 = auto: 60%% of "
                         "--hbm-budget-mib)")
    ap.add_argument("--min-budget-mib", type=int, default=0,
                    help="operator floor for the governor: below this it "
                         "refuses new work (finished='pressure') instead "
                         "of reclaiming further (0 = the computed "
                         "min_viable floor only)")
    ap.add_argument("--device", default=None,
                    help="where to serve: the CUDA card by default; 'cpu' "
                         "runs the kernels' plain versions")
    return ap


def _tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def main(argv=None, *, params=None) -> dict:
    """Run the launcher on ``argv`` (default: the command line).
    ``params``: dense weights of the arch's smoke config to serve instead
    of ``init_lm(cfg, seed=0)``.  Prints the summary; → a dict of what it
    printed (completions, dispatch counts, health, ...)."""
    ap = _parser()
    args = ap.parse_args(argv)
    mesh = None
    if args.mesh:
        shape = _parse_mesh(ap, args.mesh)
        need = math.prod(shape)
        if not dist.is_initialized() and "RANK" not in os.environ:
            # no ranks yet: start them, each running this launcher
            if params is not None:
                params = _map_leaves(params, lambda t: t.cpu())
            return M.spawn(_rank_main, need,
                           list(sys.argv[1:] if argv is None else argv),
                           params, device=args.device or "cuda")[0]
        have = M.world_size()
        if need > have:
            ap.error(f"--mesh {args.mesh} needs {need} devices, have {have} "
                     f"(start {need} ranks)")
        M.init_from_env(args.device or "cuda")
        mesh = M.make_mesh(shape, (M.AXIS_DATA, M.AXIS_MODEL))
        if mesh is None:          # a rank past the mesh serves nothing
            return {}
    device = resolve_device(args.device)
    quiet = (contextlib.redirect_stdout(io.StringIO())
             if mesh is not None and mesh.rank else contextlib.nullcontext())
    with quiet:
        return _serve(args, ap, device, mesh, params)


def _rank_main(rank: int, argv: list, params):
    """One rank of ``--mesh`` (``launch.mesh.spawn``)."""
    return main(argv, params=params)


def _parse_mesh(ap, spec: str) -> tuple:
    """'2,4' -> (2, 4): (data, model)."""
    try:
        shape = tuple(int(s) for s in spec.split(","))
    except ValueError:
        shape = ()
    if len(shape) != 2 or min(shape) < 1:
        ap.error(f"--mesh wants DATA,MODEL, got {spec!r}")
    return shape


def _serve(args, ap, device, mesh, params) -> dict:
    """The launcher's body on ``device`` (and ``mesh``, this rank's)."""
    model_shards = mesh.shape[M.AXIS_MODEL] if mesh is not None else 1

    cfg = get_config(args.arch).smoke
    if params is None:
        params = LM.init_lm(cfg, seed=0, device=device)
    data = DataPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                   batch=args.batch,
                                   seq_len=args.prompt_len))
    if args.mode == "dense":
        st, lut = None, None
        sp = _map_leaves(params, lambda t: t.to(device))
    else:
        st = build_serve_params(
            params, CompressionPolicy(mode=args.mode, min_weight_size=1024,
                                      tiles=args.tiles),
            model_shards=model_shards, device=device)
        sp, lut = st.params, st.lut
        print(f"{args.mode} weights: {sum(st.stats.values())/2**20:.2f} MiB")
    if mesh is not None:
        # each rank keeps its share of the packed state (ResilientEngine
        # places it after the integrity gate); the LUT and the other
        # leaves replicate
        if args.residency == "tiered":
            ap.error("--residency tiered is single-device: run it without "
                     "--mesh")
        print(f"mesh: {dict(mesh.shape)}")

    max_len = args.prompt_len + args.max_new

    def _device_budget(expert_bytes: int):
        resident_bytes = _tree_bytes(sp) - expert_bytes + \
            (_tree_bytes(lut) if lut is not None else 0)
        probe_pool = PagedKVPool(cfg, args.slots, max_len,
                                 page_size=args.page_size, device=device)
        kv_bytes = probe_pool.device_bytes()
        del probe_pool
        return device_budget(args.hbm_budget_mib * 2**20,
                             expert_bytes=expert_bytes,
                             resident_bytes=resident_bytes,
                             kv_bytes=kv_bytes,
                             act_bytes=64 * 2**20)

    budget = None
    residency = None
    if args.residency == "tiered":
        from ..serve.residency import ResidencyManager
        if args.mode != "compressed":
            ap.error("--residency tiered requires --mode compressed")
        budget = _device_budget(_tree_bytes(
            [b["moe"]["experts"] for b in sp["blocks"]]))
        cache_bytes = (args.expert_cache_mib * 2**20
                       if args.expert_cache_mib > 0
                       else budget.expert_cache_bytes)
        residency = ResidencyManager(st, cfg, cache_bytes=cache_bytes)
        # the summary names an overshoot when the granted budget was too
        # small and the cache clamped to its one-expert-per-layer floor
        used = (residency.capacity * residency.n_layers
                * residency.bytes_per_expert)
        print(budget.summary(expert_cache_used=used))
        print(f"expert cache: {residency.capacity}/{residency.n_experts} "
              f"experts/layer x {residency.n_layers} layers "
              f"({used / 2**20:.2f} MiB of "
              f"{cache_bytes / 2**20:.2f} MiB granted)")

    governor = None
    if args.pressure_trace != "none":
        from ..serve.governor import MemoryGovernor
        from ..testing.faults import pressure_trace
        if budget is None:
            budget = _device_budget(0)
        low = (args.pressure_low_mib * 2**20 if args.pressure_low_mib > 0
               else int(0.6 * args.hbm_budget_mib * 2**20))
        trace = pressure_trace(args.pressure_trace,
                               boot_bytes=budget.budget_bytes,
                               low_bytes=low, n_steps=64)
        polled = {"i": 0}

        def poll():
            i = min(polled["i"], len(trace) - 1)
            polled["i"] += 1
            return trace[i]

        governor = MemoryGovernor(
            budget, poll=poll,
            min_budget_bytes=(args.min_budget_mib * 2**20
                              if args.min_budget_mib > 0 else None))
        print(f"pressure trace: {args.pressure_trace} "
              f"({budget.budget_bytes / 2**20:.0f} -> {low / 2**20:.0f} MiB "
              f"low watermark over {len(trace)} steps)")
    engine_kw = dict(n_slots=args.slots, max_len=max_len,
                     page_size=args.page_size, max_queue=args.max_queue,
                     shed_policy=args.shed_policy,
                     request_ttl=args.request_ttl, governor=governor)
    if st is not None:
        # the integrity gate (manifest re-hash + device invariants) runs at
        # construction when --verify is on; corrupt leaves raise
        # IntegrityError naming themselves instead of serving garbage
        rengine = ResilientEngine(
            cfg, st, policy=ResiliencePolicy(verify=args.verify),
            device=device, residency=residency, mesh=mesh)
        if args.verify != "off":
            print(rengine.verify_report.summary())
            print(rengine.invariant_report.summary())
        eng = rengine.scheduler(**engine_kw)
    else:
        rengine = None
        eng = Engine(ServeContext(cfg=cfg, lut=lut, device=device,
                                  mesh=mesh), sp, **engine_kw)

    toks = data.batch_at(0)["tokens"].numpy()
    arrivals = [i * args.stagger for i in range(args.batch)]
    ops.DISPATCH_COUNTS.clear()

    try:
        t = time.perf_counter()
        submitted = 0
        while submitted < args.batch or eng.health()["occupied"] \
                or eng.health()["queued"]:
            while submitted < args.batch and eng.steps >= arrivals[submitted]:
                eng.submit(Request(tokens=toks[submitted],
                                   max_new=args.max_new, rid=submitted))
                submitted += 1
            eng.step()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t

        h = eng.health()
        n_tok = sum(c.n_generated for c in eng.completions)
        print(f"served {h['completed']} requests / {n_tok} tokens in "
              f"{1e3*dt:.1f} ms ({n_tok/dt:.1f} tok/s) over {h['steps']} "
              "steps")
        print(f"occupancy: mean {h['occupancy_mean']:.2f} "
              f"max {h['occupancy_max']} of {args.slots} slots; "
              f"joined mid-decode: {h['joined_mid_decode']}")
        print(f"overload: queue_peak {h['queue_peak']} shed {h['shed']} "
              f"expired {h['expired']} preempted {h['preempted']} "
              f"quarantined {h['quarantined']} resumed {h['resumed']}")
        reasons = {}
        for c in eng.completions:
            reasons[c.finished] = reasons.get(c.finished, 0) + 1
        print("completions by reason:", reasons)
        dispatch = dict(ops.DISPATCH_COUNTS)
        if args.mode == "compressed":
            print("matmul dispatch:", dispatch)
        health = rengine.health() if rengine is not None else None
        if health is not None:
            print("health:", health)
        res = None
        if rengine is not None and rengine.residency is not None:
            res = rengine.residency.snapshot()
            print(f"residency: hits {res['hit']} (+{res['prefetch_hit']} "
                  f"prefetch) misses {res['miss']} evictions {res['evict']} "
                  f"fetched {res['bytes_fetched']/2**20:.2f} MiB "
                  f"hit_rate {res['hit_rate']} prefetch_hit_rate "
                  f"{res['prefetch_hit_rate']} stall {res['stall_s']:.3f}s")
        pressure = None
        if governor is not None:
            pressure = governor.snapshot()
            print(f"pressure: plan_changes {pressure['plan_changes']} "
                  f"refusing {pressure['refusing']} plan {pressure['plan']} "
                  f"rung_latency_s {pressure['rung_latency_s']}")
        by_rid = {c.rid: c for c in eng.completions}
        sample = [int(v) for v in by_rid[0].tokens[args.prompt_len:]]
        print("sample:", sample)
    finally:
        eng.close()        # stop the residency prefetch worker
    return {"completions": list(eng.completions), "reasons": reasons,
            "dispatch": dispatch, "health": health, "engine": h,
            "residency": res, "pressure": pressure, "sample": sample,
            "seconds": dt, "tokens": n_tok,
            "mesh": dict(mesh.shape) if mesh is not None else None}


if __name__ == "__main__":
    main()
