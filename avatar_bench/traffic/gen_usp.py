"""Long-video generation under Ulysses sequence parallelism: the gen kind's
request and checks (`traffic/gen.py`) on one process per card, as the
inference CLI runs `--ulysses_degree W --ring_degree R` on W x R
processes (`cli/inference.py:build_mesh`: sp = W x R, no fsdp).

Rank 0 is this process; `run` spawns ranks 1 .. W-1 (start method
"spawn"), each on its own card.  Every rank starts the process group
through the port's `parallel/distributed.py:initialize_distributed` over a
free local port, builds the mesh with `build_mesh`, draws the same weights
and inputs from the seed on its card and runs `pipelines/long.py:
generate_long` under `mesh_context`: the whole DiT on every card, a
1/(W R) slice of each window's tokens, the Ulysses all-to-alls around
self-attention and the gather of the token slices before the head.

Timing: rank 0 decides after each sweep whether the window has closed and
the other ranks learn it from one broadcast of one number, issued between
sweeps (in the step callback, outside the DiT).  `window_step_s` is rank
0's window wall over the window-steps completed; `setup_s` runs from the
harness's start to rank 0's window start (one host clock);
`peak_mem_gib` is the largest of the cards' `max_memory_allocated`.

What is judged is the gen kind's four numbers (`gen.judge`) on rank 0's
state: the conditioning, the DiT outputs and the latents, which every rank
holds whole, and block k's branches, whose inputs and outputs each rank
holds for its own tokens: they are gathered to rank 0 and put together in
rank order.  With a traced run every rank traces its first window sweep;
rank 0's trace feeds the breakdown, the result line's `busy_s` and the gen
kind's readers, which see rank 0's share of the DiT's calls
(`roofline_usp.rank_calls`), every rank's kernels the readers of the
exchanges and of the ranks' balance (`roofline_usp.py`).

No run hangs: a worker that ends with an error, or a run that makes no
progress for `STALL_S`, ends every rank, and this process exits with
code 3 and no result; workers die with this process (the parent's
death signal) and are joined with a limit.  `run_jobs` runs several
seeds, variants and faults in one set-up of the processes
(`readings.py`); a fault (`faults_usp.py`) is planted in every rank.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import random
import socket
import sys
import threading
import time
from typing import Callable, List, Optional

from avatar_bench import core, roofline, roofline_usp, weights
from avatar_bench.traffic import gen

# seconds without progress on rank 0 while a worker lives before the run is ended
STALL_S = 300.0
# seconds a worker has to end after rank 0's last collective
JOIN_S = 60.0


@dataclasses.dataclass(frozen=True)
class Job:
    """One run on the ranks' shared set-up: a seed, a window, a variant
    ("program" or "control", as in `gen.run`) and a fault of
    `faults_usp.USP` (None: none)."""

    seed: int
    seconds: float
    trace: bool = False
    variant: str = "program"
    fault: Optional[str] = None


def world_size(tr: dict) -> int:
    return int(tr["ulysses_degree"]) * int(tr["ring_degree"])


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class _Watch(threading.Thread):
    """Ends the run when a worker fails or rank 0 stops making progress."""

    def __init__(self, procs):
        super().__init__(daemon=True)
        self.procs = procs
        self.last = time.monotonic()
        self.done = threading.Event()

    def progress(self):
        self.last = time.monotonic()

    def run(self):
        while not self.done.wait(1.0):
            failed = [p.exitcode for p in self.procs if p.exitcode not in (None, 0)]
            stalled = (time.monotonic() - self.last > STALL_S
                       and any(p.is_alive() for p in self.procs))
            if not failed and not stalled:
                continue
            why = (f"a worker ended with exit code {failed[0]}" if failed
                   else f"no progress for {STALL_S:.0f} s")
            print(f"avatar_bench gen_usp: {why}; ending every rank", file=sys.stderr, flush=True)
            _end(self.procs, 0.0)
            # rank 0 may be waiting in a collective or a rendezvous that will never end
            os._exit(3)


def _end(procs, limit: float):
    """Join the workers within `limit` seconds, kill what is left, and end
    the resource tracker that spawning them started, which would otherwise
    outlive this process."""
    from multiprocessing import resource_tracker

    deadline = time.monotonic() + limit
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10.0)
    resource_tracker._resource_tracker._stop()


def run(cell, seed: int, seconds: float, trace: bool, t0: float, device="cuda",
        variant: str = "program") -> core.Outcome:
    """One run of the cell (the harness's call)."""
    return run_jobs(cell, [Job(seed, seconds, trace, variant)], t0, device)[0]


def run_jobs(cell, jobs: List[Job], t0: float, device="cuda",
             on_outcome: Optional[Callable] = None) -> List[core.Outcome]:
    """Run `jobs` in turn on W x R ranks, rank 0 here; rank 0's outcome of
    each, also handed to `on_outcome(job, outcome)` as it comes."""
    import multiprocessing

    world = world_size(cell.traffic)
    port = _free_port()
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_worker, args=(r, world, port, cell, jobs, device, os.getpid()))
             for r in range(1, world)]
    for p in procs:
        p.start()
    watch = _Watch(procs)
    watch.start()
    try:
        outs = _rank(0, world, port, cell, jobs, device, t0, watch.progress, on_outcome)
    except BaseException:
        watch.done.set()
        _end(procs, 0.0)
        _leave_group(device)
        raise
    watch.done.set()
    _end(procs, JOIN_S)
    return outs


def _leave_group(device):
    """After a failure on the CPU, end this process's gloo group (its peers
    are gone), so that the next run can start one.  On the card the process
    is ending: a collective in flight could hold the NCCL group."""
    import torch.distributed as dist

    if device == "cpu" and dist.is_initialized():
        dist.destroy_process_group()


def _die_with_parent(parent: int):
    """Have the kernel kill this process when the process that spawned it
    ends (prctl PR_SET_PDEATHSIG), so that no rank outlives rank 0."""
    import ctypes
    import signal

    try:
        ctypes.CDLL("libc.so.6", use_errno=True).prctl(1, signal.SIGKILL)
    except (OSError, AttributeError):
        pass
    if os.getppid() != parent:
        os._exit(3)


def _worker(rank, world, port, cell, jobs, device, parent):
    _die_with_parent(parent)
    import torch

    torch.set_num_threads(max(1, (os.cpu_count() or world) // world))
    _rank(rank, world, port, cell, jobs, device, None, lambda: None, None)


def _rank(rank, world, port, cell, jobs, device, t0, progress, on_outcome):
    """Rank `rank`'s part of every job; rank 0 returns the outcomes."""
    import torch.distributed as dist

    from stableavatar_tpu_torch.cli.inference import build_mesh
    from stableavatar_tpu_torch.parallel.distributed import initialize_distributed

    os.environ["LOCAL_RANK"] = str(rank)  # the card initialize_distributed takes
    tr = cell.traffic
    initialize_distributed(f"localhost:{port}", world, rank, device=device)
    mesh = build_mesh(argparse.Namespace(ulysses_degree=int(tr["ulysses_degree"]),
                                         ring_degree=int(tr["ring_degree"]), fsdp_dit=False),
                      device)
    progress()
    outs = []
    for job in jobs:
        start = time.monotonic() if t0 is None or outs else t0
        out = _job(rank, world, mesh, cell, job, device, start, progress)
        if rank == 0:
            outs.append(out)
            if on_outcome is not None:
                on_outcome(job, out)
        _release(device)
        progress()
    dist.destroy_process_group()
    return outs


def _release(device):
    """Free what the program held: the window's end leaves it in a reference
    cycle (the closing exception's traceback holds `generate_long`'s frame),
    which only the collector frees."""
    import gc

    import torch

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def _job(rank, world, mesh, cell, job: Job, device, t0, progress) -> Optional[core.Outcome]:
    import torch
    import torch.distributed as dist

    from stableavatar_tpu_torch.models import dit as dit_mod
    from stableavatar_tpu_torch.parallel.mesh import mesh_context
    from stableavatar_tpu_torch.parallel.sharding import shard_params
    from stableavatar_tpu_torch.pipelines import long as long_mod
    from stableavatar_tpu_torch.pipelines.common import WanModels
    from stableavatar_tpu_torch.utils.profiling import StepTimer

    from avatar_bench import faults_usp
    from avatar_bench.trace import Tracer

    if job.variant not in ("program", "control"):
        raise ValueError(f"unknown variant {job.variant!r}")
    tr, c = cell.traffic, cell.config
    on_card = torch.device(device).type == "cuda"
    dev = torch.device("cuda", torch.cuda.current_device()) if on_card else torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = job.variant == "control"
    torch.backends.cudnn.allow_tf32 = job.variant == "control"
    g = torch.Generator(device=dev)
    g.manual_seed(job.seed)
    dtypes = c["dtypes"]
    dit, vae, clip, w2v = weights.draw(
        [weights.spec_dit(c["dit"]), weights.spec_vae(c["vae"]), weights.spec_clip(c["clip"]),
         weights.spec_wav2vec(c["wav2vec"])], g, dev,
        [getattr(torch, dtypes[k]) for k in ("dit", "vae", "clip", "wav2vec")])
    image, audio, text_ctx = gen.make_inputs(tr, c, g, dev)
    dit_cfg, vae_cfg, clip_cfg, w2v_cfg = gen.program_configs(c)
    prog_dit, fast = dit, {}
    if job.variant == "control":
        from stableavatar_tpu_torch.utils.fastpath import prepare_fast_params

        prog_dit = prepare_fast_params(dit, dit_cfg, quant=True)
        fast = dict(rope_split=True, attn_quant="qk")
    attn_impl = "ring" if int(tr["ring_degree"]) > 1 else "ulysses"
    # as the CLI does under a mesh (with no fsdp axis every leaf stays whole)
    models = WanModels(dit_params=shard_params(prog_dit, mesh), dit_cfg=dit_cfg,
                       vae_params=vae, vae_cfg=vae_cfg, clip_params=clip, clip_cfg=clip_cfg,
                       wav2vec_params=w2v, wav2vec_cfg=w2v_cfg, attn_impl=attn_impl, device=dev,
                       **fast)

    windows, slices, frames, lh, lw = gen.plan(tr, c)
    n_win = len(windows)
    rng = random.Random(job.seed)
    lo, hi = tr["check_sweeps"]
    sample = {"sweep": rng.randint(lo, hi), "window": rng.randrange(n_win),
              "block": rng.randrange(c["dit"]["num_layers"]), "row": rng.randrange(3)}
    tokens = frames * (lh // 2) * (lw // 2)
    shape = (3, tokens // world, c["dit"]["dim"])
    buffers = {f"{stage}_{end}": torch.empty(shape, dtype=torch.bfloat16, pin_memory=on_card)
               for stage in gen.STAGES for end in ("in", "out")}
    cap = gen._Capture(n_win, c["dit"]["num_layers"], sample, buffers)
    warm = tr["warmup_sweeps"]
    st = {"start": None, "end": None, "sweeps": 0, "bad": 0, "trace": None}
    tracer = Tracer() if job.trace else None
    flag = torch.zeros(1, device=dev)

    def on_step(i, lat):
        # the StepTimer has synchronised the card at the end of the sweep
        now = time.monotonic()
        progress()
        if i == sample["sweep"] - 1:
            cap.got["before"] = lat
        elif i == sample["sweep"]:
            cap.got["after"] = lat
        finite = bool(torch.isfinite(lat).all())
        if i < warm - 1:
            return
        if i == warm - 1:
            st["start"] = time.monotonic()
            if tracer is not None:
                tracer.start()
            return
        st["sweeps"] += 1
        st["bad"] += int(not finite)
        if tracer is not None and st["trace"] is None:
            st["trace"] = tracer.stop(steps=n_win)
        # rank 0's decision, to every rank
        flag.fill_(float(rank == 0 and now - st["start"] >= job.seconds
                         and i >= sample["sweep"]))
        dist.broadcast(flag, src=0)
        if flag.item() > 0:
            st["end"] = now
            raise gen._WindowClosed

    patches = [(long_mod, "prepare_conditioning", cap.conditioning),
               (long_mod, "extract_vocal_features", cap.vocal),
               (long_mod, "dit_forward", cap.forward), (dit_mod, "apply_block", cap.apply_block),
               (dit_mod, "_self_attention", cap.self_attention),
               (dit_mod, "_cross_attention", cap.cross_attention),
               (dit_mod, "apply_linear", cap.linear)]
    planted = faults_usp.plant(job.fault)
    with planted:
        saved = [(m, name, getattr(m, name)) for m, name, _ in patches]
        for m, name, wrap in patches:
            setattr(m, name, wrap(getattr(m, name)))
        try:
            with mesh_context(mesh):
                long_mod.generate_long(
                    models, ref_image=image, vocal_waveform=audio, text_ctx=text_ctx,
                    num_inference_steps=tr["steps"], text_guide_scale=tr["text_guidance"],
                    audio_guide_scale=tr["audio_guidance"], clip_length=tr["clip_length"],
                    overlap_window_length=tr["overlap"], scheduler=tr["scheduler"],
                    fps=tr["fps"], sr=tr["sample_rate"], seed=job.seed, shift=tr["shift"],
                    output_type="latent", timer=StepTimer(dev), step_callback=on_step)
        except gen._WindowClosed:
            pass
        finally:
            for m, name, real in saved:
                setattr(m, name, real)
    if st["end"] is None:
        raise core.BenchError(f"the schedule of {tr['steps']} steps ended before the window "
                              f"of {job.seconds} s closed")
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    steps = st["sweeps"] * n_win
    del models, prog_dit
    _release(device)
    progress()

    # every rank's report and block k's branch slices, to rank 0
    got_all = all(k in cap.got for k in buffers)
    report = {"peak": peak, "forbidden": core.forbidden_modules(), "captured": got_all,
              "device": None if st["trace"] is None else st["trace"].device}
    reports = [None] * world
    dist.all_gather_object(reports, report)
    if all(r["captured"] for r in reports):
        for name in buffers:
            part = cap.got[name].to(dev)
            parts = [torch.empty_like(part) for _ in range(world)] if rank == 0 else None
            dist.gather(part, parts, dst=0)
            if rank == 0:
                cap.got[name] = torch.cat(parts, 1).cpu()
            del part, parts
    else:
        for name in buffers:
            cap.got.pop(name, None)
    if rank != 0:
        return None

    bad = sorted({m for r in reports for m in r["forbidden"]})
    if bad:
        raise core.BenchError(f"modules of JAX or the JAX package were loaded on a rank: "
                              f"{', '.join(bad)}")
    peak = max(r["peak"] for r in reports)
    metrics = {"window_step_s": (st["end"] - st["start"]) / steps,
               "peak_mem_gib": peak / 2 ** 30, "setup_s": st["start"] - t0}
    checks = gen.judge(c, tr, (dit, vae, clip, w2v), (image, audio, text_ctx), cap.got, windows,
                       slices, sample, cell.limits)
    calls = roofline.dit_calls(c["dit"], 3, frames, lh, lw,
                               roofline.wav2vec_frames(c["wav2vec"], len(slices[0])),
                               (frames - 1) * 4 + 1)
    trace = st["trace"]
    ctx = {"trace": trace, "calls": roofline_usp.rank_calls(calls, world), "steps": n_win,
           "train": False,
           "usp": None if trace is None else {
               "world": world, "ranks": [r["device"] for r in reports],
               "exchange_bytes": roofline_usp.exchange_bytes(c["dit"], 3, tokens, world)
               if attn_impl == "ulysses" else None}}
    return core.Outcome(metrics=metrics, checks=checks, attempted=steps,
                        failed=st["bad"] * n_win, memory_peak_bytes=peak, trace=trace,
                        layer_ctx=ctx)
