"""The sequence-parallel kind (`traffic/gen_usp.py`) on two spawned gloo
ranks at the tiny size: its latents against one process's gen run, each
fault it can have (the gen kind's and those only a sharded run can have),
a rank 0 that fails, and the readers' arithmetic on a synthetic trace."""

import dataclasses
import multiprocessing
import time
from multiprocessing import resource_tracker

import numpy as np
import pytest
import torch

from avatar_bench import core, faults_usp, readings, roofline, roofline_usp
from avatar_bench.tests.test_bench_hygiene import loaded_after
from avatar_bench.tests.tiny import tiny_cell, tiny_config
from avatar_bench.trace import Trace
from avatar_bench.traffic import gen, gen_usp

SEED = 2 ** 31 + 11
CELL = "gen-14b-usp4"


def usp_cell():
    """The cell at the tiny size on 2 ranks, the DiT in float32 as the
    port's own gloo tests run it; 168 tokens a rank, so rank 1's slice
    starts inside a latent frame of 16."""
    cell = tiny_cell(CELL)
    return dataclasses.replace(cell, config=tiny_config(("float32", "bfloat16", "bfloat16",
                                                         "float32")),
                               traffic=dict(cell.traffic, ulysses_degree=2))


@pytest.fixture(scope="module")
def runs():
    """One spawn: the program, then each fault; and the gen kind's
    run of the same request in this process.  The latents after the checked
    sweep are taken from what each run hands its judge."""
    cell = usp_cell()
    judged = []
    real = gen.judge

    def judge(c, tr, models, inputs, got, *a):
        judged.append(got["after"].float().cpu().numpy())
        return real(c, tr, models, inputs, got, *a)

    gen.judge = judge
    threads = torch.get_num_threads()
    torch.set_num_threads(max(1, threads // 2))  # the spawned rank takes the other half
    try:
        jobs = [gen_usp.Job(SEED, 0.0)] + [gen_usp.Job(SEED, 0.0, fault=f)
                                          for f in sorted(faults_usp.USP)]
        outs = gen_usp.run_jobs(cell, jobs, time.monotonic(), device="cpu")
        one = dataclasses.replace(cell, traffic=dict(cell.traffic, kind="gen"))
        single = gen.run(one, seed=SEED, seconds=0.0, trace=False, t0=time.monotonic(),
                         device="cpu")
    finally:
        gen.judge = real
        torch.set_num_threads(threads)
    return {"program": (outs[0], judged[0]), "single": (single, judged[-1]),
            **{j.fault: (o, None) for j, o in zip(jobs[1:], outs[1:])}}


def test_program_matches_one_process(runs):
    out, latents = runs["program"]
    assert out.correct, [(c.name, c.value, c.limit) for c in out.checks]
    # no process of the run outlives it: the workers and the resource tracker have ended
    assert multiprocessing.active_children() == []
    assert resource_tracker._resource_tracker._pid is None
    assert set(out.metrics) == {"window_step_s", "peak_mem_gib", "setup_s"}
    assert out.failed == 0 and out.metrics["window_step_s"] > 0
    # the tolerance of the port's gloo test of generate_long (tests/test_torch_parallel.py)
    np.testing.assert_allclose(latents, runs["single"][1], rtol=2e-3, atol=2e-4)
    assert runs["single"][0].correct


@pytest.mark.parametrize("fault", sorted(faults_usp.USP))
def test_fault_is_caught(runs, fault):
    out, _ = runs[fault]
    assert not out.correct, [(c.name, c.value, c.limit) for c in out.checks]


def test_workers_end_when_rank_0_fails():
    """Rank 0 fails before its first collective: the worker, waiting in it,
    is ended at once and the error reaches the caller."""
    cell = usp_cell()
    real = gen_usp._job

    def failing(rank, *a, **k):
        raise RuntimeError("rank 0 failed")

    gen_usp._job = failing
    t = time.monotonic()
    try:
        with pytest.raises(RuntimeError, match="rank 0 failed"):
            gen_usp.run_jobs(cell, [gen_usp.Job(SEED, 0.0)], time.monotonic(), device="cpu")
    finally:
        gen_usp._job = real
    assert multiprocessing.active_children() == []
    assert resource_tracker._resource_tracker._pid is None
    assert time.monotonic() - t < gen_usp.JOIN_S


def test_exchange_bytes_by_hand():
    # 2 layers x 4 exchanges x (3 rows x 168 tokens x 32 wide x 2 bytes) x 1/2 leaving
    assert roofline_usp.exchange_bytes({"dim": 32, "num_layers": 2}, 3, 336, 2) == 129024
    # the cell: 40 x 4 x 3 x 5,376 x 5,120 x 2 x 3/4 = 19.8 GB a card a window-step
    c = core.read_json(core.PACKAGE / "configs" / "wan2.1-14b.json")["dit"]
    assert roofline_usp.exchange_bytes(c, 3, 21504, 4) == 19818086400


NAMES = ("ncclDevKernel_SendRecv(ncclDevComm*, unsigned long, ncclWork*)",
         "ncclDevKernel_AllGather_RING_LL(ncclDevComm*, unsigned long, ncclWork*)")


def synthetic_ctx():
    """Rank 0: a GEMM over [0, 4) ms, an exchange over [3, 6) ms, copy
    [7, 8) ms, the gather [9, 10) ms, in a 12 ms window of 2 window-steps;
    rank 1's compute is 4 ms + 1 ms, rank 0's 4 ms + 1 ms copy = 5 ms."""
    ms = 1e-3
    r0 = [("sm90_gemm", 0, 4 * ms), (NAMES[0], 3 * ms, 6 * ms), ("Memcpy DtoD", 7 * ms, 8 * ms),
          (NAMES[1], 9 * ms, 10 * ms)]
    r1 = [("sm90_gemm", 0, 2 * ms), ("k", 2 * ms, 4 * ms), (NAMES[0], 4 * ms, 6 * ms)]
    t = Trace(device=r0, host=[], window_s=12 * ms, steps=2)
    calls = [roofline.Call("linear", "x", 1e12, 0.0)]
    return {"trace": t, "calls": roofline_usp.rank_calls(calls, 4), "steps": 2, "train": False,
            "usp": {"world": 4, "ranks": [r0, r1], "exchange_bytes": 0.45e9}}


@pytest.mark.parametrize("name, want", [
    # the whole step's 2e12 operations over four cards' peak
    ("mfu_pct.gen", 100 * 2e12 / (12e-3 * 4 * 989e12)),
    ("idle_pct.gen", 100 * (1 - 8 / 12)),  # rank 0 busy [0, 6) + [7, 8) + [9, 10)
    ("gemm_roofline.gen", 100 * 2 * 0.25e12 / 989e12 / 4e-3),  # rank 0's quarter, its GEMM
    ("all_to_all_ms.usp", 3 / 2),
    ("comm_exposed_ms.usp", (2 + 1) / 2),  # [4, 6) and [9, 10)
    ("all_to_all_link_pct.usp", 100 * 0.45e9 * 2 / 3e-3 / 450e9),
    ("rank_busy_spread_pct.usp", 100 * (5 - 4) / 5),
])
def test_readers_by_hand(name, want):
    assert core.metric_reader(name)(synthetic_ctx()) == pytest.approx(want, rel=1e-9)


@pytest.mark.parametrize("name", ["all_to_all_ms.usp", "comm_exposed_ms.usp",
                                  "all_to_all_link_pct.usp", "rank_busy_spread_pct.usp"])
def test_readers_find_nothing_without_the_ranks(name):
    ctx = dict(synthetic_ctx(), usp=None)
    assert core.metric_reader(name)(ctx) is None


def test_rank_calls_by_hand():
    """Rank 0's self-attention at one small shape: 10 of 40 heads over the
    whole 1,024-token sequence of 3 rows; its linears over 256 tokens."""
    c = core.read_json(core.PACKAGE / "configs" / "wan2.1-14b.json")["dit"]
    calls = roofline.dit_calls(c, 3, 1, 64, 64, 50, 1)
    mine = roofline_usp.rank_calls(calls, 4)
    by = {x.name: x for x in mine}
    assert by["self"].flops == 4 * 3 * 10 * 1024 * 1024 * 128
    assert by["self"].nbytes == 2 * 3 * 10 * 128 * (2 * 1024 + 2 * 1024)
    assert by["self.q"].flops == 2 * 3 * 256 * 5120 * 5120
    assert roofline.model_flops(mine) * 4 == pytest.approx(roofline.model_flops(calls), rel=1e-12)


def test_readings_plant_faults_in_the_ranks():
    """`readings.py` hands a kind that runs workers each fault by name."""
    cell = usp_cell()
    todo = [("program", 1), ("control", 2), ("fault:gather_swap", 3), ("fault:half_batch", 4)]
    jobs = readings.worker_jobs(cell, gen_usp, todo, 0.0)
    assert [(j.seed, j.variant, j.fault) for j in jobs] == [
        (1, "program", None), (2, "control", None), (3, "program", "gather_swap"),
        (4, "program", "half_batch")]
    with pytest.raises(SystemExit, match="no fault named"):
        readings.worker_jobs(cell, gen_usp, [("fault:nothing", 1)], 0.0)


def test_new_modules_load_no_jax():
    mods = loaded_after(("avatar_bench.traffic.gen_usp", "avatar_bench.roofline_usp",
                         "avatar_bench.faults_usp", "avatar_bench.readings",
                         "stableavatar_tpu_torch.cli.inference"))
    assert core.forbidden_modules(mods) == []
