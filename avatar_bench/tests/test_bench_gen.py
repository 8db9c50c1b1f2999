"""The gen traffic's whole run below the card check, at the tiny size: its
window, its metrics and its comparison with the reference.  Each fault a
gen cell can have, planted under the timed path, turns `correct` false
under the cell's own limits; the control's gap stands apart from the
program's."""

import time

import pytest

from avatar_bench import faults
from avatar_bench.tests.tiny import tiny_cell
from avatar_bench.traffic import gen

SEEDS = (3, 2 ** 31 + 11)


def run(cell, seed, variant="program"):
    return gen.run(cell, seed=seed, seconds=0.0, trace=False, t0=time.monotonic(), device="cpu",
                   variant=variant)


@pytest.fixture(scope="module", params=["gen-1.3b-euler", "gen-14b-euler"])
def cell(request):
    return tiny_cell(request.param)


@pytest.mark.parametrize("seed", SEEDS)
def test_program_is_correct(cell, seed):
    out = run(cell, seed)
    assert out.correct, [(c.name, c.value, c.limit) for c in out.checks]
    assert out.failed == 0 and out.attempted >= len(gen.plan(cell.traffic, cell.config)[0])
    assert set(out.metrics) == {"window_step_s", "peak_mem_gib", "setup_s"}
    assert out.metrics["window_step_s"] > 0


def test_same_seed_same_answer(cell):
    a, b = run(cell, SEEDS[0]), run(cell, SEEDS[0])
    assert [c.value for c in a.checks] == [c.value for c in b.checks]


@pytest.mark.parametrize("fault", sorted(faults.GEN))
def test_fault_is_caught(cell, fault):
    with faults.GEN[fault]():
        out = run(cell, SEEDS[0])
    assert not out.correct, [(c.name, c.value, c.limit) for c in out.checks]


def test_control_reads_above_the_program(cell):
    """The program's int8 path in its place (the control; on the CPU its
    W8A8 linears only) reads a branch gap above twice the bf16 program's."""
    for seed in SEEDS:
        prog = {c.name: c.value for c in run(cell, seed).checks}
        ctrl = {c.name: c.value for c in run(cell, seed, "control").checks}
        assert ctrl["branch_gap"] > 2 * prog["branch_gap"]
