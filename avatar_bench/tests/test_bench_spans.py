"""The readers of the program's spans against hand-worked values: a
synthetic trace with the spans' host ranges and synthetic recorder totals
in place of the program's, and nothing to read where the program has no
spans."""

import pytest

from avatar_bench import core
from avatar_bench.trace import Trace
from stableavatar_tpu_torch.utils import profiling

NEW = ("self_attn_ms.gen", "cross_attn_ms.gen", "ffn_ms.gen", "block_chain_ms.gen",
       "dit_edges_ms.gen", "sweep_update_ms.gen", "idle_in_dit_ms.gen",
       "idle_outside_dit_ms.gen", "allocator_calls_per_window_step.gen")
# device ms of the whole traced sweep by span, two window-steps
TOTALS = {"sa.window": 96.0, "sa.dit": 80.0, "sa.prologue": 4.0, "sa.block": 70.0,
          "sa.self_attn": 30.0, "sa.cross_attn": 10.0, "sa.ffn": 20.0, "sa.head": 2.0}


def synthetic_trace():
    host = [("sa.denoise_step", 0.000, 0.100),
            ("sa.window", 0.001, 0.049), ("sa.dit", 0.002, 0.040),
            ("sa.window", 0.050, 0.098), ("sa.dit", 0.052, 0.090),
            ("sa.step_callback", 0.101, 0.125)]
    device = [("k1", 0.005, 0.030), ("k2", 0.032, 0.045), ("k3", 0.047, 0.060),
              ("k4", 0.060, 0.095), ("k5", 0.097, 0.1015), ("k6", 0.120, 0.121)]
    return Trace(device=device, host=host, window_s=0.130, steps=2)


def read_all(ctx):
    cell = core.load_cell("gen-1.3b-euler")
    return {k: x["value"] for k, x in core.read_per_layer(cell, ctx).items()}


@pytest.fixture
def recorder(monkeypatch):
    got = {"ms": (dict(TOTALS), 2), "alloc": (6, 2)}
    monkeypatch.setattr(profiling, "span_device_ms", lambda: got["ms"])
    monkeypatch.setattr(profiling, "span_allocator_calls", lambda: got["alloc"])
    return got


def ctx(trace=None):
    return {"trace": synthetic_trace() if trace is None else trace, "calls": [], "steps": 2,
            "train": False}


def test_device_split_by_hand(recorder):
    v = read_all(ctx())
    assert v["self_attn_ms.gen"] == pytest.approx(30.0 / 2)
    assert v["cross_attn_ms.gen"] == pytest.approx(10.0 / 2)
    assert v["ffn_ms.gen"] == pytest.approx(20.0 / 2)
    assert v["block_chain_ms.gen"] == pytest.approx((70.0 - 30.0 - 10.0 - 20.0) / 2)
    assert v["dit_edges_ms.gen"] == pytest.approx((80.0 - 70.0) / 2)
    assert v["sweep_update_ms.gen"] == pytest.approx((96.0 - 80.0) / 2)
    # the six parts close on the windows' own device time
    assert sum(v[k] for k in NEW[:6]) == pytest.approx(96.0 / 2)
    assert v["allocator_calls_per_window_step.gen"] == pytest.approx(6 / 2)


def test_idle_split_by_hand(recorder):
    """Gaps inside sa.denoise_step [0, 100 ms], extended to k5's end at
    101.5 ms (k6 ran after it): [0, 5] (3 ms inside the first sa.dit from
    2 ms, 2 before it), [30, 32] (inside), [45, 47] and [95, 97] (between
    DiT calls): 5 ms in the DiT, 6 ms outside, over 2 window-steps."""
    v = read_all(ctx())
    assert v["idle_in_dit_ms.gen"] == pytest.approx(5.0 / 2)
    assert v["idle_outside_dit_ms.gen"] == pytest.approx(6.0 / 2)


def test_nothing_to_read_without_spans(recorder, monkeypatch):
    bare = Trace(device=synthetic_trace().device, host=[], window_s=0.130, steps=2)
    # no window, or not one a window-step
    for ms, alloc in ((({}, 0), (0, 0)), ((dict(TOTALS), 3), (6, 3))):
        recorder.update(ms=ms, alloc=alloc)
        assert not set(read_all(ctx())) & set(NEW)
    recorder["ms"] = (dict(TOTALS), 2)
    assert "idle_in_dit_ms.gen" not in read_all(ctx(bare))
    assert not set(read_all({"trace": None, "calls": [], "steps": 2})) & set(NEW)
    recorder["alloc"] = None  # a stretch without the card
    assert "allocator_calls_per_window_step.gen" not in read_all(ctx())
    # a program from before the spans
    monkeypatch.delattr(profiling, "span_device_ms")
    assert not set(read_all(ctx())) & set(NEW)
