"""The port's spans (`utils/profiling.py:span`): nothing recorded without a
profiler, names and nesting in a CPU `torch.profiler` trace, one span of
each kind where `generate_long` does its work, the latents unchanged by
tracing, and the recorder's arithmetic under an injected clock.  Tiny
models from the port's own initialisers; nothing runs through JAX."""

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from stableavatar_tpu_torch.config import tiny_debug_configs
from stableavatar_tpu_torch.models.clip import init_clip_visual
from stableavatar_tpu_torch.models.dit import init_dit
from stableavatar_tpu_torch.models.vae import init_vae
from stableavatar_tpu_torch.models.wav2vec import init_wav2vec2
from stableavatar_tpu_torch.pipelines.common import WanModels
from stableavatar_tpu_torch.pipelines.long import generate_long, plan_windows
from stableavatar_tpu_torch.utils import profiling
from stableavatar_tpu_torch.utils.profiling import StepTimer, span, span_device_ms

STEPS = 2
BRANCHES = ("sa.self_attn", "sa.cross_attn", "sa.ffn")


def host_ranges(prof):
    """The profiler's host events as (name, start ns, end ns)."""
    return [(ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns())
            for ev in prof.profiler.kineto_results.events() if ev.device_type() == DeviceType.CPU]


def inside(ranges, outer, inner):
    """How many `inner` ranges lie inside each `outer` range."""
    outs = [(s, e) for n, s, e in ranges if n == outer]
    ins = [(s, e) for n, s, e in ranges if n == inner]
    return [sum(a <= s and e <= b for s, e in ins) for a, b in outs]


@pytest.fixture(scope="module")
def tiny():
    dit_cfg, vae_cfg, _, clip_cfg, w2v_cfg = tiny_debug_configs()
    gen = torch.Generator().manual_seed(0)
    models = WanModels(
        dit_params=init_dit(gen, dit_cfg, device="cpu", dtype=torch.bfloat16), dit_cfg=dit_cfg,
        vae_params=init_vae(gen, vae_cfg, device="cpu"), vae_cfg=vae_cfg,
        clip_params=init_clip_visual(gen, clip_cfg, device="cpu"), clip_cfg=clip_cfg,
        wav2vec_params=init_wav2vec2(gen, w2v_cfg, device="cpu"), wav2vec_cfg=w2v_cfg,
        device="cpu")
    inputs = dict(
        ref_image=torch.rand((1, 3, 32, 32), generator=gen) * 2 - 1,
        vocal_waveform=0.1 * torch.randn(18 * 640, generator=gen).numpy(),
        text_ctx=torch.randn((3, dit_cfg.text_len, dit_cfg.text_dim), generator=gen))
    return models, inputs


def run(models, inputs, timer=None, callback=None):
    return generate_long(models, **inputs, num_inference_steps=STEPS, clip_length=9,
                         overlap_window_length=1, output_type="latent", timer=timer,
                         step_callback=callback).latents


def test_no_profiler_no_span():
    before = span_device_ms()
    ctx = span("sa.window")
    assert ctx is span("sa.block") is profiling._NOOP
    with ctx:
        torch.ones(3).sum()
    assert span_device_ms() == before


def test_spans_nest_in_the_profilers_trace():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("sa.window"):
            with span("sa.dit"):
                torch.ones(4).add_(1)
            torch.ones(4).mul_(2)
    ranges = host_ranges(prof)
    assert inside(ranges, "sa.window", "sa.dit") == [1]
    assert inside(ranges, "sa.dit", "aten::add_") == [1]
    assert inside(ranges, "sa.dit", "aten::mul_") == [0]
    ms, windows = span_device_ms()
    assert windows == 1 and set(ms) == {"sa.window", "sa.dit"}
    assert ms["sa.window"] >= ms["sa.dit"] > 0


def test_generate_long_spans_and_latents(tiny):
    models, inputs = tiny
    plain = run(models, inputs)
    seen = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = run(models, inputs, StepTimer("cpu"), lambda i, lat: seen.append(i))
    assert torch.equal(plain, traced)
    assert seen == list(range(STEPS))
    n_win = len(plan_windows(5, 3, 1))
    layers = models.dit_cfg.num_layers
    ranges = host_ranges(prof)
    count = {n: sum(r[0] == n for r in ranges) for n in profiling.TIMED | {"sa.denoise_step"}}
    calls = STEPS * n_win
    assert n_win == 2 and count["sa.denoise_step"] == STEPS
    assert inside(ranges, "sa.denoise_step", "sa.window") == [n_win] * STEPS
    assert inside(ranges, "sa.window", "sa.dit") == [1] * calls
    assert inside(ranges, "sa.dit", "sa.prologue") == [1] * calls
    assert inside(ranges, "sa.dit", "sa.head") == [1] * calls
    assert inside(ranges, "sa.dit", "sa.block") == [layers] * calls
    for branch in BRANCHES:
        assert inside(ranges, "sa.block", branch) == [1] * (calls * layers)
    for phase in ("text_encode", "conditioning", "wav2vec"):
        assert sum(r[0] == f"sa.{phase}" for r in ranges) == 1
    assert sum(r[0] == "sa.step_callback" for r in ranges) == STEPS
    ms, windows = span_device_ms()
    assert windows == calls and set(ms) == profiling.TIMED
    assert profiling.span_allocator_calls() is None  # no card


def test_step_timer_phase_is_a_span():
    timer = StepTimer("cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timer.phase("denoise_step"):
            with span("sa.window"):
                torch.ones(2).sum()
    assert inside(host_ranges(prof), "sa.denoise_step", "sa.window") == [1]
    assert timer.summary()["denoise_step"]["count"] == 1
    assert span_device_ms()[1] == 1


def test_nested_totals_under_an_injected_clock(monkeypatch):
    """Each span counts from its start to its end, children included; the
    readers' subtractions then give each level its own time."""
    ticks = iter(range(100))
    monkeypatch.setattr(profiling, "_clock", lambda: float(next(ticks)))
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            with span("sa.window"):  # 0 .. 9, then 10 .. 19
                with span("sa.dit"):  # 1 .. 8
                    with span("sa.block"):  # 2 .. 7
                        with span("sa.self_attn"):  # 3 .. 4
                            pass
                        with span("sa.ffn"):  # 5 .. 6
                            pass
        with span("sa.step_callback"):  # host range only: no ticks
            pass
    ms, windows = span_device_ms()
    assert windows == 2
    assert ms == {"sa.window": 18e3, "sa.dit": 14e3, "sa.block": 10e3, "sa.self_attn": 2e3,
                  "sa.ffn": 2e3}
    assert ms["sa.block"] - ms["sa.self_attn"] - ms["sa.ffn"] == 6e3
    assert ms["sa.window"] - ms["sa.dit"] == 4e3
    # a reading is kept until a new stretch starts, which replaces it
    assert span_device_ms() == (ms, 2)
    with profile(activities=[ProfilerActivity.CPU]):
        with span("sa.window"):  # 20 .. 21
            pass
    # a stretch also ends where a span runs with no profiler recording
    with span("sa.window"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        with span("sa.window"):  # 22 .. 25
            with span("sa.dit"):  # 23 .. 24
                pass
    assert span_device_ms() == ({"sa.window": 3e3, "sa.dit": 1e3}, 1)


def test_spans_are_read_after_the_profiler_stops():
    with profile(activities=[ProfilerActivity.CPU]):
        with span("sa.window"):
            pass
        with pytest.raises(RuntimeError, match="after the profiler has stopped"):
            span_device_ms()
