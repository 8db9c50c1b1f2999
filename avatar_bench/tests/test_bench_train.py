"""The train traffic's whole run below the card check, at the tiny size; the
train reference against the port's float32 step; the train readers on a
synthetic trace; the train step's operation counts.

The tiny runs keep the DiT's parameters and activations in float32
(`trainer.DIT_DTYPE` patched, as the port's parity tests do), so that the
program equals the reference to rounding: each fault a train cell can have,
planted under the timed path, turns `correct` false under the cell's own
limits, and the control (the reference with float8 products in the
program's place) reads above the program.
"""

import dataclasses
import re
import time

import numpy as np
import pytest

from avatar_bench import core, faults_train, readings, roofline, roofline_train
from avatar_bench.reference import train as rt
from avatar_bench.tests.tiny import tiny_config
from avatar_bench.trace_train import TrainTrace
from avatar_bench.traffic import train

SEEDS = (3, 2 ** 31 + 11)
CELL = "train-1.3b-adamw"


@pytest.fixture(scope="module")
def cell():
    c = core.load_cell(CELL)
    return dataclasses.replace(c, config=tiny_config(("float32",) * 4),
                               traffic=dict(c.traffic, image_size=[32, 32], prompt_tokens=5))


@pytest.fixture(autouse=True)
def float32_step(monkeypatch):
    import torch

    from stableavatar_tpu_torch.train import trainer

    monkeypatch.setattr(trainer, "DIT_DTYPE", torch.float32)


def run(cell, seed, variant="program"):
    return train.run(cell, seed=seed, seconds=0.0, trace=False, t0=time.monotonic(),
                     device="cpu", variant=variant)


def numbers(out):
    return {c.name: c.value for c in out.checks}


@pytest.mark.parametrize("seed", SEEDS)
def test_program_is_correct(cell, seed):
    out = run(cell, seed)
    assert out.correct, [(c.name, c.value, c.limit) for c in out.checks]
    assert out.failed == 0 and out.attempted >= 1
    assert set(out.metrics) == {"train_step_s", "peak_mem_gib", "setup_s"}
    assert out.metrics["train_step_s"] > 0


def test_same_seed_same_answer(cell):
    assert numbers(run(cell, SEEDS[0])) == numbers(run(cell, SEEDS[0]))


@pytest.mark.parametrize("fault", sorted(faults_train.TRAIN))
def test_fault_is_caught(cell, fault):
    """Each fault, planted through `readings.py`'s table for the cell's kind."""
    line = readings.reading(cell, SEEDS[0], f"fault:{fault}", 0.0, device="cpu")
    assert line["variant"] == f"fault:{fault}" and not line["correct"], line["compared"]


def test_control_reads_above_the_program(cell):
    for seed in SEEDS:
        prog, ctrl = run(cell, seed), run(cell, seed, "control")
        assert not ctrl.correct
        assert numbers(ctrl)["loss_gap"] > 10 * numbers(prog)["loss_gap"]


def test_flag_plan_holds_the_same_counts_for_every_seed(cell):
    tr = cell.traffic
    f = tr["flags"]
    for seed in SEEDS + (7,):
        plan = train.flag_plan(tr, seed)
        warm = [next(plan) for _ in range(3)]
        assert sorted((w["clip_level"], w["audio_dropped"]) for w in warm) == \
            [(False, False), (False, True), (True, False)]
        for _ in range(3):
            cycle = [next(plan) for _ in range(f["cycle"])]
            assert sum(x["clip_level"] for x in cycle) == f["clip_level"]
            assert sum(x["audio_dropped"] for x in cycle) == f["audio_dropped"]
            assert not any(x["clip_level"] and x["audio_dropped"] for x in cycle)


def rel(a, b):
    return train._rel(a.double(), b.double())


@pytest.mark.parametrize("kind", [{}, {"clip_level": True}, {"audio_dropped": True}])
def test_reference_matches_the_ports_float32_step(cell, kind):
    """One step of the port (`encode_batch`, then `train_step` with AdamW
    behind the clip) and of the reference on the same fp32 weights, batch
    and draws: the encodes, the loss and the clipped gradient (AdamW's first
    moment) at rel-L2 1e-5, every parameter's update to 1e-5 of itself and
    two roundings of the parameter, TF32 off on both sides."""
    import torch

    from stableavatar_tpu_torch.pipelines.common import WanModels
    from stableavatar_tpu_torch.train import loop, trainer
    from avatar_bench import weights
    from avatar_bench.traffic.gen import program_configs

    c, tr = cell.config, cell.traffic
    gen = torch.Generator().manual_seed(11)
    specs = [weights.spec_dit(c["dit"]), weights.spec_vae(c["vae"]), weights.spec_clip(c["clip"]),
             weights.spec_wav2vec(c["wav2vec"])]
    models = weights.draw(specs, gen, "cpu", [torch.float32] * 4)
    batch = train.make_pool(tr, c, gen, "cpu", 11)[0]
    shape = train.latent_shape(tr, c)
    vae_noise = tuple(torch.randn(shape, generator=gen) for _ in range(2))
    flags = {"clip_level": bool(kind.get("clip_level")),
             "audio_dropped": bool(kind.get("audio_dropped"))}
    draws = {"noise": torch.randn(shape, generator=gen), "idx": torch.tensor([417]),
             "mask_flag": torch.tensor(0.2)}
    ref = rt.follow(c, models, [{"batch": batch, "flags": flags, "vae_noise": vae_noise,
                                 **draws}], tr["train"], keep=True)

    dit_cfg, vae_cfg, clip_cfg, w2v_cfg = program_configs(c)
    dit, vae, clip, w2v = models
    wan = WanModels(dit_params=dit, dit_cfg=dit_cfg, vae_params=vae, vae_cfg=vae_cfg,
                    clip_params=clip, clip_cfg=clip_cfg, wav2vec_params=w2v, wav2vec_cfg=w2v_cfg,
                    device="cpu")
    enc = loop.encode_batch(wan, batch, np.random.default_rng(0),
                            audio_dropout_prob=float(flags["audio_dropped"]),
                            clip_level_prob=float(flags["clip_level"]), vae_noise=vae_noise)
    for k in train.ENCODED:
        assert rel(enc[k], ref["encoded"][0][k]) < 1e-5, k
    tc = train.train_config(tr)
    tx = trainer.make_optimizer(tc)
    leaves = [p for _, p in rt.paths(dit)]
    before = [p.clone() for p in leaves]
    state = tx.init(leaves)
    is_clip = enc.pop("is_clip_level_modeling")
    assert is_clip == flags["clip_level"]
    _, state, metrics = trainer.train_step(
        dit, state, enc, None, is_clip, dit_cfg=dit_cfg, train_cfg=tc, tx=tx,
        sigmas_table=trainer.train_sigmas(tc.num_train_timesteps, tc.shift, device="cpu"),
        draws=draws)
    assert abs(float(metrics["loss"]) - ref["loss"][0]) <= 1e-5 * abs(ref["loss"][0])
    names = [p for p, _ in rt.paths(dit)]
    mu = train._first_moments(state)
    grad = torch.cat([(m / (1 - tc.adam_beta1)).reshape(-1) for m in mu])
    assert rel(grad, torch.cat([ref["first_grads"][k].reshape(-1) for k in names])) < 1e-5
    # the leaves whose gradient is not nought to rounding: AdamW moves the
    # others (the attention key biases) by the sign of their round-off
    moved = set(rt.moved_leaves(ref["grad_raw"]))
    assert len(moved) < len(names)
    kept = [(k, p, b) for k, p, b in zip(names, leaves, before) if k in moved]
    step = torch.cat([(p - b).reshape(-1) for _, p, b in kept])
    want = torch.cat([(ref["params"][k] - b).reshape(-1) for k, _, b in kept])
    # each parameter's update the same to 1e-5 of itself, give or take two
    # roundings of the float32 parameter (the update is some 2e-5, a
    # rounding of a weight up to some 4e-9), where its gradient is at least
    # a thousandth of the median's: AdamW divides a gradient by its own size
    # plus 1e-10, so one of some 1e-9 carries its round-off into the update
    start = torch.cat([b.reshape(-1) for _, _, b in kept]).abs()
    ulp = torch.nextafter(start, torch.tensor(float("inf"))) - start
    g = torch.cat([ref["first_grads"][k].reshape(-1) for k, _, _ in kept]).abs()
    sure = g >= 1e-3 * g.median()
    assert float(sure.float().mean()) > 0.99
    assert bool(((step - want).abs() <= 2 * ulp + 1e-5 * want.abs())[sure].all())


# ---------------------------------------------------------------------------
# the readers and the arithmetic
# ---------------------------------------------------------------------------

C13 = core.read_json(core.ROOT / "avatar_bench/configs/wan2.1-1.3b.json")["dit"]


def calls_13b():
    return roofline.dit_calls(C13, 1, 21, 64, 64, 161, 81)


def test_step_operations_are_three_forwards():
    calls = calls_13b()
    assert roofline_train.step_flops(calls) == 3 * roofline.model_flops(calls)
    # the DiT work of a step at 1.3B / 512x512 / 81 frames
    assert roofline_train.step_flops(calls) == pytest.approx(3 * 1.426e14, rel=0.01)


def test_k4_counts_two_and_a_half_forwards():
    self_attn = [x for x in calls_13b() if x.name == "self"]
    assert len(self_attn) == C13["num_layers"]
    k1 = self_attn[0]
    k4 = roofline_train.attention_backward(k1)
    assert k4.flops == 2.5 * k1.flops
    # 12 heads of 21,504 queries and keys at 128: 4 b h L^2 d forward
    assert k1.flops == 4 * 12 * 21504 ** 2 * 128
    assert k4.nbytes == 2 * k1.nbytes
    assert roofline_train.attn_fwd_bound_s(self_attn) == pytest.approx(2 * 30 * k1.bound_s)


def test_linear_passes():
    by_name = {x.name: x for x in calls_13b()}
    assert roofline_train.linear_passes(by_name["self.q"]) == 4  # forward, recompute, dgrad, wgrad
    assert roofline_train.linear_passes(by_name["head"]) == 3  # not recomputed
    assert roofline_train.linear_passes(by_name["patch_embedding"]) == 2  # no dgrad
    assert roofline_train.linear_passes(by_name["vocal.proj"]) == 2


def synthetic_trace():
    """One step: a K1 forward (2 ms), an SDPA forward (1 ms), K4 (6 ms), an
    SDPA backward (1 ms), a GEMM (4 ms), two elementwise kernels (1 ms each,
    one launched inside the optimizer's range, one inside the encode's) and
    a copy (0.5 ms, launched in the encode); 25 ms of wall time."""
    ms = 1e-3
    device = [("void sa::ffwd::flash_fwd_kernel<128>", 0.0, 2 * ms),
              ("pytorch_flash::flash_fwd_kernel", 2 * ms, 3 * ms),
              ("void sa::fbwd::flash_bwd_fused_kernel", 3 * ms, 9 * ms),
              ("pytorch_flash::flash_bwd_dq_dk_dv_loop_kernel", 9 * ms, 10 * ms),
              ("nvjet_tst_192x192_64x4_2x1_v_bz_coopB_TNN", 10 * ms, 14 * ms),
              ("void at::native::vectorized_elementwise_kernel", 14 * ms, 15 * ms),
              ("void at::native::elementwise_kernel", 15 * ms, 16 * ms),
              ("Memcpy HtoD (Pageable -> Device)", 16 * ms, 16.5 * ms)]
    launched = [-1.0, -1.0, -1.0, -1.0, -1.0, 0.5, 1.5, 1.6]
    host = [("bench.optimizer", 0.4, 0.6), ("bench.encode", 1.4, 1.7),
            ("aten::add", 1.45, 1.46)]
    return TrainTrace(device=device, host=host, window_s=25 * ms, steps=1, launched=launched)


def read(name, ctx):
    return core.metric_reader(name)(ctx)


def test_readers_on_a_synthetic_trace():
    t = synthetic_trace()
    calls = calls_13b()
    ctx = {"trace": t, "calls": calls, "steps": 1, "train": True}
    assert read("launches_per_step.train", ctx) == 7
    assert read("elementwise_ms.train", ctx) == pytest.approx(2.0)
    assert read("optimizer_ms.train", ctx) == pytest.approx(1.0)
    assert read("encode_ms.train", ctx) == pytest.approx(1.5)
    assert read("idle_pct.train", ctx) == pytest.approx(100 * (1 - 16.5 / 25))
    assert read("mfu_pct.train", ctx) == pytest.approx(
        100 * 3 * roofline.model_flops(calls) / (25e-3 * roofline.PEAK_BF16))
    assert read("attn_fwd_roofline.train", ctx) == pytest.approx(
        100 * roofline_train.attn_fwd_bound_s(calls) / 3e-3)
    assert read("attn_bwd_roofline.train", ctx) == pytest.approx(
        100 * roofline_train.attn_bwd_bound_s(calls) / 7e-3)
    assert read("gemm_roofline.train", ctx) == pytest.approx(
        100 * roofline_train.gemm_bound_s(calls) / 4e-3)


def test_readers_need_a_train_trace():
    names = [m["name"] for m in core.load_cell(CELL).per_layer]
    assert len(names) == 9 and all(re.search(r"\.train$", n) for n in names)
    for ctx in ({"trace": synthetic_trace(), "calls": calls_13b(), "steps": 1, "train": False},
                {"trace": None, "calls": [], "steps": 1, "train": True}):
        assert all(read(n, ctx) is None for n in names)
