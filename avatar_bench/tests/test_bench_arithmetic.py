"""The yardstick's arithmetic against hand-worked values: the DiT's
operations a window-step, the kernels' bounds, the union of kernel
intervals and the per-layer readers on a synthetic trace."""

import pytest

from avatar_bench import core, roofline
from avatar_bench.trace import Trace, gaps, union_s

W2V = {"conv_kernels": [10, 3, 3, 3, 3, 2, 2], "conv_strides": [5, 2, 2, 2, 2, 2, 2]}


def dit(name):
    return core.read_json(core.PACKAGE / "configs" / f"{name}.json")["dit"]


def window_calls(name):
    # 21 latent frames of 64 x 64 (512 x 512), 81 video frames, CFG 3 rows
    return roofline.dit_calls(dit(name), 3, 21, 64, 64, roofline.wav2vec_frames(W2V, 53760), 81)


def test_wav2vec_frames_of_a_window():
    assert roofline.wav2vec_frames(W2V, 21 * 4 * 640) == 167


@pytest.mark.parametrize("name, d, ffn, heads, layers, total", [
    ("wan2.1-1.3b", 1536, 8960, 12, 30, 4.2784e14),
    ("wan2.1-14b", 5120, 13824, 40, 40, 2.7395e15),
])
def test_window_step_flops(name, d, ffn, heads, layers, total):
    calls = window_calls(name)
    m, l = 3 * 21504, 21504
    # by hand: the blocks' q, k, v, o, cross q, o and FFN linears, and
    # self, text and image attention, which are all but 1% of the total
    linears = 2 * m * (6 * d * d + 2 * d * ffn) * layers
    attn = 4 * 3 * heads * l * (l + 512 + 257) * (d // heads) * layers
    assert linears + attn == pytest.approx(total, rel=1e-2)
    assert roofline.model_flops(calls) == pytest.approx(total, rel=1e-4)
    assert sum(c.flops for c in calls if c.kind == "attention") == pytest.approx(attn, rel=1e-12)


def test_self_attention_bound_is_k1s():
    """K1 at [3, 21504, 12, 128]: 8.523e12 FLOP over 989 TFLOP/s = 8.618 ms."""
    (k1,) = [c for c in window_calls("wan2.1-1.3b") if c.name == "self"][:1]
    assert k1.flops == 4 * 3 * 12 * 21504 ** 2 * 128
    assert k1.bound_s * 1e3 == pytest.approx(8.618, abs=5e-4)
    assert k1.nbytes == 2 * 3 * 12 * 128 * 4 * 21504  # q, k, v read, o written


def test_a_call_bound_by_bytes():
    c = roofline.linear("gemv", 3, 4096, 4096)  # 3 rows: the weight's bytes bound it
    assert c.bound_s == pytest.approx(2 * (3 * 4096 + 4096 * 4096 + 3 * 4096) / 3.35e12)


def test_union_and_gaps():
    iv = [("a", 0.0, 1.0), ("b", 0.5, 2.0), ("c", 3.0, 4.0), ("d", 3.2, 3.5)]
    assert union_s(iv) == pytest.approx(3.0)
    assert gaps(iv, -1.0, 5.0) == [(-1.0, 0.0), (2.0, 3.0), (4.0, 5.0)]
    assert union_s([]) == 0.0


def synthetic_trace():
    device = [
        ("void ffwd::flash_fwd_kernel<128, 0, 0>(Params)", 0.000, 0.010),
        ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64", 0.010, 0.016),
        ("void at::native::vectorized_elementwise_kernel<4, gelu>", 0.016, 0.020),
        ("Memcpy DtoD (Device -> Device)", 0.020, 0.021),
        ("void at::native::reduce_kernel<512, 1>", 0.030, 0.032),
    ]
    host = [("aten::linear", 0.020, 0.031), ("cudaLaunchKernel", 0.022, 0.030)]
    return Trace(device=device, host=host, window_s=0.040, steps=2)


def test_breakdown_names_the_host_in_each_gap():
    t = synthetic_trace()
    assert t.busy_s == pytest.approx(0.023)
    b = t.breakdown()
    assert b["device_ops"][0] == ["void ffwd::flash_fwd_kernel<128, 0, 0>(Params)", pytest.approx(0.010)]
    assert b["idle_gaps"] == [["cudaLaunchKernel", pytest.approx(0.009)]]


def test_gen_readers_on_a_synthetic_trace():
    t = synthetic_trace()
    calls = [roofline.Call("attention", "self", 2 * 989e12 * 0.004, 0.0),
             roofline.Call("linear", "fc", 2 * 989e12 * 0.003, 0.0)]
    cell = core.load_cell("gen-1.3b-euler")
    got = core.read_per_layer(cell, {"trace": t, "calls": calls, "steps": 2, "train": False})
    v = {k: x["value"] for k, x in got.items()}
    assert v["attn_roofline.gen"] == pytest.approx(100 * 2 * 0.008 / 0.010)
    assert v["gemm_roofline.gen"] == pytest.approx(100 * 2 * 0.006 / 0.006)
    assert v["idle_pct.gen"] == pytest.approx(100 * (1 - 0.023 / 0.040))
    assert v["elementwise_ms.gen"] == pytest.approx(1e3 * 0.006 / 2)
    assert v["launches_per_window_step.gen"] == pytest.approx(4 / 2)
    flops = 2 * 989e12 * 0.007
    assert v["mfu_pct.gen"] == pytest.approx(100 * flops * 2 / (0.040 * 989e12))
