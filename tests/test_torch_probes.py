"""The port's probes S1-S3 (`ops/probes.py`, `scripts/`) against the JAX
package's probe scripts.

The JAX scripts are loaded from `scripts/` with importlib, their module
constants cut to a CPU size (a test-side patch: the scripts are not
edited), and run with every `pallas_call` in interpret mode and recorded:
each call's inputs and output.  Their `measure` is replaced by one run of
the chained function outside jit, so the recorded arrays are concrete.  The
port's plain versions take the same inputs: int8 GEMM outputs must match
bit for bit, bf16 ones (GEMM and dots, fp32 sums in another order, then
bf16) within rel-L2 1e-2.
"""

import importlib.util
from contextlib import contextmanager
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from stableavatar_tpu_torch.ops import probes
from stableavatar_tpu_torch.scripts import (bench_attn_blocks, microbench_int8,
                                             microbench_int8_linear)
from tests.torch_parity import rel_l2

ROOT = Path(__file__).resolve().parent.parent


def _load(name):
    spec = importlib.util.spec_from_file_location(f"jax_probe_{name}",
                                                  ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextmanager
def recorded_pallas_calls():
    """Every pallas_call in interpret mode, its (inputs, output) appended to
    the yielded list (concrete outside jit)."""
    orig = pl.pallas_call
    calls = []

    def call(*args, **kwargs):
        kwargs["interpret"] = True
        fn = orig(*args, **kwargs)

        def run(*inputs):
            out = fn(*inputs)
            calls.append((inputs, out))
            return out

        return run

    pl.pallas_call = call
    try:
        yield calls
    finally:
        pl.pallas_call = orig


def _run_once(fn, *args, n=None):
    """The scripts' `measure`, replaced: one run outside jit, no timing."""
    with jax.disable_jit():
        fn(*args)
    return 1.0


def _torch(x, dtype):
    """jax array -> CPU torch tensor of `dtype` (bf16 through fp32, exact)."""
    return torch.from_numpy(np.asarray(x, np.float32)).to(dtype)


def _check_mm(inputs, out, epilogue):
    dtype = torch.bfloat16 if epilogue == "bf16" else torch.int8
    a, b = (_torch(x, dtype) for x in inputs)
    got = probes.mm_probe(a, b, epilogue).float().numpy()
    want = np.asarray(out, np.float32)
    if epilogue == "bf16":
        assert rel_l2(got, want) < 1e-2
    else:  # exact integer sums; "scaled" rounds each once, as the JAX body
        np.testing.assert_array_equal(got, want)


def _small_gemm(mod, monkeypatch, ch):
    for name, value in dict(M=256, K=128, N=128, CH=ch).items():
        monkeypatch.setattr(mod, name, value)
    for name in ("BM", "BN"):
        if hasattr(mod, name):
            monkeypatch.setattr(mod, name, 128)
    monkeypatch.setattr(mod, "measure", _run_once)


def test_s1_mm_probe_matches_the_jax_script(monkeypatch, capsys):
    """S1: `main` of scripts/microbench_pallas_int8.py, bf16 and int8 (wrap)
    chains of 2, call by call; and the port's chain of the same length."""
    mod = _load("microbench_pallas_int8")
    _small_gemm(mod, monkeypatch, ch=2)
    with recorded_pallas_calls() as calls:
        mod.main()
    assert "Pallas bf16" in capsys.readouterr().out
    assert len(calls) == 4  # 2 bf16 then 2 int8
    for i, (inputs, out) in enumerate(calls):
        _check_mm(inputs, out, "bf16" if i < 2 else "int8")
    (a8, b8), _ = calls[2]
    got = microbench_int8.chained(_torch(a8, torch.int8), _torch(b8, torch.int8), "int8", 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(calls[3][1]))


class _LaxPythonLoop:
    """jax.lax with fori_loop as a Python loop, so a chain may change its
    carry's dtype (k_scaled: int8 in, bf16 out)."""

    @staticmethod
    def fori_loop(lo, hi, body, init):
        x = init
        for i in range(lo, hi):
            x = body(i, x)
        return x

    def __getattr__(self, name):
        return getattr(jax.lax, name)


class _JaxPythonLoop:
    lax = _LaxPythonLoop()

    def __getattr__(self, name):
        return getattr(jax, name)


@pytest.mark.parametrize("body,epilogue", [("k_requant", "requant"), ("k_scaled", "scaled"),
                                           ("k_bf16", "bf16")])
def test_s2_mm_probe_epilogues_match_the_jax_bodies(monkeypatch, body, epilogue):
    """S2: scripts/microbench_pallas_int8_variants.py's `build` on each body
    (the script's tiles are literals in `main`; the test builds 128 x 128)."""
    mod = _load("microbench_pallas_int8_variants")
    _small_gemm(mod, monkeypatch, ch=1 if body == "k_scaled" else 2)
    if body == "k_scaled":
        monkeypatch.setattr(mod, "jax", _JaxPythonLoop())
    rng = np.random.default_rng(5)
    a = rng.standard_normal((256, 128)).astype(np.float32)
    b = rng.standard_normal((128, 128)).astype(np.float32)
    if epilogue == "bf16":
        args = (jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16))
        out_dtype = jnp.bfloat16
    else:
        args = (jnp.asarray(a * 10).astype(jnp.int8), jnp.asarray(b * 10).astype(jnp.int8))
        out_dtype = jnp.bfloat16 if epilogue == "scaled" else jnp.int8
    with recorded_pallas_calls() as calls:
        _run_once(mod.build(128, 128, getattr(mod, body), out_dtype), *args)
    assert len(calls) == mod.CH
    for inputs, out in calls:
        _check_mm(inputs, out, epilogue)


def test_s3_dots_probe_matches_the_jax_script(monkeypatch, capsys):
    """S3: `dots_only` and `int8_dots_only` of scripts/bench_attn_blocks.py
    at B, N, L, D = 1, 2, 2048, 64 and CH = 1 (its blocks of 1024 need L a
    multiple of 1024); k8 arrives [D, L] there and [L, D] in the port."""
    mod = _load("bench_attn_blocks")
    for name, value in dict(B=1, N=2, L=2048, D=64, CH=1).items():
        monkeypatch.setattr(mod, name, value)
    monkeypatch.setattr(mod, "FLOPS", 4 * 2 * 2048 * 2048 * 64)
    monkeypatch.setattr(mod, "measure", _run_once)
    with recorded_pallas_calls() as calls:
        mod.dots_only()
        mod.int8_dots_only()
    assert "int8QK dots-only" in capsys.readouterr().out
    assert len(calls) == 2
    (h, _, _), want = calls[0]
    h = _torch(h, torch.bfloat16)
    got = bench_attn_blocks.dots_chain(h, 1)
    assert got.shape == (2, 2048, 64)
    assert rel_l2(got.float().numpy(), np.asarray(want, np.float32)) < 1e-2
    (q8, k8t, v), want = calls[1]
    k8 = _torch(k8t, torch.int8).transpose(1, 2).contiguous()
    got = probes.dots_probe(_torch(q8, torch.int8), k8, _torch(v, torch.bfloat16), int8=True)
    assert rel_l2(got.float().numpy(), np.asarray(want, np.float32)) < 1e-2


def test_int8_linear_chains_match_the_jax_script(monkeypatch, capsys):
    """scripts/microbench_int8.py (XLA GEMMs, no Pallas) at M, K, N = 64,
    64, 96 and CH = 2, its `measure` replaced by one eager run that records
    each chain's inputs and output; the port's three chains on the same
    inputs (weights in the nn.Linear layout, b = wb^T, c = wc^T): int8 and
    W8A8 equal bit for bit (integer sums, the same fp32 scale and bf16
    rounding), bf16 within rel-L2 1e-2 (fp32 sums in another order)."""
    mod = _load("microbench_int8")
    for name, value in dict(M=64, K=64, N=96, CH=2).items():
        monkeypatch.setattr(mod, name, value)
    runs = []

    def record(fn, *args):
        with jax.disable_jit():
            runs.append((args, fn(*args)))
        return 1.0

    monkeypatch.setattr(mod, "measure", record)
    mod.main()
    assert "XLA w8a8" in capsys.readouterr().out
    assert len(runs) == 3
    chains = (("bf16", microbench_int8_linear.chain_bf16, torch.bfloat16, torch.bfloat16),
              ("int8", microbench_int8_linear.chain_int8, torch.int8, torch.int8),
              ("w8a8", microbench_int8_linear.chain_w8a8, torch.bfloat16, torch.int8))
    for ((a, b, c), want), (name, chain, a_dtype, w_dtype) in zip(runs, chains):
        wb = _torch(b, w_dtype).t().contiguous()
        wc = _torch(c, w_dtype).t().contiguous()
        got = chain(_torch(a, a_dtype), wb, wc, 2).float().numpy()
        want = np.asarray(want, np.float32)
        assert got.shape == want.shape == (64, 64), name
        if name == "bf16":
            assert rel_l2(got, want) < 1e-2
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)


def test_probe_wrappers_check_their_inputs():
    a = torch.zeros((64, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        probes.mm_probe(a, a, "fp8")
    with pytest.raises(TypeError):
        probes.mm_probe(a, a, "int8")
    with pytest.raises(ValueError):
        probes.mm_probe(a, a[:32], "bf16")
    q = torch.zeros((2, 128, 64), dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        probes.dots_probe(q, q, q, int8=True)
    with pytest.raises(ValueError):
        probes.dots_probe(q, q[:, :64], q)


@pytest.mark.parametrize("epilogue", ["int8", "requant", "scaled"])
def test_mm_probe_plain_epilogues_are_exact(epilogue):
    """Sums beyond 2^24 stay exact and the int8 cast wraps (JAX
    `.astype(int8)` of int32); `requant` shifts arithmetically."""
    a = torch.full((16, 1536), 127, dtype=torch.int8)
    b = torch.full((1536, 16), -127, dtype=torch.int8)
    b[:, 1] = 127
    acc = torch.tensor([-1536 * 127 * 127, 1536 * 127 * 127], dtype=torch.int64)
    got = probes.mm_probe(a, b, epilogue)[0, :2]
    if epilogue == "int8":
        want = [((x + 128) % 256) - 128 for x in acc.tolist()]
        np.testing.assert_array_equal(got.numpy(), want)
        assert want != [-127, 127]
    elif epilogue == "requant":
        np.testing.assert_array_equal(got.numpy(), [-127, 127])
    else:
        want = (acc.to(torch.float32) * probes.SCALED_FACTOR).to(torch.bfloat16)
        assert torch.equal(got, want)


# --------------------------------------------------------------------------
# the host scripts' mains at tiny sizes on the CPU
# --------------------------------------------------------------------------


def test_bench_decode_overlap_main_on_the_cpu(capsys):
    """Monolithic and overlapped decodes of the tiny VAE: the same frames,
    one time per run."""
    from stableavatar_tpu_torch.scripts import bench_decode_overlap

    res = bench_decode_overlap.main(["--tiny", "--device", "cpu", "--latents", "5",
                                     "--size", "32", "--reps", "2"])
    assert res["equal"] and res["frames"] == 17
    assert len(res["monolithic_s"]) == len(res["overlapped_s"]) == 2
    assert "frames equal bit for bit: True" in capsys.readouterr().out


def test_bench_dit_step_main_on_the_cpu():
    """Every configuration of the JAX script runs one timed window-step of
    the tiny DiT; the launch table names the kernels of each route."""
    from stableavatar_tpu_torch.scripts import bench_dit_step

    names = list(bench_dit_step.VARIANTS)
    assert names == ["base", "rope", "rope_qk", "rope_qkpv", "w8a8", "full"]
    res = bench_dit_step.main([*names, "--tiny", "--device", "cpu", "--inner", "1",
                               "--size", "32", "--frames", "3"])
    assert list(res) == names
    assert all(r["forwards"] == 2 and r["s_per_step"] > 0 for r in res.values())
    assert bench_dit_step.launches_per_forward("base", 30) == {"flash_fwd_bf16": 90}
    assert bench_dit_step.launches_per_forward("full", 30) == {
        "flash_fwd_int8_qk": 30, "dual_context": 30}
    assert bench_dit_step.launches_per_forward("rope_qkpv", 2) == {
        "flash_fwd_int8_qkpv": 2, "dual_context": 2}


def test_profile_step_parts_main_on_the_cpu():
    from stableavatar_tpu_torch.scripts import profile_step_parts

    res = profile_step_parts.main(["--tiny", "--device", "cpu", "--grid", "3", "4", "4"])
    assert list(res) == list(profile_step_parts.PARTS)
    assert all(r["calls"] == 4 and r["ms_per_layer"] > 0 for r in res.values())


def test_quality_curves_main_on_the_cpu(tmp_path):
    """The smallest step lists on the tiny models: every row's PSNRs are
    numbers, the solver-sensitised DiT moves the latents (UniPC-2 is not
    the reference), the JSON holds the rows, and the DiT forwards counted
    are the window calls that TeaCache did not skip."""
    import json

    from stableavatar_tpu_torch.scripts import quality_curves

    out = tmp_path / "curves.json"
    res = quality_curves.main(["--small", "--tiny", "--device", "cpu", "--size", "32",
                               "--clip_frames", "9", "--overlap", "1", "--out", str(out)])
    rows = res["solver_curve"] + res["teacache_frontier"]
    assert [(r.get("solver"), r.get("steps")) for r in res["solver_curve"]] == [
        ("unipc", 2), ("unipc", 3), ("euler", 2)]
    assert [r["rel_l1_thresh"] for r in res["teacache_frontier"]] == [0.05]
    assert np.isfinite(res["solver_curve"][0]["psnr_latent"])
    assert all(r["psnr_latent"] > 0 and r["wall_s"] > 0 for r in rows)
    windows = 2
    skipped = round(res["teacache_frontier"][0]["skip_frac"] * 3 * windows)
    assert res["dit_forwards"] == windows * (3 + 3 + 2 + 3 + 2 + 3) - skipped
    assert json.loads(out.read_text())["dit_forwards"] == res["dit_forwards"]
