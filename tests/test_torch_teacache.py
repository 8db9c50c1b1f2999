"""The port's TeaCache (`models/teacache.py`, `dit_time_e0`,
`dit_forward_skip`, `dit_forward(return_residual=True)`,
`precompute_teacache_plan`) against the JAX package's, and `generate_long`
with TeaCache under Euler and UniPC against the JAX package's latents and
skip counts on the tiny models (the JAX side with XLA's excess precision
off, from the subprocess shared with tests/test_torch_pipeline.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stableavatar_tpu.models import dit as jdit
from stableavatar_tpu.models import teacache as jtc
from stableavatar_tpu.pipelines import long as jlong
from stableavatar_tpu_torch.models import dit as tdit
from stableavatar_tpu_torch.models import teacache as ttc
from stableavatar_tpu_torch.pipelines import long as tlong
from stableavatar_tpu_torch.utils.weights import dit_from_jax
from tests.test_torch_dit import CFG, _inputs
from tests.test_torch_pipeline import (  # noqa: F401 (fixtures)
    JAX_RUNS,
    jax_models,
    jax_runs,
    port_generate_long,
)
from tests.torch_parity import densify_dit, rel_l2, t, to_numpy_tree


@pytest.mark.parametrize("name", ["wan2.1-t2v-1.3b", "Wan2.1-T2V-14B", "wan2.1-i2v-14b-480p",
                                  "wan2.1-i2v-14b-720p", "stableavatar-1b", "other"])
def test_coefficients_equal(name):
    assert ttc.get_teacache_coefficients(name) == jtc.get_teacache_coefficients(name)


def _e0_steps(seed, steps, dtype):
    """A drifting e0 sequence [1, 6, 16] per step, as the time embedding
    drifts along the sigma ladder."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((1, 6, 16)).astype(np.float32)
    drift = rng.standard_normal((steps, 1, 6, 16)).astype(np.float32)
    e0 = [base + 0.03 * (i + 1) * drift[i] for i in range(steps)]
    return ([torch.from_numpy(x).to(dtype) for x in e0],
            [jnp.asarray(x, dtype=jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
             for x in e0])


@pytest.mark.parametrize("steps,windows,thresh,skip", [
    (10, 1, 0.1, 0), (10, 1, 0.3, 2), (5, 2, 0.3, 1), (6, 2, 0.05, 1), (12, 3, 0.2, 1),
    (8, 2, 0.0, 0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plan_and_decisions_equal(steps, windows, thresh, skip, dtype):
    """The controller's decisions call by call, and the canonicalised plan
    with its skip count, are equal for the same e0 sequence."""
    te0, je0 = _e0_steps(steps + windows, steps, dtype)
    coef = ttc.get_teacache_coefficients("wan2.1-t2v-1.3b")
    tc_t = ttc.TeaCache(coef, steps, rel_l1_thresh=thresh, num_skip_start_steps=skip)
    tc_j = jtc.TeaCache(coef, steps, rel_l1_thresh=thresh, num_skip_start_steps=skip)
    calls = [(i, w) for i in range(steps) for w in range(windows)]
    assert [tc_t.plan(te0[i], can_skip=n > 0) for n, (i, _) in enumerate(calls)] == \
        [tc_j.plan(je0[i], can_skip=n > 0) for n, (i, _) in enumerate(calls)]
    assert (tc_t.skipped_calls, tc_t.total_calls) == (tc_j.skipped_calls, tc_j.total_calls)
    tc_t.reset()
    tc_j.reset()
    plan = tlong.precompute_teacache_plan(tc_t, te0, windows)
    assert plan == jlong.precompute_teacache_plan(tc_j, je0, windows)
    assert tc_t.skipped_calls == tc_j.skipped_calls
    assert all(all(f) or not any(f) for f in plan)


def test_controller_rules():
    tc = ttc.TeaCache([0.0, 0.0, 0.0, 0.0, -1.0], num_steps=4, rel_l1_thresh=0.5)
    e0 = torch.ones((1, 6, 4))
    # forced compute on the first and last call of each cycle of num_steps
    assert [tc.plan(e0) for _ in range(8)] == [True, False, False, True] * 2
    assert tc.skipped_calls == 4
    with pytest.raises(ValueError):
        ttc.TeaCache([0.0], num_steps=0)
    with pytest.raises(ValueError):
        ttc.TeaCache([0.0], num_steps=3, rel_l1_thresh=-1.0)


@pytest.fixture(scope="module")
def jax_params():
    return densify_dit(jdit.init_dit(jax.random.PRNGKey(0), CFG))


def test_time_e0_matches_jax(jax_params):
    ts = np.array([999.0, 750.5, 10.0], np.float32)
    params = dit_from_jax(to_numpy_tree(jax_params))
    for dtype, jdtype, tol in ((torch.float32, jnp.float32, 2e-5),
                               (torch.bfloat16, jnp.bfloat16, 1e-2)):
        want = np.asarray(jdit.dit_time_e0(jax_params, CFG, jnp.asarray(ts), jdtype), np.float32)
        got = tdit.dit_time_e0(params, CFG, t(ts), dtype)
        assert got.dtype == dtype and got.shape == (3, 6, CFG.dim)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


def test_residual_and_skip_match_jax(jax_params):
    """dit_forward(return_residual=True) and dit_forward_skip in fp32 at the
    DiT parity tolerance (tests/test_torch_dit.py: 2e-4); replaying a
    forward's own residual gives that forward's output."""
    inputs = _inputs(9)
    jin = [jnp.asarray(x) for x in inputs]
    want_out, want_res = jdit.dit_forward(jax_params, CFG, *jin, video_sample_n_frames=17,
                                          return_residual=True)
    params = dit_from_jax(to_numpy_tree(jax_params))
    with torch.no_grad():
        out, res = tdit.dit_forward(params, CFG, *map(t, inputs), video_sample_n_frames=17,
                                    return_residual=True)
        skip = tdit.dit_forward_skip(params, CFG, t(inputs[0]), t(inputs[1]), t(inputs[4]),
                                     t(np.asarray(want_res)))
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(res.numpy(), np.asarray(want_res), rtol=2e-4, atol=2e-4)
    want_skip = jdit.dit_forward_skip(jax_params, CFG, jin[0], jin[1], jin[4], want_res)
    np.testing.assert_allclose(skip.numpy(), np.asarray(want_skip), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(skip.numpy(), out.numpy(), rtol=2e-4, atol=2e-4)


# Measured (my CPU run), latents after steps 1-5: Euler 1.4e-4 ... 2.4e-3,
# UniPC 1.4e-4 ... 8.6e-3 (the multistep extrapolation amplifies the bf16
# rounding differences, tests/test_torch_solvers.py)
TEACACHE_TOL = {"euler": 5e-3, "unipc": 1.5e-2}


@pytest.mark.parametrize("scheduler", ["euler", "unipc"])
def test_generate_long_teacache_matches_jax(jax_models, jax_runs, scheduler):
    """5 steps with TeaCache (JAX_RUNS["teacache-<scheduler>"]): equal skip
    counts, latents within TEACACHE_TOL."""
    want = jax_runs[f"teacache-{scheduler}"]
    got, steps, teacache = port_generate_long(jax_models, JAX_RUNS[f"teacache-{scheduler}"])
    assert teacache.skipped_calls == want["skipped"] == 4
    tol = TEACACHE_TOL[scheduler]
    for a, b in zip(steps, want["steps"]):
        assert rel_l2(a, b) < tol
    assert rel_l2(got.latents.numpy(), want["latents"]) < tol
    assert np.isfinite(got.videos).all()
