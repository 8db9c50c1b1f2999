"""The port's multistep solvers (`schedulers/fm_solvers.py`) against the JAX
package's: the host-side coefficient tables are equal, the fp32 tensor
updates agree on seeded arrays, and `generate_long` with DPM++ and UniPC
gives the JAX package's latents on the tiny models (the JAX side with XLA's
excess precision off, from the subprocess shared with
tests/test_torch_pipeline.py)."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest

from stableavatar_tpu.schedulers import fm_solvers as jfm
from stableavatar_tpu.schedulers.flow_match import flow_match_timesteps as jsched
from stableavatar_tpu_torch.schedulers import fm_solvers as tfm
from stableavatar_tpu_torch.schedulers.flow_match import flow_match_timesteps as tsched
from tests.test_torch_pipeline import (  # noqa: F401 (fixtures)
    JAX_RUNS,
    jax_models,
    jax_runs,
    port_generate_long,
)
from tests.torch_parity import rel_l2, t


def _as_floats(co):
    return {k: float(v) for k, v in co.items()}


@pytest.mark.parametrize("steps", [4, 10, 20])
def test_dpm_coefficients_equal(steps):
    js, ts = jsched(steps, shift=5.0), tsched(steps, shift=5.0)
    for order, kind, lof in itertools.product((1, 2, 3), ("midpoint", "heun"), (True, False)):
        for i in range(steps):
            assert tfm.dpm_effective_order(i, steps, order, lof) == \
                jfm.dpm_effective_order(i, steps, order, lof)
            assert tfm.dpm_coeffs(ts, i, order, kind, lof) == \
                _as_floats(jfm.dpm_coeffs(js, i, order, kind, lof)), (order, kind, i)


@pytest.mark.parametrize("steps", [4, 10, 20])
def test_unipc_coefficients_equal(steps):
    js, ts = jsched(steps, shift=5.0), tsched(steps, shift=5.0)
    for order, kind, corrector in itertools.product((1, 2, 3), ("bh1", "bh2"), (True, False)):
        jprev = tprev = 1
        for i in range(steps):
            jco, jprev = jfm.unipc_coeffs(js, i, order, jprev, kind, corrector)
            tco, tprev = tfm.unipc_coeffs(ts, i, order, tprev, kind, corrector)
            assert tprev == jprev
            assert tco == _as_floats(jco), (order, kind, corrector, i)


def test_sigma_helpers_equal():
    np.testing.assert_array_equal(tfm.get_sampling_sigmas(12, 5.0),
                                  jfm.get_sampling_sigmas(12, 5.0))
    sig = np.concatenate([np.linspace(1.0, 0.05, 8), [0.0]]).astype(np.float32)
    a, b = tfm._make_sched(8, 5.0, sig), jfm._make_sched(8, 5.0, sig)
    np.testing.assert_array_equal(a.sigmas, np.asarray(b.sigmas))
    np.testing.assert_array_equal(a.timesteps, np.asarray(b.timesteps))


def _arrays(seed, n, shape=(1, 4, 3, 8, 8)):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def test_apply_updates_match_jax():
    """dpm_apply / unipc_apply with every coefficient set of a 10-step
    order-3 ladder on seeded fp32 arrays (rtol 1e-6: the same fp32 ops in
    the same order)."""
    sched = tsched(10, shift=5.0)
    sample, v, p1, p2, p3, last = _arrays(0, 6)
    prev = 1
    for i in range(10):
        co = tfm.dpm_coeffs(sched, i, 3)
        got = tfm.dpm_apply(t(sample), t(v), sched.sigmas[i], t(p1), t(p2), **co)
        want = jfm.dpm_apply(jnp.asarray(sample), jnp.asarray(v), sched.sigmas[i],
                             jnp.asarray(p1), jnp.asarray(p2),
                             **{k: jnp.float32(x) for k, x in co.items()})
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
        co, prev = tfm.unipc_coeffs(sched, i, 3, prev)
        got = tfm.unipc_apply(t(sample), t(v), sched.sigmas[i], t(p1), t(p2), t(last),
                              x0_prev3=t(p3), **co)
        want = jfm.unipc_apply(jnp.asarray(sample), jnp.asarray(v), sched.sigmas[i],
                               jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(last),
                               x0_prev3=jnp.asarray(p3),
                               **{k: jnp.float32(x) for k, x in co.items()})
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("solver", ["dpm", "unipc"])
def test_solver_classes_match_jax(solver):
    """Eight steps of the stateful solver classes on a fixed velocity
    field v = x - target (rtol 1e-5 over the chained fp32 updates)."""
    target, x0 = _arrays(1, 2)
    kw = dict(order=3, solver_type="heun" if solver == "dpm" else "bh1")
    tcls, jcls = ((tfm.FlowDPMSolverMultistep, jfm.FlowDPMSolverMultistep) if solver == "dpm"
                  else (tfm.FlowUniPCMultistep, jfm.FlowUniPCMultistep))
    ts, js = tcls(8, **kw), jcls(8, **kw)
    tx, jx = t(x0), jnp.asarray(x0)
    tstate, jstate = tfm.MultistepState(), jfm.MultistepState()
    for i in range(8):
        tx, tstate = ts.step(tx - t(target), i, tx, tstate)
        jx, jstate = js.step(jx - jnp.asarray(target), i, jx, jstate)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-5, atol=1e-5)
    assert tstate.prev_order == getattr(jstate, "prev_order", tstate.prev_order)


# Measured (my CPU run): 3e-5 / 4.7e-3 / 3.8e-3 (DPM++) and 3e-5 / 4.3e-3 /
# 3.4e-3 (UniPC) after steps 1-3.  The multistep extrapolation amplifies the
# two sides' bf16 rounding differences several times over the Euler
# path's (a 1e-3 perturbation of the initial latents grows 5x more under
# UniPC than under Euler by step 3 of 4).
MULTISTEP_TOL = 1e-2


@pytest.mark.parametrize("name", ["dpm++", "unipc"])
def test_generate_long_multistep_matches_jax(jax_models, jax_runs, name):
    """3 steps of JAX_RUNS[name] against the JAX package's latents."""
    want = jax_runs[name]
    got, steps, _ = port_generate_long(jax_models, JAX_RUNS[name])
    assert len(steps) == len(want["steps"]) == 3
    for a, b in zip(steps, want["steps"]):
        assert rel_l2(a, b) < MULTISTEP_TOL
    assert rel_l2(got.latents.numpy(), want["latents"]) < MULTISTEP_TOL
    assert got.videos.shape == (1, 3, 13, 32, 32) and np.isfinite(got.videos).all()

