"""The port's multi-process inference (`stableavatar_tpu_torch/parallel/`,
`ops/ring_attention.py`, the sequence-parallel DiT and the CLI) on the CPU:
gloo process groups of spawned ranks, no GPU.

One spawn of 4 ranks computes every world-4 case (meshes of dp x fsdp x sp
over the same 4 ranks, so sp=2 cases run as two dp replicas) and one spawn
of 2 ranks drives the CLI; rank 0 hands the results back through a pickle
and the tests below compare them.  Tolerances are the JAX package's
(tests/test_sharding.py): ring attention rtol 2e-4 / atol 2e-5 against the
JAX ring under shard_map, DiT forwards rtol / atol 2e-3 and generate_long
latents rtol 2e-3 / atol 2e-4 against the port's one-process run; the
int8 ring, whose slab scales are per chunk, at rel-L2 2e-2.  The token
count of every DiT case (3 latent frames of 16 tokens) splits a latent frame
between ranks.
"""

import dataclasses
import os
import pickle
import socket
import tempfile
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from stableavatar_tpu_torch.config import tiny_debug_configs
from stableavatar_tpu_torch.models import dit as tdit
from stableavatar_tpu_torch.ops.ring_attention import ring_attention
from stableavatar_tpu_torch.parallel import sharding
from stableavatar_tpu_torch.parallel.mesh import make_mesh, mesh_context
from stableavatar_tpu_torch.parallel.sharding import Shard, shard_params
from stableavatar_tpu_torch.pipelines.common import WanModels
from stableavatar_tpu_torch.pipelines.long import generate_long
from stableavatar_tpu_torch.utils.fastpath import prepare_fast_params

RING_SHAPE = (2, 64, 2, 16)  # b, l, n, d: 16 tokens per rank at W = 4
# a spawn that has not ended by then (a collective that never completes) is
# killed and fails its tests, well inside the suite's time limit
SPAWN_TIMEOUT_S = 240


# --------------------------------------------------------------------------
# spawning
# --------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_entry(rank, world, port, name, out_path, init_group):
    torch.set_num_threads(2)
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    if init_group:
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                world_size=world, rank=rank)
    try:
        result = globals()[name](rank)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    if rank == 0:
        with open(out_path, "wb") as f:
            pickle.dump(result, f)


def spawn(name: str, world: int, init_group: bool = True):
    """Run the module function `name(rank)` on `world` spawned ranks (a gloo
    group unless `init_group` is False) and return rank 0's result."""
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "result.pkl")
        ctx = mp.spawn(_rank_entry, args=(world, _free_port(), name, out, init_group),
                       nprocs=world, join=False)
        deadline = time.monotonic() + SPAWN_TIMEOUT_S
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                for proc in ctx.processes:
                    proc.kill()
                raise TimeoutError(f"{name} on {world} ranks did not end in {SPAWN_TIMEOUT_S} s")
        with open(out, "rb") as f:
            return pickle.load(f)


# --------------------------------------------------------------------------
# the world-4 cases
# --------------------------------------------------------------------------


def _ring_inputs():
    rng = np.random.default_rng(0)
    return [rng.standard_normal(RING_SHAPE).astype(np.float32) for _ in range(3)]


def _gather_rows(x, group=None):
    """All ranks' [B, L/W, ...] slices, concatenated on dim 1."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=1)


def _tiny_dit():
    """The tiny DiT (tests/test_pipeline.py's DIT_E2E widths) with random
    head and vocal k/v weights, and one CFG-tripled window of 3 latent
    frames at 8 x 8 (48 tokens, 16 per frame)."""
    cfg = tiny_debug_configs()[0]
    gen = torch.Generator().manual_seed(0)
    params = tdit.init_dit(gen, cfg, "cpu")
    params["head"]["head"]["w"] = torch.randn(params["head"]["head"]["w"].shape, generator=gen) * 0.05
    for bp in params["blocks"]:
        for name in ("k_vocal", "v_vocal"):
            node = bp["cross_attn"][name]
            node["w"] = torch.randn(node["w"].shape, generator=gen) * 0.1
    rng = np.random.default_rng(4)
    f, h, w = 3, 8, 8
    args = tuple(torch.from_numpy(a) for a in (
        rng.standard_normal((3, cfg.out_dim, f, h, w)).astype(np.float32),
        np.full((3,), 500.0, np.float32),
        rng.standard_normal((3, cfg.text_len, cfg.text_dim)).astype(np.float32),
        rng.standard_normal((3, cfg.clip_tokens, cfg.clip_dim)).astype(np.float32),
        rng.standard_normal((3, cfg.in_dim - cfg.out_dim, f, h, w)).astype(np.float32),
        rng.standard_normal((1, 24, cfg.audio_in_dim)).astype(np.float32)))
    return cfg, params, args, dict(video_sample_n_frames=9, vocal_cfg_tile=True)


# name: (dp, fsdp, sp, attn_impl, fast path)
DIT_CASES = {
    "ulysses-sp2": (2, 1, 2, "ulysses", False),
    "ring-sp2": (2, 1, 2, "ring", False),
    "ring-sp4": (1, 1, 4, "ring", False),
    "fsdp2-sp2": (1, 2, 2, "ulysses", False),
    "fsdp2-sp2-w8a8-qk": (1, 2, 2, "ulysses", True),
}


def _tiny_models(dit_params, cfg):
    from stableavatar_tpu_torch.models.clip import init_clip_visual
    from stableavatar_tpu_torch.models.vae import init_vae
    from stableavatar_tpu_torch.models.wav2vec import init_wav2vec2

    _, vae_cfg, _, clip_cfg, w2v_cfg = tiny_debug_configs()
    gen = torch.Generator().manual_seed(1)
    return WanModels(dit_params=dit_params, dit_cfg=cfg, vae_params=init_vae(gen, vae_cfg, "cpu"),
                     vae_cfg=vae_cfg, clip_params=init_clip_visual(gen, clip_cfg, "cpu"),
                     clip_cfg=clip_cfg, wav2vec_params=init_wav2vec2(gen, w2v_cfg, "cpu"),
                     wav2vec_cfg=w2v_cfg, device="cpu")


def _pipeline_kwargs(cfg):
    rng = np.random.default_rng(5)
    # 14 video frames -> 4 latent frames: 3-frame windows (0, 3), (1, 4)
    return dict(ref_image=rng.uniform(-1, 1, (1, 3, 32, 32)).astype(np.float32),
                vocal_waveform=rng.standard_normal(14 * 640).astype(np.float32) * 0.1,
                text_ctx=torch.from_numpy(rng.standard_normal(
                    (3, cfg.text_len, cfg.text_dim)).astype(np.float32)),
                num_inference_steps=2, clip_length=9, overlap_window_length=1, seed=4,
                output_type="latent")


def world4_cases(rank):
    res = {}
    # ring attention over 4 ranks, fp32, quant="none"
    mesh = make_mesh(1, 1, 4, device_type="cpu")
    w = RING_SHAPE[1] // 4
    q, k, v = (torch.from_numpy(a[:, rank * w:(rank + 1) * w]) for a in _ring_inputs())
    out = ring_attention(q, k, v, group=mesh.get_group("sp"))
    res["ring"] = _gather_rows(out).numpy()
    qg = q.clone().requires_grad_()
    try:
        ring_attention(qg, k, v, group=mesh.get_group("sp")).sum().backward()
        res["ring_backward"] = None
    except NotImplementedError as e:
        res["ring_backward"] = str(e)

    # the DiT forward on each mesh against the one-process forward
    sharding._MIN_SHARD_SIZE = 16  # split the tiny matrices too
    cfg, params, args, kw = _tiny_dit()
    fast_params = prepare_fast_params(params, cfg, quant=True)
    fast_kw = dict(kw, rope_split=True, attn_quant="qk")
    with torch.no_grad():
        res["dit_want"] = tdit.dit_forward(params, cfg, *args, **kw).numpy()
        res["dit_want_fast"] = tdit.dit_forward(fast_params, cfg, *args, **fast_kw).numpy()
        for name, (dp, fsdp, sp, impl, fast) in DIT_CASES.items():
            mesh = make_mesh(dp, fsdp, sp, device_type="cpu")
            with mesh_context(mesh):
                p = shard_params(fast_params if fast else params, mesh)
                shards = [x for x in _leaves(p) if isinstance(x, Shard)]
                got = tdit.dit_forward(p, cfg, *args, **(fast_kw if fast else kw),
                                       attn_impl=impl)
            res[name] = (got.numpy(), len(shards), sorted({str(x.local.dtype) for x in shards}))

    # generate_long: fsdp 2 x sp 2 (Ulysses), and the int8 ring with W8A8
    models = _tiny_models(params, cfg)
    fast_models = dataclasses.replace(models, dit_params=fast_params, rope_split=True,
                                      attn_quant="qk", attn_impl="ring")
    kwargs = _pipeline_kwargs(cfg)
    mesh = make_mesh(1, 2, 2, device_type="cpu")
    for name, m in (("pipeline", models), ("pipeline-ring-qk", fast_models)):
        res[name + "_want"] = generate_long(m, **kwargs).latents.numpy()
        with mesh_context(mesh):
            sharded = dataclasses.replace(m, dit_params=shard_params(m.dit_params, mesh))
            res[name] = generate_long(sharded, **kwargs).latents.numpy()
    return res


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


@pytest.fixture(scope="module")
def world4():
    return spawn("world4_cases", 4)


# --------------------------------------------------------------------------
# the tests
# --------------------------------------------------------------------------


@pytest.mark.parametrize("shape,fsdp", [((4096, 256), 4), ((16,), 4), ((4097, 333), 4),
                                        ((333, 4096), 4), ((1536, 8960), 8), ((5120,), 8),
                                        ((30, 1536, 1536), 4), ((4096, 256), 1)])
def test_param_sharding_spec_matches_jax(shape, fsdp):
    """The JAX rule (tests/test_sharding.py:66-76 and more): the axis the
    JAX PartitionSpec names 'fsdp', or None where it replicates."""
    import jax.numpy as jnp

    from stableavatar_tpu.parallel.sharding import param_sharding_spec as jspec

    want = jspec(jnp.zeros(shape, jnp.int8), fsdp)
    axis = [i for i, s in enumerate(want) if s == "fsdp"]
    assert sharding.param_sharding_spec(torch.zeros(shape, dtype=torch.int8), fsdp) == \
        (axis[0] if axis else None)


def test_ring_attention_matches_jax_ring(world4):
    """W = 4, fp32, quant="none": the port's ring against the JAX ring under
    shard_map on 4 virtual CPU devices (tests/test_sharding.py:80-106)."""
    from functools import partial

    import jax
    import jax.numpy as jnp
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P

    from stableavatar_tpu.ops.ring_attention import ring_attention as jring
    from stableavatar_tpu.parallel.mesh import make_mesh as jmesh

    fn = shard_map(partial(jring, axis_name="sp"), mesh=jmesh(dp=1, fsdp=1, sp=4),
                   in_specs=(P(None, "sp"),) * 3, out_specs=P(None, "sp"))
    want = np.asarray(jax.jit(fn)(*map(jnp.asarray, _ring_inputs())))
    np.testing.assert_allclose(world4["ring"], want, rtol=2e-4, atol=2e-5)


def test_ring_backward_raises(world4):
    assert world4["ring_backward"] is not None and "no backward" in world4["ring_backward"]


@pytest.mark.parametrize("case", list(DIT_CASES))
def test_sequence_parallel_dit_matches_one_process(world4, case):
    got, n_shards, dtypes = world4[case]
    want = world4["dit_want_fast" if DIT_CASES[case][4] else "dit_want"]
    assert got.shape == want.shape == (3, 4, 3, 8, 8)
    assert np.abs(want).max() > 1e-2  # the head and vocal weights are live
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
    if DIT_CASES[case][1] > 1:  # fsdp: the block matrices were split
        assert n_shards > 0
        if DIT_CASES[case][4]:
            assert "torch.int8" in dtypes  # the W8A8 weights too
    else:
        assert n_shards == 0


def test_generate_long_fsdp_sp_matches_one_process(world4):
    """fsdp 2 x sp 2, Ulysses, bf16 sweep (tests/test_sharding.py:313-343)."""
    got, want = world4["pipeline"], world4["pipeline_want"]
    assert got.shape == want.shape == (1, 4, 4, 8, 8) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-4)


def test_generate_long_int8_ring_matches_one_process(world4):
    """fsdp 2 x sp 2 with the ring and the W8A8 / int8-QK fast path: the
    ring quantises each K chunk on its own slab scale, so the latents differ
    from the one-process run at the int8 level."""
    got, want = world4["pipeline-ring-qk"], world4["pipeline-ring-qk_want"]
    assert np.isfinite(got).all()
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= 2e-2, rel


def test_sequence_parallel_degrees_must_divide():
    """Tokens that W does not divide (ring and Ulysses) and heads that it
    does not divide (Ulysses) raise, naming the constraint."""
    cfg = tiny_debug_configs()[0]

    class FakeMesh:
        def __init__(self, sp):
            self.sp = sp

        def size(self, i):
            return self.sp if i == 2 else 1

    with mesh_context(FakeMesh(3)):
        with pytest.raises(ValueError, match="multiple of 3: 50 tokens"):
            tdit._sp_check(cfg, 48 + 2, "ring")
        assert tdit._sp_check(cfg, 48, "ring") == 3
        with pytest.raises(ValueError, match="head count to be a multiple of 3"):
            tdit._sp_check(cfg, 48, "ulysses")
    with pytest.raises(ValueError, match="unknown attn_impl"):
        tdit._sp_check(cfg, 48, "xfuser")
    assert tdit._sp_check(cfg, 47, "ulysses") is None  # no mesh: one rank


# --------------------------------------------------------------------------
# the CLI on 2 ranks
# --------------------------------------------------------------------------


def cli_runs(rank):
    """The CLI's main on each rank (its own process group from torchrun's
    variables), once with --ulysses_degree 2 and once with --ring_degree 2;
    each rank gets its own output directory."""
    from stableavatar_tpu_torch.cli import inference as tcli

    base = os.environ["SA_TEST_DIR"]
    os.environ["STABLEAVATAR_TINY"] = "1"
    out = {}
    for flag in ("--ulysses_degree", "--ring_degree"):
        outdir = os.path.join(base, flag.strip("-"), f"rank{rank}")
        rc = tcli.main(["--validation_reference_path", os.path.join(base, "ref.png"),
                        "--validation_driven_audio_path", os.path.join(base, "voice.wav"),
                        "--width", "32", "--height", "32", "--sample_steps", "2",
                        "--clip_sample_n_frames", "9", "--overlap_window_length", "1",
                        "--fast_path", "linears", flag, "2", "--output_dir", outdir],
                       device="cpu")
        out[flag] = (rc, dist.is_initialized())
        os.environ["MASTER_PORT"] = str(int(os.environ["MASTER_PORT"]) + 1)
    return out


def test_cli_main_on_two_ranks(tmp_path, monkeypatch):
    from PIL import Image

    from stableavatar_tpu_torch.utils.media import save_wav

    img = np.random.default_rng(0).uniform(0, 255, (64, 64, 3)).astype(np.uint8)
    Image.fromarray(img).save(tmp_path / "ref.png")
    t = np.arange(16000) / 16000.0
    save_wav(str(tmp_path / "voice.wav"), (0.3 * np.sin(2 * np.pi * 220 * t)).astype(np.float32),
             16000)
    monkeypatch.setenv("SA_TEST_DIR", str(tmp_path))
    result = spawn("cli_runs", 2, init_group=False)
    for flag in ("ulysses_degree", "ring_degree"):
        rc, still_running = result[f"--{flag}"]
        assert rc == 0 and not still_running  # main ended the group it started
        produced = os.listdir(tmp_path / flag / "rank0")
        assert any(p.endswith(".mp4") or len(os.listdir(tmp_path / flag / "rank0" / p)) == 25
                   for p in produced), produced
        assert not (tmp_path / flag / "rank1").exists()  # rank 0 alone writes


def test_initialize_distributed_without_coordinator_is_a_noop(monkeypatch):
    """No coordinator flag and no torchrun variables: one process, no group
    (the JAX function's no-op); incomplete information raises."""
    from stableavatar_tpu_torch.parallel import distributed as tdist

    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert tdist.initialize_distributed(device="cpu") is False
    assert not dist.is_initialized()
    assert tdist.local_batch_slice(6) == slice(0, 6)
    with pytest.raises(RuntimeError, match="initialised process group"):
        make_mesh(1, 1, 2, device_type="cpu")
    with pytest.raises(ValueError, match="number of processes"):
        tdist.initialize_distributed("localhost:29400", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tdist.initialize_distributed("localhost:29400", 2, 0)
