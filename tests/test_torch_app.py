"""The port's serving app (`stableavatar_tpu_torch/cli/app.py` on
`utils/gradio_shim.py`), mirroring tests/test_app_ui.py: the three-tab
contract, a Generate click whose latents and frames match the JAX app's
(the tiny models of tests/test_pipeline.py:make_tiny_models with a random
head and vocal projections, through the bridge, the same initial noise on
both sides, the JAX side with XLA's excess precision off), the streaming writer, the HTTP / MCP server with concurrent requests,
and a server's model loading, which keeps umT5 for per-request prompts."""

import dataclasses
import json
import os
import threading
import time
import urllib.request
import wave
from unittest import mock
from urllib.parse import quote

import numpy as np
import pytest
import torch

from stableavatar_tpu_torch.cli import app as tapp
from stableavatar_tpu_torch.pipelines import long as tlong
from stableavatar_tpu_torch.pipelines.common import WanModels
from stableavatar_tpu_torch.utils.fastpath import prepare_fast_params
from stableavatar_tpu_torch.utils.weights import dit_from_jax, from_jax_tree, t5_from_jax
from tests.test_pipeline import CLIP_E2E, DIT_E2E, T5_E2E, VAE_E2E, W2V_E2E
from tests.test_torch_pipeline import LATENT_TOL, randomize_velocity, run_jax_exact
from tests.torch_parity import rel_l2

GENERATE = "Generate 生成"
SIZE, CLIP, OVERLAP, SEED = 32, 9, 1, 7
# the click's knobs, none at the UI's default: a wrong or dropped one moves
# the latents
STEPS, CFG_T, CFG_A = 4, 4.5, 2.0
PROMPT, NEGATIVE = "a person talking", "blurry, static"
N_FRAMES = 18  # video frames of audio: infer_length 5, windows (0, 3), (2, 5)


def _tok(prompt):
    """make_tiny_models' tokenizer (tests/test_pipeline.py:114)."""
    ids = np.zeros(16, dtype=np.int32)
    mask = np.zeros(16, dtype=np.int32)
    toks = [ord(c) % 60 for c in prompt][:15]
    ids[: len(toks)] = toks
    ids[len(toks)] = 1
    mask[: len(toks) + 1] = 1
    return ids, mask


def _noise():
    """The initial latents both apps start from: [1, z, infer_length, h, w]."""
    rng = np.random.default_rng(3)
    return rng.standard_normal((1, VAE_E2E.z_dim, 5, SIZE // 4, SIZE // 4)).astype(np.float32)


def write_inputs(d):
    """A 32x32 reference image and an 18-frame 16 kHz voice under `d`."""
    from PIL import Image

    img_path, wav_path = os.path.join(d, "ref.png"), os.path.join(d, "voice.wav")
    rng = np.random.default_rng(0)
    Image.fromarray(rng.integers(0, 255, (SIZE, SIZE, 3), np.uint8)).save(img_path)
    w = (0.2 * np.sin(2 * np.pi * 220 * np.arange(N_FRAMES * 640) / 16000)).astype(np.float32)
    with wave.open(wav_path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(16000)
        f.writeframes((w * 32767).astype(np.int16).tobytes())
    return img_path, wav_path


def gen_values(demo, img_path, wav_path, seed=SEED, solver="euler"):
    """The Generate click's 19 values, in the UI's input order."""
    vals = demo.default_inputs(GENERATE)
    # [image, audio, prompt, negative, width, height, clip_frames, steps,
    #  solver, cfg_t, cfg_a, overlap, scheme, fps, memory_mode, motion,
    #  tc_thresh, tc_skip, seed]
    vals[0], vals[1] = img_path, wav_path
    vals[2], vals[3] = PROMPT, NEGATIVE
    vals[4] = vals[5] = SIZE
    vals[6], vals[7], vals[8], vals[11], vals[18] = CLIP, STEPS, solver, OVERLAP, seed
    vals[9], vals[10] = CFG_T, CFG_A
    return vals


def read_frames(path):
    """The frames an app wrote: a PNG frame directory [T, H, W, 3] uint8."""
    from PIL import Image

    assert os.path.isdir(path), path  # no ffmpeg video backend on this host
    names = sorted(os.listdir(path))
    return np.stack([np.asarray(Image.open(os.path.join(path, n)).convert("RGB"))
                     for n in names])


def jax_app_frames(noise):
    """In the JAX subprocess: the JAX app's Generate click (bf16 and the
    fast path, from `noise`), its final latents, the frames it wrote read
    back, and the tiny models as numpy trees."""
    import tempfile

    import jax

    from stableavatar_tpu.cli import app as japp
    from stableavatar_tpu.pipelines import long as jlong
    from stableavatar_tpu.utils.fastpath import prepare_fast_params as jprepare
    from tests.test_pipeline import make_tiny_models
    from tests.torch_parity import pallas_k5, to_numpy_tree

    models = make_tiny_models()
    randomize_velocity(models.dit_params)
    out = {"models": to_numpy_tree({"dit": models.dit_params, "vae": models.vae_params,
                                    "t5": models.t5_params, "clip": models.clip_params,
                                    "w2v": models.wav2vec_params})}
    gen, latents = jlong.generate_long, []

    def from_noise(*a, **k):
        res = gen(*a, initial_latents=noise, **k)
        latents.append(np.asarray(res.latents))
        return res

    with tempfile.TemporaryDirectory() as d, \
            mock.patch.object(jlong, "generate_long", from_noise):
        img_path, wav_path = write_inputs(d)
        for fast in (False, True):
            m = models if not fast else dataclasses.replace(
                models, dit_params=jprepare(models.dit_params, DIT_E2E, quant=True),
                rope_split=True, attn_quant="qk")
            service = japp.AvatarService(m, output_dir=os.path.join(d, f"out{fast}"))
            demo = japp.build_ui(service)
            with pallas_k5() if fast else mock.patch.dict(os.environ, {}):
                video, seed = demo.dispatch(GENERATE, gen_values(demo, img_path, wav_path))
            out[fast] = (latents.pop(), read_frames(video), seed)
    jax.clear_caches()
    return out


@pytest.fixture(scope="module")
def jax_app():
    return run_jax_exact(jax_app_frames, noise=_noise())


def port_models(jm, fast=False):
    dit = dit_from_jax(jm["dit"])
    return WanModels(
        dit_params=prepare_fast_params(dit, DIT_E2E, quant=True) if fast else dit,
        dit_cfg=DIT_E2E, vae_params=from_jax_tree(jm["vae"]), vae_cfg=VAE_E2E,
        t5_params=t5_from_jax(jm["t5"]), t5_cfg=T5_E2E,
        clip_params=from_jax_tree(jm["clip"]), clip_cfg=CLIP_E2E,
        wav2vec_params=from_jax_tree(jm["w2v"]), wav2vec_cfg=W2V_E2E, tokenizer=_tok,
        rope_split=fast, attn_quant="qk" if fast else "none", device="cpu")


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return write_inputs(str(tmp_path_factory.mktemp("app_in")))


@pytest.fixture
def from_noise():
    """The port's generate_long from the tests' initial noise."""
    gen = tlong.generate_long
    with mock.patch.object(tlong, "generate_long",
                           lambda *a, **k: gen(*a, initial_latents=_noise(), **k)):
        yield


@pytest.fixture(scope="module")
def service(jax_app, tmp_path_factory):
    return tapp.AvatarService(port_models(jax_app["models"]),
                              output_dir=str(tmp_path_factory.mktemp("app_out")))


def test_build_ui_three_tab_contract(service):
    from stableavatar_tpu.cli.app import AvatarService as JService, build_ui as jbuild

    demo = tapp.build_ui(service)
    assert [t.label for t in demo.tabs] == [
        "Avatar Generation 数字人生成", "Audio Extraction 音频提取", "Vocal Separation 人声分离"]
    assert [e["name"] for e in demo.events] == [GENERATE, "Extract", "Separate"]
    gen = demo.events[0]
    assert len(gen["inputs"]) == 19 and len(gen["outputs"]) == 2
    # the same components, labels and defaults as the JAX app's UI
    jdemo = jbuild(JService(None, output_dir=service.output_dir))
    for ev, jev in zip(demo.events, jdemo.events):
        assert [(type(c).__name__, c.label, c.value) for c in ev["inputs"] + ev["outputs"]] \
            == [(type(c).__name__, c.label, c.value) for c in jev["inputs"] + jev["outputs"]]


# The click's final latents against the JAX app's: bf16 at the pipeline's
# LATENT_TOL; the fast path, whose latents match to a few bf16 last bits,
# at 1e-4.  Dropping the negative prompt moves the bf16 latents by 7e-3,
# swapping the two scales by 0.45.  (At 3 steps the bf16 gap is 5e-3: XLA's
# fp32 sin / cos differ from torch's in the last bit on a few entries of
# the timestep embedding at t = 834.71, e0's bf16 rounding keeps a few of
# those, and the step to sigma 0.024 under guidance multiplies them.)
APP_LATENT_TOL = {False: LATENT_TOL[False], True: 1e-4}


def _grid(segments):
    """The decoder's uint8 segments as the frames a writer stores."""
    return np.concatenate([s.numpy() for s in segments], axis=2)[0].transpose(1, 2, 3, 0)


@pytest.mark.parametrize("fast", [False, True])
def test_generate_click_frames_equal_jax(jax_app, inputs, tmp_path, fast):
    """A Generate click with every knob off its default (steps, both
    guidance scales, a negative prompt) gives the JAX app's final latents
    within APP_LATENT_TOL, and writes exactly the frames of its own
    latents; on the JAX app's latents the port's decoder gives the JAX
    app's frames within 1/255 (the decode stage's bound in
    tests/test_torch_pipeline.py), so the written frames follow the app's
    latents through an equal decode.  On the fast path the written frames
    are the JAX app's within 1/255."""
    from stableavatar_tpu_torch.models.vae import decode_video_segmented

    models = port_models(jax_app["models"], fast)
    svc = tapp.AvatarService(models, output_dir=str(tmp_path))
    demo = tapp.build_ui(svc)
    gen, latents = tlong.generate_long, []

    def from_noise(*a, **k):
        res = gen(*a, initial_latents=_noise(), **k)
        latents.append(res.latents)
        return res

    with mock.patch.object(tlong, "generate_long", from_noise):
        video, used_seed = demo.dispatch(GENERATE, gen_values(demo, *inputs))
    assert used_seed == SEED and demo.events[0]["outputs"][0].value == video
    want_lat, want, jseed = jax_app[fast]
    assert jseed == SEED
    (got_lat,) = latents
    assert rel_l2(got_lat.numpy(), want_lat) < APP_LATENT_TOL[fast]
    got = read_frames(video)
    assert got.shape == want.shape == (1 + 4 * 4, SIZE, SIZE, 3)

    def decode(lat):
        return _grid(decode_video_segmented(models.vae_params, lat.to(torch.bfloat16),
                                            models.vae_cfg, out_uint8=True))

    np.testing.assert_array_equal(got, decode(got_lat))
    diff = np.abs(decode(torch.from_numpy(want_lat)).astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1
    if fast:  # the latents are the JAX app's to a few last bits: so are the frames
        assert np.abs(got.astype(np.int16) - want.astype(np.int16)).max() <= 1


def test_generate_unipc_streaming_equals_the_whole_video(service, inputs, from_noise):
    """generate(sample_solver="unipc", stream_output=True) writes through
    the streaming writer the frames that the one-piece path writes: no
    segment reordered or dropped by the overlapped decode."""
    kw = dict(width=SIZE, height=SIZE, num_inference_steps=3, clip_length=CLIP,
              overlap_window_length=OVERLAP, sample_solver="unipc")
    streamed, seed, _ = service.generate(*inputs, "a person talking", "", seed_param=11,
                                         stream_output=True, **kw)
    assert seed == 11 and os.listdir(streamed)
    frames = read_frames(streamed)
    whole, _, _ = service.generate(*inputs, "a person talking", "", seed_param=12,
                                   stream_output=False, **kw)
    np.testing.assert_array_equal(frames, read_frames(whole))


def _post(base, name, values, timeout=600):
    req = urllib.request.Request(base + quote(f"/api/{name}"),
                                 data=json.dumps({"data": values}).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    return json.loads(urllib.request.urlopen(req, timeout=timeout).read())


def test_launch_serves_http_mcp_and_concurrent_requests(service, inputs, from_noise):
    """launch(mcp_server=True): the page, the MCP tool list and POST /api;
    two concurrent POSTs each get their own seed and video, and the
    service's lock runs their generations one after the other."""
    demo = tapp.build_ui(service)
    demo.launch(server_name="127.0.0.1", server_port=0, mcp_server=True,
                prevent_thread_lock=True)
    active, overlaps = [0], []
    gen = tlong.generate_long

    def watched(*a, **k):
        active[0] += 1
        overlaps.append(active[0])
        try:
            time.sleep(0.2)
            return gen(*a, **k)
        finally:
            active[0] -= 1

    try:
        base = f"http://127.0.0.1:{demo.server_port}"
        page = urllib.request.urlopen(base + "/", timeout=10).read().decode()
        assert "Avatar Generation" in page and "POST /api/" in page
        tools = json.loads(urllib.request.urlopen(base + "/mcp/tools", timeout=10).read())
        assert [t["name"] for t in tools["tools"]] == [GENERATE, "Extract", "Separate"]

        results = {}

        def request(seed):
            results[seed] = _post(base, GENERATE, gen_values(demo, *inputs, seed=seed))

        with mock.patch.object(tlong, "generate_long", watched):
            threads = [threading.Thread(target=request, args=(s,)) for s in (21, 22)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(600)
        for seed in (21, 22):
            video, used = results[seed]["data"]
            assert used == seed and os.path.isdir(video) and f"avatar_{seed}" in video
        assert overlaps and max(overlaps) == 1  # never two generations at once
        assert results[21]["data"][0] != results[22]["data"][0]
    finally:
        demo.close()


def test_teacache_is_per_request_and_follows_the_model_family(jax_app, inputs, tmp_path):
    """A TeaCache request builds its own controller (the service's models
    keep none) with the loaded family's coefficients; threshold 0 disables
    it (app.py:284)."""
    from stableavatar_tpu_torch.models import teacache as tc_mod

    seen, models_seen = [], []
    get = tc_mod.get_teacache_coefficients
    gen = tlong.generate_long

    def record(*a, **k):
        models_seen.append(a[0].teacache)
        return gen(*a, **k)

    svc = tapp.AvatarService(port_models(jax_app["models"]), output_dir=str(tmp_path),
                             model_family="14B")
    with mock.patch.object(tc_mod, "get_teacache_coefficients",
                           lambda name: seen.append(name) or get(name)), \
            mock.patch.object(tlong, "generate_long", record):
        for thr in (0.1, 0.0):
            svc.generate(*inputs, width=SIZE, height=SIZE, num_inference_steps=2,
                         clip_length=CLIP, overlap_window_length=OVERLAP, seed_param=3,
                         enable_teacache=True, teacache_threshold=thr)
    assert seen == ["wan2.1-t2v-14b"]
    assert models_seen[0] is not None and models_seen[0].num_steps == 2
    assert models_seen[1] is None and svc.models.teacache is None


def test_extract_and_separate_tabs(service, inputs, tmp_path, monkeypatch):
    """The Extract tab raises the ffmpeg gate without ffmpeg; the Separate
    tab writes the vocals (the HPSS tier here, with its warning) under the
    service's lock."""
    import warnings

    from stableavatar_tpu_torch.preprocess import vocal_separator as tsep
    from stableavatar_tpu_torch.utils import media

    monkeypatch.delenv("STABLEAVATAR_MDX_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    demo = tapp.build_ui(service)
    monkeypatch.setattr(media.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="ffmpeg"):
        demo.dispatch("Extract", ["missing.mp4"])
    locked, separate = [], tsep.separate
    monkeypatch.setattr(tsep, "separate",
                        lambda *a, **k: locked.append(service.lock.locked()) or separate(*a, **k))
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        (out,) = demo.dispatch("Separate", [inputs[1]])
    assert locked == [True]  # the separation holds the card as a generation does
    assert out == os.path.join(service.output_dir, "vocal.wav") and os.path.exists(out)


def test_server_load_keeps_t5_and_encodes_each_prompt(inputs, tmp_path, monkeypatch):
    """Under the default --GPU_memory_mode (model_cpu_offload) the CLI's
    loader encodes --validation_prompts and releases umT5; the server's
    (keep_t5) keeps it, and each request encodes its own prompt."""
    from stableavatar_tpu_torch.cli import inference as tcli
    from stableavatar_tpu_torch.pipelines import common as tcommon

    monkeypatch.setenv("STABLEAVATAR_TINY", "1")
    args = tapp.build_app_parser().parse_args(["--output_dir", str(tmp_path)])
    assert args.GPU_memory_mode == "model_cpu_offload" and args.server_port == 7860
    released = tcli.load_models(args, device="cpu")
    assert released.t5_params is None and released.text_ctx is not None
    kept = tcli.load_models(args, device="cpu", keep_t5=True)
    assert kept.t5_params is not None and kept.text_ctx is None
    svc = tapp.AvatarService(kept, output_dir=str(tmp_path))
    prompts, encode = [], tcommon.encode_prompts

    def record(models, prompt, negative=""):
        prompts.append((prompt, negative))
        return encode(models, prompt, negative)

    with mock.patch.object(tlong, "encode_prompts", record):
        for prompt in ("first request", "second request"):
            video, _, _ = svc.generate(*inputs, prompt, "blurry", width=SIZE, height=SIZE,
                                       num_inference_steps=1, clip_length=CLIP,
                                       overlap_window_length=OVERLAP, seed_param=5)
            assert os.path.exists(video)
    assert prompts == [("first request", "blurry"), ("second request", "blurry")]


def test_main_loads_and_launches(tmp_path, monkeypatch):
    """`main` parses the inference flags plus the server's, loads the
    models with umT5 kept, builds the UI and launches it."""
    from stableavatar_tpu_torch.utils import gradio_shim

    monkeypatch.setenv("STABLEAVATAR_TINY", "1")
    launched = []
    monkeypatch.setattr(gradio_shim.Blocks, "launch",
                        lambda self, **kw: launched.append((self, kw)) or self)
    tapp.main(["--output_dir", str(tmp_path), "--server_name", "127.0.0.1",
               "--server_port", "0", "--mcp_server"], device="cpu")
    (demo, kw), = launched
    assert kw == {"server_name": "127.0.0.1", "server_port": 0, "mcp_server": True}
    assert [e["name"] for e in demo.events] == [GENERATE, "Extract", "Separate"]


def test_main_runs_on_the_card_unless_asked(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a host without CUDA")
    monkeypatch.setenv("STABLEAVATAR_TINY", "1")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tapp.main(["--server_port", "0"])
