"""The plain reference against the port's CPU path at a tiny size, both in
float32 on the same weights: they compute the same functions."""

import numpy as np
import pytest
import torch

from avatar_bench import weights
from avatar_bench.reference import common as rc
from avatar_bench.reference import dit as ref_dit
from avatar_bench.reference import encoders as ref_enc
from avatar_bench.tests.tiny import tiny_config
from avatar_bench.traffic import gen


@pytest.fixture(scope="module")
def models():
    c = tiny_config(dtypes=("float32",) * 4)
    g = torch.Generator().manual_seed(7)
    trees = weights.draw([weights.spec_dit(c["dit"]), weights.spec_vae(c["vae"]),
                          weights.spec_clip(c["clip"]), weights.spec_wav2vec(c["wav2vec"])],
                         g, "cpu", [torch.float32] * 4)
    return c, trees, gen.program_configs(c)


def rel(a, b):
    return float(torch.linalg.vector_norm(a.float() - b.float()) / torch.linalg.vector_norm(b.float()))


def test_dit_forward(models):
    from stableavatar_tpu_torch.models.dit import dit_forward

    c, (dit, _, _, _), (dcfg, _, _, _) = models
    g = torch.Generator().manual_seed(1)
    d = c["dit"]
    x = torch.randn((3, d["out_dim"], 5, 8, 8), generator=g)
    y = torch.randn((3, d["in_dim"] - d["out_dim"], 5, 8, 8), generator=g)
    text = torch.randn((3, d["text_len"], d["text_dim"]), generator=g)
    clip = torch.randn((3, d["clip_tokens"], d["clip_dim"]), generator=g)
    audio = torch.randn((1, 40, d["audio_in_dim"]), generator=g)
    t = torch.full((3,), 937.0)
    want = ref_dit.dit_forward(dit, d, x, t, text, clip, y, audio, 17)
    got = dit_forward(dit, dcfg, x, t, text, clip, y, audio, video_sample_n_frames=17,
                      vocal_cfg_tile=True)
    assert want.shape == got.shape == x.shape
    assert rel(got, want) < 1e-5


def test_vae_encode(models):
    from stableavatar_tpu_torch.models.vae import encode_video

    c, (_, vae, _, _), (_, vcfg, _, _) = models
    video = torch.randn((1, 3, 17, 16, 16), generator=torch.Generator().manual_seed(2))
    assert rel(encode_video(vae, video, vcfg), ref_enc.vae_encode(vae, c["vae"], video)) < 1e-5


def test_clip_features(models):
    from stableavatar_tpu_torch.models.clip import clip_visual_forward, preprocess_reference_image

    c, (_, _, clip, _), (_, _, ccfg, _) = models
    image = torch.rand((1, 3, 40, 36), generator=torch.Generator().manual_seed(3)) * 2 - 1
    got = clip_visual_forward(clip, ccfg, preprocess_reference_image(image, ccfg))
    assert rel(got, ref_enc.clip_features(clip, c["clip"], image)) < 1e-5


def test_wav2vec_states(models):
    from stableavatar_tpu_torch.models.wav2vec import normalize_waveform, wav2vec2_forward

    c, (_, _, _, w2v), (_, _, _, wcfg) = models
    wav = 0.1 * torch.randn(8000, generator=torch.Generator().manual_seed(4))
    got = wav2vec2_forward(w2v, wcfg, normalize_waveform(wav[None]))
    assert rel(got, ref_enc.wav2vec_states(w2v, c["wav2vec"], wav)) < 1e-5


def test_schedule_and_windows():
    from stableavatar_tpu_torch.pipelines.long import plan_audio_slices, plan_windows
    from stableavatar_tpu_torch.schedulers.flow_match import flow_match_timesteps

    np.testing.assert_array_equal(rc.flow_match_sigmas(50, 5.0), flow_match_timesteps(50, 5.0).sigmas)
    for infer in (21, 27, 38, 100):
        w = rc.window_plan(infer, 21, 15)
        assert w == plan_windows(infer, 21, 15)
        for a, b in zip(rc.audio_slices(w, infer, 640, infer * 2560 - 999),
                        plan_audio_slices(w, infer, 640, infer * 2560 - 999)):
            np.testing.assert_array_equal(a, b)


def test_attention_blocks_and_masks(monkeypatch):
    g = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn((2, 37, 3, 8), generator=g) for _ in range(3))
    lens = torch.tensor([37, 5])
    whole = rc.attention(q, k, v, k_lens=lens)
    monkeypatch.setattr(rc, "ATTN_BLOCK_BYTES", 4 * 2 * 3 * 37 * 7)  # blocks of 7 queries
    assert torch.allclose(rc.attention(q, k, v, k_lens=lens), whole, atol=1e-6)
    p = torch.softmax(torch.einsum("bqnd,bknd->bnqk", q[1:], k[1:, :5]) * 8 ** -0.5, -1)
    assert torch.allclose(whole[1:], torch.einsum("bnqk,bknd->bqnd", p, v[1:, :5]), atol=1e-6)
