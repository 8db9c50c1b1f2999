"""The port's training data path against the JAX package's: the inpaint
masks (`data/masks.py`), the clip dataset and its batch streams
(`data/dataset.py`) over a clip directory built here, and the YAML loader
(`utils/yaml_config.py`).  Both sides are numpy with the same seeds, so
every array must be equal bit for bit (mirrors tests/test_data_cli.py)."""

import dataclasses

import numpy as np
import pytest

from stableavatar_tpu.data import dataset as jds
from stableavatar_tpu.data import masks as jmasks
from stableavatar_tpu_torch.data import dataset as tds
from stableavatar_tpu_torch.data import masks as tmasks

MASK_P = [0.05, 0.2, 0.2, 0.2, 0.05, 0.05, 0.05, 0.1, 0.05, 0.05]


def _seed_for_scheme(scheme: int) -> int:
    """The first seed whose generator picks `scheme` as its mask scheme."""
    for seed in range(10_000):
        if np.random.default_rng(seed).choice(10, p=MASK_P) == scheme:
            return seed
    raise AssertionError(scheme)


@pytest.mark.parametrize("scheme", range(10))
def test_random_mask_scheme_matches_jax(scheme):
    """Each of the 10 schemes, from the same generator state, on a clip
    whose sides differ: the same mask bit for bit, and the generators left
    in the same state."""
    seed = _seed_for_scheme(scheme)
    rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
    want = jmasks.get_random_mask((9, 3, 24, 40), rng=rj)
    got = tmasks.get_random_mask((9, 3, 24, 40), rng=rt)
    assert got.dtype == want.dtype == np.uint8 and got.shape == (9, 1, 24, 40)
    np.testing.assert_array_equal(got, want)
    assert rj.integers(2 ** 63) == rt.integers(2 ** 63)


@pytest.mark.parametrize("shape,start_only", [((9, 3, 16, 16), True), ((1, 3, 16, 16), True),
                                              ((1, 3, 16, 16), False)])
def test_random_mask_start_only_and_single_frame_match_jax(shape, start_only):
    for seed in range(6):
        np.testing.assert_array_equal(
            tmasks.get_random_mask(shape, start_only, np.random.default_rng(seed)),
            jmasks.get_random_mask(shape, start_only, np.random.default_rng(seed)))


@pytest.fixture
def clip_dir(tmp_path):
    """tests/test_data_cli.py's clip: 12 frames of 32 x 32 with face and lip
    masks and a 1 s wav, under a path that holds "speech"."""
    import cv2

    from stableavatar_tpu_torch.utils.media import save_wav

    clip = tmp_path / "data" / "speech_clip_000"
    (clip / "images").mkdir(parents=True)
    (clip / "face_masks").mkdir()
    (clip / "lip_masks").mkdir()
    rng = np.random.default_rng(0)
    for i in range(12):
        cv2.imwrite(str(clip / "images" / f"{i:05d}.png"),
                    rng.integers(0, 255, (32, 32, 3), dtype=np.uint8))
        mask = (rng.random((32, 32)) > 0.5).astype(np.uint8) * 255
        cv2.imwrite(str(clip / "face_masks" / f"{i:05d}.png"), mask)
        cv2.imwrite(str(clip / "lip_masks" / f"{i:05d}.png"), mask)
    save_wav(str(clip / "audio.wav"), (rng.standard_normal(16000) * 0.1).astype(np.float32),
             16000)
    index = tmp_path / "data" / "index.txt"
    index.write_text(str(clip) + "\n")
    return str(index)


@pytest.fixture
def mixed_dir(tmp_path):
    """Two clips of 20 and 5 frames, the short one without masks (they
    fall back to ones) and one path holding "singing"."""
    import cv2

    from stableavatar_tpu_torch.utils.media import save_wav

    root = tmp_path / "mixed"
    rng = np.random.default_rng(1)
    for name, n in (("singing_long", 20), ("speech_short", 5)):
        clip = root / name
        (clip / "images").mkdir(parents=True)
        if n == 20:
            (clip / "face_masks").mkdir()
        for i in range(n):
            cv2.imwrite(str(clip / "images" / f"{i:05d}.png"),
                        rng.integers(0, 255, (24, 40, 3), dtype=np.uint8))
            if n == 20:
                cv2.imwrite(str(clip / "face_masks" / f"{i:05d}.png"),
                            (rng.random((24, 40)) > 0.5).astype(np.uint8) * 255)
        save_wav(str(clip / "audio.wav"), (rng.standard_normal(16000) * 0.1).astype(np.float32),
                 16000)
    index = root / "index.txt"
    index.write_text("singing_long\nspeech_short\n")
    return str(index), str(root)


def _assert_samples_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype, k
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            assert g == w, k


DATASETS = {
    "default": dict(sample_size=(32, 32), clip_length=9, seed=0),
    "stride2": dict(sample_size=(32, 32), clip_length=5, sample_frame_rate=2, fps=25, seed=3),
    "probed_fps": dict(sample_size=(32, 32), clip_length=9, fps=None, seed=0),
    "whole_clip": dict(sample_size=(32, 32), clip_length=12, fps=None, seed=1),
    "resized": dict(sample_size=(16, 24), clip_length=5, seed=2),
}


@pytest.mark.parametrize("name", list(DATASETS))
def test_dataset_samples_match_jax(clip_dir, name):
    """Three samples in a row from one seed (window start, masks, audio
    slice, motion score, prompt from the path), bit for bit."""
    want_ds = jds.TalkingVideoDataset(clip_dir, **DATASETS[name])
    got_ds = tds.TalkingVideoDataset(clip_dir, **DATASETS[name])
    assert got_ds.audio_target_len() == want_ds.audio_target_len()
    for _ in range(3):
        _assert_samples_equal(got_ds[0], want_ds[0])
    assert got_ds[0]["text_prompt"] == "The protagonist is talking"
    assert got_ds.window_indices(81, start=4) == want_ds.window_indices(81, start=4)


def test_dataset_mixed_clips_and_mask_fallback_match_jax(mixed_dir):
    index, root = mixed_dir
    kw = dict(sample_size=(24, 40), clip_length=9, fps=25, seed=5)
    want_ds, got_ds = (m.TalkingVideoDataset(index, root, **kw) for m in (jds, tds))
    for i in (0, 1, 0, 1):
        _assert_samples_equal(got_ds[i], want_ds[i])
    assert got_ds[0]["text_prompt"] == "The protagonist is singing"
    np.testing.assert_array_equal(got_ds[1]["tgt_face_masks"], 1.0)


@pytest.mark.parametrize("workers,batch", [(0, 1), (2, 2)])
def test_dataset_batches_match_jax(mixed_dir, workers, batch):
    """The batch stream, synchronous and through the decode pool and the
    prefetch thread (per-sample generators drawn in order)."""
    index, root = mixed_dir
    kw = dict(sample_size=(24, 40), clip_length=9, fps=25, seed=7)
    streams = [m.TalkingVideoDataset(index, root, **kw).batches(batch, num_workers=workers)
               for m in (jds, tds)]
    for _ in range(3):
        want, got = (next(s) for s in streams)
        _assert_samples_equal(got, want)
        assert got["pixel_values"].shape == (batch, 3, 9, 24, 40)
    for s in streams:
        s.close()


def test_interleaved_dataset_matches_jax(clip_dir, mixed_dir):
    """The rec + vec interleave: which dataset advances and what it yields."""
    index, root = mixed_dir

    def build(m):
        return m.InterleavedDataset(
            [m.TalkingVideoDataset(clip_dir, sample_size=(32, 32), clip_length=5, seed=1),
             m.TalkingVideoDataset(index, root, sample_size=(24, 40), clip_length=5, seed=2)],
            seed=4)

    for workers in (0, 2):
        streams = [build(m).batches(1, num_workers=workers) for m in (jds, tds)]
        for _ in range(5):
            want, got = (next(s) for s in streams)
            _assert_samples_equal(got, want)
        for s in streams:
            s.close()


def test_prefetch_iterator_reraises_at_the_consumer():
    def gen():
        yield 1
        raise KeyError("decode failed")

    it = tds.prefetch_iterator(gen(), depth=1)
    assert next(it) == 1
    with pytest.raises(KeyError, match="decode failed"):
        next(it)


YAML = """
transformer_additional_kwargs:
  transformer_subpath: ./
  dict_mapping:
    in_dim: in_channels
  num_layers: 40
  dim: 5120
vae_kwargs:
  vae_subpath: Wan2.1_VAE.pth
  temporal_compression_ratio: 4
  spatial_compression_ratio: 8
text_encoder_kwargs:
  text_encoder_subpath: models_t5_umt5-xxl-enc-bf16.pth
  tokenizer_subpath: google/umt5-xxl
  text_length: 512
  vocab: 256384
  dim: 4096
  dim_ffn: 10240
  num_heads: 64
  num_layers: 24
  num_buckets: 32
  shared_pos: False
scheduler_kwargs:
  scheduler_subpath: null
  num_train_timesteps: 1000
  shift: 3.0
  use_dynamic_shifting: false
  base_shift: 0.5
"""


@pytest.mark.parametrize("text", [YAML, YAML.replace("spatial_compression_ratio: 8",
                                                     "spacial_compression_ratio: 16"), ""],
                         ids=["reference", "spacial", "empty"])
def test_yaml_config_loader_matches_jax(tmp_path, text):
    """The same YAML through both loaders (tests/test_data_cli.py:202):
    dict_mapping and the *_subpath keys dropped, text_length -> text_len,
    both spellings of the compression ratio."""
    from stableavatar_tpu.utils.yaml_config import load_config as jload
    from stableavatar_tpu_torch import config as tconfig
    from stableavatar_tpu_torch.utils.yaml_config import load_config as tload

    path = tmp_path / "cfg.yaml"
    path.write_text(text)
    want, got = jload(str(path)), tload(str(path))
    assert set(got) == set(want) == {"dit", "vae", "t5", "scheduler", "raw"}
    assert got["raw"] == want["raw"]
    for key, cls in (("dit", tconfig.DiTConfig), ("vae", tconfig.VAEConfig),
                     ("t5", tconfig.T5Config), ("scheduler", tconfig.SchedulerConfig)):
        assert isinstance(got[key], cls)
        assert dataclasses.asdict(got[key]) == dataclasses.asdict(want[key]), key
    if text:
        assert got["t5"].text_len == 512 and got["dit"].num_layers == 40
        assert got["scheduler"].shift == 3.0
