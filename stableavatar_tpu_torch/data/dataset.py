"""Talking-video training dataset (host-side, numpy; copy of
`stableavatar_tpu/data/dataset.py`, held equal sample for sample by
tests/test_torch_data.py).

Re-implements `LargeScaleTalkingFantasyVideos`
(`wan/dataset/talking_video_dataset_fantasy.py:102-328`): pure-numpy sample
assembly feeding the train step (`train/loop.py:encode_batch` moves each
batch to the card).  Under data parallelism every rank builds the same
seeded stream and keeps its own rows of each batch.

Per-clip directory schema (reference `:130-137,161-185`):
  {clip}/sub_clip.mp4 (or images/ frame PNGs), images/, face_masks/,
  lip_masks/, audio.wav — clip paths listed one-per-line in an index txt.

Behaviors preserved:
- random window with stride: span = (n_sample_frames-1)*sample_frame_rate+1
  capped at the clip length, then np.linspace index selection (`:189-194`);
  reference image = first frame of the window (`:203-207`);
- fps probed from sub_clip.mp4, with the fps-from-audio-duration fallback
  when the container reports 0 (`:164-177`); pass a fixed fps to skip
  probing;
- audio sliced to the window by fps, sample-accurate float-seconds bounds
  (`:251-265`), zero-pad fallback when too short (`:258-262`);
- motion score = mean cosine similarity of consecutive frames (`:283-296`);
- prompt derived from path keywords singing/speech/dancing (`:299-307`);
- first-frame-only inpaint mask at train time (`:321-325`);
- missing-mask fallback to ones (`:220-244`).
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Optional

import numpy as np

from stableavatar_tpu_torch.data.masks import get_random_mask
from stableavatar_tpu_torch.utils.media import load_wav

PROMPTS = {
    "singing": "The protagonist is singing",
    "speech": "The protagonist is talking",
    "dancing": "The protagonist is simultaneously dancing and singing",
}


def prefetch_iterator(gen, depth: int = 2):
    """Run `gen` on a background thread, keeping up to `depth` items ready —
    host-side sample decode overlaps the device train step (the analog of
    DataLoader prefetching; reference `train_1B_square.py:979`).
    The producer is daemonic; exceptions re-raise at the consumer."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
    END = object()

    def produce():
        try:
            for item in gen:
                q.put(item)
            q.put(END)
        except BaseException as e:  # noqa: BLE001 — re-raised at consumer
            q.put(e)

    threading.Thread(target=produce, daemon=True, name="data-prefetch").start()

    def consume():
        while True:
            item = q.get()
            if item is END:
                return
            if isinstance(item, BaseException):
                raise item
            yield item

    return consume()


def _load_frame(path: str, size) -> np.ndarray:
    import cv2

    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(path)
    img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    if size is not None:
        img = cv2.resize(img, (size[1], size[0]))
    return img


def _load_mask(path: str, size) -> Optional[np.ndarray]:
    import cv2

    m = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    if m is None:
        return None
    if size is not None:
        m = cv2.resize(m, (size[1], size[0]))
    return (m > 127).astype(np.float32)


class TalkingVideoDataset:
    """Iterable over per-clip samples for flow-matching training."""

    def __init__(
        self,
        index_file: str,
        data_root: str = "",
        sample_size=(512, 512),
        clip_length: int = 81,
        sample_frame_rate: int = 1,
        fps: Optional[float] = 25,
        sr: int = 16000,
        enable_inpaint: bool = True,
        seed: int = 0,
    ):
        """`sample_frame_rate` is the reference's frame stride (`:189`);
        `fps=None` probes each clip's sub_clip.mp4 (fps-from-audio-duration
        fallback when the container reports 0, `:164-177`)."""
        with open(index_file) as f:
            self.clips: List[str] = [
                os.path.join(data_root, line.strip()) for line in f if line.strip()
            ]
        self.sample_size = tuple(sample_size)
        self.clip_length = clip_length
        self.sample_frame_rate = int(sample_frame_rate)
        self.fps = fps
        self.sr = sr
        self.enable_inpaint = enable_inpaint
        self.rng = np.random.default_rng(seed)
        self._fps_cache: Dict[str, float] = {}
        self._audio_target: Optional[int] = None

    def __len__(self):
        return len(self.clips)

    def _frame_paths(self, clip: str) -> List[str]:
        img_dir = os.path.join(clip, "images")
        names = sorted(os.listdir(img_dir))
        return [os.path.join(img_dir, n) for n in names]

    def _clip_fps(self, clip: str, n_frames: int) -> float:
        """Per-clip fps, reference-exactly (`:162-177`): cv2-probe
        sub_clip.mp4; when the container reports 0 fps (or there is no
        mp4), recover fps = frame_count / audio_duration; last resort 25."""
        if self.fps is not None:
            return float(self.fps)
        cached = self._fps_cache.get(clip)
        if cached is not None:
            return cached
        fps = 0.0
        mp4 = os.path.join(clip, "sub_clip.mp4")
        if os.path.exists(mp4):
            import cv2

            cap = cv2.VideoCapture(mp4)
            fps = float(cap.get(cv2.CAP_PROP_FPS) or 0.0)
            cap.release()
        if fps <= 0.0:
            wav_path = os.path.join(clip, "audio.wav")
            if os.path.exists(wav_path):
                import wave

                with wave.open(wav_path, "rb") as f:
                    dur = f.getnframes() / f.getframerate()
                if dur > 0:
                    fps = n_frames / dur
        if fps <= 0.0:
            fps = 25.0
        self._fps_cache[clip] = fps
        return fps

    def audio_target_len(self) -> int:
        """Fixed (per-dataset) audio sample count every sample is padded /
        truncated to, so batches stack into fixed shapes.  Sized for
        the FULL frame span at the slowest fps in play — a per-clip slice
        (`span/clip_fps` seconds) can never exceed it, so no clip's window
        audio is ever truncated (short clips / fast fps zero-pad)."""
        if self._audio_target is None:
            full_span = (self.clip_length - 1) * self.sample_frame_rate + 1
            if self.fps is not None:
                fps = float(self.fps)
            else:
                fps = min(
                    (self._clip_fps(c, len(self._frame_paths(c)))
                     for c in self.clips),
                    default=25.0,
                )
            self._audio_target = int(math.ceil(full_span * self.sr / fps))
        return self._audio_target

    def window_indices(self, n_frames: int, start: Optional[int] = None,
                       rng=None) -> List[int]:
        """Frame indices for one sample window, matching the reference
        formula exactly (`talking_video_dataset_fantasy.py:189-194`):
        span = min(n, (n_sample_frames-1)*stride + 1), random start, then
        np.linspace(start, start+span-1, n_sample_frames) integer indexing
        (short clips yield linspace-duplicated indices, not tail-padding)."""
        cl = self.clip_length
        span = min(n_frames, (cl - 1) * self.sample_frame_rate + 1)
        if start is None:
            r = rng if rng is not None else self.rng
            start = 0 if n_frames <= span else int(r.integers(0, n_frames - span + 1))
        return np.linspace(start, start + span - 1, cl, dtype=int).tolist()

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        return self._sample(idx, self.rng)

    def _sample(self, idx: int, rng) -> Dict[str, np.ndarray]:
        # all randomness comes through `rng` so the threaded loader can hand
        # each sample its own child generator (np.random.Generator is not
        # thread-safe)
        clip = self.clips[idx]
        frames = self._frame_paths(clip)
        n = len(frames)
        cl = self.clip_length

        sel = self.window_indices(n, rng=rng)
        span = min(n, (cl - 1) * self.sample_frame_rate + 1)

        h, w = self.sample_size
        pixels = np.stack([_load_frame(frames[i], (h, w)) for i in sel])
        pixels = (pixels.astype(np.float32) / 255.0 - 0.5) * 2.0  # [F,H,W,3]
        pixels = pixels.transpose(3, 0, 1, 2)  # [3,F,H,W]

        def masks_for(sub: str) -> np.ndarray:
            mdir = os.path.join(clip, sub)
            out = []
            for i in sel:
                p = os.path.join(mdir, os.path.basename(frames[i]))
                m = _load_mask(p, (h, w)) if os.path.isdir(mdir) else None
                out.append(m if m is not None else np.ones((h, w), np.float32))
            return np.stack(out)[None]  # [1,F,H,W]

        face_masks = masks_for("face_masks")
        lip_masks = masks_for("lip_masks")

        # audio window, sample-accurate to the spanned frame window: the
        # reference slices [start/fps, start/fps + span/fps) in float
        # seconds (`:251-258`) — with stride>1 the audio covers the full
        # span, not n_sample_frames/fps.  Length is then fixed PER DATASET
        # (audio_target_len: zero-pad up to the slowest-fps full span) so
        # mixed-length clips still stack into fixed batch shapes and
        # no clip's window audio gets truncated.
        fps = self._clip_fps(clip, n)
        wav_path = os.path.join(clip, "audio.wav")
        target = self.audio_target_len()
        if os.path.exists(wav_path):
            wav, _ = load_wav(wav_path, self.sr)
            a0 = int(sel[0] / fps * self.sr)
            a1 = int((sel[0] + span) / fps * self.sr)
            audio = wav[a0:a1]
            if len(audio) < target:
                audio = np.pad(audio, (0, target - len(audio)))
            audio = audio[:target]
        else:
            audio = np.zeros(target, np.float32)

        # NOTE: the 10% audio dropout happens in train/loop.py:encode_batch
        # on the wav2vec EMBEDDINGS, matching the reference call site
        # (train_1B_square.py:1193-1194) — not here on the raw waveform.

        # motion score (`:283-296`): stride-8 whole-frame cosine rescaled to
        # [0,1], plus a first-vs-last term; motion_id = (1 - mean) * 100
        fr = pixels.transpose(1, 0, 2, 3).reshape(cl, -1)

        def _cos01(u, v):
            c = float(np.dot(u, v) / max(np.linalg.norm(u) * np.linalg.norm(v), 1e-8))
            return (c + 1.0) / 2.0

        sims = [_cos01(fr[i], fr[i + 8]) for i in range(0, cl - 8, 8)]
        sims.append(_cos01(fr[0], fr[-1]))
        motion_id = (1.0 - sum(sims) / len(sims)) * 100.0

        prompt = ""
        for k, v in PROMPTS.items():
            if k in clip:
                prompt = v
                break

        sample = {
            "pixel_values": pixels,
            "reference_image": pixels[:, 0:1],
            "tgt_face_masks": face_masks,
            "tgt_lip_masks": lip_masks,
            "vocal_input_values": audio.astype(np.float32),
            "text_prompt": prompt,
            "motion_id": motion_id,
            "audio_path": wav_path,
        }

        if self.enable_inpaint:
            m = get_random_mask(
                (cl, 3, h, w), image_start_only=True, rng=rng
            ).astype(np.float32)
            masked = pixels * (1 - m.transpose(1, 0, 2, 3))
            sample["masked_pixel_values"] = masked
            sample["pixel_value_masks"] = m
        return sample

    def batches(self, batch_size: int, shuffle: bool = True,
                num_workers: int = 0, prefetch_depth: int = 2):
        """Endless batch stream.  `num_workers>0` is the analog of
        the reference's `DataLoader(num_workers=...)`
        (`train_1B_square.py:979`): cv2/wav decode releases the GIL, so a
        thread pool parallelizes sample assembly within each batch, and a
        bounded producer thread keeps `prefetch_depth` batches ahead so host
        decode overlaps the device step."""
        gen = self._batches_sync(batch_size, shuffle, num_workers)
        if num_workers <= 0:
            return gen
        return prefetch_iterator(gen, prefetch_depth)

    def _batches_sync(self, batch_size: int, shuffle: bool, num_workers: int,
                      executor=None):
        # a caller-owned executor (InterleavedDataset) is shared, not
        # re-created per sub-iterator; a self-owned one is shut down when
        # the generator is closed/abandoned
        ex, own = executor, False
        if ex is None and num_workers > 0:
            from concurrent.futures import ThreadPoolExecutor

            ex = ThreadPoolExecutor(num_workers, thread_name_prefix="data")
            own = True
        try:
            order = np.arange(len(self))
            while True:
                if shuffle:
                    self.rng.shuffle(order)
                for i in range(0, len(order) - batch_size + 1, batch_size):
                    idxs = [int(j) for j in order[i : i + batch_size]]
                    if ex is not None:
                        # per-sample child generators drawn sequentially here
                        # so the parallel decode stays deterministic given
                        # the seed
                        rngs = [
                            np.random.default_rng(int(self.rng.integers(2**63)))
                            for _ in idxs
                        ]
                        samples = list(ex.map(self._sample, idxs, rngs))
                    else:
                        samples = [self[j] for j in idxs]
                    yield {
                        k: np.stack([s[k] for s in samples])
                        if isinstance(samples[0][k], np.ndarray)
                        else [s[k] for s in samples]
                        for k in samples[0]
                    }
        finally:
            if own:
                ex.shutdown(wait=False)


class InterleavedDataset:
    """Shuffled interleave of multiple datasets (the rec+vec trainer pattern,
    `train_1B_rec_vec.py:1101-1127`)."""

    def __init__(self, datasets: List[TalkingVideoDataset], seed: int = 0):
        self.datasets = datasets
        self.rng = np.random.default_rng(seed)

    def batches(self, batch_size: int, num_workers: int = 0,
                prefetch_depth: int = 2):
        def gen():
            # ONE shared decode pool across sub-iterators (total threads =
            # num_workers, not num_workers x n_datasets) and no producer
            # thread of their own (the interleave picks which one advances);
            # the pool is shut down when this generator is closed/abandoned
            ex = None
            if num_workers > 0:
                from concurrent.futures import ThreadPoolExecutor

                ex = ThreadPoolExecutor(num_workers, thread_name_prefix="data")
            try:
                iters = [
                    d._batches_sync(batch_size, True, num_workers, executor=ex)
                    for d in self.datasets
                ]
                while True:
                    yield next(iters[int(self.rng.integers(0, len(iters)))])
            finally:
                if ex is not None:
                    ex.shutdown(wait=False)

        if num_workers <= 0:
            return gen()
        return prefetch_iterator(gen(), prefetch_depth)
