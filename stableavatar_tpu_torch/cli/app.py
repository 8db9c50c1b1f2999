"""Serving app of the port (port of `stableavatar_tpu/cli/app.py`): the
reference Gradio UI contract (`app.py:110-236`) on PyTorch and the card.

`AvatarService.generate()` keeps the reference signature's semantics (every
generation knob, the TeaCache toggle, seed handling, the audio mux) and
works headless: the programmatic serving API.  `build_ui()` builds the
three-tab UI with real gradio when installed, else with `utils/gradio_shim.py`
(the same Blocks subset and a stdlib HTTP server); the reference's MCP flag
(`app.py:36,489-496`) maps to `launch(mcp_server=True)` in both.

A server answers request after request on handler threads, so the service
keeps umT5-xxl loaded (`load_models(..., keep_t5=True)`: bf16 on the card,
fp32 on the host with --t5_cpu) to encode each request's prompt, runs one
generation (or vocal separation) at a time under a lock, and gives each
request its own TeaCache.

Run on the card:

    python -m stableavatar_tpu_torch.cli.app --server_port 7860 [inference flags]
"""

from __future__ import annotations

import dataclasses
import os
import random
import threading
import time
from typing import Optional


class AvatarService:
    """The loaded models behind the UI (the reference preloads them at
    module import, `app.py:59-107`).  `timer` (a `utils/profiling.py:StepTimer`)
    collects the phases of every request; `model_family` picks the TeaCache
    coefficients of the loaded DiT."""

    def __init__(self, models, output_dir: str = "outputs",
                 default_stream_output: bool = False, model_family: str = "1.3B",
                 timer=None):
        self.models = models
        self.output_dir = output_dir
        # the server's default (--stream_output): stream_output=None inherits it
        self.default_stream_output = default_stream_output
        self.model_family = model_family
        self.timer = timer
        # one user of the card at a time (a generation, a vocal separation):
        # the card holds one request's activations
        self.lock = threading.Lock()
        os.makedirs(output_dir, exist_ok=True)

    def generate(
        self,
        image_path: str,
        audio_path: str,
        prompt: str = "",
        negative_prompt: str = "",
        width: int = 512,
        height: int = 512,
        guidance_scale: float = 3.0,  # text CFG (the app's "Text Guidance Scale")
        audio_guidance_scale: float = 5.0,
        num_inference_steps: int = 50,
        clip_length: int = 81,
        overlap_window_length: int = 15,
        overlapping_weight_scheme: str = "uniform",
        seed_param: int = -1,
        enable_teacache: bool = False,
        teacache_threshold: float = 0.1,
        num_skip_start_steps: int = 5,
        fps: int = 25,
        GPU_memory_mode: str = "model_cpu_offload",
        motion_frame: int = 25,  # accepted, unused (reference parity)
        sample_solver: str = "euler",
        solver_order: int = 2,
        stream_output: Optional[bool] = None,
    ):
        """Returns (path written, seed used, seconds).  `sample_solver` /
        `solver_order` expose the reduced-step solvers of the CLI (the
        reference app hardwires euler, `app.py:284`); `stream_output` writes
        each decoded segment as it arrives (host memory O(segment))."""
        from stableavatar_tpu_torch.models.teacache import TeaCache, get_teacache_coefficients
        from stableavatar_tpu_torch.pipelines.long import generate_long
        from stableavatar_tpu_torch.utils.media import (
            ffmpeg_available,
            load_image,
            load_wav,
            mux_audio,
        )
        from stableavatar_tpu_torch.utils.video_io import StreamingVideoWriter, save_videos_grid

        seed = seed_param if seed_param >= 0 else random.randint(0, 2**31 - 1)
        # empty textboxes arrive as None from the shim (real gradio sends "")
        prompt = prompt or ""
        negative_prompt = negative_prompt or ""

        # reference semantics: threshold 0 disables TeaCache (app.py:284)
        if teacache_threshold <= 0:
            enable_teacache = False
        # parameter placement is decided at load time (cli/inference.py)
        del GPU_memory_mode, motion_frame

        teacache = None
        if enable_teacache:
            # the loaded DiT's coefficients (the JAX app always takes 1.3B's)
            teacache = TeaCache(
                get_teacache_coefficients(f"wan2.1-t2v-{self.model_family.lower()}"),
                num_inference_steps, rel_l1_thresh=teacache_threshold,
                num_skip_start_steps=num_skip_start_steps)

        ref = load_image(image_path, (width, height))
        wav, sr = load_wav(audio_path, 16000)

        base = os.path.join(self.output_dir, f"avatar_{seed}")
        video_path = base + ".mp4"
        use_stream = self.default_stream_output if stream_output is None else stream_output
        sink_writer = (StreamingVideoWriter(video_path, fps=fps, audio_path=audio_path)
                       if use_stream else None)

        with self.lock:
            models = dataclasses.replace(self.models, teacache=teacache)
            t0 = time.time()
            try:
                out = generate_long(
                    models,
                    ref_image=ref,
                    vocal_waveform=wav,
                    prompt=prompt,
                    negative_prompt=negative_prompt,
                    num_inference_steps=num_inference_steps,
                    text_guide_scale=guidance_scale,
                    audio_guide_scale=audio_guidance_scale,
                    clip_length=clip_length,
                    overlap_window_length=overlap_window_length,
                    overlapping_weight_scheme=overlapping_weight_scheme,
                    scheduler=sample_solver,
                    solver_order=solver_order,
                    fps=fps,
                    sr=sr,
                    seed=seed,
                    frame_sink=sink_writer.append if sink_writer is not None else None,
                    timer=self.timer,
                )
            except BaseException:
                # a long-lived server: a failed request must not leak the
                # encoder process or the open pipe behind the frame sink
                if sink_writer is not None:
                    sink_writer.abort()
                raise
            elapsed = time.time() - t0

        if sink_writer is not None:
            video_path = sink_writer.close()
        else:
            # the path actually written (a PNG frame directory without an
            # ffmpeg video backend)
            video_path = save_videos_grid(out.videos, video_path, fps=fps)
        already_muxed = sink_writer is not None and sink_writer.audio_muxed
        if not already_muxed and ffmpeg_available() and video_path.endswith(".mp4"):
            muxed = base + "_audio.mp4"
            try:
                mux_audio(video_path, audio_path, muxed)
                video_path = muxed
            except Exception:
                pass  # the video stands without audio
        return video_path, seed, elapsed


def build_ui(service: AvatarService):
    """The reference's tabs: generation, audio extraction, vocal separation
    (`app.py:280-496`), on real gradio when installed, else on
    `utils/gradio_shim.py`."""
    from stableavatar_tpu_torch.utils.gradio_shim import ensure_gradio

    gr = ensure_gradio()

    with gr.Blocks(title="StableAvatar-TPU") as demo:
        with gr.Tab("Avatar Generation 数字人生成"):
            # the reference UI's knobs (app.py:280-496), bilingual labels included
            image = gr.Image(type="filepath", label="Reference Image 参考图片")
            audio = gr.Audio(type="filepath", label="Vocal Audio 人声音频")
            prompt = gr.Textbox(label="Prompt 提示词")
            negative = gr.Textbox(label="Negative Prompt 负面提示词")
            with gr.Row():
                width = gr.Slider(256, 1024, 512, step=64, label="Width 宽度")
                height = gr.Slider(256, 1024, 512, step=64, label="Height 高度")
                clip_frames = gr.Slider(
                    17, 161, 81, step=4,
                    label="Clip Sample Frames 视频帧数 (4n+1; 81=2s@25fps)",
                )
            with gr.Row():
                steps = gr.Slider(10, 100, 50, step=1,
                                  label="Sampling Steps 采样步数 (Recommended 50)")
                solver = gr.Dropdown(
                    ["euler", "unipc", "dpm++"], value="euler",
                    label="Solver 求解器",
                    info="unipc/dpm++ @ ~25 steps match euler @ 50 "
                         "(matched-quality reduced-step operating point)",
                )
                cfg_t = gr.Slider(1.0, 10.0, 3.0, label="Text Guidance 文本引导")
                cfg_a = gr.Slider(1.0, 10.0, 5.0, label="Audio Guidance 音频引导")
            with gr.Row():
                overlap = gr.Slider(0, 20, 15, step=1,
                                    label="Overlap Window Length 重叠窗口")
                scheme = gr.Dropdown(["uniform", "log"], value="uniform",
                                     label="Overlap Weight Scheme 融合权重")
                fps = gr.Slider(8, 30, 25, step=1, label="FPS 帧率")
            with gr.Row():
                memory_mode = gr.Dropdown(
                    ["model_full_load", "model_cpu_offload",
                     "model_cpu_offload_and_qfloat8", "sequential_cpu_offload"],
                    value="model_cpu_offload",
                    label="Memory Mode 显存模式",
                    info="parameter placement is decided when the server loads; "
                         "the server keeps umT5 loaded for per-request prompts",
                )
                motion = gr.Slider(1, 50, 25, step=1,
                                   label="Motion Frame 运动帧 (parity; unused)")
            with gr.Row():
                tc_thresh = gr.Slider(
                    0.0, 0.3, 0.0, step=0.01,
                    label="TeaCache Threshold 阈值 (0 disables; recommended 0.1)",
                )
                tc_skip = gr.Slider(0, 10, 5, step=1,
                                    label="Skip Start Steps 起始跳过 (Recommended 5)")
                seed = gr.Number(-1, label="Seed 种子 (-1 random)")
            out_video = gr.Video(label="Result 结果")
            out_seed = gr.Number(label="Used Seed 使用的种子")

            def _generate(img, aud, pr, neg, w, h, cf, st, sv, ct, ca, ov,
                          sch, fp, mm, mo, tt, ts, sd):
                video, used_seed, _ = service.generate(
                    img, aud, pr, neg, int(w), int(h),
                    guidance_scale=ct, audio_guidance_scale=ca,
                    num_inference_steps=int(st), clip_length=int(cf),
                    overlap_window_length=int(ov),
                    overlapping_weight_scheme=sch, seed_param=int(sd),
                    enable_teacache=tt > 0, teacache_threshold=tt,
                    num_skip_start_steps=int(ts), fps=int(fp),
                    GPU_memory_mode=mm, motion_frame=int(mo),
                    sample_solver=sv,
                )
                return video, used_seed

            gr.Button("Generate 生成").click(
                _generate,
                [image, audio, prompt, negative, width, height, clip_frames,
                 steps, solver, cfg_t, cfg_a, overlap, scheme, fps,
                 memory_mode, motion, tc_thresh, tc_skip, seed],
                [out_video, out_seed],
            )
        with gr.Tab("Audio Extraction 音频提取"):
            vid_in = gr.Video(label="Video")
            wav_out = gr.Audio(label="Extracted WAV", type="filepath")

            def _extract(v):
                from stableavatar_tpu_torch.preprocess.audio_extractor import extract

                out = os.path.join(service.output_dir, "extracted.wav")
                extract(v, out)
                return out

            gr.Button("Extract").click(_extract, [vid_in], [wav_out])
        with gr.Tab("Vocal Separation 人声分离"):
            wav_in = gr.Audio(label="Audio", type="filepath")
            vocal_out = gr.Audio(label="Vocals", type="filepath")

            def _separate(a):
                from stableavatar_tpu_torch.preprocess.vocal_separator import separate

                out = os.path.join(service.output_dir, "vocal.wav")
                # the MDX graph runs where the models do, one card user at a time
                with service.lock:
                    return separate(a, out, device=service.models.device)

            gr.Button("Separate").click(_separate, [wav_in], [vocal_out])
    return demo


def build_app_parser():
    """The inference CLI's parser plus the server's flags."""
    from stableavatar_tpu_torch.cli.inference import build_parser

    p = build_parser()
    p.add_argument("--server_name", type=str, default="0.0.0.0")
    p.add_argument("--server_port", type=int, default=7860)
    p.add_argument("--mcp_server", action="store_true")
    return p


def main(argv=None, device="cuda"):
    from stableavatar_tpu_torch.cli.inference import load_models

    args = build_app_parser().parse_args(argv)
    service = AvatarService(load_models(args, device, keep_t5=True), args.output_dir,
                            default_stream_output=args.stream_output,
                            model_family=args.model_family)
    demo = build_ui(service)
    demo.launch(
        server_name=args.server_name,
        server_port=args.server_port,
        mcp_server=args.mcp_server,
    )


if __name__ == "__main__":
    main()
