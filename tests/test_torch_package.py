"""Packaging facts of the PyTorch port: it imports no JAX and nothing of the
JAX package, importing it builds nothing, its configs are field-for-field
copies of the JAX package's, the kernel sources it builds exist, the weight
bridge yields the same tree structure as the port's own initialisers, and
its entry points never run on the CPU unless asked."""

import dataclasses
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import stableavatar_tpu_torch
from stableavatar_tpu_torch.ops import cuda_lib
from tests.test_pipeline import CLIP_E2E, DIT_E2E, VAE_E2E, W2V_E2E

PKG = Path(stableavatar_tpu_torch.__file__).parent


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages([str(PKG)], "stableavatar_tpu_torch."))


def test_import_loads_no_jax_and_builds_nothing():
    code = (
        "import subprocess, sys\n"
        "def refuse(*a, **k):\n"
        "    raise AssertionError(f'subprocess at import: {a}')\n"
        "subprocess.run = subprocess.Popen = subprocess.check_output = refuse\n"
        "import importlib\n"
        f"for name in {_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "from stableavatar_tpu_torch.ops import cuda_lib\n"
        "assert cuda_lib._lib is None\n"
        "jax = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.'))\n"
        "assert not jax, jax\n"
        "pkg = sorted(m for m in sys.modules if m.split('.')[0] == 'stableavatar_tpu')\n"
        "assert not pkg, pkg\n"
        "print('ok', len(sys.modules))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=PKG.parent)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_import_check_covers_the_probes_and_their_scripts():
    """The subprocess import check above walks every module of the package,
    the probes' wrappers and the probe scripts included."""
    assert {"stableavatar_tpu_torch.ops.probes", "stableavatar_tpu_torch.scripts",
            "stableavatar_tpu_torch.scripts.microbench_int8",
            "stableavatar_tpu_torch.scripts.microbench_int8_variants",
            "stableavatar_tpu_torch.scripts.bench_attn_blocks"} <= set(_modules())


def test_import_check_covers_the_training_entry_point():
    """... and the train CLI's modules: the clip dataset, the masks, the
    YAML loader and the LoRA adapters."""
    assert {"stableavatar_tpu_torch.cli.train", "stableavatar_tpu_torch.data.dataset",
            "stableavatar_tpu_torch.data.masks", "stableavatar_tpu_torch.utils.yaml_config",
            "stableavatar_tpu_torch.utils.lora"} <= set(_modules())


def test_no_source_line_imports_jax():
    pattern = re.compile(r"^\s*(import jax|from jax|import stableavatar_tpu\b(?!_torch)"
                         r"|from stableavatar_tpu\b(?!_torch))")
    sources = [*PKG.rglob("*.py"), PKG.parent / "chip_smoke.py"]
    offenders = [f"{p}:{i}" for p in sources
                 for i, line in enumerate(p.read_text().splitlines(), 1) if pattern.match(line)]
    assert not offenders, offenders


@pytest.mark.parametrize("name", ["DiTConfig", "VAEConfig", "CLIPConfig", "Wav2Vec2Config",
                                  "WAN_1_3B", "TrainConfig", "T5Config", "WAN_14B",
                                  "SchedulerConfig"])
def test_configs_equal_jax_package(name):
    """Each config the port copies equals the JAX package's, field by field."""
    from stableavatar_tpu import config as jconfig
    from stableavatar_tpu.train import trainer as jtrainer
    from stableavatar_tpu_torch import config as tconfig
    from stableavatar_tpu_torch.train import trainer as ttrainer

    jmod, tmod = (jtrainer, ttrainer) if name == "TrainConfig" else (jconfig, tconfig)
    want, got = getattr(jmod, name), getattr(tmod, name)
    if isinstance(want, type):
        want, got = want(), got()
    assert [f.name for f in dataclasses.fields(got)] == [f.name for f in dataclasses.fields(want)]
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if name == "WAN_1_3B":
        assert got.head_dim == want.head_dim == 128


def test_tiny_debug_configs_equal_jax_package():
    from stableavatar_tpu import config as jconfig
    from stableavatar_tpu_torch import config as tconfig

    for got, want in zip(tconfig.tiny_debug_configs(), jconfig.tiny_debug_configs(),
                         strict=True):
        assert type(got).__name__ == type(want).__name__
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_kernel_sources_exist():
    for path in cuda_lib.source_paths():
        assert path.is_file(), path
        assert path.suffix in (".cu", ".cuh")
    assert len(cuda_lib.source_hash()) == 16
    assert cuda_lib.library_path().parent.parent == PKG / "_build"
    for name in cuda_lib.SIGNATURES:
        assert any(f'"C" int {name}(' in p.read_text() for p in cuda_lib.source_paths()), name


def _shapes(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_shapes(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_shapes(v, f"{prefix}/{i}"))
        return out
    return {prefix: tuple(tree.shape) if torch.is_tensor(tree) else ()}


@pytest.mark.parametrize("model", ["dit", "vae", "clip", "wav2vec"])
def test_bridge_matches_port_init_structure(model):
    from stableavatar_tpu.models import clip, dit, vae, wav2vec
    from stableavatar_tpu_torch.models import clip as tclip, dit as tdit, vae as tvae
    from stableavatar_tpu_torch.models import wav2vec as twav
    from stableavatar_tpu_torch.utils import weights

    key, gen = jax.random.PRNGKey(0), torch.Generator().manual_seed(0)
    jax_init, port_init, bridge, cfg = {
        "dit": (dit.init_dit, tdit.init_dit, weights.dit_from_jax, DIT_E2E),
        "vae": (vae.init_vae, tvae.init_vae, weights.from_jax_tree, VAE_E2E),
        "clip": (clip.init_clip_visual, tclip.init_clip_visual, weights.from_jax_tree, CLIP_E2E),
        "wav2vec": (wav2vec.init_wav2vec2, twav.init_wav2vec2, weights.from_jax_tree, W2V_E2E),
    }[model]
    # shapes only: eval_shape skips the eager JAX init
    shapes = jax.eval_shape(lambda k: jax_init(k, cfg), key)
    bridged = bridge(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes))
    assert _shapes(bridged) == _shapes(port_init(gen, cfg, device="cpu"))


def test_cpu_wrappers_refuse_other_devices():
    from stableavatar_tpu_torch.ops.cross_attention import dual_context_attention
    from stableavatar_tpu_torch.ops.flash_attention import flash_attention

    q = torch.empty((1, 4, 1, 64), device="meta")
    with pytest.raises(ValueError):
        flash_attention(q, q, q)
    with pytest.raises(ValueError):
        dual_context_attention(q, q, q, q, q)


def test_entry_points_default_to_the_card():
    """Without CUDA, generate_long, train and the CLI's load_models with
    their default devices raise instead of running on the CPU; the
    initialisers and the CLI's main default to the card too."""
    import inspect

    import numpy as np

    from stableavatar_tpu_torch.cli import inference
    from stableavatar_tpu_torch.config import DiTConfig, VAEConfig
    from stableavatar_tpu_torch.models import dit, t5, vae
    from stableavatar_tpu_torch.pipelines.common import WanModels
    from stableavatar_tpu_torch.pipelines.long import generate_long
    from stableavatar_tpu_torch.train.loop import train
    from stableavatar_tpu_torch.train.trainer import TrainConfig
    from stableavatar_tpu_torch.utils.profiling import StepTimer

    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    assert inspect.signature(dit.init_dit).parameters["device"].default == "cuda"
    assert inspect.signature(vae.init_vae).parameters["device"].default == "cuda"
    assert inspect.signature(t5.init_t5).parameters["device"].default == "cuda"
    for fn in (inference.load_models, inference.main):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        inference.load_models(inference.build_parser().parse_args([]))
    assert StepTimer().device is None
    models = WanModels(dit_params={}, dit_cfg=DiTConfig(), vae_params={}, vae_cfg=VAEConfig())
    assert models.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        generate_long(models, ref_image=np.zeros((1, 3, 32, 32)), vocal_waveform=np.zeros(9000),
                      text_ctx=np.zeros((3, 4, 8), np.float32))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train(models, iter([]), TrainConfig())
