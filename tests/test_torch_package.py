"""Packaging facts of the PyTorch port: it imports no JAX (of the JAX package
only the jax-free `stableavatar_tpu.config`), importing it builds nothing,
the kernel sources it builds exist, and the weight bridge yields the same
tree structure as the port's own initialisers."""

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
        "pkg = {m for m in sys.modules if m.split('.')[0] == 'stableavatar_tpu'}\n"
        "assert pkg <= {'stableavatar_tpu', 'stableavatar_tpu.config'}, pkg\n"
        "print('ok', len(sys.modules))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=PKG.parent)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_no_source_line_imports_jax():
    pattern = re.compile(r"^\s*(import jax|from jax|import stableavatar_tpu\b(?!_torch)"
                         r"|from stableavatar_tpu\b(?!_torch|\.config import))")
    offenders = [f"{p}:{i}" for p in PKG.rglob("*.py")
                 for i, line in enumerate(p.read_text().splitlines(), 1) if pattern.match(line)]
    assert not offenders, offenders


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
    assert _shapes(bridged) == _shapes(port_init(gen, cfg))


def test_cpu_wrappers_refuse_other_devices():
    from stableavatar_tpu_torch.ops.cross_attention import dual_context_attention
    from stableavatar_tpu_torch.ops.flash_attention import flash_attention

    q = torch.empty((1, 4, 1, 64), device="meta")
    with pytest.raises(ValueError):
        flash_attention(q, q, q)
    with pytest.raises(ValueError):
        dual_context_attention(q, q, q, q, q)
