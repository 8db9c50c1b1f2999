"""What a run may load and where it refuses to run."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from avatar_bench import core

HARNESS = ("avatar_bench.run", "avatar_bench.core", "avatar_bench.readings", "avatar_bench.faults",
           "avatar_bench.faults_train", "avatar_bench.trace", "avatar_bench.trace_train",
           "avatar_bench.roofline", "avatar_bench.roofline_train", "avatar_bench.weights",
           "avatar_bench.traffic.gen", "avatar_bench.traffic.train")
REFERENCE = ("avatar_bench.reference.common", "avatar_bench.reference.dit",
             "avatar_bench.reference.encoders", "avatar_bench.reference.train")


def loaded_after(modules, extra=""):
    code = ("import importlib, json, sys\n"
            f"for m in {list(modules)!r}: importlib.import_module(m)\n{extra}"
            "print(json.dumps(sorted(sys.modules)))")
    env = dict(os.environ, PYTHONPATH=str(core.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         cwd=core.ROOT, timeout=300, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_whole_names_are_compared():
    assert core.forbidden_modules(["jax", "jax.numpy", "jaxlib.xla", "flax", "stableavatar_tpu.ops"]) \
        == ["flax", "jax", "jax.numpy", "jaxlib.xla", "stableavatar_tpu.ops"]
    assert core.forbidden_modules(["stableavatar_tpu_torch", "stableavatar_tpu_torch.models",
                                   "jaxtyping", "flaxen"]) == []


def test_harness_and_port_load_no_jax():
    mods = loaded_after(HARNESS + ("stableavatar_tpu_torch.pipelines.long",
                                   "stableavatar_tpu_torch.utils.fastpath",
                                   "stableavatar_tpu_torch.train.loop"))
    assert core.forbidden_modules(mods) == []
    assert {"stableavatar_tpu_torch.pipelines.long", "stableavatar_tpu_torch.train.loop"} <= set(mods)


def test_reference_loads_nothing_of_the_program():
    mods = loaded_after(REFERENCE)
    assert core.forbidden_modules(mods) == []
    assert not [m for m in mods if m.split(".")[0] == "stableavatar_tpu_torch"]


@pytest.fixture
def no_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")


def run_cell(cwd):
    env = dict(os.environ, PYTHONPATH=str(cwd))
    return subprocess.run([sys.executable, "-m", "avatar_bench.run", "--workload", "gen-1.3b-euler",
                           "--seed", "2147483659", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, cwd=cwd, env=env, timeout=300)


def test_refuses_without_a_card(no_card):
    out = run_cell(core.ROOT)
    assert out.returncode == 2 and out.stdout == ""
    assert "no CUDA card" in out.stderr


def test_fails_with_the_benchmark_alone(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's folder
    has no program to run: a non-zero exit and no result."""
    shutil.copy(core.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(core.PACKAGE, tmp_path / "avatar_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = run_cell(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
