"""8-bit Adam's and CAME's state sharded over 'fsdp' (`train/optim.py:Split`,
`train/adam8bit.py`, `train/came.py` and the checkpoint maps of
`train/loop.py`) on the CPU: one spawn of 4 gloo ranks runs 3 updates of
each optimizer at fsdp 2 (a dp 2 x fsdp 2 mesh) and at fsdp 4, against the
one-process transform on the same leaves and gradients.

The leaves are made by hand above the fsdp rule's 2^16 elements, so that
they split, one on each kind of axis: [256, 512] on its last, [512, 256]
on axis 0, [4, 256, 128] on axis -2, [512, 8, 16] on its leading axis; a
[16, 32] matrix and a [64] vector stay whole.  8-bit Adam's sharded update
equals the one-process update bit for bit (the row absmax over the group
is a max, the rest is element by element); CAME's is within rel-L2 1e-5
(its row and column means and its RMS clip summed over the group in
another order), the bound the sharded AdamW step is held to
(tests/test_torch_parallel.py).  A checkpoint written at fsdp 2 and
resumed at fsdp 4 continues as the one-process run does.
"""

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

from stableavatar_tpu_torch.parallel.mesh import axis_group, make_mesh, mesh_context
from stableavatar_tpu_torch.parallel.sharding import Shard, leaf_specs, shard_like, shard_params
from stableavatar_tpu_torch.train import optim
from stableavatar_tpu_torch.train.adam8bit import adamw8bit
from stableavatar_tpu_torch.train.came import came
from stableavatar_tpu_torch.train.loop import CheckpointManager, host_state, shard_state
from stableavatar_tpu_torch.utils.tree import tree_leaves

# name: (shape, the axis the fsdp rule splits it on at fsdp 2 and 4)
LEAVES = {"last": ((256, 512), 1), "first": ((512, 256), 0), "minus2": ((4, 256, 128), 1),
          "leading": ((512, 8, 16), 0), "small": ((16, 32), None), "vector": ((64,), None)}
OPTIMIZERS = {"adam8bit": lambda: adamw8bit(1e-3),
              "came": lambda: came(1e-3, weight_decay=1e-2)}
# the state's tensors of each leaf's shape
MOMENTS = {"adam8bit": ("mu", "q"), "came": ("exp_avg",)}
STEPS = 3
WORLD = 4
SPAWN_TIMEOUT_S = 240


def _params():
    rng = np.random.default_rng(0)
    return {k: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            for k, (shape, _) in LEAVES.items()}


def _grads(n):
    """n steps of seeded full gradients, one list per step."""
    rng = np.random.default_rng(1)
    return [[torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * 0.1)
             for shape, _ in LEAVES.values()] for _ in range(n)]


def _one_process(opt, grads):
    """The transform on whole leaves in one process: (params, state)."""
    params = _params()
    leaves = tree_leaves(params)
    tx = OPTIMIZERS[opt]()
    state = tx.init(leaves)
    for g in grads:
        updates, state = tx.update(g, state, leaves)
        optim.apply_updates(leaves, updates)
    return params, state


def _sharded(opt, mesh, grads, params=None, state=None):
    """The transform on this rank's slices under `mesh`, from full `params`
    (and full `state`, split by `shard_state`) or from the start:
    (sharded params, state)."""
    params = _params() if params is None else params
    if state is None:
        sharded = shard_params(params, mesh)
    else:
        sharded, state = shard_state(params, state, mesh)
    specs, leaves = leaf_specs(sharded), tree_leaves(sharded)
    tx = OPTIMIZERS[opt]()
    with optim.sharded_leaves(specs, axis_group("fsdp", mesh)):
        if state is None:
            state = tx.init(leaves)
        for g in grads:
            local = [shard_like(x, s, mesh) for x, s in zip(g, specs)]
            updates, state = tx.update(local, state, leaves)
            optim.apply_updates(leaves, updates)
    return sharded, state


def _per_leaf(state, opt):
    return state[0]["nu"] if opt == "adam8bit" else state["leaves"]


def _counts(opt, sharded, state):
    """Per split leaf: elements of its parameter's shape in this rank's
    moments, and in the whole leaf's."""
    out = {}
    for (name, (shape, _)), spec, entry, mu in zip(
            LEAVES.items(), leaf_specs(sharded), _per_leaf(state, opt),
            state[0]["mu"] if opt == "adam8bit" else [None] * len(LEAVES)):
        if spec is None:
            continue
        fields = [mu if k == "mu" else entry[k] for k in MOMENTS[opt]]
        out[name] = (sum(x.numel() for x in fields), len(fields) * int(np.prod(shape)))
    return out


def _whole_statistics(opt, sharded, state):
    """This rank's copies of the statistics that every rank holds whole:
    those reduced over the axis their leaf is split on."""
    out = {}
    for (name, (shape, _)), spec, entry in zip(LEAVES.items(), leaf_specs(sharded),
                                               _per_leaf(state, opt)):
        if spec is None:
            continue
        for k, x in entry.items():
            if k in optim.STATISTICS and optim.field_spec(k, x, spec.local.shape, spec) is None:
                out[name, k] = x.clone()
    return out


def sharded_cases(rank):
    res = {}
    grads = _grads(2 * STEPS)
    ckpt_root = os.environ["SA_TEST_DIR"]
    for opt in OPTIMIZERS:
        want_params, want_state = _one_process(opt, grads[:STEPS])
        want_more, want_more_state = _one_process(opt, grads)
        for fsdp in (2, 4):
            mesh = make_mesh(WORLD // fsdp, fsdp, 1, device_type="cpu")
            with mesh_context(mesh):
                sharded, state = _sharded(opt, mesh, grads[:STEPS])
                axes = {k: (s.axis if s is not None else None)
                        for k, s in zip(LEAVES, leaf_specs(sharded))}
                full, full_state = host_state(sharded, state)
                counts = _counts(opt, sharded, state)
                mine = _whole_statistics(opt, sharded, state)
                every = [None] * WORLD
                dist.all_gather_object(every, mine)
                if fsdp == 2:
                    ckpt = os.path.join(ckpt_root, opt)
                    CheckpointManager(ckpt, writer=rank == 0).save(STEPS, sharded, state)
                    dist.barrier()
            res[opt, fsdp] = dict(axes=axes, full=full, full_state=full_state, counts=counts,
                                  whole=every, want=want_params, want_state=want_state)
        mesh = make_mesh(1, WORLD, 1, device_type="cpu")
        restored = CheckpointManager(os.path.join(ckpt_root, opt)).restore("cpu")
        with mesh_context(mesh):
            sharded, state = _sharded(opt, mesh, grads[STEPS:], restored["params"],
                                      restored["opt_state"])
            full, full_state = host_state(sharded, state)
        res[opt, "resume"] = dict(step=restored["step"], full=full, full_state=full_state,
                                  want=want_more, want_state=want_more_state)
    return res


# --------------------------------------------------------------------------
# spawning
# --------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_entry(rank, world, port, out_path):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world,
                            rank=rank)
    try:
        result = sharded_cases(rank)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        with open(out_path, "wb") as f:
            pickle.dump(result, f)


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    os.environ["SA_TEST_DIR"] = str(tmp_path_factory.mktemp("optim_sharded"))
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "result.pkl")
        ctx = mp.spawn(_rank_entry, args=(WORLD, _free_port(), out), nprocs=WORLD, join=False)
        deadline = time.monotonic() + SPAWN_TIMEOUT_S
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                for proc in ctx.processes:
                    proc.kill()
                raise TimeoutError(f"sharded_cases did not end in {SPAWN_TIMEOUT_S} s")
        with open(out, "rb") as f:
            return pickle.load(f)


# --------------------------------------------------------------------------
# the tests
# --------------------------------------------------------------------------


def _tensors(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _tensors(v)]
    return [tree] if torch.is_tensor(tree) else []


def _rel_l2(got, want):
    g = torch.cat([x.double().reshape(-1) for x in got])
    w = torch.cat([x.double().reshape(-1) for x in want])
    return float(torch.linalg.vector_norm(g - w) / torch.linalg.vector_norm(w))


def _check_matches(opt, full, full_state, want, want_state):
    got_s, want_s = _tensors(full_state), _tensors(want_state)
    assert [x.shape for x in got_s] == [x.shape for x in want_s]
    assert [x.dtype for x in got_s] == [x.dtype for x in want_s]
    if opt == "adam8bit":
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(full), tree_leaves(want)))
        assert all(torch.equal(a, b) for a, b in zip(got_s, want_s))
    else:
        init = tree_leaves(_params())
        steps = [a - p for a, p in zip(tree_leaves(full), init)]
        want_steps = [b - p for b, p in zip(tree_leaves(want), init)]
        assert _rel_l2(steps, want_steps) <= 1e-5
        assert _rel_l2(got_s, want_s) <= 1e-5


CASES = [f"{opt}-fsdp{fsdp}-{check}" for opt in OPTIMIZERS for fsdp in (2, 4)
         for check in ("update", "slices", "whole")] + [f"{opt}-resume" for opt in OPTIMIZERS]


@pytest.mark.parametrize("case", CASES)
def test_sharded_optimizer_state(sharded, case):
    """update: 3 sharded updates, gathered, against the one-process ones
    (8-bit Adam bit for bit, CAME at rel-L2 1e-5), each leaf split on the
    axis LEAVES names; slices: each rank's moments hold 1/fsdp of their
    split leaves' elements; whole: the statistics reduced over the split
    axis (8-bit Adam's row scales and CAME's rows of [256, 512], CAME's
    columns of [512, 256] and [4, 256, 128]) are the same on every rank;
    resume: the state written at fsdp 2 after 3 updates, restored and
    split at fsdp 4, continues for 3 more as the one-process run of 6."""
    opt, *rest = case.split("-")
    if rest == ["resume"]:
        r = sharded[opt, "resume"]
        assert r["step"] == STEPS
        _check_matches(opt, r["full"], r["full_state"], r["want"], r["want_state"])
        return
    fsdp, check = int(rest[0][len("fsdp"):]), rest[1]
    r = sharded[opt, fsdp]
    if check == "update":
        assert r["axes"] == {k: axis for k, (_, axis) in LEAVES.items()}
        _check_matches(opt, r["full"], r["full_state"], r["want"], r["want_state"])
    elif check == "slices":
        assert set(r["counts"]) == {k for k, (_, axis) in LEAVES.items() if axis is not None}
        assert all(have * fsdp == whole for have, whole in r["counts"].values())
    else:
        want = {("last", "scale")} if opt == "adam8bit" else {
            ("last", "row"), ("last", "res_row"), ("first", "col"), ("first", "res_col"),
            ("minus2", "col"), ("minus2", "res_col")}
        first, *others = r["whole"]
        assert set(first) == want
        assert all(set(o) == want and all(torch.equal(o[k], first[k]) for k in want)
                   for o in others)


def test_split_of_a_statistic_follows_the_reduced_axis():
    """`Split.reduced` and `optim.field_spec` without a process group: a
    statistic over the split axis is whole (no Shard); one over another
    axis keeps the split, its axis shifted where an earlier axis went."""
    split = optim.Split(2, 3)
    assert split.reduced(-1) == optim.Split(None, 2)
    assert split.reduced(0) == optim.Split(1, 2)
    assert split.reduced(-1, keepdim=True) == optim.Split(None, 3)
    assert optim.Split(0, 3).reduced(-2) == optim.Split(0, 2)
    spec = Shard(torch.zeros(128, 4, 128), 1, (4, 256, 128))
    assert optim.field_spec("row", torch.zeros(128, 4), (128, 4, 128), spec).axis == 1
    assert optim.field_spec("col", torch.zeros(4, 128), (128, 4, 128), spec) is None
    assert optim.field_spec("scale", torch.zeros(128, 4, 1), (128, 4, 128), spec).shape == \
        (4, 256, 1)
    assert optim.field_spec("exp_avg", torch.zeros(128, 4, 128), (128, 4, 128), spec) is spec
    with pytest.raises(ValueError, match="no fsdp layout"):
        optim.field_spec("other", torch.zeros(3), (128, 4, 128), spec)
