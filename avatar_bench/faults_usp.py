"""Faults of a sequence-parallel run, planted in every rank by
`traffic/gen_usp.py` (a context manager opened in the parent does not
reach spawned ranks): the gen kind's faults (`faults.GEN`), and four that
only a run over several ranks can have, each in the port's
`models/dit.py`.  None is reachable from `run.py`."""

from __future__ import annotations

import contextlib
import dataclasses

from avatar_bench.faults import GEN, _patched


def _dit():
    from stableavatar_tpu_torch.models import dit

    return dit


def no_exchange():
    """The exchange between cards left out: every Ulysses all-to-all hands
    back the rank's own chunks in place of the others'."""
    return _patched(_dit(), "all_to_all_dim0", lambda real: lambda x, group: x.contiguous())


def gather_swap():
    """The gather of the token slices before the head puts the first two
    ranks' slices in each other's place."""

    def make(real):
        def gather(x, sp):
            out = real(x, sp)
            n = x.shape[1]
            return out.index_select(1, _swap_index(n, out.shape[1], out.device))
        return gather

    return _patched(_dit(), "_gather_seq", make)


def _swap_index(n, total, device):
    import torch

    idx = torch.arange(total, device=device)
    idx[:n], idx[n:2 * n] = idx[n:2 * n].clone(), idx[:n].clone()
    return idx


def rope_rows():
    """Every rank rotates its queries and keys at the first slice's
    positions, as if its tokens started the sequence."""

    def make(real):
        def rows(freqs, rope_packed, sp):
            return real(freqs, rope_packed, sp and dataclasses.replace(sp, start=0))
        return rows

    return _patched(_dit(), "_rope_rows", make)


@contextlib.contextmanager
def vocal_frames():
    """The vocal branch drops the zero-padding of a slice that starts inside
    a latent frame: each rank's tokens are taken to start at the start of
    their first frame, so that they meet the audio of the wrong frames."""
    dit = _dit()
    shard = dit._seq_shard

    def make(real):
        def cross(p, x, *a, **k):
            frames = a[5]  # latents_num_frames

            def aligned(length):
                sp = shard(length)
                if sp is None:
                    return sp
                return dataclasses.replace(sp, start=sp.start - sp.start % (sp.total // frames))

            dit._seq_shard = aligned
            try:
                return real(p, x, *a, **k)
            finally:
                dit._seq_shard = shard
        return cross

    with _patched(dit, "_cross_attention", make):
        yield


SHARDING = {"no_exchange": no_exchange, "gather_swap": gather_swap, "rope_rows": rope_rows,
            "vocal_frames": vocal_frames}
USP = {**GEN, **SHARDING}


def plant(name):
    """The named fault's context manager; None: nothing planted."""
    return contextlib.nullcontext() if name is None else USP[name]()
