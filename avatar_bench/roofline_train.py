"""The work of a train step's DiT calls, from `roofline.dit_calls` at one
row: the forward, the backward (twice the forward's operations) and what
remat recomputes (each block's forward once more in the backward).

A linear's backward is two products the size of its forward, the input's
gradient (dgrad) and the weight's (wgrad): every parameter trains, and
only the linears that read a raw input of the step (the patch embedding,
the first time and text embedding layers, the vocal projector's input
projection) need no dgrad.  An attention call's backward recomputes the
logits and then forms dV, dP, dQ and dK: 2.5 times the forward's
operations, reading q, k, v, o and dO and writing dq, dk and dv (twice the
forward's bytes).  Model operations (`step_flops`) leave the recompute
out.
"""

from __future__ import annotations

from typing import List

from avatar_bench.roofline import Call, model_flops

NO_DGRAD = ("patch_embedding", "time_embedding.fc1", "text_embedding.fc1", "vocal.proj",
            "vocal.proj1")
BLOCK = ("self.", "cross.", "ffn.")  # linears inside the checkpointed blocks


def step_flops(calls: List[Call]) -> float:
    """The forward's and the backward's model operations, recompute left out."""
    return 3.0 * model_flops(calls)


def attn_fwd_bound_s(calls: List[Call]) -> float:
    """The attention calls' forward bound, twice: the forward and remat's."""
    return 2.0 * sum(x.bound_s for x in calls if x.kind == "attention")


def attention_backward(x: Call) -> Call:
    return Call(x.kind, x.name, 2.5 * x.flops, 2.0 * x.nbytes)


def attn_bwd_bound_s(calls: List[Call]) -> float:
    return sum(attention_backward(x).bound_s for x in calls if x.kind == "attention")


def linear_passes(x: Call) -> int:
    """Products a train step makes of the size of linear `x`'s forward."""
    return 1 + x.name.startswith(BLOCK) + (x.name not in NO_DGRAD) + 1


def gemm_bound_s(calls: List[Call]) -> float:
    """The linears' forward, recompute, dgrad and wgrad bounds (each pass
    reads and writes its three matrices once, so each has the forward's
    bound)."""
    return sum(linear_passes(x) * x.bound_s for x in calls if x.kind == "linear")
