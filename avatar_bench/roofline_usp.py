"""What the sequence-parallel cell's readers count: rank 0's share of the
DiT's calls, the bytes the Ulysses exchanges send, the link's peak, and the
ranks' kernels in a trace.

A window-step's DiT runs each block's self-attention between two
all-to-alls (`models/dit.py:_seq_to_heads` for q, k and v, `_heads_to_seq`
for the output).  Each exchange starts from a rank's [rows, L/W, heads,
head_dim] bf16 slice and keeps 1/W of it: (W-1)/W of the slice leaves the
card.  The peak is NVLink 4's published bandwidth in one direction on one
H100 SXM (18 links of 25 GB/s).  NCCL's kernels are told from the rest by
name: the exchanges, `all_to_all_single`, run as NCCL's grouped send and
receive.
"""

from __future__ import annotations

import dataclasses
import re
from typing import List, Sequence

from avatar_bench.roofline import Call
from avatar_bench.trace import Interval, union_s

NVLINK_BYTES_S = 450e9  # one direction, one H100 SXM
BF16 = 2
# all-to-alls a block: q, k and v to heads, the output back to tokens
EXCHANGES_PER_BLOCK = 4
NCCL = re.compile(r"nccl", re.I)
EXCHANGE = re.compile(r"nccl\w*(SendRecv|AllToAll)", re.I)


def rank_calls(calls: Sequence[Call], world: int) -> List[Call]:
    """Rank 0's share of one DiT forward's calls: each call's operations and
    bytes over `world`.  The operations are each rank's exactly; a rank
    reads more bytes than that (every linear's weight whole, the text and
    image keys and values whole), and runs the prologue, the vocal
    projector and the head whole, so a bound from these calls is at most
    the rank's, and a roofline share from it at most the true one."""
    return [dataclasses.replace(x, flops=x.flops / world, nbytes=x.nbytes / world)
            for x in calls]


def exchange_bytes(c: dict, rows: int, tokens: int, world: int) -> float:
    """Bytes one card sends to the others in one DiT forward over `rows` CFG
    rows of `tokens` tokens split over `world` ranks."""
    per_exchange = rows * (tokens // world) * c["dim"] * BF16
    return c["num_layers"] * EXCHANGES_PER_BLOCK * per_exchange * (world - 1) / world


def nccl(device: Sequence[Interval]) -> List[Interval]:
    return [x for x in device if NCCL.search(x[0])]


def compute(device: Sequence[Interval]) -> List[Interval]:
    """The device operations other than NCCL's kernels."""
    return [x for x in device if not NCCL.search(x[0])]


def exchange_s(device: Sequence[Interval]) -> float:
    """Device seconds of the exchanges' kernels."""
    return sum(e - s for n, s, e in device if EXCHANGE.search(n))


def exposed_s(device: Sequence[Interval]) -> float:
    """Seconds in which an NCCL kernel runs and no other operation does:
    the union of both less the union of the others."""
    return union_s(list(device)) - union_s(compute(device))
