"""Minimal ONNX model runner on PyTorch -- no onnx / onnxruntime dependency
(port of `stableavatar_tpu/utils/onnx_runner.py`).

The reference's vocal separator runs MDX-Net (Kim_Vocal_2.onnx) through the
`audio-separator` ONNX-Runtime package (`vocal_seperator.py:20-26`).  This
module executes such a model natively in two pieces:

1. a protobuf *wire-format* parser for the ONNX ModelProto subset (graph,
   nodes, initializers, attributes, tensors), copied from the JAX package;
2. a topological executor on torch tensors on an explicit device, covering
   the convolutional op set MDX-Net / UVR models use (Conv, ConvTranspose,
   the normalisations, activations, elementwise ops, Reshape / Transpose /
   Concat / Slice, MatMul / Gemm, pooling, Pad and the shape ops).

Unsupported ops raise with the op name.  The convolutions are cuDNN's on
the card: `run_graph` runs them with TF32 off, so the card computes in fp32
as the CPU does (PyTorch keeps TF32 off for matmuls unless a caller turns
it on).  tests/test_torch_onnx_runner.py holds the parser and the
executor against the JAX package's on graphs written by a minimal writer.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# protobuf wire format
# ---------------------------------------------------------------------------


def _read_varint(buf: memoryview, pos: int):
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _fields(buf: memoryview):
    """Yield (field_number, wire_type, value) triples of one message."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wt = key >> 3, key & 7
        if wt == 0:
            val, pos = _read_varint(buf, pos)
        elif wt == 1:
            val = bytes(buf[pos : pos + 8])
            pos += 8
        elif wt == 2:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos : pos + ln]
            pos += ln
        elif wt == 5:
            val = bytes(buf[pos : pos + 4])
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield field, wt, val


def _packed_varints(v) -> List[int]:
    out = []
    pos = 0
    while pos < len(v):
        x, pos = _read_varint(v, pos)
        out.append(x)
    return out


def _svarint(x: int) -> int:
    """Interpret a varint as signed 64-bit (two's complement)."""
    return x - (1 << 64) if x >= 1 << 63 else x


class Tensor:
    def __init__(self):
        self.dims: List[int] = []
        self.data_type = 1
        self.name = ""
        self.raw = b""
        self.float_data: List[float] = []
        self.int64_data: List[int] = []

    def to_numpy(self) -> np.ndarray:
        dt = {1: np.float32, 7: np.int64, 10: np.float16, 6: np.int32,
              9: np.bool_, 11: np.float64}[self.data_type]
        if self.raw:
            arr = np.frombuffer(self.raw, dtype=dt)
        elif self.float_data:
            arr = np.asarray(self.float_data, np.float32)
        elif self.int64_data:
            arr = np.asarray(self.int64_data, np.int64)
        else:
            arr = np.zeros(0, dt)
        return arr.reshape(self.dims) if self.dims else arr.reshape(())


def _parse_tensor(buf) -> Tensor:
    t = Tensor()
    for f, wt, v in _fields(buf):
        if f == 1:
            t.dims.extend(_packed_varints(v) if wt == 2 else [_svarint(v)])
        elif f == 2:
            t.data_type = v
        elif f == 4:
            t.float_data.extend(struct.unpack(f"<{len(v) // 4}f", bytes(v)))
        elif f == 7:
            t.int64_data.extend(
                [_svarint(x) for x in (_packed_varints(v) if wt == 2 else [v])]
            )
        elif f == 8:
            t.name = bytes(v).decode()
        elif f == 9:
            t.raw = bytes(v)
    return t


class Attr:
    def __init__(self):
        self.name = ""
        self.f = None
        self.i = None
        self.s = None
        self.t: Optional[Tensor] = None
        self.floats: List[float] = []
        self.ints: List[int] = []

    @property
    def value(self):
        for v in (self.t, self.s, self.f, self.i):
            if v is not None:
                return v.to_numpy() if isinstance(v, Tensor) else v
        return self.ints if self.ints else self.floats


def _parse_attr(buf) -> Attr:
    a = Attr()
    for f, wt, v in _fields(buf):
        if f == 1:
            a.name = bytes(v).decode()
        elif f == 2:
            a.f = struct.unpack("<f", v)[0]
        elif f == 3:
            a.i = _svarint(v)
        elif f == 4:
            a.s = bytes(v)
        elif f == 5:
            a.t = _parse_tensor(v)
        elif f == 6:
            a.floats.extend(struct.unpack(f"<{len(v) // 4}f", bytes(v))
                            if wt == 2 else [struct.unpack("<f", v)[0]])
        elif f == 7:
            a.ints.extend(
                [_svarint(x) for x in (_packed_varints(v) if wt == 2 else [v])]
            )
    return a


class Node:
    def __init__(self):
        self.inputs: List[str] = []
        self.outputs: List[str] = []
        self.op_type = ""
        self.attrs: Dict[str, Attr] = {}


def _parse_node(buf) -> Node:
    n = Node()
    for f, wt, v in _fields(buf):
        if f == 1:
            n.inputs.append(bytes(v).decode())
        elif f == 2:
            n.outputs.append(bytes(v).decode())
        elif f == 4:
            n.op_type = bytes(v).decode()
        elif f == 5:
            a = _parse_attr(v)
            n.attrs[a.name] = a
    return n


class OnnxGraph:
    def __init__(self):
        self.nodes: List[Node] = []
        self.initializers: Dict[str, np.ndarray] = {}
        self.inputs: List[str] = []
        self.outputs: List[str] = []


def _parse_value_info_name(buf) -> str:
    for f, wt, v in _fields(buf):
        if f == 1:
            return bytes(v).decode()
    return ""


def parse_onnx(data: bytes) -> OnnxGraph:
    """Parse an ONNX ModelProto byte string into an OnnxGraph."""
    g = OnnxGraph()
    graph_buf = None
    for f, wt, v in _fields(memoryview(data)):
        if f == 7:
            graph_buf = v
    if graph_buf is None:
        raise ValueError("no graph in ONNX model")
    for f, wt, v in _fields(graph_buf):
        if f == 1:
            g.nodes.append(_parse_node(v))
        elif f == 5:
            t = _parse_tensor(v)
            g.initializers[t.name] = t.to_numpy()
        elif f == 11:
            g.inputs.append(_parse_value_info_name(v))
        elif f == 12:
            g.outputs.append(_parse_value_info_name(v))
    g.inputs = [i for i in g.inputs if i not in g.initializers]
    return g


# ---------------------------------------------------------------------------
# executor on torch tensors
# ---------------------------------------------------------------------------

# onnx TensorProto.DataType -> torch
_DTYPES = {1: torch.float32, 6: torch.int32, 7: torch.int64, 9: torch.bool,
           10: torch.float16, 11: torch.float64}


def _host(x) -> np.ndarray:
    """A shape / index operand as numpy (it may live on the card)."""
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _conv(x, w, b, attrs, transpose=False):
    strides = tuple(attrs["strides"].ints) if "strides" in attrs else (1, 1)
    pads = tuple(attrs["pads"].ints) if "pads" in attrs else (0,) * 4
    dil = tuple(attrs["dilations"].ints) if "dilations" in attrs else (1, 1)
    groups = attrs["group"].i if "group" in attrs else 1
    if "auto_pad" in attrs and attrs["auto_pad"].s not in (None, b"", b"NOTSET"):
        raise NotImplementedError(f"Conv auto_pad={attrs['auto_pad'].s!r}")
    nd = x.ndim - 2
    assert nd == 2, "only 2-D convs implemented (the MDX-Net op set)"
    if len(strides) < nd:
        strides = strides * nd
    # onnx pads = [b1, b2, ..., e1, e2, ...]
    padding = [(pads[k], pads[k + nd]) for k in range(nd)]
    if not transpose:
        # F.pad takes the last axis first
        x = F.pad(x, [p for pair in reversed(padding) for p in pair])
        out = F.conv2d(x, w, None, strides, 0, dil, groups)
    else:
        # the full transposed conv (weight [C_in, C_out/groups, kH, kW]),
        # then the onnx output window: it starts pad_b into the full output
        # and is (in-1)*stride - pad_b - pad_e + dil*(k-1) + 1 + output_padding
        # long, zeros past the full output's end
        opad = (tuple(attrs["output_padding"].ints)
                if "output_padding" in attrs else (0,) * nd)
        full = F.conv_transpose2d(x, w, None, strides, 0, 0, groups, dil)
        sizes = [(x.shape[2 + k] - 1) * strides[k] - padding[k][0] - padding[k][1]
                 + dil[k] * (w.shape[2 + k] - 1) + 1 + opad[k] for k in range(nd)]
        short = [max(0, padding[k][0] + sizes[k] - full.shape[2 + k]) for k in range(nd)]
        full = F.pad(full, [p for k in reversed(range(nd)) for p in (0, short[k])])
        out = full[:, :, padding[0][0]:padding[0][0] + sizes[0],
                   padding[1][0]:padding[1][0] + sizes[1]]
    if b is not None:
        out = out + b.reshape((1, -1) + (1,) * nd)
    return out


def _pool(x, op, ks, strides):
    nd = len(ks)
    if nd not in (1, 2, 3):
        raise NotImplementedError(f"{op} over {nd} spatial axes")
    fn = {("MaxPool", 1): F.max_pool1d, ("MaxPool", 2): F.max_pool2d,
          ("MaxPool", 3): F.max_pool3d, ("AveragePool", 1): F.avg_pool1d,
          ("AveragePool", 2): F.avg_pool2d, ("AveragePool", 3): F.avg_pool3d}[op, nd]
    return fn(x, ks, strides)


def _slice(x, starts, ends, axes, steps):
    sl = [slice(None)] * x.ndim
    flips = []
    for s, e, ax, st in zip(starts, ends, axes, steps):
        s_ = slice(s, None if e >= 2**31 else e, st)
        if st > 0:
            sl[ax] = s_
        else:  # torch slices take no negative step: gather the indices
            flips.append((ax, torch.arange(*s_.indices(x.shape[ax]), device=x.device)))
    x = x[tuple(sl)]
    for ax, idx in flips:
        x = x.index_select(ax, idx)
    return x


def graph_weights(graph: OnnxGraph, device="cuda") -> Dict[str, torch.Tensor]:
    """The graph's initializers as tensors on `device`: copy them once and
    pass them to every `run_graph` call of the graph."""
    from stableavatar_tpu_torch.pipelines.common import resolve_device

    device = resolve_device(device)
    return {k: torch.from_numpy(np.array(v)).to(device) for k, v in graph.initializers.items()}


def run_graph(graph: OnnxGraph, inputs: Dict[str, np.ndarray], device="cuda",
              weights: Optional[Dict[str, torch.Tensor]] = None):
    """Execute the graph on `device` (the card unless the caller asks for
    the CPU); returns a dict of output name -> torch tensor there.
    `weights` are the initializers already on `device` (`graph_weights`);
    without them each call copies them there.  The convolutions run in
    fp32 (TF32 off) on the card."""
    from stableavatar_tpu_torch.pipelines.common import resolve_device

    device = resolve_device(device)
    if weights is None:
        weights = graph_weights(graph, device)
    with torch.no_grad(), torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        return _run(graph, inputs, device, weights)


def _run(graph: OnnxGraph, inputs, device, weights):
    env: Dict[str, object] = dict(weights)
    env.update({k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v,
                                   device=device) for k, v in inputs.items()})

    def get(name):
        return env[name] if name else None

    # names actually read anywhere in the graph: dead declared outputs
    # (e.g. MaxPool's optional Indices) are allowed to go uncomputed
    consumed = {i for n in graph.nodes for i in n.inputs if i}

    for node in graph.nodes:
        i = node.inputs
        op = node.op_type
        a = node.attrs
        if op in ("Conv", "ConvTranspose"):
            out = _conv(get(i[0]), env[i[1]], env[i[2]] if len(i) > 2 else None, a,
                        transpose=op == "ConvTranspose")
        elif op == "BatchNormalization":
            x, sc, bi, mean, var = (get(n) for n in i[:5])
            eps = a["epsilon"].f if "epsilon" in a else 1e-5
            shape = (1, -1) + (1,) * (x.ndim - 2)
            out = (x - mean.reshape(shape)) / torch.sqrt(var.reshape(shape) + eps)
            out = out * sc.reshape(shape) + bi.reshape(shape)
        elif op == "InstanceNormalization":
            x, sc, bi = (get(n) for n in i[:3])
            eps = a["epsilon"].f if "epsilon" in a else 1e-5
            axes = tuple(range(2, x.ndim))
            m = x.mean(dim=axes, keepdim=True)
            v = x.var(dim=axes, keepdim=True, unbiased=False)
            shape = (1, -1) + (1,) * (x.ndim - 2)
            out = (x - m) / torch.sqrt(v + eps) * sc.reshape(shape) + bi.reshape(shape)
        elif op == "GroupNormalization":
            x, sc, bi = (get(n) for n in i[:3])
            eps = a["epsilon"].f if "epsilon" in a else 1e-5
            ng = a["num_groups"].i
            b_, c = x.shape[:2]
            xs = x.reshape(b_, ng, c // ng, *x.shape[2:])
            axes = tuple(range(2, xs.ndim))
            m = xs.mean(dim=axes, keepdim=True)
            v = xs.var(dim=axes, keepdim=True, unbiased=False)
            xs = (xs - m) / torch.sqrt(v + eps)
            shape = (1, -1) + (1,) * (x.ndim - 2)
            out = xs.reshape(x.shape) * sc.reshape(shape) + bi.reshape(shape)
        elif op == "Relu":
            out = torch.relu(get(i[0]))
        elif op == "LeakyRelu":
            alpha = a["alpha"].f if "alpha" in a else 0.01
            x = get(i[0])
            out = torch.where(x >= 0, x, alpha * x)
        elif op == "Elu":
            alpha = a["alpha"].f if "alpha" in a else 1.0
            x = get(i[0])
            out = torch.where(x >= 0, x, alpha * (torch.exp(x) - 1))
        elif op == "Sigmoid":
            out = 1.0 / (1.0 + torch.exp(-get(i[0])))
        elif op == "Tanh":
            out = torch.tanh(get(i[0]))
        elif op in ("Add", "Sub", "Mul", "Div"):
            x, y = get(i[0]), get(i[1])
            out = {"Add": torch.add, "Sub": torch.sub, "Mul": torch.mul,
                   "Div": torch.div}[op](x, y)
        elif op == "Concat":
            out = torch.cat([get(n) for n in i], dim=a["axis"].i)
        elif op == "Transpose":
            out = get(i[0]).permute(*a["perm"].ints)
        elif op == "Reshape":
            out = get(i[0]).reshape([int(s) for s in _host(env[i[1]])])
        elif op == "Slice":
            starts = _host(env[i[1]]).tolist()
            ends = _host(env[i[2]]).tolist()
            axes = _host(env[i[3]]).tolist() if len(i) > 3 else list(range(len(starts)))
            steps = _host(env[i[4]]).tolist() if len(i) > 4 else [1] * len(starts)
            out = _slice(get(i[0]), starts, ends, axes, steps)
        elif op == "MatMul":
            out = torch.matmul(get(i[0]), get(i[1]))
        elif op == "Gemm":
            x, w = get(i[0]), get(i[1])
            if a.get("transA") and a["transA"].i:
                x = x.T
            if a.get("transB") and a["transB"].i:
                w = w.T
            alpha = a["alpha"].f if "alpha" in a else 1.0
            beta = a["beta"].f if "beta" in a else 1.0
            out = alpha * (x @ w)
            if len(i) > 2:
                out = out + beta * get(i[2])
        elif op in ("AveragePool", "MaxPool"):
            ks = tuple(a["kernel_shape"].ints)
            strides = tuple(a["strides"].ints) if "strides" in a else ks
            out = _pool(get(i[0]), op, ks, strides)
        elif op == "GlobalAveragePool":
            x = get(i[0])
            out = x.mean(dim=tuple(range(2, x.ndim)), keepdim=True)
        elif op == "Identity":
            out = get(i[0])
        elif op == "Cast":
            to = a["to"].i
            if to not in _DTYPES:
                raise NotImplementedError(f"Cast to data_type {to}")
            out = get(i[0]).to(_DTYPES[to])
        elif op == "Unsqueeze":
            axes = (_host(env[i[1]]).tolist() if len(i) > 1 else list(a["axes"].ints))
            out = get(i[0])
            for ax in sorted(axes):
                out = out.unsqueeze(ax)
        elif op == "Squeeze":
            axes = (_host(env[i[1]]).tolist() if len(i) > 1 else list(a["axes"].ints))
            out = get(i[0]).squeeze(tuple(axes))
        elif op == "Constant":
            out = torch.from_numpy(np.array(a["value"].t.to_numpy())).to(device)
        elif op == "Pad":
            x = get(i[0])
            pads = ([int(p) for p in _host(env[i[1]])] if len(i) > 1
                    else list(a["pads"].ints))
            nd = x.ndim
            out = F.pad(x, [p for d in reversed(range(nd)) for p in (pads[d], pads[d + nd])])
        else:
            raise NotImplementedError(f"ONNX op not implemented: {op}")
        # a node with a DECLARED extra output is fine when that output is
        # dead (MaxPool's optional Indices); a consumed one must fail loudly
        # rather than produce wrong values downstream
        extra = [o for o in node.outputs[1:]
                 if o and (o in consumed or o in graph.outputs)]
        if extra:
            raise NotImplementedError(
                f"{op} declares unsupported extra outputs {extra} "
                "that are consumed downstream"
            )
        env[node.outputs[0]] = out

    return {o: env[o] for o in graph.outputs}


def load_onnx(path: str) -> OnnxGraph:
    with open(path, "rb") as f:
        return parse_onnx(f.read())
