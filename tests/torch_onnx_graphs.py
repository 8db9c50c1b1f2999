"""ONNX graphs for the port's runner, written as real ModelProto wire bytes
by a minimal protobuf writer (a copy of tests/test_onnx_runner.py's).

Imports numpy only -- no JAX, no torch -- so `chip_smoke.py` uses it too:
`mdx_graph` builds a graph of MDX-Net's Conv-TDF U-Net topology (the
Kim_Vocal_2 architecture) at any geometry, with seeded random weights.
"""

import struct

import numpy as np


def _varint(x: int) -> bytes:
    out = b""
    while True:
        b = x & 0x7F
        x >>= 7
        if x:
            out += bytes([b | 0x80])
        else:
            return out + bytes([b])


def _field(num, wt, payload: bytes) -> bytes:
    return _varint(num << 3 | wt) + payload


def _ld(num, payload: bytes) -> bytes:
    return _field(num, 2, _varint(len(payload)) + payload)


def tensor(name, arr: np.ndarray) -> bytes:
    out = b"".join(_field(1, 0, _varint(d)) for d in arr.shape)
    out += _field(2, 0, _varint(1))  # FLOAT
    out += _ld(8, name.encode())
    out += _ld(9, arr.astype("<f4").tobytes())
    return out


def tensor_i64(name, arr: np.ndarray) -> bytes:
    out = b"".join(_field(1, 0, _varint(d)) for d in arr.shape)
    out += _field(2, 0, _varint(7))  # INT64
    out += _ld(8, name.encode())
    out += _ld(9, arr.astype("<i8").tobytes())
    return out


def attr_ints(name, ints) -> bytes:
    out = _ld(1, name.encode())
    out += _ld(7, b"".join(_varint(i) for i in ints))
    out += _field(20, 0, _varint(7))  # type INTS
    return out


def attr_int(name, i) -> bytes:
    return _ld(1, name.encode()) + _field(3, 0, _varint(i)) + _field(20, 0, _varint(2))


def attr_float(name, f) -> bytes:
    return _ld(1, name.encode()) + _field(2, 5, struct.pack("<f", f)) + _field(20, 0, _varint(1))


def attrs(*chunks) -> bytes:
    return b"".join(_ld(5, c) for c in chunks)


def node(op, inputs, outputs, node_attrs=b"") -> bytes:
    out = b"".join(_ld(1, s.encode()) for s in inputs)
    out += b"".join(_ld(2, s.encode()) for s in outputs)
    out += _ld(4, op.encode())
    out += node_attrs
    return out


def model(nodes, initializers, inputs, outputs) -> bytes:
    g = b"".join(_ld(1, n) for n in nodes)
    g += b"".join(_ld(5, t) for t in initializers)
    g += b"".join(_ld(11, _ld(1, n.encode())) for n in inputs)
    g += b"".join(_ld(12, _ld(1, n.encode())) for n in outputs)
    return _ld(7, g)


# --------------------------------------------------------------------------
# the graphs of tests/test_onnx_runner.py, as (model bytes, {input: array})
# --------------------------------------------------------------------------


def conv_bn_relu_graph():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 3, 8, 8)).astype(np.float32)
    w1 = rng.standard_normal((4, 3, 3, 3)).astype(np.float32) * 0.2
    b1 = rng.standard_normal(4).astype(np.float32) * 0.1
    scale = rng.uniform(0.5, 1.5, 4).astype(np.float32)
    bias = rng.standard_normal(4).astype(np.float32) * 0.1
    mean = rng.standard_normal(4).astype(np.float32) * 0.1
    var = rng.uniform(0.5, 1.5, 4).astype(np.float32)
    w2 = rng.standard_normal((6, 4, 3, 3)).astype(np.float32) * 0.2
    nodes = [
        node("Conv", ["x", "w1", "b1"], ["c1"],
             attrs(attr_ints("pads", [1, 1, 1, 1]), attr_ints("strides", [1, 1]))),
        node("BatchNormalization", ["c1", "scale", "bias", "mean", "var"], ["bn"],
             attrs(attr_float("epsilon", 1e-5))),
        node("Relu", ["bn"], ["r1"]),
        node("Conv", ["r1", "w2"], ["c2"],
             attrs(attr_ints("pads", [1, 1, 1, 1]), attr_ints("strides", [2, 2]))),
        node("Concat", ["c2", "c2"], ["out"], attrs(attr_int("axis", 1))),
    ]
    inits = [tensor("w1", w1), tensor("b1", b1), tensor("scale", scale),
             tensor("bias", bias), tensor("mean", mean), tensor("var", var),
             tensor("w2", w2)]
    return model(nodes, inits, ["x"], ["out"]), {"x": x}


def conv_transpose_graph(pads=(1, 1, 1, 1), output_padding=None):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, 4, 5, 5)).astype(np.float32)
    w = rng.standard_normal((4, 3, 4, 4)).astype(np.float32) * 0.2  # [Cin, Cout, kH, kW]
    b = rng.standard_normal(3).astype(np.float32) * 0.1
    a = [attr_ints("pads", list(pads)), attr_ints("strides", [2, 2])]
    if output_padding is not None:
        a.append(attr_ints("output_padding", list(output_padding)))
    nodes = [node("ConvTranspose", ["x", "w", "b"], ["out"], attrs(*a))]
    return model(nodes, [tensor("w", w), tensor("b", b)], ["x"], ["out"]), {"x": x}


def gemm_graph():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    b = rng.standard_normal(4).astype(np.float32)
    nodes = [
        node("Gemm", ["x", "w", "b"], ["g"], attrs(attr_int("transB", 1))),
        node("Sigmoid", ["g"], ["out"]),
    ]
    return model(nodes, [tensor("w", w), tensor("b", b)], ["x"], ["out"]), {"x": x}


def maxpool_node():
    """MaxPool declaring an Indices output besides its values."""
    return node("MaxPool", ["x"], ["y", "idx"],
                attrs(attr_ints("kernel_shape", [2, 2]), attr_ints("strides", [2, 2])))


def mdx_graph(c=4, g=4, f=16, t=8, crop=2, tdf_div=2, seed=3, scale=0.2):
    """A Conv-TDF U-Net of MDX-Net's topology (the Kim_Vocal_2 architecture
    the reference separates vocals with, `vocal_seperator.py:20-26`): a
    frequency-crop Slice, a 1x1 stem conv, TFC blocks (Conv + BatchNorm +
    ReLU), a TDF bottleneck over the frequency axis (Transpose / MatMul /
    Add / Relu / MatMul / Add / Transpose, plus a residual Add, hidden width
    f // tdf_div), a strided-Conv downsample, a GroupNormalization
    bottleneck, a ConvTranspose upsample, a Concat skip and a Sigmoid . Mul
    mask head.  Input "x" [1, c, f + crop, t], output "out" [1, c, f, t];
    f and t even.  Returns (model bytes, {"x": input}) with seeded weights
    (tests/test_onnx_runner.py's graph at the defaults)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1, c, f + crop, t)).astype(np.float32)

    def w(*shape, s=scale):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    def bn(ch):
        return (rng.uniform(0.5, 1.5, ch).astype(np.float32), w(ch, s=0.1), w(ch, s=0.1),
                rng.uniform(0.5, 1.5, ch).astype(np.float32))

    h = f // tdf_div
    weights = {}
    weights["stem_w"], weights["stem_b"] = w(g, c, 1, 1), w(g)
    bn1 = bn(g)
    weights["tfc1_w"], weights["tfc1_b"] = w(g, g, 3, 3), w(g)
    bn2 = bn(g)
    weights["tdf1_w"], weights["tdf1_b"] = w(f, h), w(h)
    weights["tdf2_w"], weights["tdf2_b"] = w(h, f), w(f)
    weights["down_w"], weights["down_b"] = w(2 * g, g, 2, 2), w(2 * g)
    bn3 = bn(2 * g)
    weights["mid_w"], weights["mid_b"] = w(2 * g, 2 * g, 3, 3), w(2 * g)
    weights["gn_s"] = rng.uniform(0.5, 1.5, 2 * g).astype(np.float32)
    weights["gn_b"] = w(2 * g, s=0.1)
    weights["up_w"], weights["up_b"] = w(2 * g, g, 2, 2), w(g)  # [Cin, Cout, kH, kW]
    bn4 = bn(g)
    weights["dec_w"], weights["dec_b"] = w(g, 2 * g, 3, 3), w(g)
    bn5 = bn(g)
    weights["head_w"], weights["head_b"] = w(c, g, 1, 1), w(c)

    eps = 1e-5
    conv_attrs = attrs(attr_ints("pads", [1, 1, 1, 1]), attr_ints("strides", [1, 1]))
    bn_attrs = attrs(attr_float("epsilon", eps))

    def bn_node(x_name, name, out):
        return node("BatchNormalization", [x_name, f"{name}_s", f"{name}_b", f"{name}_m",
                                           f"{name}_v"], [out], bn_attrs)

    nodes = [
        # dim_f crop (the real net slices the STFT to dim_f bins)
        node("Slice", ["x", "sl_starts", "sl_ends", "sl_axes"], ["xc"]),
        node("Conv", ["xc", "stem_w", "stem_b"], ["s0"]),
        bn_node("s0", "bn1", "s1"),
        node("Relu", ["s1"], ["s2"]),
        # TFC
        node("Conv", ["s2", "tfc1_w", "tfc1_b"], ["t0"], conv_attrs),
        bn_node("t0", "bn2", "t1"),
        node("Relu", ["t1"], ["t2"]),
        # TDF over the frequency axis: [B, C, F, T] -> [B, C, T, F] -> dense(F)
        node("Transpose", ["t2"], ["d0"], attrs(attr_ints("perm", [0, 1, 3, 2]))),
        node("MatMul", ["d0", "tdf1_w"], ["d1"]),
        node("Add", ["d1", "tdf1_b"], ["d2"]),
        node("Relu", ["d2"], ["d3"]),
        node("MatMul", ["d3", "tdf2_w"], ["d4"]),
        node("Add", ["d4", "tdf2_b"], ["d5"]),
        node("Transpose", ["d5"], ["d6"], attrs(attr_ints("perm", [0, 1, 3, 2]))),
        node("Add", ["t2", "d6"], ["enc1"]),  # residual
        # downsample
        node("Conv", ["enc1", "down_w", "down_b"], ["dn0"], attrs(attr_ints("strides", [2, 2]))),
        bn_node("dn0", "bn3", "dn1"),
        node("Relu", ["dn1"], ["dn2"]),
        # bottleneck TFC + GroupNorm
        node("Conv", ["dn2", "mid_w", "mid_b"], ["m0"], conv_attrs),
        node("GroupNormalization", ["m0", "gn_s", "gn_b"], ["m1"],
             attrs(attr_float("epsilon", eps), attr_int("num_groups", 2))),
        node("Relu", ["m1"], ["m2"]),
        # upsample + skip concat + decoder TFC
        node("ConvTranspose", ["m2", "up_w", "up_b"], ["u0"],
             attrs(attr_ints("strides", [2, 2]))),
        bn_node("u0", "bn4", "u1"),
        node("Relu", ["u1"], ["u2"]),
        node("Concat", ["u2", "enc1"], ["cat"], attrs(attr_int("axis", 1))),
        node("Conv", ["cat", "dec_w", "dec_b"], ["dc0"], conv_attrs),
        bn_node("dc0", "bn5", "dc1"),
        node("Relu", ["dc1"], ["dc2"]),
        # mask head: a sigmoid mask applied to the cropped input
        node("Conv", ["dc2", "head_w", "head_b"], ["h0"]),
        node("Sigmoid", ["h0"], ["mask"]),
        node("Mul", ["mask", "xc"], ["out"]),
    ]
    inits = [tensor_i64("sl_starts", np.array([0])), tensor_i64("sl_ends", np.array([f])),
             tensor_i64("sl_axes", np.array([2]))]
    inits += [tensor(k, v) for k, v in weights.items()]
    for name, (s_, b_, m_, v_) in zip(["bn1", "bn2", "bn3", "bn4", "bn5"],
                                      [bn1, bn2, bn3, bn4, bn5]):
        inits += [tensor(f"{name}_s", s_), tensor(f"{name}_b", b_),
                  tensor(f"{name}_m", m_), tensor(f"{name}_v", v_)]
    return model(nodes, inits, ["x"], ["out"]), {"x": x}
