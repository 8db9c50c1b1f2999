"""The port's ONNX runner (`stableavatar_tpu_torch/utils/onnx_runner.py`)
against the JAX package's: the same wire bytes (tests/torch_onnx_graphs.py,
a copy of tests/test_onnx_runner.py's writer and graphs) parse to the same
graph, and the torch executor on the CPU gives the JAX executor's outputs
at rel 1e-5 (fp32)."""

import numpy as np
import pytest
import torch

from stableavatar_tpu.utils import onnx_runner as jrunner
from stableavatar_tpu_torch.utils import onnx_runner as trunner
from tests import torch_onnx_graphs as graphs


def _attr_value(a):
    v = a.value
    return v.tolist() if isinstance(v, np.ndarray) else v


def _same_graph(t, j):
    assert t.inputs == j.inputs and t.outputs == j.outputs
    assert [n.op_type for n in t.nodes] == [n.op_type for n in j.nodes]
    for tn, jn in zip(t.nodes, j.nodes):
        assert tn.inputs == jn.inputs and tn.outputs == jn.outputs
        assert {k: _attr_value(a) for k, a in tn.attrs.items()} == \
            {k: _attr_value(a) for k, a in jn.attrs.items()}
    assert list(t.initializers) == list(j.initializers)
    for k, v in j.initializers.items():
        assert t.initializers[k].dtype == v.dtype
        np.testing.assert_array_equal(t.initializers[k], v)


def _assert_rel(got, want, rel=1e-5):
    """Elementwise within rel of each value, or of the largest one."""
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * float(np.abs(want).max()))


GRAPHS = {
    "conv_bn_relu": graphs.conv_bn_relu_graph,
    "conv_transpose": graphs.conv_transpose_graph,
    "conv_transpose_asym_opad": lambda: graphs.conv_transpose_graph((1, 0, 2, 1), (1, 1)),
    "gemm_sigmoid": graphs.gemm_graph,
    "mdx_topology": graphs.mdx_graph,
}


@pytest.mark.parametrize("name", list(GRAPHS))
def test_parser_equals_jax(name):
    data, _ = GRAPHS[name]()
    _same_graph(trunner.parse_onnx(data), jrunner.parse_onnx(data))


@pytest.mark.parametrize("name", list(GRAPHS))
def test_run_graph_matches_jax(name):
    data, inputs = GRAPHS[name]()
    want = {k: np.asarray(v) for k, v in jrunner.run_graph(jrunner.parse_onnx(data),
                                                           inputs).items()}
    got = trunner.run_graph(trunner.parse_onnx(data), inputs, device="cpu")
    assert list(got) == list(want)
    for k in want:
        assert got[k].device.type == "cpu" and got[k].dtype == torch.float32
        _assert_rel(got[k].numpy(), want[k])


def test_mdx_topology_matches_torch_modules():
    """The MDX-topology graph against the same network written with
    torch.nn.functional (the JAX test's oracle, tests/test_onnx_runner.py)."""
    data, inputs = graphs.mdx_graph()
    g = trunner.parse_onnx(data)
    got = trunner.run_graph(g, inputs, device="cpu")["out"].numpy()
    p = {k: torch.from_numpy(np.array(v)) for k, v in g.initializers.items()}
    tf = torch.nn.functional

    def bn(t, name):
        return tf.batch_norm(t, p[f"{name}_m"], p[f"{name}_v"], p[f"{name}_s"],
                             p[f"{name}_b"], eps=1e-5)

    with torch.no_grad():
        tx = torch.from_numpy(inputs["x"])[:, :, :16, :]
        t = torch.relu(bn(tf.conv2d(tx, p["stem_w"], p["stem_b"]), "bn1"))
        t = torch.relu(bn(tf.conv2d(t, p["tfc1_w"], p["tfc1_b"], padding=1), "bn2"))
        d = t.permute(0, 1, 3, 2)
        d = torch.relu(d @ p["tdf1_w"] + p["tdf1_b"])
        enc1 = t + (d @ p["tdf2_w"] + p["tdf2_b"]).permute(0, 1, 3, 2)
        t = torch.relu(bn(tf.conv2d(enc1, p["down_w"], p["down_b"], stride=2), "bn3"))
        t = tf.conv2d(t, p["mid_w"], p["mid_b"], padding=1)
        t = torch.relu(tf.group_norm(t, 2, p["gn_s"], p["gn_b"], eps=1e-5))
        t = torch.relu(bn(tf.conv_transpose2d(t, p["up_w"], p["up_b"], stride=2), "bn4"))
        t = torch.cat([t, enc1], dim=1)
        t = torch.relu(bn(tf.conv2d(t, p["dec_w"], p["dec_b"], padding=1), "bn5"))
        want = (torch.sigmoid(tf.conv2d(t, p["head_w"], p["head_b"])) * tx).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("op,build", [
    ("Softmax", lambda: graphs.model([graphs.node("Softmax", ["x"], ["y"])], [], ["x"], ["y"])),
    ("LSTM", lambda: graphs.model([graphs.node("LSTM", ["x"], ["y"])], [], ["x"], ["y"])),
])
def test_unsupported_op_raises_with_its_name(op, build):
    g = trunner.parse_onnx(build())
    with pytest.raises(NotImplementedError, match=f"ONNX op not implemented: {op}"):
        trunner.run_graph(g, {"x": np.zeros((1, 4), np.float32)}, device="cpu")


def test_dead_extra_output_allowed_consumed_raises():
    """As tests/test_onnx_runner.py: MaxPool's unread Indices output is
    fine; the same output as a graph output or read downstream raises."""
    x = np.arange(16, dtype=np.float32).reshape(1, 1, 4, 4)
    n = graphs.maxpool_node()
    g = trunner.parse_onnx(graphs.model([n], [], ["x"], ["y"]))
    out = trunner.run_graph(g, {"x": x}, device="cpu")
    np.testing.assert_array_equal(out["y"].numpy().reshape(2, 2),
                                  np.array([[5, 7], [13, 15]], np.float32))
    g2 = trunner.parse_onnx(graphs.model([n], [], ["x"], ["y", "idx"]))
    with pytest.raises(NotImplementedError, match="extra outputs"):
        trunner.run_graph(g2, {"x": x}, device="cpu")
    g3 = trunner.parse_onnx(graphs.model([n, graphs.node("Relu", ["idx"], ["z"])], [],
                                         ["x"], ["z"]))
    with pytest.raises(NotImplementedError, match="extra outputs"):
        trunner.run_graph(g3, {"x": x}, device="cpu")


def test_shape_ops_match_jax():
    """Reshape, Unsqueeze, Squeeze, Pad, Cast, a negative-step Slice, the
    pools and the normalisations without a conv, against the JAX runner."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1, 4, 6, 6)).astype(np.float32)
    n = graphs.node
    a = graphs.attrs
    nodes = [
        n("InstanceNormalization", ["x", "in_s", "in_b"], ["i0"]),
        n("LeakyRelu", ["i0"], ["i1"], a(graphs.attr_float("alpha", 0.2))),
        n("Elu", ["i1"], ["i2"]),
        n("Tanh", ["i2"], ["i3"]),
        n("Pad", ["i3", "pads"], ["p0"]),
        n("AveragePool", ["p0"], ["a0"], a(graphs.attr_ints("kernel_shape", [2, 2]))),
        n("MaxPool", ["p0"], ["m0"], a(graphs.attr_ints("kernel_shape", [2, 2]),
                                       graphs.attr_ints("strides", [2, 2]))),
        n("Sub", ["a0", "m0"], ["s0"]),
        n("Div", ["s0", "two"], ["s1"]),
        n("Slice", ["s1", "st", "en", "ax", "sp"], ["s2"]),
        n("GlobalAveragePool", ["s2"], ["g0"]),
        n("Squeeze", ["g0", "sq_axes"], ["g1"]),
        n("Unsqueeze", ["g1", "un_axes"], ["g2"]),
        n("Reshape", ["s2", "shape"], ["r0"]),
        n("Identity", ["r0"], ["r1"]),
        n("Cast", ["r1"], ["r2"], a(graphs.attr_int("to", 11))),
        n("Cast", ["r2"], ["out"], a(graphs.attr_int("to", 1))),
    ]
    inits = [graphs.tensor("in_s", rng.uniform(0.5, 1.5, 4).astype(np.float32)),
             graphs.tensor("in_b", rng.standard_normal(4).astype(np.float32)),
             graphs.tensor_i64("pads", np.array([0, 0, 1, 1, 0, 0, 1, 1])),
             graphs.tensor("two", np.array([2.0], np.float32)),
             graphs.tensor_i64("st", np.array([3, 0])), graphs.tensor_i64("en", np.array([0, 9])),
             graphs.tensor_i64("ax", np.array([2, 3])), graphs.tensor_i64("sp", np.array([-1, 2])),
             graphs.tensor_i64("sq_axes", np.array([2, 3])),
             graphs.tensor_i64("un_axes", np.array([0])),
             graphs.tensor_i64("shape", np.array([1, -1]))]
    data = graphs.model(nodes, inits, ["x"], ["out", "g2"])
    want = jrunner.run_graph(jrunner.parse_onnx(data), {"x": x})
    got = trunner.run_graph(trunner.parse_onnx(data), {"x": x}, device="cpu")
    for k in ("out", "g2"):
        _assert_rel(got[k].numpy(), np.asarray(want[k]))


def test_run_graph_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a host without CUDA")
    data, inputs = graphs.gemm_graph()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trunner.run_graph(trunner.parse_onnx(data), inputs)
