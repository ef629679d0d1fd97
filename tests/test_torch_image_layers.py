"""Port parity: the image layers the port gained for LeNet, VGG and the
generative family (``models/layers.py``: ``normal_init``,
``conv_transpose``, ``avg_pool``, ``rms_norm``, ``instance_norm``,
``embedding_init``) and the ``utils`` surface the recipes call
(``boost``, ``seed``'s ``deterministic``, ``detach``, ``to_array``,
``stack_dictionaries``, ``trace``/``annotate``), against the JAX package
on the CPU. Inputs are made once with numpy from a seed and fed to both;
fp32 throughout, at atol = rtol = 1e-5 unless a case says otherwise."""
import collections

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torchbooster_tpu import utils as jutils
from torchbooster_tpu.models import layers as JL
from torchbooster_tpu_torch import utils
from torchbooster_tpu_torch.models import layers as L

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.tensor(np.asarray(a), requires_grad=True)


@pytest.mark.parametrize("k", [3, 4])
@pytest.mark.parametrize("padding", ["SAME", "VALID"])
def test_conv_transpose_matches_jax(k, padding):
    """Stride 2 on a 5×6 map with a kernel whose taps differ under a flip
    and under an I/O swap (3 in, 4 out): forward and the gradients of x,
    kernel and bias. ``F.conv_transpose2d`` with the same weights would
    fail this (it flips the taps)."""
    rs = np.random.RandomState(10 * k + len(padding))
    x = rs.randn(2, 5, 6, 3).astype(np.float32)
    w = rs.randn(k, k, 3, 4).astype(np.float32)
    w[0, 0] += 3.0                      # no spatial symmetry
    b = rs.randn(4).astype(np.float32)

    def jfn(x, w, b):
        return JL.conv_transpose({"kernel": w, "bias": b}, x, 2, padding)

    want = jfn(*map(jnp.asarray, (x, w, b)))
    want_g = jax.grad(lambda *a: (jfn(*a) ** 2).sum(), argnums=(0, 1, 2))(
        *map(jnp.asarray, (x, w, b)))
    tx, tw, tb = _t(x), _t(w), _t(b)
    got = L.conv_transpose({"kernel": tw, "bias": tb}, tx, 2, padding)
    (got ** 2).sum().backward()
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    for name, g, w_ in zip("xwb", (tx.grad, tw.grad, tb.grad), want_g):
        w_ = np.asarray(w_)
        np.testing.assert_allclose(g.numpy(), w_, rtol=1e-5,
                                   atol=1e-5 * np.abs(w_).max(),
                                   err_msg=f"d{name}")
    flipped = torch.nn.functional.conv_transpose2d(
        torch.tensor(x).permute(0, 3, 1, 2),
        torch.tensor(w).permute(2, 3, 0, 1), stride=2)
    assert flipped.shape[-2:] != got.shape[1:3] or not np.allclose(
        flipped.permute(0, 2, 3, 1).numpy() + b,
        got.detach().numpy(), atol=1e-3)


@pytest.mark.parametrize("window,stride", [(2, None), (3, 2), (3, 1),
                                           (2, 3)])
@pytest.mark.parametrize("padding", ["SAME", "VALID"])
def test_avg_pool_matches_jax(window, stride, padding):
    """An odd 7×8 map, where XLA's ``"SAME"`` pads one side more than the
    other; the padded zeros count in the ``window²`` divisor."""
    x = np.random.RandomState(window).randn(2, 7, 8, 3).astype(np.float32)
    want = JL.avg_pool(jnp.asarray(x), window, stride, padding)
    got = L.avg_pool(torch.tensor(x), window, stride, padding)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_rms_and_instance_norm_match_jax():
    """``rms_norm`` over the last axis and ``instance_norm`` over H, W
    with the population variance, on inputs with a non-zero mean, and
    their input gradients. ``rms_norm`` keeps x's dtype (bf16 in, bf16
    out, no fp32 upcast) as JAX's does."""
    rs = np.random.RandomState(3)
    x = (rs.randn(2, 5, 6, 8) * 2 + 1.5).astype(np.float32)
    scale = (rs.randn(8) + 1).astype(np.float32)
    cases = {
        "rms": (lambda a: JL.rms_norm({"scale": jnp.asarray(scale)}, a),
                lambda a: L.rms_norm({"scale": torch.tensor(scale)}, a)),
        "instance": (JL.instance_norm, L.instance_norm)}
    for name, (jfn, fn) in cases.items():
        want = jfn(jnp.asarray(x))
        want_g = jax.grad(lambda a: (jfn(a) ** 3).sum())(jnp.asarray(x))
        tx = _t(x)
        got = fn(tx)
        (got ** 3).sum().backward()
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   err_msg=name, **TOL)
        np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_g),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    xb = torch.tensor(x).to(torch.bfloat16)
    out = L.rms_norm({"scale": torch.tensor(scale)}, xb)
    assert out.dtype == torch.bfloat16
    want = JL.rms_norm({"scale": jnp.asarray(scale)},
                       jnp.asarray(x, jnp.bfloat16))
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=2e-2, atol=2e-2)


def test_normal_and_embedding_init_follow_jax():
    """The draws differ from JAX's (another generator) but have its
    distribution: shape, dtype, zero mean and ``std`` within 2% over
    64k draws; the same seed gives the same draws."""
    gen = torch.Generator().manual_seed(0)
    got = L.normal_init(gen, (256, 256), std=0.05)
    want = JL.normal_init(jax.random.PRNGKey(0), (256, 256), std=0.05)
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    assert abs(got.std().item() / float(want.std()) - 1) < 0.02
    assert abs(got.mean().item()) < 1e-3
    table = L.embedding_init(torch.Generator().manual_seed(1), 512, 128)
    jtable = JL.embedding_init(jax.random.PRNGKey(1), 512, 128)
    assert table.keys() == jtable.keys()
    assert tuple(table["table"].shape) == jtable["table"].shape
    assert abs(table["table"].std().item() / 0.02 - 1) < 0.02
    again = L.normal_init(torch.Generator().manual_seed(0), (256, 256), 0.05)
    assert torch.equal(got, again)
    assert L.normal_init(gen, (4,), dtype=torch.bfloat16).dtype == \
        torch.bfloat16


# -------------------------------------------------------------------- utils
@pytest.fixture
def anomaly_restored():
    before = torch.is_anomaly_enabled()
    yield
    torch.autograd.set_detect_anomaly(before)


def test_boost_toggles_anomaly_detection(anomaly_restored):
    """``boost(False)`` is debug mode (autograd anomaly detection, the
    counterpart of ``jax_debug_nans``); ``boost()`` turns it off. No
    cuDNN switch moves."""
    bench = torch.backends.cudnn.benchmark
    utils.boost(False)
    assert torch.is_anomaly_enabled()
    x = torch.tensor([0.0], requires_grad=True)
    # anomaly mode names the forward op that made the NaN, then raises
    with pytest.warns(UserWarning, match="SqrtBackward"), \
            pytest.raises(RuntimeError, match="nan"):
        torch.sqrt(x - 1.0).sum().backward()
    utils.boost()
    assert not torch.is_anomaly_enabled()
    assert torch.backends.cudnn.benchmark == bench


def test_seed_deterministic_keyword_is_a_no_op():
    """``seed(v, deterministic=True)`` (JAX's default) seeds as
    ``seed(v)`` and leaves every global determinism switch as it was."""
    import os

    switches = lambda: (  # noqa: E731
        torch.are_deterministic_algorithms_enabled(),
        torch.is_deterministic_algorithms_warn_only_enabled(),
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
        os.environ.get("CUBLAS_WORKSPACE_CONFIG"))
    before = switches()
    for flag in (True, False):
        gen = utils.seed(7, deterministic=flag)
        assert switches() == before
        a = (np.random.rand(), torch.rand(2), torch.rand(2, generator=gen))
        gen = utils.seed(7)
        b = (np.random.rand(), torch.rand(2), torch.rand(2, generator=gen))
        assert a[0] == b[0] and torch.equal(a[1], b[1]) \
            and torch.equal(a[2], b[2])
    jutils.seed(7, deterministic=True)      # the JAX signature it mirrors


def test_tree_helpers_match_jax():
    """``to_array`` and ``stack_dictionaries`` give JAX's arrays byte for
    byte (lists, dicts, namedtuples, a dtype); ``detach`` cuts the
    gradient of every tensor of each tree, one argument giving its
    value and several a tuple."""
    Pair = collections.namedtuple("Pair", "ids mask")
    data = [{"ids": [1, 2, 3], "mask": [1.0, 0.0, 1.0]},
            {"ids": [4, 5, 6], "mask": [0.0, 1.0, 1.0]}]
    for value in (data[0], Pair([1, 2], [0.5, 1.5]), [[1, 2], [3, 4]]):
        for dtype in (None, np.float32):
            got, want = utils.to_array(value, dtype), jutils.to_array(value,
                                                                      dtype)
            got_l = got.values() if isinstance(got, dict) else [got]
            want_l = want.values() if isinstance(want, dict) else [want]
            for a, b in zip(got_l, want_l, strict=True):
                assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    got, want = utils.stack_dictionaries(data), \
        jutils.stack_dictionaries(data)
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].shape == want[k].shape and \
            got[k].tobytes() == want[k].tobytes()
    assert utils.stack_dictionaries([]) == {}
    x = torch.ones(3, requires_grad=True)
    tree = {"a": x * 2, "b": [x + 1, 5]}
    one = utils.detach(tree)
    assert not one["a"].requires_grad and one["b"][1] == 5
    pair = utils.detach(x * 3, tree)
    assert isinstance(pair, tuple) and len(pair) == 2
    assert not pair[0].requires_grad and not pair[1]["b"][0].requires_grad


def test_trace_and_annotate_are_the_span_helpers(tmp_path):
    """``utils.trace`` writes a Chrome trace of its window and
    ``utils.annotate`` names a profiler range inside it."""
    from torchbooster_tpu_torch.observability import spans

    assert utils.trace is spans.trace and utils.annotate is spans.annotate
    path = tmp_path / "trace.json"
    with utils.trace(str(path)):
        with utils.annotate("image_layers_region"):
            torch.ones(8).sum()
    assert "image_layers_region" in path.read_text()
