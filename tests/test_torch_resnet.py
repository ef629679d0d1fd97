"""Port parity: the ResNet training slice of ``torchbooster_tpu_torch``
against the JAX package on the CPU, inputs made once with numpy from a
seed and fed to both, all in fp32, each tolerance stated where it is used.

- the plain versions of B5/B6 (``group_norm_fused``), B7
  (``conv1x1_gn_relu``, stride 1 and 2) and B8 (``conv3x3_gn_relu``, a
  non-square 7×9 map) against the JAX kernels in interpret mode, forward
  and every gradient, at the JAX suite's own tolerances
  (``tests/test_ops.py``);
- the layers the model uses (``conv`` with integer and ``"SAME"``
  padding, ``max_pool``, ``global_avg_pool``, the plain ``group_norm``);
- ResNet-18 (CIFAR stem, 16×16, batch 2) logits and parameter gradients
  against JAX ``ResNet.apply(fused=False)`` and ``jax.grad``, through the
  fused wrappers and through ``fused=False``; a 5-step AdamW ``make_step``
  trajectory on that model;
- the ``resnet_params_from_jax`` round trip (byte-exact, fp32 and bf16)
  and its shape check; ``synthetic_cifar10`` (and the twins) byte-identical;
  each transform byte-identical for an identical ``np.random.Generator``;
  ``freeze``; ``Config.load`` of the recipe's YAML; the recipe's ``main``
  on a tiny config; the options the port refuses raising;
- ``load_torch_state`` against a plain-torch eval-mode ResNet-18 with
  randomized BatchNorm statistics and against JAX's import, with and
  without the head swap (JAX ``tests/test_torch_import.py:82``,
  ``:100``); the recipe's ``pretrained`` from a ``.pt`` and from a
  ``SaveCallback`` directory (JAX ``tests/test_examples.py:223``).

NF-ResNet and the space-to-depth stem are in
``tests/test_torch_resnet_nf.py``.
"""
import dataclasses
import importlib.util
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torchbooster_tpu import utils as jutils
from torchbooster_tpu.config import (
    OptimizerConfig as JOptimizerConfig,
    SchedulerConfig as JSchedulerConfig,
)
from torchbooster_tpu.data import transforms as jtransforms
from torchbooster_tpu.data.sources import resolve_dataset as jax_resolve
from torchbooster_tpu.dataset import Split as JSplit
from torchbooster_tpu.models import layers as JL
from torchbooster_tpu.models.resnet import ResNet as JResNet
from torchbooster_tpu.ops import losses as jlosses
from torchbooster_tpu_torch import utils
from torchbooster_tpu_torch.config import (
    DatasetConfig,
    EnvConfig,
    LoaderConfig,
    OptimizerConfig,
    SchedulerConfig,
)
from torchbooster_tpu_torch.data import resolve_dataset, transforms
from torchbooster_tpu_torch.dataset import Split
from torchbooster_tpu_torch.interop import resnet_params_from_jax, to_numpy
from torchbooster_tpu_torch.models import layers as L
from torchbooster_tpu_torch.models.resnet import ResNet, load_torch_state
from torchbooster_tpu_torch.ops import fused_block as fb
from torchbooster_tpu_torch.ops import group_norm as gn
from torchbooster_tpu_torch.ops import losses
from torchbooster_tpu_torch.recipes import resnet as recipe

ROOT = Path(__file__).resolve().parents[1]
RESNET_YML = ROOT / "examples" / "img_cls" / "resnet" / "resnet.yml"


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, np.asarray(tree)


def _sq_loss_grads(fn, arrays):
    """Gradients of ``sum(fn(*arrays)**2)`` through the port."""
    leaves = [torch.tensor(a, requires_grad=True) for a in arrays]
    out = fn(*leaves)
    (out ** 2).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in leaves]


# ------------------------------------------------------- B5/B6, B7, B8 plain
@pytest.mark.parametrize("relu", [False, True])
def test_group_norm_plain_matches_jax_kernel(relu):
    """(2, 8, 8, 32), 32 groups: forward 2e-5 and gradients 1e-3, the JAX
    suite's tolerances for its kernel against XLA (test_ops.py:311,316);
    both sides are fp32 sums in another order."""
    from torchbooster_tpu.ops.group_norm import group_norm_fused as jgn

    rs = np.random.RandomState(0)
    x = (rs.randn(2, 8, 8, 32) * 3 + 1.5).astype(np.float32)
    scale = (rs.randn(32) + 1.0).astype(np.float32)
    bias = (rs.randn(32) * 0.3).astype(np.float32)
    jfn = lambda s, b, xx: jgn(s, b, xx, 32, relu=relu, interpret=True)  # noqa: E731
    want = jfn(*map(jnp.asarray, (scale, bias, x)))
    want_g = jax.grad(lambda *a: (jfn(*a) ** 2).sum(), argnums=(0, 1, 2))(
        *map(jnp.asarray, (scale, bias, x)))
    before = (gn.launches_fwd, gn.launches_bwd)
    got, got_g = _sq_loss_grads(
        lambda s, b, xx: gn.group_norm_fused(s, b, xx, 32, relu=relu),
        (scale, bias, x))
    assert (gn.launches_fwd, gn.launches_bwd) == before  # plain path only
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5, atol=2e-5)
    for name, g, w in zip(("scale", "bias", "x"), got_g, want_g):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-3, atol=1e-3,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("cin,cout,relu,stride", [(32, 64, True, 1),
                                                  (64, 32, False, 2)])
def test_conv1x1_gn_plain_matches_jax_kernel(cin, cout, relu, stride):
    """Forward 2e-4; all four gradients 2e-3 relative and 2e-3 of the
    gradient's largest entry absolute (test_ops.py:440,450)."""
    from torchbooster_tpu.ops.fused_block import conv1x1_gn_relu as j1

    rs = np.random.RandomState(cin + cout)
    x = (rs.randn(2, 8, 8, cin) * 2 + 0.3).astype(np.float32)
    k = (rs.randn(1, 1, cin, cout) * 0.1).astype(np.float32)
    scale = (rs.randn(cout) + 1.0).astype(np.float32)
    bias = (rs.randn(cout) * 0.2).astype(np.float32)
    jfn = lambda *a: j1(*a, 32, relu=relu, stride=stride, interpret=True)  # noqa: E731
    want = jfn(*map(jnp.asarray, (x, k, scale, bias)))
    want_g = jax.grad(lambda *a: (jfn(*a) ** 2).sum(), argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, (x, k, scale, bias)))
    got, got_g = _sq_loss_grads(
        lambda *a: fb.conv1x1_gn_relu(*a, 32, relu=relu, stride=stride),
        (x, k, scale, bias))
    assert got.shape == (2, 8 // stride, 8 // stride, cout)
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-4, atol=2e-4)
    for name, g, w in zip(("x", "kernel", "scale", "bias"), got_g, want_g):
        w = np.asarray(w)
        np.testing.assert_allclose(g.reshape(w.shape), w, rtol=2e-3,
                                   atol=2e-3 * max(1.0, np.abs(w).max()),
                                   err_msg=f"d{name}")


def test_conv3x3_gn_plain_matches_jax_kernel():
    """A non-square (7, 9) map, the border taps masked: forward 3e-4, all
    four gradients 2e-3 relative and 2e-3 of the largest entry
    (test_ops.py:494,508)."""
    from torchbooster_tpu.ops.fused_block import conv3x3_gn_relu as j3

    rs = np.random.RandomState(96)
    x = (rs.randn(2, 7, 9, 64) * 2 + 0.3).astype(np.float32)
    k = (rs.randn(3, 3, 64, 32) * 0.1).astype(np.float32)
    scale = (rs.randn(32) + 1.0).astype(np.float32)
    bias = (rs.randn(32) * 0.2).astype(np.float32)
    jfn = lambda *a: j3(*a, 32, relu=False, interpret=True)  # noqa: E731
    want = jfn(*map(jnp.asarray, (x, k, scale, bias)))
    want_g = jax.grad(lambda *a: (jfn(*a) ** 2).sum(), argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, (x, k, scale, bias)))
    got, got_g = _sq_loss_grads(
        lambda *a: fb.conv3x3_gn_relu(*a, 32, relu=False),
        (x, k, scale, bias))
    np.testing.assert_allclose(got, np.asarray(want), rtol=3e-4, atol=3e-4)
    for name, g, w in zip(("x", "kernel", "scale", "bias"), got_g, want_g):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=2e-3,
                                   atol=2e-3 * max(1.0, np.abs(w).max()),
                                   err_msg=f"d{name}")


def test_fused_kernel_plain_versions_agree_with_their_reference_formulas():
    """On the CPU the kernels' plain versions are the reference formulas:
    B7's moments (mu, rstd) equal the plain GroupNorm's without the clamp,
    and ``conv_gn_reference`` of a 3×3 equals ``ref_conv3x3_gn`` in fp32
    (1e-5: sums in another grouping)."""
    rs = np.random.RandomState(4)
    x = torch.as_tensor(rs.randn(2, 6, 5, 16).astype(np.float32))
    w = torch.as_tensor((rs.randn(3, 3, 16, 32) * 0.2).astype(np.float32))
    s = torch.as_tensor((rs.randn(32) + 1).astype(np.float32))
    b = torch.as_tensor(rs.randn(32).astype(np.float32))
    out, mu, rstd = fb.conv_gn_reference(x, w, s, b, 8, relu=True)
    torch.testing.assert_close(out, fb.ref_conv3x3_gn(x, w, s, b, 8),
                               atol=1e-5, rtol=1e-5)
    y = L.conv({"kernel": w}, x, padding=1)
    torch.testing.assert_close(
        out, L.group_norm({"scale": s, "bias": b}, y, 8, relu=True),
        atol=1e-5, rtol=1e-5)
    assert mu.shape == rstd.shape == (2, 32)


# ------------------------------------------------------------------ layers
def test_layers_match_jax():
    """conv with integer and "SAME" padding (stride 1 and 2, odd and even
    sizes), max pool with symmetric padding, global average pool and the
    plain group_norm: fp32, 1e-5."""
    rs = np.random.RandomState(1)
    for hw, k, stride, pad in ((9, 3, 2, 1), (8, 1, 2, "SAME"),
                               (7, 3, 2, "SAME"), (8, 7, 2, 3)):
        x = rs.randn(2, hw, hw, 5).astype(np.float32)
        w = rs.randn(k, k, 5, 6).astype(np.float32)
        want = JL.conv({"kernel": jnp.asarray(w)}, jnp.asarray(x),
                       stride=stride, padding=pad)
        got = L.conv({"kernel": torch.as_tensor(w)}, torch.as_tensor(x),
                     stride=stride, padding=pad)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5, err_msg=f"{hw} {k} {stride}")
    x = rs.randn(2, 9, 9, 4).astype(np.float32)
    np.testing.assert_array_equal(
        L.max_pool(torch.as_tensor(x), 3, 2, padding=1).numpy(),
        np.asarray(JL.max_pool(jnp.asarray(x), 3, 2, padding=1)))
    np.testing.assert_allclose(L.global_avg_pool(torch.as_tensor(x)).numpy(),
                               np.asarray(JL.global_avg_pool(jnp.asarray(x))),
                               rtol=1e-6)
    x = (rs.randn(2, 4, 4, 12) * 2 + 1).astype(np.float32)
    p = {"scale": rs.randn(12).astype(np.float32),
         "bias": rs.randn(12).astype(np.float32)}
    want = JL.group_norm({k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x), 8, relu=True)    # clipped to 6
    for impl in ("plain", "xla", "auto"):
        got = L.group_norm({k: torch.as_tensor(v) for k, v in p.items()},
                           torch.as_tensor(x), 8, relu=True, impl=impl)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5, err_msg=impl)


# ----------------------------------------------------------------- ResNet-18
@pytest.fixture(scope="module")
def resnet18():
    """JAX ResNet-18 (CIFAR stem) params, a 16×16 batch of 2, and JAX's
    loss, logits and gradients at fp32 (``fused=False``)."""
    jp = JResNet.init(jax.random.PRNGKey(0), depth=18, num_classes=10,
                      stem="cifar")
    rs = np.random.RandomState(2)
    x = rs.randn(2, 16, 16, 3).astype(np.float32)
    labels = np.array([3, 7], np.int32)

    def jloss(p):
        logits = JResNet.apply(p, jnp.asarray(x), fused=False)
        return jlosses.cross_entropy(logits, jnp.asarray(labels)), logits

    (loss, logits), grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)
    return dict(jp=jax.device_get(jp), x=x, labels=labels, loss=float(loss),
                logits=np.asarray(logits), grads=jax.device_get(grads))


@pytest.mark.parametrize("fused", ["auto", False])
def test_resnet18_apply_and_grads_match_jax(resnet18, fused):
    """Logits 5e-4 (test_ops.py:623); the loss 1e-5 relative; every
    parameter gradient within 1e-3 relative plus 1e-3 of its leaf's
    largest entry (fp32 both sides; 20 layers of sums in another order).
    ``fused="auto"`` runs the plain B7/B8 versions, False conv + the
    plain GroupNorm."""
    params = resnet_params_from_jax(resnet18["jp"], "cpu")
    for p in utils.tree_leaves(params):
        p.requires_grad_(True)
    logits = ResNet.apply(params, torch.as_tensor(resnet18["x"]),
                          fused=fused)
    loss = losses.cross_entropy(logits,
                                torch.as_tensor(resnet18["labels"]).long())
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), resnet18["logits"],
                               rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(loss.item(), resnet18["loss"], rtol=1e-5)
    got = dict(_leaves(to_numpy(utils._tree_map(lambda t: t.grad, params))))
    want = dict(_leaves(resnet18["grads"]))
    assert got.keys() == want.keys()
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=1e-3,
                                   atol=1e-3 * np.abs(w).max(),
                                   err_msg=str(path))


def test_resnet18_make_step_trajectory_matches_jax(resnet18):
    """5 steps of the recipe's update (AdamW lr 1e-3, wd 1e-2, cycle
    schedule with warmup 2, clip 1.0, label smoothing 0.1), fp32, from
    the same parameters and batches: losses 1e-4 relative; parameters
    2e-4 absolute (AdamW divides by √v, so fp32 noise on a near-zero
    gradient entry becomes an O(lr) difference in that entry; 2e-4 is a
    fifth of one lr-sized update)."""
    optim = dict(name="adamw", lr=1e-3, weight_decay=1e-2)
    sched = dict(name="cycle", n_iter=5, warmup=2, decay=("lin", "cos"))
    rs = np.random.RandomState(6)
    batches = [(rs.randn(2, 16, 16, 3).astype(np.float32),
                rs.randint(0, 10, 2).astype(np.int32)) for _ in range(5)]

    jopt = JOptimizerConfig(**optim)
    jtx = jopt.make(JSchedulerConfig(**sched).make(jopt))

    def jloss(p, batch, rng):
        logits = JResNet.apply(p, batch[0], fused=False)
        return jlosses.cross_entropy(logits, batch[1], 0.1), {}

    jstate = jutils.TrainState.create(jax.tree.map(jnp.asarray,
                                                   resnet18["jp"]), jtx,
                                      rng=0)
    jstep = jutils.make_step(jloss, jtx, clip=1.0)
    opt = OptimizerConfig(**optim)
    tx = opt.make(SchedulerConfig(**sched).make(opt))

    def loss(p, batch, generator):
        logits = ResNet.apply(p, batch[0])
        return losses.cross_entropy(logits, batch[1], 0.1), {}

    state = utils.TrainState.create(
        resnet_params_from_jax(resnet18["jp"], "cpu"), tx)
    step = utils.make_step(loss, tx, clip=1.0)
    jl, tl = [], []
    for x, y in batches:
        jstate, jm = jstep(jstate, (jnp.asarray(x), jnp.asarray(y)))
        state, m = step(state, (torch.as_tensor(x),
                                torch.as_tensor(y).long()))
        jl.append(float(jm["loss"]))
        tl.append(m["loss"].item())
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    got = dict(_leaves(to_numpy(state.params)))
    for path, w in _leaves(jax.device_get(jstate.params)):
        np.testing.assert_allclose(got[path], w, rtol=0, atol=2e-4,
                                   err_msg=str(path))


def test_resnet_params_round_trip_and_shape_check(resnet18):
    """JAX tree → port → numpy is byte-exact at fp32 and bf16; a tree
    whose leaves do not fit the depth its keys imply raises."""
    tree = resnet18["jp"]
    for cast in (lambda a: a, lambda a: np.asarray(jnp.asarray(a,
                                                               jnp.bfloat16))):
        src = jax.tree.map(cast, tree)
        back = to_numpy(resnet_params_from_jax(src, "cpu"))
        for (path, a), (_, b) in zip(_leaves(src), _leaves(back)):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), path
    bad = jax.tree.map(lambda a: a, tree)
    bad["stage1"]["block0"]["conv1"]["kernel"] = np.zeros((3, 3, 64, 96),
                                                          np.float32)
    with pytest.raises(ValueError, match="ResNet-18"):
        resnet_params_from_jax(bad, "cpu")
    short = {**tree, "stage3": {"block0": tree["stage3"]["block0"]}}
    with pytest.raises(ValueError, match="no ResNet depth"):
        resnet_params_from_jax(short, "cpu")
    # the port's own init has the JAX tree's structure
    own = ResNet.init(0, 18, 10, "cifar", device="cpu")
    assert {p: v.shape for p, v in _leaves(to_numpy(own))} == \
        {p: v.shape for p, v in _leaves(tree)}


# -------------------------------------------------------------------- data
def test_synthetic_images_byte_identical_and_twin_chain(tmp_path, caplog):
    """The synthetic families give the JAX package's bytes; ``cifar10``
    with nothing under ``root`` resolves to its twin with the JAX
    warning; a release under ``root`` is read instead of the twin (here
    empty batch files, which fail as the JAX reader's do), and a name no
    link answers exits."""
    # (synthetic_imagenet runs the same function at 224² and 1000
    # classes: 150M prototype draws, too slow to repeat here)
    for name in ("synthetic_cifar10", "synthetic_mnist"):
        conf = DatasetConfig(name=name, n_examples=16)
        for split, jsplit in ((Split.TRAIN, JSplit.TRAIN),
                              (Split.TEST, JSplit.TEST)):
            got = resolve_dataset(conf, split)
            want = jax_resolve(conf, jsplit)
            for a, b in zip(got.arrays, want.arrays):
                assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    with caplog.at_level("WARNING"):
        twin = resolve_dataset(DatasetConfig(name="cifar10",
                                             root=str(tmp_path),
                                             n_examples=16), Split.TRAIN)
    assert "using synthetic_cifar10 stand-in" in caplog.text
    want = resolve_dataset(DatasetConfig(name="synthetic_cifar10",
                                         n_examples=16), Split.TRAIN)
    assert twin.arrays[0].tobytes() == want.arrays[0].tobytes()
    for f in [f"data_batch_{i}.bin" for i in range(1, 6)] + ["test_batch.bin"]:
        (tmp_path / f).write_bytes(b"")
    with pytest.raises(ValueError, match="CIFAR-10 records"):
        resolve_dataset(DatasetConfig(name="cifar10", root=str(tmp_path)),
                        Split.TRAIN)
    with pytest.raises(ValueError, match="CIFAR-10 records"):
        jax_resolve(DatasetConfig(name="cifar10", root=str(tmp_path)),
                    JSplit.TRAIN)
    with pytest.raises(SystemExit):
        resolve_dataset(DatasetConfig(name="coco"), Split.TRAIN)


def test_transforms_byte_identical_for_the_same_generator():
    """Every transform, and the recipe's ``Augment`` over an (image,
    label) example, draws the same numbers and returns the same bytes as
    the JAX package's for an identical generator."""
    img = np.random.RandomState(3).rand(32, 32, 3).astype(np.float32)
    cases = [("PadCrop", (32, 4)), ("HorizontalFlip", (1.0,)),
             ("Rotation", (15.0,)), ("ColorJitter", (0.3, 0.3)),
             ("RandomErasing", (1.0,)), ("CenterCrop", (24,)),
             ("Normalize", ((0.5, 0.4, 0.3), (0.2, 0.25, 0.3)))]
    for name, args in cases:
        got = getattr(transforms, name)(*args)(np.random.default_rng(5), img)
        want = getattr(jtransforms, name)(*args)(np.random.default_rng(5),
                                                 img)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), \
            name
    aug = recipe.augment(11)
    jaug = jtransforms.Augment(11, aug.transforms)
    for i in range(4):
        got, label = aug((img * (i + 1), 7))
        want, _ = jaug((img * (i + 1), 7))
        assert label == 7 and got.tobytes() == want.tobytes()


def test_freeze_keeps_frozen_leaves_bit_identical():
    """AdamW with weight decay over 3 steps: the frozen backbone leaves
    keep their bits (no update, no decay), the head moves; the clip still
    counts the frozen gradients, as the JAX step does."""
    rs = np.random.RandomState(7)
    params = {"stage0": {"w": torch.tensor(rs.randn(6, 5).astype(np.float32))},
              "head": {"kernel": torch.tensor(rs.randn(5, 3).astype(
                  np.float32))}}
    before = {k: v["w" if k == "stage0" else "kernel"].clone()
              for k, v in params.items()}
    tx = utils.freeze(lambda path: not path.startswith("head"),
                      OptimizerConfig(name="adamw", lr=0.1,
                                      weight_decay=0.5).make())
    state = utils.TrainState.create(params, tx)

    def loss(p, batch, generator):
        h = torch.tanh(batch["x"] @ p["stage0"]["w"])
        return losses.cross_entropy(h @ p["head"]["kernel"], batch["y"]), {}

    step = utils.make_step(loss, tx, clip=0.1)
    batch = {"x": torch.as_tensor(rs.randn(8, 6).astype(np.float32)),
             "y": torch.as_tensor(rs.randint(0, 3, 8)).long()}
    for _ in range(3):
        state, _ = step(state, batch)
    w = state.params["stage0"]["w"]
    assert w.detach().numpy().tobytes() == before["stage0"].numpy().tobytes()
    assert w.grad is None
    assert not torch.equal(state.params["head"]["kernel"], before["head"])
    with pytest.raises(ValueError, match="every parameter"):
        utils.freeze(lambda path: True, tx.tx).init(params)


# ------------------------------------------------------------------ recipe
def _jax_recipe(monkeypatch):
    directory = RESNET_YML.parent
    monkeypatch.chdir(directory)
    spec = importlib.util.spec_from_file_location("jax_example_resnet",
                                                  directory / "resnet.py")
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module
    spec.loader.exec_module(module)
    return module


def test_recipe_config_load_matches_jax(monkeypatch):
    jrecipe = _jax_recipe(monkeypatch)
    want = dataclasses.asdict(jrecipe.Config.load(RESNET_YML))
    got = dataclasses.asdict(recipe.Config.load(RESNET_YML))
    for block in ("env", "loader", "optim", "scheduler", "dataset"):
        shared = got[block].keys() & want[block].keys()
        assert {k: got[block][k] for k in shared} == \
            {k: want[block][k] for k in shared}, block
        got.pop(block), want.pop(block)
    assert got == want
    assert got["depth"] == 18 and got["label_smoothing"] == 0.1


def _tiny_conf(pretrained=""):
    return recipe.Config(
        epochs=1, seed=42, depth=18, num_classes=10, clip=1.0,
        label_smoothing=0.1, pretrained=pretrained, freeze_backbone=False,
        env=EnvConfig(precision="bf16"),
        loader=LoaderConfig(batch_size=8, drop_last=True),
        optim=OptimizerConfig(name="adamw", lr=1e-3, weight_decay=1e-2),
        scheduler=SchedulerConfig(name="cycle", n_iter=8, warmup=1,
                                  decay=("lin", "cos")),
        dataset=DatasetConfig(name="cifar10", root="dataset/cifar10",
                              n_examples=64))


def test_recipe_main_runs_on_the_cpu():
    """ResNet-18 on the cifar10 twin, bf16 compute, 8 steps and one eval
    batch on the CPU; the CPU has no kernel launches."""
    before = (gn.launches_fwd, fb.launches_1x1, fb.launches_3x3)
    res = recipe.main(_tiny_conf(), device="cpu")
    assert (gn.launches_fwd, fb.launches_1x1, fb.launches_3x3) == before
    assert len(res["steps"]) == res["train_steps"] == 8
    assert all(math.isfinite(s["loss"]) and s["data_s"] > 0
               for s in res["steps"])
    assert math.isfinite(res["test_loss"]) and 0 <= res["test_acc"] <= 1


def test_unported_options_raise(tmp_path):
    """What the port still refuses, each with its reason: a pretrained
    directory that no ``SaveCallback`` wrote (an orbax checkpoint needs
    the JAX package), VGG features without an ``nn.Sequential`` (the port
    downloads nothing), and the recipe's entry point on a machine with no
    card unless ``device="cpu"`` is asked for."""
    from torchbooster_tpu_torch.models.vgg import VGGFeatures, \
        load_torch_features

    params = ResNet.init(0, 18, 10, "cifar", device="cpu")
    (tmp_path / "orbax").mkdir()
    (tmp_path / "orbax" / "_METADATA").write_text("{}")
    with pytest.raises(ValueError, match="orbax checkpoint needs the JAX "
                                         "package"):
        recipe.load_pretrained(_tiny_conf(pretrained=str(tmp_path / "orbax")),
                               params, torch.Generator(), "cpu")
    with pytest.raises(FileNotFoundError, match="not found"):
        recipe.load_pretrained(_tiny_conf(pretrained=str(tmp_path / "nope")),
                               params, torch.Generator(), "cpu")
    with pytest.raises(ValueError, match="downloads nothing"):
        load_torch_features(VGGFeatures.init(0, 16, device="cpu"))
    with pytest.raises(ValueError, match="no norm in the activation path"):
        ResNet.apply(params, torch.zeros(1, 8, 8, 3), norm="ws", fused=True)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            recipe.main(_tiny_conf())


# ------------------------------------------------------- load_torch_state
def _bn_randomized_resnet18(seed: int):
    """The JAX suite's plain-torch ResNet-18 (torchvision's key names)
    with random weights and randomized BatchNorm statistics, in eval
    mode."""
    from tests.test_torch_import import _randomize_bn_stats, _torch_resnet18

    gen = torch.Generator().manual_seed(seed)
    torch.manual_seed(seed)
    with torch.no_grad():
        model = _torch_resnet18()
        _randomize_bn_stats(model, gen)
    return model.eval(), gen


def test_load_torch_state_matches_torch_eval_and_jax():
    """The import run at ``norm="affine"`` against the module's own
    eval-mode forward (1e-4 relative plus 1e-4 of the largest logit; the
    JAX suite holds its import to 1e-3), and every imported leaf against
    JAX's ``load_torch_state`` of the same state dict (1e-6: the same
    fp32 fold, in torch and in numpy)."""
    from torchbooster_tpu.models.resnet import load_torch_state as jload

    model, gen = _bn_randomized_resnet18(0)
    x = torch.randn(2, 3, 64, 64, generator=gen)
    with torch.no_grad():
        want = model(x).numpy()
    params = load_torch_state(model.state_dict(), device="cpu")
    got = ResNet.apply(params, x.permute(0, 2, 3, 1).contiguous(),
                       norm="affine").detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())
    jtree = jax.device_get(jload(model.state_dict()))
    mine = dict(_leaves(to_numpy(params)))
    theirs = dict(_leaves(jtree))
    assert mine.keys() == theirs.keys()
    for path, w in theirs.items():
        np.testing.assert_allclose(mine[path], w, rtol=1e-6, atol=1e-7,
                                   err_msg=str(path))
    numpy_sd = {k: v.numpy() for k, v in model.state_dict().items()}
    again = load_torch_state(numpy_sd, device="cpu")
    for a, b in zip(utils.tree_leaves(again), utils.tree_leaves(params)):
        assert torch.equal(a, b)


def test_load_torch_state_head_swap():
    """``num_classes`` with a generator swaps the head (512 → 10) and
    keeps every backbone leaf; without a generator the swap raises; the
    swapped model runs (JAX ``test_resnet_torch_import_head_swap``)."""
    model, _ = _bn_randomized_resnet18(1)
    full = load_torch_state(model.state_dict(), device="cpu")
    params = load_torch_state(model.state_dict(), num_classes=10,
                              generator=torch.Generator().manual_seed(0),
                              device="cpu")
    assert tuple(params["head"]["kernel"].shape) == (512, 10)
    for key in full:
        if key != "head":
            for a, b in zip(utils.tree_leaves(params[key]),
                            utils.tree_leaves(full[key])):
                assert torch.equal(a, b)
    out = ResNet.apply(params, torch.zeros(1, 64, 64, 3), norm="affine")
    assert out.shape == (1, 10)
    with pytest.raises(ValueError, match="generator"):
        load_torch_state(model.state_dict(), num_classes=10, device="cpu")


def test_recipe_pretrained_pt_and_savecallback_tree(tmp_path):
    """The recipe's ``pretrained``: a ``.pt`` state dict imports at
    ``norm="affine"`` with the head swapped onto ``num_classes`` (JAX
    ``test_resnet_pretrained_torch_import``: ``main`` then fine-tunes the
    head only); a checkpoint directory ``SaveCallback`` wrote restores
    its params tree byte for byte at ``norm="group"``."""
    from torchbooster_tpu_torch.callbacks import SaveCallback

    model, _ = _bn_randomized_resnet18(2)
    ckpt = tmp_path / "resnet18.pt"
    torch.save(model.state_dict(), ckpt)
    conf = _tiny_conf(pretrained=str(ckpt))
    params = ResNet.init(0, 18, 10, "cifar", device="cpu")
    got, norm = recipe.load_pretrained(conf, params,
                                       torch.Generator().manual_seed(0),
                                       "cpu")
    assert norm == "affine" and tuple(got["head"]["kernel"].shape) == \
        (512, 10)
    want = load_torch_state(model.state_dict(), device="cpu")
    assert torch.equal(got["stage2"]["block1"]["norm2"]["scale"],
                       want["stage2"]["block1"]["norm2"]["scale"])

    saved = ResNet.init(5, 18, 10, "cifar", device="cpu")
    cb = SaveCallback(1, 10, root=tmp_path / "ckpts")
    path = cb.save(3, params=saved)
    cb.wait()
    conf = _tiny_conf(pretrained=str(path))
    got, norm = recipe.load_pretrained(conf, params,
                                       torch.Generator().manual_seed(0),
                                       "cpu")
    assert norm == "group"
    for key in saved:
        if key != "head":
            for a, b in zip(utils.tree_leaves(got[key]),
                            utils.tree_leaves(saved[key])):
                assert a.dtype == b.dtype and torch.equal(a, b)

    conf = _tiny_conf(pretrained=str(ckpt))
    conf.freeze_backbone = True
    conf.dataset = DatasetConfig(name="synthetic_cifar10", n_examples=64)
    conf.scheduler.n_iter = 4
    conf.loader.batch_size = 16
    res = recipe.main(conf, device="cpu")
    assert res["train_steps"] == 4 and math.isfinite(res["train_loss"])
