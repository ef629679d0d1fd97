"""The style recipes of the port (``recipes/{offline,online,adain}.py``)
held to the JAX recipes of ``examples/img_stt`` on the CPU: each port
``main`` against the JAX recipe's ``main`` at JAX
``tests/test_examples.py``'s sizes (32² images, 2 steps, fp32), on the
same procedural images and loader order, with JAX's initial weights
carried across (its random VGG critic, StyleNet and AdaINDecoder):

- the loss within 1e-5 relative, and each weighted term of it (content,
  the style grams or statistics, TV) within 1e-5 of the loss;
- the image each writes (the optimized image, the preview, the final
  stylization) within ``IMAGE_ATOL``, which says why.

The draws-free recipes' ``main`` alone, and the rest, are in
``tests/test_torch_gen_recipes.py``."""
import numpy as np
import pytest
import torch

from tests.test_torch_gen_recipes import _jax_recipe, _load, tiny_env


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: beside the other test processes, OpenMP's
    barriers would otherwise stall on busy cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# The images a style recipe writes come after its Adam steps. Adam moves
# an entry whose gradient is at fp32 noise by up to lr either way, and a
# bias of the last conv so moved shifts a whole channel (adain's decoder
# at lr 1e-4 shows 6e-5 after 2 steps), so they are held within 1e-4.
IMAGE_ATOL = 1e-4


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    return torch.as_tensor(np.array(tree))


def _jax_vgg(seed, depth):
    """The JAX recipes' critic: ``VGGFeatures.init`` from the seed's root
    key (``load_torch_features`` raises without torchvision, and the
    recipes keep the random VGG)."""
    import jax

    from torchbooster_tpu.models import VGGFeatures as JVGG

    return jax.device_get(JVGG.init(jax.random.PRNGKey(seed), depth=depth))


def _results_match(got, want, terms):
    """The loss within 1e-5 relative, and each weighted term of it
    (``terms``: name → weight) within 1e-5 of the loss: a term that is
    all but zero (the content of a random VGG's deepest tap at 32²) is
    held to the sum it is part of."""
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    for key, weight in terms.items():
        np.testing.assert_allclose(weight * got[key], weight * want[key],
                                   rtol=0, atol=1e-5 * abs(want["loss"]),
                                   err_msg=key)


def test_offline_recipe_matches_jax(monkeypatch, tmp_path):
    """The offline recipe's ``main`` against the JAX recipe's ``main`` on
    the same procedural content and style images and the same random
    VGG-19 (JAX's, carried across): after 2 Adam steps on the image's
    logits the content, style (grams), TV and total losses within 1e-5
    relative (:func:`_results_match`), and the optimized image within
    ``IMAGE_ATOL``."""
    joffline = _jax_recipe(monkeypatch, "offline")
    offline, conf = _load("offline")
    jconf = joffline.Config.load(offline.DEFAULT_YAML)
    for c, out in ((conf, "port.npy"), (jconf, "jax.npy")):
        c.n_iter, c.image_size = 2, 32
        c.output_path = str(tmp_path / out)
    want = joffline.main(jconf)
    vgg = _tensors(_jax_vgg(conf.seed, 19))
    monkeypatch.setattr(offline, "random_vgg", lambda *a: vgg)
    got = offline.main(conf, device="cpu")
    _results_match(got, want, {"content": conf.content_weight,
                               "style": conf.style_weight,
                               "tv": conf.tv_weight})
    np.testing.assert_allclose(np.load(tmp_path / "port.npy"),
                               np.load(tmp_path / "jax.npy"), rtol=0,
                               atol=IMAGE_ATOL)


def _style_confs(monkeypatch, tmp_path, name):
    jrecipe = _jax_recipe(monkeypatch, name)
    recipe, conf = _load(name)
    jconf = jrecipe.Config.load(recipe.DEFAULT_YAML)
    for c, out in ((conf, "port"), (jconf, "jax")):
        c.n_iter, c.sample_every = 2, 2
        for ds in ((c.dataset,) if name == "online" else (c.content,
                                                           c.style)):
            ds.image_size, ds.n_images = 32, 16
        c.loader.batch_size = 4
        c.samples_path = str(tmp_path / out)
        tiny_env(c)
        # the first step moves the weights (the YAMLs warm up from 0)
        c.scheduler.warmup = 0
    return jrecipe, recipe, conf, jconf


def test_online_recipe_matches_jax(monkeypatch, tmp_path):
    """The online recipe's ``main`` against the JAX recipe's on the same
    procedural batches, with JAX's StyleNet and random VGG-16 carried
    across: the content and style losses and the total over 2 steps
    (the second after the first update) as :func:`_results_match` holds
    them, and the preview, the updated StyleNet on the last batch's first
    image, within ``IMAGE_ATOL``."""
    import jax

    from torchbooster_tpu.models import StyleNet as JStyleNet
    from torchbooster_tpu_torch.interop import stylenet_params_from_jax

    jonline, online, conf, jconf = _style_confs(monkeypatch, tmp_path,
                                                "online")
    want = jonline.main(jconf)
    key = jax.random.PRNGKey(conf.seed)
    vgg = _tensors(_jax_vgg(conf.seed, 16))
    params = stylenet_params_from_jax(jax.device_get(JStyleNet.init(key)),
                                      "cpu")
    monkeypatch.setattr(online, "random_vgg", lambda *a: vgg)
    monkeypatch.setattr(online.StyleNet, "init",
                        staticmethod(lambda *a, **k: params))
    got = online.main(conf, device="cpu")
    _results_match(got, want, {"content": conf.content_weight,
                               "style": conf.style_weight})
    name = "styled_000002.npy"
    np.testing.assert_allclose(np.load(tmp_path / "port" / name),
                               np.load(tmp_path / "jax" / name), rtol=0,
                               atol=IMAGE_ATOL)


def test_adain_recipe_matches_jax(monkeypatch, tmp_path):
    """The adain recipe's ``main`` against the JAX recipe's on the same
    zipped content and style batches, with JAX's AdaINDecoder and random
    VGG-19 carried across: the content term (the decoded features
    against the AdaIN target) and the style term (the means and
    standard deviations at relu1_1 … relu4_1) over 2 steps as
    :func:`_results_match` holds them, and the final stylization within
    ``IMAGE_ATOL``."""
    import jax

    from torchbooster_tpu.models.stylenet import AdaINDecoder as JDecoder
    from torchbooster_tpu_torch.interop import adain_decoder_params_from_jax

    jadain, adain, conf, jconf = _style_confs(monkeypatch, tmp_path,
                                              "adain")
    want = jadain.main(jconf)
    key = jax.random.PRNGKey(conf.seed)
    vgg = _tensors(_jax_vgg(conf.seed, 19))
    params = adain_decoder_params_from_jax(
        jax.device_get(JDecoder.init(key)), "cpu")
    monkeypatch.setattr(adain, "random_vgg", lambda *a: vgg)
    monkeypatch.setattr(adain.AdaINDecoder, "init",
                        staticmethod(lambda *a, **k: params))
    got = adain.main(conf, device="cpu")
    _results_match(got, want, {"content": 1.0, "style": conf.style_weight})
    name = "adain_final.npy"
    np.testing.assert_allclose(np.load(tmp_path / "port" / name),
                               np.load(tmp_path / "jax" / name), rtol=0,
                               atol=IMAGE_ATOL)
