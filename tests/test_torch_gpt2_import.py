"""Port parity: ``load_torch_gpt2`` of ``torchbooster_tpu_torch/models/gpt.py``
against the JAX package's and against HuggingFace ``transformers``, on
the CPU, with tiny ``GPT2LMHeadModel``s built from a local
``GPT2Config`` (random weights, nothing downloaded):

- params equal JAX's import exactly, and the config's fields JAX's;
- fp32 logits within 2e-4 of ``transformers``' eval forward (the JAX
  import test's tolerance);
- both key forms (``GPT2LMHeadModel`` with the ``transformer.`` prefix,
  ``GPT2Model`` without), numpy arrays, HF's attention buffers and
  ``lm_head.weight`` ignored, the ``n_heads`` table and its
  ``ValueError``, the card by default;
- the imported model served by the port's paged engine on the CPU,
  token-exact against the dense ``generate``;
- ``chip_smoke.py``'s builder of the ``gpt2_import`` phase: HF's keys
  and shapes at GPT-2 small, and a round trip through ``load_torch_gpt2``.
"""
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from torchbooster_tpu.models.gpt import load_torch_gpt2 as jax_load
from torchbooster_tpu_torch.config import ServingConfig
from torchbooster_tpu_torch.interop import to_numpy
from torchbooster_tpu_torch.models.gpt import (
    GPT,
    GPTConfig,
    generate,
    load_torch_gpt2,
)
from torchbooster_tpu_torch.serving import Request
from torchbooster_tpu_torch.utils import _paths

ROOT = Path(__file__).resolve().parents[1]


def _hf_model(seed=0, **kw):
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(seed)
    cfg = dict(vocab_size=97, n_positions=24, n_embd=32, n_layer=2,
               n_head=4, resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)
    cfg.update(kw)
    return transformers.GPT2LMHeadModel(
        transformers.GPT2Config(**cfg)).eval()


def _flat(tree):
    return {path: to_numpy(leaf) if isinstance(leaf, torch.Tensor)
            else np.asarray(leaf) for path, leaf in _paths(tree)}


def test_import_equals_jax_import_and_transformers_logits():
    """Params equal JAX's import bit for bit and the config fields
    JAX's; logits within 2e-4 of ``transformers``' (fp32, both use the
    tanh gelu; the sums differ in order)."""
    model = _hf_model()
    sd = model.state_dict()
    params, cfg = load_torch_gpt2(sd, n_heads=4, device="cpu")
    jparams, jcfg = jax_load(sd, n_heads=4)
    got, want = _flat(params), _flat(jax.device_get(jparams))
    assert got.keys() == want.keys()
    for path, w in want.items():
        assert got[path].dtype == np.float32
        np.testing.assert_array_equal(got[path], w, err_msg=path)
    for name in GPTConfig.__dataclass_fields__:
        assert getattr(cfg, name) == getattr(jcfg, name), name
    assert cfg == GPTConfig(vocab=97, n_layers=2, d_model=32, n_heads=4,
                            seq_len=24, tie_embeddings=True)
    ids = np.array([[3, 14, 15, 92, 65, 35], [8, 9, 7, 9, 3, 2]], np.int64)
    with torch.no_grad():
        want_logits = model(torch.from_numpy(ids)).logits.numpy()
        logits = GPT.apply(params, torch.from_numpy(ids), cfg,
                           compute_dtype=torch.float32, remat=False)
    np.testing.assert_allclose(logits.numpy(), want_logits, rtol=2e-4,
                               atol=2e-4)


def test_key_forms_numpy_buffers_head_and_heads_table():
    """``GPT2Model`` keys (no prefix), numpy values, HF's attention
    buffers and a different ``lm_head.weight`` all give the same params;
    d_model 24 is not in the table and raises; d_model 768 infers 12
    heads; without ``device`` the import wants the card."""
    model = _hf_model(vocab_size=50, n_positions=16, n_embd=24, n_layer=1,
                      n_head=3)
    sd = model.state_dict()
    assert any(k.startswith("transformer.") for k in sd)
    with pytest.raises(ValueError, match="n_heads"):
        load_torch_gpt2(sd, device="cpu")
    want, cfg = load_torch_gpt2(sd, n_heads=3, device="cpu")
    assert (cfg.d_model, cfg.n_heads, cfg.n_layers) == (24, 3, 1)
    bare = {k: v.numpy() for k, v in model.transformer.state_dict().items()}
    assert not any(k.startswith("transformer.") for k in bare)
    bare["h.0.attn.bias"] = np.tril(np.ones((1, 1, 16, 16), bool))
    bare["h.0.attn.masked_bias"] = np.float32(-1e4)
    bare["lm_head.weight"] = np.zeros((50, 24), np.float32)
    got, cfg2 = load_torch_gpt2(bare, n_heads=3, device="cpu")
    assert cfg2 == cfg and "head" not in got
    want, got = _flat(want), _flat(got)
    assert got.keys() == want.keys()
    for path in want:
        np.testing.assert_array_equal(got[path], want[path], err_msg=path)
    wide = _hf_model(vocab_size=10, n_positions=4, n_embd=768, n_layer=1,
                     n_head=12)
    assert load_torch_gpt2(wide.state_dict(), device="cpu")[1].n_heads == 12
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            load_torch_gpt2(sd, n_heads=3)


def test_imported_model_served_token_exact():
    """The imported model (its ``wte`` scaled by 4, the serving tests'
    decisive head) through ``ServingConfig.make`` on the CPU at fp32:
    every request's tokens equal the dense ``generate``'s."""
    model = _hf_model(seed=1)
    with torch.no_grad():
        model.transformer.wte.weight.mul_(4.0)
    params, cfg = load_torch_gpt2(model.state_dict(), n_heads=4,
                                  device="cpu")
    rs = np.random.RandomState(2)
    prompts = [rs.randint(0, 97, n).astype(np.int32) for n in (3, 9, 14)]
    batcher = ServingConfig(page_size=4, n_pages=16, max_slots=2).make(
        params, cfg, compute_dtype="float32", device="cpu",
        on_recompile="raise")
    reqs = [Request(prompt=p, max_new_tokens=6) for p in prompts]
    batcher.run(reqs)
    for r, p in zip(reqs, prompts):
        full = generate(params, torch.as_tensor(p).long()[None], cfg,
                        n_new=6, temperature=0.0,
                        compute_dtype=torch.float32)
        assert r.tokens == full[0, len(p):].tolist()


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


def test_chip_smoke_gpt2_state_dict_builder():
    """The smoke's checkpoint has HF ``GPT2LMHeadModel``'s keys and
    shapes: checked against a ``transformers`` model at GPT-2 small's
    published widths built on the meta device (no memory), and built at
    a small width it round-trips through ``load_torch_gpt2`` bit for bit
    (``lm_head.weight`` the ``wte`` array itself, wte scaled by 4, the
    layer-norm weights near 1), every tensor where ``imported_leaf``
    says."""
    transformers = pytest.importorskip("transformers")
    cs = _chip_smoke()
    small = GPTConfig()
    assert (small.vocab, small.n_layers, small.d_model, small.n_heads,
            small.seq_len) == (50257, 12, 768, 12, 1024)
    with torch.device("meta"):
        hf = transformers.GPT2LMHeadModel(transformers.GPT2Config())
    want = {k: tuple(v.shape) for k, v in hf.state_dict().items()}
    assert cs.gpt2_shapes(small) == want
    assert sum(np.prod(s) for k, s in want.items()
               if k != "lm_head.weight") == 124_439_808

    cfg = GPTConfig(vocab=160, n_layers=2, d_model=768, n_heads=12,
                    seq_len=32)
    sd = cs.gpt2_state_dict(cfg)
    assert {k: v.shape for k, v in sd.items()} == cs.gpt2_shapes(cfg)
    assert sd["lm_head.weight"] is sd["transformer.wte.weight"]
    assert all(v.dtype == np.float32 for v in sd.values())
    assert 0.06 < sd["transformer.wte.weight"].std() < 0.1
    assert abs(sd["transformer.h.1.ln_2.weight"].mean() - 1) < 0.01
    params, got = load_torch_gpt2(sd, device="cpu")
    assert got == cfg
    for key, a in sd.items():
        if key != "lm_head.weight":
            leaf = cs.imported_leaf(params, key)
            assert leaf.dtype == torch.float32
            assert torch.equal(leaf, torch.from_numpy(a)), key
    again = cs.gpt2_state_dict(cfg)
    assert all(np.array_equal(again[k], sd[k]) for k in sd)


@pytest.mark.parametrize("name", ["lamb", "lion", "adafactor"])
def test_chip_smoke_finetune_config_is_the_train_config_but_its_optimizer(
        name):
    """Each fine-tune of the ``gpt2_import`` phase is the ``train``
    phase's config (GPT-2 small, batch 8 x 1024, bf16, remat, chunked
    head, clip 1.0, ``synthetic_lm``) for 8 steps with no sample, but its
    optimizer's name and lr; the config builds that optimizer."""
    import dataclasses

    cs = _chip_smoke()
    conf = cs.gpt2_finetune_config(name)
    want = cs.gpt2_train_config(cs.GPT2_STEPS, sample_tokens=0)
    assert dataclasses.replace(conf, optim=want.optim) == want
    assert dataclasses.replace(conf.optim, name="adamw",
                               lr=want.optim.lr) == want.optim
    assert (conf.optim.name, conf.optim.lr) == (name, cs.GPT2_LR[name])
    assert conf.model.remat and conf.model.chunked_head
    assert conf.model.make() == GPTConfig()
    tx = conf.optim.make(conf.scheduler.make(conf.optim))
    opt = tx.init({"w": torch.zeros(2, 2)})
    assert type(opt).__name__.lower() == name
