"""The port's Vision Transformer and image loaders
(flash_attn_tpu_torch.models.vit, flash_attn_tpu_torch.training.data)
against the JAX package's, and the ViT against HF's
``ViTForImageClassification`` built from a config written here, in fp32 on
the CPU: the same seeded inputs, the logits within atol 1e-4 of JAX's
(both pooling modes) and within the JAX package's HF tolerances
(tests/test_models_misc.py: atol 5e-4, rtol 5e-3); the loaders' batches
equal, in the same order, after a resume too."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_tpu.models.vit import ViTConfig as JaxViTConfig
from flash_attn_tpu.models.vit import VisionTransformer as JaxViT
from flash_attn_tpu.training import data as jdata
from flash_attn_tpu_torch.models.vit import (
    ViTConfig,
    VisionTransformer,
    load_jax_params,
    remap_state_dict_hf_vit,
    vit_config_from_hf,
)
from flash_attn_tpu_torch.training import data as tdata

torch.set_num_threads(1)

# 32 x 32 images in patches of 8: 16 patches and the cls token
FIELDS = dict(img_size=32, patch_size=8, embed_dim=64, depth=2, num_heads=4,
              num_classes=10)


@pytest.mark.parametrize("global_pool", ["token", "avg"])
def test_vit_matches_jax(global_pool):
    jcfg = JaxViTConfig(global_pool=global_pool, **FIELDS)
    jmodel = JaxViT(jcfg)
    imgs = np.random.default_rng(0).standard_normal(
        (3, 32, 32, 3)).astype(np.float32)
    params = jmodel.init(jax.random.PRNGKey(1), jnp.asarray(imgs))["params"]
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(imgs)))
    tmodel = VisionTransformer(ViTConfig(global_pool=global_pool, **FIELDS),
                               device="cpu")
    load_jax_params(tmodel, jax.tree_util.tree_map(np.asarray, params))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(imgs))
    assert got.dtype == torch.float32 and got.shape == (3, 10)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_vit_matches_hf():
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.ViTConfig(
        image_size=32, patch_size=8, num_channels=3, hidden_size=64,
        num_hidden_layers=2, num_attention_heads=4, intermediate_size=128,
        num_labels=10)
    torch.manual_seed(0)
    hf = transformers.ViTForImageClassification(hf_cfg).eval()
    imgs = torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(3))
    cfg = vit_config_from_hf(hf_cfg, num_classes=10)
    model = VisionTransformer(cfg, device="cpu")
    model.load_state_dict(remap_state_dict_hf_vit(hf.state_dict(), cfg))
    with torch.no_grad():
        want = hf(imgs).logits.float()
        got = model(imgs.permute(0, 2, 3, 1))  # NCHW -> NHWC
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=5e-4,
                               rtol=5e-3)


def test_vit_seeded_weights_are_finite_in_bf16():
    """reset_parameters gives flax's scales; a bf16 model of them gives
    finite logits near the fp32 model's."""
    cfg = ViTConfig(**FIELDS)
    model = VisionTransformer(cfg, device="cpu")
    model.reset_parameters(torch.Generator().manual_seed(0))
    low = VisionTransformer(dataclasses.replace(cfg, dtype=torch.bfloat16),
                            device="cpu")
    low.load_state_dict(model.state_dict())
    imgs = torch.randn(2, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want, got = model(imgs), low(imgs)
    assert torch.isfinite(got).all() and got.dtype == torch.float32
    assert (got - want).abs().max() < 0.1 * want.abs().max()


@pytest.fixture
def image_files(tmp_path):
    """A seeded uint8 image file of 13 images of 6 x 5 x 3 and its labels."""
    rng = np.random.default_rng(7)
    images = rng.integers(0, 256, (13, 6, 5, 3), dtype=np.uint8)
    labels = rng.integers(0, 10, 13).astype(np.int32)
    ipath, lpath = tmp_path / "images.bin", tmp_path / "labels.bin"
    images.tofile(ipath)
    labels.tofile(lpath)
    return str(ipath), str(lpath)


@pytest.mark.parametrize("flip", [True, False])
def test_image_loaders_match_jax(image_files, flip):
    """The same batches in the same order as JAX's loader over two epochs,
    and after load_state_dict of a mid-epoch state."""
    def loaders(mod):
        ds = mod.ImageDataset(*image_files, (6, 5, 3))
        sampler = mod.FaultTolerantSampler(len(ds), seed=3)
        return mod.ImageDataLoader(ds, 4, sampler, random_flip=flip)

    jl, tl = loaders(jdata), loaders(tdata)
    jit, tit = iter(jl), iter(tl)
    for _ in range(5):  # 20 samples: over an epoch boundary
        (ji, jlab), (ti, tlab) = next(jit), next(tit)
        assert ti.dtype == np.float32 and ti.shape == (4, 6, 5, 3)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tlab, jlab)
    state = tl.state_dict()
    assert state == jl.state_dict()
    resumed = loaders(tdata)
    resumed.load_state_dict(state)
    for got, want in zip(iter(resumed), tit):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        if resumed.sampler.epoch == 3:
            break
    with pytest.raises(ValueError, match="whole number"):
        tdata.ImageDataset(*image_files, (7, 5, 3))
