"""The port's top-k codeword sampling (topk > 1) on the CPU against the JAX
package: `quantize_topk` fed JAX's own Gumbel noise (jax.random.categorical
draws argmax(logits[:, None, :] + jax.random.gumbel(rng, (P, S, k)))), at
topk 2 and 8, with and without the extrapolation mask, with a
temperature and in the reference's position-0 mode: the indices must be
equal. Also `resize_mask_nearest` bit-exact, the port's own draws seeded
by a torch.Generator, and a 3x3 unroll at topk 4 whose draws take JAX's
noise, step by step."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgam_neurips22_tpu.models.vqgan.quantize import quantize_topk as j_quantize_topk
from sgam_neurips22_tpu.models.vqgan.quantize import resize_mask_nearest as j_resize
from sgam_neurips22_tpu.pipeline.scene_generation import (
    InfiniteSceneGeneration as JGen,
    SceneGenConfig as JCfg,
)
from sgam_neurips22_tpu_torch.models.vqgan import quantize
from sgam_neurips22_tpu_torch.pipeline.scene_generation import (
    InfiniteSceneGeneration,
    SceneGenConfig,
)
from torch_port_common import H, TINY, TINY_K, W, make_seed, port_model, t, tiny_jax_params


def _latents(seed=0, b=2, h=8, w=8, d=16, k=32):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(b, h, w, d)).astype(np.float32)
    codebook = rng.normal(size=(k, d)).astype(np.float32)
    mask = rng.random((b, 4 * h, 4 * w, 1)) < 0.5
    return z, codebook, mask


@pytest.mark.parametrize("topk,samples,masked,temperature,position0", [
    (2, 1, False, 1.0, False),
    (8, 3, False, 1.0, False),
    (8, 2, True, 1.0, False),
    (2, 2, True, 0.5, False),
    (8, 1, False, 2.0, False),
    (8, 2, True, 0.5, True),  # position 0's logits; the temperature is ignored
])
def test_quantize_topk_matches_jax_with_its_noise(topk, samples, masked, temperature, position0):
    z, codebook, mask = _latents()
    b, h, w, d = z.shape
    rng = jax.random.PRNGKey(5)
    kw = dict(temperature=temperature, position0_bug=position0)
    ref = j_quantize_topk(jnp.asarray(codebook), jnp.asarray(z), rng, topk, samples,
                          jnp.asarray(mask) if masked else None, **kw)
    noise = jax.random.gumbel(rng, (b * h * w, samples, topk))
    got = quantize.quantize_topk(t(codebook), t(z), topk, samples, t(mask) if masked else None,
                                 gumbel=t(noise), **kw)
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(ref.indices))
    np.testing.assert_array_equal(got.z_q.numpy(), np.asarray(ref.z_q))
    nearest = np.argmin(((z.reshape(-1, 1, d) - codebook[None]) ** 2).sum(-1), axis=1)
    drawn = got.indices.numpy().transpose(0, 2, 3, 1).reshape(-1, samples)
    assert (drawn != nearest[:, None]).any()  # the draws really sample
    if masked:  # visible positions take the nearest codeword
        visible = ~quantize.resize_mask_nearest(t(mask[..., 0]).float(), h, w).reshape(-1).bool().numpy()
        assert visible.any()
        np.testing.assert_array_equal(drawn[visible], np.repeat(nearest[visible, None], samples, 1))


@pytest.mark.parametrize("shape_in,shape_out", [((32, 32), (8, 8)), ((30, 22), (16, 16)), ((16, 16), (5, 7)),
                                                ((256, 256), (16, 16))])
def test_resize_mask_nearest_bit_exact(shape_in, shape_out):
    mask = np.random.default_rng(3).random((2, *shape_in)) < 0.4
    for m in (mask, mask.astype(np.float32), mask[..., None]):
        np.testing.assert_array_equal(quantize.resize_mask_nearest(t(m), *shape_out).numpy(),
                                      np.asarray(j_resize(jnp.asarray(m), *shape_out)))


def test_port_draws_are_seeded():
    """The same generator seed gives the same draws, another seed others;
    the Gumbel noise is finite and standard (mean 0.5772, Euler's gamma)."""
    z, codebook, mask = _latents(1)

    def draw(seed):
        g = torch.Generator().manual_seed(seed)
        return quantize.quantize_topk(t(codebook), t(z), 8, 4, t(mask), generator=g).indices

    assert torch.equal(draw(0), draw(0))
    assert not torch.equal(draw(0), draw(1))
    noise = quantize.gumbel_noise((200000,), torch.Generator().manual_seed(0), "cpu")
    assert bool(torch.isfinite(noise).all()) and abs(float(noise.mean()) - 0.5772) < 0.01


@pytest.mark.parametrize("position0", [False, True])
def test_topk_unroll_matches_jax_with_its_noise(monkeypatch, position0):
    """A 3x3 unroll at topk 4 (mask on, as the pipeline passes it): each
    step's draw takes JAX's noise for that step, gumbel(fold_in(rng, t),
    (P, 1, 4)), as JAX's fused unroll draws it; frames equal to JAX's at
    the batch-1 unroll test's tolerances (rgb 1e-5, depth 1e-4)."""
    params = tiny_jax_params()
    kw = dict(dataset="clevr-infinite", output_dim=(3, 3), num_src=3, topk=4, image_resolution=(H, W),
              topk_position0_compat=position0)
    rgb, depth = make_seed()
    seeds = [((0, 0), rgb, depth)]
    rng = jax.random.PRNGKey(9)
    j_rgb, j_depth = JGen(params, TINY, JCfg(**kw), seeds=seeds, intrinsics=TINY_K).scene_expansion(rng)
    step = iter(range(100))

    def jax_noise(shape, generator, device):
        return t(jax.random.gumbel(jax.random.fold_in(rng, next(step)), shape))

    monkeypatch.setattr(quantize, "gumbel_noise", jax_noise)
    gen = InfiniteSceneGeneration(port_model(params, TINY), SceneGenConfig(**kw), seeds, intrinsics=TINY_K,
                                  device="cpu")
    p_rgb, p_depth = gen.scene_expansion(torch.Generator())
    assert next(step) == 8  # one draw a generated frame
    np.testing.assert_allclose(p_rgb.numpy(), np.asarray(j_rgb), atol=1e-5)
    np.testing.assert_allclose(p_depth.numpy(), np.asarray(j_depth), atol=1e-4)
