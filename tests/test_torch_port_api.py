"""The JAX package's public helpers without a kernel, and its package-level
re-exports, against the port's counterparts on the CPU (seeded numpy
inputs on both sides): `decode_code` (TINY, the JAX weights carried over by
`core.state_dict`, at test_torch_port_vqgan.py's decoder tolerance, 2e-4),
the codebook helpers of `models/vqgan/quantize.py` (exact; the random
branch of `remap_to_used` draws from a torch.Generator where JAX takes a
key, so only its range and its matched positions are compared), the
camera helpers (exact; `relative_transform` inverts a matrix, at 1e-5),
`get_closest_anchor`, `TSDFVolume.pool_count` and `native_available`."""
import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sgam_neurips22_tpu.core as j_core
import sgam_neurips22_tpu.geometry as j_geometry
import sgam_neurips22_tpu.models as j_models
from sgam_neurips22_tpu.geometry import camera as j_camera
from sgam_neurips22_tpu.mapping import mesh as j_mesh
from sgam_neurips22_tpu.mapping import tsdf as j_tsdf
from sgam_neurips22_tpu.models import init_vqmodel
from sgam_neurips22_tpu.models.vqgan import model as j_model
from sgam_neurips22_tpu.models.vqgan import quantize as j_quantize
from sgam_neurips22_tpu.pipeline import selection as j_selection
from sgam_neurips22_tpu.pipeline import trajectory as j_trajectory
from sgam_neurips22_tpu_torch import core as t_core
from sgam_neurips22_tpu_torch import geometry as t_geometry
from sgam_neurips22_tpu_torch import models as t_models
from sgam_neurips22_tpu_torch.geometry import camera
from sgam_neurips22_tpu_torch.mapping import mesh, tsdf
from sgam_neurips22_tpu_torch.models.vqgan import model as t_model
from sgam_neurips22_tpu_torch.models.vqgan import quantize
from sgam_neurips22_tpu_torch.pipeline import selection, trajectory
from torch_port_common import TINY, port_model

# JAX functions of (params, cfg, ...) that are VQModel methods in the port
MODEL_METHODS = {"decode", "decode_features", "encode_prequant", "forward", "get_last_layer", "init_vqmodel"}


def _public(mod):
    return {n for n in vars(mod) if not n.startswith("_") and not isinstance(vars(mod)[n], type(jax))}


@pytest.mark.parametrize("jmod,tmod,missing", [(j_geometry, t_geometry, set()), (j_models, t_models, MODEL_METHODS),
                                               (j_core, t_core, set())], ids=["geometry", "models", "core"])
def test_package_reexports_match_jax(jmod, tmod, missing):
    names = _public(jmod)
    assert names - _public(tmod) == missing
    if hasattr(jmod, "__all__"):
        assert tmod.__all__ == jmod.__all__
    for name in names - missing:  # each function or class from the module JAX takes it from
        if inspect.isfunction(getattr(jmod, name)) or inspect.isclass(getattr(jmod, name)):
            assert getattr(tmod, name).__module__.split(".")[-1] == getattr(jmod, name).__module__.split(".")[-1], name


def test_decode_code_matches_jax():
    params = jax.jit(init_vqmodel, static_argnums=1)(jax.random.PRNGKey(0), TINY)  # tiny_jax_params, compiled
    idx = np.random.default_rng(0).integers(0, TINY.n_embed, (2, 8, 8)).astype(np.int32)
    ref = np.asarray(jax.jit(j_model.decode_code, static_argnums=1)(params, TINY, jnp.asarray(idx)))
    model = port_model(params, TINY)
    with torch.no_grad():
        got = t_model.decode_code(model, torch.as_tensor(idx).long())
    assert got.shape == ref.shape == (2, 16, 16, 4)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-4)
    assert torch.equal(got, t_models.decode_code(model, torch.as_tensor(idx).long()))


def test_codebook_helpers_match_jax():
    rng = np.random.default_rng(1)
    used = np.array([3, 7, 11, 20], np.int64)
    idx = rng.integers(0, 24, (3, 5)).astype(np.int64)
    for unknown in (0, 2):
        ref = np.asarray(j_quantize.remap_to_used(jnp.asarray(idx), jnp.asarray(used), unknown_index=unknown))
        got = quantize.remap_to_used(torch.as_tensor(idx), torch.as_tensor(used), unknown_index=unknown)
        np.testing.assert_array_equal(got.numpy(), ref)
        np.testing.assert_array_equal(quantize.unmap_to_all(got, torch.as_tensor(used)).numpy(),
                                      np.asarray(j_quantize.unmap_to_all(jnp.asarray(ref), jnp.asarray(used))))
    known = np.isin(idx, used)
    drawn = quantize.remap_to_used(torch.as_tensor(idx), torch.as_tensor(used),
                                   generator=torch.Generator().manual_seed(0)).numpy()
    j_drawn = np.asarray(j_quantize.remap_to_used(jnp.asarray(idx), jnp.asarray(used), rng=jax.random.PRNGKey(0)))
    np.testing.assert_array_equal(drawn[known], j_drawn[known])
    assert (~known).any() and drawn.min() >= 0 and drawn.max() < len(used)
    with pytest.raises(ValueError, match="torch.Generator"):
        quantize.remap_to_used(torch.as_tensor(idx), torch.as_tensor(used))
    beyond = np.array([0, 3, 4, 9])  # past the table: entry 0
    np.testing.assert_array_equal(quantize.unmap_to_all(torch.as_tensor(beyond), torch.as_tensor(used)).numpy(),
                                  np.asarray(j_quantize.unmap_to_all(jnp.asarray(beyond), jnp.asarray(used))))

    cb = rng.normal(size=(10, 4)).astype(np.float32)
    codes = rng.integers(0, 10, (2, 3, 3))
    np.testing.assert_array_equal(quantize.embed_code(torch.as_tensor(cb), torch.as_tensor(codes)).numpy(),
                                  np.asarray(j_quantize.embed_code(jnp.asarray(cb), jnp.asarray(codes))))
    feats, rows = rng.normal(size=(3, 4)), np.array([1, 5, 8])
    got = quantize.update_codebook(torch.as_tensor(cb), torch.as_tensor(feats), torch.as_tensor(rows))
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        j_quantize.update_codebook(jnp.asarray(cb), jnp.asarray(feats, jnp.float32), jnp.asarray(rows))))
    assert got.dtype == torch.float32 and not np.array_equal(got.numpy(), cb)  # a copy: cb stays
    usage = quantize.codebook_usage(torch.as_tensor(codes), 12)
    assert usage.dtype == torch.int32
    np.testing.assert_array_equal(usage.numpy(), np.asarray(j_quantize.codebook_usage(jnp.asarray(codes), 12)))


def test_camera_helpers_match_jax():
    k = camera.make_intrinsics(355.5555, 300.25, 128.0, 96.5)
    assert k.dtype == torch.float32
    np.testing.assert_array_equal(k.numpy(), np.asarray(j_camera.make_intrinsics(355.5555, 300.25, 128.0, 96.5)))
    rng = np.random.default_rng(2)
    r = [np.linalg.qr(rng.normal(size=(3, 3)))[0] for _ in range(4)]
    poses = np.tile(np.eye(4), (4, 1, 1))
    for i in range(4):
        poses[i, :3, :3], poses[i, :3, 3] = r[i], rng.normal(size=3)
    poses = poses.astype(np.float32)
    got = camera.relative_transform(torch.as_tensor(poses[:2]), torch.as_tensor(poses[2:]))
    np.testing.assert_allclose(got.numpy(), np.asarray(j_camera.relative_transform(jnp.asarray(poses[:2]),
                                                                                   jnp.asarray(poses[2:]))),
                               atol=1e-5)
    np.testing.assert_array_equal(camera.opengl_to_opencv(torch.as_tensor(poses)).numpy(),
                                  np.asarray(j_camera.opengl_to_opencv(jnp.asarray(poses))))


@pytest.mark.parametrize("dataset", ["clevr-infinite", "google_earth"])
def test_get_closest_anchor_matches_jax(dataset):
    grid = trajectory.prepare_grid(dataset, (5, 4))
    j_grid = j_trajectory.prepare_grid(dataset, (5, 4))
    for anchors in ([0], [0, 7], [3, 12, 19]):
        for tgt in range(grid.size):
            assert selection.get_closest_anchor(grid, anchors, tgt) == j_selection.get_closest_anchor(
                j_grid, anchors, tgt)


def test_pool_count_matches_jax():
    cfg = j_tsdf.TSDFConfig(dims=(16, 16, 16), voxel_size=0.1, sdf_trunc=0.4, origin=(-0.8, -0.8, 0.0),
                            pool_capacity=1 << 10, pool_cells=4)
    jvol = j_tsdf.create_volume(cfg, n_scenes=2)
    counts = np.random.default_rng(3).integers(0, 200, np.shape(jvol.cell_counts)).astype(np.int32)
    jvol = dataclasses.replace(jvol, cell_counts=jnp.asarray(counts))
    vol = tsdf.volume_from_numpy({f: np.asarray(getattr(jvol, f)) for f in tsdf.FIELDS}, device="cpu")
    assert int(vol.pool_count) == int(jvol.pool_count) == int(counts.sum())


def test_native_available_matches_jax():
    assert mesh.native_available() is True  # g++ builds it here, as make builds JAX's
    assert j_mesh.native_available() is True
