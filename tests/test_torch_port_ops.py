"""The PyTorch port's kernel modules on the CPU, where each wrapper runs its
plain version: the z-buffer merge against the JAX Pallas kernel (interpret
mode) and the XLA scatter-min, bit-exact; the codeword search against the
JAX Pallas kernel (interpret mode) and `codeword_distances`."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgam_neurips22_tpu.models.vqgan.quantize import codeword_distances as j_distances
from sgam_neurips22_tpu.ops.splat_pallas import zbuffer_min as j_zbuffer_min
from sgam_neurips22_tpu.ops.vq_pallas import nearest_codeword as j_nearest
from sgam_neurips22_tpu_torch.ops import cuda_build
from sgam_neurips22_tpu_torch.ops.vq import nearest_codeword
from sgam_neurips22_tpu_torch.ops.zbuffer import IMAX, zbuffer_min
from torch_port_common import t

B = 2


def _xla_zbuffer_min(pix, key, h, w):
    return np.stack([
        np.asarray(jnp.full((h * w,), IMAX, jnp.int32).at[p].min(k, mode="drop"))
        for p, k in zip(pix, key)
    ])


def _case(name):
    """The cases of tests/test_ops.py at B=2: (pix, key, h, w); and two of
    the port's: the map-requery pool splat's sign-flipped keys
    (sgam_neurips22_tpu/mapping/tsdf.py:931-940: uint32 zq << 20 | slot,
    with zq on both sides of 2048, xor 0x80000000 into int32, so both signs
    occur), and a P that is not a multiple of the kernel's 4-wide loads."""
    rng = np.random.default_rng(5)
    if name == "all_invalid":
        h, w, p = 8, 128, 256
        return np.zeros((B, p), np.int32), np.full((B, p), IMAX, np.int32), h, w
    h, w, p = 16, 128, 701 if name == "ragged" else 700  # p not a multiple of the TPU kernel's chunk*group
    pix = rng.integers(0, h * w, (B, p), dtype=np.int32)
    if name == "collisions":
        pix[:, :50] = 7  # 50-way collision on one pixel
        pix[1, 50:300] = rng.integers(0, 4, 250)  # dense collisions on 4 pixels
    key = rng.integers(0, 2**30, (B, p), dtype=np.int32)
    if name == "sign_flipped":
        pix[:, 100:200] = rng.integers(0, 8, 100)  # negative and positive keys meet on 8 pixels
        zq = rng.integers(0, 4096, (B, p)).astype(np.uint32)
        key = ((zq << np.uint32(20)) | np.arange(p, dtype=np.uint32)) ^ np.uint32(0x80000000)
        key = key.view(np.int32)
        assert (key < 0).any() and (key >= 0).any()
    valid = rng.random((B, p)) < 0.8
    return np.where(valid, pix, 0), np.where(valid, key, IMAX), h, w


@pytest.mark.parametrize("name", ["collisions", "random", "all_invalid", "sign_flipped", "ragged"])
def test_zbuffer_plain_bit_exact_vs_jax(name):
    pix, key, h, w = _case(name)
    ours = zbuffer_min(t(pix), t(key), h, w).numpy()
    pallas = np.asarray(j_zbuffer_min(jnp.asarray(pix), jnp.asarray(key), h, w, chunk=128, group=4, interpret=True))
    np.testing.assert_array_equal(ours, pallas)
    np.testing.assert_array_equal(ours, _xla_zbuffer_min(pix, key, h, w))
    if name == "all_invalid":
        assert (ours == IMAX).all()


def test_zbuffer_drops_out_of_range_pixels():
    pix = np.array([[3, 70, 64, 3]], np.int32)  # ids 70 and 64 are past 8*8
    key = np.array([[9, 1, 2, 5]], np.int32)
    ours = zbuffer_min(t(pix), t(key), 8, 8).numpy()
    np.testing.assert_array_equal(ours, _xla_zbuffer_min(pix, key, 8, 8))
    assert ours[0, 3] == 5 and (np.delete(ours[0], 3) == IMAX).all()


def test_wrappers_run_plain_only_for_cpu_tensors():
    """Only a CPU tensor reaches the plain version: on any other device a
    wrapper launches its kernel (CUDA) or raises."""
    with pytest.raises(ValueError):
        zbuffer_min(torch.zeros(1, 4, dtype=torch.int32, device="meta"),
                    torch.zeros(1, 4, dtype=torch.int32, device="meta"), 2, 2)
    with pytest.raises(ValueError):
        nearest_codeword(torch.zeros(2, 4, device="meta"), torch.zeros(3, 4, device="meta"))


def test_zbuffer_rejects_wrong_dtype():
    with pytest.raises(TypeError):
        zbuffer_min(t(np.zeros((1, 4), np.int64)), t(np.zeros((1, 4), np.int32)), 2, 2)


@pytest.mark.parametrize("p,k,d,scale", [
    (256, 1500, 64, 1.0),  # test_ops.py's case: K not a multiple of any tile
    (13, 256, 32, 1.0),  # P not a multiple of 8
    (256, 4096, 64, 1.0 / 4096),  # a flagship-like codebook scale
])
def test_nearest_codeword_plain_vs_jax(p, k, d, scale):
    rng = np.random.default_rng(p + k)
    z = rng.normal(size=(p, d)).astype(np.float32)
    cb = (rng.uniform(-1, 1, size=(k, d)) * scale).astype(np.float32)
    idx, dist = nearest_codeword(t(z), t(cb))
    j_idx, j_dist = j_nearest(jnp.asarray(z), jnp.asarray(cb), tile_k=512, interpret=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    ref = np.asarray(j_distances(jnp.asarray(z), jnp.asarray(cb)))
    np.testing.assert_allclose(dist.numpy(), np.asarray(j_dist), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(dist.numpy(), ref.min(axis=1), rtol=1e-4, atol=1e-4)


def test_nearest_codeword_first_occurrence_ties():
    cb = np.zeros((6, 4), np.float32)
    cb[2] = cb[4] = 1.0  # two identical nearest codewords
    z = np.ones((3, 4), np.float32)
    idx, dist = nearest_codeword(t(z), t(cb))
    assert idx.tolist() == [2, 2, 2]
    np.testing.assert_allclose(dist.numpy(), 0.0, atol=1e-6)


def test_kernel_libraries_are_named_by_source_hash():
    """The build writes each kernel's library under a name carrying the
    hash of its source, into the package's build/ directory."""
    for name in ("zbuffer_min", "nearest_codeword", "flash_attention_fwd"):
        path = cuda_build.lib_path(name)
        assert path.parent == cuda_build.BUILD_DIR
        assert path.name.startswith(f"lib{name}-") and path.suffix == ".so"
        assert (cuda_build.CSRC / f"{name}.cu").is_file()


KERNELS = ["zbuffer_min", "nearest_codeword", "flash_attention_fwd", "flash_attention_dq",
           "flash_attention_dkv"]


@pytest.mark.parametrize("name", KERNELS)
def test_kernel_library_hash_covers_its_headers(name, tmp_path, monkeypatch):
    """A library is rebuilt when its source or a csrc/*.cuh header that it
    includes changes, and only then: a header edit leaves the libraries of
    the kernels that do not include it as they were."""
    for f in cuda_build.CSRC.iterdir():
        if f.suffix in (".cu", ".cuh"):
            (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(cuda_build, "CSRC", tmp_path)
    path = cuda_build.lib_path(name)
    includes = '#include "mma_tf32.cuh"' in (tmp_path / f"{name}.cu").read_text()
    assert includes == (name in ("nearest_codeword", "flash_attention_fwd", "flash_attention_dq", "flash_attention_dkv"))
    (tmp_path / "mma_tf32.cuh").write_text((tmp_path / "mma_tf32.cuh").read_text() + "\n// edited\n")
    assert (cuda_build.lib_path(name) != path) == includes
    (tmp_path / f"{name}.cu").write_text((tmp_path / f"{name}.cu").read_text() + "\n// edited\n")
    edited = cuda_build.lib_path(name)
    assert edited != path and edited.name.startswith(f"lib{name}-")
