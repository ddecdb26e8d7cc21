"""The PyTorch port's weight bridge and VQGAN on the CPU, held against the
JAX package and against the frozen reference activations in
tests/goldens/model_stages.npz (as tests/test_goldens.py holds JAX)."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgam_neurips22_tpu.core.torch_convert import params_to_state_dict
from sgam_neurips22_tpu.models import VQModelConfig as JVQModelConfig
from sgam_neurips22_tpu.models import forward as j_forward
from sgam_neurips22_tpu.models import init_vqmodel
from sgam_neurips22_tpu.models.vqgan.autoencoder import apply_decoder, apply_encoder
from sgam_neurips22_tpu.models.vqgan.nn import group_norm as j_group_norm
from sgam_neurips22_tpu.serving import flagship_config as j_flagship_config
from sgam_neurips22_tpu_torch.core.state_dict import from_jax_params, load_into, random_state_dict
from sgam_neurips22_tpu_torch.models.vqgan import autoencoder as t_ae
from sgam_neurips22_tpu_torch.models.vqgan.model import VQModel
from sgam_neurips22_tpu_torch.models.vqgan.nn import group_norm
from sgam_neurips22_tpu_torch.models.vqgan.quantize import (
    codeword_distances,
    quantize,
    quantize_topk,
)
from sgam_neurips22_tpu_torch.serving import flagship_config
from torch_port_common import TINY, port_config, port_model, t, tiny_jax_params, to_numpy_tree

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_params():
    return tiny_jax_params()


@pytest.fixture(scope="module")
def golden_models():
    """Encoder/decoder/codebook of the golden case, loaded strictly from its
    reference-layout state_dict (the config of tests/test_goldens.py)."""
    g = np.load(os.path.join(GOLDENS, "model_stages.npz"))
    sd = {k[len("sd/"):]: g[k] for k in g.files if k.startswith("sd/")}
    dd = t_ae.DDConfig(
        ch=32, out_ch=4, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(16,),
        in_channels=4, resolution=32, z_channels=32,
    )
    enc, dec = t_ae.Encoder(dd).eval(), t_ae.Decoder(dd).eval()
    load_into(enc, {k[8:]: v for k, v in sd.items() if k.startswith("encoder.")})
    load_into(dec, {k[8:]: v for k, v in sd.items() if k.startswith("decoder.")})
    return g, enc, dec, t(sd["quantize.embedding.weight"])


def test_bridge_matches_jax_export_and_loads_strictly(jax_params):
    sd = from_jax_params(to_numpy_tree(jax_params))
    ref = params_to_state_dict(jax_params)
    assert set(sd) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(sd[k], ref[k], err_msg=k)
    model = VQModel(port_config(TINY))
    own = model.state_dict()
    assert set(own) == set(sd)
    assert all(tuple(own[k].shape) == sd[k].shape for k in sd)
    load_into(model, sd)
    np.testing.assert_array_equal(model.state_dict()["quantize.embedding.weight"].numpy(), sd["quantize.embedding.weight"])
    with pytest.raises(KeyError, match="missing"):
        load_into(model, {k: v for k, v in sd.items() if k != "encoder.conv_in.bias"})
    with pytest.raises(KeyError, match="unexpected"):
        load_into(model, {**sd, "extra.weight": np.zeros(1, np.float32)})
    with pytest.raises(ValueError, match="shape"):
        load_into(model, {**sd, "quant_conv.bias": np.zeros(3, np.float32)})


def test_flagship_layout_matches_jax():
    """The flagship model's state_dict names and shapes equal JAX's
    (shapes only: jax.eval_shape, no weights are drawn), and attention sits
    at the 64x64 level of a 256^2 input (tracked resolution 16, C=256)."""
    jcfg = j_flagship_config()
    shapes = jax.eval_shape(lambda: init_vqmodel(jax.random.PRNGKey(0), jcfg))
    want = from_jax_params(jax.tree_util.tree_map(lambda s: np.empty(s.shape, np.float32), shapes))
    model = VQModel(flagship_config())
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == {k: v.shape for k, v in want.items()}
    levels = [(len(level.attn), level.block[-1].conv2.out_channels) for level in model.encoder.down]
    assert levels == [(0, 128), (0, 128), (2, 256), (0, 256), (0, 512)]
    assert model.codebook.shape == (16384, 256)


@pytest.mark.parametrize("dataset,dtype", [
    ("clevr-infinite", "float32"), ("google_earth", "float32"), ("clevr-infinite", "bfloat16"),
])
def test_flagship_config_matches_jax(dataset, dtype):
    """Every field of the port's flagship_config(dataset, compute_dtype)
    (VQModelConfig and its DDConfig) equals the same-named field of JAX's,
    and JAX's DDConfig fields that the port does not have hold the values
    the port hard-codes (no dropout, no double_z); flash_attention is a
    field of both since the port chooses attention by config, as JAX
    does. Every VQModelConfig field of
    JAX's is the port's too (use_extrapolation_mask and vq_step_threshold
    since the trainer slice)."""
    import dataclasses

    got, want = flagship_config(dataset, dtype), j_flagship_config(dataset, dtype)
    only_jax = {
        "model": {},
        "ddconfig": {"dropout": 0.0, "resamp_with_conv": True, "double_z": False},
    }
    for part, ours, theirs in (("model", got, want), ("ddconfig", got.ddconfig, want.ddconfig)):
        names = {f.name for f in dataclasses.fields(ours)}
        jax_names = {f.name for f in dataclasses.fields(theirs)}
        assert names <= jax_names, f"{part}: port-only fields {names - jax_names}"
        assert jax_names - names == set(only_jax[part]), part
        for name in sorted(names - {"ddconfig"}):
            assert getattr(ours, name) == getattr(theirs, name), f"{part}.{name}"
        for name, value in only_jax[part].items():
            assert getattr(theirs, name) == value, f"{part}.{name}"


def test_random_init_is_seeded():
    model = VQModel(port_config(TINY))
    a, b = random_state_dict(model, 3), random_state_dict(model, 3)
    assert set(a) == set(model.state_dict())
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["encoder.conv_in.weight"], random_state_dict(model, 4)["encoder.conv_in.weight"])
    assert a["quantize.embedding.weight"].abs().max() <= 1.0 / TINY.n_embed


def test_group_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 6, 5, 64)).astype(np.float32) * 3 + 1
    wgt, bias = rng.normal(size=64).astype(np.float32), rng.normal(size=64).astype(np.float32)
    ref = np.asarray(j_group_norm(jnp.asarray(x), {"weight": jnp.asarray(wgt), "bias": jnp.asarray(bias)}))
    got = group_norm(t(x).permute(0, 3, 1, 2), t(wgt), t(bias)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)


@torch.inference_mode()
def test_encoder_decoder_match_jax(jax_params):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 32, 32, 4)).astype(np.float32)
    z = rng.normal(size=(2, 16, 16, 32)).astype(np.float32)
    model = port_model(jax_params, TINY)
    enc = model.encoder(t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    dec = model.decoder(t(z).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(enc, np.asarray(apply_encoder(jax_params["encoder"], TINY.ddconfig, x)), atol=2e-4)
    np.testing.assert_allclose(dec, np.asarray(apply_decoder(jax_params["decoder"], TINY.ddconfig, z)), atol=2e-4)


@torch.inference_mode()
def test_encoder_decoder_match_golden(golden_models):
    g, enc, dec, _ = golden_models
    got = enc(t(g["enc_in"]).permute(0, 3, 1, 2)).numpy()
    np.testing.assert_allclose(got, g["enc_out"], atol=2e-4)
    got = dec(t(g["dec_in"]).permute(0, 3, 1, 2)).numpy()
    np.testing.assert_allclose(got, g["dec_out"], atol=2e-4)


def test_quantize_matches_golden(golden_models):
    g, _, _, codebook = golden_models
    res = quantize(codebook, t(g["vq_in"]), beta=0.25)
    np.testing.assert_array_equal(res.indices.numpy().reshape(-1), g["vq_indices"])
    np.testing.assert_allclose(res.z_q.numpy(), g["vq_zq"].transpose(0, 2, 3, 1), atol=1e-6)
    np.testing.assert_allclose(float(res.loss), float(g["vq_loss"]), rtol=1e-5)
    dist = codeword_distances(t(g["vq_in"]).reshape(-1, 32), codebook)
    np.testing.assert_array_equal(dist.argmin(1).numpy(), g["vq_indices"])


def test_quantize_topk_other_than_one_raises(golden_models):
    """topk > 1 draws: without a generator (or the noise itself) it raises,
    as JAX's forward raises without an rng key; with one it samples among
    each position's topk nearest codewords."""
    g, _, _, codebook = golden_models
    z = t(g["vq_in"])
    with pytest.raises(ValueError, match="generator"):
        quantize_topk(codebook, z, topk=4)
    res = quantize_topk(codebook, z, topk=4, sample_number=3, generator=torch.Generator().manual_seed(0))
    b, h, w, d = z.shape
    assert res.indices.shape == (b, 3, h, w) and res.z_q.shape == (b, 3, h, w, d)
    near = torch.topk(-codeword_distances(z.reshape(-1, d), codebook), 4, dim=1).indices
    drawn = res.indices.permute(0, 2, 3, 1).reshape(-1, 3).long()
    assert bool((drawn[:, :, None] == near[:, None, :]).any(-1).all())


@pytest.mark.parametrize("topk", [None, 1])
@torch.inference_mode()
def test_forward_matches_jax(jax_params, topk):
    """Indices identical, xrec at atol 1e-4 (f32 conv sums taken in another
    order by the two frameworks)."""
    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, (2, 32, 32, 4)).astype(np.float32)
    mask = rng.random((2, 32, 32, 1)) < 0.3
    res = port_model(jax_params, TINY)(t(x), extrapolation_mask=t(mask), topk=topk)
    ref = j_forward(jax_params, TINY, jnp.asarray(x), extrapolation_mask=jnp.asarray(mask),
                    topk=topk, rng=jax.random.PRNGKey(0))
    np.testing.assert_array_equal(res.indices.numpy(), np.asarray(ref.indices))
    np.testing.assert_allclose(res.xrec.numpy(), np.asarray(ref.xrec), atol=1e-4)
    np.testing.assert_allclose(res.pre_quant.numpy(), np.asarray(ref.pre_quant), atol=1e-4)


def test_forward_without_mask_folds_zeros(jax_params):
    x = np.random.default_rng(3).uniform(-1, 1, (1, 32, 32, 4)).astype(np.float32)
    model = port_model(jax_params, TINY)
    with torch.inference_mode():
        a = model.encode_prequant(t(x))
        b = model.encode_prequant(t(x), extrapolation_mask=torch.zeros(1, 32, 32, dtype=torch.bool))
    assert torch.equal(a, b)


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every module of the port, and chip_smoke.py, import with `jax` and
    `sgam_neurips22_tpu` blocked."""
    code = r"""
import importlib, importlib.abc, pkgutil, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        root = name.split(".")[0]
        if root in ("jax", "jaxlib", "sgam_neurips22_tpu"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import sgam_neurips22_tpu_torch as pkg
mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for m in mods:
    importlib.import_module(m)
import chip_smoke
assert not any(k.split(".")[0] in ("jax", "sgam_neurips22_tpu") for k in sys.modules)
print(len(mods))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 15
