"""The port's hand kernels as `torch.library` custom ops (`ops/library.py`)
on the CPU:

- `torch.library.opcheck` passes for each of the six ops on small inputs
  (schema, fake tensors, autograd registration, AOT dispatch): the flash
  forward with inputs that require grad (its autograd formula), and
  `grid_accumulate` for its declared mutation of `grid`; each op has a
  CPU, a CUDA and a fake (Meta) kernel, its CPU kernel is the plain
  version bit for bit, and its CUDA implementation raises for CPU tensors
  without counting a launch;
- the flash forward op's autograd formula: with lse unused, FlashAttention's
  gradients bit for bit; with an upstream gradient on lse too, autograd of
  the plain forward at atol 3e-5 (test_torch_port_flash_bwd's tolerance);
  it looks `ops.attention.flash_attention_bwd` up at each call, as
  FlashAttention does (chip_smoke plants its dV fault there);
- `torch.export` of a TINY forward with flash attention on keeps
  `sgam.flash_attention_fwd` and `sgam.nearest_codeword` as nodes, and the
  exported module equals the eager forward.
"""
import dataclasses

import numpy as np
import pytest
import torch

from sgam_neurips22_tpu_torch.core.state_dict import load_into, random_state_dict
from sgam_neurips22_tpu_torch.models.vqgan.model import VQModel
from sgam_neurips22_tpu_torch.ops import attention, vq, zbuffer
from sgam_neurips22_tpu_torch.ops import grid_accumulate as accumulate
from torch_port_common import TINY, port_config, t


def _attention_inputs(seed, shape=(2, 40, 64)):
    rng = np.random.default_rng(seed)
    q, k, v, dout = (t(rng.normal(size=shape).astype(np.float32)) for _ in range(4))
    out, lse = attention.flash_attention_plain(q, k, v)
    return q, k, v, dout, lse, (dout * out).sum(-1)


def _cases():
    """op name -> (its args, its plain version, its public wrapper, its CUDA implementation)."""
    rng = np.random.default_rng(0)
    pix = t(rng.integers(-3, 70, (2, 50), dtype=np.int32))  # ids past 8*8 and negative ones drop
    key = t(rng.integers(0, 1000, (2, 50), dtype=np.int32))
    z, cb = t(rng.normal(size=(30, 16)).astype(np.float32)), t(rng.normal(size=(20, 16)).astype(np.float32))
    q, k, v, dout, lse, dd = _attention_inputs(1)
    grid = t(rng.normal(size=20).astype(np.float32))
    idx, vals = t(rng.integers(0, 20, 50, dtype=np.int32)), t(rng.normal(size=50).astype(np.float32))
    return {
        "zbuffer_min": ((pix, key, 8, 8), zbuffer.zbuffer_min_plain, zbuffer.zbuffer_min, zbuffer.zbuffer_min_cuda),
        "nearest_codeword": ((z, cb), vq.nearest_codeword_plain, vq.nearest_codeword, vq.nearest_codeword_cuda),
        "flash_attention_fwd": (tuple(x.clone().requires_grad_() for x in (q, k, v)),
                                attention.flash_attention_plain, attention.flash_attention_fwd,
                                attention.flash_attention_fwd_cuda),
        "flash_attention_dq": ((q, k, v, dout, lse, dd), attention.flash_attention_dq_plain,
                               attention.flash_attention_dq, attention.flash_attention_dq_cuda),
        "flash_attention_dkv": ((q, k, v, dout, lse, dd), attention.flash_attention_dkv_plain,
                                attention.flash_attention_dkv, attention.flash_attention_dkv_cuda),
        "grid_accumulate": ((grid, idx, vals), accumulate.grid_accumulate_plain, accumulate.grid_accumulate,
                            accumulate.grid_accumulate_cuda),
    }


@pytest.mark.parametrize("name", list(_cases()))
def test_op_checks_and_kernels(name):
    args, plain, wrapper, cuda_impl = _cases()[name]
    op = getattr(torch.ops.sgam, name).default
    torch.library.opcheck(op, args)
    for key in ("CPU", "CUDA", "Meta"):
        assert torch._C._dispatch_has_kernel_for_dispatch_key(f"sgam::{name}", key), key
    copies = lambda: [x.detach().clone() if isinstance(x, torch.Tensor) else x for x in args]  # noqa: E731
    got, want = copies(), copies()
    out, ref = op(*got), plain(*want)
    if name == "grid_accumulate":  # no output: the grid itself
        out, ref = got[0], want[0]
    for a, b in zip(*(x if isinstance(x, tuple) else (x,) for x in (out, ref))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with pytest.raises(ValueError, match="cpu"):
        cuda_impl(*copies())
    assert wrapper.launches == 0


def test_grid_accumulate_wrapper_returns_its_grid():
    args = _cases()["grid_accumulate"][0]
    grid = args[0].clone()
    before = grid.clone()
    assert accumulate.grid_accumulate(grid, *args[1:]) is grid
    assert torch.equal(grid, accumulate.grid_accumulate_plain(before, *args[1:]))


def _grads(fn, q, k, v, dout, dlse=None):
    q, k, v = (x.clone().requires_grad_() for x in (q, k, v))
    out, lse = fn(q, k, v)
    loss = (out * dout).sum() + (0 if dlse is None else (lse * dlse).sum())
    return torch.autograd.grad(loss, (q, k, v))


def test_fwd_op_autograd():
    q, k, v, dout, _, _ = _attention_inputs(2, (2, 70, 128))
    op = torch.ops.sgam.flash_attention_fwd
    qs, ks, vs = (x.clone().requires_grad_() for x in (q, k, v))
    flash = torch.autograd.grad(attention.flash_attention(qs, ks, vs), (qs, ks, vs), dout)
    for a, b in zip(_grads(op, q, k, v, dout), flash):
        assert torch.equal(a, b)
    dlse = t(np.random.default_rng(3).normal(size=q.shape[:2]).astype(np.float32))
    for a, b in zip(_grads(op, q, k, v, dout, dlse), _grads(attention.flash_attention_plain, q, k, v, dout, dlse)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=3e-5, rtol=0)


def test_fwd_op_backward_looks_up_flash_attention_bwd(monkeypatch):
    q, k, v, dout, _, _ = _attention_inputs(4)
    bwd = attention.flash_attention_bwd
    monkeypatch.setattr(attention, "flash_attention_bwd",
                        lambda *a: (lambda dq, dk, dv: (dq, dk, torch.zeros_like(dv)))(*bwd(*a)))
    dq, _, dv = _grads(torch.ops.sgam.flash_attention_fwd, q, k, v, dout)
    assert float(dq.abs().max()) > 0 and float(dv.abs().max()) == 0


def test_export_keeps_flash_attention_op():
    cfg = port_config(TINY)
    cfg = dataclasses.replace(cfg, ddconfig=dataclasses.replace(cfg.ddconfig, flash_attention=True))
    model = VQModel(cfg)
    load_into(model, random_state_dict(model, 0))
    model.eval()
    rng = np.random.default_rng(5)
    x = t(rng.uniform(-1, 1, (2, 16, 16, 4)).astype(np.float32))
    mask = t(rng.random((2, 16, 16)) < 0.5)

    class Forward(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.model = model

        def forward(self, x, mask):
            res = self.model(x, extrapolation_mask=mask)
            return res.xrec, res.indices

    with torch.no_grad():
        exported = torch.export.export(Forward(), (x, mask))
        want = Forward()(x, mask)
    targets = {n.target for n in exported.graph.nodes if n.op == "call_function"}
    assert torch.ops.sgam.flash_attention_fwd.default in targets
    assert torch.ops.sgam.nearest_codeword.default in targets
    assert all(torch.equal(a, b) for a, b in zip(exported.module()(x, mask), want))
