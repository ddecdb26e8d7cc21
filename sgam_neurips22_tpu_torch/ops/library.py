"""The port's six hand kernels as `torch.library` custom ops, namespace `sgam`.

Importing this module registers them (the `ops` package imports it, so any
import of a kernel module does). Each op has three implementations:

- CUDA: the kernel's launch path in its `ops/` module (`*_cuda`): every
  check, the ctypes launch through `cuda_build`, and one added to the
  public wrapper's `.launches`, so that a call from an exported program
  counts too;
- CPU: the kernel's plain PyTorch version;
- fake: the output's shape and dtype only, for `torch.export` and other
  tracers (fake tensors have no storage, so `data_ptr()` appears only in
  the CUDA implementations).

A CUDA tensor launches the kernel or raises; nothing falls back to the
plain version. The public wrappers (`ops.zbuffer.zbuffer_min`,
`ops.vq.nearest_codeword`, `ops.attention.flash_attention_fwd` / `_dq` /
`_dkv`, `ops.grid_accumulate.grid_accumulate`) check their arguments and
call `torch.ops.sgam.<name>`. `grid_accumulate` adds into its `grid` and
returns nothing (an op may not return an alias of an input); its wrapper
returns the grid. `flash_attention_fwd` carries an autograd formula that
calls `ops.attention.flash_attention_bwd`, looked up at each call; the
model's attention differentiates through `ops.attention.FlashAttention`,
which calls the ops.

The ops are defined on a `torch.library.Library` with their schemas and
kernels registered per dispatch key, not through `torch.library.custom_op`,
which wraps every kernel in Python wrappers of its own (autograd and
backend) that cost host time on every call (PERF.md; the batch-1 paths
are host-bound).

This module imports torch and the `ops/` wrappers only: a process that
loads an exported program (`export_aot.load_step`) imports it and nothing
of the model.
"""
from __future__ import annotations

import torch

from sgam_neurips22_tpu_torch.ops import attention, vq, zbuffer
from sgam_neurips22_tpu_torch.ops import grid_accumulate as accumulate

_LIB = torch.library.Library("sgam", "DEF")  # the ops live as long as this object


def _op(schema: str, cpu, cuda, fake) -> None:
    name = schema.split("(")[0]
    _LIB.define(schema)
    _LIB.impl(name, cpu, "CPU")
    _LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"sgam::{name}", fake, lib=_LIB)


def _grid_accumulate_cpu(grid, idx, vals) -> None:
    accumulate.grid_accumulate_plain(grid, idx, vals)


_op("zbuffer_min(Tensor pix, Tensor key, int h, int w) -> Tensor",
    zbuffer.zbuffer_min_plain, zbuffer.zbuffer_min_cuda,
    lambda pix, key, h, w: pix.new_empty((pix.shape[0], h * w)))
_op("nearest_codeword(Tensor z_flat, Tensor codebook) -> (Tensor, Tensor)",
    vq.nearest_codeword_plain, vq.nearest_codeword_cuda,
    lambda z, cb: (z.new_empty(z.shape[0], dtype=torch.int32), z.new_empty(z.shape[0], dtype=torch.float32)))
_op("flash_attention_fwd(Tensor q, Tensor k, Tensor v) -> (Tensor, Tensor)",
    attention.flash_attention_plain, attention.flash_attention_fwd_cuda,
    lambda q, k, v: (q.new_empty(q.shape), q.new_empty(q.shape[:2])))
_op("flash_attention_dq(Tensor q, Tensor k, Tensor v, Tensor dout, Tensor lse, Tensor dd) -> Tensor",
    attention.flash_attention_dq_plain, attention.flash_attention_dq_cuda,
    lambda q, k, v, dout, lse, dd: q.new_empty(q.shape))
_op("flash_attention_dkv(Tensor q, Tensor k, Tensor v, Tensor dout, Tensor lse, Tensor dd) -> (Tensor, Tensor)",
    attention.flash_attention_dkv_plain, attention.flash_attention_dkv_cuda,
    lambda q, k, v, dout, lse, dd: (k.new_empty(k.shape), v.new_empty(v.shape)))
_op("grid_accumulate(Tensor(a!) grid, Tensor idx, Tensor vals) -> ()",
    _grid_accumulate_cpu, accumulate.grid_accumulate_cuda, lambda grid, idx, vals: None)


def _fwd_setup_context(ctx, inputs, output):
    ctx.save_for_backward(*inputs, *output)


def _fwd_backward(ctx, dout, dlse):
    q, k, v, out, lse = ctx.saved_tensors
    return attention.flash_attention_bwd(q, k, v, out, lse, dout.contiguous(), dlse)


torch.library.register_autograd("sgam::flash_attention_fwd", _fwd_backward, setup_context=_fwd_setup_context,
                                lib=_LIB)
