"""PyTorch / CUDA port of `sgam_neurips22_tpu`, for NVIDIA Hopper (sm_90a).

The JAX package beside this one is the reference: every module here keeps
the name of its JAX counterpart, and the tests hold each against it. This
package imports torch, numpy and the standard library only.

Slice covered: the splat-conditioned flythrough unroll at batch 1
(`pipeline.scene_generation.InfiniteSceneGeneration`), with hand-written
CUDA kernels for the z-buffer merge (`ops.zbuffer`) and the codeword search
(`ops.vq`). Entry points run on `cuda` unless the caller passes
`device="cpu"`.
"""
