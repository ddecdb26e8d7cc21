"""PyTorch / CUDA port of `sgam_neurips22_tpu`, for NVIDIA Hopper (sm_90a).

The JAX package beside this one is the reference: every module here keeps
the name of its JAX counterpart, and the tests hold each against it. This
package imports torch, numpy and the standard library only (and Pillow,
inside the one branch that resizes a seed template of another size).

Slices covered: the splat-conditioned flythrough unroll, for one scene and
for S scenes at once (`pipeline.scene_generation.InfiniteSceneGeneration`;
f32 or bf16, clevr-infinite or google_earth, every splat collision rule
and stride, top-k sampling), map-requery generation for one scene and
for S scenes at once (`SceneGenConfig(use_rgbd_integration=True)`: the
TSDF map of `mapping.tsdf` and the inverse warp of `geometry.warp`), over
the grid, spiral, cylinder or pose-file trajectory, streamed frame by
frame with the reference's exports (`mapping.pointcloud`, `mapping.mesh`),
behind the CLI `python -m sgam_neurips22_tpu_torch.generate`; and the
two-optimizer GAN training step (`training.train_step`), with
hand-written CUDA kernels for the z-buffer merge (`ops.zbuffer`), the
codeword search (`ops.vq`) and the flash attention forward and backward
(`ops.attention`). Entry points run on `cuda` unless the caller passes
`device="cpu"`.
"""
