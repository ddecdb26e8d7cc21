"""PyTorch / CUDA port of `sgam_neurips22_tpu`, for NVIDIA Hopper (sm_90a).

The JAX package beside this one is the reference: every module here keeps
the name of its JAX counterpart, and the tests hold each against it. This
package imports torch, numpy, PyYAML (`core.config`) and the standard
library only (and Pillow, inside the branches that resize an image of
another size), and builds its host C++ with g++ at first use
(`core.native`).

Slices covered: the splat-conditioned flythrough unroll, for one scene and
for S scenes at once (`pipeline.scene_generation.InfiniteSceneGeneration`;
f32 or bf16, clevr-infinite or google_earth, every splat collision rule
and stride, top-k sampling), map-requery generation for one scene and
for S scenes at once (`SceneGenConfig(use_rgbd_integration=True)`: the
TSDF map of `mapping.tsdf` and the inverse warp of `geometry.warp`), over
the grid, spiral, cylinder or pose-file trajectory, streamed frame by
frame with the reference's exports (`mapping.pointcloud`, `mapping.mesh`),
behind the CLI `python -m sgam_neurips22_tpu_torch.generate`; the
two-optimizer GAN training step (`training.train_step`) and the trainer
around it (`training.trainer`: YAML configs, datasets and loader,
checkpoints, online k-means, gradient accumulation, the LR schedule)
behind `python -m sgam_neurips22_tpu_torch.train`, on one device or on
several (`parallel`); serving (`serving`: the inference step, a resident
scene server and its HTTP daemon, `python -m
sgam_neurips22_tpu_torch.serve`) and offline evaluation (`evaluate`); the
AOT export of the inference step (`export_aot`: `torch.export` of the step
with its weights, reloaded without the model code); the checkpoint-parity
tool (`parity_check`, against goldens or its torch-functional oracle) and
the EXR converter (`convert_exr`, over the reader `pipeline.exr`: numpy,
zlib and a C++ Huffman decoder for PIZ and DWA; every OpenEXR codec, tiled
and multipart files); generate's `--matmul_precision`
(`core.device.set_matmul_precision`); with hand-written
CUDA kernels for the z-buffer merge (`ops.zbuffer`), the codeword search
(`ops.vq`), the flash attention forward and backward (`ops.attention`) and
the map's grid accumulation (`ops.grid_accumulate`), each a
`torch.library` custom op (`ops.library`, `torch.ops.sgam.*`). Entry
points run on `cuda` unless the caller passes `device="cpu"`.
"""
