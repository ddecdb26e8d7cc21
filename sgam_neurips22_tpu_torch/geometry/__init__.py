from sgam_neurips22_tpu_torch.geometry.camera import (
    cam2pixel,
    make_intrinsics,
    opengl_to_opencv,
    pixel2cam,
    pixel_grid,
    pose_matrix,
    ray_depth_to_z,
    relative_transform,
    z_depth_to_ray,
)
from sgam_neurips22_tpu_torch.geometry.codec import (
    CLEVR_CODEC,
    CODECS,
    GOOGLE_EARTH_CODEC,
    DepthCodec,
    get_codec,
)
from sgam_neurips22_tpu_torch.geometry.pose import euler2mat, pose_vec2mat, quat2mat
from sgam_neurips22_tpu_torch.geometry.splat import (
    SplatResult,
    median_blur_3x3,
    render_projection_from_srcs,
)
from sgam_neurips22_tpu_torch.geometry.warp import (
    grid_sample_bilinear,
    grid_sample_nearest,
    inverse_warp,
    inverse_warp_multi_src,
)
