from .postprocess import (
    detector_postprocess,
    paste_masks_np,
    postprocess,
    single_wrap_outputs,
)
from .preprocess import (
    FIXED_EDGE_SIZE,
    MAX_EDGE_SIZE,
    MIN_EDGE_SIZE,
    PIXEL_MEAN,
    PIXEL_STD,
    compute_resize_shape,
    postprocess_scale,
    preprocess_for_model,
    read_image_bgr,
    resize_shortest_edge,
    s2d_pack_u8,
    s2d_pack_u8_tight,
    s2d_preprocess,
    s2d_serving_canvas,
    single_preprocessing,
    stem_space_to_depth,
)
