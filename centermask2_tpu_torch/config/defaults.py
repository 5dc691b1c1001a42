"""Default configuration (the port's own copy of
``centermask2_tpu/config/defaults.py``; the key schema is shared).

Mirrors the key schema of the reference fork — both its own additions
(reference: centermask2/centermask/config/defaults.py:9-86) and the
detectron2 base keys its code paths read. One new section, ``TPU``, holds
static-shape capacities: on TPU every data-dependent size becomes a
fixed-capacity padded buffer, so the capacities are explicit config.
"""

from .node import CfgNode as CN

_C = CN()

_C.VERSION = 2
_C.OUTPUT_DIR = "./output"
_C.SEED = -1

# ---------------------------------------------------------------------------
# MODEL
# ---------------------------------------------------------------------------
_C.MODEL = CN()
_C.MODEL.META_ARCHITECTURE = "GeneralizedRCNN"
_C.MODEL.DEVICE = "tpu"
_C.MODEL.WEIGHTS = ""
_C.MODEL.MASK_ON = False
_C.MODEL.KEYPOINT_ON = False
_C.MODEL.LOAD_PROPOSALS = False
# BGR means, std=1 (reference: deploy_utils.py:76-83)
_C.MODEL.PIXEL_MEAN = [103.530, 116.280, 123.675]
_C.MODEL.PIXEL_STD = [1.0, 1.0, 1.0]
_C.MODEL.MOBILENET = False

_C.MODEL.BACKBONE = CN()
_C.MODEL.BACKBONE.NAME = "build_fcos_vovnet_fpn_backbone"
_C.MODEL.BACKBONE.FREEZE_AT = 2

# ResNet bottom-up (detectron2 MODEL.RESNETS defaults, read by the
# reference's build_fcos_resnet_fpn_backbone, ref fpn.py:56-87)
_C.MODEL.RESNETS = CN()
_C.MODEL.RESNETS.DEPTH = 50
_C.MODEL.RESNETS.OUT_FEATURES = ["res3", "res4", "res5"]
_C.MODEL.RESNETS.NORM = "FrozenBN"
_C.MODEL.RESNETS.NUM_GROUPS = 1
_C.MODEL.RESNETS.WIDTH_PER_GROUP = 64
_C.MODEL.RESNETS.STRIDE_IN_1X1 = True
_C.MODEL.RESNETS.RES5_DILATION = 1
_C.MODEL.RESNETS.RES2_OUT_CHANNELS = 256
_C.MODEL.RESNETS.STEM_OUT_CHANNELS = 64

_C.MODEL.FPN = CN()
_C.MODEL.FPN.IN_FEATURES = []
_C.MODEL.FPN.OUT_CHANNELS = 256
_C.MODEL.FPN.NORM = ""
_C.MODEL.FPN.FUSE_TYPE = "sum"

_C.MODEL.PROPOSAL_GENERATOR = CN()
_C.MODEL.PROPOSAL_GENERATOR.NAME = "FCOS"
_C.MODEL.PROPOSAL_GENERATOR.MIN_SIZE = 0

# ---------------------------------------------------------------------------
# FCOS head (reference: config/defaults.py:14-50)
# ---------------------------------------------------------------------------
_C.MODEL.FCOS = CN()
_C.MODEL.FCOS.NUM_CLASSES = 80
_C.MODEL.FCOS.IN_FEATURES = ["p3", "p4", "p5", "p6", "p7"]
_C.MODEL.FCOS.FPN_STRIDES = [8, 16, 32, 64, 128]
_C.MODEL.FCOS.PRIOR_PROB = 0.01
_C.MODEL.FCOS.INFERENCE_TH_TRAIN = 0.05
_C.MODEL.FCOS.INFERENCE_TH_TEST = 0.05
_C.MODEL.FCOS.NMS_TH = 0.6
_C.MODEL.FCOS.PRE_NMS_TOPK_TRAIN = 1000
_C.MODEL.FCOS.PRE_NMS_TOPK_TEST = 1000
_C.MODEL.FCOS.POST_NMS_TOPK_TRAIN = 100
_C.MODEL.FCOS.POST_NMS_TOPK_TEST = 100
_C.MODEL.FCOS.TOP_LEVELS = 2
_C.MODEL.FCOS.NORM = "GN"
_C.MODEL.FCOS.USE_SCALE = True
_C.MODEL.FCOS.THRESH_WITH_CTR = False
_C.MODEL.FCOS.LOSS_ALPHA = 0.25
_C.MODEL.FCOS.LOSS_GAMMA = 2.0
_C.MODEL.FCOS.SIZES_OF_INTEREST = [64, 128, 256, 512]
_C.MODEL.FCOS.USE_RELU = True
_C.MODEL.FCOS.USE_DEFORMABLE = False
_C.MODEL.FCOS.NUM_CLS_CONVS = 4
_C.MODEL.FCOS.NUM_BOX_CONVS = 4
_C.MODEL.FCOS.NUM_SHARE_CONVS = 0
_C.MODEL.FCOS.CENTER_SAMPLE = True
_C.MODEL.FCOS.POS_RADIUS = 1.5
_C.MODEL.FCOS.LOC_LOSS_TYPE = "giou"

# ---------------------------------------------------------------------------
# VoVNet backbone (reference: config/defaults.py:53-67)
# ---------------------------------------------------------------------------
_C.MODEL.VOVNET = CN()
_C.MODEL.VOVNET.CONV_BODY = "V-39-eSE"
_C.MODEL.VOVNET.OUT_FEATURES = ["stage2", "stage3", "stage4", "stage5"]
_C.MODEL.VOVNET.NORM = "FrozenBN"
_C.MODEL.VOVNET.OUT_CHANNELS = 256
_C.MODEL.VOVNET.BACKBONE_OUT_CHANNELS = 256
_C.MODEL.VOVNET.STAGE_WITH_DCN = (False, False, False, False)
_C.MODEL.VOVNET.WITH_MODULATED_DCN = False
_C.MODEL.VOVNET.DEFORMABLE_GROUPS = 1

# ---------------------------------------------------------------------------
# ROI heads (detectron2 base keys read by center_heads.py:116-131)
# ---------------------------------------------------------------------------
_C.MODEL.ROI_HEADS = CN()
_C.MODEL.ROI_HEADS.NAME = "CenterROIHeads"
_C.MODEL.ROI_HEADS.NUM_CLASSES = 80
_C.MODEL.ROI_HEADS.IN_FEATURES = ["p3", "p4", "p5"]
_C.MODEL.ROI_HEADS.IOU_THRESHOLDS = [0.5]
_C.MODEL.ROI_HEADS.IOU_LABELS = [0, 1]
_C.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 512
_C.MODEL.ROI_HEADS.POSITIVE_FRACTION = 0.25
_C.MODEL.ROI_HEADS.SCORE_THRESH_TEST = 0.05
_C.MODEL.ROI_HEADS.NMS_THRESH_TEST = 0.5
_C.MODEL.ROI_HEADS.PROPOSAL_APPEND_GT = True

_C.MODEL.ROI_MASK_HEAD = CN()
_C.MODEL.ROI_MASK_HEAD.NAME = "SpatialAttentionMaskHead"
_C.MODEL.ROI_MASK_HEAD.POOLER_RESOLUTION = 14
_C.MODEL.ROI_MASK_HEAD.POOLER_SAMPLING_RATIO = 0
_C.MODEL.ROI_MASK_HEAD.NUM_CONV = 4
_C.MODEL.ROI_MASK_HEAD.CONV_DIM = 256
_C.MODEL.ROI_MASK_HEAD.NORM = ""
_C.MODEL.ROI_MASK_HEAD.CLS_AGNOSTIC_MASK = False
_C.MODEL.ROI_MASK_HEAD.POOLER_TYPE = "ROIAlignV2"
_C.MODEL.ROI_MASK_HEAD.ASSIGN_CRITERION = "area"

_C.MODEL.MASKIOU_ON = False
_C.MODEL.MASKIOU_LOSS_WEIGHT = 1.0

_C.MODEL.ROI_MASKIOU_HEAD = CN()
_C.MODEL.ROI_MASKIOU_HEAD.NAME = "MaskIoUHead"
_C.MODEL.ROI_MASKIOU_HEAD.CONV_DIM = 256
_C.MODEL.ROI_MASKIOU_HEAD.NUM_CONV = 4

_C.MODEL.ROI_KEYPOINT_HEAD = CN()
_C.MODEL.ROI_KEYPOINT_HEAD.NAME = "KRCNNConvDeconvUpsampleHead"
# intentionally inert: the keypoint branch shares CenterROIHeads' pooler
# (ROI_HEADS.IN_FEATURES p3-p5, resolution 14, TPU.POOLER_SAMPLING_RATIO)
# — this FPN has no p2, matching the reference's CenterMask keypoint path
_C.MODEL.ROI_KEYPOINT_HEAD.IN_FEATURES = ["p2", "p3", "p4", "p5"]
_C.MODEL.ROI_KEYPOINT_HEAD.POOLER_RESOLUTION = 14
_C.MODEL.ROI_KEYPOINT_HEAD.POOLER_SAMPLING_RATIO = 0
_C.MODEL.ROI_KEYPOINT_HEAD.CONV_DIMS = [512, 512, 512, 512, 512, 512, 512, 512]
_C.MODEL.ROI_KEYPOINT_HEAD.NUM_KEYPOINTS = 17
_C.MODEL.ROI_KEYPOINT_HEAD.MIN_KEYPOINTS_PER_IMAGE = 1
_C.MODEL.ROI_KEYPOINT_HEAD.NORMALIZE_LOSS_BY_VISIBLE_KEYPOINTS = True
_C.MODEL.ROI_KEYPOINT_HEAD.LOSS_WEIGHT = 1.0
_C.MODEL.ROI_KEYPOINT_HEAD.POOLER_TYPE = "ROIAlignV2"
_C.MODEL.ROI_KEYPOINT_HEAD.ASSIGN_CRITERION = "ratio"

# ---------------------------------------------------------------------------
# DATASETS / DATALOADER
# ---------------------------------------------------------------------------
_C.DATASETS = CN()
_C.DATASETS.TRAIN = ()
_C.DATASETS.TEST = ()

_C.DATALOADER = CN()
_C.DATALOADER.NUM_WORKERS = 4
_C.DATALOADER.FILTER_EMPTY_ANNOTATIONS = True

# ---------------------------------------------------------------------------
# SOLVER (detectron2 base keys + reference yaml overrides)
# ---------------------------------------------------------------------------
_C.SOLVER = CN()
_C.SOLVER.IMS_PER_BATCH = 16
_C.SOLVER.BASE_LR = 0.001
_C.SOLVER.MOMENTUM = 0.9
_C.SOLVER.NESTEROV = False
_C.SOLVER.WEIGHT_DECAY = 0.0001
_C.SOLVER.WEIGHT_DECAY_NORM = 0.0
_C.SOLVER.GAMMA = 0.1
_C.SOLVER.STEPS = (30000,)
_C.SOLVER.MAX_ITER = 40000
_C.SOLVER.WARMUP_FACTOR = 1.0 / 1000
_C.SOLVER.WARMUP_ITERS = 1000
_C.SOLVER.WARMUP_METHOD = "linear"
_C.SOLVER.CHECKPOINT_PERIOD = 5000
_C.SOLVER.CLIP_GRADIENTS = CN()
_C.SOLVER.CLIP_GRADIENTS.ENABLED = False
# "value" = elementwise clip to +-CLIP_VALUE; "norm" = scale the whole
# gradient pytree so its global L2 norm is <= CLIP_VALUE (detectron2's
# SOLVER.CLIP_GRADIENTS schema; its NORM_TYPE other than 2.0 is not
# supported here)
_C.SOLVER.CLIP_GRADIENTS.CLIP_TYPE = "value"
_C.SOLVER.CLIP_GRADIENTS.CLIP_VALUE = 1.0
_C.SOLVER.CLIP_GRADIENTS.NORM_TYPE = 2.0

# ---------------------------------------------------------------------------
# INPUT
# ---------------------------------------------------------------------------
_C.INPUT = CN()
_C.INPUT.MIN_SIZE_TRAIN = (800,)
_C.INPUT.MIN_SIZE_TRAIN_SAMPLING = "choice"
_C.INPUT.MAX_SIZE_TRAIN = 1333
_C.INPUT.MIN_SIZE_TEST = 800
_C.INPUT.MAX_SIZE_TEST = 1333
_C.INPUT.RANDOM_FLIP = "horizontal"
_C.INPUT.FORMAT = "BGR"
_C.INPUT.MASK_FORMAT = "polygon"

# ---------------------------------------------------------------------------
# TEST
# ---------------------------------------------------------------------------
_C.TEST = CN()
_C.TEST.DETECTIONS_PER_IMAGE = 100
_C.TEST.EVAL_PERIOD = 0
# OKS sigmas for the "keypoints" eval task; empty = COCO's 17 defaults
# (d2 TEST.KEYPOINT_OKS_SIGMAS; reference coco_evaluation.py:80)
_C.TEST.KEYPOINT_OKS_SIGMAS = []

# ---------------------------------------------------------------------------
# TPU (new): static-shape capacities and compute policy.
# The reference's deployment constants become config here
# (deploy_utils.py:19-21 FIXED_EDGE_SIZE=1344; ml_nms.py:85 nms cap 100;
#  deploy_utils.py:106 output truncation [:50]).
# ---------------------------------------------------------------------------
_C.TPU = CN()
# Fixed padded input edge for the export/inference path.
_C.TPU.FIXED_EDGE_SIZE = 1344
# Use approximate top-k (approx_max_k, recall ~0.95 at the candidate
# tail) in decode. Off by default: exact top_k is both reference-exact
# and measured faster on v5e after the round-2 decode rewrite
# (models/meta.py:approx_topk).
_C.TPU.APPROX_TOPK = False
# Per-level candidate capacity before NMS (= PRE_NMS_TOPK).
_C.TPU.NMS_CANDIDATES = 1000
# Max ground-truth instances per image (training padding capacity).
_C.TPU.MAX_GT_INSTANCES = 100
# Max foreground ROIs routed to the mask/maskiou branches in training.
_C.TPU.MAX_FG_PROPOSALS = 128
# Compute dtype for conv towers: "bfloat16" or "float32".
_C.TPU.COMPUTE_DTYPE = "bfloat16"
# Data-parallel mesh axis name.
_C.TPU.MESH_AXIS = "data"
# ROIAlign sampling ratio actually used on TPU: a fixed count (2 = round-1
# default, fastest), or 0 = detectron2-adaptive semantics via static
# bucket ratios {1,2,4} selected per ROI (ops/roi_align.py; ~3x gather
# cost — use for AP-parity evaluation).
_C.TPU.POOLER_SAMPLING_RATIO = 2
# Feed the stem space-to-depth'd input prepared on the host
# (data/preprocess.py:stem_space_to_depth): bit-identical outputs, no
# MXU-hostile 3-channel conv on device. VoVNet backbones only.
_C.TPU.S2D_STEM_INPUT = False
# Size buckets (shortest-edge padded sizes) for batched inference.
_C.TPU.SIZE_BUCKETS = [896, 1120, 1344]
# Rematerialize the backbone in the backward pass (jax.checkpoint):
# drops all backbone activations from HBM at ~15% extra forward FLOPs,
# for large-batch / large-resolution training.
_C.TPU.REMAT_BACKBONE = False
# Train with detectron2's geometry instead of the fixed deploy square:
# aspect-ratio-grouped batches (d2 build.py aspect_ratio_grouping)
# padded to the quantized tight canvas covering the batch — at most 4
# padded shapes (4 compiled train programs), ~30-40% fewer pixels per
# step for typical COCO. Step time scales ~linearly with canvas area.
_C.TPU.TRAIN_TIGHT_PAD = False


def get_cfg() -> CN:
    """Return a fresh copy of the default config
    (reference: centermask2/centermask/config/config.py:4-13)."""
    return _C.clone()
