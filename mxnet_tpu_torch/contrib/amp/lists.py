"""AMP op-classification lists, policy as data (a copy of
``mxnet_tpu/contrib/amp/lists.py``).

Upstream's python/mxnet/contrib/amp/lists/symbol.py
classifies every operator into FP16_FUNCS (run in the low-precision
target dtype), FP32_FUNCS (numerically sensitive, keep fp32),
FP16_FP32_FUNCS (run in whatever dtype the input already has) and
WIDEST_TYPE_CASTS (multi-input ops whose inputs are cast to the widest
present dtype).  Names refer to this framework's op registry; ops not
listed default to pass-through (the reference's FP16_FP32 class).
"""

# matmul and convolution ops: cast inputs to the AMP target dtype
TARGET_DTYPE_OPS = [
    "Convolution", "Convolution_v1", "Deconvolution", "FullyConnected",
    "dot", "batch_dot", "RNN", "_linalg_gemm", "_linalg_gemm2",
    "_npi_matmul",
]

# numerically sensitive ops: force fp32 inputs
FP32_OPS = [
    "softmax", "log_softmax", "softmin", "SoftmaxActivation",
    "SoftmaxOutput", "softmax_cross_entropy", "CTCLoss", "ctc_loss",
    "BatchNorm", "BatchNorm_v1", "LayerNorm", "GroupNorm", "InstanceNorm",
    "L2Normalization", "LRN", "norm", "exp", "log", "log2", "log10",
    "log1p", "expm1", "rsqrt", "rcbrt", "reciprocal", "erfinv", "gamma",
    "gammaln", "sum", "mean", "prod", "nansum", "nanprod",
    "LinearRegressionOutput", "MAERegressionOutput",
    "LogisticRegressionOutput", "SVMOutput", "smooth_l1", "MakeLoss",
    "make_loss",
]

# multi-input ops: cast every floating input to the widest input dtype
WIDEST_TYPE_CASTS = [
    "broadcast_add", "broadcast_sub", "broadcast_mul", "broadcast_div",
    "broadcast_power", "broadcast_maximum", "broadcast_minimum",
    "broadcast_hypot", "broadcast_equal", "broadcast_not_equal",
    "broadcast_greater", "broadcast_greater_equal", "broadcast_lesser",
    "broadcast_lesser_equal", "elemwise_add", "elemwise_sub",
    "elemwise_mul", "elemwise_div", "maximum", "minimum", "hypot",
    "power", "Concat", "concat", "stack", "add_n", "where",
]

# fp8-eligible ops: only the matmul/conv family (norms, softmax and
# reductions never drop below bf16).  A strict subset of
# TARGET_DTYPE_OPS: RNN gates and the linalg kernels carry recurrences
# and long accumulation chains that e4m3's ~2 significant digits cannot
# hold, so they cap at bf16.
FP8_OPS = [
    "Convolution", "Convolution_v1", "Deconvolution", "FullyConnected",
    "dot", "batch_dot", "_npi_matmul",
]

# reference-compat aliases
FP16_FUNCS = TARGET_DTYPE_OPS
FP32_FUNCS = FP32_OPS
FP8_FUNCS = FP8_OPS
