"""Device milliseconds a refiner round of its heads' kernels: the fused
attention (SDPA), the LayerNorms and the heads' GEMMs (the projections,
the feed-forward layers and the token heads), by kernel name, over the
rounds of the traced pass (the port's counter ``refine.rounds``)."""
import re

from portbench import trace

# Kernels of the two transformer heads: the fused attention (cuDNN's or
# torch's flash kernel), LayerNorm, and the cuBLAS and cuBLASLt GEMMs of
# the linear layers (gemm or nvjet in a name that has none of the
# convolutions' words; not cuBLAS's small-matrix gemmSN and gemv kernels,
# which the pose's 3x3 products take).
ATTN_KERNEL = re.compile(
    r"flash|fmha|sdpa|attention|softmax|layer_norm|layernorm|"
    r"^(?!.*(conv|fprop|implicit|nhwc|nchw|winograd|gemmSN|gemv)).*"
    r"(gemm|nvjet)", re.IGNORECASE)


def read(ctx):
    rounds = ctx.get("rounds")
    sec, n = trace.seconds_of(ctx["summary"], ATTN_KERNEL)
    return 1e3 * sec / rounds if n and rounds else None
