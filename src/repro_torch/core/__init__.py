"""ReCalKV core — the paper's contribution as composable PyTorch modules
(port of ``repro.core``; Fisher allocation is not ported yet).

Offline (compression-time) components:
  svd        truncated / whitened / grouped SVD primitives
  cka        head-similarity metrics (covariance-based linear CKA)
  reorder    greedy HSR head grouping (numpy)
  calibrate  alternating closed-form factor refinement (OCMF part 1)
  fusion     block fusion of R_v into W_o + permutation folding (OCMF part 2)
  pipeline   Algorithm 1 end to end
"""

from repro_torch.core.calibrate import CalibrationResult, calibrate_factors
from repro_torch.core.cka import head_cka_from_cov, head_cka_matrix, linear_cka
from repro_torch.core.fusion import (fold_head_permutation,
                                     fuse_output_projection,
                                     fused_output_apply, inverse_permutation)
from repro_torch.core.pipeline import (AttnWeights, CalibStats,
                                       CompressedAttention, ReCalKVConfig,
                                       collect_stats, compress_attention_layer,
                                       compress_model_layers, merge_stats)
from repro_torch.core.reorder import (greedy_group_heads, groups_to_permutation,
                                      identity_groups)
from repro_torch.core.svd import (LowRankFactors, effective_rank_for_ratio,
                                  grouped_svd, truncated_svd, whitened_svd)

__all__ = [
    "AttnWeights", "CalibStats", "CalibrationResult", "CompressedAttention",
    "LowRankFactors", "ReCalKVConfig", "calibrate_factors", "collect_stats",
    "compress_attention_layer", "compress_model_layers",
    "effective_rank_for_ratio", "fold_head_permutation",
    "fuse_output_projection", "fused_output_apply", "greedy_group_heads",
    "grouped_svd", "groups_to_permutation", "head_cka_from_cov",
    "head_cka_matrix", "identity_groups", "inverse_permutation", "linear_cka",
    "merge_stats", "truncated_svd", "whitened_svd",
]
