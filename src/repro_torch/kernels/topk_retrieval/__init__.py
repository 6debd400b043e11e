"""T3 proxy scoring: B7 ``proxy_scores`` (contiguous codes) and
``paged_proxy_scores`` (the arena's code pages), one CUDA kernel."""
from repro_torch.kernels.topk_retrieval.ops import (paged_proxy_scores,
                                                    paged_proxy_scores_plain,
                                                    proxy_scores, proxy_scores_plain,
                                                    proxy_scores_q, retrieval_decode)

__all__ = ["paged_proxy_scores", "paged_proxy_scores_plain", "proxy_scores",
           "proxy_scores_plain", "proxy_scores_q", "retrieval_decode"]
