"""Evaluation metrics: Panoptic Quality (binary + CoNIC multiclass),
detection P/R/F1, border-instance removal, sparse-GT fairness filtering
(counterpart of ``classpose_tpu/metrics``, without pandas or sklearn)."""

from classpose_tpu_torch.metrics.pq import (  # noqa: F401
    compute_binary_pq_metrics,
    compute_multiclass_pq_metrics,
    format_rows,
    remove_border_instances,
    write_csv,
)
from classpose_tpu_torch.metrics.stats_utils import (  # noqa: F401
    get_multi_pq_info,
    get_multi_r2,
    get_pq,
)
from classpose_tpu_torch.metrics.utils import (  # noqa: F401
    filter_out_unlabelled_cells,
    get_bounding_box,
    remap_label,
)
