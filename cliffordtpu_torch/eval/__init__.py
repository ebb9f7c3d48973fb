"""The evaluation layer (port of ``cliffordtpu/eval``): the model adapter,
prior sampling, class-mean classifier, kNN, the binding experiments with
their plots, FID (the seed-42 surrogate and InceptionV3), the plots and
the across-dims tables.  Plots split into a device half that returns
numpy and a drawing half that imports matplotlib when called; t-SNE and
``knn``'s "sklearn" backend import scikit-learn when called.

The battery's functions named ``test_*`` are evaluations, as in the JAX
package; import their modules, not the names, where pytest collects."""

from cliffordtpu_torch.eval.adapters import ModelHandle
from cliffordtpu_torch.eval.class_means import (
    compute_class_means,
    evaluate_mean_vector_cosine,
)
from cliffordtpu_torch.eval.fid import compute_fid
from cliffordtpu_torch.eval.knn import perform_knn_evaluation
from cliffordtpu_torch.eval.tables import (
    plot_across_dims_comparison,
    plot_cross_dist_comparison_dim,
)

__all__ = [
    "ModelHandle",
    "compute_class_means",
    "compute_fid",
    "evaluate_mean_vector_cosine",
    "perform_knn_evaluation",
    "plot_across_dims_comparison",
    "plot_cross_dist_comparison_dim",
]
