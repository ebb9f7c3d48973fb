"""Datasets (port of ``cliffordtpu/data``): MNIST / FashionMNIST /
CIFAR-10 loaders with the labelled synthetic fallback, the keyed batch
iterator and the train loop's binarisation."""

from cliffordtpu_torch.data.loaders import (
    binarize_with_random_threshold,
    iterate_batches,
    load_dataset,
)

__all__ = [
    "binarize_with_random_threshold",
    "iterate_batches",
    "load_dataset",
]
