"""Work of random cosine features (``CosineRandomFeatures``)."""
from __future__ import annotations


def cosine_flops(n: int, dim: int, features: int) -> int:
    """``cos(X W^T + b)`` for X (n, dim) and W (features, dim): the
    product (2 n dim features), the bias add and the cosine (one each an
    output)."""
    return 2 * n * dim * features + 2 * n * features
