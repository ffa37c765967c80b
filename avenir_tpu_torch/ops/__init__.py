"""The port's compute engine on one device: counting, distances and
their kernels."""

from .counting import (  # noqa: F401
    count_table,
    moment_table,
    feature_class_counts,
    sharded_reduce,
)
