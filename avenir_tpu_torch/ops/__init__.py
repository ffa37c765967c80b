"""The port's compute engine on one device: counting, distances and
their kernels."""
