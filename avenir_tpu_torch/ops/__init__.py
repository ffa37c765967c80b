"""The port's compute engine: counting on one device and its kernels."""
