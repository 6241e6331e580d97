"""Hand-written device kernels and the choice of implementation."""

from .rotate_peak import rotate_peak_sweep_kernel

__all__ = ["rotate_peak_sweep_kernel"]
