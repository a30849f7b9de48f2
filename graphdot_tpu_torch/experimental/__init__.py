"""Experimental features; counterpart of ``graphdot_tpu/experimental/``."""
