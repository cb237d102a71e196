"""Render-and-compare simulation (counterpart of ``pcl_tpu/simulation``):
point-splat depth rendering of a model from a candidate pose and the
observation likelihood of a measured depth image. Like the JAX package's,
the module defines no ``__all__``; it imports the same public names.
"""

from pcl_tpu_torch.simulation.range_likelihood import render_depth, range_likelihood
